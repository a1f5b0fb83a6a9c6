"""Preset imaging configurations, shared with the JAX package: its
``models/presets.py`` builds plain ``Parameters`` + ``PipelineSpec`` pairs
without jax, so the port re-exports it unchanged."""

from ogl_beamforming_tpu.models.presets import (  # noqa: F401
    decode_benchmark, forces_compounding, from_zbp, hercules_3d,
    plane_wave_2d, uforces_volumetric)
