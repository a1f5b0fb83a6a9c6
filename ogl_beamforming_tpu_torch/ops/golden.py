"""The NumPy golden oracle, shared with the JAX package (its
``ops/golden.py`` is plain numpy): the reference every port stage is held
against, re-exported so the port's users and checks import only the port."""

from ogl_beamforming_tpu.ops.golden import (  # noqa: F401
    DasParams, coherency_weighting, das, decode_hadamard, demodulate,
    fir_filter, hilbert)
