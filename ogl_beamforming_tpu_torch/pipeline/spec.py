"""Pipeline specification and validation.

Ports the client-library validation rules exactly
(reference: lib/ogl_beamformer_lib.c:253-313) so that invalid pipelines fail
with the same error kinds as the reference ABI.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params.constants import (MAX_COMPUTE_SHADER_STAGES,
                                MAX_PARAMETER_BLOCKS)
from ..params.enums import (BeamformerError, ContrastMode, DataKind,
                            ErrorKind, ShaderKind)
from ..params.types import Parameters

CAPABILITY_HILBERT = True
"""The reference force-disables its CUDA Hilbert plugin
(beamformer.c:96-99,264); the TPU framework implements Hilbert natively
(ops/filtering.py) so the capability is on."""


@dataclass(frozen=True)
class PipelineStage:
    kind: ShaderKind
    parameter: int = 0
    """Per-stage parameter: filter slot for Filter/Demodulate
    (lib/ogl_beamformer_lib.c beamformer_set_pipeline_stage_parameters)."""


@dataclass
class PipelineSpec:
    stages: tuple[PipelineStage, ...] = ()
    data_kind: DataKind = DataKind.Int16

    @classmethod
    def from_shaders(cls, shaders, data_kind: DataKind,
                     stage_parameters=None) -> "PipelineSpec":
        stage_parameters = stage_parameters or [0] * len(shaders)
        stages = tuple(PipelineStage(ShaderKind(s), int(p))
                       for s, p in zip(shaders, stage_parameters))
        return cls(stages=stages, data_kind=DataKind(data_kind))

    @property
    def shaders(self) -> list[ShaderKind]:
        return [s.kind for s in self.stages]


def validate_pipeline(shaders, data_kind) -> None:
    """Reference: validate_pipeline (lib/ogl_beamformer_lib.c:279-313)."""
    try:
        data_kind = DataKind(data_kind)
    except ValueError:
        raise BeamformerError(ErrorKind.InvalidDataKind, str(data_kind))

    if len(shaders) > MAX_COMPUTE_SHADER_STAGES:
        raise BeamformerError(ErrorKind.ComputeStageOverflow,
                              f"{len(shaders)} stages")
    for s in shaders:
        try:
            kind = ShaderKind(s)
        except ValueError:
            raise BeamformerError(ErrorKind.InvalidComputeStage, str(s))
        if not kind.is_compute:
            raise BeamformerError(ErrorKind.InvalidComputeStage, kind.name)
        if kind == ShaderKind.Hilbert and not CAPABILITY_HILBERT:
            raise BeamformerError(ErrorKind.InvalidComputeStage, "Hilbert")
        if kind == ShaderKind.Demodulate and DataKind(data_kind).is_complex:
            raise BeamformerError(ErrorKind.InvalidDemodulationDataKind,
                                  DataKind(data_kind).name)
    if (not shaders or ShaderKind(shaders[0]) not in
            (ShaderKind.Decode, ShaderKind.Demodulate)):
        raise BeamformerError(ErrorKind.InvalidStartShader)


def validate_parameters(p: Parameters) -> None:
    """Reference: validate_parameters (lib/ogl_beamformer_lib.c:253-277).

    The frame-size check is against the backlog budget in the executor; here
    the structural checks are enforced.
    """
    try:
        ContrastMode(p.contrast_mode)
    except ValueError:
        raise BeamformerError(ErrorKind.InvalidContrastMode,
                              str(p.contrast_mode))
    contrast_samples = ContrastMode(p.contrast_mode).samples
    needed = p.acquisition_count * p.sample_count * contrast_samples
    if int(p.raw_data_dimensions[0]) and needed > int(p.raw_data_dimensions[0]):
        raise BeamformerError(
            ErrorKind.DataSizeMismatch,
            f"need {needed} raw samples/channel, raw_data_dimensions.x = "
            f"{int(p.raw_data_dimensions[0])}")


def validate_block(block: int) -> None:
    if not (0 <= block < MAX_PARAMETER_BLOCKS):
        raise BeamformerError(ErrorKind.ParameterBlockOverflow, str(block))


def expected_raw_shape(p: Parameters, data_kind: DataKind) -> tuple[int, int]:
    """(raw_channels, raw_samples_per_channel) — raw_data_dimensions is
    (x = samples, y = channels) (lib/ogl_beamformer_lib.c:506-521)."""
    x, y = (int(v) for v in p.raw_data_dimensions)
    if x == 0:
        x = p.sample_count * p.acquisition_count \
            * ContrastMode(p.contrast_mode).samples
    if y == 0:
        y = p.channel_count
    return y, x
