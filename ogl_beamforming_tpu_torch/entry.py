"""Single-card entry point: the port's counterpart of ``__graft_entry__``.

``entry(device="cuda")`` returns ``(forward, (rf,))``: one Decode -> DAS
step of the framework's flagship FORCES plan on the card and a zero frame
to call it with.  ``forward`` takes canonical ``(C, A, S)`` int16 RF, a
tensor or a numpy array, and returns the ``(nx, nz, 1)`` frame on the
plan's device.  The multi-card dry run waits for the port's parallel
package.
"""

from __future__ import annotations

import numpy as np
import torch

from .params.enums import (AcquisitionKind, DataKind, InterpolationMode,
                           ShaderKind)
from .params.types import Parameters
from .pipeline.plan import CompiledPlan, build_plan
from .pipeline.spec import PipelineSpec
from .utils.device import resolve_device
from .utils.transforms import das_transform_2d_xz

PITCH = 0.3e-3


def flagship_parameters(c, a, s, nx, nz) -> Parameters:
    """A FORCES linear-array configuration: 20 MHz, f# 0.8, cubic, the
    grid under the aperture from 1 to 40 mm deep."""
    return Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * PITCH, 40e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([nx, nz, 1, 0], np.int32))


def flagship_plan(c, a, s, nx, nz, device="cuda") -> CompiledPlan:
    """Decode -> DAS pipeline on :func:`flagship_parameters`, built on
    ``device``."""
    pipeline = PipelineSpec.from_shaders(
        [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    return build_plan(flagship_parameters(c, a, s, nx, nz), pipeline, {},
                      device=device)


def entry(device="cuda"):
    """Returns ``(forward, (rf,))``: a forward step on ``device`` (the GPU
    unless told otherwise; raises without one) and a zero frame there."""
    c, a, s = 32, 16, 1024
    plan = flagship_plan(c, a, s, nx=128, nz=128, device=device)
    dev = resolve_device(device)
    rf = torch.zeros((c, a, s), dtype=torch.int16, device=dev)

    def forward(rf):
        return plan(torch.as_tensor(rf, device=dev))

    return forward, (rf,)
