"""Single-card entry point: the port's counterpart of ``__graft_entry__``.

``entry(device="cuda")`` returns ``(forward, (rf,))``: one Decode -> DAS
step of the framework's flagship FORCES plan on the card and a zero frame
to call it with.  ``forward`` takes canonical ``(C, A, S)`` int16 RF, a
tensor or a numpy array, and returns the ``(nx, nz, 1)`` frame on the
plan's device.  ``dryrun_multichip(n_devices, device="cuda")`` runs the
framework's parallel axes over ``n_devices`` positions of ``device``.
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


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """A full pipeline step over a mesh of ``n_devices`` positions of
    ``device`` on tiny shapes (one card holds them all: a virtual mesh).

    Uses the framework's two parallel axes when the count allows: channels
    (DAS accumulation summed over positions) x output voxel slabs
    (independent spatial shards), else 1-D channel sharding through the
    multi-host feeder (``feed_rf`` of this process's
    ``local_channel_slice``); then, for an even count of at least 4,
    channels x transmits on an RCA_TPW compounding plan."""
    from .parallel.multihost import feed_rf, local_channel_slice
    from .parallel.sharding import (make_mesh, make_mesh_2d, make_mesh_tx,
                                    shard_plan, shard_plan_2d, shard_plan_tx)

    dev = resolve_device(device)
    devices = [dev] * n_devices
    a, s = 4, 128
    two_axes = n_devices % 2 == 0 and n_devices >= 4
    if two_axes:
        n_ch = n_devices // 2
        c = 4 * n_ch
        plan = flagship_plan(c, a, s, nx=16, nz=16, device=dev)
        mesh = make_mesh_2d(n_ch, 2, devices)
        out = shard_plan_2d(plan, mesh)(
            torch.zeros((c, a, s), dtype=torch.int16, device=dev))
    else:
        c = 4 * n_devices
        plan = flagship_plan(c, a, s, nx=16, nz=16, device=dev)
        mesh = make_mesh(devices)
        rf = np.zeros((c, a, s), np.int16)
        out = shard_plan(plan, mesh)(
            feed_rf(rf[local_channel_slice(c)], mesh))
    assert tuple(out.shape) == (16, 16, 1), tuple(out.shape)

    if two_axes:
        # third parallel axis: channels x transmits (multi-angle compounding)
        n_tx = 2
        n_ch = n_devices // n_tx
        c = 4 * n_ch
        angles = np.linspace(-8, 8, 2 * n_tx).astype(np.float32)
        fv = np.stack([angles, np.full(2 * n_tx, np.inf, np.float32)],
                      axis=1)
        p = Parameters(
            sample_count=s, channel_count=c, acquisition_count=2 * n_tx,
            sampling_frequency=20e6, demodulation_frequency=5e6,
            speed_of_sound=1500.0, f_number=0.8,
            acquisition_kind=AcquisitionKind.RCA_TPW, single_focus=0,
            das_voxel_transform=das_transform_2d_xz(
                [0, 1e-3], [(c - 1) * PITCH, 8e-3]),
            xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
            output_points=np.array([16, 16, 1, 0], np.int32))
        plan = build_plan(p, PipelineSpec.from_shaders(
            [ShaderKind.DAS], DataKind.Float32), {}, focal_vectors=fv,
            device=dev)
        mesh = make_mesh_tx(n_ch, n_tx, devices)
        out = shard_plan_tx(plan, mesh)(
            torch.zeros((c, 2 * n_tx, s), dtype=torch.float32, device=dev))
        assert tuple(out.shape) == (16, 16, 1), tuple(out.shape)
