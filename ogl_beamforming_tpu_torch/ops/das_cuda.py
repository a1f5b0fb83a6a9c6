"""CUDA launch of the FORCES-family DAS kernel: the torch counterpart of the
parts of ``ogl_beamforming_tpu.ops.das_pallas`` that the port's main path
needs.

:func:`prepare` is the analogue of ``das_pallas._prep_scalars``: it packs the
dynamic parameters into the kernel's scalar vector and builds the
per-transmit tables (FORCES: element x positions; READI: Hadamard-row
weights with rf acquisition ``e % A``; UFORCES: ``sparse_elements``, skipping
acquisition 0).  Everything stays on the device: no host synchronisation.
:func:`das_cuda` checks its inputs, allocates the outputs and launches
``csrc/das.cu`` on the current stream.
"""

from __future__ import annotations

import torch

from ogl_beamforming_tpu.params.enums import InterpolationMode

from ..kernels import build
from .das import DasStatic, transmit_tables

LAUNCHES = 0
"""Number of DAS kernel launches in this process (the plain twin does not
count)."""

_MODE = {InterpolationMode.Nearest: 0, InterpolationMode.Linear: 1,
         InterpolationMode.Cubic: 2}


def prepare(dyn: dict, st: DasStatic):
    """``(scalars, tx_pos, tx_weight, tx_row)`` for the kernel.  The scalar
    layout is ``csrc/das.cu``'s ``Scalar`` enum: voxel transform rows 0..2,
    fs, c, t0, f#, pitch x, pitch y, f_demod, channel offset, x offset."""
    f32 = torch.float32
    scalars = torch.cat([
        dyn["voxel_transform"][:3].reshape(-1).to(f32),
        torch.stack([dyn["sampling_frequency"], dyn["speed_of_sound"],
                     dyn["time_offset"], dyn["f_number"]]).to(f32),
        dyn["xdc_element_pitch"][:2].to(f32),
        torch.stack([dyn["demodulation_frequency"].to(f32),
                     dyn["channel_offset"].to(f32),
                     dyn["x_offset"].to(f32)]),
    ]).contiguous()
    tx_pos, weight, row = transmit_tables(st, dyn)
    return (scalars, tx_pos.to(f32).contiguous(), weight.to(f32).contiguous(),
            row.to(torch.int32).contiguous())


def das_cuda(rf: torch.Tensor, dyn: dict, st: DasStatic):
    """Launch the DAS kernel on ``rf`` (C, A, S): contiguous float32, or
    complex64 when ``st.iq``, on a CUDA device that also holds ``dyn``.
    Returns the (nx, ny, nz) volume, or ``(coherent, incoherent)`` with
    coherency weighting."""
    global LAUNCHES
    if st.family != "forces" or st.frame_batch != 1:
        raise NotImplementedError(
            f"CUDA DAS covers single FORCES-family frames, not "
            f"{st.acquisition_kind.name} x {st.frame_batch}; see ROADMAP.md")
    if not rf.is_cuda:
        raise ValueError(f"das_cuda needs a CUDA tensor, got {rf.device}")
    want = torch.complex64 if st.iq else torch.float32
    if rf.dtype != want:
        raise ValueError(f"rf dtype {rf.dtype}, expected {want}")
    if rf.dim() != 3 or rf.shape[2] != st.sample_count \
            or rf.shape[1] < st.acquisition_count:
        raise ValueError(f"rf shape {tuple(rf.shape)} does not match "
                         f"(C, {st.acquisition_count}, {st.sample_count})")
    if not rf.is_contiguous():
        raise ValueError("rf must be contiguous")
    scalars, tx_pos, weight, row = prepare(dyn, st)
    if scalars.device != rf.device:
        raise ValueError(f"dyn on {scalars.device}, rf on {rf.device}")

    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or st.output_points
    out = torch.empty((nx, ny, nz), dtype=want, device=rf.device)
    inco = (torch.empty((nx, ny, nz), dtype=torch.float32, device=rf.device)
            if st.coherency_weighting else None)
    lib = build.library()
    stream = torch.cuda.current_stream(rf.device).cuda_stream
    code = lib.das_forces(
        rf.data_ptr(), scalars.data_ptr(), tx_pos.data_ptr(),
        weight.data_ptr(), row.data_ptr(), out.data_ptr(),
        inco.data_ptr() if inco is not None else None,
        rf.shape[0], st.channel_count, rf.shape[1], rf.shape[2],
        tx_pos.shape[0], nx, ny, nz, gnx, gny, gnz,
        _MODE[st.interpolation_mode], int(st.iq),
        int(st.coherency_weighting), stream)
    build.check("das_forces", code)
    LAUNCHES += 1
    if st.coherency_weighting:
        return out, inco
    return out
