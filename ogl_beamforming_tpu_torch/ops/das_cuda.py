"""CUDA launch of the DAS kernels: the torch counterpart of the parts of
``ogl_beamforming_tpu.ops.das_pallas`` that the port's paths need.

:func:`prepare` is the analogue of ``das_pallas._prep_scalars``: it packs the
dynamic parameters into the kernel's scalar vector.  A FORCES-family frame
also gets its per-transmit tables (FORCES: element x positions; READI:
Hadamard-row weights with rf acquisition ``e % A``; UFORCES:
``sparse_elements``, skipping acquisition 0); an RCA frame gets its
per-acquisition transmit table (``das.rca_tables``).  Everything stays on
the device: no host synchronisation.  :func:`launch_tables` gathers them;
they depend only on the plan, so ``build_plan`` builds them once into
``dyn["launch"]`` and a frame reuses them.  :func:`das_cuda` checks its
inputs, allocates the outputs and launches ``csrc/das.cu`` on the current
stream.
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..params.enums import InterpolationMode
from .das import DasStatic, rca_tables, transmit_tables

_MODE = {InterpolationMode.Nearest: 0, InterpolationMode.Linear: 1,
         InterpolationMode.Cubic: 2}


def prepare(dyn: dict) -> torch.Tensor:
    """The kernel's scalar vector, ``csrc/das.cu``'s ``Scalar`` layout:
    voxel transform rows 0..2, fs, c, t0, f#, pitch x, pitch y, f_demod,
    channel offset, x offset, XDC transform rows 0..2."""
    f32 = torch.float32
    return torch.cat([
        dyn["voxel_transform"][:3].reshape(-1).to(f32),
        torch.stack([dyn["sampling_frequency"], dyn["speed_of_sound"],
                     dyn["time_offset"], dyn["f_number"]]).to(f32),
        dyn["xdc_element_pitch"][:2].to(f32),
        torch.stack([dyn["demodulation_frequency"].to(f32),
                     dyn["channel_offset"].to(f32),
                     dyn["x_offset"].to(f32)]),
        dyn["xdc_transform"][:3].reshape(-1).to(f32),
    ]).contiguous()


def launch_tables(st: DasStatic, dyn: dict) -> dict:
    """The kernel's scalar vector and the tables of ``st``'s family, as
    contiguous device tensors: ``rca`` (A, 8) for an RCA frame; ``tx_pos``,
    ``tx_weight`` and ``tx_row`` for a FORCES-family frame."""
    tables = {"scalars": prepare(dyn)}
    if st.family == "rca":
        tables["rca"] = rca_tables(dyn)
    else:
        tx_pos, weight, row = transmit_tables(st, dyn)
        tables["tx_pos"] = tx_pos.to(torch.float32).contiguous()
        tables["tx_weight"] = weight.to(torch.float32).contiguous()
        tables["tx_row"] = row.to(torch.int32).contiguous()
    return tables


def das_cuda(rf: torch.Tensor, dyn: dict, st: DasStatic):
    """Launch the DAS kernel of ``st``'s family (FORCES or RCA) on ``rf``
    (C, A, S): contiguous float32, or complex64 when ``st.iq``, on a CUDA
    device that also holds ``dyn``.  Returns the (nx, ny, nz) volume, or
    ``(coherent, incoherent)`` with coherency weighting.  The tables come
    from ``dyn["launch"]`` where the plan built them, else from ``dyn``."""
    if st.family not in ("forces", "rca") or st.frame_batch != 1:
        raise NotImplementedError(
            f"CUDA DAS covers single FORCES- and RCA-family frames, not "
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
    tables = dyn.get("launch") or launch_tables(st, dyn)
    scalars = tables["scalars"]
    if scalars.device != rf.device:
        raise ValueError(f"dyn on {scalars.device}, rf on {rf.device}")

    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or st.output_points
    out = torch.empty((nx, ny, nz), dtype=want, device=rf.device)
    inco = (torch.empty((nx, ny, nz), dtype=torch.float32, device=rf.device)
            if st.coherency_weighting else None)
    inco_ptr = inco.data_ptr() if inco is not None else None
    flags = (_MODE[st.interpolation_mode], int(st.iq),
             int(st.coherency_weighting))
    lib = build.library()
    stream = torch.cuda.current_stream(rf.device).cuda_stream
    if st.family == "rca":
        name = "das_rca"
        code = lib.das_rca(
            rf.data_ptr(), scalars.data_ptr(), tables["rca"].data_ptr(),
            out.data_ptr(), inco_ptr, rf.shape[0], rf.shape[1],
            st.acquisition_count, rf.shape[2], nx, ny, nz, gnx, gny, gnz,
            *flags, stream)
    else:
        tx_pos = tables["tx_pos"]
        name = "das_forces"
        code = lib.das_forces(
            rf.data_ptr(), scalars.data_ptr(), tx_pos.data_ptr(),
            tables["tx_weight"].data_ptr(), tables["tx_row"].data_ptr(),
            out.data_ptr(), inco_ptr, rf.shape[0], st.channel_count,
            rf.shape[1], rf.shape[2], tx_pos.shape[0], nx, ny, nz, gnx, gny,
            gnz, *flags, stream)
    build.check(name, code)
    build.LAUNCHES[name] += 1
    if st.coherency_weighting:
        return out, inco
    return out
