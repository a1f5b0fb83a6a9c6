"""Delay-and-sum (DAS): the torch counterpart of ``ogl_beamforming_tpu.ops.das``.

:func:`das_ref` is the plain-torch twin, a line-for-line translation of the
JAX package's exact-f32 XLA path (``ops/das.py``); :func:`das` dispatches on
the RF tensor's device: a CPU tensor takes the twin, a CUDA tensor takes the
hand-written kernel (``ops/das_cuda.py`` -> ``csrc/das.cu``) or raises.

Every DAS family of the JAX package: FORCES, UFORCES (sparse) and
READI-grouped FORCES; HERCULES, UHERCULES (sparse) and HERO_PA (a 2D
apodization over the transmit x receive element grid, with acquisition 0's
plane or cylindrical transmit); and the RCA family (Flash, RCA_TPW, RCA_VLS:
per-acquisition orientation and focal vector, plane or cylindrical
transmit), in every interpolation mode, real and IQ, with or without the
coherency output, one frame (C, A, S) or a batch of frames (B, C, A, S).

Constants that the JAX code multiplies in (pi, 2*pi, pi/180) are the
float32 values JAX would use, so the twin's arithmetic is the JAX package's,
operation for operation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..params.enums import AcquisitionKind, InterpolationMode, RCAOrientation
from ..utils.device import resolve_device
from .golden import DasParams

PI_F32 = float(np.float32(np.pi))
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
DEG_F32 = float(np.float32(np.pi / 180))      # jnp.radians' constant


@dataclasses.dataclass(frozen=True)
class DasStatic:
    """Shape-level DAS configuration (the JAX package's trace-time
    parameters); everything numeric lives in the dynamic dict."""

    acquisition_kind: AcquisitionKind
    acquisition_count: int
    channel_count: int
    sample_count: int
    interpolation_mode: InterpolationMode
    output_points: tuple[int, int, int]
    iq: bool
    sparse: bool = False
    readi_group_count: int = 0
    coherency_weighting: bool = False
    global_points: tuple[int, int, int] | None = None
    """Full output grid when this call computes a slab of it starting at
    ``dyn["x_offset"]``: voxel coordinates use its denominators."""
    grid_channels: int = 0
    """The channels this call beamforms when they are a shard of
    ``channel_count`` (``parallel/sharding.py``), starting at
    ``dyn["channel_offset"]``; ``channel_count`` stays global, because the
    element geometry needs it."""
    frame_batch: int = 1

    @property
    def family(self) -> str:
        return self.acquisition_kind.das_family

    @property
    def local_channels(self) -> int:
        return self.grid_channels or self.channel_count


def make_dynamic(p: DasParams, device) -> dict:
    """The dynamic-parameter dict of tensors on ``device`` (same keys and
    values as the JAX package's ``make_dynamic``)."""
    a = p.acquisition_count
    if p.single_focus or p.focal_vectors is None:
        fv = np.broadcast_to(
            np.array([p.transmit_angle, p.focus_depth], np.float32), (a, 2))
    else:
        fv = np.asarray(p.focal_vectors[:a], np.float32)
    if p.single_orientation or p.transmit_receive_orientations is None:
        orient = np.full((a,), int(p.transmit_receive_orientation), np.int32)
    else:
        orient = np.asarray(p.transmit_receive_orientations[:a], np.int32)
    sparse = (np.asarray(p.sparse_elements[:a], np.int32)
              if p.sparse_elements is not None else np.zeros(a, np.int32))
    g = max(p.readi_group_count, 1)
    if p.das_hadamard is not None:
        hrow = np.asarray(p.das_hadamard, np.float32)[p.readi_group]
    else:
        hrow = np.ones(g, np.float32)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    def i32(v):
        return torch.tensor(np.asarray(v, np.int32), device=device)

    return {
        "sampling_frequency": f32(p.sampling_frequency),
        "demodulation_frequency": f32(p.demodulation_frequency),
        "speed_of_sound": f32(p.speed_of_sound),
        "time_offset": f32(p.time_offset),
        "f_number": f32(p.f_number),
        "voxel_transform": f32(p.voxel_transform),
        "xdc_transform": f32(p.xdc_transform),
        "xdc_element_pitch": f32(p.xdc_element_pitch),
        "focal_vectors": f32(fv),
        "orientations": i32(orient),
        "sparse_elements": i32(sparse),
        "hadamard_row": f32(hrow),
        "channel_offset": i32(0),
        "x_offset": i32(0),
    }


def make_static(p: DasParams, iq: bool) -> DasStatic:
    return DasStatic(
        acquisition_kind=p.acquisition_kind,
        acquisition_count=p.acquisition_count,
        channel_count=p.channel_count,
        sample_count=p.sample_count,
        interpolation_mode=p.interpolation_mode,
        output_points=tuple(int(v) for v in p.output_points),
        iq=iq,
        sparse=bool(p.sparse),
        readi_group_count=int(p.readi_group_count),
        coherency_weighting=bool(p.coherency_weighting),
    )


# ---------------------------------------------------------------------------
# Shared machinery
# ---------------------------------------------------------------------------

def _world_points(st: DasStatic, dyn) -> torch.Tensor:
    """Normalized voxel grid -> world points, flattened (V, 3), voxels in
    C order over (nx, ny, nz)."""
    nx, ny, nz = st.output_points
    gnx, gny, gnz = st.global_points or (nx, ny, nz)
    dev = dyn["voxel_transform"].device
    denom = torch.clamp(torch.tensor([gnx, gny, gnz], dtype=torch.float32,
                                     device=dev) - 1.0, min=1.0)
    x_off = dyn["x_offset"].to(torch.float32)
    ix, iy, iz = torch.meshgrid(
        torch.arange(nx, dtype=torch.float32, device=dev),
        torch.arange(ny, dtype=torch.float32, device=dev),
        torch.arange(nz, dtype=torch.float32, device=dev), indexing="ij")
    p = torch.stack([(ix + x_off) / denom[0], iy / denom[1], iz / denom[2]],
                    dim=-1).reshape(-1, 3)
    return _apply_m4(dyn["voxel_transform"], p)


def _apply_m4(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    # elementwise, left to right: the order the JAX package (and the CUDA
    # kernel) evaluates world coordinates in
    return torch.stack(
        [m[i, 0] * pts[..., 0] + m[i, 1] * pts[..., 1]
         + m[i, 2] * pts[..., 2] + m[i, 3] for i in range(3)], dim=-1)


def _interpolate(st: DasStatic, lines: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """Fractional-delay interpolation of ``lines`` (N, S) at ``index``
    (N, V); out-of-window indices give 0 (das.glsl:64-122 windows)."""
    s = st.sample_count
    mode = st.interpolation_mode

    def at(i):
        return torch.gather(lines, 1, i)

    if mode == InterpolationMode.Nearest:
        r = torch.round(index)                 # half to even, as jnp.round
        valid = (torch.floor(index) >= 0) & (r < s)
        val = at(torch.where(valid, r, 0.0).long())
        return torch.where(valid, val, 0)
    k = torch.floor(index)
    t = index - k
    if mode == InterpolationMode.Linear:
        valid = (k >= 0) & (k < s - 1)
        kk = torch.where(valid, k, 0.0).long()
        return torch.where(valid, (1 - t) * at(kk) + t * at(kk + 1), 0)
    # Cubic Catmull-Rom (C_SPLINE = 0.5, das.glsl:49,64-95)
    valid = (k > 0) & (k < s - 2)
    kk = torch.where(valid, k, 1.0).long()
    p0, p1, p2, p3 = at(kk - 1), at(kk), at(kk + 1), at(kk + 2)
    t1 = 0.5 * (p2 - p0)
    t2 = 0.5 * (p3 - p1)
    tt = t * t
    ttt = tt * t
    val = ((2 * ttt - 3 * tt + 1) * p1 + (-2 * ttt + 3 * tt) * p2
           + (ttt - 2 * tt + t) * t1 + (ttt - tt) * t2)
    return torch.where(valid, val, 0)


def _sample_rf(st: DasStatic, dyn, lines: torch.Tensor,
               index: torch.Tensor) -> torch.Tensor:
    """Interpolate + IQ phase rotation by exp(+j 2 pi f_d index / fs)."""
    val = _interpolate(st, lines, index)
    if st.iq:
        arg = ((TWO_PI_F32 * dyn["demodulation_frequency"])
               * (index / dyn["sampling_frequency"]))
        val = val * torch.complex(torch.cos(arg), torch.sin(arg))
    return val


def _apodize(arg: torch.Tensor) -> torch.Tensor:
    a = torch.cos(PI_F32 * arg)
    return a * a


def _sample_index(dyn, distance: torch.Tensor) -> torch.Tensor:
    return ((distance / dyn["speed_of_sound"] + dyn["time_offset"])
            * dyn["sampling_frequency"])


def _channels(dyn, n: int) -> torch.Tensor:
    dev = dyn["channel_offset"].device
    return (dyn["channel_offset"].to(torch.float32)
            + torch.arange(n, dtype=torch.float32, device=dev))


def _forces_transmits(st: DasStatic, dyn):
    """FORCES / UFORCES (das.glsl:286-319): transmit ``j`` fires element
    ``j`` (or ``sparse_elements[j]``) and reads rf acquisition ``j``
    (``j + 1`` for UFORCES, whose acquisition 0 is skipped)."""
    sparse = int(st.sparse)
    n_tx = st.acquisition_count - sparse
    dev = dyn["sparse_elements"].device
    if st.sparse:
        tx_ch = dyn["sparse_elements"][:n_tx].to(torch.float32)
    else:
        tx_ch = torch.arange(sparse, st.acquisition_count,
                             dtype=torch.float32, device=dev)
    weight = torch.ones(n_tx, dtype=torch.float32, device=dev)
    row = torch.arange(sparse, st.acquisition_count, device=dev)
    return dyn["xdc_element_pitch"][0] * tx_ch, weight, row


def _readi_transmits(st: DasStatic, dyn):
    """READI FORCES (das.glsl:321-366): element ``e = group * A + event``
    reads rf acquisition ``event`` with weight ``hadamard_row[group]``."""
    g = st.readi_group_count
    a = st.acquisition_count
    dev = dyn["hadamard_row"].device
    tx_el = torch.arange(g * a, dtype=torch.float32, device=dev)
    weight = torch.repeat_interleave(dyn["hadamard_row"][:g], a)
    row = torch.arange(a, device=dev).repeat(g)
    return dyn["xdc_element_pitch"][0] * tx_el, weight, row


def _rx_columns(dyn) -> torch.Tensor:
    """Whether acquisition 0 receives on columns (HERCULES, das.glsl:252)."""
    return (dyn["orientations"][0] & 0xF) == int(RCAOrientation.Columns)


def _hercules_transmits(st: DasStatic, dyn):
    """HERCULES / UHERCULES (das.glsl:246-273): transmit ``j`` fires row or
    column ``j`` (or ``sparse_elements[j]``), at its lateral position along
    the axis the receive elements do not run on, and reads rf acquisition
    ``j`` (``j + 1`` for UHERCULES); loop transmit 0 of a dense frame
    weighs ``float32(1 / sqrt(A))`` (das.glsl:271-273)."""
    sparse = int(st.sparse)
    a = st.acquisition_count
    dev = dyn["sparse_elements"].device
    if st.sparse:
        tx_ch = dyn["sparse_elements"][:a - sparse].to(torch.float32)
    else:
        tx_ch = torch.arange(sparse, a, dtype=torch.float32, device=dev)
    pitch = torch.where(_rx_columns(dyn), dyn["xdc_element_pitch"][1],
                        dyn["xdc_element_pitch"][0])
    row = torch.arange(sparse, a, device=dev)
    weight = torch.where(row == 0, float(np.float32(1.0 / np.sqrt(a))),
                         1.0).to(torch.float32)
    return tx_ch * pitch, weight, row


def transmit_tables(st: DasStatic, dyn):
    """Per-transmit ``(lateral position, weight, rf acquisition)`` of a
    FORCES- or HERCULES-family frame, shared by the plain twin and the CUDA
    kernel's table preparation (``ops/das_cuda.py``)."""
    if st.family == "hercules":
        return _hercules_transmits(st, dyn)
    if st.readi_group_count > 1:
        return _readi_transmits(st, dyn)
    return _forces_transmits(st, dyn)


def _forces_block(st: DasStatic, dyn, rf, world):
    """All channels x transmits of a FORCES-family frame for the voxels
    ``world`` (V, 3), already in XDC space (the planner premultiplies the
    transform, beamformer_core.c:760-763).  READI (the JAX package's
    ``_readi_forces_block``) differs only in its transmit tables."""
    tx_pos, weight, row = transmit_tables(st, dyn)
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    z2 = z * z
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]
    ty = y - py * (st.channel_count / 2)
    t_yz2 = ty * ty + z2

    # Transmit index field: (n_tx, V), shared across channels.
    tx_dx = x[None, :] - tx_pos[:, None]
    tx_index = (torch.sqrt(t_yz2[None, :] + tx_dx * tx_dx)
                * (dyn["sampling_frequency"] / dyn["speed_of_sound"]))

    v = world.shape[0]
    out = torch.zeros(v, dtype=torch.complex64 if st.iq else torch.float32,
                      device=world.device)
    inco = torch.zeros(v, dtype=torch.float32, device=world.device)
    for c, ch in enumerate(_channels(dyn, rf.shape[0])):
        rx_dx = x - ch * px
        a_arg = torch.abs(dyn["f_number"] * rx_dx / z)
        mask = a_arg < 0.5
        apod = _apodize(torch.where(mask, a_arg, 0.0))
        rx_index = _sample_index(dyn, torch.sqrt(rx_dx * rx_dx + z2))
        index = rx_index[None, :] + tx_index   # (n_tx, V)
        vals = _sample_rf(st, dyn, rf[c, row], index)
        vals = torch.where(mask[None, :],
                           (apod[None, :] * weight[:, None]) * vals, 0)
        out = out + vals.sum(dim=0)
        if st.coherency_weighting:
            inco = inco + torch.abs(vals).sum(dim=0)
    return out, inco


# ---------------------------------------------------------------------------
# RCA: Flash / TPW / VLS (das.glsl:202-229)
# ---------------------------------------------------------------------------

def rca_tables(dyn) -> torch.Tensor:
    """Per-acquisition transmit table (A, 8) float32 of an RCA frame, shared
    by the plain twin and the CUDA kernel (``csrc/das.cu``'s ``RcaColumn``):
    tx orientation, rx orientation, sin and cos of the steering angle, focal
    point (lateral, z), plane-wave flag (infinite focal depth), pad.  The
    angle goes through ``radians``, ``sin`` and ``cos`` once per
    acquisition, in float32 (the JAX package's
    ``_rca_transmit_distance``)."""
    orient = dyn["orientations"].to(torch.int32)
    fv = dyn["focal_vectors"].to(torch.float32)
    angle = fv[:, 0] * DEG_F32
    sin_a, cos_a = torch.sin(angle), torch.cos(angle)
    depth = fv[:, 1]
    plane = torch.isinf(depth)
    safe_depth = torch.where(plane, 0.0, depth)
    cols = [((orient >> 4) & 0xF).to(torch.float32),
            (orient & 0xF).to(torch.float32), sin_a, cos_a,
            safe_depth * sin_a, safe_depth * cos_a, plane.to(torch.float32),
            torch.zeros_like(angle)]
    return torch.stack(cols, dim=-1).contiguous()


def _rca_transmit_distance(world, tab) -> torch.Tensor:
    """Plane or cylindrical transmit distance of one acquisition for the
    voxels ``world`` (V, 3) (das.glsl:158-200); selects, as the JAX
    package's traced orientation."""
    tx_o, sin_a, cos_a, f_lat, f_z, plane = (tab[0], tab[2], tab[3], tab[4],
                                            tab[5], tab[6])
    lat = torch.where(tx_o == float(RCAOrientation.Rows), world[:, 1],
                      world[:, 0])
    z = world[:, 2]
    plane_d = lat * sin_a + z * cos_a
    d_lat = lat - f_lat
    d_z = z - f_z
    cyl = torch.sqrt(d_lat * d_lat + d_z * d_z)
    dist = torch.where(plane > 0.5, plane_d, cyl)
    return torch.where(tx_o == float(RCAOrientation.NoOrientation), 0.0,
                       dist)


def _rca_block(st: DasStatic, dyn, rf, world):
    """All acquisitions x channels of an RCA frame for the voxels ``world``
    (V, 3) in world space; the receive geometry works in XDC space.  Each
    acquisition's channel sum is taken in channel order and then added to
    the frame, as the CUDA kernel does."""
    xdc = _apply_m4(dyn["xdc_transform"], world)
    px = dyn["xdc_element_pitch"][0]
    py = dyn["xdc_element_pitch"][1]
    chans = _channels(dyn, rf.shape[0])
    tabs = rca_tables(dyn)
    v = world.shape[0]
    dtype = torch.complex64 if st.iq else torch.float32
    out = torch.zeros(v, dtype=dtype, device=world.device)
    inco = torch.zeros(v, dtype=torch.float32, device=world.device)
    z = xdc[:, 2]
    abs_z = torch.abs(z)
    z2 = z * z
    for a in range(st.acquisition_count):
        tab = tabs[a]
        rx_rows = tab[1] == float(RCAOrientation.Rows)
        lat = torch.where(rx_rows, xdc[:, 1], xdc[:, 0])
        rx_lat = torch.where(rx_rows, chans * py, chans * px)
        tx_dist = _rca_transmit_distance(world, tab)
        part = torch.zeros(v, dtype=dtype, device=world.device)
        part_inco = torch.zeros(v, dtype=torch.float32, device=world.device)
        for c in range(rf.shape[0]):
            recv_lat = lat - rx_lat[c]
            a_arg = torch.abs(dyn["f_number"] * recv_lat / abs_z)
            mask = a_arg < 0.5
            apod = _apodize(torch.where(mask, a_arg, 0.0))
            rlen = torch.sqrt(recv_lat * recv_lat + z2)
            index = _sample_index(dyn, tx_dist + rlen)
            vals = _sample_rf(st, dyn, rf[c, a][None], index[None])[0]
            vals = torch.where(mask, apod * vals, 0)
            part = part + vals
            if st.coherency_weighting:
                part_inco = part_inco + torch.abs(vals)
        out = out + part
        inco = inco + part_inco
    return out, inco


# ---------------------------------------------------------------------------
# HERCULES / UHERCULES / HERO_PA (das.glsl:231-284)
# ---------------------------------------------------------------------------

def _hercules_block(st: DasStatic, dyn, rf, world, transmits=None):
    """All channels x transmits of a HERCULES-family frame for the voxels
    ``world`` (V, 3) in world space (the JAX package's ``_hercules_block``):
    acquisition 0's transmit index, then per (channel, transmit) the 2D
    apodization over ``d2 = rx_d2 + tx_d2`` and the receive leg
    ``sqrt(z^2 + d2)``.  Receiving on columns, the receive elements run
    along x and the transmits along y; otherwise the axes swap.
    ``transmits``: the per-transmit ``(position, weight, rf acquisition)``
    in another order than :func:`transmit_tables` (the kernel's sorted
    table), which changes only the order of the transmit sum."""
    xdc = _apply_m4(dyn["xdc_transform"], world)
    tab = rca_tables(dyn)[0]
    rx_cols = _rx_columns(dyn)
    tx_index = _sample_index(dyn, _rca_transmit_distance(world, tab))
    z = xdc[:, 2]
    z2 = z * z
    fnum_over_z = torch.abs(dyn["f_number"] / z)
    apod_test = 0.25 / (fnum_over_z * fnum_over_z)
    xw, yw = xdc[:, 0], xdc[:, 1]
    rx_lat = torch.where(rx_cols, xw, yw)
    rx_pitch = torch.where(rx_cols, dyn["xdc_element_pitch"][0],
                           dyn["xdc_element_pitch"][1])
    tx_pos, first_w, row = transmits or transmit_tables(st, dyn)
    tx_dd = torch.where(rx_cols, yw, xw)[None, :] - tx_pos[:, None]
    tx_d2 = tx_dd * tx_dd                                  # (n_tx, V)
    fs_over_c = dyn["sampling_frequency"] / dyn["speed_of_sound"]

    v = world.shape[0]
    out = torch.zeros(v, dtype=torch.complex64 if st.iq else torch.float32,
                      device=world.device)
    inco = torch.zeros(v, dtype=torch.float32, device=world.device)
    for c, ch in enumerate(_channels(dyn, rf.shape[0])):
        rx_dd = rx_lat - ch * rx_pitch
        d2 = (rx_dd * rx_dd)[None, :] + tx_d2
        mask = d2 < apod_test[None, :]
        apod = first_w[:, None] * _apodize(
            torch.where(mask, fnum_over_z[None, :] * torch.sqrt(d2), 0.0))
        index = tx_index[None, :] + torch.sqrt(z2[None, :] + d2) * fs_over_c
        vals = _sample_rf(st, dyn, rf[c, row], index)
        vals = torch.where(mask, apod * vals, 0)
        out = out + vals.sum(dim=0)
        if st.coherency_weighting:
            inco = inco + torch.abs(vals).sum(dim=0)
    return out, inco


_FAMILY_BLOCK = {"forces": _forces_block, "hercules": _hercules_block,
                 "rca": _rca_block}


def _zero_frame(st: DasStatic, device):
    shape = ((st.frame_batch,) if st.frame_batch > 1 else ()) \
        + tuple(st.output_points)
    zero = torch.zeros(shape, device=device,
                       dtype=torch.complex64 if st.iq else torch.float32)
    if st.coherency_weighting:
        return zero, torch.zeros(shape, device=device)
    return zero


def das_ref(rf: torch.Tensor, dyn: dict, st: DasStatic):
    """Plain-torch DAS of one frame ``rf`` (C, A, S) float32 or complex64,
    or of ``st.frame_batch = B > 1`` frames (B, C, A, S), one after the
    other (what the JAX package's ``vmap`` computes).  Returns the
    (nx, ny, nz) coherent volume, or (B, nx, ny, nz) volumes, or
    ``(coherent, incoherent)`` of those with coherency weighting."""
    if st.frame_batch > 1:
        if rf.dim() != 4 or rf.shape[0] != st.frame_batch:
            raise ValueError(f"rf shape {tuple(rf.shape)} is not a batch of "
                             f"{st.frame_batch} frames (B, C, A, S)")
        st1 = dataclasses.replace(st, frame_batch=1)
        outs = [das_ref(frame, dyn, st1) for frame in rf]
        if st.coherency_weighting:
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)
    if st.family == "none":
        # no das.glsl dispatch case for this kind: the frame stays zero
        return _zero_frame(st, rf.device)
    block = _FAMILY_BLOCK[st.family]
    out, inco = block(st, dyn, rf, _world_points(st, dyn))
    shape = st.output_points
    if st.coherency_weighting:
        return out.reshape(shape), inco.reshape(shape)
    return out.reshape(shape)


def das(rf: torch.Tensor, dyn: dict, st: DasStatic):
    """DAS one frame or a batch: the CUDA kernel for a CUDA tensor, the
    plain twin for a CPU tensor (same signature and outputs as
    :func:`das_ref`)."""
    if rf.is_cuda:
        if st.family == "none":
            return _zero_frame(st, rf.device)
        from .das_cuda import das_cuda      # das_cuda imports this module
        return das_cuda(rf, dyn, st)
    if rf.device.type != "cpu":
        raise ValueError(f"no DAS for device {rf.device}")
    return das_ref(rf, dyn, st)


def das_from_params(rf, p: DasParams, device="cuda"):
    """The golden ``das(rf, params)`` API on the port: ``make_static``,
    ``make_dynamic`` and :func:`das` in one call.  A numpy ``rf`` goes to
    ``device`` (the GPU unless told otherwise; raises without one); a
    tensor stays where it is, so a CUDA tensor takes the kernel and a CPU
    tensor the twin."""
    if not isinstance(rf, torch.Tensor):
        rf = torch.from_numpy(np.ascontiguousarray(rf)).to(
            resolve_device(device))
    st = make_static(p, iq=rf.is_complex())
    return das(rf, make_dynamic(p, rf.device), st)
