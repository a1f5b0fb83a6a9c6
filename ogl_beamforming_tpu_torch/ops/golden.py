"""NumPy golden-reference implementations of every compute stage.

The reference repo has no numerical test oracle (SURVEY.md §4) — its GLSL
shaders are validated against out-of-repo MATLAB.  This module *is* that
oracle for the TPU framework: a direct, scalar-faithful NumPy model of each
shader, written for clarity over speed.  The JAX/Pallas ops are tested to
<= 1e-3 NRMSE against these functions.

Canonical logical layout for RF data is ``(channels, acquisitions, samples)``
— matching the reference's DAS-ready buffer layout (das.glsl:212-226, stride
table in beamformer_core.c:527-533).

Shader provenance:
  * decode      -> shaders/decode.glsl
  * filter/demodulate -> shaders/filter.glsl (+ planner beamformer_core.c:680-726)
  * das_*       -> shaders/das.glsl
  * coherency_weighting -> shaders/coherency_weighting.glsl
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params.enums import (AcquisitionKind, InterpolationMode, RCAOrientation,
                            unpack_tx_rx_orientation)

C_SPLINE = 0.5  # Catmull-Rom tension (das.glsl:49)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def decode_hadamard(rf: np.ndarray, hadamard: np.ndarray) -> np.ndarray:
    """Hadamard decode: ``out[c, t, s] = sum_j H[t, j] rf[c, j, s] / T``.

    Matches decode.glsl:120-150 (``run_decode_small``/``run_decode_large``):
    the shader accumulates ``result[t] += rf[j] * H_T[j, t]`` against the
    *transposed* Hadamard buffer, i.e. contracts with ``H[t, j]``, then
    divides by the transmit count.

    ``rf``: (C, A, S) real or complex.  ``hadamard``: (A, A) row-major
    (``utils.hadamard.hadamard``).
    """
    a = rf.shape[1]
    h = np.asarray(hadamard, np.float32)
    assert h.shape == (a, a)
    out = np.einsum("tj,cjs->cts", h, rf.astype(np.promote_types(rf.dtype,
                                                                 np.float32)))
    return out / np.float32(a)


# ---------------------------------------------------------------------------
# Filter / Demodulate
# ---------------------------------------------------------------------------

def fir_filter(rf: np.ndarray, taps: np.ndarray, decimation_rate: int = 1
               ) -> np.ndarray:
    """FIR along the sample axis: ``y[n] = sum_j x[D n - (L-1) + j] h[j]``.

    Matches filter.glsl:114-118 with the cache offset of filter.glsl:89-92:
    output sample ``n`` correlates the taps against input samples ending at
    ``D*n`` (zero-padded below 0).  Complex taps use the full complex product
    (filter.glsl:50-55).  Output sample count is ``S // D``.
    """
    taps = np.asarray(taps)
    length = len(taps)
    s = rf.shape[-1]
    out_dtype = np.promote_types(np.promote_types(rf.dtype, taps.dtype),
                                 np.float32)
    pad = [(0, 0)] * (rf.ndim - 1) + [(length - 1, length - 1)]
    x = np.pad(rf.astype(out_dtype), pad)
    # x index (padded) for output n, tap j: D*n + j; valid input window only.
    n_out = s // decimation_rate
    idx = (decimation_rate * np.arange(n_out)[:, None]
           + np.arange(length)[None, :])
    gathered = x[..., :s + length - 1][..., idx]      # (..., n_out, L)
    return np.einsum("...nl,l->...n", gathered, taps.astype(out_dtype))


def demodulate(rf: np.ndarray, taps: np.ndarray, demodulation_frequency: float,
               sampling_frequency: float, decimation_rate: int = 1,
               complex_filter: bool = False) -> np.ndarray:
    """Demodulation: implicit-IQ pairing, baseband rotation, FIR + decimate.

    Matches filter.glsl:57-64,99-118 with the planner's convention
    (beamformer_core.c:709-721): the sampler is treated as alternating I/Q,
    so ``IQ[n] = RF[2n] - j RF[2n+1]`` at pair rate ``fs/2``; each pair is
    rotated by ``exp(-j 2 pi f_demod n / (fs/2))`` and scaled by ``sqrt(2)``
    (unless the filter itself is complex), then FIR-filtered with decimation.

    NOTE: the reference shader computes the rotation phase from the
    *workgroup-local* cache index (filter.glsl:101-107), which adds a
    spurious per-workgroup phase offset unless the demodulation frequency is
    workgroup-periodic.  This model uses the absolute pair index — the
    mathematically intended behavior (and identical whenever
    ``f_demod * D * workgroup_span / (fs/2)`` is an integer, the typical
    4-points-per-wavelength configuration).

    ``rf``: real (..., S_raw).  Returns complex64 (..., S_raw // 2 // D).
    """
    s_pairs = rf.shape[-1] // 2
    i = rf[..., : 2 * s_pairs : 2].astype(np.float32)
    q = rf[..., 1 : 2 * s_pairs : 2].astype(np.float32)
    iq = i - 1j * q

    pair_fs = sampling_frequency / 2.0
    n = np.arange(s_pairs, dtype=np.float32)
    phase = np.exp(-1j * (2 * np.pi * demodulation_frequency / pair_fs) * n)
    scale = 1.0 if complex_filter else np.sqrt(2.0)
    iq = (scale * iq * phase).astype(np.complex64)

    return fir_filter(iq, taps, decimation_rate).astype(np.complex64)


def hilbert(rf: np.ndarray) -> np.ndarray:
    """Analytic signal along the sample axis (FFT method).

    The reference offloads this to an optional CUDA plugin
    (beamformer_internal.h:225-252, currently force-disabled); the TPU
    framework implements it natively via FFT.
    """
    x = np.asarray(rf, np.float32)
    n = x.shape[-1]
    xf = np.fft.fft(x, axis=-1)
    h = np.zeros(n, np.float32)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[1:(n + 1) // 2] = 2
    return (np.fft.ifft(xf * h, axis=-1)).astype(np.complex64)


# ---------------------------------------------------------------------------
# DAS helpers
# ---------------------------------------------------------------------------

def _interp_nearest(line: np.ndarray, index: np.ndarray) -> np.ndarray:
    s = line.shape[-1]
    valid = (np.floor(index) >= 0) & (np.round(index) < s)
    idx = np.clip(np.round(index).astype(np.int64), 0, s - 1)
    return np.where(valid, line[..., idx], 0)


def _interp_linear(line: np.ndarray, index: np.ndarray) -> np.ndarray:
    s = line.shape[-1]
    k = np.floor(index)
    valid = (k >= 0) & (k < s - 1)
    kk = np.clip(k.astype(np.int64), 0, s - 2)
    t = (index - k).astype(np.float32)
    return np.where(valid, (1 - t) * line[..., kk] + t * line[..., kk + 1], 0)


def _interp_cubic(line: np.ndarray, index: np.ndarray) -> np.ndarray:
    """Catmull-Rom / Hermite 4-tap (das.glsl:64-95,114-118)."""
    s = line.shape[-1]
    k = np.floor(index)
    valid = (k > 0) & (k < s - 2)
    kk = np.clip(k.astype(np.int64), 1, s - 3)
    t = (index - k).astype(np.float32)
    p0 = line[..., kk - 1]
    p1 = line[..., kk]
    p2 = line[..., kk + 1]
    p3 = line[..., kk + 2]
    t1 = C_SPLINE * (p2 - p0)
    t2 = C_SPLINE * (p3 - p1)
    t2_ = t * t
    t3 = t2_ * t
    val = ((2 * t3 - 3 * t2_ + 1) * p1 + (-2 * t3 + 3 * t2_) * p2
           + (t3 - 2 * t2_ + t) * t1 + (t3 - t2_) * t2)
    return np.where(valid, val, 0)


_INTERP = {
    InterpolationMode.Nearest: _interp_nearest,
    InterpolationMode.Linear: _interp_linear,
    InterpolationMode.Cubic: _interp_cubic,
}


def sample_rf(line: np.ndarray, index: np.ndarray, mode: InterpolationMode,
              sampling_frequency: float, demodulation_frequency: float,
              iq: bool) -> np.ndarray:
    """Interpolated RF lookup with IQ phase rotation (das.glsl:97-122).

    ``line``: (S,) one channel/transmit's samples.  ``index``: fractional
    sample positions (any shape).  IQ data is rotated by
    ``exp(+j 2 pi f_demod index / fs)`` (das.glsl:51-59 — note the positive
    rotation, undoing the demodulation mix-down at the echo time).
    """
    val = _INTERP[mode](line, index)
    if iq:
        arg = (2 * np.pi * demodulation_frequency
               * (index / sampling_frequency)).astype(np.float32)
        val = val * np.exp(1j * arg)
    return val


def apodize(arg: np.ndarray) -> np.ndarray:
    """cos^2 F-number apodization (das.glsl:136-150); caller masks arg>=0.5."""
    a = np.cos(np.pi * arg)
    return (a * a).astype(np.float32)


@dataclass
class DasParams:
    """Bake + push-constant parameters for a DAS dispatch.

    Mirrors BeamformerDASBakeParameters + DAS push constants
    (generated/beamformer.c:198-217,243-257).  Matrices are row-major with
    ``world = M @ [p, 1]``.
    """

    acquisition_kind: AcquisitionKind = AcquisitionKind.FORCES
    acquisition_count: int = 0
    channel_count: int = 0
    sample_count: int = 0
    sampling_frequency: float = 0.0
    demodulation_frequency: float = 0.0
    speed_of_sound: float = 1540.0
    time_offset: float = 0.0
    interpolation_mode: InterpolationMode = InterpolationMode.Linear
    f_number: float = 1.0
    voxel_transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    xdc_transform: np.ndarray = field(default_factory=lambda: np.eye(4, dtype=np.float32))
    xdc_element_pitch: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))
    output_points: tuple[int, int, int] = (1, 1, 1)
    # RCA / orientation:
    single_orientation: bool = True
    transmit_receive_orientation: int = 0
    single_focus: bool = True
    transmit_angle: float = 0.0      # degrees (focal_vector.x)
    focus_depth: float = np.inf
    focal_vectors: np.ndarray | None = None            # (A, 2) degrees, meters
    transmit_receive_orientations: np.ndarray | None = None  # (A,) packed u8
    # Sparse (UFORCES/UHERCULES):
    sparse: bool = False
    sparse_elements: np.ndarray | None = None          # (MaxEmissions,) i16
    # READI:
    readi_group_count: int = 0
    readi_group: int = 0
    das_hadamard: np.ndarray | None = None             # (G, G) transposed form
    coherency_weighting: bool = False

    def world_points(self) -> np.ndarray:
        """Voxel-center world points, shape (nx, ny, nz, 3) (das.glsl:368-376)."""
        from ..utils.transforms import voxel_world_points
        return voxel_world_points(self.voxel_transform, self.output_points)

    def sample_index(self, distance: np.ndarray) -> np.ndarray:
        """(distance / c + time_offset) * fs (das.glsl:124-128)."""
        return ((distance / self.speed_of_sound + self.time_offset)
                * self.sampling_frequency).astype(np.float32)

    def orientation_for(self, acquisition: int) -> tuple[RCAOrientation, RCAOrientation]:
        """(tx, rx) orientation for an acquisition (das.glsl:170-176)."""
        if self.single_orientation or self.transmit_receive_orientations is None:
            packed = int(self.transmit_receive_orientation)
        else:
            packed = int(self.transmit_receive_orientations[acquisition])
        return unpack_tx_rx_orientation(packed)

    def focal_vector_for(self, acquisition: int) -> tuple[float, float]:
        """(transmit_angle_degrees, focal_depth) (das.glsl:178-183)."""
        if self.single_focus or self.focal_vectors is None:
            return float(self.transmit_angle), float(self.focus_depth)
        fv = self.focal_vectors[acquisition]
        return float(fv[0]), float(fv[1])


def _accum_dtype(iq: bool):
    return np.complex64 if iq else np.float32


def _sample(p: DasParams, line: np.ndarray, index: np.ndarray, iq: bool):
    return sample_rf(line, index, p.interpolation_mode, p.sampling_frequency,
                     p.demodulation_frequency, iq)


# ---------------------------------------------------------------------------
# DAS acquisition families
# ---------------------------------------------------------------------------

def _rca_plane_projection(points: np.ndarray, rows: bool) -> np.ndarray:
    """Project to (lateral, z): lateral = y if rows else x (das.glsl:152-156)."""
    lat = points[..., 1] if rows else points[..., 0]
    return np.stack([lat, points[..., 2]], axis=-1)


def _rca_transmit_distance(p: DasParams, world: np.ndarray, focal_vector,
                           tx_orientation: RCAOrientation) -> np.ndarray:
    """Plane- or cylindrical-wave transmit distance (das.glsl:158-200)."""
    if tx_orientation == RCAOrientation.NoOrientation:
        return np.zeros(world.shape[:-1], np.float32)
    tx_rows = tx_orientation == RCAOrientation.Rows
    angle = np.radians(np.float32(focal_vector[0]))
    depth = np.float32(focal_vector[1])
    proj = _rca_plane_projection(world, tx_rows)
    if np.isinf(depth):
        return (proj[..., 0] * np.sin(angle) + proj[..., 1] * np.cos(angle)
                ).astype(np.float32)
    f = np.array([depth * np.sin(angle), depth * np.cos(angle)], np.float32)
    return np.linalg.norm(proj - f, axis=-1).astype(np.float32)


def das_rca(rf: np.ndarray, p: DasParams) -> np.ndarray:
    """Flash / RCA_TPW / RCA_VLS (das.glsl:202-229).

    ``rf``: (C, A, S).  Returns (nx, ny, nz) accumulated voxels (complex when
    ``rf`` is complex); with coherency weighting also returns the incoherent
    accumulator — see :func:`das`.
    """
    iq = np.iscomplexobj(rf)
    world = p.world_points()
    out = np.zeros(world.shape[:-1], _accum_dtype(iq))
    inco = np.zeros(world.shape[:-1], np.float32)
    xdc_world = world @ p.xdc_transform[:3, :3].T + p.xdc_transform[:3, 3]

    for acq in range(p.acquisition_count):
        tx_o, rx_o = p.orientation_for(acq)
        rx_rows = rx_o == RCAOrientation.Rows
        fv = p.focal_vector_for(acq)
        xdc_proj = _rca_plane_projection(xdc_world, rx_rows)
        tx_dist = _rca_transmit_distance(p, world, fv, tx_o)

        for ch in range(p.channel_count):
            rx_center = np.array([ch * p.xdc_element_pitch[0],
                                  ch * p.xdc_element_pitch[1], 0], np.float32)
            rx_proj = _rca_plane_projection(rx_center, rx_rows)
            recv = xdc_proj - rx_proj
            a_arg = np.abs(p.f_number * recv[..., 0]
                           / np.abs(xdc_proj[..., 1]))
            mask = a_arg < 0.5
            sidx = p.sample_index(tx_dist + np.linalg.norm(recv, axis=-1))
            val = apodize(np.where(mask, a_arg, 0)) * _sample(p, rf[ch, acq], sidx, iq)
            val = np.where(mask, val, 0)
            out += val
            if p.coherency_weighting:
                inco += np.abs(val).astype(np.float32)
    return (out, inco) if p.coherency_weighting else out


def das_hercules(rf: np.ndarray, p: DasParams) -> np.ndarray:
    """HERCULES / UHERCULES / HERO-PA (das.glsl:231-284)."""
    iq = np.iscomplexobj(rf)
    world = p.world_points()
    out = np.zeros(world.shape[:-1], _accum_dtype(iq))
    inco = np.zeros(world.shape[:-1], np.float32)

    tx_o, rx_o = p.orientation_for(0)
    rx_cols = rx_o == RCAOrientation.Columns
    fv = p.focal_vector_for(0)
    xdc_world = world @ p.xdc_transform[:3, :3].T + p.xdc_transform[:3, 3]

    tx_index = p.sample_index(_rca_transmit_distance(p, world, fv, tx_o))
    z = xdc_world[..., 2]
    z2 = z * z
    fnum_over_z = np.abs(p.f_number / z)
    apod_test = 0.25 / (fnum_over_z * fnum_over_z)
    xw, yw = xdc_world[..., 0], xdc_world[..., 1]
    px, py = float(p.xdc_element_pitch[0]), float(p.xdc_element_pitch[1])

    sparse = int(p.sparse)
    for ch in range(p.channel_count):
        if rx_cols:
            rx_d2 = (xw - ch * px) ** 2
        else:
            rx_d2 = (yw - ch * py) ** 2
        for transmit in range(sparse, p.acquisition_count):
            if p.sparse:
                tx_ch = int(p.sparse_elements[transmit - sparse])
            else:
                tx_ch = transmit
            if rx_cols:
                tx_d2 = (yw - tx_ch * py) ** 2
            else:
                tx_d2 = (xw - tx_ch * px) ** 2
            d2 = rx_d2 + tx_d2
            mask = d2 < apod_test
            # NOTE: first-transmit 1/sqrt(N) weight — "tribal knowledge"
            # (das.glsl:271-273).
            apod = (1.0 / np.sqrt(p.acquisition_count) if transmit == 0 else 1.0)
            apod = apod * apodize(np.where(mask, fnum_over_z * np.sqrt(d2), 0))
            index = tx_index + (np.sqrt(z2 + d2) * p.sampling_frequency
                                / p.speed_of_sound)
            val = apod * _sample(p, rf[ch, transmit], index, iq)
            val = np.where(mask, val, 0)
            out += val
            if p.coherency_weighting:
                inco += np.abs(val).astype(np.float32)
    return (out, inco) if p.coherency_weighting else out


def das_forces(rf: np.ndarray, p: DasParams) -> np.ndarray:
    """FORCES / UFORCES (das.glsl:286-319).

    The voxel transform is expected to already include the XDC transform
    (planner: beamformer_core.c:760-763 premultiplies for FORCES kinds).
    """
    iq = np.iscomplexobj(rf)
    world = p.world_points()          # already xdc space for FORCES
    out = np.zeros(world.shape[:-1], _accum_dtype(iq))
    inco = np.zeros(world.shape[:-1], np.float32)

    x, y, z = world[..., 0], world[..., 1], world[..., 2]
    z2 = z * z
    px, py = float(p.xdc_element_pitch[0]), float(p.xdc_element_pitch[1])
    ty = y - py * p.channel_count / 2
    t_yz2 = ty * ty + z2

    sparse = int(p.sparse)
    for ch in range(p.channel_count):
        rx_dx = x - ch * px
        a_arg = np.abs(p.f_number * rx_dx / z)
        mask = a_arg < 0.5
        apod = apodize(np.where(mask, a_arg, 0))
        rx_index = p.sample_index(np.sqrt(rx_dx * rx_dx + z2))
        for transmit in range(sparse, p.acquisition_count):
            if p.sparse:
                tx_ch = int(p.sparse_elements[transmit - sparse])
            else:
                tx_ch = transmit
            tx_dx = x - px * tx_ch
            tx_index = (np.sqrt(t_yz2 + tx_dx * tx_dx)
                        * p.sampling_frequency / p.speed_of_sound)
            val = apod * _sample(p, rf[ch, transmit], rx_index + tx_index, iq)
            val = np.where(mask, val, 0)
            out += val
            if p.coherency_weighting:
                inco += np.abs(val).astype(np.float32)
    return (out, inco) if p.coherency_weighting else out


def das_readi_forces(rf: np.ndarray, p: DasParams) -> np.ndarray:
    """READI-grouped FORCES (das.glsl:321-366).

    Transmit elements are grouped into ``readi_group_count`` groups of
    ``acquisition_count`` sequential elements; group ``g`` is weighted by the
    *transposed* DAS Hadamard ``H_T[readi_group, g]``
    (beamformer_core.c:1077 uploads with row_major=0).
    """
    iq = np.iscomplexobj(rf)
    world = p.world_points()
    out = np.zeros(world.shape[:-1], _accum_dtype(iq))
    inco = np.zeros(world.shape[:-1], np.float32)

    x, y, z = world[..., 0], world[..., 1], world[..., 2]
    z2 = z * z
    px, py = float(p.xdc_element_pitch[0]), float(p.xdc_element_pitch[1])
    ty = y - py * p.channel_count / 2
    t_yz2 = ty * ty + z2
    hrow = np.asarray(p.das_hadamard, np.float32)[p.readi_group]

    for ch in range(p.channel_count):
        rx_dx = x - ch * px
        a_arg = np.abs(p.f_number * rx_dx / z)
        mask = a_arg < 0.5
        apod = apodize(np.where(mask, a_arg, 0))
        rx_index = p.sample_index(np.sqrt(rx_dx * rx_dx + z2))
        for group in range(p.readi_group_count):
            gapod = apod * hrow[group]
            for event in range(p.acquisition_count):
                tx_el = group * p.acquisition_count + event
                tx_dx = x - px * tx_el
                tx_index = (np.sqrt(t_yz2 + tx_dx * tx_dx)
                            * p.sampling_frequency / p.speed_of_sound)
                val = gapod * _sample(p, rf[ch, event], rx_index + tx_index, iq)
                val = np.where(mask, val, 0)
                out += val
                if p.coherency_weighting:
                    inco += np.abs(val).astype(np.float32)
    return (out, inco) if p.coherency_weighting else out


def das(rf: np.ndarray, p: DasParams):
    """Dispatch on acquisition kind (das.glsl:368-400).

    Returns the coherent volume, or ``(coherent, incoherent)`` when
    ``p.coherency_weighting``.
    """
    family = p.acquisition_kind.das_family
    if family == "forces":
        if p.readi_group_count > 1:
            return das_readi_forces(rf, p)
        return das_forces(rf, p)
    if family == "hercules":
        return das_hercules(rf, p)
    if family == "rca":
        return das_rca(rf, p)
    # No dispatch case in the reference (das.glsl:381-400): zero frame.
    shape = tuple(int(v) for v in p.output_points)
    zero = np.zeros(shape, _accum_dtype(np.iscomplexobj(rf)))
    if p.coherency_weighting:
        return zero, np.zeros(shape, np.float32)
    return zero


def coherency_weighting(coherent: np.ndarray, incoherent: np.ndarray,
                        scale: float = 1.0) -> np.ndarray:
    """coherent *= scale * coherent / incoherent
    (coherency_weighting.glsl:34-41; scale = 1, beamformer_core.c:1299).

    For IQ data the GLSL ``vec2 * vec2`` product is componentwise — each of
    re/im is squared and divided by the scalar incoherent sum.
    """
    with np.errstate(divide="ignore", invalid="ignore"):
        w = np.where(incoherent != 0, scale / incoherent, 0.0)
    if np.iscomplexobj(coherent):
        return (coherent.real ** 2 * w + 1j * (coherent.imag ** 2 * w)
                ).astype(coherent.dtype)
    return (coherent * coherent * w).astype(coherent.dtype)


# ---------------------------------------------------------------------------
# Display / reductions
# ---------------------------------------------------------------------------

def sum_frames(frames: np.ndarray, scale: float | None = None) -> np.ndarray:
    """Frame averaging (shaders/sum.glsl: out += scale * in per frame)."""
    n = frames.shape[0]
    if scale is None:
        scale = 1.0 / n
    return (frames.sum(axis=0) * scale).astype(frames.dtype)


def min_max_mips(volume: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """Mip-style min/max reduction pyramid (shaders/min_max.glsl)."""
    mips = []
    v_min = v_max = np.abs(volume)
    while True:
        mips.append((v_min, v_max))
        if all(d <= 1 for d in v_min.shape):
            break
        def _reduce(a, op):
            for ax in range(a.ndim):
                if a.shape[ax] > 1:
                    pairs = a.shape[ax] // 2 * 2
                    sl = [slice(None)] * a.ndim
                    sl[ax] = slice(0, pairs)
                    b = a[tuple(sl)]
                    shp = list(b.shape)
                    shp[ax] = shp[ax] // 2
                    b = op(b.reshape(shp[:ax] + [shp[ax], 2] + shp[ax + 1:]),
                           axis=ax + 1)
                    a = b
            return a
        v_min = _reduce(v_min, np.min)
        v_max = _reduce(v_max, np.max)
    return mips


def display_map(volume: np.ndarray, db_cutoff: float = -60.0,
                threshold: float = 1.0, gamma: float = 1.0) -> np.ndarray:
    """Log-compress + threshold + gamma display mapping
    (render_3d.frag.glsl:61-70): normalized |v| -> dB -> clamp -> gamma.
    """
    mag = np.abs(volume).astype(np.float32)
    peak = mag.max() if mag.size else 1.0
    peak = peak if peak > 0 else 1.0
    mag = mag / peak
    with np.errstate(divide="ignore"):
        db = 20.0 * np.log10(np.maximum(mag, 1e-30))
    db = np.clip(db, db_cutoff, 0.0)
    out = 1.0 - db / db_cutoff
    out = np.minimum(out, threshold)
    return np.power(out, gamma).astype(np.float32)
