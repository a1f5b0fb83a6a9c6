#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (ogl_beamforming_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one line or more each; any failure exits non-zero before the last
line:

  1. device   a CUDA device must be present; prints its name and
              ``nvidia-smi`` name/power limit.
  2. build    compiles csrc/*.cu with nvcc for sm_90a (kernels/build.py),
              one nvcc per source, all started together.
  3. kernels  each kernel against its plain-torch twin on the card at its
              path's shapes: int16 decode (128, 128, 4096) bit-equal, an
              order-12 and a float32 decode to 1e-6 of the peak, FORCES
              cubic DAS 128 ch x 128 tx x 4096 samples -> 512 x 1024 voxels,
              FORCES cubic IQ DAS at path B's DAS stage (complex64 128 x 128
              x 2048 at 20 MHz, the filter's delay in the time offset) and
              RCA Flash cubic IQ DAS 256 ch x 1 x 4096 complex samples ->
              512 x 1024 to NRMSE 1e-4, demodulate int16 (128, 128, 4096)
              with the 16-tap Kaiser low-pass (and a complex chirp at D = 2)
              and FIR complex64 (128, 128, 2048) with real and complex taps
              to NRMSE 1e-6; CUDA-event times of the kernel (median and
              interquartile range of 21 runs), its twin (median of 5) and,
              where one PyTorch call computes the same function, that call
              (median of 21); and each kernel's bound from its bytes and
              operations.
  4. canary   reduced configurations through Beamformer(device="cuda")
              against the NumPy golden oracle, NRMSE <= 1e-3: FORCES decode
              -> DAS; path A (plane-wave Flash IQ); path B (Demodulate ->
              Decode -> FORCES IQ DAS); [Decode, Filter (complex matched
              chirp), DAS] on baseband data; [Decode, Hilbert, DAS].
  5. main     three paths at full width through Beamformer(device="cuda"),
              each a warmup and then 5 frames of a point-target acquisition
              with the launch counts set to 0 just before and read just
              after; the image peak must land within one voxel of the
              target and each kernel of the path must launch once per
              frame:
                main        the Quickstart (forces_compounding without
                            demodulation, 128 x 128 x 4096 -> 512 x 1024);
                main_rca    path A, the plane-wave headline (plane_wave_2d,
                            Float32Complex, 256 ch x 4096 -> 512 x 1024);
                main_demod  path B, the preset's default demodulate chain
                            (forces_compounding, 128 x 128 x 4096 int16,
                            16-tap Kaiser at the pair rate).
              Prints device ms/frame with the stage split and ms/frame end
              to end.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

RUNS = 5          # frames per main path, and timed runs of a plain twin
TIMED_RUNS = 21   # timed runs of a kernel or library call

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit): device
# memory rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# float32 operations per active pair of a DAS kernel, counted from
# csrc/das.cu (a square root, division, cosine or sincos counts as one):
# FORCES real cubic: transmit leg 5, index 1, cubic tap 26, weights and sum 3;
# FORCES IQ cubic: transmit leg 5, index 1, complex cubic tap 35, rotation 10,
# weights and sum 5; RCA IQ cubic: receive leg 16, complex cubic tap 35,
# rotation 10, scale and sum 4.
OPS_FORCES_REAL_CUBIC = 35
OPS_FORCES_IQ_CUBIC = 56
OPS_RCA_IQ_CUBIC = 65

PKG = "ogl_beamforming_tpu_torch"
TPU = "ogl_beamforming_tpu"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def nrmse(ref: np.ndarray, test: np.ndarray) -> float:
    denom = np.sqrt(np.mean(np.abs(ref) ** 2))
    return float(np.sqrt(np.mean(np.abs(test - ref) ** 2)) / denom)


def times_ms(fn, runs: int) -> list[float]:
    """CUDA-event times of ``runs`` runs of ``fn`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def median_ms(fn, runs: int = TIMED_RUNS) -> float:
    return statistics.median(times_ms(fn, runs))


def kernel_ms(fn) -> tuple[float, float]:
    """Median and interquartile range of ``fn``'s time over TIMED_RUNS."""
    times = times_ms(fn, TIMED_RUNS)
    q1, _, q3 = statistics.quantiles(times, n=4)
    return statistics.median(times), q3 - q1


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` of device memory traffic and
    ``nops`` float32 operations, and which of the two sets it."""
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    o = nops / PEAK_F32_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def kernel_row(name, source, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms=None) -> dict:
    bound_ms, bound_by = bound(nbytes, nops)
    return dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
                replaces=f"{TPU}/{replaces}", launches=0,
                max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def compare(kernel_out, plain_out, tol: float, label: str) -> float:
    """NRMSE of kernel vs twin must be <= tol; returns the max abs error."""
    torch.cuda.synchronize()
    k, p = kernel_out.cpu().numpy(), plain_out.cpu().numpy()
    check(k.shape == p.shape and k.dtype == p.dtype,
          f"{label}: kernel {k.shape} {k.dtype} vs twin {p.shape} {p.dtype}")
    check(np.isfinite(k).all(), f"{label}: kernel output not finite")
    err = nrmse(p, k)
    check(err <= tol, f"{label}: NRMSE {err:.3e} > {tol:g}")
    return float(np.abs(k - p).max())


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; devices: {torch.cuda.device_count()}")
    print(smi_line)
    return name, smi_line


def phase_build() -> None:
    from ogl_beamforming_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    log = build.library_path().with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln] if log.exists() else []
    print(f"[build] {build.library_path().name} in {dt:.1f} s "
          f"(ptxas: {len(regs)} kernels; {'; '.join(regs[:3])})")


def active_pairs(st, dyn) -> int:
    """(voxel, channel, transmit-or-acquisition) triples inside the
    apodization mask: the pairs the DAS kernels compute."""
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    world = das_ops._world_points(st, dyn)
    chans = das_ops._channels(dyn, st.channel_count)
    fnum = dyn["f_number"]
    if st.family == "forces":
        x, z = world[:, 0:1], world[:, 2:3]
        rx_dx = x - chans[None] * dyn["xdc_element_pitch"][0]
        on = torch.abs(fnum * rx_dx / z) < 0.5
        return int(on.sum()) * st.acquisition_count
    xdc = das_ops._apply_m4(dyn["xdc_transform"], world)
    tabs = das_ops.rca_tables(dyn)
    total = 0
    for a in range(st.acquisition_count):
        rows = bool(tabs[a, 1] == 1.0)
        lat = xdc[:, 1:2] if rows else xdc[:, 0:1]
        pitch = dyn["xdc_element_pitch"][1 if rows else 0]
        recv_lat = lat - chans[None] * pitch
        total += int((torch.abs(fnum * recv_lat / torch.abs(xdc[:, 2:3]))
                      < 0.5).sum())
    return total


def phase_kernels(dev) -> list[dict]:
    import torch.nn.functional as F

    from ogl_beamforming_tpu_torch import (DataKind, FilterKind,
                                           FilterParameters,
                                           KaiserFilterParameters,
                                           MatchedChirpFilterParameters)
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import das_cuda, decode, filtering
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    from ogl_beamforming_tpu_torch.utils.filters import make_filter

    rng = np.random.default_rng(1234)
    rows = []

    # decode, int16 at the main path's shape: bit-equal
    c, a, s = 128, 128, 4096
    rf = torch.from_numpy(rng.integers(-32768, 32767, (c, a, s),
                                       dtype=np.int16)).to(dev)
    h = decode.hadamard_matrix(a, device=dev)
    out_k = decode.decode_hadamard_cuda(rf, h)
    out_p = decode.decode_hadamard_ref(rf, h)
    torch.cuda.synchronize()
    check(torch.equal(out_k, out_p), "int16 decode kernel != plain twin")
    dec_err = float((out_k - out_p).abs().max())
    dec_ms, dec_iqr = kernel_ms(lambda: decode.decode_hadamard_cuda(rf, h))
    dec_plain_ms = median_ms(lambda: decode.decode_hadamard_ref(rf, h), RUNS)
    rf32 = rf.to(torch.float32)
    dec_lib_ms = median_ms(lambda: torch.matmul(h, rf32))
    print(f"[kernels] decode int16 {c}x{a}x{s}: bit-equal; kernel "
          f"{dec_ms:.3f} ms (IQR {dec_iqr:.3f}), plain {dec_plain_ms:.3f} ms, cuBLAS f32 "
          f"matmul {dec_lib_ms:.3f} ms")
    rows.append(kernel_row(
        "decode_hadamard", "decode.cu", "ops/decode.py:247", dec_err, dec_ms,
        dec_plain_ms, rf.numel() * 2 + out_k.numel() * 4 + a * a * 4,
        2.0 * c * a * a * s, dec_lib_ms))
    del rf32, out_k, out_p

    # decode, order 12 (int16) and float32: max error <= 1e-6 of the peak
    for label, shape, f32 in (("order-12 int16", (c, 12, s), False),
                              ("float32", (c, a, s), True)):
        x = (rng.standard_normal(shape).astype(np.float32) * 1000 if f32
             else rng.integers(-32768, 32767, shape, dtype=np.int16))
        x = torch.from_numpy(x).to(dev)
        hh = decode.hadamard_matrix(shape[1], device=dev)
        k = decode.decode_hadamard_cuda(x, hh)
        p = decode.decode_hadamard_ref(x, hh)
        rel = float((k - p).abs().max() / p.abs().max())
        check(rel <= 1e-6, f"{label} decode max relative error {rel:.3e}")
        print(f"[kernels] decode {label} {tuple(shape)}: max rel err "
              f"{rel:.3e}, bit-equal {torch.equal(k, p)}")

    # DAS, FORCES cubic real at the Quickstart's shape
    params, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=128, sample_count=4096,
        demodulate=False)
    plan = build_plan(params, pipe, {}, device=dev)
    st = plan.descriptor.stages[-1].das
    dyn = plan.dyn["das"]
    rf = torch.from_numpy(
        rng.standard_normal((c, a, s), dtype=np.float32)).to(dev)
    das_k = das_cuda.das_cuda(rf, dyn, st)
    das_p = das_ops.das_ref(rf, dyn, st)
    das_err = compare(das_k, das_p, 1e-4, "FORCES DAS")
    das_nrmse = nrmse(das_p.cpu().numpy(), das_k.cpu().numpy())
    das_ms, das_iqr = kernel_ms(lambda: das_cuda.das_cuda(rf, dyn, st))
    das_plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, st), RUNS)
    pairs = active_pairs(st, dyn)
    print(f"[kernels] DAS FORCES cubic {c}x{a}x{s} -> {st.output_points}: "
          f"NRMSE {das_nrmse:.3e}, max abs err {das_err:.3e}; kernel "
          f"{das_ms:.3f} ms (IQR {das_iqr:.3f}), plain {das_plain_ms:.3f} "
          f"ms; {pairs} active "
          f"pairs")
    rows.append(kernel_row(
        "das_forces", "das.cu", "ops/das_pallas.py:1963", das_err, das_ms,
        das_plain_ms, rf.numel() * 4 + das_k.numel() * 4,
        OPS_FORCES_REAL_CUBIC * pairs))
    del rf, das_k, das_p

    # DAS, FORCES cubic IQ at path B's DAS stage: the plan of the preset's
    # demodulate chain, with path B's Kaiser taps in slot 0
    fs, fd = 40e6, 7.8e6
    kaiser = make_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs / 2,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16)))
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s)
    plan = build_plan(params, pipe, {0: kaiser}, device=dev)
    st = plan.descriptor.stages[-1].das
    dyn = plan.dyn["das"]
    check(st.iq and st.sample_count == s // 2,
          f"path B's DAS stage is not IQ over {s // 2} samples: {st}")
    shape = (c, a, st.sample_count)
    rf = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    iq_k = das_cuda.das_cuda(rf, dyn, st)
    iq_p = das_ops.das_ref(rf, dyn, st)
    iq_err = compare(iq_k, iq_p, 1e-4, "FORCES IQ DAS")
    iq_nrmse = nrmse(iq_p.cpu().numpy(), iq_k.cpu().numpy())
    iq_ms, iq_iqr = kernel_ms(lambda: das_cuda.das_cuda(rf, dyn, st))
    iq_plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, st), RUNS)
    pairs = active_pairs(st, dyn)
    print(f"[kernels] DAS FORCES cubic IQ {shape} at "
          f"{float(dyn['sampling_frequency']) / 1e6:g} MHz, t0 "
          f"{float(dyn['time_offset']):.4e} s -> {st.output_points}: NRMSE "
          f"{iq_nrmse:.3e}, max abs err {iq_err:.3e}; kernel {iq_ms:.3f} ms "
          f"(IQR {iq_iqr:.3f}), plain {iq_plain_ms:.3f} ms; {pairs} active "
          f"pairs")
    rows.append(kernel_row(
        "das_forces_iq", "das.cu", "ops/das_pallas.py:1963", iq_err, iq_ms,
        iq_plain_ms, rf.numel() * 8 + iq_k.numel() * 8,
        OPS_FORCES_IQ_CUBIC * pairs))
    del rf, iq_k, iq_p

    # DAS, RCA Flash cubic IQ at path A's shape
    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    plan = build_plan(params, pipe, {}, device=dev)
    st = plan.descriptor.stages[-1].das
    dyn = plan.dyn["das"]
    shape = (params.channel_count, 1, params.sample_count)
    rf = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    rca_k = das_cuda.das_cuda(rf, dyn, st)
    rca_p = das_ops.das_ref(rf, dyn, st)
    rca_err = compare(rca_k, rca_p, 1e-4, "RCA DAS")
    rca_nrmse = nrmse(rca_p.cpu().numpy(), rca_k.cpu().numpy())
    rca_ms, rca_iqr = kernel_ms(lambda: das_cuda.das_cuda(rf, dyn, st))
    rca_plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, st), RUNS)
    pairs = active_pairs(st, dyn)
    print(f"[kernels] DAS RCA Flash cubic IQ {tuple(shape)} -> "
          f"{st.output_points}: NRMSE {rca_nrmse:.3e}, max abs err "
          f"{rca_err:.3e}; kernel {rca_ms:.3f} ms (IQR {rca_iqr:.3f}), plain "
          f"{rca_plain_ms:.3f} ms; {pairs} active pairs")
    rows.append(kernel_row(
        "das_rca", "das.cu", "ops/das_pallas.py:1963", rca_err, rca_ms,
        rca_plain_ms, rf.numel() * 8 + rca_k.numel() * 8,
        OPS_RCA_IQ_CUBIC * pairs))
    del rf, rca_k, rca_p

    # demodulate, int16 (128, 128, 4096) with path B's Kaiser taps
    taps = torch.from_numpy(kaiser.taps).to(dev)
    length = taps.shape[0]
    rf = torch.from_numpy(rng.integers(-2048, 2048, (c, a, s),
                                       dtype=np.int16)).to(dev)
    dm_k = filtering.demodulate_cuda(rf, taps, fd, fs)
    dm_p = filtering.demodulate_ref(rf, taps, fd, fs)
    dm_err = compare(dm_k, dm_p, 1e-6, "demodulate")
    dm_ms, dm_iqr = kernel_ms(
        lambda: filtering.demodulate_cuda(rf, taps, fd, fs))
    dm_plain_ms = median_ms(
        lambda: filtering.demodulate_ref(rf, taps, fd, fs), RUNS)
    n_out = dm_k.numel()
    print(f"[kernels] demodulate int16 {c}x{a}x{s} -> {tuple(dm_k.shape)} "
          f"complex, {length} Kaiser taps: max abs err {dm_err:.3e}; kernel "
          f"{dm_ms:.3f} ms (IQR {dm_iqr:.3f}), plain {dm_plain_ms:.3f} ms")
    rows.append(kernel_row(
        "demodulate", "filter.cu", "ops/demod_pallas.py:94", dm_err, dm_ms,
        dm_plain_ms, rf.numel() * 2 + n_out * 8 + length * 4,
        n_out * 4 * length + (rf.numel() // 2) * 11))
    del rf, dm_k, dm_p

    # demodulate, float32 with complex chirp taps at D = 2 (smaller shape)
    chirp = make_filter(FilterParameters(
        kind=FilterKind.MatchedChirp, sampling_frequency=fs / 2,
        complex=True,
        matched_chirp=MatchedChirpFilterParameters(2e-6, 5e6, 10e6)))
    ctaps = torch.from_numpy(chirp.taps).to(dev)
    x = torch.from_numpy(rng.standard_normal((16, 16, s), dtype=np.float32)
                         * 1000).to(dev)
    k = filtering.demodulate_cuda(x, ctaps, fd, fs, 2, True)
    p = filtering.demodulate_ref(x, ctaps, fd, fs, 2, True)
    err = compare(k, p, 1e-6, "demodulate chirp D=2")
    print(f"[kernels] demodulate float32 (16, 16, {s}) D=2, "
          f"{ctaps.shape[0]} complex chirp taps -> {tuple(k.shape)}: max abs "
          f"err {err:.3e}")

    # FIR, complex64 (128, 128, 2048) with real and complex taps
    n = s // 2
    x = torch.complex(
        torch.from_numpy(rng.standard_normal((c, a, n), dtype=np.float32)),
        torch.from_numpy(rng.standard_normal((c, a, n), dtype=np.float32))
    ).to(dev)
    for label, h in (("real", taps), ("complex", ctaps)):
        k = filtering.fir_cuda(x, h)
        p = filtering.fir_filter_ref(x, h)
        err = compare(k, p, 1e-6, f"FIR {label} taps")
        ms, iqr = kernel_ms(lambda: filtering.fir_cuda(x, h))
        plain_ms = median_ms(lambda: filtering.fir_filter_ref(x, h), RUNS)
        lib_ms = None
        if label == "real":
            # F.conv1d with TF32 off (package __init__): re and im as two
            # depthwise channels, the same L - 1 left zeros
            xin = torch.view_as_real(x).reshape(-1, n, 2).transpose(1, 2) \
                .contiguous()
            w = h.reshape(1, 1, -1).repeat(2, 1, 1)
            ref = F.conv1d(xin, w, padding=h.shape[0] - 1, groups=2)[..., :n]
            lib_err = float((torch.view_as_complex(
                ref.transpose(1, 2).contiguous()).reshape(x.shape) - k
            ).abs().max())
            lib_ms = median_ms(lambda: F.conv1d(xin, w,
                                                padding=h.shape[0] - 1,
                                                groups=2))
            del xin, ref
        print(f"[kernels] FIR complex64 {tuple(x.shape)}, {h.shape[0]} "
              f"{label} taps: max abs err {err:.3e}; kernel {ms:.3f} ms "
              f"(IQR {iqr:.3f}), plain {plain_ms:.3f} ms"
              + (f", F.conv1d {lib_ms:.3f} ms (max abs diff {lib_err:.3e})"
                 if lib_ms is not None else ""))
        if label == "real":
            rows.append(kernel_row(
                "fir", "filter.cu", "ops/demod_pallas.py:160", err, ms,
                plain_ms, x.numel() * 8 * 2 + h.numel() * 4,
                x.numel() * 4 * h.shape[0], lib_ms))
    return rows


def synthesize_forces_frame(c, a, s, fs, sos, pitch, target, f0, h):
    """Per-(channel, transmit) echoes of a point target, Hadamard-encoded
    across transmits as the scanner records them, as int16 (C, A*S)."""
    rx_x = np.arange(c) * pitch
    tx_x = np.arange(a) * pitch
    ty = target[1] - pitch * c / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = (rx_d[:, None] + tx_d[None, :]).astype(np.float32)
    t = (np.arange(s) / fs).astype(np.float32)
    arg = t[None, None, :] - dist[:, :, None] / np.float32(sos)
    env = np.exp(-0.5 * (arg / np.float32(2 / f0 / 4)) ** 2)
    # a cosine burst (examples/point_scatterer.py uses a sine): the preset's
    # axial voxel pitch is coarser than a quarter carrier period, so the
    # image cannot resolve a sine burst's envelope, but a cosine burst's
    # coherent sum peaks on the target voxel itself
    echo = (env * np.cos(np.float32(2 * np.pi * f0) * arg)).astype(np.float32)
    encoded = np.matmul(h.T.astype(np.float32), echo)   # "tj,cts->cjs"
    encoded *= 30000.0 / np.abs(encoded).max()
    return np.clip(encoded, -32768, 32767).astype(np.int16).reshape(c, -1)


def synthesize_plane_wave_frame(c, s, fs, sos, pitch, target, fd):
    """Baseband IQ echoes of a point target under a 0-degree plane wave
    received by ``c`` columns at ``ch * pitch``:
    ``env(k / fs - tau_c) * exp(-j 2 pi f_d tau_c)`` with ``tau_c`` the
    plane-wave plus receive delay, interleaved I/Q float32 (C, 2 S)."""
    rx_x = np.arange(c) * pitch
    tau = (target[2] + np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)) / sos
    t = np.arange(s) / fs
    env = np.exp(-0.5 * ((t[None, :] - tau[:, None]) / (2 / fd / 4)) ** 2)
    iq = env * np.exp(-2j * np.pi * fd * tau)[:, None]
    out = np.empty((c, 2 * s), np.float32)
    out[:, 0::2] = iq.real
    out[:, 1::2] = iq.imag
    return out


def golden_das(p, rf, sample_count, fs, time_offset, vt=None):
    """The golden DAS of ``rf`` (C, A, S') with ``p``'s geometry at the DAS
    stage's sample count, sampling rate and time offset."""
    from ogl_beamforming_tpu_torch.ops import golden
    from ogl_beamforming_tpu_torch.utils.transforms import das_output_dimension
    return golden.das(rf, golden.DasParams(
        acquisition_kind=p.acquisition_kind,
        acquisition_count=p.acquisition_count,
        channel_count=p.channel_count, sample_count=sample_count,
        sampling_frequency=fs,
        demodulation_frequency=p.demodulation_frequency,
        speed_of_sound=p.speed_of_sound, time_offset=time_offset,
        interpolation_mode=p.interpolation_mode, f_number=p.f_number,
        voxel_transform=np.asarray(p.das_voxel_transform if vt is None
                                   else vt),
        xdc_transform=np.asarray(p.xdc_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=tuple(int(v) for v in
                            das_output_dimension(p.output_points[:3])),
        transmit_receive_orientation=p.transmit_receive_orientation,
        transmit_angle=float(p.focal_vector[0]),
        focus_depth=float(p.focal_vector[1])))


def run_frame(dev, p, shaders, data_kind, raw, filters=()):
    """One frame through a fresh Beamformer on ``dev``."""
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
    bf = Beamformer(device=dev)
    for slot, fp in filters:
        bf.create_filter(fp, filter_slot=slot)
    bf.push_parameters(p)
    bf.push_pipeline(shaders, data_kind)
    return bf.push_data_with_compute(raw).to_numpy()


def check_canary(label, out, ref, shape) -> None:
    err = nrmse(ref, out)
    check(np.abs(ref).max() > 0, f"canary {label}: golden frame is zero")
    check(np.isfinite(out).all() and out.shape == shape,
          f"canary {label}: frame shape {out.shape} or values not finite")
    check(err <= 1e-3, f"canary {label}: golden NRMSE {err:.3e} > 1e-3")
    print(f"[canary] {label} via Beamformer vs golden: NRMSE {err:.3e}")


def phase_canary(dev) -> dict:
    """The reduced canaries; returns the launch counts of the Filter
    canary, the path that drives the FIR kernel."""
    from ogl_beamforming_tpu_torch import (AcquisitionKind, DataKind,
                                           FilterKind, FilterParameters,
                                           InterpolationMode,
                                           KaiserFilterParameters,
                                           MatchedChirpFilterParameters,
                                           Parameters, ShaderKind)
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import golden
    from ogl_beamforming_tpu_torch.utils.filters import make_filter
    from ogl_beamforming_tpu_torch.utils.hadamard import hadamard
    from ogl_beamforming_tpu_torch.utils.transforms import das_transform_2d_xz

    # FORCES decode -> DAS
    c, a, s, pitch = 32, 16, 1024, 0.3e-3
    vt = np.eye(4, dtype=np.float32)
    vt[0, 0], vt[2, 1], vt[2, 3] = (c - 1) * pitch, 14e-3, 2e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1540.0, f_number=1.0,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic, das_voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([64, 64, 1, 0], np.int32))
    rng = np.random.default_rng(99)
    raw = rng.integers(-2048, 2048, (c, a * s), dtype=np.int16)
    out = run_frame(dev, p, [ShaderKind.Decode, ShaderKind.DAS],
                    DataKind.Int16, raw)
    dec = golden.decode_hadamard(raw.reshape(c, a, s), hadamard(a))
    check_canary(f"FORCES {c}x{a}x{s} -> 64x64", out,
                 golden_das(p, dec, s, 20e6, 0.0), (64, 64, 1))

    # path A reduced: plane-wave Flash IQ on Float32Complex wire data
    pa, pipe = presets.plane_wave_2d(
        channel_count=64, sample_count=1024, output_points=(64, 64),
        lateral_mm=(-2.0, 14.0), axial_mm=(5.0, 15.0),
        data_kind=DataKind.Float32Complex)
    raw = rng.standard_normal((64, 2 * 1024)).astype(np.float32)
    out = run_frame(dev, pa, pipe.shaders, pipe.data_kind, raw)
    rf = (raw[:, 0::2] + 1j * raw[:, 1::2]).astype(np.complex64)[:, None]
    check_canary("path A plane-wave Flash IQ 64x1x1024 -> 64x64", out,
                 golden_das(pa, rf, 1024, pa.sampling_frequency,
                            pa.time_offset), (64, 64, 1))

    # path B reduced: Demodulate (Kaiser at the pair rate) -> Decode -> DAS
    pb, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s,
        output_points=(64, 64))
    pb.das_voxel_transform = das_transform_2d_xz(
        [0, 2e-3], [(c - 1) * pb.xdc_element_pitch[0], 9e-3])
    fp = FilterParameters(kind=FilterKind.Kaiser,
                          sampling_frequency=pb.sampling_frequency / 2,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    raw = rng.integers(-2048, 2048, (c, a * s), dtype=np.int16)
    out = run_frame(dev, pb, pipe.shaders, pipe.data_kind, raw, [(0, fp)])
    filt = make_filter(fp)
    iq = golden.demodulate(raw.reshape(c, a, s), filt.taps,
                           pb.demodulation_frequency, pb.sampling_frequency)
    dec = golden.decode_hadamard(iq, hadamard(a))
    check_canary(f"path B demodulate chain {c}x{a}x{s} -> 64x64", out,
                 golden_das(pb, dec, s // 2, pb.sampling_frequency / 2,
                            pb.time_offset + filt.time_delay), (64, 64, 1))

    # [Decode, Filter (complex matched chirp), DAS] on baseband data
    chirp = FilterParameters(
        kind=FilterKind.MatchedChirp, sampling_frequency=20e6, complex=True,
        matched_chirp=MatchedChirpFilterParameters(1e-6, 3e6, 7e6))
    raw = rng.integers(-2048, 2048, (c, a * s * 2), dtype=np.int16)
    build.LAUNCHES.clear()
    out = run_frame(dev, p, [ShaderKind.Decode, ShaderKind.Filter,
                             ShaderKind.DAS], DataKind.Int16Complex, raw,
                    [(0, chirp)])
    filter_launches = dict(build.LAUNCHES)
    check(filter_launches.get("fir", 0) == 1,
          f"Filter canary launches {filter_launches}: FIR not launched once")
    filt = make_filter(chirp)
    rf = raw.reshape(c, a, -1).astype(np.float32)
    rf = (rf[..., 0::2] + 1j * rf[..., 1::2]).astype(np.complex64)
    dec = golden.fir_filter(golden.decode_hadamard(rf, hadamard(a)),
                            filt.taps)
    check_canary(f"[Decode, Filter(MatchedChirp, complex), DAS] {c}x{a}x{s}",
                 out, golden_das(p, dec, s, 20e6, filt.time_delay),
                 (64, 64, 1))

    # [Decode, Hilbert, DAS] on int16
    raw = rng.integers(-2048, 2048, (c, a * s), dtype=np.int16)
    out = run_frame(dev, p, [ShaderKind.Decode, ShaderKind.Hilbert,
                             ShaderKind.DAS], DataKind.Int16, raw)
    dec = golden.hilbert(golden.decode_hadamard(raw.reshape(c, a, s),
                                                hadamard(a)))
    check_canary(f"[Decode, Hilbert, DAS] {c}x{a}x{s}", out,
                 golden_das(p, dec, s, 20e6, 0.0), (64, 64, 1))
    return filter_launches


def drive(label, dev, params, pipe, raw, target_voxel, kernels,
          filters=()) -> dict:
    """Warm up, then RUNS frames of ``raw`` through Beamformer(device=dev)
    with the launch counts set to 0 just before and read just after; the
    peak of |image| must lie within one voxel of ``target_voxel`` and each
    of ``kernels`` must launch once per frame.  Returns the counts."""
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer

    nx, nz = int(params.output_points[0]), int(params.output_points[1])
    bf = Beamformer(device=dev)
    for slot, fp in filters:
        bf.create_filter(fp, filter_slot=slot)
    bf.push_parameters(params)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    bf.warmup()
    torch.cuda.synchronize()

    build.LAUNCHES.clear()
    wall = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        frame = bf.push_data_with_compute(raw)
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {k: build.LAUNCHES[k] for k in kernels}
    check(all(n == RUNS for n in launches.values()),
          f"{label}: kernel launch counts {launches} != {RUNS} frames")

    img = frame.to_numpy()
    check(img.shape == (nx, nz, 1) and np.isfinite(img).all(),
          f"{label}: frame shape {img.shape} or values not finite")
    px, pz = np.unravel_index(np.argmax(np.abs(img[:, :, 0])), (nx, nz))
    tx, tz = target_voxel
    check(abs(px - tx) <= 1 and abs(pz - tz) <= 1,
          f"{label}: image peak at voxel ({px}, {pz}), target ({tx}, {tz})")

    # stats rows 1..RUNS hold the timed frames (row 0 is the warmup frame)
    stages = bf._blocks[0]._plan.descriptor.stages
    times = bf.compute_timings().times[1:1 + RUNS, :len(stages)] * 1e3  # ms
    stage = np.median(times, axis=0)
    split = " + ".join(f"{sd.kind.name} {t:.3f}"
                       for sd, t in zip(stages, stage))
    print(f"[{label}] peak ({px}, {pz}) vs target ({tx}, {tz}); launches "
          f"{launches}")
    print(f"[{label}] device ms/frame {float(stage.sum()):.3f} ({split}, "
          f"median CUDA events); end to end incl. host prepare_rf + upload "
          f"{statistics.median(wall):.3f} ms/frame (median host clock)")
    return launches


def target_world(params, tx: int, tz: int) -> np.ndarray:
    """World point of voxel (tx, tz) of a 2D (x, z) output grid."""
    nx, nz = int(params.output_points[0]), int(params.output_points[1])
    vt = np.asarray(params.das_voxel_transform, np.float64)
    return (vt @ np.array([tx / (nx - 1), tz / (nz - 1), 0.0, 1.0]))[:3]


def phase_main(dev) -> dict:
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import decode

    c, a, s = 128, 128, 4096
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s, demodulate=False)
    tx, tz = (int(v) // 2 for v in params.output_points[:2])
    target = target_world(params, tx, tz)
    raw = synthesize_forces_frame(
        c, a, s, params.sampling_frequency, params.speed_of_sound,
        float(params.xdc_element_pitch[0]), target,
        params.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy())
    return drive("main", dev, params, pipe, raw, (tx, tz),
                 ("decode_hadamard", "das_forces"))


def phase_main_rca(dev) -> dict:
    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    # a target inside the 0-51 mm aperture: x = 25.5 mm, z = 40.2 mm
    tx, tz = 364, 199
    target = target_world(params, tx, tz)
    raw = synthesize_plane_wave_frame(
        params.channel_count, params.sample_count, params.sampling_frequency,
        params.speed_of_sound, float(params.xdc_element_pitch[0]), target,
        params.demodulation_frequency)
    return drive("main_rca", dev, params, pipe, raw, (tx, tz), ("das_rca",))


def phase_main_demod(dev) -> dict:
    from ogl_beamforming_tpu_torch import (FilterKind, FilterParameters,
                                           KaiserFilterParameters)
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import decode

    c, a, s = 128, 128, 4096
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s)
    tx, tz = (int(v) // 2 for v in params.output_points[:2])
    target = target_world(params, tx, tz)
    raw = synthesize_forces_frame(
        c, a, s, params.sampling_frequency, params.speed_of_sound,
        float(params.xdc_element_pitch[0]), target,
        params.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy())
    # the Kaiser low-pass is designed at the rate it runs at, the pair rate
    # fs / 2: its delay compensation (L / 2 / fs) assumes that rate
    fp = FilterParameters(kind=FilterKind.Kaiser,
                          sampling_frequency=params.sampling_frequency / 2,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    return drive("main_demod", dev, params, pipe, raw, (tx, tz),
                 ("demodulate", "decode_hadamard", "das_forces"),
                 filters=[(0, fp)])


def main() -> None:
    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    fir_launches = phase_canary(dev)
    launches = phase_main(dev)
    launches.update(phase_main_rca(dev))
    demod = phase_main_demod(dev)
    launches["demodulate"] = demod["demodulate"]
    launches["das_forces_iq"] = demod["das_forces"]
    launches["fir"] = fir_launches["fir"]
    for row in rows:
        row["launches"] = launches[row["name"]]
        check(row["launches"] > 0, f"{row['name']} never launched on its path")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
