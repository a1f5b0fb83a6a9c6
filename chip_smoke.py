#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (ogl_beamforming_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper GPU and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the last line:

  1. device   a CUDA device must be present; prints its name and
              ``nvidia-smi`` name/power limit.
  2. build    compiles csrc/*.cu with nvcc for sm_90a (kernels/build.py).
  3. kernels  each kernel against its plain-torch twin on the card at the
              main path's shapes: int16 decode (128, 128, 4096) bit-equal,
              an order-12 and a float32 decode to 1e-6 of the peak, FORCES
              cubic DAS 128 ch x 128 tx x 4096 samples -> 512 x 1024 voxels
              to NRMSE 1e-4; median times (CUDA events) of kernel and twin.
  4. canary   a reduced FORCES configuration through Beamformer(device=
              "cuda") against the NumPy golden oracle, NRMSE <= 1e-3.
  5. main     the Quickstart configuration (presets.forces_compounding,
              128 x 128 x 4096, 512 x 1024 voxels, no demodulation) through
              Beamformer(device="cuda"): warmup, then 5 frames of a
              point-scatterer acquisition; the image peak must land within
              one voxel of the target and both kernels' launch counters must
              advance once per frame.  Prints ms/frame and the stage split.

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

RUNS = 5          # timed runs per measurement, after one warm-up run


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {msg}")


def nrmse(ref: np.ndarray, test: np.ndarray) -> float:
    denom = np.sqrt(np.mean(np.abs(ref) ** 2))
    return float(np.sqrt(np.mean(np.abs(test - ref) ** 2)) / denom)


def median_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` over RUNS runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def phase_kernels(dev) -> list[dict]:
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import decode, das_cuda
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan

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
    dec_ms = median_ms(lambda: decode.decode_hadamard_cuda(rf, h))
    dec_plain_ms = median_ms(lambda: decode.decode_hadamard_ref(rf, h))
    print(f"[kernels] decode int16 {c}x{a}x{s}: bit-equal; kernel "
          f"{dec_ms:.3f} ms, plain {dec_plain_ms:.3f} ms")

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

    # DAS, FORCES cubic real at the main path's shape
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
    torch.cuda.synchronize()
    k_np, p_np = das_k.cpu().numpy(), das_p.cpu().numpy()
    check(np.isfinite(k_np).all(), "DAS kernel output not finite")
    das_nrmse = nrmse(p_np, k_np)
    das_err = float(np.abs(k_np - p_np).max())
    check(das_nrmse <= 1e-4, f"DAS kernel NRMSE {das_nrmse:.3e} > 1e-4")
    das_ms = median_ms(lambda: das_cuda.das_cuda(rf, dyn, st))
    das_plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, st))
    print(f"[kernels] DAS FORCES cubic {c}x{a}x{s} -> {st.output_points}: "
          f"NRMSE {das_nrmse:.3e}, max abs err {das_err:.3e}; kernel "
          f"{das_ms:.3f} ms, plain {das_plain_ms:.3f} ms")

    rows.append(dict(name="decode_hadamard", route="cuda",
                     source="ogl_beamforming_tpu_torch/csrc/decode.cu",
                     replaces="ogl_beamforming_tpu/ops/decode.py:247",
                     max_abs_err=dec_err, ms=dec_ms, plain_ms=dec_plain_ms))
    rows.append(dict(name="das_forces", route="cuda",
                     source="ogl_beamforming_tpu_torch/csrc/das.cu",
                     replaces="ogl_beamforming_tpu/ops/das_pallas.py:1963",
                     max_abs_err=das_err, ms=das_ms, plain_ms=das_plain_ms))
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


def phase_canary(dev) -> None:
    from ogl_beamforming_tpu_torch import AcquisitionKind, DataKind, \
        InterpolationMode, Parameters, ShaderKind
    from ogl_beamforming_tpu_torch.ops import golden
    from ogl_beamforming_tpu_torch.ops.decode import hadamard_matrix
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer

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
    bf = Beamformer(device=dev)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    out = bf.push_data_with_compute(raw).to_numpy()
    dec = golden.decode_hadamard(raw.reshape(c, a, s),
                                 hadamard_matrix(a).numpy())
    ref = golden.das(dec, golden.DasParams(
        acquisition_kind=AcquisitionKind.FORCES, acquisition_count=a,
        channel_count=c, sample_count=s, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1540.0,
        interpolation_mode=InterpolationMode.Cubic, f_number=1.0,
        voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=(64, 64, 1)))
    err = nrmse(ref, out)
    check(np.isfinite(out).all() and out.shape == (64, 64, 1),
          f"canary frame shape {out.shape} or values not finite")
    check(err <= 1e-3, f"golden canary NRMSE {err:.3e} > 1e-3")
    print(f"[canary] FORCES {c}x{a}x{s} -> 64x64 via Beamformer(cuda) vs "
          f"golden: NRMSE {err:.3e}")


def phase_main(dev) -> dict:
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das_cuda, decode
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer

    c, a, s = 128, 128, 4096
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s, demodulate=False)
    nx, nz = int(params.output_points[0]), int(params.output_points[1])
    vt = np.asarray(params.das_voxel_transform, np.float64)
    tx, tz = nx // 2, nz // 2                         # target voxel
    target = (vt @ np.array([tx / (nx - 1), tz / (nz - 1), 0.0, 1.0]))[:3]
    pitch = float(params.xdc_element_pitch[0])
    raw = synthesize_forces_frame(
        c, a, s, params.sampling_frequency, params.speed_of_sound, pitch,
        target, params.demodulation_frequency,
        decode.hadamard_matrix(a).numpy())

    bf = Beamformer(device=dev)
    bf.push_parameters(params)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    bf.warmup()

    decode.LAUNCHES = 0
    das_cuda.LAUNCHES = 0
    wall = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        frame = bf.push_data_with_compute(raw)
        wall.append((time.perf_counter() - t0) * 1e3)
    launches = {"decode_hadamard": decode.LAUNCHES,
                "das_forces": das_cuda.LAUNCHES}
    check(all(n >= RUNS for n in launches.values()),
          f"kernel launch counts {launches} < {RUNS} frames")

    img = frame.to_numpy()
    check(img.shape == (nx, nz, 1) and np.isfinite(img).all(),
          f"frame shape {img.shape} or values not finite")
    px, pz = np.unravel_index(np.argmax(np.abs(img[:, :, 0])), (nx, nz))
    check(abs(px - tx) <= 1 and abs(pz - tz) <= 1,
          f"image peak at voxel ({px}, {pz}), target ({tx}, {tz})")

    # stats rows 1..RUNS hold the timed frames (row 0 is the warmup frame)
    times = bf.compute_timings().times[1:1 + RUNS, :2] * 1e3    # ms
    stage = np.median(times, axis=0)
    print(f"[main] Quickstart FORCES {c}x{a}x{s} -> {nx}x{nz} via "
          f"Beamformer(cuda): peak ({px}, {pz}) vs target ({tx}, {tz}); "
          f"launches {launches}")
    print(f"[main] device ms/frame {float(stage.sum()):.3f} (decode "
          f"{stage[0]:.3f} + DAS {stage[1]:.3f}, median CUDA events); "
          f"end to end incl. host prepare_rf + upload "
          f"{statistics.median(wall):.3f} ms/frame (median host clock)")
    return launches


def main() -> None:
    name, _ = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    phase_canary(dev)
    launches = phase_main(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
