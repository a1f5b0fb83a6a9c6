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
              one nvcc per source, all started together; prints the decode
              kernels' registers and the static SASS instructions per pair
              of the pair loops of das_forces_kernel, das_hercules_kernel
              and das_rca_kernel (kernels/sass.py).
  3. kernels  each kernel against its plain-torch twin on the card at its
              path's shapes: int16 decode (128, 128, 4096), (128, 128,
              2048) at path C and (256, 64, 2048) at path D bit-equal, an
              order-12 and a float32 decode to 1e-6 of the peak, the
              complex64 decode at path B's shape (128, 128, 2048 complex;
              the float32 kernel) to 1e-6 of the peak, FORCES
              cubic DAS 128 ch x 128 tx x 4096 samples -> 512 x 1024 voxels,
              the four-frame FORCES launch at that shape against
              single-frame launches (1e-6),
              FORCES cubic IQ DAS at path B's DAS stage (complex64 128 x 128
              x 2048 at 20 MHz, the filter's delay in the time offset) and
              RCA Flash cubic IQ DAS 256 ch x 1 x 4096 complex samples ->
              512 x 1024, HERCULES linear DAS 128 x 128 x 2048 -> 96^3
              (path C), UFORCES linear DAS with the incoherent sum 256 x 64
              x 2048 -> 128^3 (path D, both volumes) to NRMSE 1e-4, and
              the four-frame RCA launch at path E's batch (4 x 256 x 1 x
              4096 complex) against four single-frame launches (1e-6) and
              its twin (1e-4) and bit-equal to them, timed beside those
              four launches;
              demodulate int16 (128, 128, 4096)
              with the 16-tap Kaiser low-pass and path B's plan's rotation
              table (and a complex chirp at D = 2)
              and FIR complex64 (128, 128, 2048) with real and complex taps
              to NRMSE 1e-6; CUDA-event times of the kernel (median and
              interquartile range of 21 runs), its twin (median of 5; a
              DAS twin in one block of the whole grid) and,
              where one PyTorch call computes the same function, that call
              (median of 21); and each kernel's bound from its bytes and
              operations; for demodulate and FIR also the kernel's time
              from a torch.profiler trace, and beside demodulate the
              two-call composite of the rotation as torch ops and
              F.conv1d; for each DAS row the kernel's
              registers, resident warps per SM and SASS instructions per
              pair; for FORCES its time at each pass of the index table (8
              and 32 transmits); for HERCULES the run groups, the bound with
              the run's share counted per triple beside the recounted one,
              and its time walking each channel's transmit interval and
              the whole table.
  4. canary   reduced configurations through Beamformer(device="cuda")
              against the NumPy golden oracle, NRMSE <= 1e-3: FORCES decode
              -> DAS, one frame and a batch of two through push_batch; path
              A (plane-wave Flash IQ); path B (Demodulate -> Decode ->
              FORCES IQ DAS); [Decode, Filter (complex matched chirp), DAS]
              on baseband data; [Decode, Hilbert, DAS]; HERCULES 16 x 16 x
              512 -> 24^3; uFORCES with coherency 32 x 16 x 512 -> 24^3.
  5. main     six paths at full width through Beamformer(device="cuda"),
              each a warmup and then 5 frames (path E: 5 batches of 4) of a
              point-target acquisition with the launch counts set to 0 just
              before and read just after; the image peak must land within
              one voxel of the target on every axis and each kernel of the
              path must launch once per frame (path E: once per batch):
                main        the Quickstart (forces_compounding without
                            demodulation, 128 x 128 x 4096 -> 512 x 1024);
                main_rca    path A, the plane-wave headline (plane_wave_2d,
                            Float32Complex, 256 ch x 4096 -> 512 x 1024);
                main_demod  path B, the preset's default demodulate chain
                            (forces_compounding, 128 x 128 x 4096 int16,
                            16-tap Kaiser at the pair rate);
                main_hercules  path C, HERCULES 3D (hercules_3d, 128 x 128
                            x 2048 int16 -> 96^3);
                main_uforces  path D, uFORCES 3D with coherency
                            (uforces_volumetric, 256 x 64 x 2048 int16, 63
                            sparse transmits -> 128^3);
                main_batch  path E, the plane-wave headline four frames per
                            push_batch; each frame must match
                            push_data_with_compute of it (NRMSE 1e-6) and
                            averaged_frame the mean of the four.
              Prints device ms/frame with the stage split and ms/frame end
              to end.
  6. micro    the microbenchmark kernels K5-K11 (ogl_beamforming_tpu_torch.
              experiments, csrc/micro_*.cu), each against its plain version
              at its TPU file's shapes: the gather-and-add variants and the
              int8 probes bit-equal (K10 also equal to the exact product
              and to torch._int_mm; K11 ``full`` also equal to the exact
              product H @ X / 16, at (16, 256) and at the Quickstart
              decode's width (128, 128 x 4096), and ``dot`` bit-equal
              there), the rest NRMSE 1e-6; then each
              module's sweep, launch counts set to 0 just before and read
              just after (K5, K6: every variant in shared and device
              memory, by CUDA events and by its kernel time in a profiler
              trace, and each row by the trace with its bound share, the
              bound counted from the function (its float adds or
              multiply-adds at the issue rate, its distinct gathers at the
              shared memory's peak of a warp gather a clock, at the card's
              highest SM clock), beside what the compiled kernel executes
              (kernels/sass.gather_loops): gather_floor_kernel's
              registers, spills, resident blocks a SM and grid, and the
              warp FADD (K5 mod) or FFMA (K6 hermite_pair) a launch
              executes, modelled from the SASS, which must reach the
              function's; K5 mod by the trace at REPS 8, 64 and 128, its
              slope and intercept;
              K7: the REPS slope of every variant in both, its row also by
              the trace, its bound from the function as K5's and K6's
              (its distinct gathers: every repetition's offset is new)
              beside the first count; K8 and K9: the
              cubic-tap gather bundle and the one-hot product at B = 8, 32,
              128, K8 from the trace, K9 by the UNITS slope, printed as a
              fit). K7 hermite_pair and the bundle's two forms run on
              gather_walk_kernel: its registers, spills, resident blocks a
              SM, grid and static 16-byte LDS, and the warp FFMA a launch
              executes, modelled from the SASS, which must equal the
              function's. The bundle rows (K8 and K9 gather): by events
              and by the trace, the bound from the function (8 UNITS
              multiply-adds an element; 10 distinct gathers in K8's form,
              4 UNITS in K9's). K8 and K9 rows: the one-hot kernel at every B by
              events (median, IQR) and by the trace, its bound recounted
              for the function (the dense products at the bf16 peak, W's
              nonzeros on the CUDA cores), the products alone as one bf16
              torch.matmul (library_ms), and the kernel's registers and
              the static HGMMA count of each instantiation's unit loop,
              which must equal 2 B 128^2 per unit and block over the
              operations of m64nBk16 and the two warpgroups.
              Prints cycles per warp gather, ns per voxel-row-frame and the
              SM clock; K10 beside torch._int_mm as a single call (with the
              enqueue), 20 back to back and by the trace, and the host's
              microseconds per call; K11 ``full`` and ``dot`` beside the
              decode kernel (K2) and the cuBLAS f32 product, by events and
              by the trace; the registers and static
              SASS counts of the K10/K11 instantiations timed; the card's
              name and power limit on each of those lines.
  7. trace    torch.profiler over one Quickstart frame and one path E batch
              through Beamformer (utils/profiling.device_time): kernel time
              by name and the device busy share of the window;
              Beamformer.profile_device_stages of the Quickstart and of
              path B beside its stages' CUDA-event times; then a trace of
              phase 3's demodulate and of its FIR calls, their device time
              per launch onto their rows; a profile_device_stages trace
              that lost a launched kernel's event is taken again (up to
              utils/profiling.TRACE_ATTEMPTS; roadmap C2), and a stage
              still at 0 fails naming each lost kernel and its line.
              Phases 5, 6, 7 and 8 end with a
              [trace] line naming each traced launch of the port's kernels
              whose device event the trace lacks (DeviceProfile.lost).
  8. stream   the Quickstart and paths A and B through
              runtime/streaming.StreamingSession on
              Beamformer(device="cuda"), after a warm-up: 20 frames of four
              point-target variants; each kernel once per frame, 20 new
              stats rows, each frame equal to push_data_with_compute of
              its raw frame (NRMSE 1e-6; the count bit for bit is printed)
              with its peak within one voxel of the target; prints
              streamed ms/frame (first submit to drain over 20) beside the
              synchronous end to end and device ms/frame of the same
              process, with the card's name and power limit; then a traced
              burst of Quickstart frames (utils/profiling.device_time): busy
              share and the ms of copy that overlap a kernel, which must
              not be 0.  For each path also the parts alone: the host copy
              of one raw frame into a pinned slot (host clock) and its
              upload (CUDA events).
  9. serve    the Quickstart at full width through the runtime bridge: a
              BeamformerServer on the card (runtime/server.py) on a
              256 MiB shared-memory region of its own (/dev/shm must hold
              it), driven through the port's native library
              (runtime/abi.py, built from runtime/native/ at first use) by
              a ctypes client in this process (each frame through the
              server's StreamingSession): after a warm-up, 20
              frames of four point-target variants with
              beamformer_push_data_with_compute, read back with one
              beamformer_get_last_frames and the stats with
              beamformer_compute_timings, the launch counts set to 0 just
              before; each kernel once per frame, 20 new rows in the
              client's stats table, every frame equal to
              push_data_with_compute of its raw frame on the card bit for
              bit with its peak within one voxel of the target; then one
              frame from a C client compiled against generated/
              ogl_beamformer_lib.h and the port's library, in a
              subprocess, held to the same.  Prints served ms/frame (the
              client's clock, first push to last export, over 20)
              beside phase 8's streamed Quickstart,
              the client's copy into the region and a copy out of it
              alone, and the card's name and power limit.

 10. zbp     recorded acquisitions and display, through the examples'
              functions (ogl_beamforming_tpu_torch.examples): a point-target
              FORCES acquisition (int16, Hadamard-encoded, 128 ch x 128 tx
              x 4096 samples at 40 MHz, shuffled channel mapping, drawn on
              the card) written as .zbp v2 with a sine and with a chirp
              emission descriptor and as v1, uncompressed, and loaded back
              with the port's load_zbp, every field and the data bit-equal;
              the throughput example's chain from each file (from_zbp, the
              filter from the emission, Demodulate -> Decode -> FORCES IQ
              DAS onto 512 x 1024): a warm-up and 32 frames with each
              kernel once a frame, the example's lines, device ms/frame
              with the stage split, the peak within one voxel of the
              target, the last frame against the demodulate, decode and
              DAS twins stage by stage (NRMSE 1e-4), the v1 frame equal to
              the v2 sine frame; the decode sweep (17 orders, 2-256, 256
              ch x 4096): the int16 kernel bit-equal to its twin at each,
              its 32-frame average, GB/s, share of the byte bound and the
              cuBLAS f32 product; point_scatterer: the B-mode peak on the
              target, its PNG (viewer_web.encode_png_gray) decoding to
              viewer.bmode_image's pixels; live_streaming: 20 frames
              through a StreamingSession with a LiveView on 127.0.0.1, the
              served frame PNG, stats and A-scan against the last frame, a
              StopImaging POST in the dirty flag and stopping the session,
              the X-plane and MIP endpoints over a HERCULES 24^3 volume
              equal to the renderers; ops.das.das_from_params on CUDA
              tensors for each family at phase 4's sizes against golden
              (1e-3); entry()'s forward with a point target, its peak
              checked.  The phase's launches go onto the kernel table's
              rows as ``phase10_launches``.
 11. tune    the launch knobs: the shipped H100 tables
              (ogl_beamforming_tpu_torch/data/tuned_h100.json and
              decode_tuned_h100.json) load and every knob in them is one
              the kernels have; das_cuda.autotune_das with its default
              candidates at full width on the Quickstart, paths A-E and
              the throughput chain's DAS (pretune's configurations), each
              candidate's output against the default knobs' on the same
              input (bit for bit; the FORCES index table's pass, which
              sums a voxel's pairs pass by pass, to NRMSE 1e-4; FORCES
              frames a launch to 1e-6), a plan
              built after tuning launching the installed knobs, its frame
              against a plan's built before (bit for bit, or 1e-4 where
              the installed knobs change the order); decode.autotune_decode
              on the Quickstart's int16 frame, path B's complex frame and
              256 ch x order 256 x 4096, every candidate bit-equal to the
              default; save_tuned/load_tuned and the decode pair round
              trip, and a HERCULES thread shape other than the plan's,
              loaded from a file, launched by a plan built after
              (build.VARIANT_LAUNCHES), its frame bit-equal.  Prints each
              candidate's ms with the card's name and power limit.
 12. mesh    the parallel package (parallel/sharding.py, multihost.py) at
              full width on virtual meshes of cuda:0 (positions of one card
              run one after another: the sharding's overhead, not scaling;
              the card tests and experiments/mesh_sweep.py --cards take
              meshes over several cards): the Quickstart
              through Beamformer(mesh=make_mesh([cuda:0] * 4)) beside
              Beamformer(device="cuda") on the same raw frames (a warm-up
              and 5 frames; NRMSE 1e-5, peaks within one voxel, decode and
              DAS 4 times a frame, shard k's scalar vector at channel
              offset 32 k), then 5 frames through a StreamingSession on the
              meshed Beamformer against its synchronous frames (NRMSE
              1e-6); path D on make_mesh_2d(2, 2) and an 8-angle RCA_TPW
              compounding (float32 256 x 8 x 4096 -> 512 x 1024) on
              make_mesh_tx(2, 4) against their unsharded plans (1e-5, the
              peaks on target); two gloo ranks of this script on cuda:0
              (--mesh-worker), each feeding only its local_channel_slice
              rows, channels summed by all_reduce, and slabs one a rank
              brought together by all_gather, rank 0's gathered frames
              against the unsharded frame (1e-5); entry.dryrun_multichip(8)
              and (3) and the multihost_feeders example (--frames 2).
              Prints device ms/frame sharded and unsharded with the card's
              name and power limit.  The phase's launches go onto the
              kernel table's rows as ``phase12_launches``.
 13. api      the JAX package's remaining public API at the Quickstart's
              full width (int16 128 x 128 x 4096 -> Decode -> FORCES DAS
              onto 512 x 1024): compiled_stage_fns chained,
              compose_stages, Beamformer.push_data_with_compute and a
              das_backend="cuda" plan bit-equal to the das_backend="auto"
              plan, four launches of K2 and of K1;
              Beamformer(voxel_block=4096, profile=True,
              stage_timing="device") the same frame with its stats row
              filled; path A with das_backend="xla" (the plain twin on the
              card) within 1e-4 of K1 and launching no K1; the 8-angle
              TPW of phase 12 placed by shard_rf_tx on 2 channels x 4
              transmits within 1e-6 of the unsharded frame; with two cards
              or more, the Quickstart plan built and run on cuda:1 while
              cuda:0 is current bit-equal to cuda:0's frame, both cards
              synchronized (with one card a line says the check needs
              two).  The phase's launches go onto the kernel table's rows
              as ``phase13_launches``.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

RUNS = 5          # frames per main path, and timed runs of a plain twin
TIMED_RUNS = 21   # timed runs of a kernel or library call

# H100 SXM peaks (NVIDIA's data sheet, at the 700 W power limit): device
# memory rate and float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12     # dense tensor-core rates
PEAK_INT8_PER_S = 1979e12

# float32 operations per active pair of a DAS kernel, counted from
# csrc/das.cu (a square root, division, cosine or sincos counts as one):
# FORCES real cubic: index 1, cubic tap 26, weights and sum 3; FORCES IQ
# cubic: index 1, complex cubic tap 35, rotation 10, weights and sum 5;
# FORCES real linear with the incoherent sum: index 1, linear tap 8,
# weights and sum 3, incoherent sum 2; RCA IQ cubic: receive leg 16, complex
# cubic tap 35, rotation 10, scale and sum 4; a four-frame RCA IQ cubic
# launch pays the pair's geometry once (receive leg 16, tap weights 13,
# phase 4) and the rest per frame (complex cubic gather 22, rotation 6,
# scale and sum 4).  The FORCES transmit leg (a square root, two products
# and a sum: 5) is paid once per (voxel, transmit), not per pair.
OPS_FORCES_REAL_CUBIC = 30
OPS_FORCES_IQ_CUBIC = 51
OPS_FORCES_TX_LEG = 5
OPS_FORCES_REAL_LINEAR_COH = 14
OPS_RCA_IQ_CUBIC = 65
OPS_RCA_IQ_CUBIC_SHARED = 33
OPS_RCA_IQ_CUBIC_FRAME = OPS_RCA_IQ_CUBIC - OPS_RCA_IQ_CUBIC_SHARED
# HERCULES real linear, per (voxel, channel, transmit) triple inside the 2D
# mask, all of it counted per triple: transmit distance and mask 4,
# apodization 6
# (square root, two products, cosine, square, weight), index 4, linear tap
# 8, scale and sum 2.  Along a run of voxels whose lateral coordinates are
# equal (a column of depths at path C: das_cuda.lateral_run) part of that is
# the run's, not the voxel's: the transmit offset, its square, d2 and
# sqrt(d2), 4, counted once per (run, channel, transmit) with a voxel of the
# run inside the mask; what stays per triple is the mask 1, apodization 4
# (product, cosine, square, weight), index 4, linear tap 8, scale and sum 2.
OPS_HERCULES_REAL_LINEAR_PER_TRIPLE = 24
OPS_HERCULES_REAL_LINEAR = 19
OPS_HERCULES_RUN = 4
FRAME_BATCH = 4   # frames per push_batch on path E

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


def bound(nbytes: float, nops) -> tuple[float, str]:
    """Least time in ms for ``nbytes`` of device memory traffic and
    ``nops`` operations, and which of the two sets it.  ``nops`` is a count
    of float32 operations, or a list of ``(count, peak per second)`` for
    work on several units (the operation times add)."""
    b = nbytes / PEAK_BYTES_PER_S * 1e3
    if not isinstance(nops, (list, tuple)):
        nops = [(nops, PEAK_F32_PER_S)]
    o = sum(n / peak for n, peak in nops) * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def kernel_row(name, source, replaces, err, ms, plain_ms, nbytes, nops,
               library_ms=None, iqr=None) -> dict:
    """A row of the kernel table; ``replaces`` is a path under the JAX
    package, or from the repository root when it starts with
    ``experiments/``."""
    bound_ms, bound_by = bound(nbytes, nops)
    if not replaces.startswith("experiments/"):
        replaces = f"{TPU}/{replaces}"
    row = dict(name=name, route="cuda", source=f"{PKG}/csrc/{source}",
               replaces=replaces, launches=0, max_abs_err=float(err), ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    if iqr is not None:
        row["iqr_ms"] = iqr
    return row


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
    from ogl_beamforming_tpu_torch.kernels import build, sass
    t0 = time.perf_counter()
    build.library()
    dt = time.perf_counter() - t0
    log = build.library_path().with_suffix(".log")
    usage = sass.ptxas_usage(log.read_text()) if log.exists() else {}
    BUILD_FACTS["usage"] = usage
    text = sass.dump(build.library_path())
    BUILD_FACTS["loops"] = {f: sass.pair_loops(text, f) for f in sass.FAMILIES}
    BUILD_FACTS["i8"] = sass.kernel_counts(text)
    BUILD_FACTS["onehot"] = sass.onehot_loops(text)
    decode = "; ".join(f"{m.group(1)} {regs} registers, {spill} B spilled"
                       for name, (regs, spill) in sorted(usage.items())
                       for m in [re.search(r"(decode_(?:i8|f32)_kernel(?:ILi\d)?)",
                                           name)] if m)
    print(f"[build] {build.library_path().name} in {dt:.1f} s "
          f"(ptxas: {len(usage)} kernels; decode: {decode})")
    for family, loops in BUILD_FACTS["loops"].items():
        print(f"[build] das_{family}_kernel inner pair loop (cuobjdump -sass, "
              "static; instructions / pairs in the unrolled body -> per "
              "pair; LDG, LDS, MUFU): " + "; ".join(
                  f"{k} {c['instructions']}/{c['pairs']:g} -> "
                  f"{c['per_pair']:.1f} ({c['LDG']}, {c['LDS']}, {c['MUFU']})"
                  for k, c in sorted(loops.items()) if k.endswith("fb1")))


BUILD_FACTS: dict = {}   # ptxas usage and SASS loop counts (phase 2)


def kernel_facts(st, dyn, frames: int = 1) -> str:
    """Registers, spills, resident warps and the inner loop's SASS count of
    the DAS kernel instantiation that runs ``st`` (``frames`` frames a
    launch, the launch tables' thread shape), with the FORCES index table's
    pass."""
    from ogl_beamforming_tpu_torch.kernels import build, sass
    from ogl_beamforming_tpu_torch.ops import das_cuda
    mode = das_cuda._MODE[st.interpolation_mode]
    tables = dyn.get("launch") or das_cuda.launch_tables(st, dyn)
    thread = tables.get("thread")
    if thread is not None and frames > 1:   # the only four-frame shape
        thread = build.THREAD_SHAPES[st.family][0]
    tag = (f"das_{st.family}_kernelILi{mode}ELb{int(st.iq)}"
           f"ELb{int(st.coherency_weighting)}ELi{frames}E"
           + ("" if thread is None else "Li{}ELi{}ELb{}E".format(*thread)))
    regs = [v for k, v in BUILD_FACTS["usage"].items() if tag in k]
    check(len(regs) == 1, f"no single ptxas entry for {tag}")
    n_tx = (tables["tx_pos"].shape[0] if "tx_pos" in tables
            else st.acquisition_count)
    chunk = tables.get("tx_pass", das_cuda.WIDE_PASS)
    blocks = das_cuda.blocks_per_sm(st, n_tx, chunk, frames, thread=thread)
    check(blocks > 0, f"{tag}: no block fits on an SM")
    key = (f"{sass.MODES[mode]} {'iq' if st.iq else 'real'}"
           f"{' coh' if st.coherency_weighting else ''} fb{frames}")
    if thread is not None and thread != build.THREAD_SHAPES[st.family][0]:
        key += " t{}.{}.{}".format(*thread)
    loop = BUILD_FACTS["loops"][st.family].get(key)
    per_pair = f"{loop['per_pair']:.1f}" if loop else "not found"
    table = (f", {chunk} a pass of the index table" if st.family == "forces"
             else f", runs of {tables['run']} voxels")
    return (f"{regs[0][0]} registers, {regs[0][1]} B spilled, {blocks} "
            f"blocks = {4 * blocks} resident warps per SM at {n_tx} "
            f"transmits{table}; inner loop {per_pair} SASS instructions "
            f"per pair")


def active_pairs(st, dyn) -> tuple[int, int]:
    """(voxel, channel, transmit-or-acquisition) triples inside the
    apodization mask -- the pairs the DAS kernels compute -- and, for
    HERCULES, the (run, channel, transmit) groups with a voxel of the run
    inside it, where a run is das_cuda.lateral_run voxels that share their
    lateral coordinates (0 for the other families)."""
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import das_cuda
    world = das_ops._world_points(st, dyn)
    chans = das_ops._channels(dyn, st.channel_count)
    fnum = dyn["f_number"]
    if st.family == "forces":
        x, z = world[:, 0:1], world[:, 2:3]
        rx_dx = x - chans[None] * dyn["xdc_element_pitch"][0]
        on = torch.abs(fnum * rx_dx / z) < 0.5
        return int(on.sum()) * len(das_ops.transmit_tables(st, dyn)[0]), 0
    xdc = das_ops._apply_m4(dyn["xdc_transform"], world)
    if st.family == "hercules":
        # the 2D mask d2 < z^2 / (4 f#^2) over (channel, transmit), as the
        # twin forms it, one channel at a time; a run's groups at the
        # largest bound of its voxels
        rx_cols = bool(das_ops._rx_columns(dyn))
        rx_lat, tx_lat = ((xdc[:, 0], xdc[:, 1]) if rx_cols
                          else (xdc[:, 1], xdc[:, 0]))
        pitch = dyn["xdc_element_pitch"][0 if rx_cols else 1]
        foz = torch.abs(fnum / xdc[:, 2])
        test = 0.25 / (foz * foz)
        tx_pos = das_ops.transmit_tables(st, dyn)[0]
        tx_dd = tx_lat[None] - tx_pos[:, None]
        tx_d2 = tx_dd * tx_dd
        run = das_cuda.lateral_run(st, dyn)
        run_test = test.reshape(-1, run).amax(dim=1)
        run_rx, run_tx = rx_lat[::run], tx_lat[::run]
        run_tx_dd = run_tx[None] - tx_pos[:, None]
        run_tx_d2 = run_tx_dd * run_tx_dd
        total = groups = 0
        for ch in chans:
            rx_dd = rx_lat - ch * pitch
            total += int(((rx_dd * rx_dd)[None] + tx_d2 < test[None]).sum())
            run_dd = run_rx - ch * pitch
            groups += int(((run_dd * run_dd)[None] + run_tx_d2
                           < run_test[None]).sum())
        return total, groups
    tabs = das_ops.rca_tables(dyn)
    total = 0
    for a in range(st.acquisition_count):
        rows = bool(tabs[a, 1] == 1.0)
        lat = xdc[:, 1:2] if rows else xdc[:, 0:1]
        pitch = dyn["xdc_element_pitch"][1 if rows else 0]
        recv_lat = lat - chans[None] * pitch
        total += int((torch.abs(fnum * recv_lat / torch.abs(xdc[:, 2:3]))
                      < 0.5).sum())
    return total, 0


def pass_times(rf, dyn, st):
    """(transmits per pass, median ms) of the FORCES kernel at each pass of
    its index table, whichever the launch tables chose."""
    from ogl_beamforming_tpu_torch.ops import das_cuda
    tables = dyn.get("launch") or das_cuda.launch_tables(st, dyn)
    out = []
    for tx_pass in (das_cuda.NARROW_PASS, das_cuda.WIDE_PASS):
        d = dict(dyn, launch=dict(tables, tx_pass=tx_pass))
        out.append((tx_pass, median_ms(lambda: das_cuda.das_cuda(rf, d, st))))
    return out


def walk_times(rf, dyn, st):
    """(walk, median ms) of the HERCULES kernel walking each channel's
    transmit interval and the whole table, each launch's output equal to
    the other's bit for bit."""
    from ogl_beamforming_tpu_torch.ops import das_cuda
    tables = dyn.get("launch") or das_cuda.launch_tables(st, dyn)
    ref = das_cuda.das_cuda(rf, dyn, st)
    out = []
    for label, walk in (("interval", das_cuda.INTERVAL_WALK),
                        ("full", das_cuda.FULL_WALK)):
        d = dict(dyn, launch=dict(tables, tx_walk=walk))
        check(torch.equal(das_cuda.das_cuda(rf, d, st), ref),
              f"HERCULES {label} walk != the launch tables' walk")
        out.append((label,
                    median_ms(lambda: das_cuda.das_cuda(rf, d, st))))
    return out


def whole_grid(st):
    """``st`` with the plain twin computing the whole grid in one block
    (``voxel_block``, which the kernel ignores): the twin's fastest on the
    card, and how it ran before it took blocks."""
    import dataclasses
    return dataclasses.replace(
        st, voxel_block=int(np.prod(st.global_points or st.output_points)))


def das_row(name, label, rf, dyn, st, ops_per_pair,
            ops_per_triple=None) -> dict:
    """The DAS kernel against its twin on ``rf`` (each output, coherent and
    incoherent, to NRMSE 1e-4), both timed, the line printed; returns the
    kernel's row, its bound from ``ops_per_pair`` per active pair (and, for
    FORCES, the transmit leg once per voxel and transmit; for HERCULES, the
    run's share once per group of active_pairs, with the bound of
    ``ops_per_triple`` per pair, all of it per triple, printed beside
    it)."""
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import das_cuda
    outs_k = das_cuda.das_cuda(rf, dyn, st)
    t0 = time.perf_counter()
    outs_p = das_ops.das_ref(rf, dyn, whole_grid(st))
    if not isinstance(outs_k, tuple):
        outs_k, outs_p = (outs_k,), (outs_p,)
    err = max(compare(k, p, 1e-4, f"{label} DAS output {i}")
              for i, (k, p) in enumerate(zip(outs_k, outs_p)))
    worst = max(nrmse(p.cpu().numpy(), k.cpu().numpy())
                for k, p in zip(outs_k, outs_p))
    plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, whole_grid(st)),
                         RUNS)
    twin_s = time.perf_counter() - t0
    ms, iqr = kernel_ms(lambda: das_cuda.das_cuda(rf, dyn, st))
    out_bytes = sum(k.numel() * k.element_size() for k in outs_k)
    pairs, groups = active_pairs(st, dyn)
    nops = ops_per_pair * pairs
    nbytes = rf.numel() * rf.element_size() + out_bytes
    facts = "; " + kernel_facts(st, dyn)
    if st.family == "forces":
        voxels = int(np.prod(st.output_points))
        nops += (OPS_FORCES_TX_LEG * voxels
                 * len(das_ops.transmit_tables(st, dyn)[0]))
        facts += "; by pass: " + ", ".join(
            f"{p} transmits {ms_p:.3f} ms" for p, ms_p in pass_times(rf, dyn, st))
    elif st.family == "hercules":
        nops += OPS_HERCULES_RUN * groups
        flat, _ = bound(nbytes, ops_per_triple * pairs)
        new, _ = bound(nbytes, nops)
        facts += (f"; {groups} run groups; bound {new:.3f} ms ({ops_per_pair}"
                  f" per pair + the run's share), all per triple "
                  f"{flat:.3f} ms ({ops_per_triple} per pair)")
    if st.family == "hercules":
        facts += "; by walk: " + ", ".join(
            f"{w} {ms_w:.3f} ms" for w, ms_w in walk_times(rf, dyn, st))
    print(f"[kernels] DAS {label} {tuple(rf.shape)} -> {st.output_points}: "
          f"NRMSE {worst:.3e}, max abs err {err:.3e}; kernel {ms:.3f} ms "
          f"(IQR {iqr:.3f}), plain {plain_ms:.3f} ms; {pairs} active pairs; "
          f"twin took {twin_s:.1f} s{facts}")
    return kernel_row(name, "das.cu", "ops/das_pallas.py:1963", err, ms,
                      plain_ms, nbytes, nops, iqr=iqr)


def forces_frame_batch(rf, dyn, st) -> None:
    """The FORCES kernel's four-frame launch at ``rf``'s shape: each frame
    (``rf`` scaled by 1..4) against a single-frame launch on it, NRMSE
    <= 1e-6."""
    import dataclasses

    from ogl_beamforming_tpu_torch.ops import das_cuda
    frames = torch.stack([rf * float(b + 1) for b in range(FRAME_BATCH)])
    out4 = das_cuda.das_cuda(frames, dyn, dataclasses.replace(
        st, frame_batch=FRAME_BATCH))
    err = max(compare(out4[b], das_cuda.das_cuda(frames[b], dyn, st), 1e-6,
                      f"four-frame FORCES frame {b}")
              for b in range(FRAME_BATCH))
    print(f"[kernels] DAS FORCES cubic, {FRAME_BATCH} frames in one launch "
          f"{tuple(frames.shape)}: each frame vs a single-frame launch max "
          f"abs err {err:.3e}")


def phase_kernels(dev) -> list[dict]:
    import torch.nn.functional as F

    from ogl_beamforming_tpu_torch import (DataKind, FilterKind,
                                           FilterParameters,
                                           KaiserFilterParameters,
                                           MatchedChirpFilterParameters)
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import decode, filtering
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    from ogl_beamforming_tpu_torch.utils.filters import make_filter

    rng = np.random.default_rng(1234)
    rows = []

    # decode, int16 at the main path's shape: bit-equal; bound by bytes
    # (the int8 tensor cores do its 2 x 2 C A^2 S operations in 0.017 ms)
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
    row = kernel_row(
        "decode_hadamard", "decode.cu", "ops/decode.py:247", dec_err, dec_ms,
        dec_plain_ms, rf.numel() * 2 + out_k.numel() * 4 + a * a,
        [(2 * 2.0 * c * a * a * s, PEAK_INT8_PER_S)], dec_lib_ms, iqr=dec_iqr)
    print(f"[kernels] decode int16 {c}x{a}x{s}: bit-equal; kernel "
          f"{dec_ms:.3f} ms (IQR {dec_iqr:.3f}), plain {dec_plain_ms:.3f} ms, "
          f"cuBLAS f32 matmul {dec_lib_ms:.3f} ms; bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']}), "
          f"{row['bound_ms'] / dec_ms:.3f} of it")
    rows.append(row)
    del rf32, out_k, out_p

    # decode, int16 at paths C (order 128) and D (order 64, 256 channels):
    # bit-equal
    for label, shape in (("path C", (128, 128, 2048)),
                         ("path D", (256, 64, 2048))):
        x = torch.from_numpy(rng.integers(-32768, 32767, shape,
                                          dtype=np.int16)).to(dev)
        hh = decode.hadamard_matrix(shape[1], device=dev)
        k = decode.decode_hadamard_cuda(x, hh)
        p = decode.decode_hadamard_ref(x, hh)
        torch.cuda.synchronize()
        check(torch.equal(k, p), f"int16 decode at {label} {shape} != twin")
        print(f"[kernels] decode int16 {label} {shape}: bit-equal")
        del x, k, p

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
        del x, k, p

    # decode, complex64 at path B's decode stage (128 x 128 x 2048 complex,
    # 4096 floats a row after the interleave): the float32 kernel, max error
    # <= 1e-6 of the peak; three bf16 products on the tensor cores
    shape = (c, a, s // 2)
    x = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    k = decode.decode_hadamard_cuda(x, h)
    p = decode.decode_hadamard_ref(x, h)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    rel = err / float(p.abs().max())
    check(rel <= 1e-6, f"complex64 decode max relative error {rel:.3e}")
    f_ms, f_iqr = kernel_ms(lambda: decode.decode_hadamard_cuda(x, h))
    f_plain_ms = median_ms(lambda: decode.decode_hadamard_ref(x, h), RUNS)
    xf = torch.view_as_real(x).reshape(c, a, s)
    f_lib_ms = median_ms(lambda: torch.matmul(h, xf))
    nbytes = 2 * x.numel() * 8 + a * a
    row = kernel_row(
        "decode_hadamard_f32", "decode.cu", "ops/decode.py:247", err, f_ms,
        f_plain_ms, nbytes, [(3 * 2.0 * c * a * a * s, PEAK_BF16_PER_S)],
        f_lib_ms, iqr=f_iqr)
    print(f"[kernels] decode complex64 {shape} (float32 kernel on "
          f"{(c, a, s)}): max rel err {rel:.3e}; kernel {f_ms:.3f} ms (IQR "
          f"{f_iqr:.3f}), plain {f_plain_ms:.3f} ms, cuBLAS f32 matmul "
          f"{f_lib_ms:.3f} ms; bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}, {nbytes / 1e6:.1f} MB), "
          f"{row['bound_ms'] / f_ms:.3f} of it")
    rows.append(row)
    del x, k, p, xf

    # DAS, FORCES cubic real at the Quickstart's shape
    params, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=128, sample_count=4096,
        demodulate=False)
    plan = build_plan(params, pipe, {}, device=dev)
    st = plan.descriptor.stages[-1].das
    dyn = plan.dyn["das"]
    rf = torch.from_numpy(
        rng.standard_normal((c, a, s), dtype=np.float32)).to(dev)
    rows.append(das_row("das_forces", "FORCES cubic", rf, dyn, st,
                        OPS_FORCES_REAL_CUBIC))
    forces_frame_batch(rf, dyn, st)
    del rf

    # DAS, FORCES cubic IQ at path B's DAS stage: the plan of the preset's
    # demodulate chain, with path B's Kaiser taps in slot 0
    fs, fd = 40e6, 7.8e6
    kaiser = make_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs / 2,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16)))
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s)
    plan = build_plan(params, pipe, {0: kaiser}, device=dev)
    phasor = plan.dyn["phasor0"]         # the Demodulate stage's table
    st = plan.descriptor.stages[-1].das
    dyn = plan.dyn["das"]
    check(st.iq and st.sample_count == s // 2,
          f"path B's DAS stage is not IQ over {s // 2} samples: {st}")
    shape = (c, a, st.sample_count)
    rf = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    rows.append(das_row(
        "das_forces_iq",
        f"FORCES cubic IQ at {float(dyn['sampling_frequency']) / 1e6:g} MHz, "
        f"t0 {float(dyn['time_offset']):.4e} s", rf, dyn, st,
        OPS_FORCES_IQ_CUBIC))
    del rf

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
    rows.append(das_row("das_rca", "RCA Flash cubic IQ", rf, dyn, st,
                        OPS_RCA_IQ_CUBIC))
    del rf

    # demodulate, int16 (128, 128, 4096) with path B's Kaiser taps and its
    # plan's rotation table, built outside the timed calls as the pipeline
    # builds it, once per plan
    taps = torch.from_numpy(kaiser.taps).to(dev)
    length = taps.shape[0]
    rf = torch.from_numpy(rng.integers(-2048, 2048, (c, a, s),
                                       dtype=np.int16)).to(dev)

    def demod():
        return filtering.demodulate_cuda(rf, taps, fd, fs, phasor=phasor)

    dm_k = demod()
    dm_p = filtering.demodulate_ref(rf, taps, fd, fs)
    dm_err = compare(dm_k, dm_p, 1e-6, "demodulate")
    dm_ms, dm_iqr = kernel_ms(demod)
    dm_plain_ms = median_ms(
        lambda: filtering.demodulate_ref(rf, taps, fd, fs), RUNS)
    n_out = dm_k.numel()
    n_pairs = s // 2

    # the yardstick, two calls: the rotation as torch ops, then F.conv1d of
    # re and im as two depthwise channels (TF32 off: package __init__)
    w2 = taps.reshape(1, 1, -1).repeat(2, 1, 1)

    def rotate_conv():
        x = rf.to(torch.float32)
        i, q = x[..., 0::2], x[..., 1::2]
        cos, sin = phasor.unbind(-1)
        re = filtering.SQRT2_F32 * (i * cos - q * sin)
        im = filtering.SQRT2_F32 * (-q * cos - i * sin)
        xin = torch.stack([re, im], dim=-2).reshape(-1, 2, n_pairs)
        return F.conv1d(xin, w2, padding=length - 1, groups=2)[..., :n_pairs]

    y = rotate_conv()
    comp_err = float((torch.complex(y[:, 0], y[:, 1]).reshape(dm_k.shape)
                      - dm_k).abs().max())
    comp_ms = median_ms(rotate_conv)
    del y
    print(f"[kernels] demodulate int16 {c}x{a}x{s} -> {tuple(dm_k.shape)} "
          f"complex, {length} Kaiser taps, the plan's table: max abs err "
          f"{dm_err:.3e}; kernel {dm_ms:.3f} ms (IQR {dm_iqr:.3f}); "
          f"plain {dm_plain_ms:.3f} ms; two-call composite (rotation as "
          f"torch ops + F.conv1d) {comp_ms:.3f} ms (max abs diff "
          f"{comp_err:.3e})")
    row = kernel_row(
        "demodulate", "filter.cu", "ops/demod_pallas.py:94", dm_err, dm_ms,
        dm_plain_ms, rf.numel() * 2 + n_out * 8 + length * 4
        + phasor.numel() * 4, n_out * 4 * length + n_pairs * c * a * 9,
        iqr=dm_iqr)
    dm_row = dict(row, composite_ms=comp_ms)
    rows.append(dm_row)
    del dm_k, dm_p

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
        def fir(h=h):
            return filtering.fir_cuda(x, h)

        k = fir()
        p = filtering.fir_filter_ref(x, h)
        err = compare(k, p, 1e-6, f"FIR {label} taps")
        ms, iqr = kernel_ms(fir)
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
            row = kernel_row(
                "fir", "filter.cu", "ops/demod_pallas.py:160", err, ms,
                plain_ms, x.numel() * 8 * 2 + h.numel() * 4,
                x.numel() * 4 * h.shape[0], lib_ms, iqr=iqr)
            rows.append(row)
            fir_row, fir_real = row, fir

    # both kernels' device time from torch.profiler traces, taken after
    # phase 7's: a trace this early left later traces of the process
    # without kernel events on the card
    FILTER_TRACES.update(demodulate_kernel=(demod, dm_row),
                         fir_kernel=(fir_real, fir_row))
    return rows


FILTER_TRACES: dict = {}   # kernel name -> (call, its table row), phase 3


def phase_filter_traces() -> None:
    """The device time per launch of phase 3's demodulate and FIR calls
    from a torch.profiler trace (``experiments.traced_ms``), onto their rows
    of the kernel table."""
    from ogl_beamforming_tpu_torch.experiments import traced_ms

    for name, (fn, row) in FILTER_TRACES.items():
        row["trace_ms"] = traced_ms(fn, kernel=name)
    print("[kernels] by the trace, ms per launch: " + ", ".join(
        f"{name} {row['trace_ms']:.4f}"
        for name, (_, row) in FILTER_TRACES.items()))
    FILTER_TRACES.clear()


def phase_kernels_volumes(dev) -> list[dict]:
    """Phase 3 at the shapes of paths C, D and E: HERCULES DAS, UFORCES DAS
    with the incoherent sum, and the four-frame RCA launch."""
    import dataclasses

    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import das_cuda
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan

    rng = np.random.default_rng(4321)
    rows = []
    for label, name, ops, ops_per_triple in (
            ("HERCULES linear (path C)", "das_hercules",
             OPS_HERCULES_REAL_LINEAR, OPS_HERCULES_REAL_LINEAR_PER_TRIPLE),
            ("UFORCES linear + incoherent sum (path D)", "das_forces_coh3d",
             OPS_FORCES_REAL_LINEAR_COH, None)):
        if name == "das_hercules":
            params, pipe = presets.hercules_3d()
            plan = build_plan(params, pipe, {}, device=dev)
        else:
            params, pipe, sparse = presets.uforces_volumetric()
            plan = build_plan(params, pipe, {}, sparse_elements=sparse,
                              device=dev)
        st = plan.descriptor.stages[-1].das
        dyn = plan.dyn["das"]
        shape = (params.channel_count, params.acquisition_count,
                 st.sample_count)
        rf = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).to(dev)
        rows.append(das_row(name, label, rf, dyn, st, ops, ops_per_triple))
        del rf

    # the four-frame RCA launch at path E's batch, against four
    # single-frame launches and the twin, and timed beside them
    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    plan = build_plan(params, pipe, {}, device=dev, frame_batch=FRAME_BATCH)
    st4 = plan.descriptor.stages[-1].das
    st1 = dataclasses.replace(st4, frame_batch=1)
    dyn = plan.dyn["das"]
    shape = (FRAME_BATCH, params.channel_count, 1, params.sample_count)
    rf = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    out4 = das_cuda.das_cuda(rf, dyn, st4)
    ones = [das_cuda.das_cuda(rf[b], dyn, st1) for b in range(FRAME_BATCH)]
    torch.cuda.synchronize()
    equal = all(torch.equal(out4[b], ones[b]) for b in range(FRAME_BATCH))
    check(equal, "four-frame RCA launch != single-frame launches bit for bit")
    fb_err = max(compare(out4[b], ones[b], 1e-6, f"four-frame RCA frame {b}")
                 for b in range(FRAME_BATCH))
    twin = das_ops.das_ref(rf, dyn, whole_grid(st4))
    err = compare(out4, twin, 1e-4, "four-frame RCA vs twin")
    worst = nrmse(twin.cpu().numpy(), out4.cpu().numpy())
    ms, iqr = kernel_ms(lambda: das_cuda.das_cuda(rf, dyn, st4))
    ones_ms, ones_iqr = kernel_ms(
        lambda: [das_cuda.das_cuda(rf[b], dyn, st1)
                 for b in range(FRAME_BATCH)])
    plain_ms = median_ms(lambda: das_ops.das_ref(rf, dyn, whole_grid(st4)),
                         RUNS)
    pairs, _ = active_pairs(st1, dyn)
    print(f"[kernels] DAS RCA Flash cubic IQ, {FRAME_BATCH} frames in one "
          f"launch {tuple(shape)} -> {st1.output_points}: vs single-frame "
          f"launches max abs err {fb_err:.3e}, bit-equal {equal}; vs twin "
          f"NRMSE {worst:.3e}; one {FRAME_BATCH}-frame launch {ms:.3f} ms "
          f"(IQR {iqr:.3f}), {FRAME_BATCH} single-frame launches "
          f"{ones_ms:.3f} ms (IQR {ones_iqr:.3f}); plain {plain_ms:.3f} ms; "
          f"{pairs} active pairs per frame; "
          f"{kernel_facts(st1, dyn, FRAME_BATCH)}")
    rows.append(kernel_row(
        "das_rca_fb4", "das.cu", "ops/das_pallas.py:1963", max(err, fb_err),
        ms, plain_ms, rf.numel() * 8 + out4.numel() * 8,
        pairs * (OPS_RCA_IQ_CUBIC_SHARED
                 + FRAME_BATCH * OPS_RCA_IQ_CUBIC_FRAME), iqr=iqr))
    return rows


def encode_echoes(dist, s, fs, sos, f0, h):
    """Echoes of a point target whose (channel, acquisition) path lengths
    are ``dist`` (C, A) metres (1 km: a silent acquisition), Hadamard-
    encoded across acquisitions as the scanner records them, as int16
    (C, A*S)."""
    t = (np.arange(s) / fs).astype(np.float32)
    dist = dist.astype(np.float32)
    arg = t[None, None, :] - dist[:, :, None] / np.float32(sos)
    env = np.exp(-0.5 * (arg / np.float32(2 / f0 / 4)) ** 2)
    # a cosine burst (examples/point_scatterer.py uses a sine): the preset's
    # axial voxel pitch is coarser than a quarter carrier period, so the
    # image cannot resolve a sine burst's envelope, but a cosine burst's
    # coherent sum peaks on the target voxel itself
    echo = (env * np.cos(np.float32(2 * np.pi * f0) * arg)).astype(np.float32)
    encoded = np.matmul(h.T.astype(np.float32), echo)   # "tj,cts->cjs"
    encoded *= 30000.0 / np.abs(encoded).max()
    return np.clip(encoded, -32768, 32767).astype(np.int16).reshape(
        dist.shape[0], -1)


def synthesize_forces_frame(c, a, s, fs, sos, pitch, target, f0, h,
                            elements=None):
    """A point target under FORCES (transmit ``j`` fires element ``j``) or
    uFORCES (acquisition ``j + 1`` fires ``elements[j]``, acquisition 0 is
    silent): the twin's receive and transmit legs, int16 (C, A*S)."""
    rx_x = np.arange(c) * pitch
    ty = target[1] - pitch * c / 2
    rx_d = np.sqrt((target[0] - rx_x) ** 2 + target[2] ** 2)
    if elements is None:
        tx_x = np.arange(a) * pitch
    else:
        tx_x = np.concatenate([[np.nan], np.asarray(elements[:a - 1]) * pitch])
    tx_d = np.sqrt(ty ** 2 + target[2] ** 2 + (target[0] - tx_x) ** 2)
    dist = np.nan_to_num(rx_d[:, None] + tx_d[None, :], nan=1e3)
    return encode_echoes(dist, s, fs, sos, f0, h)


def synthesize_hercules_frame(params, target, h):
    """A point target under HERCULES as the twin delays it: acquisition 0's
    plane-wave transmit from the rows, then the receive leg
    ``sqrt(z^2 + d2)`` from column ``c`` at ``x = c p`` and row ``j`` at
    ``y = j p``; int16 (C, A*S)."""
    c, a = params.channel_count, params.acquisition_count
    pitch = float(params.xdc_element_pitch[0])
    x, y, z = target
    angle = np.radians(float(params.focal_vector[0]))
    tx = y * np.sin(angle) + z * np.cos(angle)
    d2 = ((x - np.arange(c) * pitch) ** 2)[:, None] \
        + ((y - np.arange(a) * pitch) ** 2)[None, :]
    return encode_echoes(tx + np.sqrt(z * z + d2), params.sample_count,
                         params.sampling_frequency, params.speed_of_sound,
                         params.demodulation_frequency, h)


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


def golden_das(p, rf, sample_count, fs, time_offset, vt=None, **kw):
    """The golden DAS of ``rf`` (C, A, S') with ``p``'s geometry at the DAS
    stage's sample count, sampling rate and time offset (``kw``: further
    ``DasParams`` fields)."""
    from ogl_beamforming_tpu_torch.ops import golden
    return golden.das(rf, das_params(p, sample_count, fs, time_offset, vt,
                                     **kw))


def das_params(p, sample_count, fs, time_offset, vt=None, **kw):
    """The ``DasParams`` of :func:`golden_das`."""
    from ogl_beamforming_tpu_torch.ops import golden
    from ogl_beamforming_tpu_torch.utils.transforms import das_output_dimension
    return golden.DasParams(
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
        focus_depth=float(p.focal_vector[1]), **kw)


def beamformer(dev, p, shaders, data_kind, filters=(), sparse=None,
               mesh=None):
    """A fresh Beamformer on ``dev`` (over ``mesh`` when given) configured
    with ``p``."""
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
    bf = Beamformer(device=dev, mesh=mesh)
    for slot, fp in filters:
        bf.create_filter(fp, filter_slot=slot)
    bf.push_parameters(p)
    bf.push_pipeline(shaders, data_kind)
    if sparse is not None:
        bf.push_sparse_elements(sparse)
    return bf


def run_frame(dev, p, shaders, data_kind, raw, filters=(), sparse=None):
    """One frame through a fresh Beamformer on ``dev``."""
    return beamformer(dev, p, shaders, data_kind, filters,
                      sparse).push_data_with_compute(raw).to_numpy()


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
    from ogl_beamforming_tpu_torch.utils.transforms import (
        das_transform_2d_xz, das_transform_3d)

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

    # the same, a batch of two frames through push_batch
    raw2 = rng.integers(-2048, 2048, (2, c, a * s), dtype=np.int16)
    frames = beamformer(dev, p, [ShaderKind.Decode, ShaderKind.DAS],
                        DataKind.Int16).push_batch(raw2)
    for b, frame in enumerate(frames):
        dec = golden.decode_hadamard(raw2[b].reshape(c, a, s), hadamard(a))
        check_canary(f"FORCES push_batch frame {b} of 2", frame.to_numpy(),
                     golden_das(p, dec, s, 20e6, 0.0), (64, 64, 1))

    # HERCULES 3D and uFORCES 3D with coherency, voxels in the first 12 mm
    ph, pipe = presets.hercules_3d(channel_count=16, acquisition_count=16,
                                   sample_count=512,
                                   output_points=(24, 24, 24))
    ap = 15 * float(ph.xdc_element_pitch[0])
    ph.das_voxel_transform = das_transform_3d([0, 0, 2e-3], [ap, ap, 12e-3])
    raw = rng.integers(-2048, 2048, (16, 16 * 512), dtype=np.int16)
    out = run_frame(dev, ph, pipe.shaders, pipe.data_kind, raw)
    dec = golden.decode_hadamard(raw.reshape(16, 16, 512), hadamard(16))
    check_canary("HERCULES 16x16x512 -> 24^3", out,
                 golden_das(ph, dec, 512, ph.sampling_frequency,
                            ph.time_offset), (24, 24, 24))
    pu, pipe, sparse = presets.uforces_volumetric(
        channel_count=32, acquisition_count=16, sample_count=512,
        output_points=(24, 24, 24))
    ap = 31 * float(pu.xdc_element_pitch[0])
    pu.das_voxel_transform = das_transform_3d([0, -ap / 2, 2e-3],
                                              [ap, ap / 2, 12e-3])
    raw = rng.integers(-2048, 2048, (32, 16 * 512), dtype=np.int16)
    out = run_frame(dev, pu, pipe.shaders, pipe.data_kind, raw,
                    sparse=sparse)
    dec = golden.decode_hadamard(raw.reshape(32, 16, 512), hadamard(16))
    ref = golden.coherency_weighting(*golden_das(
        pu, dec, 512, pu.sampling_frequency, pu.time_offset, sparse=True,
        sparse_elements=sparse, coherency_weighting=True))
    check_canary("uFORCES + coherency 32x16x512 -> 24^3", out, ref,
                 (24, 24, 24))

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


def peak_check(label, img, target_voxel) -> tuple:
    """The peak of |img| must lie within one voxel of ``target_voxel`` on
    every axis; returns the peak's voxel."""
    check(np.isfinite(img).all(), f"{label}: values not finite")
    peak = np.unravel_index(np.argmax(np.abs(img)), img.shape)
    check(all(abs(int(p) - t) <= 1 for p, t in zip(peak, target_voxel)),
          f"{label}: image peak at voxel {tuple(map(int, peak))}, target "
          f"{tuple(target_voxel)}")
    return tuple(int(p) for p in peak)


def stage_split(bf, first_row, rows) -> tuple[np.ndarray, str]:
    """Median per-stage ms of stats rows ``first_row`` .. ``+ rows``."""
    stages = bf._blocks[0]._plan.descriptor.stages
    times = bf.compute_timings().times[first_row:first_row + rows,
                                       :len(stages)] * 1e3
    stage = np.median(times, axis=0)
    return stage, " + ".join(f"{sd.kind.name} {t:.3f}"
                             for sd, t in zip(stages, stage))


def drive(label, dev, params, pipe, raw, target_voxel, kernels,
          filters=(), sparse=None) -> dict:
    """Warm up, then RUNS frames of ``raw`` through Beamformer(device=dev)
    with the launch counts set to 0 just before and read just after; the
    peak of |image| must lie within one voxel of ``target_voxel`` on every
    axis and each of ``kernels`` must launch once per frame.  Returns the
    counts."""
    from ogl_beamforming_tpu_torch.kernels import build

    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind, filters,
                    sparse)
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
    shape = grid_shape(params)
    check(img.shape == shape, f"{label}: frame shape {img.shape} != {shape}")
    peak = peak_check(label, img, target_voxel)

    # stats rows 1..RUNS hold the timed frames (row 0 is the warmup frame)
    stage, split = stage_split(bf, 1, RUNS)
    print(f"[{label}] peak {peak} vs target {tuple(target_voxel)}; launches "
          f"{launches}")
    print(f"[{label}] device ms/frame {float(stage.sum()):.3f} ({split}, "
          f"median CUDA events); end to end incl. host prepare_rf + upload "
          f"{statistics.median(wall):.3f} ms/frame (median host clock)")
    return launches


def grid_shape(params) -> tuple:
    """The DAS grid of ``params`` (a 2D preset's grid is (nx, nz, 1))."""
    from ogl_beamforming_tpu_torch.utils import transforms
    return tuple(int(n) for n in
                 transforms.das_output_dimension(params.output_points[:3]))


def target_world(params, voxel) -> np.ndarray:
    """World point of ``voxel`` (ix, iy, iz) of the DAS grid."""
    n = grid_shape(params)
    vt = np.asarray(params.das_voxel_transform, np.float64)
    u = [v / max(int(k) - 1, 1) for v, k in zip(voxel, n)]
    return (vt @ np.array([*u, 1.0]))[:3]


def quickstart_parameters():
    """The Quickstart's parameters, pipeline and the point target's
    voxel."""
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=128, sample_count=4096,
        demodulate=False)
    voxel = (int(params.output_points[0]) // 2,
             int(params.output_points[1]) // 2, 0)
    return params, pipe, voxel


def quickstart():
    """The Quickstart's parameters, pipeline, point-target frame and the
    target's voxel."""
    from ogl_beamforming_tpu_torch.ops import decode

    params, pipe, voxel = quickstart_parameters()
    c, a, s = (params.channel_count, params.acquisition_count,
               params.sample_count)
    raw = synthesize_forces_frame(
        c, a, s, params.sampling_frequency, params.speed_of_sound,
        float(params.xdc_element_pitch[0]), target_world(params, voxel),
        params.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy())
    return params, pipe, raw, voxel


def phase_main(dev) -> dict:
    params, pipe, raw, voxel = quickstart()
    return drive("main", dev, params, pipe, raw, voxel,
                 ("decode_hadamard", "das_forces"))


def plane_wave():
    """Path A's parameters, pipeline, point-target frame and voxel."""
    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    # a target inside the 0-51 mm aperture: x = 25.5 mm, z = 40.2 mm
    voxel = (364, 199, 0)
    raw = synthesize_plane_wave_frame(
        params.channel_count, params.sample_count, params.sampling_frequency,
        params.speed_of_sound, float(params.xdc_element_pitch[0]),
        target_world(params, voxel), params.demodulation_frequency)
    return params, pipe, raw, voxel


def phase_main_rca(dev) -> dict:
    params, pipe, raw, voxel = plane_wave()
    return drive("main_rca", dev, params, pipe, raw, voxel, ("das_rca",))


def path_b():
    """Path B, the demodulate chain at full width: its parameters, pipeline
    and filters ([(slot, FilterParameters)])."""
    from ogl_beamforming_tpu_torch import (FilterKind, FilterParameters,
                                           KaiserFilterParameters)
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=128, sample_count=4096)
    # the Kaiser low-pass is designed at the rate it runs at, the pair rate
    # fs / 2: its delay compensation (L / 2 / fs) assumes that rate
    fp = FilterParameters(kind=FilterKind.Kaiser,
                          sampling_frequency=params.sampling_frequency / 2,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    return params, pipe, [(0, fp)]


def path_b_frame():
    """Path B's point-target frame and the target's voxel."""
    from ogl_beamforming_tpu_torch.ops import decode

    params, _, _ = path_b()
    c, a, s = (params.channel_count, params.acquisition_count,
               params.sample_count)
    voxel = (int(params.output_points[0]) // 2,
             int(params.output_points[1]) // 2, 0)
    raw = synthesize_forces_frame(
        c, a, s, params.sampling_frequency, params.speed_of_sound,
        float(params.xdc_element_pitch[0]), target_world(params, voxel),
        params.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy())
    return raw, voxel


def phase_main_demod(dev) -> dict:
    params, pipe, filters = path_b()
    raw, voxel = path_b_frame()
    return drive("main_demod", dev, params, pipe, raw, voxel,
                 ("demodulate", "decode_hadamard", "das_forces"),
                 filters=filters)


def phase_main_hercules(dev) -> dict:
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import decode

    params, pipe = presets.hercules_3d()
    # mid-aperture, 3/7 of the way down the 5-40 mm depth range: voxel
    # (48, 48, 40) of 96^3, x = y = 19.3 mm, z = 19.7 mm
    nx, ny, nz = grid_shape(params)
    voxel = (nx // 2, ny // 2, (nz - 1) * 3 // 7)
    raw = synthesize_hercules_frame(
        params, target_world(params, voxel),
        decode.hadamard_matrix(params.acquisition_count, "cpu").numpy())
    return drive("main_hercules", dev, params, pipe, raw, voxel,
                 ("decode_hadamard", "das_hercules"))


def uforces():
    """Path D's parameters, pipeline, sparse transmits, point-target frame
    and the target's voxel."""
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import decode

    params, pipe, sparse = presets.uforces_volumetric()
    # mid-aperture, 3/8 of the way down the 5-45 mm depth range: voxel
    # (64, 64, 47) of 128^3, x = 38.6 mm, y = 0.3 mm, z = 19.8 mm
    nx, ny, nz = grid_shape(params)
    voxel = (nx // 2, ny // 2, (nz - 1) * 3 // 8)
    c, a = params.channel_count, params.acquisition_count
    raw = synthesize_forces_frame(
        c, a, params.sample_count, params.sampling_frequency,
        params.speed_of_sound, float(params.xdc_element_pitch[0]),
        target_world(params, voxel), params.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy(), elements=sparse)
    return params, pipe, sparse, raw, voxel


def phase_main_uforces(dev) -> dict:
    params, pipe, sparse, raw, voxel = uforces()
    return drive("main_uforces", dev, params, pipe, raw, voxel,
                 ("decode_hadamard", "das_forces"), sparse=sparse)


def phase_main_batch(dev) -> dict:
    """Path E: the plane-wave headline, FRAME_BATCH frames per push_batch (a
    warm-up batch, then RUNS batches, counts set to 0 just before and read
    just after); the four-frame DAS launch must run once per batch and the
    single-frame one never.  Each frame of the last batch must equal
    push_data_with_compute of it to NRMSE 1e-6 and put its peak within one
    voxel of the target; averaged_frame must equal the mean of the four."""
    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    voxel = (364, 199, 0)
    one = synthesize_plane_wave_frame(
        params.channel_count, params.sample_count, params.sampling_frequency,
        params.speed_of_sound, float(params.xdc_element_pitch[0]),
        target_world(params, voxel), params.demodulation_frequency)
    noise = np.random.default_rng(5).standard_normal(
        (FRAME_BATCH,) + one.shape).astype(np.float32) * 0.01
    raw = one[None] * np.arange(1, FRAME_BATCH + 1, dtype=np.float32)[
        :, None, None] + noise
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    bf.push_batch(raw)
    torch.cuda.synchronize()

    build.LAUNCHES.clear()
    wall = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        frames = bf.push_batch(raw)
        wall.append((time.perf_counter() - t0) * 1e3 / FRAME_BATCH)
    launches = {k: build.LAUNCHES[k] for k in ("das_rca_fb4", "das_rca")}
    check(launches == {"das_rca_fb4": RUNS, "das_rca": 0},
          f"main_batch: launch counts {launches}, expected one four-frame "
          f"launch in each of {RUNS} batches")

    imgs = np.stack([f.to_numpy() for f in frames])
    single = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    worst = 0.0
    for b in range(FRAME_BATCH):
        peak_check(f"main_batch frame {b}", imgs[b], voxel)
        ref = single.push_data_with_compute(raw[b]).to_numpy()
        worst = max(worst, nrmse(ref, imgs[b]))
    check(worst <= 1e-6, f"main_batch: frame vs push_data_with_compute "
          f"NRMSE {worst:.3e} > 1e-6")
    avg = bf.averaged_frame(FRAME_BATCH).to_numpy()
    avg_err = nrmse(imgs.mean(axis=0), avg)
    check(avg_err <= 1e-6, f"main_batch: averaged_frame NRMSE {avg_err:.3e}")

    # stats rows FRAME_BATCH.. hold the timed batches' frames
    stage, split = stage_split(bf, FRAME_BATCH, RUNS * FRAME_BATCH)
    print(f"[main_batch] {FRAME_BATCH} frames per push_batch: launches "
          f"{launches}; each frame vs push_data_with_compute NRMSE "
          f"<= {worst:.3e}; averaged_frame vs mean NRMSE {avg_err:.3e}; "
          f"peaks within one voxel of {voxel}")
    print(f"[main_batch] device ms/frame {float(stage.sum()):.3f} ({split}, "
          f"median CUDA events over the batch / {FRAME_BATCH}); end to end "
          f"incl. host prepare_rf + upload {statistics.median(wall):.3f} "
          f"ms/frame (median host clock / {FRAME_BATCH})")
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the microbenchmark kernels (K5-K11, ogl_beamforming_tpu_torch.
# experiments).  Each kernel against its plain version at its TPU file's
# shapes (gather-and-add variants and the int8 probes bit-equal, the rest
# NRMSE 1e-6), then its module's sweep with the launch counts set to 0 just
# before and read just after, then its table row at one timed shape.

MICRO_ITERS = 5              # launches per timed run in the phase's sweeps
MICRO_ADD_ONLY = {"clip", "mod", "raw", "f32_direct", "i32_direct",
                  "bcast_hoist", "bcast_chunk"}
TILE_BYTES = 5 * 16 * 128 * 4     # four (16, 128) input tiles and the output


def micro_compare(out, ref, exact: bool, label: str) -> float:
    """The kernel's tile against the plain version's: bit-equal when
    ``exact``, else NRMSE <= 1e-6; returns the max abs error."""
    torch.cuda.synchronize()
    k, p = out.cpu().numpy(), ref.cpu().numpy()
    check(k.shape == p.shape and np.isfinite(k).all(),
          f"{label}: kernel {k.shape} vs plain {p.shape}, or not finite")
    if exact:
        check(np.array_equal(k, p), f"{label}: not bit-equal to the plain "
              f"version (max abs err {np.abs(k - p).max():.3e})")
    else:
        err = nrmse(p, k)
        check(err <= 1e-6, f"{label}: NRMSE {err:.3e} > 1e-6")
    return float(np.abs(k.astype(np.float64) - p).max())


def launches_of(name: str, run) -> int:
    """``run()`` with the launch counts set to 0 just before; returns the
    launches of kernel ``name`` it made."""
    from ogl_beamforming_tpu_torch.kernels import build
    build.LAUNCHES.clear()
    run()
    return build.LAUNCHES[name]


def gather_ops(steps, reps, ops_per_rep) -> float:
    return float(steps) * reps * 16 * 128 * ops_per_rep


# The K5, K6 and K7 bounds counted from the function, at the card's highest
# SM clock: its float adds (K5 "mod": REPS an element) or multiply-adds (K6
# and K7 "hermite_pair": 4 a bundle, a bundle every second repetition, so 2
# REPS an element) at the issue rate of the float pipes (128 a clock an SM;
# no add is counted against the FMA-counted 67 TFLOP/s), and its distinct
# gathers of a 4-byte word at the shared memory's peak, one warp-wide
# gather a clock an SM (32 banks of 4 bytes): K5 and K6 4 an element (the
# r & 3 index repeats every four repetitions; K6 2 offsets x 2 planes), K7
# REPS (its offset r / 2 - 1 is new at every bundle, 2 planes); the bound
# is the larger; the K8/K9 bundle the same way (GATHER_FUNCTION).  The
# bank conflicts of a random index cost more cycles a gather (the first
# K7's REPS slope: 3.1), but they are a kernel's, not the card's floor.
# The joining adds of the chains are left out.  The first count took
# OPS_PER_REP float32 operations per repetition and element at 67 TFLOP/s
# (K5 "mod" 4, K6 and K7 "hermite_pair" 13; the bundle
# HERMITE_OPS_PER_POSITION a position), every repetition's index
# arithmetic and gathers as work; it is printed beside.  What the compiled
# kernels execute (kernels/sass.gather_loops, experiments.gather_work) is
# printed beside it as a diagnosis (floor_facts, walk_facts).
FLOAT_PER_CLOCK = 128
LDS_GATHERS_PER_CLOCK = 1     # warp-wide 4-byte gathers a clock an SM
GATHER_FUNCTION = {          # reps -> (float ops an element, distinct gathers)
    ("K5", "mod"): lambda reps: (reps, 4),
    ("K6", "hermite_pair"): lambda reps: (2 * reps, 4),
    ("K7", "hermite_pair"): lambda reps: (2 * reps, reps),
    # the bundle: units -> 2 positions x 4 multiply-adds a unit; K8 gathers
    # 5 offsets of 2 planes, K9 a new offset at every position
    ("K8", "gather"): lambda units: (8 * units, 10),
    ("K9", "gather"): lambda units: (8 * units, 4 * units),
}


def gather_bound(label, kernel, mod, variant, reps, clock_mhz) -> list:
    """The bound of ``variant`` of ``mod`` (K5, K6, K7, or the K8/K9
    bundle's ``gather``: ``kernel``) at ``reps`` repetitions (the bundle's
    UNITS) and the module's STEPS, counted from the function, for
    :func:`bound`; the first count printed beside it (the bundle's:
    HERMITE_OPS_PER_POSITION at each of a unit's two positions)."""
    from ogl_beamforming_tpu_torch.experiments import (
        HERMITE_OPS_PER_POSITION, LANE, ROWS, WARP)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_s = clock_mhz * 1e6 * sms            # SM cycles a second
    per_elem, distinct = GATHER_FUNCTION[(kernel, variant)](reps)
    elements = mod.STEPS * ROWS * LANE
    times = {"float": elements * per_elem / FLOAT_PER_CLOCK / per_s,
             "gathers": elements * distinct / WARP / LDS_GATHERS_PER_CLOCK
             / per_s}
    by = max(times, key=times.get)
    old = (gather_ops(mod.STEPS, reps, 2 * HERMITE_OPS_PER_POSITION)
           if variant == "gather" else
           gather_ops(mod.STEPS, reps, mod.OPS_PER_REP[variant]))
    print(f"[micro] {label} bound from the function at {clock_mhz:g} MHz x "
          f"{sms} SMs: {elements} elements x {per_elem} float adds or "
          f"multiply-adds and {distinct} distinct gathers -> "
          + ", ".join(f"{k} {t * 1e3:.5f} ms" for k, t in times.items())
          + f", set by {by}; the first count {old:.4g} float32 operations at "
          f"67 TFLOP/s {old / PEAK_F32_PER_S * 1e3:.5f} ms")
    return [(times[by], 1.0)]


def floor_facts(label, mod, variant, counts, smi_line) -> None:
    """What the compiled gather_floor_kernel instantiation of ``variant``
    (shared memory) is and executes at the module's REPS and STEPS: its
    registers, spills, resident blocks a SM and grid (the occupancy query),
    and per launch the warp instructions by kind, modelled from the SASS
    (its static counts times the loops' turns and the units and threads
    that run them, ``experiments.gather_work``; not an execution count);
    fails unless the model gives a launch the function's warp FADD (K5
    ``mod``: REPS an element) or FFMA (K6 ``hermite_pair``: 2 REPS an
    element)."""
    from ogl_beamforming_tpu_torch.experiments import (FLOOR_WARPS, LANE,
                                                       ROWS, WARP,
                                                       gather_grid,
                                                       gather_work)
    vid = mod.VARIANT_IDS[variant]
    tag = f"gather_floor_kernelILi{vid}ELb1E"
    regs = [v for k, v in BUILD_FACTS["usage"].items() if tag in k]
    c = counts.get((vid, True))
    check(len(regs) == 1 and c is not None and c["unit"] is not None,
          f"{label}: no single ptxas entry or no unit loop for {tag}")
    per_sm, grid = gather_grid(vid, True, mod.STEPS)
    check(per_sm >= 2, f"{label}: {per_sm} blocks a SM, want at least 2")
    work = gather_work(c, mod.REPS, mod.STEPS, grid)
    op, per_elem = ("FADD", 1) if variant == "mod" else ("FFMA", 2)
    want = mod.STEPS * ROWS * LANE * per_elem * mod.REPS // WARP
    check(work[op] >= want, f"{label}: a launch executes {work[op]} warp "
          f"{op} (modelled from the SASS), the function {want}")
    short = ("instructions", "LDS", "LDG", "FADD", "FFMA", "integer",
             "convert")
    print(f"[micro] {label} gather_floor_kernel<{vid}, shared> ({smi_line}): "
          f"{regs[0][0]} registers, {regs[0][1]} B spilled, {per_sm} blocks "
          f"of {FLOOR_WARPS} warps resident a SM, grid {grid} for "
          f"{mod.STEPS * ROWS} units; static SASS (kernels/sass.gather_loops)"
          f" loop body {dict((k, c['body'][k]) for k in short)} for "
          f"{c['step']} repetitions a turn, unit loop "
          f"{dict((k, c['unit'][k]) for k in short)}, outside "
          f"{dict((k, c['outside'][k]) for k in short)}; modelled from "
          f"them, a launch executes {work[op]} warp {op} (the function's "
          f"{want}), "
          f"{work['convert']} conversions, {work['instructions']} warp "
          "instructions")


def walk_facts(label, vid, count, steps, counts, smi_line) -> None:
    """What the compiled gather_walk_kernel instantiation ``vid`` (shared
    memory) is and executes at ``count`` (REPS, or the bundle's UNITS) and
    ``steps``: its registers, spills, resident blocks a SM and grid, the
    16-byte LDS of its turn loop, unit loop and tail, and per launch the
    warp instructions by kind, modelled from the SASS
    (``experiments.gather_work``; not an execution count); fails unless the
    model gives a launch exactly the function's warp FFMA, 8 a unit of the
    bundle (2 a repetition of K7 ``hermite_pair``) an element, and the
    walk's fix-up, 3 bundles of the quad where the kept range ends, a unit
    (none in K8's form): the masked bundles' products are computed too."""
    from ogl_beamforming_tpu_torch.experiments import (HERMITE_IDS, LANE,
                                                       ROWS, WALK_WARPS,
                                                       WARP, gather_grid,
                                                       gather_work,
                                                       walk_trips)
    tag = f"gather_walk_kernelILi{vid}ELb1E"
    regs = [v for k, v in BUILD_FACTS["usage"].items() if tag in k]
    c = counts.get((vid, True))
    check(len(regs) == 1 and c is not None and c["unit"] is not None,
          f"{label}: no single ptxas entry or no unit loop for {tag}")
    per_sm, grid = gather_grid(vid, True, steps)
    check(per_sm >= 1, f"{label}: {per_sm} blocks a SM")
    work = gather_work(c, count, steps, grid, vid)
    per_elem = 8 * count if vid in HERMITE_IDS.values() else 2 * count
    want = steps * ROWS * LANE * per_elem // WARP
    fixup = 0 if vid == HERMITE_IDS[True] else steps * 64 * 3 * 4
    check(work["FFMA"] == want + fixup, f"{label}: a launch executes "
          f"{work['FFMA']} warp FFMA (modelled from the SASS), the function "
          f"{want} and the fix-up {fixup}")
    short = ("instructions", "LDS", "LDS128", "FADD", "FFMA", "integer",
             "convert")
    tail = c["tail"] or {}
    print(f"[micro] {label} gather_walk_kernel<{vid}, shared> ({smi_line}): "
          f"{regs[0][0]} registers, {regs[0][1]} B spilled, {per_sm} blocks "
          f"of {WALK_WARPS} warps resident a SM, grid {grid} for "
          f"{steps * 64} units; walk turns and tail trips "
          f"{walk_trips(vid, count)}; static SASS (kernels/sass.gather_loops)"
          f" turn loop {dict((k, c['body'][k]) for k in short)}, tail "
          f"{dict((k, tail.get(k, 0)) for k in short)}, unit loop "
          f"{dict((k, c['unit'][k]) for k in short)}, outside "
          f"{dict((k, c['outside'][k]) for k in short)}; modelled from "
          f"them, a launch executes {work['FFMA']} warp FFMA (the "
          f"function's {want} and the fix-up's {fixup}), {work['LDS128']} "
          f"16-byte LDS, "
          f"{work['convert']} conversions, {work['instructions']} warp "
          "instructions")


def print_gather_launches(label, res) -> None:
    print(f"[micro] {label} (REPS 64, STEPS 512), per launch: kernel us "
          "from the trace / CUDA-event us with the enqueue -> cycles per "
          "warp gather from the kernel time: " + "; ".join(
              f"{k} {r['kernel_us']:.2f} / {r['us']:.2f} -> "
              f"{r['cycles_per_warp_gather']:.3f}" for k, r in res.items()))


def gather_trace(label, row, fn, smi_line, kernel) -> None:
    """The row's kernel time by the trace (kernels named ``kernel``),
    without the enqueue its CUDA-event time holds, and its bound share by
    it."""
    from ogl_beamforming_tpu_torch.experiments import traced_ms
    row["trace_ms"] = traced_ms(fn, kernel=kernel)
    print(f"[micro] {label} row ({smi_line}): events {row['ms']:.4f} ms "
          f"(IQR {row['iqr_ms']:.4f}), trace {row['trace_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} -> {row['bound_ms'] / row['trace_ms']:.1%} "
          "by the trace")


K5_REPS_SLOPE = (8, 64, 128)


def reps_slope(label, row, launch, smi_line) -> None:
    """``launch(reps)`` by the trace at each of K5_REPS_SLOPE, and the
    least-squares line through them: ms a repetition (the adds) and the
    intercept at no repetition (launch, staging, set-up, stores)."""
    from ogl_beamforming_tpu_torch.experiments import traced_ms
    ms = [traced_ms(lambda r=r: launch(r), kernel="gather_floor_kernel")
          for r in K5_REPS_SLOPE]
    slope, intercept = np.polyfit(np.asarray(K5_REPS_SLOPE, np.float64),
                                  np.asarray(ms, np.float64), 1)
    row["reps_slope_ms"], row["reps_intercept_ms"] = float(slope), \
        float(intercept)
    print(f"[micro] {label} by the trace at REPS {list(K5_REPS_SLOPE)} "
          f"({smi_line}): " + ", ".join(f"{t:.5f}" for t in ms)
          + f" ms -> slope {slope * 1e3:.4f} us a repetition, intercept "
          f"{intercept * 1e3:.4f} us; at REPS 64 the line gives "
          f"{(intercept + 64 * slope) * 1e3:.4f} us, the adds alone "
          f"{64 * slope * 1e3:.4f}")


def phase_micro_gather(dev, smi_line, counts,
                       clock_mhz) -> list[tuple[dict, int]]:
    """K5, K6, K7: every variant in both memory spaces against its plain
    version, the sweeps, and one row each (timed through the launcher, past
    the wrapper's index check, and by the trace); the bounds from the
    function at ``clock_mhz``, and for K5 and K6 what the compiled kernel
    executes (``counts``, kernels/sass.gather_loops) beside them; K5's REPS
    slope by the trace."""
    from ogl_beamforming_tpu_torch.experiments import (gather_micro,
                                                       gather_micro2,
                                                       gather_micro3,
                                                       launch_gather)
    out = []
    # K5
    x = gather_micro.make_inputs(dev)
    err = 0.0
    for v in gather_micro.VARIANTS:
        ref = gather_micro.kernel_ref(v, x["src"], x["idx"])
        for smem in (True, False):
            err = max(err, micro_compare(
                gather_micro.kernel(v, x["src"], x["idx"], smem=smem), ref,
                v in MICRO_ADD_ONLY, f"K5 {v} smem={smem}"))
    res = {}
    n = launches_of("micro_gather", lambda: res.update(
        {f"{v}/{'shared' if sm else 'global'}": gather_micro.measure(
            v, x, sm, iters=MICRO_ITERS)
         for v in gather_micro.VARIANTS for sm in (True, False)}))
    print_gather_launches("K5 gather_micro", res)
    k5 = lambda: launch_gather(  # noqa: E731
        gather_micro.VARIANT_IDS["mod"], x["src"], x["src"], x["idx"],
        x["src"], gather_micro.REPS, gather_micro.STEPS, True)
    ms, iqr = kernel_ms(k5)
    plain = median_ms(lambda: gather_micro.kernel_ref(
        "mod", x["src"], x["idx"], steps=gather_micro.STEPS), RUNS)
    row = kernel_row(
        "micro_gather_k5", "micro_gather.cu", "experiments/gather_micro.py:56",
        err, ms, plain, TILE_BYTES, gather_bound(
            "K5 mod, shared", "K5", gather_micro, "mod", gather_micro.REPS,
            clock_mhz), iqr=iqr)
    floor_facts("K5 mod", gather_micro, "mod", counts, smi_line)
    gather_trace("K5 mod, shared", row, k5, smi_line, "gather_floor_kernel")
    reps_slope("K5 mod, shared", row, lambda reps: launch_gather(
        gather_micro.VARIANT_IDS["mod"], x["src"], x["src"], x["idx"],
        x["src"], reps, gather_micro.STEPS, True), smi_line)
    out.append((row, n))

    # K6
    x = gather_micro2.make_inputs(dev)
    err = 0.0
    for v in gather_micro2.VARIANTS:
        src, src2 = x[v]
        ref = gather_micro2.kernel_ref(v, src, src2, x["idx"], x["w"])
        for smem in (True, False):
            err = max(err, micro_compare(gather_micro2.kernel(
                v, src, src2, x["idx"], x["w"], smem=smem), ref,
                v in MICRO_ADD_ONLY, f"K6 {v} smem={smem}"))
    res = {}
    n = launches_of("micro_gather", lambda: res.update(
        {f"{v}/{'shared' if sm else 'global'}": gather_micro2.measure(
            v, x, sm, iters=MICRO_ITERS)
         for v in gather_micro2.VARIANTS for sm in (True, False)}))
    print_gather_launches("K6 gather_micro2", res)
    src, src2 = x["hermite_pair"]
    k6 = lambda: launch_gather(  # noqa: E731
        gather_micro2.VARIANT_IDS["hermite_pair"], src, src2, x["idx"],
        x["w"], gather_micro2.REPS, gather_micro2.STEPS, True)
    ms, iqr = kernel_ms(k6)
    plain = median_ms(lambda: gather_micro2.kernel_ref(
        "hermite_pair", src, src2, x["idx"], x["w"],
        steps=gather_micro2.STEPS), RUNS)
    row = kernel_row(
        "micro_gather_k6", "micro_gather.cu",
        "experiments/gather_micro2.py:136", err, ms, plain, TILE_BYTES,
        gather_bound("K6 hermite_pair, shared", "K6", gather_micro2,
                     "hermite_pair", gather_micro2.REPS, clock_mhz), iqr=iqr)
    floor_facts("K6 hermite_pair", gather_micro2, "hermite_pair", counts,
                smi_line)
    gather_trace("K6 hermite_pair, shared", row, k6, smi_line,
                 "gather_floor_kernel")
    out.append((row, n))

    # K7: every variant at the largest REPS, then the slope sweep
    x = gather_micro3.make_inputs(dev)
    reps = gather_micro3.REPS_SWEEP[-1]
    err = 0.0
    for v in gather_micro3.VARIANTS:
        src, src2 = gather_micro3.sources(v, x)
        ref = gather_micro3.kernel_ref(v, src, src2, x["idx"], x["w"], reps)
        for smem in (True, False):
            err = max(err, micro_compare(gather_micro3.kernel(
                v, src, src2, x["idx"], x["w"], reps, smem=smem), ref,
                v in MICRO_ADD_ONLY, f"K7 {v} smem={smem}"))
    res = {}
    n = launches_of("micro_gather", lambda: res.update(
        {f"{v}/{'shared' if sm else 'global'}": gather_micro3.sweep(
            v, x, sm, iters=MICRO_ITERS)
         for v in gather_micro3.VARIANTS for sm in (True, False)}))
    for k, r in res.items():
        print(f"[micro] K7 gather_micro3 {k}: slope "
              f"{r['slope_us_per_rep']:.4f} us/rep -> "
              f"{r['cycles_per_warp_gather']:.3f} cycles per warp gather at "
              f"{r['sm_clock_mhz']:g} MHz "
              f"(REPS {list(gather_micro3.REPS_SWEEP)}: "
              f"{', '.join(f'{t:.1f}' for t in r['us'])} us)")
    src, src2 = gather_micro3.sources("hermite_pair", x)
    k7 = lambda: launch_gather(  # noqa: E731
        gather_micro3.VARIANT_IDS["hermite_pair"], src, src2, x["idx"],
        x["w"], reps, gather_micro3.STEPS, True)
    ms, iqr = kernel_ms(k7)
    plain = median_ms(lambda: gather_micro3.kernel_ref(
        "hermite_pair", src, src2, x["idx"], x["w"], reps,
        steps=gather_micro3.STEPS), RUNS)
    row = kernel_row(
        "micro_gather_k7", "micro_gather.cu",
        "experiments/gather_micro3.py:105", err, ms, plain, TILE_BYTES,
        gather_bound(f"K7 hermite_pair, shared, REPS {reps}", "K7",
                     gather_micro3, "hermite_pair", reps, clock_mhz),
        iqr=iqr)
    walk_facts(f"K7 hermite_pair, REPS {reps}",
               gather_micro3.VARIANT_IDS["hermite_pair"], reps,
               gather_micro3.STEPS, counts, smi_line)
    gather_trace(f"K7 hermite_pair, shared, REPS {reps}", row, k7, smi_line,
                 "gather_walk_kernel")
    out.append((row, n))
    return out


# The one-hot kernel (csrc/micro_onehot.cu): wgmma m64nBk16, so 2 x 64 x B
# x 16 operations an instruction, issued by each of a block's two
# warpgroups running the same unit loop.
ONEHOT_MMA_M, ONEHOT_MMA_K, ONEHOT_WARPGROUPS = 64, 16, 2


def onehot_facts(batch: int) -> str:
    """Registers, spills and the static SASS of the unit loop (phase 2) of
    ``onehot_kernel<batch>``; fails unless the loop holds exactly the
    tensor-core instructions of one dense 128-deep product per unit:
    2 B 128^2 per unit and block over the instruction's operations and the
    warpgroups that issue the loop."""
    from ogl_beamforming_tpu_torch.experiments import onehot_product_ops
    from ogl_beamforming_tpu_torch.kernels import sass
    regs = [v for k, v in BUILD_FACTS["usage"].items()
            if f"onehot_kernelILi{batch}E" in k]
    loop = BUILD_FACTS["onehot"].get(batch)
    check(len(regs) == 1 and loop is not None,
          f"no ptxas entry or unit loop for onehot_kernel<{batch}>")
    want = (onehot_product_ops(batch, 1, 1)
            / (2 * ONEHOT_MMA_M * batch * ONEHOT_MMA_K) / ONEHOT_WARPGROUPS)
    check(loop["HGMMA"] + loop["HMMA"] == want,
          f"onehot_kernel<{batch}>: {loop['HGMMA']} HGMMA + {loop['HMMA']} "
          f"HMMA in the unit loop, want {want:g}")
    return (f"B = {batch}: {regs[0][0]} registers, {regs[0][1]} B spilled; "
            f"unit loop {loop['instructions']} instructions ("
            + ", ".join(f"{op} {loop[op]}" for op in sass.ONEHOT_OPS)
            + f"; {want:g} tensor-core instructions wanted)")


def phase_micro_onehot(dev, smi_line, counts,
                       clock_mhz) -> list[tuple[dict, int]]:
    """K8, K9: the gather bundle and the one-hot product against their
    plain versions (one-hot at every B), the sweeps, K9's slope fit; a
    bundle row each (shared memory, by events and by the trace, its bound
    from the function at ``clock_mhz``, what the compiled walk kernel
    executes from ``counts``); and a one-hot row each: B = 128 by events
    (with the IQR) and by the trace, every B beside it, the recounted
    bound, the product alone as one bf16 ``torch.matmul``, and the
    kernel's registers and unit-loop SASS."""
    from ogl_beamforming_tpu_torch.experiments import (
        HERMITE_IDS, ONEHOT_BATCHES, check_gather_args,
        launch_gather_hermite, launch_onehot, onehot_band_writes,
        onehot_library_operands, onehot_micro, onehot_micro2,
        onehot_product_ops, traced_ms)
    from ogl_beamforming_tpu_torch.kernels import build
    print(f"[micro] onehot_kernel build ({smi_line}): "
          + "; ".join(onehot_facts(b) for b in ONEHOT_BATCHES))
    out = []
    for mod, label, units, replaces, g_replaces in (
            (onehot_micro, "K8", onehot_micro.UNITS,
             "experiments/onehot_micro.py:86",
             "experiments/onehot_micro.py:108"),
            (onehot_micro2, "K9", onehot_micro2.UNITS_SWEEP[-1],
             "experiments/onehot_micro2.py:98",
             "experiments/onehot_micro2.py:70")):
        x = onehot_micro.make_inputs(dev)
        g = (x["src"], x["src2"], x["idx"], x["w"])
        ref = mod.gather_kernel_ref(*g, units=units)
        g_err = 0.0
        for smem in (True, False):
            g_err = max(g_err, micro_compare(
                mod.gather_kernel(*g, units=units, smem=smem), ref, False,
                f"{label} gather_hermite smem={smem}"))
        err = 0.0
        for b in ONEHOT_BATCHES:
            o = (x[f"rf{b}"], x["kvox"], x["wt4"])
            err = max(err, micro_compare(
                mod.onehot_kernel(*o, units=units),
                mod.onehot_kernel_ref(*o, units=units), False,
                f"{label} onehot B={b}"))
        res = {}
        if mod is onehot_micro:
            with contextlib.redirect_stdout(io.StringIO()):
                n = launches_of("micro_onehot", lambda: res.update(
                    onehot_micro.measure(x, iters=MICRO_ITERS)))
        else:
            def run():
                for smem in (True, False):
                    res[f"gather_hermite/{'shared' if smem else 'global'}"] \
                        = onehot_micro2.sweep_gather(x, smem,
                                                     iters=MICRO_ITERS)
                for b in ONEHOT_BATCHES:
                    res[f"onehot_mxu_B{b}"] = onehot_micro2.sweep_onehot(
                        x, b, iters=MICRO_ITERS)
            n = launches_of("micro_onehot", run)
        n_gather = build.LAUNCHES["micro_gather"]   # the bundle in that sweep
        for k, r in res.items():
            ns = {kk: v for kk, v in r.items() if kk.startswith("ns_")}
            us = np.round(np.atleast_1d(r["us"]), 1).tolist()
            print(f"[micro] {label} {mod.__name__.rsplit('.', 1)[1]} {k}: "
                  + ", ".join(f"{kk} {v:.4f}" for kk, v in ns.items())
                  + f" (us {us})")
        if mod is onehot_micro2:
            print(f"[micro] K9 slope fit ({smi_line}), time over UNITS "
                  f"{list(onehot_micro2.UNITS_SWEEP)} at STEPS "
                  f"{onehot_micro2.STEPS}: " + "; ".join(
                      f"{k} {r['unit_ns']:.3f} ns a unit of all blocks -> "
                      f"{r['ns_per_voxelrow_frame']:.4f} ns per voxel-row-"
                      f"frame" for k, r in res.items()))
        bound_ms = {}
        per_b = {}
        for b in ONEHOT_BATCHES:
            o = (x[f"rf{b}"], x["kvox"], x["wt4"])
            fn = lambda o=o: launch_onehot(  # noqa: E731
                *o, units, mod.K8_FORM, mod.STEPS)
            b_ms, b_iqr = kernel_ms(fn)
            per_b[str(b)] = {"ms": b_ms, "iqr_ms": b_iqr,
                             "trace_ms": traced_ms(fn, kernel="onehot_kernel")}
            bound_ms[b] = bound((b * 128 * 2 + 16 * 128) * 4, [
                (onehot_product_ops(b, units, mod.STEPS), PEAK_BF16_PER_S),
                (onehot_band_writes(units, mod.STEPS), PEAK_F32_PER_S)])[0]
        print(f"[micro] {label} one-hot, UNITS {units}, STEPS {mod.STEPS} "
              f"({smi_line}): " + "; ".join(
                  f"B = {b} events {r['ms']:.4f} ms (IQR {r['iqr_ms']:.4f}), "
                  f"trace {r['trace_ms']:.4f} ms, bound {bound_ms[int(b)]:.4f}"
                  f" -> {bound_ms[int(b)] / r['trace_ms']:.1%} by the trace"
                  for b, r in per_b.items()))
        o = (x["rf128"], x["kvox"], x["wt4"])
        plain_out = mod.onehot_kernel_ref(*o, units=units)
        plain = median_ms(lambda: mod.onehot_kernel_ref(
            *o, units=units, steps=mod.STEPS), RUNS)
        a, w = onehot_library_operands(*o, units, mod.K8_FORM, mod.STEPS)
        lib_fn = lambda: torch.matmul(a, w)  # noqa: E731
        lib_err = nrmse(plain_out.cpu().numpy(),
                        lib_fn()[:128].float().cpu().numpy())
        check(lib_err <= 1e-2, f"{label} torch.matmul yardstick: NRMSE "
              f"{lib_err:.3e} > 1e-2 (bf16 output)")
        lib = median_ms(lib_fn)
        lib_trace = traced_ms(lib_fn)
        print(f"[micro] {label} the products alone, bf16 torch.matmul "
              f"({tuple(a.shape)} @ {tuple(w.shape)}, W built outside the "
              f"timing; NRMSE {lib_err:.2e} with its bf16 output; "
              f"{smi_line}): {lib:.4f} ms by events, {lib_trace:.4f} by the "
              "trace")
        del a, w
        check_gather_args(*g, True)
        g_fn = lambda: launch_gather_hermite(  # noqa: E731
            mod.K8_FORM, *g, units, mod.STEPS, True)
        g_ms, g_iqr = kernel_ms(g_fn)
        g_plain = median_ms(lambda: mod.gather_kernel_ref(
            *g, units=units, steps=mod.STEPS), RUNS)
        g_label = f"{label} gather bundle, shared, UNITS {units}"
        g_row = kernel_row(
            f"micro_gather_{label.lower()}", "micro_gather.cu", g_replaces,
            g_err, g_ms, g_plain, TILE_BYTES, gather_bound(
                g_label, label, mod, "gather", units, clock_mhz), iqr=g_iqr)
        walk_facts(f"{label} gather bundle, UNITS {units}",
                   HERMITE_IDS[mod.K8_FORM], units, mod.STEPS, counts,
                   smi_line)
        gather_trace(g_label, g_row, g_fn, smi_line, "gather_walk_kernel")
        out.append((g_row, n_gather))
        row = kernel_row(
            f"micro_onehot_{label.lower()}", "micro_onehot.cu", replaces,
            err, per_b["128"]["ms"], plain, (128 * 128 * 2 + 16 * 128) * 4,
            [(onehot_product_ops(128, units, mod.STEPS), PEAK_BF16_PER_S),
             (onehot_band_writes(units, mod.STEPS), PEAK_F32_PER_S)],
            lib, iqr=per_b["128"]["iqr_ms"])
        row.update(trace_ms=per_b["128"]["trace_ms"], onehot_ms=per_b,
                   library="bf16 torch.matmul: the products alone",
                   library_trace_ms=lib_trace)
        out.append((row, n))
    return out


def i8_facts(*keys) -> str:
    """Registers, spills and static SASS counts (phase 2) of the int8
    skeleton's instantiations ``keys`` (kernels/sass.py ``i8_key``)."""
    from ogl_beamforming_tpu_torch.kernels import sass
    regs = {sass.i8_key(k): v for k, v in BUILD_FACTS["usage"].items()
            if sass.i8_key(k)}
    facts = []
    for key in keys:
        check(key in regs and key in BUILD_FACTS["i8"],
              f"no ptxas or SASS entry for {key}")
        c = BUILD_FACTS["i8"][key]
        facts.append(f"{key}: {regs[key][0]} registers, {regs[key][1]} B "
                     f"spilled, {c['instructions']} SASS instructions ("
                     + ", ".join(f"{op} {c[op]}" for op in sass.I8_OPS) + ")")
    return "; ".join(facts)


def phase_micro_i8(dev, smi_line) -> list[tuple[dict, int]]:
    """K10 and K11: exact against the plain versions and the exact product;
    K10 timed with the enqueue (single calls), back to back and by the
    trace beside torch._int_mm, with the host's share of
    a call; K11 ``full`` and ``dot`` at the decode's width beside the decode
    kernel (K2) and the cuBLAS f32 product, the same ways; the registers and
    static SASS of the instantiations timed."""
    from ogl_beamforming_tpu_torch.experiments import (call_times, launch_ms,
                                                       probe_i8, probe_i8b,
                                                       traced_ms)
    from ogl_beamforming_tpu_torch.ops import decode
    out = []
    x = probe_i8.make_inputs(dev)
    a8, b8 = x["a"], x["b"]
    exact = (a8.to(torch.float64) @ b8.to(torch.float64)).cpu()
    for name, od in probe_i8.BODIES.items():
        k = probe_i8.kernel2(a8, b8, od)
        micro_compare(k, probe_i8.kernel2_ref(a8, b8, od), True, f"K10 {name}")
        check(torch.equal(k.cpu().to(torch.float64), exact),
              f"K10 {name} != the exact product")
    n = launches_of("micro_i8", lambda: [
        probe_i8.kernel2(a8, b8, od) for od in probe_i8.BODIES.values()])
    k10 = lambda: probe_i8.kernel2(a8, b8)  # noqa: E731
    int_mm = lambda: torch._int_mm(a8, b8)  # noqa: E731
    check(torch.equal(int_mm(), k10()), "K10 != torch._int_mm")
    # single calls of the two in turns: with the enqueue, the host's time
    # is most of either, and the host drifts
    single = call_times({"K10": k10, "_int_mm": int_mm}, 2 * TIMED_RUNS + 1)
    q1, ms, q3 = statistics.quantiles(single["K10"], n=4)
    iqr = q3 - q1
    lib = statistics.median(single["_int_mm"])
    plain = median_ms(lambda: probe_i8.kernel2_ref(a8, b8), RUNS)
    times = {label: (launch_ms(fn), traced_ms(fn))
             for label, fn in (("K10", k10), ("_int_mm", int_mm))}
    host = probe_i8.host_breakdown(x)
    print(f"[micro] K10 probe_i8 int8 (128, 128) @ (128, 256), {smi_line}: "
          f"int32 and float32 bodies equal to the exact product; single "
          f"call {ms * 1e3:.2f} us (IQR {iqr * 1e3:.2f}; in turns with "
          f"torch._int_mm), 20 back to back "
          f"{times['K10'][0] * 1e3:.2f} us, trace {times['K10'][1] * 1e3:.2f}"
          f" us; torch._int_mm single call {lib * 1e3:.2f} us, back to back "
          f"{times['_int_mm'][0] * 1e3:.2f} us, trace "
          f"{times['_int_mm'][1] * 1e3:.2f} us; plain {plain * 1e3:.2f} us")
    print(f"[micro] K10 host us per call, enqueue only ({smi_line}): "
          + "; ".join(f"{k} {v:.2f}" for k, v in host.items()))
    print(f"[micro] K10 build ({smi_line}): " + i8_facts(
        "i8_mma_kernel k4 b2 wn1 wm4 rows64", "i8_mma_kernel k4 b3 wn1 wm4 rows64"))
    row = kernel_row(
        "micro_i8_k10", "micro_i8.cu", "experiments/probe_i8.py:26", 0.0, ms,
        plain, 128 * 128 + 128 * 256 + 128 * 256 * 4,
        [(2.0 * 128 * 128 * 256, PEAK_INT8_PER_S)], lib, iqr=iqr)
    row.update(launch_ms=times["K10"][0], trace_ms=times["K10"][1],
               library_launch_ms=times["_int_mm"][0],
               library_trace_ms=times["_int_mm"][1])
    out.append((row, n))

    x = probe_i8b.make_inputs(dev)
    for body in probe_i8b.BODIES:
        micro_compare(probe_i8b.k(body, x["h"], x["x"]),
                      probe_i8b.k_ref(body, x["h"], x["x"]), True,
                      f"K11 {body}")
    check(np.array_equal(
        probe_i8b.k("full", x["h"], x["x"]).cpu().numpy().astype(np.float64),
        probe_i8b.full_exact(x["h"], x["x"])), "K11 full != H @ X / 16")
    a, bs = probe_i8b.DECODE_A, probe_i8b.DECODE_BS
    w = probe_i8b.make_inputs(dev, a, bs)
    full = probe_i8b.k("full", w["h"], w["x"])
    micro_compare(full, probe_i8b.k_ref("full", w["h"], w["x"]), True,
                  "K11 full at the decode width")
    # float64 products of these integers are exact (|sum| < 2^53)
    exact = torch.matmul(w["h"].to(torch.float64), w["x"].to(torch.float64))
    check(torch.equal(full.to(torch.float64), exact / 16.0),
          "K11 full at the decode width != H @ X / 16")
    del exact, full
    micro_compare(probe_i8b.k("dot", w["h"], w["x"]),
                  probe_i8b.k_ref("dot", w["h"], w["x"]), True,
                  "K11 dot at the decode width")
    full_fn = lambda: probe_i8b.k("full", w["h"], w["x"])  # noqa: E731
    dot_fn = lambda: probe_i8b.k("dot", w["h"], w["x"])  # noqa: E731
    n = launches_of("micro_i8", lambda: launch_ms(full_fn, iters=MICRO_ITERS))
    ms, iqr = kernel_ms(full_fn)
    dot_ms, dot_iqr = kernel_ms(dot_fn)
    plain = median_ms(lambda: probe_i8b.k_ref("full", w["h"], w["x"]), RUNS)
    h32, x32 = w["h"].to(torch.float32), w["x"].to(torch.float32)
    cublas = lambda: torch.matmul(h32, x32)  # noqa: E731
    lib = median_ms(cublas)
    rf = w["x"].reshape(a, 128, bs // 128).transpose(0, 1).contiguous()
    hd = decode.hadamard_matrix(a, device=dev)
    k2 = lambda: decode.decode_hadamard_cuda(rf, hd)  # noqa: E731
    k2_ms, k2_iqr = kernel_ms(k2)
    traces = {label: traced_ms(fn) for label, fn in (
        ("full", full_fn), ("dot", dot_fn), ("cuBLAS", cublas), ("K2", k2))}
    del x32
    print(f"[micro] K11 probe_i8b ({smi_line}): five bodies bit-equal at "
          f"(16, 256), full = H @ X / 16 exactly; at the decode width ({a}, "
          f"{bs}) full bit-equal to the plain version and the exact product, "
          f"dot to its plain version; full {ms:.3f} ms (IQR {iqr:.3f}), "
          f"trace {traces['full']:.3f}; dot {dot_ms:.3f} ms (IQR "
          f"{dot_iqr:.3f}), trace {traces['dot']:.3f}; plain {plain:.3f} ms;"
          f" cuBLAS f32 matmul {lib:.3f} ms, trace {traces['cuBLAS']:.3f}; "
          f"decode kernel K2 at (128, 128, 4096) {k2_ms:.3f} ms (IQR "
          f"{k2_iqr:.3f}), trace {traces['K2']:.3f}")
    print(f"[micro] K11 build ({smi_line}): " + i8_facts(
        "i8_mma_kernel k4 b0 wn8 wm1 rows0", "i8_mma_kernel k4 b1 wn8 wm1 rows0",
        "decode_i8_kernel k4"))
    row = kernel_row(
        "micro_i8_k11", "micro_i8.cu", "experiments/probe_i8b.py:15", 0.0,
        ms, plain, a * a + a * bs * 2 + a * bs * 4,
        [(2.0 * 2 * a * a * bs, PEAK_INT8_PER_S)], lib, iqr=iqr)
    row.update(trace_ms=traces["full"], library_trace_ms=traces["cuBLAS"],
               dot_ms=dot_ms, dot_trace_ms=traces["dot"])
    out.append((row, n))
    return out


def phase_micro(dev, smi_line) -> list[dict]:
    """Phase 6; returns the rows with their sweeps' launch counts."""
    from ogl_beamforming_tpu_torch.experiments import (HERMITE_IDS,
                                                       gather_micro,
                                                       gather_micro2,
                                                       gather_micro3,
                                                       max_sm_clock_mhz,
                                                       sass_loads,
                                                       sm_clock_mhz)
    from ogl_beamforming_tpu_torch.kernels import build, sass
    t0 = time.perf_counter()
    names = {i: f"{'K8' if k8 else 'K9'} gather"
             for k8, i in HERMITE_IDS.items()}
    for label, mod in (("K5", gather_micro), ("K6", gather_micro2),
                       ("K7", gather_micro3)):
        names.update({i: f"{label} {v}" for v, i in mod.VARIANT_IDS.items()})
    loads = sass_loads(build.library_path())
    print("[micro] static loads in the compiled gather kernels (cuobjdump "
          "-sass; LDS (of them 16-byte) / LDG in the whole function): "
          + "; ".join(f"{names.get(k, k)} {'shared' if sm else 'global'} "
                      f"{n_lds} ({n_wide})/{n_ldg}"
                      for (k, sm), (n_lds, n_wide, n_ldg) in sorted(
                          loads.items())))
    clock = sm_clock_mhz()
    counts = sass.gather_loops(sass.dump(build.library_path()))
    peak_clock = max_sm_clock_mhz()
    rows = (phase_micro_gather(dev, smi_line, counts, peak_clock)
            + phase_micro_onehot(dev, smi_line, counts, peak_clock)
            + phase_micro_i8(dev, smi_line))
    for row, n in rows:
        row["launches"] = n
    print(f"[micro] {smi_line}; SM clock {clock:g} MHz before the sweeps "
          f"(idle), {sm_clock_mhz():g} MHz after; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return [row for row, _ in rows]


# ---------------------------------------------------------------------------
# Phase 7: traced frames.  torch.profiler over one Quickstart frame and one
# path E batch through Beamformer: kernel time by name and the device busy
# share of the window; profile_device_stages of the Quickstart.

def print_profile(label, prof, host_ms) -> None:
    top = "; ".join(f"{name[:60]} {s * 1e3:.3f}"
                    for name, s in prof.top_ops[:6])
    print(f"[trace] {label}: {prof.kernel_count} kernels, kernel time "
          f"{prof.module_seconds * 1e3:.3f} ms, copies "
          f"{prof.copy_seconds * 1e3:.3f} ms, traced window "
          f"{prof.window_seconds * 1e3:.3f} ms -> busy share "
          f"{prof.busy_share:.4f}; untraced host clock {host_ms:.3f} ms -> "
          f"kernel share {prof.module_seconds * 1e3 / host_ms:.4f}")
    print(f"[trace] {label} kernel ms by name: {top}")


def host_ms(fn, runs=RUNS) -> float:
    """Median host clock of ``fn`` over ``runs`` calls, each synchronised."""
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def stage_times(label, bf, rf, caught) -> list:
    """``Beamformer.profile_device_stages`` of ``rf``: every stage must take
    device time.  A trace that lost a launched kernel's event is taken
    again (up to ``TRACE_ATTEMPTS``; roadmap C2); when a stage still comes
    out 0, the failure names each lost kernel with its line from the
    ``LostKernelEvents`` warnings in ``caught``."""
    from ogl_beamforming_tpu_torch.utils.profiling import (TRACE_ATTEMPTS,
                                                           LostKernelEvents)
    first = len(caught)
    stages = bf.profile_device_stages(rf)
    lost = [str(w.message) for w in caught[first:]
            if issubclass(w.category, LostKernelEvents)]
    check(all(t > 0 for _, t in stages),
          f"{label} profile_device_stages: "
          + ", ".join(f"{k.name} {t * 1e3:.4f} ms" for k, t in stages)
          + f"; {len(lost)} of at most {TRACE_ATTEMPTS} traces lost a "
          f"launched kernel's event" + (": " + "; ".join(lost) if lost
                                        else ""))
    if lost:
        print(f"[trace] {label} profile_device_stages: {len(lost)} traces "
              f"lost a launched kernel's event and were taken again")
    return stages


def phase_trace(dev, caught) -> None:
    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.utils.profiling import device_time

    rng = np.random.default_rng(77)
    c, a, s = 128, 128, 4096
    params, pipe = presets.forces_compounding(
        channel_count=c, transmit_count=a, sample_count=s, demodulate=False)
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    raw = rng.integers(-2048, 2048, (c, a * s), dtype=np.int16)
    frame = lambda r: bf.push_data_with_compute(r).data  # noqa: E731
    prof = device_time(frame, raw)
    print_profile("Quickstart frame (push_data_with_compute)", prof,
                  host_ms(lambda: frame(raw)))
    stages = stage_times("Quickstart", bf, raw.reshape(c, a, s), caught)
    print("[trace] Quickstart profile_device_stages: " + ", ".join(
        f"{k.name} {t * 1e3:.3f} ms" for k, t in stages))

    # path B's stages by CUDA events (as phase 5 times them) beside the
    # kernels the trace puts in each: the difference is the card idle
    # inside a stage while the host enqueues it
    params, pipe, filters = path_b()
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind, filters)
    raw = rng.integers(-2048, 2048, (c, a * s), dtype=np.int16)
    bf.warmup()
    for _ in range(RUNS):
        bf.push_data_with_compute(raw)
    _, split = stage_split(bf, 1, RUNS)
    stages = stage_times("path B", bf, raw.reshape(c, a, s), caught)
    print(f"[trace] path B stages by CUDA events {split} ms; "
          "profile_device_stages (kernels by the trace): " + ", ".join(
              f"{k.name} {t * 1e3:.4f} ms" for k, t in stages))

    params, pipe = presets.plane_wave_2d(data_kind=DataKind.Float32Complex)
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    raw = rng.standard_normal((FRAME_BATCH, params.channel_count,
                               2 * params.sample_count)).astype(np.float32)
    batch = lambda r: tuple(f.data for f in bf.push_batch(r))  # noqa: E731
    prof = device_time(batch, raw)
    print_profile(f"path E batch of {FRAME_BATCH} (push_batch)", prof,
                  host_ms(lambda: batch(raw)))


# ---------------------------------------------------------------------------
# Phase 8: streaming.  The Quickstart and paths A and B through
# runtime/streaming.StreamingSession on Beamformer(device="cuda"): a pinned
# host ring, uploads on a side stream into a device ring, the channel
# mapping on the device, compute on the default stream.

STREAM_FRAMES = 20    # streamed frames per path, counted and timed
STREAM_VARIANTS = 4   # distinct raw frames, submitted in turn
STREAM_BURST = 6      # Quickstart frames in the traced burst
STREAM_TIMEOUT = 300  # seconds for a drain or a handle


def stream_variants(raw) -> list:
    """STREAM_VARIANTS raw frames with ``raw``'s target: the sign alternates
    and variant k zeroes raw channel k, so a frame read from another slot of
    a ring of 1-3 does not equal its own synchronous frame."""
    out = []
    for k in range(STREAM_VARIANTS):
        v = raw.copy() if k % 2 == 0 else -raw
        v[k] = 0
        out.append(v)
    return out


def frame_ms(bf, first: int, count: int) -> list:
    """Device ms of stats rows ``first`` .. ``first + count`` (frame
    indices; the table keeps the newest STATS_FRAME_WINDOW)."""
    from ogl_beamforming_tpu_torch.params.constants import STATS_FRAME_WINDOW
    stages = len(bf._blocks[0]._plan.descriptor.stages)
    times = bf.compute_timings().times
    rows = [times[i % STATS_FRAME_WINDOW, :stages] for i in
            range(first, first + count)]
    check(count <= STATS_FRAME_WINDOW and all((r > 0).all() for r in rows),
          f"stats rows {first}..{first + count} lack stage times")
    return [float(r.sum()) * 1e3 for r in rows]


def stream_path(label, dev, params, pipe, raw, target_voxel, kernels,
                filters=(), trace=False) -> float:
    """The synchronous frames of the STREAM_VARIANTS raw frames (the
    references) and RUNS timed ones, then a warm-up through a
    StreamingSession and STREAM_FRAMES streamed frames with the launch
    counts set to 0 just before and read just after: each kernel once per
    frame, one new stats row per frame, each frame equal to the
    synchronous frame of its raw frame (NRMSE 1e-6; prints whether bit for
    bit) with its peak within one voxel of the target.  ``trace``: a traced
    burst of STREAM_BURST frames, whose copies must overlap kernels.
    Returns the streamed ms/frame."""
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    from ogl_beamforming_tpu_torch.utils.profiling import device_time

    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind, filters)
    variants = stream_variants(raw)
    bf.warmup()
    refs = [bf.push_data_with_compute(v).data.clone() for v in variants]
    torch.cuda.synchronize()
    first = bf.stats._frame_index
    wall = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        bf.push_data_with_compute(raw)
        wall.append((time.perf_counter() - t0) * 1e3)
    sync_dev = statistics.median(frame_ms(bf, first, RUNS))

    with StreamingSession(bf) as stream:
        for v in variants:                    # the rings' first allocation
            stream.submit(v)
        stream.drain(timeout=STREAM_TIMEOUT)
        build.LAUNCHES.clear()
        first = bf.stats._frame_index
        t0 = time.perf_counter()
        handles = [stream.submit(variants[i % STREAM_VARIANTS])
                   for i in range(STREAM_FRAMES)]
        stream.drain(timeout=STREAM_TIMEOUT)
        streamed = (time.perf_counter() - t0) * 1e3 / STREAM_FRAMES
        launches = {k: build.LAUNCHES[k] for k in kernels}
        rows = bf.stats._frame_index - first
        check(all(n == STREAM_FRAMES for n in launches.values()),
              f"{label}: kernel launch counts {launches} != "
              f"{STREAM_FRAMES} streamed frames")
        check(rows == STREAM_FRAMES, f"{label}: {rows} new stats rows, "
              f"expected {STREAM_FRAMES}")
        stream_dev = statistics.median(frame_ms(bf, first, STREAM_FRAMES))

        shape = grid_shape(params)
        worst, exact = 0.0, 0
        for i, h in enumerate(handles):
            frame = h.result(timeout=STREAM_TIMEOUT)
            ref = refs[i % STREAM_VARIANTS]
            check(tuple(frame.data.shape) == shape,
                  f"{label}: streamed frame {i} shape "
                  f"{tuple(frame.data.shape)} != {shape}")
            exact += bool(torch.equal(frame.data, ref))
            img = frame.to_numpy()
            worst = max(worst, nrmse(ref.cpu().numpy(), img))
            peak_check(f"{label} streamed frame {i}", img, target_voxel)
        check(worst <= 1e-6, f"{label}: streamed frame vs "
              f"push_data_with_compute NRMSE {worst:.3e} > 1e-6")
        print(f"[stream {label}] {STREAM_FRAMES} frames, depth "
              f"{stream.depth}: launches {launches}; {rows} new stats rows; "
              f"each frame vs push_data_with_compute of its raw frame: "
              f"{exact} of {STREAM_FRAMES} bit for bit, NRMSE <= "
              f"{worst:.3e}; peaks within one voxel of {target_voxel}")
        print(f"[stream {label}] streamed {streamed:.3f} ms/frame (host "
              f"clock, first submit to drain / {STREAM_FRAMES}); synchronous "
              f"end to end {statistics.median(wall):.3f} ms/frame (median "
              f"host clock); device ms/frame {sync_dev:.3f} synchronous, "
              f"{stream_dev:.3f} streamed (median CUDA events)")

        # the candidate bounds by themselves: the host copy of the raw
        # frame into a pinned slot and that slot's upload
        src = torch.from_numpy(raw)
        slot = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf = torch.empty(src.shape, dtype=src.dtype, device=dev)
        pin = host_ms(lambda: slot.copy_(src))
        up = median_ms(lambda: buf.copy_(slot, non_blocking=True), RUNS)
        print(f"[stream {label}] parts alone: host copy of the "
              f"{src.numel() * src.element_size() / 1e6:.1f} MB raw frame "
              f"into a pinned slot {pin:.3f} ms (median host clock, "
              f"{torch.get_num_threads()} threads), its upload {up:.3f} ms "
              f"(median CUDA events)")

        if trace:
            def burst():
                hs = [stream.submit(variants[i % STREAM_VARIANTS])
                      for i in range(STREAM_BURST)]
                stream.drain(timeout=STREAM_TIMEOUT)
                return hs[-1].result(timeout=STREAM_TIMEOUT).data

            prof = device_time(burst)
            overlap = prof.copy_overlap_seconds * 1e3
            print(f"[stream {label}] traced burst of {STREAM_BURST} frames: "
                  f"{prof.kernel_count} kernels, kernel time "
                  f"{prof.module_seconds * 1e3:.3f} ms, copies "
                  f"{prof.copy_seconds * 1e3:.3f} ms ({len(prof.copy_spans)}"
                  f"), traced window {prof.window_seconds * 1e3:.3f} ms -> "
                  f"busy share {prof.busy_share:.4f}; copy under a kernel "
                  f"{overlap:.3f} ms")
            check(overlap > 0, f"{label}: no copy overlapped a kernel in "
                  f"the traced burst")
    return streamed


def phase_stream(dev, smi_line) -> float:
    """Phase 8; returns the Quickstart's streamed ms/frame."""
    params, pipe, filters = path_b()
    raw, voxel = path_b_frame()
    print(f"[stream] {smi_line}")
    params_a, pipe_a, raw_a, voxel_a = plane_wave()
    stream_path("path A", dev, params_a, pipe_a, raw_a, voxel_a,
                ("das_rca",))
    stream_path("path B", dev, params, pipe, raw, voxel,
                ("demodulate", "decode_hadamard", "das_forces"),
                filters=filters)
    params, pipe, raw, voxel = quickstart()
    return stream_path("Quickstart", dev, params, pipe, raw, voxel,
                       ("decode_hadamard", "das_forces"), trace=True)


# ---------------------------------------------------------------------------
# Phase 9: the Quickstart served through the runtime bridge: a
# BeamformerServer on the card (runtime/server.py) on a shared-memory region
# of its own, driven through the port's native library (runtime/abi.py) by
# a client in this process, as an external C or MATLAB program drives it,
# and by a compiled C client in a subprocess.

SERVE_FRAMES = 20               # served frames, counted and timed
SERVE_SHM_BYTES = 256 << 20     # the 134.2 MB raw frame, then 20 exports
SERVE_TIMEOUT_MS = 120_000      # the client library's timeout a call
C_CLIENT = r"""
#include "ogl_beamformer_lib.h"
#include <stdio.h>
#include <stdlib.h>

/* argv: simple parameters (the struct's bytes), raw frame, output file */
static void *slurp(const char *path, size_t *size) {
    FILE *f = fopen(path, "rb");
    if (!f) return 0;
    fseek(f, 0, SEEK_END);
    *size = (size_t)ftell(f);
    fseek(f, 0, SEEK_SET);
    void *p = malloc(*size);
    if (p && fread(p, 1, *size, f) != *size) { free(p); p = 0; }
    fclose(f);
    return p;
}

int main(int argc, char **argv) {
    if (argc != 4 || beamformer_get_api_version() != 34) return 2;
    size_t n_sp = 0, n_raw = 0;
    BeamformerSimpleParameters *sp = slurp(argv[1], &n_sp);
    void *raw = slurp(argv[2], &n_raw);
    if (!sp || !raw || n_sp != sizeof *sp) return 3;
    size_t points = 1;
    for (int i = 0; i < 3; i++)
        if (sp->parameters.output_points[i] > 1)
            points *= (size_t)sp->parameters.output_points[i];
    float *out = calloc(2 * points, sizeof(float));   /* complex at most */
    if (!beamformer_beamform_data(sp, raw, (uint32_t)n_raw, out, 120000)) {
        fprintf(stderr, "beamform failed: %s\n",
                beamformer_get_last_error_string());
        return 4;
    }
    FILE *f = fopen(argv[3], "wb");
    if (!f || fwrite(out, sizeof(float), points, f) != points) return 5;
    fclose(f);
    printf("FRAME %zu\n", points);
    return 0;
}
"""


def block_beamformer(dev, block):
    """A Beamformer on ``dev`` holding the state of a server's block: the
    reference its served frames are held to."""
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
    bf = Beamformer(device=dev)
    bf.push_parameters(block.parameters)
    bf.push_pipeline([sd.kind for sd in block.pipeline.stages],
                     block.pipeline.data_kind,
                     [sd.parameter for sd in block.pipeline.stages])
    bf.push_channel_mapping(block.channel_mapping)
    bf.push_sparse_elements(block.sparse_elements)
    bf.push_focal_vectors(block.focal_vectors)
    bf.push_transmit_receive_orientations(
        block.transmit_receive_orientations)
    bf._blocks[0].filters = dict(block.filters)
    return bf


def client_stats(lib) -> np.ndarray:
    """The stats table's times as the client reads them."""
    import ctypes as ct
    from ogl_beamforming_tpu_torch.runtime import abi
    table = abi.CStatsTable()
    check(lib.beamformer_compute_timings(ct.byref(table), 1000) == 1,
          "beamformer_compute_timings failed")
    return np.ctypeslib.as_array(table.times).copy()


def c_client_frame(label, sp, raw, shm_name) -> np.ndarray:
    """One frame from a C client compiled against generated/
    ogl_beamformer_lib.h and the port's library, in a subprocess: it reads
    the parameters' bytes and the raw frame from files and calls
    beamformer_beamform_data."""
    import ctypes as ct
    import os
    import shutil
    import tempfile
    from pathlib import Path

    from ogl_beamforming_tpu_torch.runtime import abi
    lib_dir = abi.build_native().parent
    tmp = Path(tempfile.mkdtemp(prefix="ogl_bf_client_"))
    try:
        (tmp / "client.c").write_text(C_CLIENT)
        generated = Path(__file__).resolve().parent / "generated"
        subprocess.run([abi.find_cc(), str(tmp / "client.c"), "-I",
                        str(generated), "-L", str(lib_dir),
                        "-logl_beamformer_tpu", "-o", str(tmp / "client")],
                       check=True, capture_output=True, timeout=120)
        (tmp / "sp").write_bytes(ct.string_at(ct.addressof(sp),
                                              ct.sizeof(sp)))
        raw.tofile(tmp / "raw")
        env = dict(os.environ, LD_LIBRARY_PATH=str(lib_dir),
                   OGL_BEAMFORMER_SHM_NAME=shm_name)
        t0 = time.perf_counter()
        run = subprocess.run([str(tmp / "client"), str(tmp / "sp"),
                              str(tmp / "raw"), str(tmp / "out")], env=env,
                             capture_output=True, text=True, timeout=300)
        ms = (time.perf_counter() - t0) * 1e3
        check(run.returncode == 0, f"{label}: C client exit "
              f"{run.returncode}: {run.stdout} {run.stderr}")
        print(f"[serve {label}] C client (subprocess, "
              f"beamformer_beamform_data): {run.stdout.strip()} in "
              f"{ms:.1f} ms with its process start")
        return np.fromfile(tmp / "out", np.float32)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def serve_path(label, dev, params, pipe, raw, target_voxel,
               kernels) -> float:
    """A BeamformerServer on ``dev`` and a client in this process: the
    client pushes the simple parameters and, after a warm-up, SERVE_FRAMES
    frames of the STREAM_VARIANTS raw frames with
    beamformer_push_data_with_compute, then reads them back with
    beamformer_get_last_frames and the stats with
    beamformer_compute_timings, the launch counts set to 0 just before.
    Each kernel must launch once per frame, the client's stats table must
    hold SERVE_FRAMES new rows, and every frame must equal
    push_data_with_compute of its raw frame bit for bit, its peak within
    one voxel of the target; then one frame from a C client in a
    subprocess, held to the same.  Returns the served ms/frame
    (the client's clock, first push to the last export, over
    SERVE_FRAMES)."""
    import ctypes as ct
    import os

    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.runtime.server import (
        BeamformerServer, simple_parameters_to_c)

    name = f"/ogl_bf_smoke_{os.getpid()}"
    os.environ["OGL_BEAMFORMER_SHM_NAME"] = name
    srv = BeamformerServer(shm_size=SERVE_SHM_BYTES, device=dev).start()
    try:
        lib = srv.lib
        lib.beamformer_set_global_timeout(SERVE_TIMEOUT_MS)
        sp = simple_parameters_to_c(params, pipe.shaders, pipe.data_kind)
        check(lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1,
              f"{label}: push_simple_parameters failed")
        shape = grid_shape(params)
        frames = np.zeros((SERVE_FRAMES, int(np.prod(shape))), np.float32)

        def push(v):
            check(lib.beamformer_push_data_with_compute(
                v.ctypes.data_as(ct.c_void_p), v.nbytes, 0, 0) == 1,
                f"{label}: push failed: "
                f"{lib.beamformer_get_last_error_string()}")

        def export(count):
            check(lib.beamformer_get_last_frames(
                frames.ctypes.data_as(ct.c_void_p),
                ct.c_uint64(frames[:count].nbytes), count) == 1,
                f"{label}: get_last_frames failed: "
                f"{lib.beamformer_get_last_error_string()}")

        variants = stream_variants(raw)
        for v in variants:                 # the plan, the session's rings
            push(v)
        export(1)
        build.LAUNCHES.clear()
        first = srv.beamformer.stats._frame_index
        before = client_stats(lib)
        t0 = time.perf_counter()
        for i in range(SERVE_FRAMES):
            push(variants[i % STREAM_VARIANTS])
        export(SERVE_FRAMES)
        served = (time.perf_counter() - t0) * 1e3 / SERVE_FRAMES
        launches = {k: build.LAUNCHES[k] for k in kernels}
        check(all(n == SERVE_FRAMES for n in launches.values()),
              f"{label}: kernel launch counts {launches} != "
              f"{SERVE_FRAMES} served frames")
        after = client_stats(lib)
        new_rows = {r for r in range(len(after))
                    if not np.array_equal(before[r], after[r])}
        want = {(first + i) % len(after) for i in range(SERVE_FRAMES)}
        check(new_rows == want and (after[sorted(want)] > 0).any(axis=1)
              .all(), f"{label}: the client's stats table changed in "
              f"rows {sorted(new_rows)}, expected {sorted(want)}")

        ref_bf = block_beamformer(dev, srv.beamformer._blocks[0])
        refs = [ref_bf.push_data_with_compute(v).to_reference_layout()
                for v in variants]
        for i, f in enumerate(frames):
            check(np.array_equal(f, refs[i % STREAM_VARIANTS]),
                  f"{label}: served frame {i} differs from "
                  f"push_data_with_compute of its raw frame")
            peak_check(f"{label} served frame {i}",
                       f.reshape(shape[::-1]).transpose(2, 1, 0),
                       target_voxel)
        print(f"[serve {label}] {SERVE_FRAMES} frames of "
              f"{raw.nbytes} bytes: launches {launches}; {len(new_rows)} new "
              f"rows in the client's stats table; every frame equal to "
              f"push_data_with_compute of its raw frame bit for bit, peaks "
              f"within one voxel of {target_voxel}; served {served:.3f} "
              f"ms/frame (client clock, first push to last export / "
              f"{SERVE_FRAMES})")
        # nothing is in flight: the scratch is free to write
        scratch = srv._scratch(raw.nbytes)
        into = host_ms(lambda: ct.memmove(scratch.ctypes.data,
                                          variants[0].ctypes.data,
                                          raw.nbytes))
        copy = host_ms(lambda: scratch.copy())
        print(f"[serve {label}] parts alone (median host clock): the raw "
              f"frame copied into the scratch as the client library copies "
              f"it (memcpy) {into:.3f} ms; a copy of it out of the scratch, "
              f"which the JAX server makes and this one leaves to the "
              f"session's pinned copy, {copy:.3f} ms")
        out = c_client_frame(label, sp, variants[0], name)
        check(np.array_equal(out, refs[0]), f"{label}: the C client's frame "
              "differs from push_data_with_compute of its raw frame")
        peak_check(f"{label} C client frame",
                   out.reshape(shape[::-1]).transpose(2, 1, 0), target_voxel)
        print(f"[serve {label}] C client frame equal to "
              "push_data_with_compute of its raw frame bit for bit")
        return served
    finally:
        os.environ["OGL_BEAMFORMER_SHM_NAME"] = name
        srv.stop(timeout=60)
        check(not srv._thread.is_alive(), f"{label}: server thread alive")


def phase_serve(dev, smi_line, streamed_ms) -> None:
    from ogl_beamforming_tpu_torch.runtime.server import shm_free_bytes
    print(f"[serve] {smi_line}; /dev/shm free {shm_free_bytes()} bytes, "
          f"region {SERVE_SHM_BYTES} bytes")
    params, pipe, raw, voxel = quickstart()
    kernels = ("decode_hadamard", "das_forces")
    served = serve_path("Quickstart", dev, params, pipe, raw, voxel, kernels)
    print(f"[serve Quickstart] served {served:.3f} ms/frame; streamed "
          f"(phase 8, this process) {streamed_ms:.3f} ms/frame; {smi_line}")


# ---------------------------------------------------------------------------
# Phase 10: recorded acquisitions and display.  A point-target FORCES
# acquisition at full width written as .zbp files and loaded back, the
# throughput chain of examples/throughput.py run from each, the decode
# sweep of examples/decode_sweep.py, the point_scatterer and live_streaming
# examples with the viewers and the browser live view, das_from_params on
# every family and entry().  Every kernel launch of the phase is counted
# onto its table row (``phase10_launches``).

ZBP_SHAPE = (128, 128, 4096)   # channels, transmits, samples at 40 MHz
ZBP_FS, ZBP_FD, ZBP_SOS, ZBP_PITCH = 40e6, 7.8e6, 1540.0, 0.3e-3
# the target, a voxel of the throughput grid (512 x 1024 over +-60 mm x
# 10-165 mm): x = 19.14 mm, under the 0-38.1 mm aperture; z = 40.0 mm,
# inside the record (4096 samples at 40 MHz reach about 79 mm)
ZBP_TARGET_VOXEL = (337, 198, 0)
ZBP_CHIRP = (2e-6, 1e6, 4e6)   # duration, min and max baseband frequency
THROUGHPUT_FRAMES = 32         # the example's rolling average
LIVE_FRAMES = 20
HTTP_TIMEOUT = 30              # seconds for a request to the live view


def zbp_echoes(dev, dist, waveform) -> np.ndarray:
    """Echoes of a point target whose (channel, transmit) path lengths are
    ``dist`` (C, A) metres, drawn on the card: ``waveform(u)`` of each
    sample's time ``u`` after the path's delay, Hadamard-encoded across
    transmits, scaled to 30000 and cut to int16 (C, A*S) on the host."""
    from ogl_beamforming_tpu_torch.ops import decode
    c, a, s = ZBP_SHAPE
    t = torch.arange(s, device=dev, dtype=torch.float64) / ZBP_FS
    tau = torch.from_numpy(dist / ZBP_SOS).to(dev)
    u = (t[None, None, :] - tau[:, :, None]).to(torch.float32)
    echo = waveform(u)
    encoded = torch.matmul(decode.hadamard_matrix(a, dev).T, echo)
    encoded *= 30000.0 / encoded.abs().max()
    return encoded.clamp(-32768, 32767).to(torch.int16).reshape(
        c, -1).cpu().numpy()


def sine_burst(u):
    """The cosine burst of :func:`encode_echoes` at the carrier ZBP_FD."""
    env = torch.exp(-0.5 * (u / (2 / ZBP_FD / 4)) ** 2)
    return env * torch.cos(2 * np.pi * ZBP_FD * u)


def chirp_burst(u):
    """The chirp the matched filter of a chirp emission compresses, on the
    carrier ZBP_FD: the filter's taps (``utils.filters.baseband_chirp``,
    reversed and conjugated, at the pair rate fs / 2) conjugated back.  The
    FIR correlates (y[n] = sum_j h[j] x[n - L + 1 + j]), so the echo whose
    baseband is conj(h) compresses, and its energy centroid, tap
    (L - 1) / 2, arrives at the path's delay: the delay the filter's
    first-moment compensation assumes."""
    duration, f_min, f_max = ZBP_CHIRP
    rate = ZBP_FS / 2
    length = int(duration * rate)
    v = (length - 1) / 2 - u * rate          # the chirp's own tap index
    fc = f_min + v * (f_max - f_min) / (2 * length)
    phase = 2 * np.pi * fc * v / rate + 2 * np.pi * ZBP_FD * u
    # utils.filters.tukey_window(v / length, 0.2)
    x, r = v / length, 0.2
    w = torch.where(x < r / 2, 0.5 * (1 + torch.cos(2 * np.pi * (x - r / 2)
                                                    / r)), 1.0)
    w = torch.where(x >= 1 - r / 2,
                    0.5 * (1 + torch.cos(2 * np.pi * (x - 1 + r / 2) / r)), w)
    inside = (v >= 0) & (v < length)
    return torch.where(inside, w * torch.cos(phase), torch.zeros_like(u))


def zbp_acquisition(dev, emission):
    """The point-target ZbpFile (v2, ``emission`` "sine" or "chirp") and
    the target's voxel: raw rows in the scanner's order, a shuffled channel
    mapping."""
    from ogl_beamforming_tpu_torch.models.presets import from_zbp
    from ogl_beamforming_tpu_torch.params.enums import (
        AcquisitionKind, DataKind, DecodeMode)
    from ogl_beamforming_tpu_torch.utils.zbp import ZbpFile

    c, a, s = ZBP_SHAPE
    mapping = np.random.default_rng(14).permutation(c).astype(np.int16)
    z = ZbpFile(
        version=(2, 0), raw_data_dimension=(a * s, c, 1, 1),
        data_kind=DataKind.Int16, decode_mode=DecodeMode.Hadamard,
        sampling_mode=0, sampling_frequency=ZBP_FS,
        demodulation_frequency=ZBP_FD, speed_of_sound=ZBP_SOS,
        sample_count=s, channel_count=c, receive_event_count=a,
        xdc_transform=np.eye(4, dtype=np.float32),
        xdc_element_pitch=np.array([ZBP_PITCH, ZBP_PITCH], np.float32),
        time_offset=0.0, acquisition_kind=AcquisitionKind.FORCES,
        channel_mapping=mapping,
        emissions=[{"kind": 0, "cycles": 2.0, "frequency": ZBP_FD}
                   if emission == "sine" else
                   {"kind": 1, "duration": ZBP_CHIRP[0],
                    "min_frequency": ZBP_CHIRP[1],
                    "max_frequency": ZBP_CHIRP[2]}])
    params, _ = from_zbp(z)
    target = target_world(params, ZBP_TARGET_VOXEL)
    x = np.arange(c) * ZBP_PITCH
    rx_d = np.sqrt((target[0] - x) ** 2 + target[2] ** 2)
    tx_d = np.sqrt((target[1] - ZBP_PITCH * c / 2) ** 2 + target[2] ** 2
                   + (target[0] - x) ** 2)
    canonical = zbp_echoes(dev, rx_d[:, None] + tx_d[None, :],
                           sine_burst if emission == "sine" else chirp_burst)
    raw = np.empty_like(canonical)
    raw[mapping] = canonical            # prepare_rf reads raw[mapping[c]]
    z.data = raw.ravel()
    return z


def zbp_mismatches(got, want) -> list:
    """The fields of two ZbpFiles that differ: arrays and floats compared
    bit for bit (floats as the file's float32)."""
    import dataclasses
    bad = []
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            same = (g is not None and w is not None
                    and np.asarray(g).dtype == np.asarray(w).dtype
                    and np.asarray(g).tobytes() == np.asarray(w).tobytes())
        elif f.name == "transmit_focus":
            same = ([np.float32(v) for v in dataclasses.astuple(g)]
                    == [np.float32(v) for v in dataclasses.astuple(w)])
        elif f.name == "emissions":
            same = ([{k: np.float32(v) for k, v in e.items()} for e in g]
                    == [{k: np.float32(v) for k, v in e.items()} for e in w])
        elif isinstance(w, float):
            same = np.float32(g) == np.float32(w)
        else:
            same = g == w
        if not same:
            bad.append(f.name)
    return bad


def zbp_round_trip(dev, tmp) -> dict:
    """The v2 sine, v2 chirp and v1 files written and loaded back with the
    port's loader, every field and the data bit-equal to what was written;
    returns {label: loaded ZbpFile}."""
    import dataclasses
    from pathlib import Path

    from ogl_beamforming_tpu_torch.params.enums import DataKind
    from ogl_beamforming_tpu_torch.utils import zbp

    t0 = time.perf_counter()
    sine, chirp = zbp_acquisition(dev, "sine"), zbp_acquisition(dev, "chirp")
    made = time.perf_counter() - t0
    v1_want = dataclasses.replace(
        sine, version=(1, 1), data_kind=DataKind.Int16, sampling_mode=0,
        emissions=[])
    for name, dt in (("channel_mapping", np.int16),
                     ("steering_angles", np.float32),
                     ("focal_depths", np.float32),
                     ("sparse_elements", np.int16)):
        table = np.zeros(256, dt)
        src = getattr(sine, name)
        if src is not None:
            table[:len(src)] = src
        setattr(v1_want, name, table)
    loaded = {}
    for label, z, want, save in (
            ("v2 sine", sine, sine,
             lambda p, z: zbp.save_zbp_v2(p, z, compress=False)),
            ("v2 chirp", chirp, chirp,
             lambda p, z: zbp.save_zbp_v2(p, z, compress=False)),
            ("v1", sine, v1_want, zbp.save_zbp_v1)):
        path = Path(tmp) / (label.replace(" ", "_") + ".zbp")
        save(path, z)
        t0 = time.perf_counter()
        got = zbp.load_zbp(path)
        load_s = time.perf_counter() - t0
        bad = zbp_mismatches(got, want)
        check(not bad, f"zbp {label}: fields {bad} differ from the written")
        print(f"[zbp] {label}: {path.stat().st_size} bytes written and "
              f"loaded back in {load_s:.2f} s, every field and the "
              f"{got.data.size} int16 samples bit-equal")
        loaded[label] = got
    print(f"[zbp] acquisitions {ZBP_SHAPE} int16 Hadamard-encoded, shuffled "
          f"mapping, drawn on the card in {made:.2f} s")
    return loaded


def throughput_chain(label, dev, z, smi_line) -> dict:
    """The throughput example on ``z``: a warm-up frame, then
    THROUGHPUT_FRAMES frames with the counts set to 0 just before and read
    just after (Demodulate, Decode and DAS once a frame), the peak within
    one voxel of the target, the last frame against the plain versions
    stage by stage on the card (NRMSE 1e-4).  Returns the launches by
    table row and the last frame."""
    from ogl_beamforming_tpu_torch.examples import throughput
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.ops import das as das_ops
    from ogl_beamforming_tpu_torch.ops import decode, filtering
    from ogl_beamforming_tpu_torch.params.enums import ContrastMode
    from ogl_beamforming_tpu_torch.runtime.upload import prepare_rf

    bf = throughput.configure(z, dev)
    raw = throughput.raw_frame(z)
    bf.push_data_with_compute(raw)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    lines = []
    wall = throughput.run(bf, raw, THROUGHPUT_FRAMES, out=lines.append)
    launches = dict(build.LAUNCHES)
    want = {"demodulate": THROUGHPUT_FRAMES,
            "decode_hadamard": THROUGHPUT_FRAMES,
            "das_forces": THROUGHPUT_FRAMES}
    check(launches == want, f"throughput {label}: launches {launches}, "
          f"want each of {want} once a frame")
    for line in lines:
        print(f"[throughput {label}] {line}")
    frame = bf.get_last_frames(1)[-1]
    out = frame.data
    check(out.shape == (512, 1024, 1) and out.dtype == torch.complex64,
          f"throughput {label}: frame {tuple(out.shape)} {out.dtype}")
    img = frame.to_numpy()
    peak = peak_check(f"throughput {label}", np.abs(img), ZBP_TARGET_VOXEL)

    plan = bf._blocks[0]._plan
    st = plan.descriptor.stages
    p = bf._blocks[0].parameters
    x = torch.from_numpy(prepare_rf(raw, bf._blocks[0].channel_mapping,
                                    p.channel_count, p.acquisition_count,
                                    p.sample_count, ContrastMode.NoContrast,
                                    plan.descriptor.data_kind)).to(dev)
    iq = filtering.demodulate_ref(x, plan.dyn["taps0"],
                                  plan.dyn["demodulation_frequency"],
                                  plan.dyn["sampling_frequency"],
                                  st[0].decimation_rate, st[0].filter_complex,
                                  plan.dyn["phasor0"])
    dec = decode.decode_hadamard_ref(iq, plan.dyn["hadamard1"])
    ref = das_ops.das_ref(dec.contiguous(), plan.dyn["das"], st[2].das)
    err = compare(out, ref, 1e-4, f"throughput {label} vs plain chain")
    stage, split = stage_split(bf, 0, THROUGHPUT_FRAMES)
    fp = bf._blocks[0].filters[0]
    print(f"[throughput {label}] {fp.parameters.kind.name} filter "
          f"{fp.length} taps ({'complex' if fp.complex else 'real'}) at "
          f"{fp.parameters.sampling_frequency / 1e6:g} MHz; peak {peak} vs "
          f"target {ZBP_TARGET_VOXEL}; vs demodulate, decode and DAS twins "
          f"stage by stage max abs err {err:.3e}; device ms/frame "
          f"{float(stage.sum()):.3f} ({split}, median CUDA events over "
          f"{THROUGHPUT_FRAMES}); end to end {statistics.median(wall) * 1e3:.3f}"
          f" ms/frame (median host clock, the example's: prepare_rf, upload, "
          f"wait); {smi_line}")
    return ({"demodulate": launches.get("demodulate", 0),
             "decode_hadamard_f32": launches.get("decode_hadamard", 0),
             "das_forces_iq": launches.get("das_forces", 0)}, img)


def decode_sweep_phase(dev, smi_line) -> int:
    """examples/decode_sweep at every order: the kernel bit-equal to its
    twin, the example's 32-frame average, GB/s, its share of the byte
    bound and the cuBLAS f32 product at the same order.  Returns the
    decode launches."""
    from ogl_beamforming_tpu_torch.examples import decode_sweep
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.ops import decode

    launches = 0
    for t in decode_sweep.TRANSMIT_COUNTS:
        rf, h = decode_sweep.sweep_input(t, dev, seed=t)
        before = build.LAUNCHES["decode_hadamard"]
        avg_ms, out = decode_sweep.time_order(rf, h)
        launches += build.LAUNCHES["decode_hadamard"] - before
        ref = decode.decode_hadamard_ref(rf, h)
        torch.cuda.synchronize()
        check(torch.equal(out, ref),
              f"decode sweep order {t}: kernel != twin (max abs err "
              f"{float((out - ref).abs().max()):.3e})")
        nbytes = rf.numel() * 2 + out.numel() * 4 + t * t
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rf32 = rf.to(torch.float32)
        h32 = h.to(torch.float32)
        lib_ms = median_ms(lambda: torch.matmul(h32, rf32))
        print(f"[decode_sweep] "
              f"{decode_sweep.order_line(t, avg_ms, decode_sweep.rf_gbs(rf, avg_ms))}"
              f" | bit-equal | byte bound {bound_ms:.4f} ms, "
              f"{bound_ms / avg_ms:.3f} of it | cuBLAS f32 matmul "
              f"{lib_ms:.4f} ms; {smi_line}")
        del rf, h, out, ref, rf32
    return launches


def decode_png_gray(png: bytes) -> np.ndarray:
    """The 8-bit grayscale pixels of a PNG from ``encode_png_gray`` (zlib
    IDAT, filter 0 on every row)."""
    import struct
    import zlib
    check(png[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos:pos + 4])
        tag, body = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        shape[0], shape[1] + 1)
    check(not rows[:, 0].any(), "PNG rows use a filter")
    return rows[:, 1:]


def png_pixels(img: np.ndarray) -> np.ndarray:
    """``encode_png_gray``'s quantisation of a [0, 1] image."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def point_scatterer_phase(dev, tmp) -> dict:
    """examples/point_scatterer at its size: a warm-up and RUNS frames
    (Decode and DAS once a frame), the B-mode peak on the target (within a
    voxel laterally; axially within a voxel of the quarter carrier period
    by which a real sine burst's |RF| peak sits off its envelope's
    centre), and the PNG through ``encode_png_gray`` decoding to the
    pixels of ``viewer.bmode_image``."""
    from pathlib import Path

    from ogl_beamforming_tpu_torch import viewer
    from ogl_beamforming_tpu_torch.examples import point_scatterer as ps
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.viewer_web import encode_png_gray

    p = ps.parameters()
    target = ps.target_for()
    raw = ps.raw_frame(p, target)
    bf = ps.configure(p, dev)
    bf.push_data_with_compute(raw)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    for _ in range(RUNS):
        frame = bf.push_data_with_compute(raw)
    launches = dict(build.LAUNCHES)
    check(launches == {"decode_hadamard": RUNS, "das_forces": RUNS},
          f"point_scatterer: launches {launches}")
    img = viewer.bmode_image(frame, db_cutoff=-50)
    wx, wz = ps.image_peak_mm(img, p)
    nx, nz = int(p.output_points[0]), int(p.output_points[1])
    dx = (ps.C - 1) * ps.PITCH * 1e3 / (nx - 1)
    dz = (ps.DEPTH_MM[1] - ps.DEPTH_MM[0]) / (nz - 1)
    quarter = ps.SOS / ps.F0 / 4 / 2 * 1e3     # mm of depth
    off_x, off_z = abs(wx - target[0] * 1e3), abs(wz - target[2] * 1e3)
    check(off_x <= dx and off_z <= quarter + dz,
          f"point_scatterer: image peak ({wx:.3f}, {wz:.3f}) mm, target "
          f"({target[0] * 1e3:.3f}, {target[2] * 1e3:.3f}) mm")
    path = Path(tmp) / "point_scatterer.png"
    path.write_bytes(encode_png_gray(img))
    pixels = decode_png_gray(path.read_bytes())
    check(np.array_equal(pixels, png_pixels(img)),
          "point_scatterer: the PNG's pixels are not bmode_image's")
    print(f"[point_scatterer] {ps.C}x{ps.A}x{ps.S} -> {nx}x{nz}: image peak "
          f"({wx:.3f}, {wz:.3f}) mm, target ({target[0] * 1e3:.3f}, "
          f"{target[2] * 1e3:.3f}) mm (voxel {dx:.4f} x {dz:.4f} mm, a "
          f"quarter period {quarter:.4f} mm); launches {launches}; PNG "
          f"{path.stat().st_size} bytes decodes to bmode_image's "
          f"{pixels.shape} pixels")
    return launches


def http(method, url, body=None):
    import urllib.request
    req = urllib.request.Request(url, method=method, data=None if body is None
                                 else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT) as r:
        return r.read()


def live_phase(dev) -> dict:
    """examples/live_streaming on the card: a StreamingSession with a
    LiveView on 127.0.0.1 (a free port), LIVE_FRAMES frames of the orbiting
    target with the counts set to 0 just before; the served PNG, stats and
    A-scan against the last frame; a StopImaging POST in the dirty flag and
    stopping the session; the X-plane and MIP endpoints over a HERCULES
    volume beamformed on the card (the phase 4 canary's 16 x 16 x 512 ->
    24^3) equal to the renderers' pixels."""
    from ogl_beamforming_tpu_torch import viewer, viewer_xplane
    from ogl_beamforming_tpu_torch.examples import live_streaming as ls
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.params.enums import LiveImagingDirtyFlags
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    from ogl_beamforming_tpu_torch.utils.transforms import das_transform_3d
    from ogl_beamforming_tpu_torch.viewer_web import LiveView

    bf = ls.configure(dev)
    view = LiveView(bf, host="127.0.0.1", port=0).start()
    views = [view]
    try:
        with StreamingSession(bf) as session:
            session.submit(ls.frame_for_target(ls.orbit_target(0))).result(
                timeout=STREAM_TIMEOUT)
            session.drain(timeout=STREAM_TIMEOUT)
            rows = bf.stats._frame_index
            build.LAUNCHES.clear()
            t0 = time.perf_counter()
            handle = ls.stream(bf, session, LIVE_FRAMES, out=print)
            last = handle.result(timeout=STREAM_TIMEOUT)
            session.drain(timeout=STREAM_TIMEOUT)
            streamed = (time.perf_counter() - t0) * 1e3 / LIVE_FRAMES
            launches = dict(build.LAUNCHES)
            check(launches == {"decode_hadamard": LIVE_FRAMES,
                               "das_forces": LIVE_FRAMES},
                  f"live_streaming: launches {launches}")
            new_rows = bf.stats._frame_index - rows
            check(new_rows == LIVE_FRAMES,
                  f"live_streaming: {new_rows} new stats rows")
            check(bf.get_last_frames(1)[-1] is last,
                  "live_streaming: the last frame is not the backlog's")

            png = decode_png_gray(http("GET", view.url + "frame.png"))
            want = png_pixels(viewer.bmode_image(last))
            check(np.array_equal(png, want),
                  "live view: frame.png is not bmode_image of the last frame")
            stats = json.loads(http("GET", view.url + "stats.json"))
            check([s["name"] for s in stats["stages"]] == ["Decode", "DAS"]
                  and stats["frame_ms"] > 0, f"live view: stats {stats}")
            ascan = json.loads(http("GET", view.url + "ascan.json?frac=0.5"))
            line = viewer.a_scan(last, ascan["lateral_index"])
            check(np.allclose(np.asarray(ascan["values"]) * ascan["peak"],
                              line, rtol=1e-5),
                  "live view: ascan.json is not a_scan of the last frame")
            stop = json.loads(http("POST", view.url + "live", {"stop": True}))
            flags = bf.live_parameters_get_dirty_flag()
            check(stop["ok"] and flags & LiveImagingDirtyFlags.StopImaging,
                  f"live view: StopImaging POST gave {stop}, flags {flags}")
            dropped = session.submit(ls.frame_for_target(
                ls.orbit_target(LIVE_FRAMES))).result(timeout=STREAM_TIMEOUT)
            check(dropped is None and session.stop_requested,
                  "live view: the session did not stop")

        ph, pipe = presets.hercules_3d(channel_count=16, acquisition_count=16,
                                       sample_count=512,
                                       output_points=(24, 24, 24))
        ap = 15 * float(ph.xdc_element_pitch[0])
        ph.das_voxel_transform = das_transform_3d([0, 0, 2e-3],
                                                  [ap, ap, 12e-3])
        raw = np.random.default_rng(10).integers(-2048, 2048, (16, 16 * 512),
                                                 dtype=np.int16)
        vbf = beamformer(dev, ph, pipe.shaders, pipe.data_kind)
        volume = vbf.push_data_with_compute(raw)
        vview = LiveView(vbf, host="127.0.0.1", port=0).start()
        views.append(vview)
        vol = viewer_xplane.volume_bmode(volume)
        xplane = decode_png_gray(http(
            "GET", vview.url + "xplane.png?ox=0.1&oy=-0.2&oz=0&size=128"))
        mip = decode_png_gray(http("GET", vview.url + "mip.png?size=96"))
        check(np.array_equal(xplane, png_pixels(viewer_xplane.render_xplane(
            vol, [0.1, -0.2, 0.0], size=128))) and xplane.max() > 0,
              "live view: xplane.png is not render_xplane of the volume")
        check(np.array_equal(mip, png_pixels(viewer_xplane.render_mip(
            vol, size=96))) and mip.max() > 0,
              "live view: mip.png is not render_mip of the volume")
    finally:
        for v in views:
            thread = v._thread
            v.stop()
            thread.join(HTTP_TIMEOUT)
    check(not any(v._thread.is_alive() for v in views),
          "live view: a server thread outlived stop()")
    print(f"[live_streaming] {LIVE_FRAMES} frames through a StreamingSession "
          f"with a LiveView on 127.0.0.1: launches {launches}, "
          f"{new_rows} new stats rows, {streamed:.3f} ms/frame streamed; "
          f"frame.png = bmode_image of the last frame, stats.json "
          f"{stats['frame_ms']:.3f} ms/frame, ascan.json = a_scan; "
          f"StopImaging in the dirty flag and the next frame dropped; "
          f"xplane.png and mip.png of a HERCULES 24^3 volume = "
          f"render_xplane and render_mip")
    return launches


def das_from_params_phase(dev) -> dict:
    """ops.das.das_from_params on CUDA tensors for each family at the
    phase 4 canaries' configurations, against golden (NRMSE 1e-3)."""
    from ogl_beamforming_tpu_torch import DataKind
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import golden
    from ogl_beamforming_tpu_torch.ops.das import das_from_params
    from ogl_beamforming_tpu_torch.utils.transforms import (
        das_transform_2d_xz, das_transform_3d)

    rng = np.random.default_rng(41)
    cases = []
    pf, _ = presets.forces_compounding(channel_count=32, transmit_count=16,
                                       sample_count=1024,
                                       output_points=(64, 64),
                                       demodulate=False)
    pf.das_voxel_transform = das_transform_2d_xz(
        [0, 2e-3], [31 * float(pf.xdc_element_pitch[0]), 16e-3])
    cases.append(("FORCES 32x16x1024 -> 64x64", "das_forces", pf, {}, False))
    ph, _ = presets.hercules_3d(channel_count=16, acquisition_count=16,
                                sample_count=512, output_points=(24, 24, 24))
    ap = 15 * float(ph.xdc_element_pitch[0])
    ph.das_voxel_transform = das_transform_3d([0, 0, 2e-3], [ap, ap, 12e-3])
    cases.append(("HERCULES 16x16x512 -> 24^3", "das_hercules", ph, {},
                  False))
    pu, _, sparse = presets.uforces_volumetric(
        channel_count=32, acquisition_count=16, sample_count=512,
        output_points=(24, 24, 24))
    ap = 31 * float(pu.xdc_element_pitch[0])
    pu.das_voxel_transform = das_transform_3d([0, -ap / 2, 2e-3],
                                              [ap, ap / 2, 12e-3])
    cases.append(("uFORCES + coherency 32x16x512 -> 24^3",
                  "das_forces_coh3d", pu,
                  dict(sparse=True, sparse_elements=sparse,
                       coherency_weighting=True), False))
    pa, _ = presets.plane_wave_2d(
        channel_count=64, sample_count=1024, output_points=(64, 64),
        lateral_mm=(-2.0, 14.0), axial_mm=(5.0, 15.0),
        data_kind=DataKind.Float32Complex)
    cases.append(("Flash IQ 64x1x1024 -> 64x64", "das_rca", pa, {}, True))

    launches = {}
    for label, row, p, kw, iq in cases:
        s = p.sample_count
        dp = das_params(p, s, p.sampling_frequency, p.time_offset, **kw)
        shape = (p.channel_count, p.acquisition_count, s)
        rf = rng.standard_normal(shape).astype(np.float32)
        if iq:
            rf = (rf + 1j * rng.standard_normal(shape)).astype(np.complex64)
        before = sum(build.LAUNCHES.values())
        out = das_from_params(torch.from_numpy(rf).to(dev), dp)
        launches[row] = sum(build.LAUNCHES.values()) - before
        check(launches[row] == 1, f"das_from_params {label}: "
              f"{launches[row]} launches")
        ref = golden.das(rf, dp)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        errs = []
        for o, r in zip(outs, refs):
            check(o.is_cuda, f"das_from_params {label}: not on the card")
            o = o.cpu().numpy()
            check(o.shape == r.shape and np.isfinite(o).all(),
                  f"das_from_params {label}: {o.shape} vs {r.shape}")
            errs.append(nrmse(r, o))
        check(max(errs) <= 1e-3, f"das_from_params {label}: golden NRMSE "
              f"{errs} > 1e-3")
        print(f"[das_from_params] {label} on CUDA tensors vs golden: NRMSE "
              + ", ".join(f"{e:.3e}" for e in errs))
    return launches


def entry_phase(dev) -> dict:
    """entry()'s forward once on the card with a point-target frame: the
    peak within one voxel of the target, Decode and DAS launched once."""
    from ogl_beamforming_tpu_torch import entry
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.ops import decode

    forward, (rf,) = entry.entry()
    check(rf.is_cuda and not rf.any(), "entry(): example frame")
    c, a, s = rf.shape
    p = entry.flagship_parameters(c, a, s, 128, 128)
    voxel = (64, 40, 0)
    raw = synthesize_forces_frame(
        c, a, s, p.sampling_frequency, p.speed_of_sound, entry.PITCH,
        target_world(p, voxel), p.demodulation_frequency,
        decode.hadamard_matrix(a, "cpu").numpy())
    forward(torch.from_numpy(raw.reshape(c, a, s)).to(dev))   # warm-up
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    out = forward(torch.from_numpy(raw.reshape(c, a, s)).to(dev))
    launches = dict(build.LAUNCHES)
    check(launches == {"decode_hadamard": 1, "das_forces": 1},
          f"entry(): launches {launches}")
    check(out.is_cuda and tuple(out.shape) == (128, 128, 1),
          f"entry(): output {tuple(out.shape)}")
    peak = peak_check("entry()", out.cpu().numpy(), voxel)
    print(f"[entry] forward on the card: {tuple(out.shape)}, peak {peak} vs "
          f"target {voxel}; launches {launches}")
    return launches


def phase_zbp(dev, smi_line) -> dict:
    """Phase 10; returns its kernel launches by table row."""
    import tempfile

    t0 = time.perf_counter()
    counts: dict = {}

    def add(launches):
        for k, n in launches.items():
            counts[k] = counts.get(k, 0) + n

    with tempfile.TemporaryDirectory(prefix="zbp_smoke_") as tmp:
        files = zbp_round_trip(dev, tmp)
        frames = {}
        for label, z in files.items():
            launches, frames[label] = throughput_chain(label, dev, z,
                                                       smi_line)
            add(launches)
        check(np.array_equal(frames["v1"], frames["v2 sine"]),
              "throughput: the v1 file's frame differs from the v2 sine's")
        print("[throughput] the v1 file's frame is bit-equal to the v2 sine "
              "file's (same data, the Kaiser filter by default)")
        add({"decode_hadamard": decode_sweep_phase(dev, smi_line)})
        add(point_scatterer_phase(dev, tmp))
    add(live_phase(dev))
    add(das_from_params_phase(dev))
    add(entry_phase(dev))
    print(f"[zbp] phase 10 launches by table row {counts}; phase took "
          f"{time.perf_counter() - t0:.1f} s; {smi_line}")
    return counts


# Phase 11: autotune.  The shipped H100 tables
# (ogl_beamforming_tpu_torch/data/*_h100.json) and autotune_das /
# autotune_decode with their default candidates at full width on the
# Quickstart, paths A-E and the throughput chain's DAS (pretune's
# configurations, the keys of the shipped table), and the decode of the
# Quickstart, path B and order 256.
TUNE_PATHS = ("quickstart", "path_a", "path_b", "path_c", "uforces_3d",
              "path_e_batch4", "throughput_chain")
TUNE_DECODE = (("quickstart int16", (128, 128, 4096), torch.int16),
               ("path B complex", (128, 128, 2048), torch.complex64),
               ("T = 256 int16", (256, 256, 4096), torch.int16))


def knob_bound(family: str, knobs: dict) -> float:
    """The NRMSE that ``knobs``' output is held to against the default
    knobs': 0 (bit for bit) where they keep every voxel's order of
    accumulation; 1e-6 for FORCES frames a launch (as phase 3); the twin
    bound, 1e-4, for the FORCES index table's pass (a voxel's pairs are
    summed pass by pass)."""
    if "tx_pass" in knobs:
        return 1e-4
    return 1e-6 if family == "forces" and "fb" in knobs else 0.0


def raw_input(plan, seed: int) -> torch.Tensor:
    """A canonical raw frame (B,) C x A x S_wire of ``plan``'s data kind,
    drawn on the card from ``seed``."""
    from ogl_beamforming_tpu_torch import pretune
    d = plan.descriptor
    lead = (d.frame_batch,) if d.frame_batch > 1 else ()
    shape = lead + (d.channel_count, d.acquisition_count,
                    d.sample_count * d.data_kind.element_count)
    dtype = (torch.int16 if d.data_kind.name.startswith("Int16")
             else torch.float32)
    return pretune.device_input(shape, dtype, seed)


def held(label, out, ref, bound: float) -> str:
    """``out`` against ``ref`` (tuples of outputs): bit-equal where
    ``bound`` is 0, else NRMSE ``bound``; returns what held."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    if bound == 0:
        check(all(torch.equal(o, r) for o, r in zip(outs, refs)),
              f"{label}: not bit-equal to the default knobs")
        return "bit-equal"
    err = max(nrmse(r.cpu().numpy(), o.cpu().numpy())
              for o, r in zip(outs, refs))
    check(err <= bound, f"{label}: NRMSE {err:.3e} > {bound:g}")
    return f"NRMSE {err:.2e}"


def tune_das_path(name, setup, seed, smi_line) -> None:
    """autotune_das on one path: every candidate's output against the
    default knobs', a plan built after tuning launching the installed
    knobs with its frame against the frame of a plan built before."""
    from ogl_beamforming_tpu_torch import pretune
    from ogl_beamforming_tpu_torch.ops import das_cuda
    from ogl_beamforming_tpu_torch.pipeline.plan import compose_stages
    plan0, st, dyn = setup()
    key = das_cuda._tune_key(st)
    raw = raw_input(plan0, seed)
    frame0 = compose_stages(plan0.descriptor, raw, plan0.dyn)
    rf = pretune.das_input(st, seed)
    t0 = time.perf_counter()
    best, results = das_cuda.autotune_das(rf, dyn, st, iters=3, passes=2)
    tune_s = time.perf_counter() - t0
    installed = das_cuda.TUNED[key]
    check(installed == best, f"tune {name}: TUNED holds {installed}, "
          f"autotune_das returned {best}")
    das_cuda.TUNED[key] = {}
    ref = das_cuda.das_cuda(rf, dict(dyn, launch=das_cuda.launch_tables(
        st, dyn)), st)
    lines = []
    for knobs in das_cuda._default_candidates(st):
        t = results[repr(knobs)]
        check(t is not None, f"tune {name}: candidate {knobs} failed")
        das_cuda.TUNED[key] = knobs
        out = das_cuda.das_cuda(rf, dict(dyn, launch=das_cuda.launch_tables(
            st, dyn)), st)
        lines.append(f"{knobs} {t * 1e3:.4f} ms " + held(
            f"tune {name} {knobs}", out, ref, knob_bound(st.family, knobs)))
    das_cuda.TUNED[key] = installed
    plan1, _, _ = setup()
    tables = plan1.dyn["das"]["launch"]
    for knob, value in best.items():
        check(tables[knob] == (tuple(value) if knob == "thread" else value),
              f"tune {name}: the plan built after tuning has {knob} "
              f"{tables[knob]}, installed {value}")
    frame1 = compose_stages(plan1.descriptor, raw, plan1.dyn)
    kept = held(f"tune {name} frame after tuning", frame1, frame0,
                knob_bound(st.family, best))
    print(f"[tune] {name} {key}: autotune_das {tune_s:.1f} s, best {best}; "
          + "; ".join(lines) + f"; the plan after tuning launches {best}, "
          f"its frame vs the frame before: {kept}; {smi_line}")


def tune_decode(label, shape, dtype, seed, smi_line) -> None:
    """autotune_decode on one shape, every candidate bit-equal to the
    default launch."""
    from ogl_beamforming_tpu_torch import pretune
    from ogl_beamforming_tpu_torch.ops import decode
    rf = pretune.device_input(shape, dtype, seed)
    h = decode.hadamard_matrix(shape[1], rf.device)
    key = tuple(shape[:-1]) + (shape[-1] * (2 if rf.is_complex() else 1),)
    t0 = time.perf_counter()
    best, results = decode.autotune_decode(rf, h, iters=20, warmup=2,
                                           passes=2)
    tune_s = time.perf_counter() - t0
    installed = decode.DECODE_TUNED[key]
    decode.DECODE_TUNED[key] = {}
    ref = decode.decode_hadamard(rf, h)
    lines = []
    for knobs in decode.decode_candidates(rf):
        t = results[repr(knobs)]
        check(t is not None, f"tune decode {label}: candidate {knobs} failed")
        decode.DECODE_TUNED[key] = knobs
        lines.append(f"{knobs} {t * 1e3:.4f} ms " + held(
            f"tune decode {label} {knobs}", decode.decode_hadamard(rf, h),
            ref, 0.0))
    decode.DECODE_TUNED[key] = installed
    print(f"[tune] decode {label} {tuple(shape)}: autotune_decode "
          f"{tune_s:.1f} s, best {best} (entry {installed}); "
          + "; ".join(lines) + f"; {smi_line}")


def tables_round_trip(tmp, smi_line) -> None:
    """save_tuned / load_tuned and the decode pair round trip; a HERCULES
    thread shape other than the plan's, loaded from a file, launches in a
    plan built after, its frame bit-equal to a plan's built before."""
    import pathlib

    from ogl_beamforming_tpu_torch import pretune
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.ops import das_cuda, decode
    from ogl_beamforming_tpu_torch.pipeline.plan import compose_stages
    tmp = pathlib.Path(tmp)
    for save, load, table in ((das_cuda.save_tuned, das_cuda.load_tuned,
                               das_cuda.TUNED),
                              (decode.save_decode_tuned,
                               decode.load_decode_tuned, decode.DECODE_TUNED)):
        before = dict(table)
        save(tmp / "table.json")
        table.clear()
        load(tmp / "table.json")
        check(table == before, f"{save.__name__}/{load.__name__}: the table "
              "did not come back as it was")
    setup = dict((n, b) for n, b, _ in pretune.das_cases())["path_c"]
    plan0, st, _ = setup()
    raw = raw_input(plan0, 11)
    frame0 = compose_stages(plan0.descriptor, raw, plan0.dyn)
    key = das_cuda._tune_key(st)
    keep = das_cuda.TUNED.get(key)
    shape = [2, 4, 0] if plan0.dyn["das"]["launch"]["thread"] != (2, 4, 0) \
        else list(build.THREAD_SHAPES["hercules"][0])
    das_cuda.TUNED[key] = {"thread": shape}
    das_cuda.save_tuned(tmp / "shape.json")
    das_cuda.TUNED.pop(key)
    das_cuda.load_tuned(tmp / "shape.json")
    plan1, _, _ = setup()
    launched = "das_hercules thread {}.{}.{}".format(*shape)
    n = build.VARIANT_LAUNCHES[launched]
    frame1 = compose_stages(plan1.descriptor, raw, plan1.dyn)
    torch.cuda.synchronize()
    check(plan1.dyn["das"]["launch"]["thread"] == tuple(shape)
          and build.VARIANT_LAUNCHES[launched] == n + 1,
          f"tune: a plan after load_tuned did not launch thread shape "
          f"{shape}")
    check(torch.equal(frame1, frame0), "tune: path C's frame in thread shape "
          f"{shape} differs from the frame before")
    if keep is None:
        das_cuda.TUNED.pop(key)
    else:
        das_cuda.TUNED[key] = keep
    print(f"[tune] save_tuned/load_tuned and the decode pair round trip; "
          f"path C's plan after load_tuned of thread {shape} launches that "
          f"shape once a frame, its frame bit-equal to the frame before; "
          f"{smi_line}")


def phase_tune(dev, smi_line) -> None:
    """Phase 11."""
    import tempfile

    from ogl_beamforming_tpu_torch import pretune
    from ogl_beamforming_tpu_torch.ops import das_cuda, decode
    t0 = time.perf_counter()
    das_cuda._load_shipped_tuned()
    decode._load_shipped_decode_tuned()
    for path, rows, table in (
            (das_cuda.TUNED_PATH, das_cuda._table_rows, das_cuda.TUNED),
            (decode.DECODE_TUNED_PATH, decode._decode_rows,
             decode.DECODE_TUNED)):
        check(path.exists(), f"tune: no shipped table {path.name}")
        entries = rows(path)         # raises on a knob the kernels lack
        check(entries and all(table.get(k) == v for k, v in entries),
              f"tune: {path.name} is empty or not loaded")
        print(f"[tune] {path.name}: {len(entries)} entries, every knob "
              f"valid, loaded: " + "; ".join(f"{k} {v}" for k, v in entries))
    setups = {n: b for n, b, _ in pretune.das_cases()}
    for i, name in enumerate(TUNE_PATHS):
        tune_das_path(name, setups[name], 200 + i, smi_line)
        torch.cuda.empty_cache()
    for i, (label, shape, dtype) in enumerate(TUNE_DECODE):
        tune_decode(label, shape, dtype, 300 + i, smi_line)
    with tempfile.TemporaryDirectory(prefix="tune_smoke_") as tmp:
        tables_round_trip(tmp, smi_line)
    print(f"[tune] phase 11 took {time.perf_counter() - t0:.1f} s; "
          f"{smi_line}")


# ---------------------------------------------------------------------------
# Phase 12: mesh.  The port's parallel package (parallel/sharding.py,
# parallel/multihost.py) at full width on virtual meshes of cuda:0: the
# Quickstart through Beamformer(mesh=...) (synchronous and streamed), path
# D on channels x slabs, an 8-angle RCA_TPW compounding on channels x
# transmits, two gloo ranks (this script again, MESH_WORKER) each feeding
# its own channel rows, and the entry points.  Positions of one card run one
# after another there: the times measure the sharding's overhead, not
# multi-GPU scaling (the card tests, two NCCL ranks among them, and
# experiments/mesh_sweep.py --cards run meshes over several cards).
# ---------------------------------------------------------------------------

MESH_WORKER = "--mesh-worker"
MESH_TIMEOUT = 240      # seconds for a worker rank or the example
MESH_POSITIONS = 4      # the Quickstart's channel shards
TPW_ANGLES = 8


def launches_since_clear(names) -> dict:
    from ogl_beamforming_tpu_torch.kernels import build
    return {k: build.LAUNCHES[k] for k in names}


def mesh_quickstart(dev, smi_line) -> dict:
    """The Quickstart through Beamformer(mesh=make_mesh([cuda:0] * 4)) and
    Beamformer(device="cuda") on the same raw frames (a warm-up, then RUNS
    frames of the stream variants): NRMSE 1e-5, peaks within one voxel, the
    decode and DAS kernels 4 times a frame, shard k's scalar vector at
    channel offset 32 k; then RUNS frames through a StreamingSession on the
    meshed Beamformer, each against its synchronous frame (NRMSE 1e-6, the
    count bit for bit printed).  Returns the launches."""
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.parallel.sharding import make_mesh
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession

    params, pipe, raw, voxel = quickstart()
    n = MESH_POSITIONS
    kernels = ("decode_hadamard", "das_forces")
    ref_bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind,
                    mesh=make_mesh([dev] * n))
    ref_bf.warmup()
    bf.warmup()
    variants = stream_variants(raw)
    frames_in = [variants[i % STREAM_VARIANTS] for i in range(RUNS)]
    first_ref = ref_bf.stats._frame_index
    refs = [ref_bf.push_data_with_compute(v).to_numpy() for v in frames_in]
    torch.cuda.synchronize()

    build.LAUNCHES.clear()
    first = bf.stats._frame_index
    outs = [bf.push_data_with_compute(v).to_numpy() for v in frames_in]
    launches = launches_since_clear(kernels)
    check(launches == {k: n * RUNS for k in kernels},
          f"mesh quickstart: launches {launches} != {n} a frame")
    worst = max(nrmse(r, o) for r, o in zip(refs, outs))
    check(worst <= 1e-5, f"mesh quickstart: NRMSE {worst:.3e} > 1e-5")
    for i, img in enumerate(outs):
        peak = peak_check(f"mesh quickstart frame {i}", img, voxel)
    plan = bf._blocks[0]._plan
    offsets = [float(sh.dyn["das"]["launch"]["scalars"][19])
               for sh in plan.shards]
    per = params.channel_count // n
    check(offsets == [per * k for k in range(n)],
          f"mesh quickstart: shard channel offsets {offsets}")
    sharded = statistics.median(frame_ms(bf, first, RUNS))
    single = statistics.median(frame_ms(ref_bf, first_ref, RUNS))
    split = stage_split(bf, first, RUNS)[1]
    split_ref = stage_split(ref_bf, first_ref, RUNS)[1]
    print(f"[mesh] Quickstart on {n} positions of {dev} (128 channels, "
          f"{per} a shard): launches {launches}; NRMSE <= {worst:.3e} "
          f"against Beamformer(device='cuda'); peak {peak} vs target "
          f"{voxel}; shard scalar channel offsets {offsets}")
    print(f"[mesh] Quickstart device ms/frame {sharded:.3f} sharded on {n} "
          f"positions of one card ({split}), {single:.3f} unsharded "
          f"({split_ref}; median CUDA events over {RUNS}); {smi_line}")
    sync = [bf.push_data_with_compute(v).data.clone() for v in frames_in]
    with StreamingSession(bf) as stream:
        stream.submit(raw)                  # the ring's first allocation
        stream.drain(timeout=STREAM_TIMEOUT)
        build.LAUNCHES.clear()
        handles = [stream.submit(v) for v in frames_in]
        stream.drain(timeout=STREAM_TIMEOUT)
        streamed = launches_since_clear(kernels)
        frames = [h.result(timeout=STREAM_TIMEOUT).data for h in handles]
    check(streamed == {k: n * RUNS for k in kernels},
          f"mesh streaming: launches {streamed} != {n} a frame")
    exact = sum(bool(torch.equal(f, r)) for f, r in zip(frames, sync))
    worst = max(nrmse(r.cpu().numpy(), f.cpu().numpy())
                for f, r in zip(frames, sync))
    check(worst <= 1e-6, f"mesh streaming: NRMSE {worst:.3e} > 1e-6")
    print(f"[mesh] {RUNS} Quickstart frames through a StreamingSession on "
          f"the meshed Beamformer: launches {streamed}; against its "
          f"synchronous frames {exact} of {RUNS} bit for bit, NRMSE <= "
          f"{worst:.3e}")
    return {k: launches[k] + streamed[k] for k in kernels}


def stage_ms(run, stages, runs: int = RUNS):
    """``run(mark)`` ``runs`` times with the executor's stage clock (CUDA
    events at each stage's end); returns the last output and the median ms
    per stage, and its split as text."""
    from ogl_beamforming_tpu_torch.pipeline.executor import _StageClock
    rows = []
    for _ in range(runs):
        clock = _StageClock(torch.device("cuda", 0))
        out = run(clock.mark)
        rows.append([t * 1e3 for t in clock.seconds()])
    ms = np.median(rows, axis=0)
    return out, ms, " + ".join(f"{sd.kind.name} {t:.3f}"
                               for sd, t in zip(stages, ms))


def run_sharded(label, splan, plan, x, voxel, kernels, shards,
                smi_line) -> dict:
    """The unsharded ``plan`` on ``x`` (a warm-up and RUNS timed frames),
    then a warm-up of ``splan`` and RUNS frames with the launch counts set
    to 0 just before: each of ``kernels`` ``shards`` times a frame, the
    frame against the unsharded one (NRMSE 1e-5) with its peak within one
    voxel of ``voxel``.  Both timed stage by stage.  Returns the
    launches."""
    from ogl_beamforming_tpu_torch.kernels import build
    stages = plan.descriptor.stages
    plan(x)
    ref, single, single_split = stage_ms(lambda m: plan(x, mark=m), stages)
    ref = ref.cpu().numpy()
    splan(x)
    torch.cuda.synchronize()
    build.LAUNCHES.clear()
    out, sharded, split = stage_ms(lambda m: splan(x, mark=m), stages)
    launches = launches_since_clear(kernels)
    check(launches == {k: shards * RUNS for k in kernels},
          f"{label}: launches {launches} != {shards} a frame")
    img = out.cpu().numpy()
    err = nrmse(ref, img)
    check(err <= 1e-5, f"{label}: NRMSE {err:.3e} against unsharded > 1e-5")
    peak = peak_check(label, img, voxel)
    print(f"[mesh] {label}: launches {launches}; NRMSE {err:.3e} against "
          f"the unsharded plan; peak {peak} vs target {tuple(voxel)}; "
          f"{sharded.sum():.3f} ms/frame sharded ({split}), "
          f"{single.sum():.3f} unsharded ({single_split}; median CUDA "
          f"events over {RUNS}); {smi_line}")
    return launches


def mesh_path_d(dev, smi_line) -> dict:
    """Path D (uFORCES 3D with coherency, 256 x 64 x 2048 int16 -> 128^3)
    on make_mesh_2d(2, 2) over cuda:0 against its unsharded plan."""
    from ogl_beamforming_tpu_torch.parallel.sharding import (make_mesh_2d,
                                                             shard_plan_2d)
    params, pipe, sparse, raw, voxel = uforces()
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind, sparse=sparse)
    b = bf._block(0)
    plan = bf._ensure_plan(b)
    x = torch.from_numpy(bf._prepare(b, raw)).to(dev)
    splan = shard_plan_2d(plan, make_mesh_2d(2, 2, [dev] * 4))
    return run_sharded("path D on 2 channels x 2 slabs", splan, plan, x,
                       voxel, ("decode_hadamard", "das_forces"), 4, smi_line)


def synthesize_tpw_frame(params, fv, target) -> np.ndarray:
    """A point target under steered plane waves (``fv``: angle in degrees,
    infinite depth) from the columns, received by column ``c`` at ``x = c
    p``: ``x sin(angle) + z cos(angle)`` plus the receive leg, a cosine
    burst at the demodulation frequency; float32 (C, A, S)."""
    c, s = params.channel_count, params.sample_count
    fs, sos = params.sampling_frequency, params.speed_of_sound
    f0 = params.demodulation_frequency
    x, _, z = target
    angle = np.radians(fv[:, 0].astype(np.float64))
    tx = x * np.sin(angle) + z * np.cos(angle)
    rx = np.sqrt((x - np.arange(c) * float(params.xdc_element_pitch[0])) ** 2
                 + z * z)
    delay = ((rx[:, None] + tx[None, :]) / sos).astype(np.float32)
    out = np.empty((c, len(fv), s), np.float32)
    t = (np.arange(s) / fs).astype(np.float32)
    for a in range(len(fv)):
        arg = t[None, :] - delay[:, a, None]
        env = np.exp(-0.5 * (arg / np.float32(2 / f0 / 4)) ** 2)
        out[:, a] = env * np.cos(np.float32(2 * np.pi * f0) * arg)
    return out


def tpw_case():
    """plane_wave_2d as RCA_TPW over TPW_ANGLES steered angles: its
    parameters, pipeline, focal vectors, the target's voxel and the
    float32 (256, 8, 4096) point-target frame."""
    from ogl_beamforming_tpu_torch import AcquisitionKind
    from ogl_beamforming_tpu_torch.models import presets

    params, pipe = presets.plane_wave_2d()
    a = TPW_ANGLES
    params.acquisition_kind = AcquisitionKind.RCA_TPW
    params.acquisition_count = a
    params.single_focus = 0
    angles = np.linspace(-8, 8, a).astype(np.float32)
    fv = np.stack([angles, np.full(a, np.inf, np.float32)], axis=1)
    # under the aperture (0 .. 51 mm) at 60 mm: voxel (362, 330) of the
    # -60 .. 60 mm x 10 .. 165 mm grid
    voxel = (362, 330, 0)
    rf = synthesize_tpw_frame(params, fv, target_world(params, voxel))
    return params, pipe, fv, voxel, rf


def mesh_tpw(dev, smi_line) -> dict:
    """plane_wave_2d as RCA_TPW over TPW_ANGLES steered angles (float32
    256 x 8 x 4096 -> 512 x 1024) on make_mesh_tx(2, 4) over cuda:0
    against its unsharded plan."""
    from ogl_beamforming_tpu_torch.parallel.sharding import (make_mesh_tx,
                                                             shard_plan_tx)
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan

    params, pipe, fv, voxel, rf = tpw_case()
    a = TPW_ANGLES
    plan = build_plan(params, pipe, {}, focal_vectors=fv, device=dev)
    x = torch.from_numpy(rf).to(dev)
    splan = shard_plan_tx(plan, make_mesh_tx(2, 4, [dev] * 8))
    return run_sharded(f"RCA_TPW, {a} angles, on 2 channels x 4 transmits",
                       splan, plan, x, voxel, ("das_rca",), 8, smi_line)


def mesh_worker(rank: int, world: int, port: str, rf_path: str,
                out_path: str) -> None:
    """One gloo rank of the two-process check (``python3 chip_smoke.py
    --mesh-worker RANK WORLD PORT RF OUT``): the Quickstart's plan on
    cuda:0, this rank's local_channel_slice rows of the frame in ``rf_path``
    (read from a memory map: no rank reads the other's rows) fed to its
    position of make_host_mesh (one a rank, both on cuda:0), channels
    summed by all_reduce; then a channels x slabs mesh whose slab r is rank
    r's (whole frames), slabs brought together by all_gather.  Rank 0 saves
    both gathered frames to ``out_path``."""
    from ogl_beamforming_tpu_torch.kernels import build
    from ogl_beamforming_tpu_torch.parallel import multihost, sharding
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    multihost.init_multihost(f"localhost:{port}", world, rank,
                             backend="gloo", timeout=MESH_TIMEOUT)
    try:
        params, pipe, _ = quickstart_parameters()
        plan = build_plan(params, pipe, {}, device=dev)
        rf = np.load(rf_path, mmap_mode="r")
        local = np.array(rf[multihost.local_channel_slice(rf.shape[0])])
        mesh = multihost.make_host_mesh(devices=[dev])
        splan = sharding.shard_plan(plan, mesh)
        splan(multihost.feed_rf(local, mesh))
        torch.cuda.synchronize()
        build.LAUNCHES.clear()
        t0 = time.perf_counter()
        for _ in range(RUNS):
            out = splan(multihost.feed_rf(local, mesh))
            frame = multihost.gathered_frame(out)
        wall = (time.perf_counter() - t0) * 1e3 / RUNS
        launches = dict(build.LAUNCHES)

        whole = torch.from_numpy(np.array(rf)).to(dev)
        grid = [(r, dev) for r in range(world)]
        slabs = sharding.Mesh(sharding.positions_array(grid, (1, world)),
                              (sharding.CHANNEL_AXIS, sharding.SLAB_AXIS),
                              dist.group.WORLD)
        splan2 = sharding.shard_plan_2d(plan, slabs)
        check(splan2.gathers_slabs, "the slab mesh does not take all_gather")
        slab_frame = multihost.gathered_frame(splan2(whole))
        print(f"[mesh rank {rank}] {local.shape[0]} channel rows fed; "
              f"launches over {RUNS} frames {launches}; {wall:.3f} ms/frame "
              f"(host clock, feed to gathered frame, gloo all_reduce on "
              f"CUDA tensors)", flush=True)
        if rank == 0:
            np.savez(out_path, channels=frame, slabs=slab_frame)
    finally:
        dist.destroy_process_group()


def mesh_ranks(dev, smi_line) -> None:
    """Two gloo ranks of this script on cuda:0 (MESH_WORKER), joined under
    MESH_TIMEOUT and killed if they outlive it; each frame rank 0 gathers
    against the single-process unsharded frame (NRMSE 1e-5), its peak
    within one voxel."""
    import socket
    import tempfile

    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan

    params, pipe, raw, voxel = quickstart()
    c, a, s = params.channel_count, params.acquisition_count, \
        params.sample_count
    rf = raw.reshape(c, a, s)
    ref = build_plan(params, pipe, {}, device=dev)(
        torch.from_numpy(rf).to(dev)).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
        sock.close()
        rf_path, out_path = f"{tmp}/rf.npy", f"{tmp}/out.npz"
        np.save(rf_path, rf)
        procs = [subprocess.Popen(
            [sys.executable, __file__, MESH_WORKER, str(r), "2", port,
             rf_path, out_path], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=MESH_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, o) in enumerate(zip(procs, outs)):
            check(p.returncode == 0,
                  f"mesh rank {r} exited {p.returncode}:\n{o[-4000:]}")
            print(o.strip())
        got = np.load(out_path)
        for name in ("channels", "slabs"):
            err = nrmse(ref, got[name])
            check(err <= 1e-5, f"two ranks ({name}): NRMSE {err:.3e} > 1e-5")
            peak = peak_check(f"two ranks ({name})", got[name], voxel)
            print(f"[mesh] two gloo ranks on {dev} ({name}): rank 0's "
                  f"gathered frame against the single-process unsharded "
                  f"frame NRMSE {err:.3e}, peak {peak}; {smi_line}")


def mesh_entry_points(dev) -> dict:
    """entry.dryrun_multichip(8) and (3) on cuda:0, then the multihost
    feeders example (single host, full width) in a subprocess."""
    from ogl_beamforming_tpu_torch import entry
    from ogl_beamforming_tpu_torch.kernels import build
    build.LAUNCHES.clear()
    entry.dryrun_multichip(8)
    entry.dryrun_multichip(3)
    launches = dict(build.LAUNCHES)
    want = {"decode_hadamard": 8 + 3, "das_forces": 8 + 3, "das_rca": 8}
    check(launches == want, f"dryrun_multichip: launches {launches}")
    proc = subprocess.run(
        [sys.executable, "-m",
         "ogl_beamforming_tpu_torch.examples.multihost_feeders",
         "--frames", "2"], capture_output=True, text=True,
        timeout=MESH_TIMEOUT)
    check(proc.returncode == 0 and "frame 1:" in proc.stdout,
          f"multihost_feeders exited {proc.returncode}:\n"
          f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    print(f"[mesh] dryrun_multichip(8) and (3) on {dev}: launches "
          f"{launches}; multihost_feeders --frames 2: "
          + "; ".join(proc.stdout.strip().splitlines()))
    return launches


def phase_mesh(dev, smi_line) -> dict:
    """Phase 12; returns its kernel launches by table row."""
    t0 = time.perf_counter()
    quick = mesh_quickstart(dev, smi_line)
    path_d = mesh_path_d(dev, smi_line)
    tpw = mesh_tpw(dev, smi_line)
    mesh_ranks(dev, smi_line)
    entry_launches = mesh_entry_points(dev)
    counts = {
        "decode_hadamard": quick["decode_hadamard"]
        + path_d["decode_hadamard"] + entry_launches["decode_hadamard"],
        "das_forces": quick["das_forces"] + entry_launches["das_forces"],
        "das_forces_coh3d": path_d["das_forces"],
        "das_rca": tpw["das_rca"] + entry_launches["das_rca"]}
    print(f"[mesh] phase 12 launches by table row {counts} (the two ranks' "
          f"and the example's are their processes'); phase took "
          f"{time.perf_counter() - t0:.1f} s; one card: its positions run "
          f"one after another")
    return counts


# ---------------------------------------------------------------------------
# Phase 13: api.  The JAX package's remaining public API on the port at the
# Quickstart's full width (pipeline/plan.py's compiled_stage_fns and
# das_backend, the executor's voxel_block, profile and stage_timing,
# parallel/sharding.py's shard_rf_tx), and a plan on a card that is not the
# current one (roadmap C3) where the machine has two.
# ---------------------------------------------------------------------------

def prepared(bf, raw) -> torch.Tensor:
    """``raw`` as ``bf``'s block 0 prepares it (mapping, contrast), on its
    device: the canonical (C, A, S_wire) frame a plan takes."""
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
    return torch.from_numpy(Beamformer._prepare(bf._blocks[0], raw)).to(
        bf.device)


def api_quickstart(dev, smi_line) -> dict:
    """The Quickstart through ``compiled_stage_fns`` chained,
    ``compose_stages``, ``Beamformer.push_data_with_compute`` and a plan
    built with ``das_backend="cuda"`` (every frame bit for bit the
    ``das_backend="auto"`` plan's), then ``Beamformer(voxel_block=4096,
    profile=True, stage_timing="device")`` (the same frame, its stats row
    filled).  Returns the frame and the prepared raw frame."""
    from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
    from ogl_beamforming_tpu_torch.pipeline.plan import (build_plan,
                                                         compiled_stage_fns,
                                                         compose_stages)
    params, pipe, raw, voxel = quickstart()
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    bf.warmup()
    x = prepared(bf, raw)
    kernels = ("decode_hadamard", "das_forces")
    auto = build_plan(params, pipe, {}, device=dev)
    cuda = build_plan(params, pipe, {}, das_backend="cuda", device=dev)
    fns = compiled_stage_fns(auto.descriptor)
    torch.cuda.synchronize()
    launches_before = launches_since_clear(kernels)
    composed = compose_stages(auto.descriptor, x, auto.dyn)
    chained = _chain(fns, x, auto.dyn)
    pushed = bf.push_data_with_compute(raw).data
    by_cuda = cuda(x)
    launches = {k: n - launches_before[k]
                for k, n in launches_since_clear(kernels).items()}
    check(launches == {k: 4 for k in kernels},
          f"api: launches {launches} != 4 of each kernel (every route "
          f"through K2 and K1)")
    check(torch.equal(chained, composed),
          "api: compiled_stage_fns chained != compose_stages")
    check(torch.equal(pushed, composed),
          "api: push_data_with_compute != compose_stages")
    check(torch.equal(by_cuda, composed),
          "api: das_backend='cuda' != das_backend='auto'")
    peak = peak_check("api quickstart", composed.cpu().numpy(), voxel)
    chained_ms = median_ms(lambda: _chain(fns, x, auto.dyn), RUNS)
    composed_ms = median_ms(lambda: compose_stages(auto.descriptor, x,
                                                   auto.dyn), RUNS)

    prof = Beamformer(device=dev, voxel_block=4096, profile=True,
                      stage_timing="device")
    prof.push_parameters(params)
    prof.push_pipeline(pipe.shaders, pipe.data_kind)
    out = prof.push_data_with_compute(raw).data
    check(torch.equal(out, composed),
          "api: Beamformer(voxel_block=4096, profile=True, "
          "stage_timing='device') frame != compose_stages")
    row = prof.compute_timings().times[0][:len(auto.descriptor.stages)]
    check(bool((row > 0).all()), f"api: profile stats row {row}")
    print(f"[api] Quickstart (128 x 128 x 4096 int16 -> 512 x 1024): "
          f"compiled_stage_fns chained, compose_stages, "
          f"push_data_with_compute and das_backend='cuda' bit-equal to "
          f"das_backend='auto'; launches {launches}; peak {peak} vs target "
          f"{voxel}; device ms/frame chained {chained_ms:.3f}, composed "
          f"{composed_ms:.3f} (median CUDA events over {RUNS}); "
          f"Beamformer(voxel_block=4096, profile=True, "
          f"stage_timing='device') the same frame, stats row "
          f"{' + '.join(f'{t * 1e3:.3f}' for t in row)} ms; {smi_line}")
    return composed, x


def _chain(fns, x, dyn):
    """``compiled_stage_fns``' callables ``fns`` in turn on ``x``."""
    for fn in fns:
        x = fn(x, dyn)
    return x


def api_plain_das(dev, smi_line) -> dict:
    """Path A with ``das_backend="xla"``: the plain twin on the card, no
    K1 launch, within the twin bound (NRMSE 1e-4) of K1's frame."""
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    params, pipe, raw, voxel = plane_wave()
    bf = beamformer(dev, params, pipe.shaders, pipe.data_kind)
    x = prepared(bf, raw)
    k1 = build_plan(params, pipe, {}, device=dev)
    plain = build_plan(params, pipe, {}, das_backend="xla", device=dev)
    st = next(sd.das for sd in plain.descriptor.stages if sd.das)
    check(st.backend == "torch", f"api: das_backend='xla' ran {st.backend}")
    ref = k1(x)
    torch.cuda.synchronize()
    before = launches_since_clear(("das_rca",))["das_rca"]
    t0 = time.perf_counter()
    out = plain(x)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check(launches_since_clear(("das_rca",))["das_rca"] == before,
          "api: das_backend='xla' launched K1")
    err = nrmse(ref.cpu().numpy(), out.cpu().numpy())
    check(err <= 1e-4, f"api: path A plain twin on the card NRMSE "
          f"{err:.3e} against K1 > 1e-4")
    peak = peak_check("api path A plain", out.cpu().numpy(), voxel)
    k1_ms = median_ms(lambda: k1(x), RUNS)
    print(f"[api] path A with das_backend='xla' (the plain twin on "
          f"{dev}, {st.voxel_block} voxels a block): NRMSE {err:.3e} "
          f"against K1, no K1 launch, peak {peak} vs target {voxel}; "
          f"{plain_s * 1e3:.1f} ms (host clock, one frame) against K1's "
          f"{k1_ms:.3f} ms/frame (median CUDA events); {smi_line}")


def api_tpw_placed(dev, smi_line) -> dict:
    """The 8-angle TPW frame placed by ``shard_rf_tx`` on
    ``make_mesh_tx(2, 4)`` of ``dev`` (each position holds its channel and
    transmit block only) through ``shard_plan_tx``: within 1e-6 of the
    unsharded frame."""
    from ogl_beamforming_tpu_torch.parallel.sharding import (make_mesh_tx,
                                                             shard_plan_tx,
                                                             shard_rf_tx)
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    params, pipe, fv, voxel, rf = tpw_case()
    plan = build_plan(params, pipe, {}, focal_vectors=fv, device=dev)
    x = torch.from_numpy(rf).to(dev)
    mesh = make_mesh_tx(2, 4, [dev] * 8)
    ref = plan(x)
    placed = shard_rf_tx(x, mesh)
    shapes = {tuple(b.shape) for b in placed.blocks.values()}
    check(shapes == {(rf.shape[0] // 2, TPW_ANGLES // 4, rf.shape[2])},
          f"api: shard_rf_tx blocks {shapes}")
    torch.cuda.synchronize()
    before = launches_since_clear(("das_rca",))["das_rca"]
    out = shard_plan_tx(plan, mesh)(placed)
    launched = launches_since_clear(("das_rca",))["das_rca"] - before
    check(launched == 8, f"api: shard_rf_tx frame launched K1 {launched} "
          f"times, not 8")
    err = nrmse(ref.cpu().numpy(), out.cpu().numpy())
    check(err <= 1e-6, f"api: shard_rf_tx frame NRMSE {err:.3e} against "
          f"the unsharded frame > 1e-6")
    peak = peak_check("api tpw placed", out.cpu().numpy(), voxel)
    print(f"[api] RCA_TPW, {TPW_ANGLES} angles, placed by shard_rf_tx on 2 "
          f"channels x 4 transmits of {dev} (blocks {shapes.pop()}): NRMSE "
          f"{err:.3e} against the unsharded frame, peak {peak} vs target "
          f"{voxel}; {smi_line}")


def api_other_card(x, frame) -> dict:
    """With two cards or more: the Quickstart's plan built on cuda:1 and
    run while cuda:0 is current gives cuda:0's frame bit for bit, and both
    cards synchronize without an error."""
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[api] a plan on cuda:1 while cuda:0 is current needs two "
              f"cards; this machine has {n}")
        return
    params, pipe, _ = quickstart_parameters()
    other = torch.device("cuda", 1)
    with torch.cuda.device(0):
        out = build_plan(params, pipe, {}, device=other)(x.to(other))
        check(torch.cuda.current_device() == 0,
              "api: the launchers left another card current")
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
    check(out.device == other, f"api: frame on {out.device}")
    check(torch.equal(out.cpu(), frame.cpu()),
          "api: the plan on cuda:1 (cuda:0 current) != cuda:0's frame")
    print(f"[api] the Quickstart plan on cuda:1 while cuda:0 is current: "
          f"bit-equal to cuda:0's frame, both cards synchronized without "
          f"an error ({n} cards)")


def phase_api(dev, smi_line) -> dict:
    """Phase 13; returns its kernel launches by table row."""
    from ogl_beamforming_tpu_torch.kernels import build
    t0 = time.perf_counter()
    before = dict(build.LAUNCHES)
    frame, x = api_quickstart(dev, smi_line)
    api_plain_das(dev, smi_line)
    api_tpw_placed(dev, smi_line)
    api_other_card(x, frame)
    # the rows of the Quickstart's int16 decode and real FORCES DAS, and of
    # the RCA IQ DAS (path A and the TPW frames)
    counts = {k: build.LAUNCHES[k] - before.get(k, 0)
              for k in ("decode_hadamard", "das_forces", "das_rca")}
    print(f"[api] phase 13 launches by table row {counts}; phase took "
          f"{time.perf_counter() - t0:.1f} s")
    return counts


def print_lost(phases: str, caught: list) -> None:
    """The traces of ``phases`` that lack a kernel event their call launched
    (utils/profiling.device_time warns of each, naming the kernel and the
    call; ``caught`` holds the warnings since the last call, and is
    emptied), or that none did: roadmap item C2.  Other warnings are shown
    as they would have been."""
    from ogl_beamforming_tpu_torch.utils.profiling import LostKernelEvents
    lines = []
    for w in caught:
        if issubclass(w.category, LostKernelEvents):
            lines.append(str(w.message))
        else:
            sys.stderr.write(warnings.formatwarning(
                w.message, w.category, w.filename, w.lineno))
    caught.clear()
    print(f"[trace] phases {phases}: " + (
        f"{len(lines)} traces lack a launched kernel's event: "
        + "; ".join(lines) if lines else
        "every launch of the port's kernels in a trace has its event"))


def main() -> None:
    name, smi_line = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    from ogl_beamforming_tpu_torch.utils.profiling import LostKernelEvents
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", LostKernelEvents)
        rows = phase_kernels(dev) + phase_kernels_volumes(dev)
        fir_launches = phase_canary(dev)
        launches = phase_main(dev)
        launches.update(phase_main_rca(dev))
        demod = phase_main_demod(dev)
        launches["demodulate"] = demod["demodulate"]
        launches["das_forces_iq"] = demod["das_forces"]
        launches["decode_hadamard_f32"] = demod["decode_hadamard"]
        launches["fir"] = fir_launches["fir"]
        launches["das_hercules"] = phase_main_hercules(dev)["das_hercules"]
        launches["das_forces_coh3d"] = phase_main_uforces(dev)["das_forces"]
        launches["das_rca_fb4"] = phase_main_batch(dev)["das_rca_fb4"]
        for row in rows:
            row["launches"] = launches[row["name"]]
        print_lost("1-5", caught)
        rows += phase_micro(dev, smi_line)
        print_lost("6", caught)
        phase_trace(dev, caught)
        phase_filter_traces()
        print_lost("7", caught)
        streamed = phase_stream(dev, smi_line)
        print_lost("8", caught)
    phase_serve(dev, smi_line, streamed)
    zbp_launches = phase_zbp(dev, smi_line)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} never launched on its path")
        row["phase10_launches"] = zbp_launches.get(row["name"], 0)
    phase_tune(dev, smi_line)
    mesh_launches = phase_mesh(dev, smi_line)
    api_launches = phase_api(dev, smi_line)
    for row in rows:
        row["phase12_launches"] = mesh_launches.get(row["name"], 0)
        row["phase13_launches"] = api_launches.get(row["name"], 0)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [MESH_WORKER]:
        mesh_worker(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
    else:
        main()
