"""Hopper ports of the JAX package's Pallas microbenchmarks (``experiments/``).

Each module keeps its TPU counterpart's name and holds the plain-torch
version of every kernel body, a wrapper that launches the CUDA kernel for a
CUDA tensor (``csrc/micro_*.cu``) and takes the plain version only for a CPU
tensor, and a ``main(device="cuda")`` that prints one JSON line per variant
and raises ``RuntimeError`` without a GPU.  Run one on the card with

    python -m ogl_beamforming_tpu_torch.experiments.gather_micro3

Timing (this module): CUDA-event time per launch, best of a few runs of
several launches, and the least-squares slope of time over a swept
repetition count, in which constant terms (launch, prologue, store) cancel.
A launch shorter than its enqueue is timed from the profiler's kernel
durations instead (:func:`traced_ms`).
A TPU grid ran its steps in order on one core; here the steps run side by
side on every SM (a block each, or K5's and K6's units spread over a
persistent grid), so a time converts to cycles per unit of work as ``time *
SM clock * SMs / work``.
"""

from __future__ import annotations

import os
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

LANE = 128
WARP = 32


def launch_ms(fn, iters: int = 20, repeats: int = 3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``iters`` calls,
    best of ``repeats``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def traced_ms(fn, iters: int = 20, kernel: str | None = None) -> float:
    """Milliseconds of kernel time per call of ``fn`` from a
    ``torch.profiler`` trace of ``iters`` calls (``utils.profiling``): the
    device's own durations, without the host's launch gaps that a CUDA-event
    time of launches shorter than their enqueue holds.  ``kernel``: count
    only the kernels whose name holds it (raises if the trace has none),
    over the calls whose events the trace holds: a trace that lost some
    (``DeviceProfile.lost``) gives the mean of the others, not a share of
    ``iters`` too small."""
    from ..utils.profiling import device_time

    def run():
        for _ in range(iters):
            out = fn()
        return out

    run.__qualname__ = f"{iters} calls of {getattr(fn, '__qualname__', fn)}"
    prof = device_time(run)
    if kernel is None:
        return prof.module_seconds * 1e3 / iters
    times = [t for name, _, t in prof.kernels if kernel in name]
    if not times:
        raise RuntimeError(f"no {kernel} kernel events in the trace"
                           + "".join(f"; {line}" for line in prof.lost))
    return sum(times) * 1e3 / min(len(times), iters)


def call_times(fns: dict, runs: int = 21) -> dict:
    """{name: [ms]} of ``runs`` single calls of each of ``fns`` ({name:
    fn}), each call between two CUDA events and synchronised, the functions
    in turns so that the host's drift falls on all alike; one warm-up call
    each first.  A single call's time holds its enqueue."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return times


def three_ways_ms(fn, iters: int = 20) -> dict:
    """``fn`` timed by the median of single calls (:func:`call_times`, with
    the enqueue), per call of ``iters`` back to back (:func:`launch_ms`) and
    by its kernels' time in a profiler trace (:func:`traced_ms`), in ms."""
    return {"call_ms": statistics.median(call_times({0: fn})[0]),
            "launch_ms": launch_ms(fn, iters),
            "trace_ms": traced_ms(fn, iters)}


def host_us(fn, calls: int = 200, repeats: int = 5) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls that are
    not waited for, best of ``repeats``: what the enqueue costs the host
    (few enough calls that the launch queue does not fill and hold the host
    back)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def slope(xs, ys) -> float:
    """Least-squares slope of ``ys`` over ``xs``."""
    return float(np.polyfit(np.asarray(xs, np.float64),
                            np.asarray(ys, np.float64), 1)[0])


def require_gpu(device) -> torch.device:
    """The CUDA device a microbenchmark measures; ``RuntimeError`` without
    one (``utils.device.resolve_device``), or for any other device."""
    from ..utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"a microbenchmark measures the GPU, got {dev}")
    return dev


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them, and
    its SM clock now, for the record beside every time."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return {"card": out.stdout.strip().splitlines()[0],
            "sm_clock_mhz": sm_clock_mhz()}


def sm_count(device=None) -> int:
    return torch.cuda.get_device_properties(
        device if device is not None else 0).multi_processor_count


def sm_clock_mhz() -> float:
    """The SM clock now, as ``nvidia-smi --query-gpu=clocks.sm`` reads it
    (MHz, first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi --query-gpu=
    clocks.max.sm`` reads it (MHz, first card): the rate a bound assumes."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def compile_source(text: str, tag: str, entry: str):
    """``text`` (a ``csrc`` source whose C entry point ``entry`` has the
    library's signature) compiled alone with the library's nvcc flags into
    a library of its own under ``_build/``, named by ``tag`` and its hash,
    and loaded: the A/B harnesses' other sources and ablations."""
    import ctypes
    import hashlib

    from ..kernels import build
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    out = build.BUILD_DIR / f"{entry}_{tag}_{digest}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared",
                               "-o", str(out), str(src)],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise build.KernelBuildError(f"nvcc {tag}:\n{proc.stdout}"
                                         f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return lib


def ab_sources(cu_name: str, others: list[str], ablations: dict) -> dict:
    """{label: source text}: the ``LABEL=PATH`` sources of ``others``, this
    tree's ``csrc/<cu_name>`` ("change"), and each ablation of it
    (``{name: [(text of the source, its replacement)]}``), every replaced
    text found once in the source."""
    from ..kernels import build
    mine = (build.CSRC_DIR / cu_name).read_text()
    out = {}
    for other in others:
        label, path = other.split("=", 1)
        out[label] = Path(path).read_text()
    out["change"] = mine
    for name, edits in ablations.items():
        text = mine
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"ablation {name}: {old!r} not once in "
                                 f"{cu_name}")
            text = text.replace(old, new)
        out[name] = text
    return out


GATHER_THREADS = 1024   # threads a block of gather_kernel (K7)
GATHER_CHAINS = 8       # repetitions in one turn of its loop body
FLOOR_VARIANTS = 12     # ids of gather_floor_kernel (K5, K6): 0 .. 11
FLOOR_WARPS = 8         # warps a block of gather_floor_kernel
FLOOR_UNITS = 16        # its units a step: a unit is a warp's 128 elements


def gather_work(counts: dict, reps: int, steps: int,
                grid: int | None = None) -> dict:
    """The warp-wide instructions that one launch of a gather kernel
    executes, by kind, from the static counts of its instantiation
    (``kernels.sass.gather_loops``), each repetition loop turning ``reps /
    step`` times (step GATHER_CHAINS where the counts hold none).
    ``gather_kernel`` (K7; counts without a unit loop): ``steps`` blocks of
    GATHER_THREADS threads, each turning the repetition loop once and
    running the code outside every loop once.  ``gather_floor_kernel`` (K5,
    K6): ``grid`` blocks of FLOOR_WARPS warps, each running the code
    outside every loop once, and ``steps * FLOOR_UNITS`` units (a row of
    a step, one warp's), each running the unit loop's own code and the
    repetition loop once."""
    turns = reps // (counts["step"] or GATHER_CHAINS)
    if counts.get("unit") is None:
        warps = steps * GATHER_THREADS // WARP
        return {k: warps * (counts["outside"][k] + turns * v)
                for k, v in counts["body"].items()}
    if grid is None:
        raise ValueError("gather_floor_kernel's work needs its grid")
    warps, units = grid * FLOOR_WARPS, steps * FLOOR_UNITS
    return {k: warps * counts["outside"][k]
            + units * (counts["unit"][k] + turns * v)
            for k, v in counts["body"].items()}


def gather_grid(variant_id: int, smem: bool, steps: int) -> tuple[int, int]:
    """(blocks a SM holds, grid) of the launch ``micro_gather`` makes for
    K5/K6 ``variant_id`` (below FLOOR_VARIANTS) at ``steps`` on the current
    card, without launching (``micro_gather_grid``)."""
    import ctypes

    from ..kernels import build
    per_sm, grid = ctypes.c_int(0), ctypes.c_int(0)
    code = build.library().micro_gather_grid(
        variant_id, int(smem), steps, ctypes.byref(per_sm),
        ctypes.byref(grid))
    build.check("micro_gather_grid", code)
    return per_sm.value, grid.value


def cycles_per_warp_op(seconds: float, clock_mhz: float, sms: int,
                       warp_ops: float) -> float:
    """SM cycles per warp-wide operation when ``warp_ops`` of them, spread
    over ``sms`` SMs running side by side, take ``seconds``."""
    return seconds * clock_mhz * 1e6 * sms / warp_ops


def hi16(v: torch.Tensor) -> torch.Tensor:
    """``v >> 16`` of int32 ``v`` (arithmetic), as float32."""
    return (v >> 16).to(torch.float32)


def lo16(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of int32 ``v`` sign-extended (the TPU files'
    ``(v << 16) >> 16``, written without a signed left shift), as
    float32."""
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.float32)


def expand_steps(steps: int, *tiles: torch.Tensor):
    """Each (rows, LANE) tile as (steps, rows, LANE): the grid steps of a
    TPU microbenchmark all recompute the same tile."""
    return [t.expand((steps,) + tuple(t.shape)) for t in tiles]


def check_tile(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_cuda(*tensors: torch.Tensor) -> torch.device:
    """The one CUDA device all ``tensors`` lie on; raises otherwise."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the kernel needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    return dev


# ---------------------------------------------------------------------------
# The gather microbenchmarks (K5-K7, and the gather bundle of K8-K9):
# csrc/micro_gather.cu, entry points micro_gather and micro_gather_hermite.

ROWS = 16


def check_gather_args(src, src2, idx, w, int_src: bool) -> None:
    """Shapes, types, one device, 16-byte aligned tiles (the K5/K6 kernel
    reads them as 16-byte words and stages them by bulk copy), and an index
    tile inside the source row for every offset the variants add before
    masking (0 .. LANE - 4): the kernels read the tile at these indices.
    Reads ``idx`` back (a synchronise), so a timing loop checks once and
    launches many."""
    dtype = torch.int32 if int_src else torch.float32
    check_tile("src", src, (ROWS, LANE), dtype)
    check_tile("src2", src2, (ROWS, LANE), dtype)
    check_tile("w", w, (ROWS, LANE), torch.float32)
    check_tile("idx", idx, (ROWS, LANE), torch.int32)
    check_cuda(src, src2, idx, w)
    for name, t in (("src", src), ("src2", src2), ("w", w), ("idx", idx)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lo, hi = int(idx.min()), int(idx.max())
    if lo < 0 or hi > LANE - 4:
        raise ValueError(f"idx must lie in [0, {LANE - 4}], got [{lo}, {hi}]")


def launch_gather(variant_id: int, src, src2, idx, w, reps: int, steps: int,
                  smem: bool) -> torch.Tensor:
    """One launch of ``micro_gather``: ``steps`` times the (ROWS, LANE)
    tile of variant ``variant_id`` over ``reps`` repetitions, gathering from
    shared memory (``smem``) or through ``__ldg`` from device memory; K5
    and K6 (ids below FLOOR_VARIANTS) on a persistent grid
    (:func:`gather_grid`), K7 a block a step.  Arguments checked by
    :func:`check_gather_args`."""
    from ..kernels import build
    if reps <= 0 or reps % 8 or steps <= 0:
        raise ValueError(f"reps must be a positive multiple of 8 and steps "
                         f"positive, got {reps}, {steps}")
    out = torch.empty((ROWS, LANE), dtype=torch.float32, device=src.device)
    code = build.library().micro_gather(
        variant_id, int(smem), src.data_ptr(), src2.data_ptr(),
        idx.data_ptr(), w.data_ptr(), out.data_ptr(), reps, steps,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check("micro_gather", code)
    build.count_launch("micro_gather", "gather_floor_kernel"
                       if variant_id < FLOOR_VARIANTS else "gather_kernel")
    return out


def launch_gather_hermite(k8: bool, src, src2, idx, w, units: int,
                          steps: int, smem: bool) -> torch.Tensor:
    """One launch of ``micro_gather_hermite``: the DAS kernel's cubic tap
    bundle over ``units`` units per block (K8's form with ``k8``, else
    K9's); arguments checked by :func:`check_gather_args`."""
    from ..kernels import build
    if units <= 0 or units % 2 or steps <= 0:
        raise ValueError(f"units must be a positive even count and steps "
                         f"positive, got {units}, {steps}")
    out = torch.empty((ROWS, LANE), dtype=torch.float32, device=src.device)
    code = build.library().micro_gather_hermite(
        int(k8), int(smem), src.data_ptr(), src2.data_ptr(), idx.data_ptr(),
        w.data_ptr(), out.data_ptr(), units, steps,
        torch.cuda.current_stream(src.device).cuda_stream)
    build.check("micro_gather_hermite", code)
    build.count_launch("micro_gather", "hermite_kernel")
    return out


def hermite_bundle(acc, idx, w, src, src2, off, bcast: bool):
    """The plain DAS cubic tap bundle, as ``gather_hermite`` writes it:
    index ``idx + off``, kept if inside the row, two int32 gathers (value
    and slope planes) at it, each unpacked into its int16 halves and
    weighted.  Tensors (steps, ROWS, LANE); ``bcast`` gathers row 0."""
    rr = idx + off
    sel = (rr >= 0) & (rr < LANE)           # the unsigned compare rr < LANE
    rc = rr & (LANE - 1)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    wp = torch.where(sel, w, zero)
    wm = torch.where(sel, w * 0.5, zero)
    if bcast:
        src, src2 = (s[:, :1].expand_as(s) for s in (src, src2))
    vp = torch.gather(src, -1, rc)
    vm = torch.gather(src2, -1, rc)
    return acc + wp * hi16(vp) + wm * hi16(vm) + wp * lo16(vp) + wm * lo16(vm)


# ---------------------------------------------------------------------------
# The one-hot matrix-product interpolation (K8, K9): csrc/micro_onehot.cu.

ONEHOT_BATCHES = (8, 32, 128)


def onehot_offset(u: int, k8: bool) -> int:
    """Unit ``u``'s index offset: ``u & 3`` (K8) or ``4 u`` (K9)."""
    return (u & 3) if k8 else 4 * u


def onehot_weights(k, wt, u: int, k8: bool):
    """Plain torch: unit ``u``'s banded weight matrix in float32,
    ``W[..., s, v] = sum_t wt[..., t, v] [s == k[..., 0, v] + t + off(u)]``
    (t = 0..3, s = 0..127): (..., LANE, LANE) for (..., 8, LANE) ``k`` and
    ``wt``."""
    iota = torch.arange(LANE, dtype=torch.int32, device=wt.device)[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=wt.device)
    wmat = torch.zeros(wt.shape[:-2] + (LANE, LANE), dtype=torch.float32,
                       device=wt.device)
    for t in range(4):
        kk = k[..., 0:1, :] + (t + onehot_offset(u, k8))
        wmat = wmat + torch.where(iota == kk, wt[..., t:t + 1, :], zero)
    return wmat


def onehot_ref(rf, k, wt, units: int, k8: bool, steps: int = 1):
    """Plain torch: per unit the banded weight matrix
    (:func:`onehot_weights`) rounded to bf16, and ``acc += bf16(rf) @ W`` in
    float32, for ``steps`` grid steps at once (the last is returned)."""
    rf, k, wt = expand_steps(steps, rf, k, wt)
    rf_b = rf.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros(rf.shape, dtype=torch.float32, device=rf.device)
    for u in range(units):
        wmat = onehot_weights(k, wt, u, k8)
        acc = acc + torch.matmul(rf_b,
                                 wmat.to(torch.bfloat16).to(torch.float32))
    return acc[-1]


def check_onehot_args(rf, k, wt) -> None:
    """Shapes, types and one CUDA device; the kernel reads ``rf`` 16 bytes
    at a time."""
    if rf.dim() != 2 or rf.shape[0] not in ONEHOT_BATCHES:
        raise ValueError(f"rf must be (B, {LANE}) with B in {ONEHOT_BATCHES},"
                         f" got {tuple(rf.shape)}")
    check_tile("rf", rf, (rf.shape[0], LANE), torch.float32)
    check_tile("k", k, (8, LANE), torch.int32)
    check_tile("wt", wt, (8, LANE), torch.float32)
    check_cuda(rf, k, wt)
    if rf.data_ptr() % 16:
        raise ValueError("rf must be 16-byte aligned")


def launch_onehot(rf, k, wt, units: int, k8: bool, steps: int):
    """One launch of ``micro_onehot``: ``steps`` blocks, each the (B, LANE)
    tile over ``units`` units; arguments checked by
    :func:`check_onehot_args`."""
    from ..kernels import build
    if units <= 0 or steps <= 0:
        raise ValueError(f"units and steps must be positive, got {units}, "
                         f"{steps}")
    out = torch.empty(rf.shape, dtype=torch.float32, device=rf.device)
    code = build.library().micro_onehot(
        rf.shape[0], int(k8), rf.data_ptr(), k.data_ptr(), wt.data_ptr(),
        out.data_ptr(), units, steps,
        torch.cuda.current_stream(rf.device).cuda_stream)
    build.check("micro_onehot", code)
    build.count_launch("micro_onehot", "onehot_kernel")
    return out


def onehot(rf, k, wt, units: int, k8: bool, steps: int):
    """The one-hot tile: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if rf.is_cuda:
        check_onehot_args(rf, k, wt)
        return launch_onehot(rf, k, wt, units, k8, steps)
    if rf.device.type != "cpu":
        raise ValueError(f"no kernel for device {rf.device}")
    return onehot_ref(rf, k, wt, units, k8)


def onehot_product_ops(batch: int, units: int, steps: int) -> float:
    """bf16 tensor-core operations of the function: one dense (B, 128) @
    (128, 128) product per unit and block, 2 B 128^2."""
    return 2.0 * batch * LANE * LANE * units * steps


def onehot_band_writes(units: int, steps: int) -> float:
    """W's nonzeros, 4 x 128 per unit and block, each written once: the only
    CUDA-core work the function needs (how a kernel builds W is its own
    cost, not the function's)."""
    return 4.0 * LANE * units * steps


def onehot_library_operands(rf, k, wt, units: int, k8: bool, steps: int):
    """The operands of one bf16 ``torch.matmul`` that does the products
    alone, 2 B 128^2 x units x steps operations: A (steps B, units 128) is
    ``rf`` repeated along K over the units and along M over the steps, and
    B (units 128, 128) the units' W stacked along K."""
    a = rf.to(torch.bfloat16).repeat(steps, units)
    w = torch.cat([onehot_weights(k, wt, u, k8) for u in range(units)])
    return a, w.to(torch.bfloat16)


def gather_hermite_ref(src, src2, idx, w, units: int, k8: bool,
                       steps: int = 1) -> torch.Tensor:
    """Plain torch: the DAS cubic-tap bundle over ``units`` units (the TPU
    bodies ``gather_kernel`` of K8 and ``make_gather.kernel`` of K9): per
    unit two positions at offset ``pos + (u & 3)`` from row 0 (K8) or
    ``pos + 2 u`` from the own row (K9), into chain ``(2 u + pos) & 3``."""
    src, src2, idx, w = expand_steps(steps, src, src2, idx, w)
    accs = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)] * 4
    for u in range(units):
        for pos in range(2):
            off = pos + ((u & 3) if k8 else 2 * u)
            a = (u * 2 + pos) & 3
            accs[a] = hermite_bundle(accs[a], idx, w, src, src2, off,
                                     bcast=k8)
    return (accs[0] + accs[1] + accs[2] + accs[3])[-1]


def gather_hermite(src, src2, idx, w, units: int, k8: bool, steps: int,
                   smem: bool = True) -> torch.Tensor:
    """The cubic-tap bundle's tile: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if src.is_cuda:
        check_gather_args(src, src2, idx, w, True)
        return launch_gather_hermite(k8, src, src2, idx, w, units, steps,
                                     smem)
    if src.device.type != "cpu":
        raise ValueError(f"no kernel for device {src.device}")
    return gather_hermite_ref(src, src2, idx, w, units, k8)


# operations of the cubic-tap bundle per element and position: index add,
# compare, mask, two selects, w * 0.5, two gathers, two unpacks of five
# (two shifts, a shift, two converts), four multiplies and four adds
HERMITE_OPS_PER_POSITION = 26


def sass_loads(library_path) -> dict:
    """Static counts of shared-memory loads (``LDS``) and device-memory
    loads (``LDG``) in each gather kernel of the built library, from
    ``cuobjdump -sass``: ``{(variant id, shared memory): (LDS, LDG)}`` for
    ``gather_floor_kernel`` (K5, K6) and ``gather_kernel`` (K7) and
    ``{("hermite K8" | "hermite K9", shared memory): ...}`` for
    ``hermite_kernel``.  Counted over the whole function: where the
    compiler loads a gather once outside the repetition loop, it counts
    once."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    text = subprocess.run([tool, "-sass", str(library_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts: dict = {}
    key = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            m = re.search(r"gather_(?:floor_)?kernelILi(\d+)ELb([01])E",
                          name)
            h = re.search(r"hermite_kernelILb([01])ELb([01])E", name)
            if m:
                key = (int(m.group(1)), m.group(2) == "1")
            elif h:
                key = ("hermite K8" if h.group(1) == "1" else "hermite K9",
                       h.group(2) == "1")
            else:
                key = None
            if key is not None:
                counts[key] = [0, 0]
        elif key is not None:
            op = line.split("*/", 1)[-1].strip()
            if re.match(r"(@!?U?P\w+\s+)?LDS(\.|\s)", op):
                counts[key][0] += 1
            elif re.match(r"(@!?U?P\w+\s+)?LDG(\.|\s)", op):
                counts[key][1] += 1
    return {k: tuple(v) for k, v in counts.items()}
