"""Device-side timing from ``torch.profiler`` traces: the torch counterpart
of ``ogl_beamforming_tpu.utils.profiling``.

A host clock around a call that ends in a synchronise measures the launch
overheads and the host work of the call as well as the device's.  The
profiler's Chrome trace records each CUDA kernel's own start and duration
on the device (CUPTI), so its kernel events give the device busy time of a
window, and their names give the split by kernel.

``device_time(fn, *args)`` traces one call of ``fn`` and returns a
:class:`DeviceProfile`.  On the CPU a trace holds no kernel events and every
device time is 0.0.  A call that ran on the card but whose trace holds no
kernel events raises ``RuntimeError``: a missing trace is never read as a
time of 0.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from .device import sync

# Chrome-trace categories (torch.profiler / Kineto): device activity, the
# host calls that launch it, and record_function annotations
_KERNEL = "kernel"
_COPIES = ("gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cuda_runtime", "cuda_driver")
_ANNOTATION = "user_annotation"


@dataclass
class DeviceProfile:
    """One traced window's device-side timing."""

    module_seconds: float      # sum of the CUDA kernels' durations
    op_seconds: dict           # kernel name -> total seconds
    copy_seconds: float = 0.0  # device copies and memsets (not kernels)
    window_seconds: float = 0.0   # host clock of the traced window
    # (kernel name, host time of its launch in us or None, seconds), in
    # trace order; the launch comes from the runtime or driver call that
    # shares the kernel's correlation id
    kernels: list = field(default_factory=list)
    # host annotation (``torch.profiler.record_function``) name -> time, us
    annotations: dict = field(default_factory=dict)
    # (device start in us, seconds) of each kernel and of each copy or
    # memset, in trace order
    kernel_spans: list = field(default_factory=list)
    copy_spans: list = field(default_factory=list)

    @property
    def kernel_count(self) -> int:
        return len(self.kernels)

    @property
    def top_ops(self):
        return sorted(self.op_seconds.items(), key=lambda kv: -kv[1])

    @property
    def busy_share(self) -> float:
        """Kernel time over the host-clock window (0.0 without a window)."""
        return (self.module_seconds / self.window_seconds
                if self.window_seconds > 0 else 0.0)

    @property
    def copy_overlap_seconds(self) -> float:
        """Seconds of copy during which a kernel ran: each copy's time
        inside the union of the kernels' spans, summed over copies."""
        merged: list[list[float]] = []
        for start, dur in sorted(self.kernel_spans):
            end = start + dur * 1e6
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        overlap_us = 0.0
        for start, dur in self.copy_spans:
            end = start + dur * 1e6
            for k_start, k_end in merged:
                overlap_us += max(0.0, min(end, k_end) - max(start, k_start))
        return overlap_us * 1e-6

    def split(self, marks: list[str]) -> list[float]:
        """Kernel seconds between consecutive annotations: segment ``i``
        holds the kernels launched after annotation ``marks[i - 1]`` (the
        window's start for ``i = 0``) and before ``marks[i]``.  Raises if a
        kernel has no launch event or was launched after the last mark."""
        bounds = [self.annotations[m] for m in marks]
        seconds = [0.0] * len(marks)
        for name, launched, dur in self.kernels:
            if launched is None:
                raise RuntimeError(f"kernel {name!r} has no launch event "
                                   "in the trace")
            i = bisect.bisect_right(bounds, launched)
            if i == len(marks):
                raise RuntimeError(f"kernel {name!r} was launched after "
                                   f"the last mark {marks[-1]!r}")
            seconds[i] += dur
        return seconds


def _parse_trace(logdir: str) -> DeviceProfile:
    """Sum the device events of the newest Chrome trace (``*.json`` or
    ``*.json.gz``) under ``logdir``: kernels by name, copies apart; host
    events (operators, runtime calls, annotations) are not device time."""
    files = [f for pattern in ("*.json", "*.json.gz")
             for f in glob.glob(os.path.join(logdir, "**", pattern),
                                recursive=True)]
    if not files:
        raise RuntimeError(f"profiler produced no trace under {logdir}")
    newest = max(files, key=os.path.getmtime)
    opener = gzip.open if newest.endswith(".gz") else open
    with opener(newest, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]

    launched = {}
    annotations = {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if cat in _LAUNCHES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
        elif cat == _ANNOTATION:
            annotations.setdefault(e["name"], float(e["ts"]))
    kernel_us = 0.0
    copy_us = 0.0
    op_us: dict = {}
    kernels = []
    kernel_spans = []
    copy_spans = []
    for e in events:
        cat = str(e.get("cat", "")).lower()
        dur = float(e.get("dur", 0.0))
        if cat == _KERNEL:
            kernel_us += dur
            op_us[e["name"]] = op_us.get(e["name"], 0.0) + dur
            corr = (e.get("args") or {}).get("correlation")
            kernels.append((e["name"], launched.get(corr), dur * 1e-6))
            kernel_spans.append((float(e["ts"]), dur * 1e-6))
        elif cat in _COPIES:
            copy_us += dur
            copy_spans.append((float(e["ts"]), dur * 1e-6))
    return DeviceProfile(module_seconds=kernel_us * 1e-6,
                         op_seconds={k: v * 1e-6 for k, v in op_us.items()},
                         copy_seconds=copy_us * 1e-6, kernels=kernels,
                         annotations=annotations, kernel_spans=kernel_spans,
                         copy_spans=copy_spans)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _on_card(values) -> bool:
    if isinstance(values, torch.Tensor):
        return values.is_cuda
    if isinstance(values, (tuple, list)):
        return any(_on_card(v) for v in values)
    return False


TRACE_ATTEMPTS = 3
"""Traces of one call :func:`device_time` takes before it gives up on kernel
events: among many short back-to-back traces, CUPTI now and then delivers
none for one of them."""


def device_time(fn, *args, warmup: int = 1, logdir: str | None = None,
                **kwargs) -> DeviceProfile:
    """Trace ONE call of ``fn(*args, **kwargs)`` and return its device
    profile.  ``warmup`` untraced calls first keep kernel builds and first
    allocations out of the trace.  ``fn`` returns the tensor(s) it produced;
    :func:`utils.device.sync` on them ends the window, and a call whose
    arguments or result lie on the card must show kernel events: a trace
    without them is taken again, and after :data:`TRACE_ATTEMPTS` traces
    without them it raises.  Export the trace into ``logdir`` to keep it."""
    for _ in range(max(warmup, 0)):
        sync(fn(*args, **kwargs))
    for _ in range(TRACE_ATTEMPTS):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.profile(activities=_activities()) as prof:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(out)
            window = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix="bf_prof_") as tmp:
            path = logdir or tmp
            os.makedirs(path, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(path, f"trace_{time.time_ns()}.json"))
            result = _parse_trace(path)
        result.window_seconds = window
        if result.kernels or not _on_card(list(args) + [out]):
            return result
    raise RuntimeError(
        f"the profiler traced work on the card but recorded no CUDA kernel "
        f"events in {TRACE_ATTEMPTS} traces (CUPTI tracing unavailable?)")
