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
time of 0.  A trace that holds kernel events but fewer of one of the port's
kernels than the call launched (``kernels/build.KERNEL_LAUNCHES``) is
returned as it is, with the kernel and the call named in
``DeviceProfile.lost`` and in a :class:`LostKernelEvents` warning.
"""

from __future__ import annotations

import bisect
import glob
import gzip
import json
import os
import tempfile
import time
import warnings
from dataclasses import dataclass, field

import torch

from ..kernels import build
from .device import sync

# Chrome-trace categories (torch.profiler / Kineto): device activity, the
# host calls that launch it, and record_function annotations
_KERNEL = "kernel"
_COPIES = ("gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cuda_runtime", "cuda_driver")
_ANNOTATION = "user_annotation"
_CALL = "device_time:call"
"""The annotation around the traced call in :func:`device_time`."""


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
    # host time in us of each kernel launch call (``cudaLaunchKernel`` and
    # the like) whose kernel event the trace lacks, and of every launch call
    launch_calls: list = field(default_factory=list)
    orphan_launches: list = field(default_factory=list)
    # device start minus host launch call, in us, of each kernel with its
    # launch event: no kernel starts before its launch, so a value below 0
    # is the error of the trace's device-to-host clock conversion
    start_lags_us: list = field(default_factory=list)
    # one line for each of the port's kernels that the traced call launched
    # more often than the trace holds its events (:func:`lost_kernels`)
    lost: list = field(default_factory=list)

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
    events (operators, runtime calls, annotations) are not device time.
    Where the trace holds :func:`device_time`'s annotation around its call,
    work launched before it and its launch calls are left out."""
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
    launch_calls = {}
    annotations = {}
    for e in events:
        cat = str(e.get("cat", "")).lower()
        if cat in _LAUNCHES:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
                if "LaunchKernel" in str(e.get("name", "")):
                    launch_calls[corr] = float(e["ts"])
        elif cat == _ANNOTATION:
            annotations.setdefault(e["name"], float(e["ts"]))
    if _CALL in annotations:
        start = annotations[_CALL]
        early = {c for c, ts in launched.items() if ts < start}
        launch_calls = {c: ts for c, ts in launch_calls.items()
                        if c not in early}
        events = [e for e in events
                  if (e.get("args") or {}).get("correlation") not in early]
    kernel_us = 0.0
    copy_us = 0.0
    op_us: dict = {}
    kernels = []
    kernel_spans = []
    copy_spans = []
    start_lags = []
    seen = set()
    for e in events:
        cat = str(e.get("cat", "")).lower()
        dur = float(e.get("dur", 0.0))
        if cat == _KERNEL:
            kernel_us += dur
            op_us[e["name"]] = op_us.get(e["name"], 0.0) + dur
            corr = (e.get("args") or {}).get("correlation")
            seen.add(corr)
            kernels.append((e["name"], launched.get(corr), dur * 1e-6))
            if corr in launched:
                start_lags.append(float(e["ts"]) - launched[corr])
            kernel_spans.append((float(e["ts"]), dur * 1e-6))
        elif cat in _COPIES:
            copy_us += dur
            copy_spans.append((float(e["ts"]), dur * 1e-6))
    return DeviceProfile(module_seconds=kernel_us * 1e-6,
                         op_seconds={k: v * 1e-6 for k, v in op_us.items()},
                         copy_seconds=copy_us * 1e-6, kernels=kernels,
                         annotations=annotations, kernel_spans=kernel_spans,
                         copy_spans=copy_spans,
                         launch_calls=sorted(launch_calls.values()),
                         orphan_launches=sorted(
                             ts for c, ts in launch_calls.items()
                             if c not in seen),
                         start_lags_us=start_lags)


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


class LostKernelEvents(RuntimeWarning):
    """A trace lacks kernel events that its call launched (roadmap C2)."""


def lost_kernels(profile: DeviceProfile, launched, call: str) -> list:
    """A line for each kernel in ``launched`` ({its name as a trace shows
    it: launches the traced call made}) of which ``profile`` holds fewer
    kernel events than were launched, naming the kernel and ``call``."""
    lines = []
    for name, n in sorted(launched.items()):
        if n <= 0:
            continue
        traced = sum(name in k for k, _, _ in profile.kernels)
        if traced < n:
            calls = profile.launch_calls
            where = ", ".join(
                f"#{calls.index(ts) + 1} at +{(ts - calls[0]) * 1e-3:.3f} ms"
                for ts in profile.orphan_launches)
            lags = profile.start_lags_us
            lines.append(f"{name}: {n} launched by {call}, {traced} in the "
                         f"trace of {len(profile.kernels)} kernel events; "
                         f"launch calls without a kernel event, of "
                         f"{len(calls)}: {where or 'none'}"
                         + (f"; kernel start minus launch call "
                            f"{min(lags):.0f} to {max(lags):.0f} us"
                            if lags else ""))
    return lines


TRACE_ATTEMPTS = 3
"""Traces of one call :func:`device_time` takes before it gives up on kernel
events: among many short back-to-back traces, CUPTI now and then delivers
none for one of them."""

TRACE_MARGIN_SECONDS = 0.1
"""Host time :func:`device_time` lets pass on the card between starting the
profiler and calling ``fn``, and between the call's end and stopping the
profiler.  The profiler keeps a device event only where its start and end,
converted to the host clock, fall between its own start and stop, and that
conversion strays by milliseconds (``experiments/trace_window``): without
the margin, the first or last kernels of a short window went missing
(roadmap C2)."""


def device_time(fn, *args, warmup: int = 1, logdir: str | None = None,
                **kwargs) -> DeviceProfile:
    """Trace ONE call of ``fn(*args, **kwargs)`` and return its device
    profile.  ``warmup`` untraced calls first keep kernel builds and first
    allocations out of the trace; on the card, the profiler runs
    :data:`TRACE_MARGIN_SECONDS` before and after the call, and one small
    kernel launched just before the call (left out of the profile) takes
    the loss where a trace drops the event of its first kernel (roadmap
    C2).  ``fn`` returns the tensor(s) it produced;
    :func:`utils.device.sync` on them ends the window, and a call whose
    arguments or result lie on the card must show kernel events: a trace
    without them is taken again, and after :data:`TRACE_ATTEMPTS` traces
    without them it raises.  Each of the port's kernels that the call
    launched more often than the trace holds it is named in the profile's
    ``lost`` and in a :class:`LostKernelEvents` warning.  Export the trace
    into ``logdir`` to keep it."""
    for _ in range(max(warmup, 0)):
        sync(fn(*args, **kwargs))
    call = getattr(fn, "__qualname__", None) or repr(fn)
    margin = TRACE_MARGIN_SECONDS if torch.cuda.is_available() else 0.0
    for _ in range(TRACE_ATTEMPTS):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        before = build.kernel_launches()
        with torch.profiler.profile(activities=_activities()) as prof:
            time.sleep(margin)
            if torch.cuda.is_available():
                # some traces lose the event of their first kernel (roadmap
                # C2): this one, left out of the profile, takes the loss
                torch.zeros(1, device=torch.cuda.current_device())
            t0 = time.perf_counter()
            with torch.profiler.record_function(_CALL):
                out = fn(*args, **kwargs)
                sync(out)
            window = time.perf_counter() - t0
            time.sleep(margin)
        launched = {k: n - before.get(k, 0)
                    for k, n in build.kernel_launches().items()}
        with tempfile.TemporaryDirectory(prefix="bf_prof_") as tmp:
            path = logdir or tmp
            os.makedirs(path, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(path, f"trace_{time.time_ns()}.json"))
            result = _parse_trace(path)
        result.window_seconds = window
        if result.kernels or not _on_card(list(args) + [out]):
            result.lost = lost_kernels(result, launched, call)
            for line in result.lost:
                warnings.warn(line, LostKernelEvents, stacklevel=2)
            return result
    raise RuntimeError(
        f"the profiler traced work on the card but recorded no CUDA kernel "
        f"events in {TRACE_ATTEMPTS} traces of {call} (CUPTI tracing "
        f"unavailable?); its last call launched "
        f"{ {k: n for k, n in launched.items() if n} }")
