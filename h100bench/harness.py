"""One run of one cell: set-up, the measured window, the check, the metrics.

Set-up makes the cell's pool of raw frames from the seed (on the device),
sets up a ``Beamformer`` through its public calls and a
``runtime.streaming.StreamingSession`` on it, and streams
``warmup_frames`` frames through it, which builds the kernels (the first
run in a checkout compiles them into the program's ``_build/``) and warms
every shape the window uses.  The window then runs the traffic mix's
generator (``loop.py``, ``traffic/<generator>.py``) for ``seconds`` seconds;
set-up ends where it opens.

Each frame's completion is its own: when the session resolves the frame's
future (right after it enqueued the frame's last kernel, before it takes
the next frame), a blocking CUDA event is recorded on the compute stream,
and a watcher thread notes the host clock when it completes.  After the
window the session drains (at most a minute past the close); a frame that
raised or never completed has failed.

The check (``check.py``) then holds every frame of the window that
completed against the plain reference's frame of the same raw frame
(``reference/``, run once for each raw frame of the pool), after the
program's state is freed; the window's frames are kept on the device until
then.  With ``trace`` the window runs under ``torch.profiler``
and the per-layer metrics are read from the trace and the run's records.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import os
import queue
import re
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ogl_beamforming_tpu_torch.kernels import build
from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession

from . import check, frames, program, trace
from .loop import Schedule

DRAIN_SECONDS = 60.0
"""How long after the window's close a frame may still complete."""
TRACE_MARGIN = 0.1
"""Seconds the profiler runs before the window and after the drain: a
trace keeps a device event only where its converted start and end fall
between the profiler's start and stop."""
ROW_EVERY = 16
"""Completed frames between two reads of the stats table (32 rows)."""
FORBIDDEN = ("jax", "jaxlib", "flax", "ogl_beamforming_tpu")
"""Top-level modules that no run may load."""
WINDOW = "h100bench:window"


class Tracker:
    """The host clock at which each submitted frame's future resolved and
    its own last kernel completed."""

    def __init__(self, cuda: bool, on_done=None):
        self.cuda = cuda
        self.resolved: dict[int, float] = {}
        self.done: dict[int, float] = {}
        self.errors: dict[int, str] = {}
        self._on_done = on_done
        self._events: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="h100bench-completions")
        self._thread.start()

    def track(self, k: int, handle) -> None:
        handle.future.add_done_callback(functools.partial(self._resolved, k))

    def _resolved(self, k: int, fut) -> None:
        # runs in the session's worker as it resolves the future, before
        # it takes the next frame, or here at once for a frame already
        # resolved: no later frame has been submitted then
        self.resolved[k] = time.perf_counter()
        err = fut.exception()
        if err is not None or fut.result() is None:
            self.errors[k] = repr(err) if err is not None else "dropped"
            return
        if self.cuda:
            event = torch.cuda.Event(blocking=True)
            event.record()
            self._events.put((k, event))
        else:
            self._finish(k, time.perf_counter())

    def _finish(self, k: int, now: float) -> None:
        self.done[k] = now
        if self._on_done is not None:
            self._on_done(len(self.done))

    def _watch(self) -> None:
        while True:
            item = self._events.get()
            if item is None:
                return
            k, event = item
            event.synchronize()
            self._finish(k, time.perf_counter())

    def close(self, timeout: float) -> None:
        self._events.put(None)
        self._thread.join(timeout)


class StageRows:
    """Rows of the program's stats table (seconds per stage of a frame),
    read every :data:`ROW_EVERY` completed frames and once at the end."""

    def __init__(self, bf, stages: int):
        self.bf = bf
        self.stages = stages
        self.rows: set = set()
        self.active = False

    def on_done(self, count: int) -> None:
        if self.active and count % ROW_EVERY == 0:
            self.read()

    def read(self) -> None:
        times = np.array(self.bf.compute_timings().times[:, :self.stages])
        self.rows.update(tuple(float(v) for v in r) for r in times
                         if (r > 0).all())


@dataclass
class Run:
    """What one run recorded; the metric readers read it."""

    bench: object
    cell: dict
    cfg: dict
    traffic: dict
    seconds: float
    device: torch.device
    started: float = 0.0                            # time.time() at start
    setup_s: float = 0.0
    t0: float = 0.0
    t1: float = 0.0
    window: list = field(default_factory=list)      # frame indices
    submitted: dict = field(default_factory=dict)   # k -> host clock
    due: dict = field(default_factory=dict)         # k -> host clock
    lateness: list = field(default_factory=list)    # seconds
    tracker: Tracker | None = None
    rows: list = field(default_factory=list)        # seconds per stage
    spans: list = field(default_factory=list)       # (label, start, end)
    trace: trace.Trace | None = None
    launched: dict = field(default_factory=dict)    # kernel -> launches
    lost: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)      # stage -> work count
    pool: list = field(default_factory=list)        # the raw frames
    checked: list = field(default_factory=list)     # frames compared
    references: list = field(default_factory=list)  # one a pool frame
    readings: dict = field(default_factory=dict)    # k -> compared numbers

    def window_us(self) -> tuple[float, float]:
        """The window on the trace's clock."""
        lo, _ = self.trace.span(WINDOW)
        return lo, lo + (self.t1 - self.t0) * 1e6

    def to_trace_us(self, t: float) -> float:
        return self.trace.span(WINDOW)[0] + (t - self.t0) * 1e6

    def completed_in_window(self) -> int:
        return sum(self.t0 < t <= self.t1
                   for t in self.tracker.done.values())

    def failed(self) -> list[int]:
        return [k for k in self.window if k not in self.tracker.done]

    def work(self, stage: str) -> dict | None:
        """``work/<stage>.py``'s count for the run's configuration, once."""
        if stage not in self.counts:
            self.counts[stage] = self.bench.work(stage)(self.cfg, self.device)
        return self.counts[stage]


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _drive(run: Run, session, pool, tracker, traced: bool):
    """Warm-up, the window and the drain; returns the handles of the
    window's frames {k: handle}."""
    traffic = run.traffic
    schedule = Schedule(run.bench.generator(traffic["generator"]), traffic)
    handles: dict = {}

    def submit(k):
        a = time.perf_counter()
        handle = session.submit(pool[k % len(pool)])
        b = time.perf_counter()
        tracker.track(k, handle)
        run.spans.append(("submit", a, b))
        run.submitted[k] = a
        return handle

    warm = int(traffic["warmup_frames"])
    for k in range(warm):
        submit(k)
    if schedule.paced:
        # the window opens with nothing in flight, as a frame clock starts
        session.drain(timeout=DRAIN_SECONDS)
    run.spans.clear()
    prof = None
    if traced:
        prof = _profiler()
        prof.start()
        time.sleep(TRACE_MARGIN)
        if run.device.type == "cuda":
            # some traces lose their first kernel's event: this one takes it
            torch.zeros(1, device=run.device)
        if not schedule.paced:
            # fill the pipeline again after the pause before the window
            for k in range(warm, warm + int(traffic["depth"]) + 1):
                submit(k)
            warm = k + 1
    before = build.kernel_launches()
    annotate = (torch.profiler.record_function(WINDOW) if traced
                else contextlib.nullcontext())
    with annotate:
        run.t0 = time.perf_counter()
        run.setup_s = time.time() - run.started
        run.t1 = run.t0 + run.seconds
        schedule.start(run.t0)
        k, j = warm, 0
        while True:
            if schedule.due(j) is not None:
                if schedule.due(j) >= run.t1:
                    break
                a = time.perf_counter()
                run.lateness.append(schedule.wait(j))
                run.spans.append(("wait for the frame clock", a,
                                  time.perf_counter()))
                run.due[k] = schedule.due(j)
            elif time.perf_counter() >= run.t1:
                break
            handles[k] = submit(k)
            run.window.append(k)
            k, j = k + 1, j + 1
        a = time.perf_counter()
        try:
            session.drain(timeout=DRAIN_SECONDS)
        except TimeoutError:
            pass                        # the frames not done have failed
        run.spans.append(("drain", a, time.perf_counter()))
    if prof is not None:
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        time.sleep(TRACE_MARGIN)
        prof.stop()
        run.launched = {n: c - before.get(n, 0)
                        for n, c in build.kernel_launches().items()
                        if c - before.get(n, 0) > 0}
        with tempfile.TemporaryDirectory(prefix="h100bench_") as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            run.trace = trace.parse(path)
        run.lost = lost_events(run)
    return handles


def lost_events(run: Run) -> list[str]:
    """A line for each of the program's kernels launched while the
    profiler ran more often than the trace holds its events (the trace
    lost some)."""
    lines = []
    for name, n in sorted(run.launched.items()):
        traced = sum(name in k[0] for k in run.trace.kernels)
        if traced < n:
            lines.append(f"lost trace events: {name} launched {n} times, "
                         f"{traced} in the trace")
    return lines


def run_cell(bench, workload: str, seed: int, seconds: float,
             traced: bool, device, started: float, traffic=None,
             check_frames: bool = True):
    """One run; returns ``(result, compared_lines, info_lines, run)``.
    ``traffic``: entries that replace the mix's (a sweep's rates);
    ``check_frames=False`` skips the reference (a sweep's, whose result is
    not a run's)."""
    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    traffic = dict(bench.traffic(cell["traffic"]), **(traffic or {}))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    run = Run(bench=bench, cell=cell, cfg=cfg, traffic=traffic,
              seconds=float(seconds), device=dev, started=started)
    info = []

    pool = run.pool = frames.pool(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    bf = program.configure(cfg, dev)
    stages = len(cfg["pipeline"]["shaders"])
    rows = StageRows(bf, stages)
    tracker = Tracker(cuda, on_done=rows.on_done)
    run.tracker = tracker
    session = StreamingSession(bf, depth=int(traffic["depth"]))
    try:
        rows.active = True
        handles = _drive(run, session, pool, tracker, traced)
    finally:
        session.close(timeout=DRAIN_SECONDS)
        tracker.close(timeout=DRAIN_SECONDS)
    rows.active = False
    rows.read()
    run.rows = sorted(rows.rows)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    failed = run.failed()
    for k in failed:
        info.append(f"frame {k} failed: "
                    f"{tracker.errors.get(k, 'not complete after the drain')}")
    if run.lateness:
        info.append(f"generator lateness over {len(run.lateness)} frames: "
                    f"median {np.median(run.lateness) * 1e3:.4f} ms, max "
                    f"{max(run.lateness) * 1e3:.4f} ms")

    # the check, with the program's state freed
    outputs = [(k, h.result(timeout=0).data) for k, h in handles.items()
               if check_frames and k in tracker.done]
    rows.bf = None
    del bf, session, handles, rows
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    run.checked = [k for k, _ in outputs]
    t = time.perf_counter()
    if check_frames:
        run.references = check.references(cfg, pool, dev)
    compared, run.readings = check.compare(cfg, outputs, run.references,
                                           len(failed))
    del outputs
    info.append(f"check: {len(run.checked)} frames of the window against "
                f"the reference's {len(run.references)} in "
                f"{time.perf_counter() - t:.3f} s")
    for i, name in enumerate(cfg["limits"] if run.readings else ()):
        k = max(run.readings, key=lambda f: run.readings[f][i])
        info.append(f"check: the worst {name} is frame {k}'s (pool frame "
                    f"{k % len(pool)})")
    correct = all(v["value"] <= v["limit"] for v in compared.values())

    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info.extend(run.lost)

    result = {"correct": bool(correct), "attempted": len(run.window),
              "failed": len(failed), "metrics": metrics,
              "device": device_facts(dev, memory_peak)}
    if traced:
        busy, window = busy_seconds(run)
        result["device"].update(busy_s=busy, window_s=window)
        result["breakdown"] = breakdown(run)
    result["compared"] = compared
    return result, check.lines(compared), info, run


def device_facts(dev: torch.device, memory_peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(memory_peak),
            "power_limit_w": power_limit()}


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def busy_seconds(run: Run) -> tuple[float, float]:
    """Seconds in the window in which a kernel or a copy ran, and the
    window's seconds, from the trace."""
    lo, hi = run.window_us()
    merged = trace.busy_intervals(run.trace.kernels + run.trace.copies,
                                  lo, hi)
    return sum(b - a for a, b in merged) * 1e-6, (hi - lo) * 1e-6


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters; a copy's name as it is."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", name, maxsplit=1)[0].split()
    return head[-1] if head else name


def breakdown(run: Run) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps by what the client thread was doing."""
    lo, hi = run.window_us()
    ops: dict = {}
    for name, start, secs in run.trace.kernels + run.trace.copies:
        if lo <= start < hi:
            key = short_name(name)
            ops[key] = ops.get(key, 0.0) + secs
    merged = trace.busy_intervals(run.trace.kernels + run.trace.copies,
                                  lo, hi)
    spans = [(label, run.to_trace_us(a), run.to_trace_us(b))
             for label, a, b in run.spans]
    labelled = []
    longest = sorted(trace.gaps(merged, lo, hi), key=lambda g: g[0] - g[1])
    for a, b in longest[:10]:
        mid = (a + b) / 2
        client = next((s[0] for s in spans if s[1] <= mid < s[2]),
                      "between client calls")
        # the innermost host operator running then (the session's worker:
        # the client and the watcher wait in calls that are no operators)
        running = [(s, name) for name, start, s in run.trace.host_ops
                   if start <= mid < start + s * 1e6]
        host = min(running)[1] if running else "no operator"
        labelled.append((f"client {client}, host {host}", (b - a) * 1e-6))
    return {"device_ops": [[n, s] for n, s in
                           sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in labelled]}


def forbidden_modules() -> list[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)
