"""Device activity from a ``torch.profiler`` Chrome trace.

``parse`` is a frozen copy of ``ogl_beamforming_tpu_torch/utils/profiling.py``
``_parse_trace`` (PR 17), kept to its reading of the events: CUDA kernels
(category ``kernel``) and device copies and memsets (``gpu_memcpy``,
``gpu_memset``) are device time, each with its start on the trace's clock
and its name; host operators (``cpu_op``) and annotations
(``user_annotation``, from ``torch.profiler.record_function``) give host
spans on the same clock.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass, field

_KERNEL = "kernel"
_COPIES = ("gpu_memcpy", "gpu_memset")
_ANNOTATION = "user_annotation"
_HOST_OP = "cpu_op"


@dataclass
class Trace:
    """A trace's device events and host operators as ``(name, start_us,
    seconds)`` and its host annotations as ``name -> [(start_us, seconds),
    ...]``."""

    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    host_ops: list = field(default_factory=list)
    annotations: dict = field(default_factory=dict)

    def span(self, name: str) -> tuple[float, float]:
        """(start_us, end_us) of the first annotation ``name``."""
        start, seconds = self.annotations[name][0]
        return start, start + seconds * 1e6


def parse(path: str) -> Trace:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X"]
    out = Trace()
    for e in events:
        cat = str(e.get("cat", "")).lower()
        item = (str(e.get("name", "")), float(e["ts"]),
                float(e.get("dur", 0.0)) * 1e-6)
        if cat == _KERNEL:
            out.kernels.append(item)
        elif cat in _COPIES:
            out.copies.append(item)
        elif cat == _HOST_OP:
            out.host_ops.append(item)
        elif cat == _ANNOTATION:
            out.annotations.setdefault(item[0], []).append(item[1:])
    return out


def busy_intervals(events, lo_us: float, hi_us: float) -> list:
    """The union of the events' intervals, clipped to [lo_us, hi_us], as
    sorted disjoint ``[start_us, end_us]``."""
    merged: list[list[float]] = []
    for _, start, seconds in sorted(events, key=lambda e: e[1]):
        a, b = max(start, lo_us), min(start + seconds * 1e6, hi_us)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def gaps(intervals, lo_us: float, hi_us: float) -> list:
    """The ``(start_us, end_us)`` between sorted disjoint intervals inside
    [lo_us, hi_us]."""
    out, at = [], lo_us
    for a, b in intervals:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi_us > at:
        out.append((at, hi_us))
    return out
