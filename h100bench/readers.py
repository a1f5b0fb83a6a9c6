"""What the metric files (``metrics/<name>.py``) share: each reads one
number from a run's records (``harness.Run``) and returns None where it
finds nothing to read."""

from __future__ import annotations

import statistics

from . import harness


def stage_roofline(run, stage: str, kernel: str):
    """Percent of the stage's least time (``work/<stage>.py``) that its
    kernel takes: the least time over the mean duration of the trace's
    events whose name holds ``kernel``.  None without a trace, from a
    trace that lost kernel events, or where no such kernel ran."""
    if run.trace is None or run.lost:
        return None
    lo, hi = run.window_us()
    secs = [s for name, start, s in run.trace.kernels
            if kernel in name and lo <= start < hi]
    if not secs:
        return None
    work = run.work(stage)
    if work is None:
        return None
    return 100.0 * work["seconds"] / (sum(secs) / len(secs))


def idle_share(run):
    """Percent of the traced window in which no kernel and no copy ran."""
    if run.trace is None:
        return None
    busy, window = harness.busy_seconds(run)
    return 100.0 * (1.0 - busy / window)


def median_ms(values):
    return statistics.median(values) * 1e3 if values else None
