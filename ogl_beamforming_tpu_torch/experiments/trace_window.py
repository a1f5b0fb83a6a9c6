"""Which kernel events a ``torch.profiler`` trace drops on the card, and how
far its device timestamps, converted to the host clock, stray.

The profiler keeps a device event only where its start and end, on the
host clock, fall between the profiler's start and stop.  No kernel starts
before its launch call, so a kernel's start minus its launch call below 0
is the error of that conversion; where the error is larger than the host
time between a kernel and the window's edge, the kernel's event is dropped
(roadmap C2).  Each window here traces 20 small kernels with a margin of
host time before them and after their synchronise, the margins of
``MARGINS`` in turn, and two 4096² products run between windows so that
the card is busy as in the smoke.  Per margin it prints the windows, those
that lost events, the events lost, and the least and largest start minus
launch call.

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.trace_window \\
        [--seconds 120]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from . import card, require_gpu

MARGINS = (0.0, 0.01, 0.1)
"""Seconds of host time before the kernels and after their synchronise."""
KERNELS = 20


def window(x: torch.Tensor, margin: float):
    """A trace of KERNELS launches on ``x`` with ``margin`` seconds before
    and after them, parsed (``utils.profiling``)."""
    from ..utils.profiling import _activities, _parse_trace
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=_activities()) as prof:
        time.sleep(margin)
        for _ in range(KERNELS):
            x.mul_(1.0000001)
        torch.cuda.synchronize()
        time.sleep(margin)
    with tempfile.TemporaryDirectory(prefix="bf_window_") as tmp:
        prof.export_chrome_trace(os.path.join(tmp, "trace.json"))
        return _parse_trace(tmp)


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0,
                    help="how long to take windows, the margins in turn")
    args = ap.parse_args(argv)
    dev = require_gpu(device)
    print(json.dumps(card()), flush=True)
    x = torch.ones(1 << 16, device=dev)
    big = torch.randn((4096, 4096), device=dev)
    stats = {m: {"margin_s": m, "windows": 0, "lossy": 0, "lost": 0,
                 "lag_min_us": None, "lag_max_us": None} for m in MARGINS}
    end = time.perf_counter() + args.seconds
    i = 0
    while time.perf_counter() < end:
        big @ big
        big @ big
        s = stats[MARGINS[i % len(MARGINS)]]
        prof = window(x, s["margin_s"])
        lost = len(prof.orphan_launches)
        s["windows"] += 1
        s["lossy"] += bool(lost)
        s["lost"] += lost
        if prof.start_lags_us:
            lo, hi = min(prof.start_lags_us), max(prof.start_lags_us)
            s["lag_min_us"] = lo if s["lag_min_us"] is None else min(
                s["lag_min_us"], lo)
            s["lag_max_us"] = hi if s["lag_max_us"] is None else max(
                s["lag_max_us"], hi)
        i += 1
    for s in stats.values():
        print(json.dumps(s), flush=True)
    print(json.dumps(card()), flush=True)
    return stats


if __name__ == "__main__":
    main()
