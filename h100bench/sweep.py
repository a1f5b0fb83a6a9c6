"""The open loop's knee, on the card: a cell's traffic at several frame
rates, one short window each, in one process.

    python3 -m h100bench.sweep --workload forces128_2d.live \
        --rates 40,44,48,50 --seconds 8 --seed 1

For each rate one JSON line: the frames due and failed, the latency's
median, 95th percentile and median in each third of the window (a backlog
that grows shows as thirds that rise), and how late the generator ran.
The knee is the highest rate whose thirds do not rise; a live mix's
``rate_per_s`` is four fifths of it, written into its traffic file once
(``PERF.md`` keeps the sweep).  The frames are not checked here.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from h100bench import harness
from h100bench.spec import Bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("h100bench.sweep needs a CUDA device")
    bench = Bench()
    for rate in (float(r) for r in args.rates.split(",")):
        _, _, _, run = harness.run_cell(
            bench, args.workload, args.seed, args.seconds, False, "cuda:0",
            time.time(), traffic={"generator": "clock", "rate_per_s": rate},
            check_frames=False)
        done = run.tracker.done
        lat = [(done[k] - run.due[k]) * 1e3 for k in run.window if k in done]
        n = len(lat)
        print(json.dumps({
            "rate_per_s": rate, "due": len(run.window),
            "failed": len(run.failed()),
            "latency_ms_p50": float(np.median(lat)),
            "latency_ms_p95": float(np.percentile(lat, 95)),
            "thirds_p50_ms": [float(np.median(lat[i * n // 3:
                                                 (i + 1) * n // 3]))
                              for i in range(3)],
            "lateness_ms_max": max(run.lateness) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
