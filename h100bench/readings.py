"""The readings behind the check's limits, on the card: the program's
numbers and the control's, seed by seed, in one process.

    python3 -m h100bench.readings --workload <cell> --seeds 1,2,3 \
        --seconds 2

For each seed, one run of the cell on its timed path (``harness.run_cell``,
as ``run.py`` runs it, with a short window) gives the program's compared
numbers, the worst over the window's frames and the worst for each raw
frame of the pool; then the control, the reference put in the program's
place with every stage's input and output rounded to bfloat16, is read in
the same way on each raw frame of the pool.  One JSON line a seed.  The
limits in ``configs/`` were set from these readings (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from h100bench import check, harness
from h100bench.spec import Bench


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("h100bench.readings needs a CUDA device")
    bench = Bench()
    dev = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _, _, run = harness.run_cell(
            bench, args.workload, seed, args.seconds, False, dev,
            time.time())
        names = list(run.cfg["limits"])
        pool = len(run.pool)
        program = [[0.0] * len(names) for _ in range(pool)]
        for k, values in run.readings.items():
            program[k % pool] = [max(a, b) for a, b in
                                 zip(program[k % pool], values)]
        control = []
        for raw, ref in zip(run.pool, run.references):
            out = check.references(run.cfg, [raw], dev, "bfloat16")[0]
            control.append(check.readings(run.cfg, out, ref).tolist())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "frames": len(run.readings), "numbers": names,
                          "program": result["compared"],
                          "program_by_pool_frame": program,
                          "control_by_pool_frame": control}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
