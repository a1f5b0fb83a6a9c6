"""One run of one benchmark cell on the card this machine holds.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's facts, then as the last line of standard output one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` with ``--trace 1``, and last ``compared``: each number the
check compared, with its limit); the compared numbers are also the last
lines of standard error.  Exits 2 without a result when the card is
missing or fewer cards than the cell asks for are present, and 3 when a
module of ``jax`` or of the JAX package was loaded.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m h100bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100bench.spec import Bench

    bench = Bench()
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from h100bench import harness

    result, compared, info, _ = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda:0", STARTED)
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"h100bench: the run loaded {forbidden}", file=sys.stderr)
        return 3
    for line in info:
        print(line)
    for line in compared:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
