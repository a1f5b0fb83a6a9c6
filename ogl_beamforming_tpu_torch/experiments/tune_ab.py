"""The decode's launch knobs timed in turns on fresh input, on Hopper.

``decode.autotune_decode`` (and so ``pretune``) times each candidate on one
input, call after call.  In a pipeline each frame's input is new.  This
harness times the default knobs (A) and a knob set (B) in turns, A B then
B A, over ``--rounds`` rounds; each time is CUDA events around ``--iters``
decodes that walk over ``--buffers`` distinct inputs of the shape (at the
main paths' shapes more bytes than the card's 50 MB L2 holds).  It prints
one JSON line a shape: each side's median and interquartile range, the
rounds B won, and the card's name and power limit.  Without ``--knobs`` B
is the shipped table's entry for the shape.

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.tune_ab \\
        --shape 256,64,2048 --shape 128,128,4096 [--knobs '{"tile_s": 128}']
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess

import torch


def time_knobs(rfs, h, knobs: dict, iters: int) -> float:
    """Milliseconds a decode takes under ``knobs`` over the defaults
    (through ``DECODE_ABLATE``, so that no table entry applies; put back
    after): CUDA events around ``iters`` decodes of ``rfs`` in turn, after
    one of each."""
    from ..ops import decode
    from ..utils.device import event_seconds
    defaults = dict(zip(decode.DECODE_KNOBS, decode.I8_TILES[0]))
    saved = dict(decode.DECODE_ABLATE)
    decode.DECODE_ABLATE.clear()
    decode.DECODE_ABLATE.update({**defaults, **knobs})
    try:
        turn = itertools.cycle(rfs)
        return 1e3 * event_seconds(
            lambda: decode.decode_hadamard_cuda(next(turn), h), iters,
            len(rfs))
    finally:
        decode.DECODE_ABLATE.clear()
        decode.DECODE_ABLATE.update(saved)


def compare(shape, knobs: dict, rounds: int, iters: int,
            buffers: int) -> dict:
    """A (the defaults) against B (``knobs``) at the int16 ``shape``."""
    from ..ops import decode
    from ..pretune import device_input
    rfs = [device_input(shape, torch.int16, seed) for seed in range(buffers)]
    h = decode.hadamard_matrix(shape[1], "cuda")
    times: dict = {"A": [], "B": []}
    for r in range(rounds):
        for side in ("A", "B") if r % 2 == 0 else ("B", "A"):
            times[side].append(time_knobs(rfs, h, {} if side == "A"
                                          else knobs, iters))

    def spread(ts):
        q1, _, q3 = statistics.quantiles(ts, n=4)
        return q3 - q1

    return {"shape": list(shape), "knobs": knobs,
            "a_ms": statistics.median(times["A"]),
            "a_iqr_ms": spread(times["A"]),
            "b_ms": statistics.median(times["B"]),
            "b_iqr_ms": spread(times["B"]),
            "b_wins": sum(b < a for a, b in zip(times["A"], times["B"])),
            "rounds": rounds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", action="append", required=True,
                    help="C,A,S of an int16 decode (repeatable)")
    ap.add_argument("--knobs", help="B's knobs as JSON (default: the "
                    "shipped table's entry for the shape)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--buffers", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tune_ab times the CUDA decode: no GPU")
    from ..ops import decode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for text in args.shape:
        shape = tuple(int(v) for v in text.split(","))
        knobs = (decode.check_decode_knobs(json.loads(args.knobs))
                 if args.knobs else decode.decode_knobs(shape))
        out = compare(shape, knobs, args.rounds, args.iters, args.buffers)
        print(json.dumps({**out, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
