"""The Quickstart plan sharded over k positions, timed stage by stage.

Builds the Quickstart plan (``forces_compounding(128, 128, 4096,
demodulate=False)``: int16 -> Decode -> FORCES cubic DAS -> 512 x 1024) on
cuda:0 and, for each k of ``--positions``, shards it with
``parallel.sharding.shard_plan`` over k positions: k virtual positions of
cuda:0, or with ``--cards`` the positions dealt over the visible cards in
turn (k = 8 on four cards: two positions a card).  Each k runs one
warm-up frame, then RUNS frames of one int16 frame made on the card from
seed 0, timed with the executor's stage clock (CUDA events on
cuda:0, whose stream waits for the other cards at each stage's end).
Prints one JSON line a k: the median ms a stage and a frame, the NRMSE of
the sharded frame against the unsharded plan's, and the cards' names and
power limits.

Run on the card, from the repository root:

    python -m ogl_beamforming_tpu_torch.experiments.mesh_sweep \\
        [--positions 1,2,4,8,16] [--cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

RUNS = 5


def quickstart_plan(dev):
    """The Quickstart's parameters and plan on ``dev``."""
    from ..models import presets
    from ..pipeline.plan import build_plan
    params, pipe = presets.forces_compounding(
        channel_count=128, transmit_count=128, sample_count=4096,
        demodulate=False)
    return params, build_plan(params, pipe, {}, device=dev)


def time_positions(plan, x, devices) -> tuple[dict, object]:
    """``plan`` sharded over ``devices`` on frame ``x``: the median ms of
    each stage and of the frame over RUNS frames after a warm-up, and the
    frame."""
    from ..parallel.sharding import make_mesh, shard_plan
    from ..pipeline.executor import _StageClock
    splan = shard_plan(plan, make_mesh(devices))
    out = splan(x)
    rows = []
    for _ in range(RUNS):
        clock = _StageClock(devices[0])
        out = splan(x, mark=clock.mark)
        rows.append([t * 1e3 for t in clock.seconds()])
    ms = np.median(rows, axis=0)
    stages = {sd.kind.name: float(t)
              for sd, t in zip(plan.descriptor.stages, ms)}
    return {"stage_ms": stages, "frame_ms": float(ms.sum())}, out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--positions", default="1,2,4,8,16",
                    help="the k to time, comma-separated (each divides 128)")
    ap.add_argument("--cards", action="store_true",
                    help="deal the positions over the visible cards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("mesh_sweep times the CUDA kernels: no GPU")
    from ..pretune import device_input
    dev = torch.device("cuda", 0)
    cards = torch.cuda.device_count() if args.cards else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    p, plan = quickstart_plan(dev)
    x = device_input((p.channel_count, p.acquisition_count, p.sample_count),
                     torch.int16, 0)
    ref = plan(x)
    for k in (int(v) for v in args.positions.split(",")):
        devices = [torch.device("cuda", i % cards) for i in range(k)]
        row, out = time_positions(plan, x, devices)
        err = float(torch.linalg.vector_norm(out - ref)
                    / torch.linalg.vector_norm(ref))
        print(json.dumps({"positions": k, "cards": len(set(devices)),
                          "channels_a_shard": p.channel_count // k, **row,
                          "nrmse": err, "runs": RUNS, "card": smi}),
              flush=True)


if __name__ == "__main__":
    main()
