"""K5: what a lane gather costs, on Hopper.

The counterpart of ``experiments/gather_micro.py``: REPS = 64 gathers per
element of a (16, 128) float32 tile at index ``idx + (r & 3)`` into 8
chains, for STEPS = 512 grid steps (the port's persistent kernel takes
every step's elements), with the index clipped (``clip``), masked
(``mod``) or taken as it is (``raw``), against a multiply-add control
(``fma``: ``src * (idx + r)``).  Each is timed alone, by CUDA events
around its launches and by its kernel time in a profiler trace.  The
``r & 3`` index repeats every four repetitions, so the compiler loads
each of the four gathers once an element-step (``csrc/micro_gather.cu``):
these variants measure fewer gathers than they name.  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.gather_micro
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (LANE, ROWS, WARP, card, check_gather_args, cycles_per_warp_op,
               expand_steps, launch_gather, launch_ms, require_gpu,
               sm_clock_mhz, sm_count, traced_ms)

REPS, STEPS = 64, 512
ITERS = 20
VARIANTS = ("clip", "mod", "raw", "fma")
VARIANT_IDS = {v: i for i, v in enumerate(VARIANTS)}    # micro_gather.cu
OPS_PER_REP = {"clip": 5, "mod": 4, "raw": 3, "fma": 3}


def make_inputs(device) -> dict:
    """The TPU file's inputs (``default_rng(5)``) on ``device``."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((ROWS, LANE)).astype(np.float32)
    idx = rng.integers(0, LANE - 4, (ROWS, LANE), np.int32)
    return {"src": torch.from_numpy(src).to(device),
            "idx": torch.from_numpy(idx).to(device)}


def kernel_ref(variant, src, idx, reps=REPS, steps=1) -> torch.Tensor:
    """Plain torch: the tile of ``variant`` (the TPU bodies ``kernel`` and,
    for ``fma``, ``kernel_fma``) for ``steps`` grid steps at once."""
    src, idx = expand_steps(steps, src, idx)
    accs = [torch.zeros(src.shape, dtype=torch.float32, device=src.device)] \
        * 8
    fidx = idx.to(torch.float32)
    for r in range(reps):
        if variant == "fma":
            accs[r & 7] = accs[r & 7] + src * (fidx + float(r))
            continue
        ix = idx + (r & 3)
        if variant == "clip":
            ix = ix.clamp(0, LANE - 1)
        elif variant == "mod":
            ix = ix & (LANE - 1)
        elif variant != "raw":
            raise ValueError(f"unknown variant {variant!r}")
        accs[r & 7] = accs[r & 7] + torch.gather(src, -1, ix)
    acc = accs[0]
    for a in accs[1:]:
        acc = acc + a
    return acc[-1]


def kernel(variant, src, idx, reps=REPS, steps=STEPS, smem=True):
    """The tile of ``variant``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        # the kernel's second plane and weights are unused here: the tile
        check_gather_args(src, src, idx, src, False)
        return launch_gather(VARIANT_IDS[variant], src, src, idx, src, reps,
                             steps, smem)
    if src.device.type != "cpu":
        raise ValueError(f"no kernel for device {src.device}")
    return kernel_ref(variant, src, idx, reps)


def measure(variant, inputs, smem=True, iters=ITERS) -> dict:
    """Time one launch of ``variant`` (on the card)."""
    src, idx = inputs["src"], inputs["idx"]
    check_gather_args(src, src, idx, src, False)

    def launch():
        return launch_gather(VARIANT_IDS[variant], src, src, idx, src, REPS,
                             STEPS, smem)

    return _result(launch_ms(launch, iters=iters),
                   traced_ms(launch, iters=iters), smem, src.device)


def _result(event_ms, kernel_ms, smem, device) -> dict:
    """A launch's CUDA-event time (the enqueue included) and its kernel
    time, and cycles per warp gather from the kernel time."""
    clock = sm_clock_mhz()
    return {"memory": "shared" if smem else "global", "us": event_ms * 1e3,
            "kernel_us": kernel_ms * 1e3,
            "cycles_per_warp_gather": cycles_per_warp_op(
                kernel_ms * 1e-3, clock, sm_count(device),
                REPS * STEPS * ROWS * LANE / WARP),
            "sm_clock_mhz": clock}


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    inputs = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    results = {}
    for variant in VARIANTS:
        for smem in (True, False):
            row = measure(variant, inputs, smem)
            results[f"{variant}/{row['memory']}"] = row
            print(json.dumps({"variant": variant, **row}), flush=True)
    print(json.dumps({"all": results}))
    return results


if __name__ == "__main__":
    main()
