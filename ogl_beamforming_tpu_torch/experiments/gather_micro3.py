"""K7: the gather floor by the slope method, on Hopper.

The counterpart of ``experiments/gather_micro3.py``: each variant's bundle,
repeated ``reps`` times per element of a (16, 128) tile into 8 accumulator
chains, in ``STEPS`` blocks, timed at REPS in {32, 96, 224}; the slope of
time over REPS gives the cost of one repetition with every constant term
(launch, staging, store) cancelled.  One repetition of a step is one gather
per element, 2048 / 32 = 64 warp-wide gathers, so

    cycles per warp gather = slope * SM clock * SMs / (STEPS * 64).

Variants:
  fma           8-chain multiply-add control, no gather
  f32_direct    gather at a fresh masked index (idx + r) & 127
  idx_fresh     the DAS tap's index pipeline: add, unsigned compare, mask,
                select, gather, multiply-add
  unpack        int32 gather, hi/lo int16 unpack, 2 multiply-adds
  hermite_pair  the DAS cubic tap: 2 gathers (value and slope planes) at
                one index, full unpack, 4 multiply-adds

Each is timed gathering from shared memory and through ``__ldg`` from
device memory (``csrc/micro_gather.cu``).  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.gather_micro3
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (LANE, ROWS, WARP, card, check_gather_args, cycles_per_warp_op,
               expand_steps, hermite_bundle, hi16, launch_gather, launch_ms,
               lo16, require_gpu, slope, sm_clock_mhz, sm_count)

STEPS = 16384
NCHAINS = 8
REPS_SWEEP = (32, 96, 224)
ITERS = 20
VARIANTS = ("fma", "f32_direct", "idx_fresh", "unpack", "hermite_pair")
VARIANT_IDS = {"fma": 12, "f32_direct": 13, "idx_fresh": 14, "unpack": 15,
               "hermite_pair": 16}           # csrc/micro_gather.cu Variant
INT_SRC = ("unpack", "hermite_pair")

# operations per element and repetition (gather, add, multiply, compare,
# shift, convert, mask and select one each), for the bound
OPS_PER_REP = {"fma": 3, "f32_direct": 4, "idx_fresh": 7, "unpack": 14,
               "hermite_pair": 13}


def make_inputs(device) -> dict:
    """The TPU file's inputs (``default_rng(5)``) on ``device``."""
    rng = np.random.default_rng(5)
    arrays = dict(
        idx=rng.integers(1, LANE - 4, (ROWS, LANE), np.int32),
        w=rng.standard_normal((ROWS, LANE)).astype(np.float32),
        src_f=rng.standard_normal((ROWS, LANE)).astype(np.float32),
        src_i=rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(np.int32),
        src_i2=rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(np.int32))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def sources(variant: str, inputs: dict):
    """(src, src2) of ``variant``: int32 planes or the float32 tile twice."""
    if variant in INT_SRC:
        return inputs["src_i"], inputs["src_i2"]
    return inputs["src_f"], inputs["src_f"]


def kernel_ref(variant, src, src2, idx, w, reps, steps=1) -> torch.Tensor:
    """Plain torch: the (16, 128) tile of ``variant`` (the TPU body
    ``make(variant, reps).kernel``), computed for ``steps`` grid steps at
    once (all equal; the last is returned)."""
    src, src2, idx, w = expand_steps(steps, src, src2, idx, w)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    accs = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)] \
        * NCHAINS
    for r in range(reps):
        a = r % NCHAINS
        if variant == "fma":
            accs[a] = accs[a] + w * (w + float(r))
        elif variant == "f32_direct":
            rc = (idx + r) & (LANE - 1)
            accs[a] = accs[a] + torch.gather(src, -1, rc)
        elif variant in ("idx_fresh", "unpack"):
            rr = idx + (r - 1)
            sel = (rr >= 0) & (rr < LANE)
            rc = rr & (LANE - 1)
            wsel = torch.where(sel, w, zero)
            v = torch.gather(src, -1, rc)
            if variant == "idx_fresh":
                accs[a] = accs[a] + wsel * v
            else:
                accs[a] = accs[a] + wsel * hi16(v) + wsel * lo16(v)
        elif variant == "hermite_pair":
            if r % 2:
                continue
            accs[a] = hermite_bundle(accs[a], idx, w, src, src2, r // 2 - 1,
                                     bcast=False)
        else:
            raise ValueError(f"unknown variant {variant!r}")
    acc = accs[0]
    for x in accs[1:]:
        acc = acc + x
    return acc[-1]


def kernel(variant, src, src2, idx, w, reps, steps=STEPS, smem=True):
    """The tile of ``variant``: the CUDA kernel for CUDA tensors (``steps``
    blocks, gathering from shared memory or, without ``smem``, through
    ``__ldg``), the plain version for CPU tensors."""
    if src.is_cuda:
        check_gather_args(src, src2, idx, w, variant in INT_SRC)
        return launch_gather(VARIANT_IDS[variant], src, src2, idx, w, reps,
                             steps, smem)
    if src.device.type != "cpu":
        raise ValueError(f"no kernel for device {src.device}")
    return kernel_ref(variant, src, src2, idx, w, reps)


def sweep(variant, inputs, smem=True, reps_sweep=REPS_SWEEP,
          iters=ITERS) -> dict:
    """Time ``variant`` at each REPS and fit the slope (on the card).  The
    SM clock is read right after the timed launches: an idle card reads
    its idle clock."""
    src, src2 = sources(variant, inputs)
    idx, w = inputs["idx"], inputs["w"]
    check_gather_args(src, src2, idx, w, variant in INT_SRC)
    times = [launch_ms(lambda reps=reps: launch_gather(
        VARIANT_IDS[variant], src, src2, idx, w, reps, STEPS, smem),
        iters=iters) for reps in reps_sweep]
    clock = sm_clock_mhz()
    per_rep_s = slope(reps_sweep, times) * 1e-3
    return {"memory": "shared" if smem else "global",
            "us": [t * 1e3 for t in times],
            "slope_us_per_rep": per_rep_s * 1e6,
            "cycles_per_warp_gather": cycles_per_warp_op(
                per_rep_s, clock, sm_count(src.device),
                STEPS * ROWS * LANE / WARP),
            "sm_clock_mhz": clock}


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    inputs = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    results = {}
    for variant in VARIANTS:
        for smem in (True, False):
            row = sweep(variant, inputs, smem)
            results[f"{variant}/{row['memory']}"] = row
            print(json.dumps({"variant": variant, **row}), flush=True)
    print(json.dumps({"all": results}))
    return results


if __name__ == "__main__":
    main()
