"""K6: the DAS tap's inner loop piece by piece, on Hopper.

The counterpart of ``experiments/gather_micro2.py``: eight variants of the
gather bundle, REPS = 64 repetitions per element of a (16, 128) tile into 8
chains, for STEPS = 512 grid steps (the port's persistent kernel takes
every step's elements), each timed alone, by CUDA events around its
launches and by its kernel time in a profiler trace (no sweep):

  f32_direct        float32 source, index (idx + (r & 3)) & 127
  i32_direct        the same with an int32 source
  bcast_hoist       int32 row 0 broadcast to every row
  bcast_chunk       row 0 broadcast, index idx
  idx_fresh         row 0 broadcast; add, unsigned compare, mask, select,
                    gather, multiply-add
  unpack            idx_fresh's index, hi/lo int16 unpack, 2 multiply-adds
  hermite_pair      2 gathers (value and slope planes) at one index, unpack,
                    4 multiply-adds: the DAS cubic tap
  hermite_same_src  hermite_pair with both gathers from one plane (rc, rc+1)

The ``r & 3`` indices repeat every four repetitions, so the kernel loads
each of the four gathers once an element-step (``csrc/micro_gather.cu``):
such a variant measures fewer gathers than it names.  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.gather_micro2
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (LANE, ROWS, WARP, card, check_gather_args, cycles_per_warp_op,
               expand_steps, hermite_bundle, hi16, launch_gather, launch_ms,
               lo16, require_gpu, sm_clock_mhz, sm_count,
               traced_ms)

REPS, STEPS = 64, 512
NCHAINS = 8
ITERS = 20
VARIANTS = ("f32_direct", "i32_direct", "bcast_hoist", "bcast_chunk",
            "idx_fresh", "unpack", "hermite_pair", "hermite_same_src")
VARIANT_IDS = {v: 4 + i for i, v in enumerate(VARIANTS)}  # micro_gather.cu
INT_SRC = VARIANTS[1:]
BCAST = VARIANTS[2:]
OPS_PER_REP = {"f32_direct": 4, "i32_direct": 5, "bcast_hoist": 5,
               "bcast_chunk": 3, "idx_fresh": 8, "unpack": 14,
               "hermite_pair": 13, "hermite_same_src": 13.5}


def make_inputs(device) -> dict:
    """The TPU file's inputs (``default_rng(5)``): the index and weight
    tiles, then each variant's sources drawn in the file's order."""
    rng = np.random.default_rng(5)
    out = dict(idx=rng.integers(1, LANE - 4, (ROWS, LANE), np.int32),
               w=rng.standard_normal((ROWS, LANE)).astype(np.float32))
    for variant in VARIANTS:
        if variant in INT_SRC:
            src = rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(np.int32)
            src2 = rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(
                np.int32)
        else:
            src = rng.standard_normal((ROWS, LANE)).astype(np.float32)
            src2 = src
        out[variant] = (src, src2)
    return {k: (tuple(torch.from_numpy(a).to(device) for a in v)
                if isinstance(v, tuple) else torch.from_numpy(v).to(device))
            for k, v in out.items()}


def kernel_ref(variant, src, src2, idx, w, reps=REPS, steps=1):
    """Plain torch: the (16, 128) tile of ``variant`` (the TPU body
    ``make(variant).kernel``) for ``steps`` grid steps at once."""
    src, src2, idx, w = expand_steps(steps, src, src2, idx, w)
    if variant in BCAST:
        src, src2 = (s[:, :1].expand_as(s) for s in (src, src2))
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    accs = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)] \
        * NCHAINS
    for r in range(reps):
        a = r % NCHAINS
        if variant == "bcast_chunk":
            accs[a] = accs[a] + torch.gather(src, -1, idx).to(torch.float32)
        elif variant in ("f32_direct", "i32_direct", "bcast_hoist"):
            rc = (idx + (r & 3)) & (LANE - 1)
            accs[a] = accs[a] + torch.gather(src, -1, rc).to(torch.float32)
        elif variant in ("idx_fresh", "unpack"):
            rr = idx + ((r & 3) - 1)
            sel = (rr >= 0) & (rr < LANE)
            wsel = torch.where(sel, w, zero)
            v = torch.gather(src, -1, rr & (LANE - 1))
            if variant == "idx_fresh":
                accs[a] = accs[a] + wsel * v.to(torch.float32)
            else:
                accs[a] = accs[a] + wsel * hi16(v) + wsel * lo16(v)
        elif variant == "hermite_same_src":
            if r % 2:
                continue
            rr = idx + ((r & 3) - 1)
            sel = (rr >= 0) & (rr < LANE)
            rc = rr & (LANE - 1)
            wp = torch.where(sel, w, zero)
            wm = torch.where(sel, w * 0.5, zero)
            vp = torch.gather(src, -1, rc)
            vm = torch.gather(src, -1, rc + 1)
            accs[a] = (accs[a] + wp * hi16(vp) + wm * hi16(vm)
                       + wp * lo16(vp) + wm * lo16(vm))
        elif variant == "hermite_pair":
            if r % 2:
                continue
            accs[a] = hermite_bundle(accs[a], idx, w, src, src2,
                                     (r & 3) - 1, bcast=False)
        else:
            raise ValueError(f"unknown variant {variant!r}")
    acc = accs[0]
    for x in accs[1:]:
        acc = acc + x
    return acc[-1]


def kernel(variant, src, src2, idx, w, reps=REPS, steps=STEPS, smem=True):
    """The tile of ``variant``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if src.is_cuda:
        check_gather_args(src, src2, idx, w, variant in INT_SRC)
        return launch_gather(VARIANT_IDS[variant], src, src2, idx, w, reps,
                             steps, smem)
    if src.device.type != "cpu":
        raise ValueError(f"no kernel for device {src.device}")
    return kernel_ref(variant, src, src2, idx, w, reps)


def measure(variant, inputs, smem=True, iters=ITERS) -> dict:
    """Time one launch of ``variant`` (on the card)."""
    src, src2 = inputs[variant]
    idx, w = inputs["idx"], inputs["w"]
    check_gather_args(src, src2, idx, w, variant in INT_SRC)

    def launch():
        return launch_gather(VARIANT_IDS[variant], src, src2, idx, w, REPS,
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
