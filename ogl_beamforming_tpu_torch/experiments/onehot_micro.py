"""K8: can one-hot matrix-product interpolation beat the gather path?  On
Hopper.

The counterpart of ``experiments/onehot_micro.py``, UNITS = 16 units per
block in STEPS = 256 blocks, each path timed alone:

  gather_hermite  the DAS kernel's cubic-tap bundle: per unit a (16, 128)
                  voxel tile x 2 positions of (index ops, 2 int32 gathers
                  from row 0, unpack, 4 multiply-adds); 16 voxel rows and 1
                  frame per unit (``csrc/micro_gather.cu``)
  onehot_mxu_B    per unit a 4-tap banded weight matrix built from compares
                  on a (128, 128) tile and one (B, 128) @ (128, 128) bf16
                  tensor-core product; 1 voxel row and B frames per unit, for
                  B in {8, 32, 128} (``csrc/micro_onehot.cu``)

Reports ns per (128-voxel row x 128-sample chunk x frame), the kernel time
(from a profiler trace) of all blocks over all their work.  The ``u & 3`` offsets repeat every four units,
so the compiler may load the gathers of four units once: K9
(``onehot_micro2``) has unique offsets.  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.onehot_micro
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (LANE, ONEHOT_BATCHES, ROWS, card, check_gather_args,
               check_onehot_args, gather_hermite, gather_hermite_ref,
               launch_gather_hermite, launch_ms, launch_onehot, onehot,
               onehot_ref, require_gpu, traced_ms)

STEPS = 256
UNITS = 16
ITERS = 20
K8_FORM = True


def gather_kernel_ref(src, src2, idx, w, units=UNITS, steps=1):
    """Plain torch: the TPU body ``gather_kernel`` (offsets ``pos + (u &
    3)``, row 0)."""
    return gather_hermite_ref(src, src2, idx, w, units, K8_FORM, steps)


def gather_kernel(src, src2, idx, w, units=UNITS, steps=STEPS, smem=True):
    """``gather_kernel``'s tile: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return gather_hermite(src, src2, idx, w, units, K8_FORM, steps, smem)


def onehot_kernel_ref(rf, k, wt, units=UNITS, steps=1):
    """Plain torch: the TPU body ``make_onehot(B).kernel`` (offsets
    ``t + (u & 3)``)."""
    return onehot_ref(rf, k, wt, units, K8_FORM, steps)


def onehot_kernel(rf, k, wt, units=UNITS, steps=STEPS):
    """``make_onehot(B).kernel``'s tile: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    return onehot(rf, k, wt, units, K8_FORM, steps)


def make_inputs(device) -> dict:
    """The TPU file's inputs (``default_rng(7)``) on ``device``: the gather
    path's tiles, the voxel sample indices and tap weights, and one RF block
    per B."""
    rng = np.random.default_rng(7)
    arrays = dict(
        idx=rng.integers(1, LANE - 8, (ROWS, LANE), np.int32),
        w=rng.standard_normal((ROWS, LANE)).astype(np.float32),
        src=rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(np.int32),
        src2=rng.integers(-2 ** 30, 2 ** 30, (ROWS, LANE)).astype(np.int32),
        kvox=rng.integers(1, LANE - 8, (8, LANE), np.int32),
        wt4=rng.standard_normal((8, LANE)).astype(np.float32))
    for b in ONEHOT_BATCHES:
        arrays[f"rf{b}"] = rng.standard_normal((b, LANE)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def measure(x, iters=ITERS) -> dict:
    """Time the gather path in both memory spaces and the one-hot path at
    each B (on the card); prints one JSON line each."""
    n_units = STEPS * UNITS
    results = {}
    for smem in (True, False):
        check_gather_args(x["src"], x["src2"], x["idx"], x["w"], True)
        def launch(smem=smem):
            return launch_gather_hermite(K8_FORM, x["src"], x["src2"],
                                         x["idx"], x["w"], UNITS, STEPS, smem)

        ms = traced_ms(launch, iters=iters)
        label = f"gather_hermite/{'shared' if smem else 'global'}"
        results[label] = {"us": launch_ms(launch, iters=iters) * 1e3,
                          "kernel_us": ms * 1e3,
                          "ns_per_voxelrow_chunk": ms * 1e6 / (n_units * ROWS)}
        print(json.dumps({"variant": label, **results[label]}), flush=True)
    for b in ONEHOT_BATCHES:
        rf = x[f"rf{b}"]
        check_onehot_args(rf, x["kvox"], x["wt4"])
        def launch(rf=rf):
            return launch_onehot(rf, x["kvox"], x["wt4"], UNITS, K8_FORM,
                                 STEPS)

        ms = traced_ms(launch, iters=iters)
        label = f"onehot_mxu_B{b}"
        results[label] = {"us": launch_ms(launch, iters=iters) * 1e3,
                          "kernel_us": ms * 1e3,
                          "ns_per_voxelrow_chunk_per_frame":
                              ms * 1e6 / n_units / b}
        print(json.dumps({"variant": label, **results[label]}), flush=True)
    return results


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    x = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    results = measure(x)
    print(json.dumps({"all": results}))
    return results


if __name__ == "__main__":
    main()
