"""K9: one-hot matrix-product interpolation against the gather path by the
slope method, on Hopper.

The counterpart of ``experiments/onehot_micro2.py``: as K8
(``onehot_micro``), with offsets unique to each unit (the gather path at
``pos + 2 u`` from its own row, the one-hot path at ``t + 4 u``), STEPS =
2048 blocks, and each path timed at UNITS in {4, 12, 28}; the slope of time
over UNITS gives the cost of one unit in every block with the constant
terms cancelled:

  gather_hermite  16 voxel rows x 1 frame per unit (``csrc/micro_gather.cu``)
  onehot_mxu_B    1 voxel row x B frames per unit, B in {8, 32, 128}
                  (``csrc/micro_onehot.cu``)

Reports ns per (128-voxel row x 128-sample chunk x frame): slope / STEPS /
(rows x frames per unit), the time of all SMs over the work.  Run on the
card:

    python -m ogl_beamforming_tpu_torch.experiments.onehot_micro2
"""

from __future__ import annotations

import json

from . import (ONEHOT_BATCHES, ROWS, card, check_gather_args,
               check_onehot_args, gather_hermite, gather_hermite_ref,
               launch_gather_hermite, launch_ms, launch_onehot, onehot,
               onehot_ref, require_gpu, slope)
from .onehot_micro import make_inputs  # noqa: F401  (the same draws)

STEPS = 2048
UNITS_SWEEP = (4, 12, 28)
ITERS = 20
K8_FORM = False


def gather_kernel_ref(src, src2, idx, w, units, steps=1):
    """Plain torch: the TPU body ``make_gather(units).kernel`` (offsets
    ``pos + 2 u``, own row)."""
    return gather_hermite_ref(src, src2, idx, w, units, K8_FORM, steps)


def gather_kernel(src, src2, idx, w, units, steps=STEPS, smem=True):
    """``make_gather(units).kernel``'s tile: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return gather_hermite(src, src2, idx, w, units, K8_FORM, steps, smem)


def onehot_kernel_ref(rf, k, wt, units, steps=1):
    """Plain torch: the TPU body ``make_onehot(B, units).kernel`` (offsets
    ``t + 4 u``)."""
    return onehot_ref(rf, k, wt, units, K8_FORM, steps)


def onehot_kernel(rf, k, wt, units, steps=STEPS):
    """``make_onehot(B, units).kernel``'s tile: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return onehot(rf, k, wt, units, K8_FORM, steps)


def _fit(launch, rows_per_unit, frames_per_unit, units_sweep, iters):
    times = [launch_ms(lambda u=u: launch(u), iters=iters)
             for u in units_sweep]
    unit_ns = slope(units_sweep, times) * 1e6 / STEPS
    return {"us": [t * 1e3 for t in times], "unit_ns": unit_ns,
            "ns_per_voxelrow_frame":
                unit_ns / (rows_per_unit * frames_per_unit)}


def sweep_gather(x, smem=True, units_sweep=UNITS_SWEEP, iters=ITERS) -> dict:
    """The gather path's slope (on the card)."""
    check_gather_args(x["src"], x["src2"], x["idx"], x["w"], True)
    return _fit(lambda u: launch_gather_hermite(
        K8_FORM, x["src"], x["src2"], x["idx"], x["w"], u, STEPS, smem),
        ROWS, 1, units_sweep, iters)


def sweep_onehot(x, batch, units_sweep=UNITS_SWEEP, iters=ITERS) -> dict:
    """The one-hot path's slope at frame batch ``batch`` (on the card)."""
    rf = x[f"rf{batch}"]
    check_onehot_args(rf, x["kvox"], x["wt4"])
    return _fit(lambda u: launch_onehot(rf, x["kvox"], x["wt4"], u, K8_FORM,
                                        STEPS), 1, batch, units_sweep, iters)


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    x = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    results = {}
    for smem in (True, False):
        label = f"gather_hermite/{'shared' if smem else 'global'}"
        results[label] = sweep_gather(x, smem)
        print(json.dumps({"variant": label, **results[label]}), flush=True)
    for b in ONEHOT_BATCHES:
        label = f"onehot_mxu_B{b}"
        results[label] = sweep_onehot(x, b)
        print(json.dumps({"variant": label, **results[label]}), flush=True)
    print(json.dumps({"all": results}))
    return results


if __name__ == "__main__":
    main()
