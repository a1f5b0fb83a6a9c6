"""K11: the steps of the int8 two-pass Hadamard decode on Hopper's tensor
cores.

The counterpart of ``experiments/probe_i8b.py``, on int8 H (a x a) and
int16 X (a x bs), with X = 256 hi + lo + 128, hi = X >> 8 and
lo = (X & 255) - 128:

  shift    float(X >> 8)
  split8   256 float(hi) + float(lo)
  dot      float(H @ hi)
  rowsum   float(128 rowsum(H)), broadcast along bs
  full     (256 H @ hi + H @ lo + 128 rowsum(H)) / 16, the body of the JAX
           package's int8 decode kernel (``ops/decode.py::_decode_kernel_i8``)

``csrc/micro_i8.cu`` runs ``dot`` and ``full`` on the int8 tensor-core
skeleton of the decode kernel (``csrc/i8_mma.cuh``, ``mma.sync``) over X as
one channel of width bs, and the other three elementwise.  All five are
exact: each must equal its plain version bit for bit, and ``full`` the exact
int64 product H @ X / 16.  ``main`` checks them at the probe's shape (a =
16, bs = 256), where a launch is a few blocks, and checks and times
``full`` and ``dot`` at the Quickstart decode's width (a = 128, bs = 128 x
4096) beside the cuBLAS float32 product, with the enqueue, back to back
and by the trace.  ``full`` is this probe's
function only: the decode (``ops/decode.py``) does not call it.  Run on the
card:

    python -m ogl_beamforming_tpu_torch.experiments.probe_i8b
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels import build
from ..utils.device import on_device
from . import card, require_gpu, three_ways_ms
from .probe_i8 import int8_matmul_ref, launch_i8_mma

A, BS = 16, 256
DECODE_A, DECODE_BS = 128, 128 * 4096
ITERS = 20
BODIES = ("shift", "split8", "dot", "rowsum", "full")
FULL_SCALE = np.float32(1.0 / 16)
_MMA_BODY = {"dot": 2, "full": 3}                  # csrc/micro_i8.cu Body
_ELEMENTWISE = {"shift": 0, "split8": 1, "rowsum": 2}


def make_inputs(device, a=A, bs=BS, seed=11) -> dict:
    """The TPU file's inputs (H = sign of a normal draw, X uniform over
    [-32768, 32767)), drawn from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    h = np.sign(rng.standard_normal((a, a))).astype(np.int8)
    x = rng.integers(-32768, 32767, (a, bs)).astype(np.int16)
    return {"h": torch.from_numpy(h).to(device),
            "x": torch.from_numpy(x).to(device)}


def split(x: torch.Tensor):
    """int16 X -> (hi, lo) int8 with X = 256 hi + lo + 128."""
    hi = (x >> 8).to(torch.int8)
    lo = ((x & 255) - 128).to(torch.int8)
    return hi, lo


def rowsum128(h: torch.Tensor) -> torch.Tensor:
    return h.to(torch.int32).sum(dim=1, keepdim=True) * 128


def k_ref(body: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain torch: the TPU body ``k_<body>`` on ``h`` (a, a) int8 and ``x``
    (a, bs) int16, as float32 (a, bs)."""
    if body == "shift":
        return (x >> 8).to(torch.float32)
    hi, lo = split(x)
    if body == "split8":
        return hi.to(torch.float32) * 256 + lo.to(torch.float32)
    if body == "dot":
        return int8_matmul_ref(h, hi).to(torch.float32)
    if body == "rowsum":
        return rowsum128(h).to(torch.float32).expand(x.shape).contiguous()
    if body == "full":
        acc = int8_matmul_ref(h, hi) * 256 + int8_matmul_ref(h, lo) \
            + rowsum128(h)
        return acc.to(torch.float32) * torch.tensor(FULL_SCALE,
                                                    device=x.device)
    raise ValueError(f"unknown body {body!r}")


def k(body: str, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The body ``k_<body>``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if not h.is_cuda:
        if h.device.type != "cpu":
            raise ValueError(f"no kernel for device {h.device}")
        return k_ref(body, h, x)
    if body in _MMA_BODY:
        return launch_i8_mma(_MMA_BODY[body], h, x, torch.float32,
                             FULL_SCALE if body == "full" else 1.0)
    a, bs = x.shape if x.dim() == 2 else (0, 0)
    if not (x.device == h.device and x.dtype == torch.int16 and bs > 0
            and h.dtype == torch.int8 and h.shape == (a, a)
            and h.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"k({body!r}) needs contiguous int8 h (a, a) and "
                         f"int16 x (a, bs) on one CUDA device, got h "
                         f"{h.dtype} {tuple(h.shape)} on {h.device}, x "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty((a, bs), dtype=torch.float32, device=x.device)
    lib = build.library()
    with on_device(x):
        code = lib.micro_i8_elementwise(
            _ELEMENTWISE[body], h.data_ptr(), x.data_ptr(), out.data_ptr(),
            a, bs, torch._C._cuda_getCurrentRawStream(x.device.index))
    build.check("micro_i8_elementwise", code)
    build.count_launch("micro_i8", "i8_rowsum_kernel" if body == "rowsum"
                       else "i8_elementwise_kernel")
    return out


def full_exact(h: torch.Tensor, x: torch.Tensor) -> np.ndarray:
    """The exact H @ X / 16 (int64 product on the host, float64)."""
    prod = h.cpu().to(torch.int64) @ x.cpu().to(torch.int64)
    return prod.numpy().astype(np.float64) / 16.0


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    x = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    results = {}
    for body in BODIES:
        out = k(body, x["h"], x["x"])
        equal = torch.equal(out, k_ref(body, x["h"], x["x"]))
        results[body] = {"ok": equal, "mean": float(out.mean())}
        print(json.dumps({body: results[body]}), flush=True)
    err = float(np.abs(k("full", x["h"], x["x"]).cpu().numpy()
                       - full_exact(x["h"], x["x"])).max())
    print(json.dumps({"full_max_err": err}), flush=True)
    wide = make_inputs(dev, DECODE_A, DECODE_BS)
    x32 = wide["x"].to(torch.float32)
    h32 = wide["h"].to(torch.float32)
    results["decode_width"] = {"shape": [DECODE_A, DECODE_BS]}
    for body in ("full", "dot"):
        equal = torch.equal(k(body, wide["h"], wide["x"]),
                            k_ref(body, wide["h"], wide["x"]))
        results["decode_width"][body] = {
            "ok": equal, **three_ways_ms(lambda body=body: k(
                body, wide["h"], wide["x"]), iters=ITERS)}
    results["decode_width"]["cublas_f32_matmul"] = three_ways_ms(
        lambda: torch.matmul(h32, x32), iters=ITERS)
    print(json.dumps({"decode_width": results["decode_width"]}), flush=True)
    return results


if __name__ == "__main__":
    main()
