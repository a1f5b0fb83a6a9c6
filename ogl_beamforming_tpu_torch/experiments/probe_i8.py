"""K10: int8 x int8 -> int32 products on Hopper's tensor cores.

The counterpart of ``experiments/probe_i8.py``: A (128, 128) int8 @ B (128,
256) int8, read out as int32 (``i8i8i32``) and as float32 (``i8i8f32``), by
the hand-written WMMA kernel of ``csrc/micro_i8.cu``.  Both must equal the
exact int64 product.  ``main`` checks both, times them, and times
``torch._int_mm`` on the same operands as the yardstick (the port never
calls it).  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.probe_i8
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import card, check_cuda, launch_ms, require_gpu

M = K = 128
N = 256
ITERS = 20
BODIES = {"i8i8i32": torch.int32, "i8i8f32": torch.float32}
_MMA_BODY = {torch.int32: 0, torch.float32: 1}    # csrc/micro_i8.cu Body


def make_inputs(device) -> dict:
    """The TPU file's operand ranges (A in [-2, 2), B in [-128, 128)),
    drawn from ``default_rng(10)``."""
    rng = np.random.default_rng(10)
    a = rng.integers(-2, 2, (M, K)).astype(np.int8)
    b = rng.integers(-128, 128, (K, N)).astype(np.int8)
    return {"a": torch.from_numpy(a).to(device),
            "b": torch.from_numpy(b).to(device)}


def int8_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch: int8 (K x K) @ (K x N) as int32.  A float32 product is
    exact here: every partial sum is an integer of magnitude at most
    K 128^2 <= 2^21 < 2^24 for K <= 128 (TF32 is off, see the package
    ``__init__``)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32)).to(
        torch.int32)


def kernel2_ref(a, b, out_dtype=torch.int32) -> torch.Tensor:
    """Plain torch: the TPU body ``kernel2`` with ``preferred_element_type
    = out_dtype``."""
    return int8_matmul_ref(a, b).to(out_dtype)


def launch_i8_mma(body: int, a, b, out_dtype, scale=1.0) -> torch.Tensor:
    """One launch of ``micro_i8_mma``: square int8 ``a`` (K x K), ``b``
    int8 (K10) or int16 (K11) K x N, K a multiple of 16 up to 128, N of
    64."""
    from ..kernels import build
    check_cuda(a, b)
    k, n = b.shape
    if a.dtype != torch.int8 or a.shape != (k, k) or not a.is_contiguous() \
            or not b.is_contiguous():
        raise ValueError(f"a must be contiguous int8 ({k}, {k}) and b "
                         f"contiguous, got {a.dtype} {tuple(a.shape)}")
    if k % 16 or k > 128 or n % 64:
        raise ValueError(f"K must be a multiple of 16 up to 128 and N of 64, "
                         f"got {k}, {n}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must start on a 16-byte boundary (the "
                         "kernel reads them in words)")
    out = torch.empty((k, n), dtype=out_dtype, device=a.device)
    code = build.library().micro_i8_mma(
        body, a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n,
        float(scale), torch.cuda.current_stream(a.device).cuda_stream)
    build.check("micro_i8_mma", code)
    build.LAUNCHES["micro_i8"] += 1
    return out


def kernel2(a, b, out_dtype=torch.int32) -> torch.Tensor:
    """``kernel2``: the tensor-core kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.is_cuda:
        if b.dtype != torch.int8:
            raise ValueError(f"b must be int8, got {b.dtype}")
        return launch_i8_mma(_MMA_BODY[out_dtype], a, b, out_dtype)
    if a.device.type != "cpu":
        raise ValueError(f"no kernel for device {a.device}")
    return kernel2_ref(a, b, out_dtype)


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    x = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    exact = x["a"].cpu().to(torch.int64) @ x["b"].cpu().to(torch.int64)
    results = {}
    for name, od in BODIES.items():
        out = kernel2(x["a"], x["b"], od)
        err = float((out.cpu().to(torch.float64) - exact).abs().max())
        ms = launch_ms(lambda od=od: kernel2(x["a"], x["b"], od),
                       iters=ITERS)
        results[name] = {"ok": err == 0.0, "max_err": err, "us": ms * 1e3}
        print(json.dumps({name: results[name]}), flush=True)
    lib = launch_ms(lambda: torch._int_mm(x["a"], x["b"]), iters=ITERS)
    results["torch._int_mm"] = {"us": lib * 1e3}
    print(json.dumps({"torch._int_mm": results["torch._int_mm"]}),
          flush=True)
    return results


if __name__ == "__main__":
    main()
