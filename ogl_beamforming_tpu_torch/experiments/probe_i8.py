"""K10: int8 x int8 -> int32 products on Hopper's tensor cores.

The counterpart of ``experiments/probe_i8.py``: A (128, 128) int8 @ B (128,
256) int8, read out as int32 (``i8i8i32``) and as float32 (``i8i8f32``), by
the int8 tensor-core skeleton (``mma.sync``) that the decode kernel runs
(``csrc/i8_mma.cuh``, ``csrc/micro_i8.cu``).  Both must equal the exact int64
product.  ``main`` checks them, times them with the enqueue, back to back
and by the trace beside ``torch._int_mm`` on the same operands as the
yardstick (the port never calls it), and splits the host's share of a
call.  Run on the card:

    python -m ogl_beamforming_tpu_torch.experiments.probe_i8
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..kernels import build
from . import card, host_us, require_gpu, three_ways_ms

M = K = 128
N = 256
ITERS = 20
BODIES = {"i8i8i32": torch.int32, "i8i8f32": torch.float32}
_MMA_BODY = {torch.int32: 0, torch.float32: 1}    # csrc/micro_i8.cu Body
MAX_K = 128


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
    """One launch of ``micro_i8_mma`` (``csrc/micro_i8.cu``): square int8
    ``a`` (K x K, 0 < K <= :data:`MAX_K`) and ``b`` (K x N), int8 for the
    K10 bodies (0, 1) and int16 for K11's (2, 3), both contiguous on one
    CUDA device.  Raises ``ValueError`` for any other input.  The launch
    runs on the current stream, taken as its raw handle
    (``torch.cuda.current_stream`` builds a ``Stream`` object on every
    call, a few microseconds of a launch this short)."""
    k, n = b.shape if b.dim() == 2 else (0, 0)
    if not (a.is_cuda and b.device == a.device and a.dtype == torch.int8
            and b.dtype == (torch.int8 if body < 2 else torch.int16)
            and a.shape == (k, k) and 0 < k <= MAX_K and n > 0
            and a.is_contiguous() and b.is_contiguous()):
        raise ValueError(
            f"micro_i8_mma needs contiguous int8 a (K, K) and b (K, N) "
            f"({'int8' if body < 2 else 'int16'}) on one CUDA device, "
            f"0 < K <= {MAX_K}; got a {a.dtype} {tuple(a.shape)} on "
            f"{a.device}, b {b.dtype} {tuple(b.shape)} on {b.device}")
    out = torch.empty((k, n), dtype=out_dtype, device=a.device)
    build.check("micro_i8_mma", build.library().micro_i8_mma(
        body, a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n,
        scale, torch._C._cuda_getCurrentRawStream(a.device.index)))
    build.count_launch("micro_i8", "i8_mma_kernel")
    return out


def kernel2(a, b, out_dtype=torch.int32) -> torch.Tensor:
    """``kernel2``: the tensor-core kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if a.is_cuda:
        return launch_i8_mma(_MMA_BODY[out_dtype], a, b, out_dtype)
    if a.device.type != "cpu":
        raise ValueError(f"no kernel for device {a.device}")
    return kernel2_ref(a, b, out_dtype)


def host_breakdown(x: dict) -> dict:
    """Host microseconds per call, enqueue only, of K10 through
    :func:`kernel2`, of its parts (the output's allocation by
    ``torch.empty`` and by ``new_empty``, the current stream as a
    ``Stream`` object and as the raw handle the wrapper takes, the ctypes
    call on prepared arguments with the launch and, refused at the C
    entry's check, without it) and of ``torch._int_mm``: how much of a
    single call's time is the host's."""
    a, b = x["a"], x["b"]
    k, n = b.shape
    out = torch.empty((k, n), dtype=torch.int32, device=a.device)
    lib = build.library()
    args = [0, a.data_ptr(), b.data_ptr(), out.data_ptr(), k, n, 1.0,
            torch._C._cuda_getCurrentRawStream(a.device.index)]
    refused = args[:4] + [0] + args[5:]          # K = 0: no launch
    return {"kernel2": host_us(lambda: kernel2(a, b)),
            "torch_empty": host_us(lambda: torch.empty(
                (k, n), dtype=torch.int32, device=a.device)),
            "new_empty": host_us(lambda: a.new_empty(
                (k, n), dtype=torch.int32)),
            "stream_object": host_us(
                lambda: torch.cuda.current_stream(a.device).cuda_stream),
            "raw_stream": host_us(
                lambda: torch._C._cuda_getCurrentRawStream(a.device.index)),
            "ctypes_launch": host_us(lambda: lib.micro_i8_mma(*args)),
            "ctypes_no_launch": host_us(lambda: lib.micro_i8_mma(*refused)),
            "torch._int_mm": host_us(lambda: torch._int_mm(a, b))}


def main(device="cuda") -> dict:
    dev = require_gpu(device)
    x = make_inputs(dev)
    print(json.dumps(card()), flush=True)
    exact = x["a"].cpu().to(torch.int64) @ x["b"].cpu().to(torch.int64)
    results = {}
    for name, od in BODIES.items():
        err = float((kernel2(x["a"], x["b"], od).cpu().to(torch.float64)
                     - exact).abs().max())
        results[name] = {"ok": err == 0.0, "max_err": err,
                         **three_ways_ms(lambda od=od: kernel2(
                             x["a"], x["b"], od), iters=ITERS)}
        print(json.dumps({name: results[name]}), flush=True)
    results["torch._int_mm"] = three_ways_ms(
        lambda: torch._int_mm(x["a"], x["b"]), iters=ITERS)
    results["host_us"] = host_breakdown(x)
    for key in ("torch._int_mm", "host_us"):
        print(json.dumps({key: results[key]}), flush=True)
    return results


if __name__ == "__main__":
    main()
