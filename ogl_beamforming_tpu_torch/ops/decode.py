"""Hadamard decode: the torch counterpart of ``ogl_beamforming_tpu.ops.decode``.

``out[c, t, s] = (1/T) * sum_j H[t, j] * rf[c, j, s]`` over the acquisition
axis, written as float32 (C, A, S) (complex64 for complex input).

:func:`decode_hadamard_ref` is the plain-torch twin; :func:`decode_hadamard`
dispatches on the tensor's device: a CPU tensor takes the twin, a CUDA tensor
takes the hand-written kernel (``csrc/decode.cu``) or raises: int16 input
runs on the int8 tensor cores (two exact int8 halves, bit for bit the twin),
float32 and complex64 on the bf16 tensor cores (three exact bf16 terms,
within 1e-6 of the peak), for any order up to :data:`MAX_ORDER`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..utils.hadamard import hadamard as _hadamard_host


MAX_ORDER = 256
"""Largest order A the kernels take (the reference's emission limit)."""


def hadamard_matrix(order: int, device, dtype=torch.float32) -> torch.Tensor:
    """Hadamard matrix H (row-major, untransposed) on ``device``."""
    return torch.as_tensor(_hadamard_host(order), dtype=dtype, device=device)


def _inv_order(a: int) -> np.float32:
    # The f32 constant 1/T, multiplied in: for T = 12 dividing by T rounds
    # differently, and the JAX package multiplies.
    return np.float32(1.0 / a)


def decode_hadamard_ref(rf: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain-torch decode of ``rf`` (C, A, S) int16, float32 or complex64
    with ``h`` (A, A).  A float32 matmul: exact for int16 input, since every
    partial sum is an integer below 2**24 (TF32 is off, see the package
    ``__init__``)."""
    if rf.is_complex():
        return torch.complex(decode_hadamard_ref(rf.real.contiguous(), h),
                             decode_hadamard_ref(rf.imag.contiguous(), h))
    a = rf.shape[1]
    y = torch.matmul(h.to(device=rf.device, dtype=torch.float32),
                     rf.to(torch.float32))
    return y * torch.tensor(_inv_order(a), device=rf.device)


def decode_hadamard_cuda(rf: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA decode kernel.  ``rf``: contiguous CUDA (C, A, S)
    int16, float32 or complex64; ``h``: (A, A) with entries +-1 (a Hadamard
    or Walsh matrix) on the same device; 0 < A <= :data:`MAX_ORDER`."""
    if not rf.is_cuda or h.device != rf.device:
        raise ValueError("decode_hadamard_cuda needs rf and h on one CUDA "
                         f"device, got {rf.device} and {h.device}")
    if rf.dim() != 3 or h.shape != (rf.shape[1], rf.shape[1]):
        raise ValueError(f"rf must be (C, A, S) and h (A, A); got "
                         f"{tuple(rf.shape)} and {tuple(h.shape)}")
    if not 0 < rf.shape[1] <= MAX_ORDER:
        raise ValueError(f"decode kernel takes orders 1..{MAX_ORDER}, got "
                         f"{rf.shape[1]}")
    if not rf.is_contiguous():
        raise ValueError("rf must be contiguous")
    cplx = rf.is_complex()
    if cplx:
        if rf.dtype != torch.complex64:
            raise ValueError(f"complex rf must be complex64, got {rf.dtype}")
        # interleave re|im along S: the contraction over A commutes with it
        rf = torch.view_as_real(rf).reshape(rf.shape[0], rf.shape[1], -1)
    if rf.dtype == torch.int16:
        entry = "decode_int16"
    elif rf.dtype == torch.float32:
        entry = "decode_f32"
    else:
        raise ValueError(f"rf dtype {rf.dtype} not supported "
                         "(int16, float32, complex64)")
    c, a, s = rf.shape
    h8 = h.to(torch.int8).contiguous()
    out = torch.empty((c, a, s), dtype=torch.float32, device=rf.device)
    lib = build.library()
    stream = torch.cuda.current_stream(rf.device).cuda_stream
    code = getattr(lib, entry)(rf.data_ptr(), h8.data_ptr(), out.data_ptr(),
                               c, a, s, float(_inv_order(a)), stream)
    build.check(entry, code)
    build.count_launch("decode_hadamard", "decode_i8_kernel"
                       if entry == "decode_int16" else "decode_f32_kernel")
    if cplx:
        out = torch.view_as_complex(out.view(c, a, s // 2, 2))
    return out


def decode_hadamard(rf: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Decode ``rf`` (C, A, S) with ``h`` (A, A): the CUDA kernel for a CUDA
    tensor, the plain twin for a CPU tensor.  float16 RF (Float16 wire
    data) is decoded as its float32 values, exactly, as the JAX package's
    decode casts it."""
    if rf.is_cuda:
        if rf.dtype == torch.float16:
            rf = rf.to(torch.float32)
        return decode_hadamard_cuda(rf, h)
    if rf.device.type != "cpu":
        raise ValueError(f"no decode for device {rf.device}")
    return decode_hadamard_ref(rf, h)
