"""Hadamard decode (``shaders/decode.glsl``): acquisition ``i`` of the
decoded frame is ``(1 / A) sum_j H[i, j] x[j]``, for each channel and
sample, with ``H`` the Sylvester Hadamard matrix of order ``A``."""

from __future__ import annotations

import numpy as np
import torch


def hadamard(order: int) -> np.ndarray:
    """The Sylvester Hadamard matrix of a power-of-two order, float32 (the
    upstream's other orders, 12 and 20 times a power of two, raise)."""
    if order < 1 or order & (order - 1):
        raise ValueError(f"the reference builds power-of-two Hadamard "
                         f"orders only, not {order}")
    h = np.ones((1, 1), np.float32)
    while h.shape[0] < order:
        h = np.block([[h, h], [h, -h]])
    return h


def decode(rf: torch.Tensor) -> torch.Tensor:
    """Decode ``rf`` (C, A, S), real or complex, in float32 (TF32 off)."""
    if rf.is_complex():
        return torch.complex(decode(rf.real.contiguous()),
                             decode(rf.imag.contiguous()))
    a = rf.shape[1]
    h = torch.from_numpy(hadamard(a)).to(rf.device)
    y = torch.matmul(h, rf.to(torch.float32))
    return y * float(np.float32(1.0 / a))


def stage(cfg: dict, st: dict, x: torch.Tensor,
          voxel_block: int) -> torch.Tensor:
    """The pipeline's Decode stage (``chain.run_stages``)."""
    mode = cfg["parameters"]["decode_mode"]
    if mode != "Hadamard":
        raise ValueError(f"decode mode {mode!r} is not in the reference")
    return decode(x)
