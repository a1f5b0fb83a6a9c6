"""Coherence-factor weighting (shaders/coherency_weighting.glsl): the torch
counterpart of ``ogl_beamforming_tpu.ops.coherency``."""

from __future__ import annotations

import torch


def coherency_weighting(coherent: torch.Tensor, incoherent: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """``coherent *= scale * coherent / incoherent`` per voxel.

    For IQ data the GLSL ``vec2 * vec2`` product is componentwise: each of
    re/im is squared and divided by the (scalar) incoherent sum, not a
    complex multiply.  Zero incoherent energy maps to zero output.
    """
    w = torch.where(incoherent != 0, scale / incoherent, 0.0)
    if coherent.is_complex():
        re, im = coherent.real, coherent.imag
        return torch.complex(re * re * w, im * im * w)
    return coherent * coherent * w
