"""Display mapping and frame reductions: the torch counterpart of
``ogl_beamforming_tpu.ops.display``.

The reference's Sum and MinMax shaders (shaders/sum.glsl,
shaders/min_max.glsl) and the fragment shader's display transfer function
(render_3d.frag.glsl:61-70), in plain torch on the tensor's device: each is
one or two elementwise passes and a reduction, which torch's own kernels
run at the memory rate, and the JAX package writes them in ``jnp``, not
Pallas.
"""

from __future__ import annotations

import torch


def sum_frames(frames: torch.Tensor, scale=None) -> torch.Tensor:
    """Average a stack of frames (sum.glsl: out += scale * in per frame;
    ``scale`` defaults to 1 / the number of frames)."""
    if scale is None:
        scale = 1.0 / frames.shape[0]
    return frames.sum(dim=0) * scale


def min_max(volume: torch.Tensor):
    """Global min and max of |volume| (min_max.glsl's reduction endpoint)."""
    mag = torch.abs(volume)
    return mag.min(), mag.max()


def display_map(volume: torch.Tensor, db_cutoff=-60.0, threshold=1.0,
                gamma=1.0) -> torch.Tensor:
    """Normalize -> dB -> clamp -> threshold -> gamma
    (render_3d.frag.glsl:61-70).  Returns float32 values in [0, 1]."""
    mag = torch.abs(volume).to(torch.float32)
    peak = torch.clamp(mag.max(), min=1e-30)
    db = 20.0 * torch.log10(torch.clamp(mag / peak, min=1e-30))
    db = torch.clamp(db, db_cutoff, 0.0)
    out = 1.0 - db / db_cutoff
    out = torch.clamp(out, max=threshold)
    return torch.pow(out, gamma)
