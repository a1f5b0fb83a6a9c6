"""JAX plan parameters -> this package's tensors.

The port never imports jax, so the caller converts a JAX plan's dynamic
parameters to numpy first (``jax.tree.map(np.asarray, plan.dyn)``) and
:func:`dyn_from_numpy` places them on a torch device with their dtypes kept:
``hadamard{i}`` and ``taps{i}`` of the pre-DAS stages, the top-level
frequencies, and every key of the DAS dict, ``channel_offset`` and
``x_offset`` included.
"""

from __future__ import annotations

import numpy as np
import torch


def dyn_from_numpy(dyn: dict, device="cpu") -> dict:
    """Nested dict of numpy arrays (or scalars) -> same keys, tensors on
    ``device``."""
    return {k: dyn_from_numpy(v, device) if isinstance(v, dict)
            else torch.tensor(np.asarray(v), device=device)
            for k, v in dyn.items()}
