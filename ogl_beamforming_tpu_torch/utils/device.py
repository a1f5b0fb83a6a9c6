"""Device helpers: the torch counterpart of ``ogl_beamforming_tpu.utils.transfer``.

Every entry point of the port takes an explicit ``device``; there is no
global default device and no silent substitution of the CPU for a missing GPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  Raises ``RuntimeError`` when a CUDA
    device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but "
                           "torch.cuda.is_available() is False")
    return dev


def sync(tensor) -> None:
    """Wait until the device has finished the work producing ``tensor``
    (a no-op for CPU tensors, which are computed synchronously)."""
    if isinstance(tensor, (tuple, list)):
        for t in tensor:
            sync(t)
    elif isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def to_host(tensor) -> np.ndarray:
    """Tensor -> numpy array on the host (complex stays complex64)."""
    if isinstance(tensor, np.ndarray):
        return tensor
    return tensor.detach().cpu().numpy()


def event_seconds(fn, iters: int, warmup: int) -> float:
    """Seconds one call of ``fn`` takes on the card: CUDA events around
    ``iters`` calls after ``warmup`` calls (the autotuners' timer)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / max(iters, 1)
