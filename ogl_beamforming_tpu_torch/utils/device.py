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


class on_device:
    """Context manager: make the card that holds ``t`` (a tensor or a
    device) the current CUDA device for the block, and make the previous
    one current again after it.  Every kernel launcher takes its stream
    handle (:func:`launch_stream`) and calls its C entry point inside it:
    the CUDA runtime reads a default stream's handle, 0, on the current
    device, and the entry points keep their per-card caches (the shared
    memory limit, the persistent grid, the kernels' attributes) under
    ``cudaGetDevice``.  It switches only when another card is current, so
    the common case costs one ``torch.cuda.current_device()``; a CPU
    tensor switches nothing."""

    __slots__ = ("_index", "_prev")

    def __init__(self, t):
        dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
        self._index = dev.index if dev.type == "cuda" else None
        self._prev = None

    def __enter__(self):
        if self._index is not None:
            prev = torch.cuda.current_device()
            if prev != self._index:
                torch.cuda.set_device(self._index)
                self._prev = prev
        return self

    def __exit__(self, *exc):
        if self._prev is not None:
            torch.cuda.set_device(self._prev)
            self._prev = None
        return False


def launch_stream(t) -> int:
    """The raw handle of the current stream of the card that holds ``t``,
    for a launch made inside :class:`on_device` of ``t``."""
    return torch.cuda.current_stream(t.device).cuda_stream


def sync(array) -> None:
    """Wait until the device has finished the work producing ``array`` (a
    tensor, or a tuple or list of them; a no-op for CPU tensors, which are
    computed synchronously)."""
    if isinstance(array, (tuple, list)):
        for t in array:
            sync(t)
    elif isinstance(array, torch.Tensor) and array.is_cuda:
        torch.cuda.synchronize(array.device)


def to_host(array) -> np.ndarray:
    """Tensor -> numpy array on the host (complex stays complex64)."""
    if isinstance(array, np.ndarray):
        return array
    return array.detach().cpu().numpy()


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
