"""Hadamard decode: the torch counterpart of ``ogl_beamforming_tpu.ops.decode``.

``out[c, t, s] = (1/T) * sum_j H[t, j] * rf[c, j, s]`` over the acquisition
axis, written as float32 (C, A, S) (complex64 for complex input).

:func:`decode_hadamard_ref` is the plain-torch twin; :func:`decode_hadamard`
dispatches on the tensor's device: a CPU tensor takes the twin, a CUDA tensor
takes the hand-written kernel (``csrc/decode.cu``) or raises: int16 input
runs on the int8 tensor cores (two exact int8 halves, bit for bit the twin),
float32 and complex64 on the bf16 tensor cores (three exact bf16 terms,
within 1e-6 of the peak), for any order up to :data:`MAX_ORDER`.

The int16 kernel's launch knobs are chosen per (C, A, S) shape, as the
JAX package's decode tunes its Pallas knobs: :data:`DECODE_ABLATE` (an explicit
override), then :data:`DECODE_TUNED` (installed by :func:`autotune_decode`
or :func:`load_decode_tuned`, and the shipped H100 table
``data/decode_tuned_h100.json``, loaded once on first use), then the
defaults.  The knobs change the schedule only: every output is the same
sum in the same order, bit for bit.
"""

from __future__ import annotations

import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..utils import device as device_utils
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
    or Walsh matrix) on the same device; 0 < A <= :data:`MAX_ORDER`.  An
    int16 launch takes the knobs of its shape (:func:`decode_knobs`)."""
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
    knobs, kernel = (), "decode_f32_kernel"
    if entry == "decode_int16":
        tuned = decode_knobs((c, a, s))
        knobs = (tuned.get("tile_s", I8_TILES[0][0]),
                 tuned.get("row_warps", I8_TILES[0][1]))
        kernel = ("decode_i8_kernel" if knobs == I8_TILES[0]
                  else "decode_i8_tile_kernel")
    code = getattr(lib, entry)(rf.data_ptr(), h8.data_ptr(), out.data_ptr(),
                               c, a, s, float(_inv_order(a)), *knobs, stream)
    build.check(entry, code)
    build.count_launch("decode_hadamard", kernel)
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


# Per-shape launch knobs of the int16 kernel, chosen as the JAX package's
# decode chooses its Pallas knobs.  The float32 kernel has none.

I8_TILES = ((64, 1), (128, 1), (64, 2))
"""The int16 kernel's (``tile_s``, ``row_warps``) that ``csrc/decode.cu``
instantiates, the default first: samples of a tile (8 a warp across it) and
warps across H's 16-row m-tiles."""
DECODE_KNOBS = ("tile_s", "row_warps")
"""The decode knobs, both the int16 kernel's."""

DECODE_ABLATE: dict = {}
"""Knobs that override every table (experiments)."""
DECODE_TUNED: dict = {}
"""Per-shape knobs keyed by the (C, A, S) input shape, complex input by
its interleaved (C, A, 2 S) form, as ``decode_hadamard_cuda`` launches it."""
DECODE_TUNED_PATH = (Path(__file__).resolve().parent.parent / "data"
                     / "decode_tuned_h100.json")
"""The shipped table, made on an H100 by ``python -m
ogl_beamforming_tpu_torch.pretune``."""
_DECODE_SHIPPED_LOADED = False


def check_decode_knobs(knobs: dict) -> dict:
    """``knobs`` if each names a decode knob with a value the kernels
    instantiate; ``ValueError`` otherwise (a table of another package's
    knobs fails here, it is not ignored)."""
    bad = set(knobs) - set(DECODE_KNOBS)
    if bad:
        raise ValueError(f"unknown decode knobs {sorted(bad)} (the port's: "
                         f"{', '.join(DECODE_KNOBS)})")
    tile = (knobs.get("tile_s", I8_TILES[0][0]),
            knobs.get("row_warps", I8_TILES[0][1]))
    if tile not in I8_TILES:
        raise ValueError(f"(tile_s, row_warps) = {tile} is not one of "
                         f"{I8_TILES}")
    return knobs


def _decode_rows(path) -> list:
    """The (key, knobs) rows of a decode table, every row checked before
    any is installed."""
    with open(path) as f:
        rows = json.load(f)
    return [(tuple(row["key"]), check_decode_knobs(dict(row["knobs"])))
            for row in rows]


def _load_shipped_decode_tuned() -> None:
    """Install the shipped table once, lazily, without overriding entries
    the user installed."""
    global _DECODE_SHIPPED_LOADED
    if _DECODE_SHIPPED_LOADED:
        return
    _DECODE_SHIPPED_LOADED = True
    if not DECODE_TUNED_PATH.exists():
        return
    for key, knobs in _decode_rows(DECODE_TUNED_PATH):
        DECODE_TUNED.setdefault(key, knobs)


def save_decode_tuned(path) -> None:
    """Write :data:`DECODE_TUNED` as JSON rows ``{"key": [C, A, S],
    "knobs": {...}}`` (the JAX package's format)."""
    rows = [{"key": list(k), "knobs": v} for k, v in DECODE_TUNED.items()]
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def load_decode_tuned(path) -> None:
    """Install a :func:`save_decode_tuned` table; raises (installing
    nothing) on a knob the port's kernels do not have."""
    DECODE_TUNED.update(_decode_rows(path))


def decode_knobs(shape) -> dict:
    """The knobs an int16 decode of the (C, A, S) ``shape`` launches with:
    :data:`DECODE_ABLATE` over its :data:`DECODE_TUNED` entry."""
    _load_shipped_decode_tuned()
    return {**DECODE_TUNED.get(tuple(shape), {}), **DECODE_ABLATE}


def decode_candidates(rf: torch.Tensor) -> list:
    """The default candidates of :func:`autotune_decode` for ``rf``, the
    default (``{}``) first: for int16 input each other tile of
    :data:`I8_TILES` that fits the card's shared memory at its order; float
    input has only the default."""
    if rf.dtype != torch.int16:
        return [{}]
    lib = build.library()
    out = [{}]
    fits = ctypes.c_int(0)
    for t, w in I8_TILES[1:]:
        build.check("decode_fits", lib.decode_fits(rf.shape[1], t, w,
                                                   ctypes.byref(fits)))
        if fits.value:
            out.append({"tile_s": t, "row_warps": w})
    return out


def autotune_decode(rf, hadamard, candidates=None, iters: int = 50,
                    warmup: int = 4, passes: int = 2, save_path=None):
    """Time the decode kernel's knob candidates (default:
    :func:`decode_candidates`) on ``rf`` (a CUDA tensor) with CUDA events
    and install the fastest in :data:`DECODE_TUNED` under ``rf``'s key, as
    the JAX package's ``autotune_decode`` does.  The sweep runs ``passes``
    times and ranks each candidate's least time; a candidate that raises is
    recorded as None.  Each candidate runs through
    :data:`DECODE_ABLATE`, which is left as it was found; the shape's
    entry is left out while they run and put back if none ran.  The float32
    kernel has no knobs: for float input the sweep times the default alone
    and installs ``{}`` only where the key has no entry (an int16 frame and
    an interleaved complex one of the same shape share a key, and the int16
    frame's knobs stay).
    ``save_path`` writes the whole table (:func:`save_decode_tuned`).
    Returns ``(best_knobs, {repr(knobs): seconds or None})``."""
    if not isinstance(rf, torch.Tensor) or not rf.is_cuda:
        raise ValueError("autotune_decode times the CUDA kernel: rf must be "
                         "a CUDA tensor (the plain twin has no knobs)")
    if candidates is None:
        candidates = decode_candidates(rf)
    for knobs in candidates:
        check_decode_knobs(knobs)
        if knobs and rf.dtype != torch.int16:
            raise ValueError(f"{knobs}: the float32 decode kernel has no "
                             "knobs")
    key = tuple(rf.shape[:-1]) + (rf.shape[-1] * (2 if rf.is_complex()
                                                  else 1),)
    _load_shipped_decode_tuned()
    results: dict = {}
    saved = dict(DECODE_ABLATE)
    prior = DECODE_TUNED.pop(key, None)   # candidates run pure
    try:
        for _ in range(max(1, passes)):
            for knobs in candidates:
                if repr(knobs) in results and results[repr(knobs)] is None:
                    continue
                DECODE_ABLATE.clear()
                DECODE_ABLATE.update(knobs)
                try:
                    dt = device_utils.event_seconds(
                        lambda: decode_hadamard(rf, hadamard), iters, warmup)
                except (RuntimeError, ValueError):   # it may not launch
                    results[repr(knobs)] = None
                    continue
                prev = results.get(repr(knobs))
                results[repr(knobs)] = dt if prev is None else min(prev, dt)
    finally:
        DECODE_ABLATE.clear()
        DECODE_ABLATE.update(saved)
        if prior is not None:
            DECODE_TUNED[key] = prior
    timed = [(t, i) for i, knobs in enumerate(candidates)
             if (t := results.get(repr(knobs))) is not None]
    best = dict(candidates[min(timed)[1]]) if timed else {}
    if timed and rf.dtype == torch.int16:
        DECODE_TUNED[key] = best
    elif timed:
        DECODE_TUNED.setdefault(key, {})
    if save_path is not None:
        save_decode_tuned(save_path)
    return best, results
