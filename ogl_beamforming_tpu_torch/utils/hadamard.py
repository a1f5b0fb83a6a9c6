"""Hadamard matrix construction.

Reference: math.c:36-134 (``make_hadamard_transpose``).  Supports Sylvester
powers of two plus Kronecker products with 12x12 and 20x20 seed matrices, so
that transmit counts of the form ``2^k``, ``12 * 2^k`` and ``20 * 2^k`` decode.
"""

from __future__ import annotations

import numpy as np

# 12x12 Hadamard seed, stored transposed exactly as the reference's
# ``hadamard_12_12_transpose`` table (math.c:38-51).
_HADAMARD_12_T = np.array([
    [1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1],
    [1, -1, -1,  1, -1, -1, -1,  1,  1,  1, -1,  1],
    [1,  1, -1, -1,  1, -1, -1, -1,  1,  1,  1, -1],
    [1, -1,  1, -1, -1,  1, -1, -1, -1,  1,  1,  1],
    [1,  1, -1,  1, -1, -1,  1, -1, -1, -1,  1,  1],
    [1,  1,  1, -1,  1, -1, -1,  1, -1, -1, -1,  1],
    [1,  1,  1,  1, -1,  1, -1, -1,  1, -1, -1, -1],
    [1, -1,  1,  1,  1, -1,  1, -1, -1,  1, -1, -1],
    [1, -1, -1,  1,  1,  1, -1,  1, -1, -1,  1, -1],
    [1, -1, -1, -1,  1,  1,  1, -1,  1, -1, -1,  1],
    [1,  1, -1, -1, -1,  1,  1,  1, -1,  1, -1, -1],
    [1, -1,  1, -1, -1, -1,  1,  1,  1, -1,  1, -1],
], dtype=np.float32)

# 20x20 Hadamard seed (math.c:53-74), also stored transposed.
_HADAMARD_20_T = np.array([
    [1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1],
    [1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1],
    [1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1],
    [1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1],
    [1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1],
    [1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1],
    [1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1],
    [1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1],
    [1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1],
    [1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1],
    [1, -1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1],
    [1,  1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1],
    [1, -1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1],
    [1,  1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1],
    [1,  1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1],
    [1,  1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1],
    [1,  1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1],
    [1, -1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1],
    [1, -1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1],
    [1,  1, -1, -1,  1,  1, -1, -1, -1, -1,  1, -1,  1, -1,  1,  1,  1,  1, -1, -1],
], dtype=np.float32)


def hadamard_supported(dim: int) -> bool:
    """Whether a Hadamard matrix of order ``dim`` can be built
    (reference: math.c:79-94)."""
    if dim <= 0:
        return False

    def pow2(n: int) -> bool:
        return n > 0 and (n & (n - 1)) == 0

    if pow2(dim):
        return True
    if dim % 20 == 0 and pow2(dim // 20):
        return True
    if dim % 12 == 0 and pow2(dim // 12):
        return True
    return False


def _sylvester(dim: int) -> np.ndarray:
    m = np.ones((1, 1), dtype=np.float32)
    while m.shape[0] < dim:
        m = np.block([[m, m], [m, -m]])
    return m


def hadamard_transpose(dim: int, dtype=np.float32) -> np.ndarray:
    """Build the transposed Hadamard matrix of order ``dim``.

    Exactly mirrors ``make_hadamard_transpose(arena, dim, row_major=False)``
    (math.c:36-134): Sylvester construction for powers of two, otherwise the
    Kronecker product ``kron(sylvester(dim/base), seed_base_transpose)`` for
    base 12 or 20.

    Raises ``ValueError`` for unsupported orders.
    """
    if not hadamard_supported(dim):
        raise ValueError(f"no Hadamard construction for order {dim}")

    def pow2(n: int) -> bool:
        return n > 0 and (n & (n - 1)) == 0

    if pow2(dim):
        result = _sylvester(dim)
    elif dim % 20 == 0 and pow2(dim // 20):
        result = np.kron(_sylvester(dim // 20), _HADAMARD_20_T)
    else:
        result = np.kron(_sylvester(dim // 12), _HADAMARD_12_T)
    return np.ascontiguousarray(result, dtype=dtype)


def hadamard(dim: int, dtype=np.float32) -> np.ndarray:
    """Row-major (untransposed) Hadamard matrix: the ``row_major=True`` path
    of the reference (math.c:127-131), used by the matmul decode."""
    return np.ascontiguousarray(hadamard_transpose(dim, dtype).T)


def walsh(dim: int, dtype=np.float32) -> np.ndarray:
    """Sequency-ordered (Walsh) Hadamard matrix of order ``dim``.

    The Sylvester rows re-sorted by sequency (number of sign changes per
    row) — the ``ZBP_DecodeMode_Walsh`` encoding of the zemp_bp container
    (reference: external/zemp_bp.h:33-38; the reference runtime itself has
    no Walsh decode — generated/beamformer.c:27-31 — so this exceeds it).
    Only Sylvester orders (powers of two) have a standard sequency
    ordering; 12/20-seeded orders raise.
    """
    if not (dim > 0 and (dim & (dim - 1)) == 0):
        raise ValueError(f"Walsh (sequency) ordering needs a power-of-two "
                         f"order, got {dim}")
    h = _sylvester(dim)
    sequency = (np.diff(h, axis=1) != 0).sum(axis=1)
    return np.ascontiguousarray(h[np.argsort(sequency, kind="stable")],
                                dtype=dtype)
