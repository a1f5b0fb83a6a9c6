"""The int8 tensor-core skeleton (``csrc/i8_mma.cuh``) modelled in numpy.

A model of what each lane of a warp holds, step by step: ``ldmatrix.x4
.trans`` on the b16 view of a shared-memory tile, the two ``__byte_perm``
that split each register pair into B fragments, ``mma.sync.m16n8k32`` with
H (or K10's A) staged in the ``k_column`` order, and the stores each body
makes.  The products must equal the exact integer ones: K10's pair body on
int8 B (columns 2n and 2n+1 from one b16 element), K11 ``dot`` through the
high half alone, ``full`` through both halves with the row-sum correction.
The padded rows of a tile hold garbage, as they do on the card: H's zero
columns must cancel them.  numpy only; well under a second.
"""

import numpy as np
import pytest

from ogl_beamforming_tpu_torch.utils.hadamard import hadamard

LANES = np.arange(32)
GID, TIG = LANES // 4, LANES % 4


def k_column(l):
    """``k_column`` of ``csrc/i8_mma.cuh``."""
    half, q = divmod(l, 16)
    t, i = divmod(q, 4)
    return half * 16 + 8 * (i // 2) + 2 * t + i % 2


def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on arrays of 32-bit words."""
    a, b = a.astype(np.uint64), b.astype(np.uint64)
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out.astype(np.uint32)


def signed_bytes(words):
    """(lanes,) 32-bit words -> (lanes, 4) int8, byte 0 first."""
    return words.astype("<u4").view(np.int8).reshape(-1, 4).astype(np.int64)


def word(bytes4):
    """(..., 4) int8 -> (...) 32-bit words, byte 0 lowest."""
    return np.ascontiguousarray(bytes4.astype(np.int8)).view("<u4")[..., 0]


def ldmatrix_x4_trans(tile16, row0, col0):
    """Lane l gives the address of tile row row0 + l; lane t receives, per
    matrix m, the b16 elements of rows row0 + 8 m + 2 (t % 4) and the next
    row at column col0 + t / 4, the first in the low half."""
    regs = []
    for m in range(4):
        r = row0 + 8 * m + 2 * TIG
        lo = tile16[r, col0 + GID].astype(np.uint32)
        hi = tile16[r + 1, col0 + GID].astype(np.uint32)
        regs.append(lo | (hi << 16))
    return regs


def mma_m16n8k32(a, b0, b1):
    """The 16 x 8 int32 tile a lane holds after ``mma.sync.m16n8k32.row.col
    .s32.s8.s8`` from zero: (32, 4), rows gid, gid, gid + 8, gid + 8 at
    columns 2 tig, 2 tig + 1."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = GID[lane], TIG[lane]
        am[g, 4 * t:4 * t + 4] = signed_bytes(a[0][lane:lane + 1])[0]
        am[g + 8, 4 * t:4 * t + 4] = signed_bytes(a[1][lane:lane + 1])[0]
        am[g, 16 + 4 * t:20 + 4 * t] = signed_bytes(a[2][lane:lane + 1])[0]
        am[g + 8, 16 + 4 * t:20 + 4 * t] = signed_bytes(a[3][lane:lane + 1])[0]
        bm[4 * t:4 * t + 4, g] = signed_bytes(b0[lane:lane + 1])[0]
        bm[16 + 4 * t:20 + 4 * t, g] = signed_bytes(b1[lane:lane + 1])[0]
    d = am @ bm
    return np.stack([d[GID, 2 * TIG], d[GID, 2 * TIG + 1],
                     d[GID + 8, 2 * TIG], d[GID + 8, 2 * TIG + 1]], axis=1)


def stage_scalar(h, kpad):
    """H zero-padded to kpad x kpad, logical column l = H[:, k_column]."""
    a = h.shape[0]
    out = np.zeros((kpad, kpad), np.int8)
    for l in range(kpad):
        j = 32 * (l // 32) + k_column(l % 32)
        if j < a:
            out[:a, l] = h[:, j]
    return out


def stage_vector(h, kpad):
    """The 16-byte staging path: each 16-byte half of a row loaded as four
    words v.x .. v.w and stored as byte_perm(x, z, 0x5410), (x, z, 0x7632),
    (y, w, 0x5410), (y, w, 0x7632)."""
    a = h.shape[0]
    padded = np.zeros((kpad, kpad), np.int8)
    padded[:a, :a] = h
    out = np.zeros_like(padded)
    for q in range(kpad // 16):
        v = padded[:, 16 * q:16 * q + 16].reshape(kpad, 4, 4)
        x, y, z, w = (word(v[:, i]) for i in range(4))
        words = [byte_perm(x, z, 0x5410), byte_perm(x, z, 0x7632),
                 byte_perm(y, w, 0x5410), byte_perm(y, w, 0x7632)]
        out[:, 16 * q:16 * q + 16] = np.stack(
            [w_.astype("<u4").view(np.int8).reshape(kpad, 4) for w_ in words],
            axis=1).reshape(kpad, 16)
    return out


def a_fragment(staged, mt, k):
    """The four A registers of every lane for m-tile ``mt``, step ``k``:
    4 bytes at columns 32 k + 4 tig (and + 16) of rows 16 mt + gid (and
    + 8) of the staged H."""
    r = 16 * mt + GID
    c = 32 * k + 4 * TIG
    take = lambda rows, cols: word(  # noqa: E731
        np.stack([staged[rows, cols + i] for i in range(4)], axis=1))
    return [take(r, c), take(r + 8, c), take(r, c + 16), take(r + 8, c + 16)]


def tile_of(x, kpad, rng):
    """x (a, n) as a shared-memory tile of kpad rows, the rows a .. kpad
    left as garbage."""
    tile = rng.integers(-128, 128, (kpad, x.shape[1] * x.itemsize),
                        dtype=np.int8)
    tile[:x.shape[0]] = np.ascontiguousarray(x).view(np.int8)
    return tile.view("<u2")


def warp_products(staged, tile16, col0, steps, m_tiles, perm_q):
    """(mt, p, q) for each m-tile of one warp's 8 b16 columns at col0: p
    from the high bytes of each b16 element, q from the low ones (xor
    ``perm_q``, the decode's 0x80808080 or 0 for K10)."""
    bp, bq = [], []
    for k in range(steps):
        r = ldmatrix_x4_trans(tile16, 32 * k, col0)
        bp.append((byte_perm(r[0], r[1], 0x7531), byte_perm(r[2], r[3], 0x7531)))
        bq.append((byte_perm(r[0], r[1], 0x6420) ^ np.uint32(perm_q),
                   byte_perm(r[2], r[3], 0x6420) ^ np.uint32(perm_q)))
    for mt in range(m_tiles):
        p = sum(mma_m16n8k32(a_fragment(staged, mt, k), *bp[k])
                for k in range(steps))
        q = sum(mma_m16n8k32(a_fragment(staged, mt, k), *bq[k])
                for k in range(steps))
        yield mt, p, q


@pytest.mark.parametrize("a", [16, 48, 128])
def test_h_staging_sixteen_bytes_at_a_time(a):
    """The 16-byte staging path puts every byte where k_column does."""
    rng = np.random.default_rng(a)
    h = rng.integers(-128, 128, (a, a), dtype=np.int8)
    kpad = -(-a // 32) * 32
    assert np.array_equal(stage_vector(h, kpad), stage_scalar(h, kpad))


@pytest.mark.parametrize("k", [16, 32, 128])
def test_k10_pair_body_is_the_int8_product(k):
    """K10: ldmatrix.trans on the b16 view of int8 B and the two byte
    permutes give the fragments of columns 2n (low bytes) and 2n + 1 (high
    bytes); with A staged in the k_column order the pair body's stores (a
    lane's four consecutive columns 4 tig .. 4 tig + 3 of rows gid and
    gid + 8) are A @ B."""
    rng = np.random.default_rng(k)
    n = 48                                    # three warps' column groups
    a = rng.integers(-128, 128, (k, k), dtype=np.int8)
    b = rng.integers(-128, 128, (k, n), dtype=np.int8)
    kpad = -(-k // 32) * 32
    staged = stage_vector(a, kpad)
    tile16 = tile_of(b, kpad, rng)
    out = np.full((kpad, n), -1, np.int64)
    for wn in range(n // 16):
        for mt, p, q in warp_products(staged, tile16, 8 * wn, kpad // 32,
                                      -(-k // 16), 0):
            cols = 16 * wn + 4 * TIG[:, None] + np.arange(4)
            out[16 * mt + GID[:, None], cols] = np.stack(
                [q[:, 0], p[:, 0], q[:, 1], p[:, 1]], axis=1)
            out[16 * mt + 8 + GID[:, None], cols] = np.stack(
                [q[:, 2], p[:, 2], q[:, 3], p[:, 3]], axis=1)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert np.array_equal(out[:k], exact)


def decode_stores(p, q, rowsum, body, scale):
    """The decode and ``dot`` epilogue: each lane's four floats, one
    shuffle with its neighbour, and (row offset, first column, four values)
    for each lane: even lanes row gid, odd lanes gid + 8."""
    if body == "full":
        f = (256 * p + q + rowsum[GID[:, None] + 8 * (np.arange(4) // 2)]
             ).astype(np.float32) * np.float32(scale)
    else:
        f = p.astype(np.float32)
    odd = TIG % 2 == 1
    partner = LANES ^ 1
    g0 = np.where(odd[partner], f[partner, 0], f[partner, 2])
    g1 = np.where(odd[partner], f[partner, 1], f[partner, 3])
    v = np.where(odd[:, None], np.stack([g0, g1, f[:, 2], f[:, 3]], axis=1),
                 np.stack([f[:, 0], f[:, 1], g0, g1], axis=1))
    return GID + 8 * odd, 4 * (TIG // 2), v


@pytest.mark.parametrize("body", ["dot", "full"])
@pytest.mark.parametrize("a", [16, 128])
def test_k11_bodies_through_the_halves(a, body):
    """K11 ``dot`` through the high half alone is H @ hi (hi = X >> 8), and
    ``full`` through both halves with the row-sum correction is H @ X / 16,
    both after the epilogue's shuffle, over the int16 range."""
    rng = np.random.default_rng(a + len(body))
    n = 32                                    # four warps' 8 samples
    h = hadamard(a).astype(np.int8)[rng.permutation(a)]
    x = rng.integers(-32768, 32768, (a, n)).astype(np.int16)
    x[0, :2] = -32768, 32767
    kpad = -(-a // 32) * 32
    staged = stage_scalar(h, kpad)
    tile16 = tile_of(x, kpad, rng)
    rowsum = np.zeros(kpad, np.int64)
    rowsum[:a] = 128 * h.astype(np.int64).sum(axis=1)
    out = np.full((kpad, n), np.nan, np.float32)
    for wn in range(n // 8):
        for mt, p, q in warp_products(staged, tile16, 8 * wn, kpad // 32,
                                      -(-a // 16), 0x80808080):
            rows, cols, v = decode_stores(p, q, rowsum[16 * mt:16 * mt + 16],
                                          body, 1 / 16)
            out[16 * mt + rows[:, None],
                8 * wn + cols[:, None] + np.arange(4)] = v
    wide = h.astype(np.int64) @ (x.astype(np.int64) if body == "full"
                                 else x.astype(np.int64) >> 8)
    want = wide / 16.0 if body == "full" else wide.astype(np.float64)
    assert np.array_equal(out[:a].astype(np.float64), want)


def test_sass_counts_the_int8_kernels():
    """kernels/sass.py counts each instantiation of the skeleton's kernels
    on a synthetic cuobjdump listing, and nothing else."""
    from ogl_beamforming_tpu_torch.kernels import sass
    prefix = "_ZN12_GLOBAL__N_1"

    def function(name, body):
        lines = [f"\t\tFunction : {prefix}{name}"]
        lines += [f"        /*{16 * i:04x}*/  {ins} ;"
                  for i, ins in enumerate(body)]
        return "\n".join(lines)

    text = "\n".join([
        function("16decode_i8_kernelILi4EEEvPKsPKaPviiifbb",
                 ["LDGSTS.E.BYPASS.128 [R2], desc[UR4][R4.64]",
                  "LDSM.16.MT88.4 R8, [R3]", "PRMT R9, R8, 0x7531, R10",
                  "IMMA.16832.S8.S8 R12, R16, R20, R12", "STG.E.EF.128 [R6], R12",
                  "EXIT"]),
        function("13i8_mma_kernelILi2ELi0ELi1ELi1ELi16EEEvPKT_PKaPviiifbb",
                 ["LDS R4, [R5]", "IMMA.16832.S8.S8 R12, R16, R20, R12",
                  "IMMA.16832.S8.S8 R24, R16, R22, R24", "SHFL.BFLY PT, R1, R2, 0x1, 0x1f"]),
        function("15das_rca_kernelILi2ELb1ELb0ELi1EEEvNS_4ArgsE", ["IMMA R1, R2, R3, R4"])])
    counts = sass.kernel_counts(text)
    assert set(counts) == {"decode_i8_kernel k4",
                           "i8_mma_kernel k2 b0 wn1 wm1 rows16"}
    d = counts["decode_i8_kernel k4"]
    assert d["instructions"] == 6
    assert [d[op] for op in ("LDGSTS", "LDSM", "PRMT", "IMMA", "STG", "LDS")] \
        == [1, 1, 1, 1, 1, 0]
    k = counts["i8_mma_kernel k2 b0 wn1 wm1 rows16"]
    assert (k["IMMA"], k["LDS"], k["SHFL"], k["LDSM"]) == (2, 1, 1, 0)


@pytest.mark.parametrize("body", [0, 1, 2, 3])
def test_launch_i8_mma_takes_only_cuda_tensors(body):
    """The kernel wrapper never runs the plain version: CPU tensors raise
    before anything is built."""
    import torch

    from ogl_beamforming_tpu_torch.experiments import probe_i8
    a = torch.ones((16, 16), dtype=torch.int8)
    b = torch.ones((16, 64), dtype=torch.int8 if body < 2 else torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        probe_i8.launch_i8_mma(body, a, b, torch.float32)
