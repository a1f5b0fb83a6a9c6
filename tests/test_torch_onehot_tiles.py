"""The redesigned one-hot kernel (``csrc/micro_onehot.cu``: K8, K9) on the
CPU: a numpy model of its two W^T tiles.

* The layout: element (r, k) of a K-major bf16 tile of ``rows`` rows sits at
  the kernel's ``tile_offset`` (two 64-wide halves of K, the 16-byte chunk
  XORed with r % 8).  What a ``wgmma`` reads through a 128-byte-swizzle
  descriptor (start address, stride between 8-row groups, the hardware's
  XOR of address bits 4-6 with bits 7-9) is that same element, for every
  warpgroup's rows and every K step.
* The band: each tile is zeroed once, unit 0 is scattered into tile 0, and
  unit u + 1 into tile (u + 1) % 2 after erasing unit u - 1's entries
  there (their places carried in registers), as the kernel's two threads
  of a row do, one for the even taps and one for the odd; the places one
  of them stores to are never the other's, and entries outside the tile
  are neither written nor erased there, but stored to a trash slot past
  the tiles.  Read back through the descriptors, the tile
  of every unit equals the plain version's dense ``bf16(W_u)``, bit for
  bit, over K8's and K9's offsets, for index tiles near 0 and near 127
  where bands leave the tile, at units 1, 2, 5, 16 and 28.
* The stores: the accumulator layout of ``wgmma`` m64nNk16 mapped to
  ``out[b, v]`` writes every output once, from D = W^T rf^T.

The constants are read from the source.  numpy only; well under a second.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu_torch import experiments  # noqa: E402

SOURCE = (Path(experiments.__file__).resolve().parent.parent / "csrc"
          / "micro_onehot.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


LANE = _constant("kLane")
TAPS = _constant("kTaps")
TAPS_EACH = _constant("kTapsEach")
THREADS = _constant("kThreads")
GROUP_ROWS = _constant("kGroupRows")
STEP_K = _constant("kStepK")
ATOM_K = _constant("kAtomK")
ATOM_BYTES = _constant("kAtomBytes")
W_BYTES = LANE * LANE * 2
GROUPS = THREADS // 128


def tile_offset(rows, r, k):
    """``tile_offset`` of the kernel."""
    return ((k // ATOM_K) * rows * 128 + r * 128
            + (((k % ATOM_K) // 8) ^ (r % 8)) * 16 + (k % 8) * 2)


def descriptor_read(tile, start, rows):
    """The (rows, STEP_K) bf16 block a K-major 128-byte-swizzle descriptor
    at byte ``start`` names: row m, column kk at linear address start +
    (m // 8) SBO + (m % 8) 128 + 2 kk, whose 16-byte chunk the hardware
    XORs with the address's 128-byte row within its 1024-byte atom."""
    m = np.arange(rows)[:, None]
    kk = np.arange(STEP_K)[None, :]
    lin = start + (m // 8) * ATOM_BYTES + (m % 8) * 128 + 2 * kk
    phys = lin ^ (((lin >> 7) & 7) << 4)
    return tile[phys // 2]


def read_tile(tile, tile_rows, rows, row0=0):
    """Rows row0 .. row0 + rows of a K-major tile of ``tile_rows`` rows as
    the kernel's descriptors read them, K step by K step: half ks / 4 of
    the tile, 32 bytes into its rows per step."""
    out = np.zeros((rows, LANE), tile.dtype)
    for ks in range(LANE // STEP_K):
        half, inner = divmod(ks * STEP_K, ATOM_K)
        start = row0 * 128 + half * tile_rows * 128 + 2 * inner
        out[:, ks * STEP_K:(ks + 1) * STEP_K] = descriptor_read(
            tile, start, rows)
    return out


def bf16_bits(x):
    """float32 -> bf16 bits, round to nearest even (``__float2bfloat16_rn``
    on finite values)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def test_source_names_the_128_byte_swizzle():
    """The descriptor names the 128-byte swizzle with 1024-byte 8-row
    groups, and the scatter's address function is the model's."""
    body = re.search(r"sw128_desc\(unsigned addr\) \{(.*?)\n\}", SOURCE,
                     re.S).group(1)
    assert "(kAtomBytes >> 4) << 32" in body and "1 << 62" in body
    assert ATOM_BYTES == 8 * 128 and ATOM_K * 2 == 128
    offset = re.search(r"tile_offset\(int rows, int r, int k\) \{(.*?)\n\}",
                       SOURCE, re.S).group(1)
    assert " ".join(offset.split()) == (
        "return (k / kAtomK) * rows * 128 + r * 128 + "
        "((((k % kAtomK) / 8) ^ (r % 8)) * 16) + (k % 8) * 2;")


@pytest.mark.parametrize("rows", [8, 32, 128])
def test_descriptor_reads_equal_the_layout(rows):
    """Every (row, k) of a tile, written at ``tile_offset``, comes back at
    its place through the descriptors of every warpgroup and K step (the
    RF tile at each B, and W^T's two warpgroup halves)."""
    values = np.arange(rows * LANE, dtype=np.int64).reshape(rows, LANE)
    tile = np.full(rows * LANE, -1, np.int64)
    r, k = np.meshgrid(np.arange(rows), np.arange(LANE), indexing="ij")
    addr = tile_offset(rows, r, k)
    assert addr.min() == 0 and addr.max() == 2 * (rows * LANE - 1)
    assert len(np.unique(addr)) == rows * LANE and (addr % 2 == 0).all()
    tile[addr // 2] = values
    if rows == LANE:
        for g in range(GROUPS):
            part = read_tile(tile, LANE, GROUP_ROWS, g * GROUP_ROWS)
            np.testing.assert_array_equal(
                part, values[g * GROUP_ROWS:(g + 1) * GROUP_ROWS])
    np.testing.assert_array_equal(read_tile(tile, rows, rows), values)


def band_at(kv, u, k8, trash, parity):
    """``band_at`` of the threads of one parity (i // 64): the byte offsets
    of unit u's entries of every row v at taps t = 2 j + parity, in tile
    u % 2 of the shared memory, or the trash slot for s outside the tile."""
    taps = 2 * np.arange(TAPS_EACH) + parity
    s = kv[:, None] + taps + experiments.onehot_offset(u, k8)
    v = np.arange(LANE)[:, None]
    return np.where((s >= 0) & (s < LANE),
                    (u % 2) * W_BYTES + tile_offset(LANE, v, s % LANE), trash)


def store(smem, at, w_bits, parity, erase):
    """``store``: zeros, or each row's weights of the parity's taps, at
    their places."""
    for j in range(TAPS_EACH):
        smem[at[:, j] // 2] = 0 if erase else w_bits[2 * j + parity]


def _tiles(low):
    rng = np.random.default_rng(9 + low)
    k = (rng.integers(0, 6, (8, LANE)) if low
         else rng.integers(LANE - 6, LANE, (8, LANE))).astype(np.int32)
    k[0, :8] = [0, 1, 2, 3, 124, 125, 126, 127]
    if low:
        k[0, 8:12] = [-4, -3, -2, -1]        # bands that start before s = 0
    wt = rng.standard_normal((8, LANE)).astype(np.float32)
    return k, wt


@pytest.mark.parametrize("units", [1, 2, 5, 16, 28])
@pytest.mark.parametrize("low", [True, False], ids=["k_near_0", "k_near_127"])
@pytest.mark.parametrize("k8", [True, False], ids=["K8", "K9"])
def test_band_tiles_equal_the_plain_weights(k8, low, units):
    """The kernel's double-buffered scatter over a launch of ``units``
    units, with the places of the last two units' entries carried in
    registers (prev, cur, next) by each of a row's two threads: the tile
    each unit's products read equals bf16(W_u) of the plain version bit for
    bit, for both warpgroups' rows, the two threads never store to one
    place in a step, and no store lands outside the two tiles but in the
    trash slot."""
    k, wt = _tiles(low)
    kv = k[0].astype(np.int64)
    w_bits = bf16_bits(wt[:TAPS])
    trash = 2 * W_BYTES + 8 * LANE * 2          # past the B = 8 rf tile
    smem = np.zeros(trash // 2 + 8, np.uint16)
    parities = range(TAPS // TAPS_EACH)
    prev = [np.full((LANE, TAPS_EACH), trash) for _ in parities]
    cur = [band_at(kv, 0, k8, trash, p) for p in parities]
    for p in parities:
        store(smem, cur[p], w_bits, p, False)
    kt, wtt = torch.from_numpy(k), torch.from_numpy(wt)
    for u in range(units):
        dense = experiments.onehot_weights(kt, wtt, u, k8)
        want = dense.to(torch.bfloat16).view(torch.int16).numpy().view(
            np.uint16).T                     # W^T [v][s]
        tile = smem[(u % 2) * W_BYTES // 2:(u % 2 + 1) * W_BYTES // 2]
        for g in range(GROUPS):
            rows = slice(g * GROUP_ROWS, (g + 1) * GROUP_ROWS)
            np.testing.assert_array_equal(
                read_tile(tile, LANE, GROUP_ROWS, g * GROUP_ROWS),
                want[rows], err_msg=f"unit {u}, warpgroup {g}")
        if u + 1 == units:
            break
        # the kernel's step after unit u's products are issued: the two
        # threads of a row run side by side, so the places one stores to
        # (erase or write) must be none of the other's, but the trash slot
        nxt = [band_at(kv, u + 1, k8, trash, p) for p in parities]
        touched = [set(np.concatenate([prev[p], nxt[p]], 1).ravel()) - {trash}
                   for p in parities]
        assert not touched[0] & touched[1], f"unit {u + 1}"
        for p in parities:
            store(smem, prev[p], w_bits, p, True)
            store(smem, nxt[p], w_bits, p, False)
        prev, cur = cur, nxt
    assert not smem[2 * W_BYTES // 2:trash // 2].any()   # the rf tile's place
    ends = kv[:, None] + np.arange(TAPS)
    assert ((ends < 0).any() if low else (ends >= LANE).any())


def wgmma_accumulator(warp, lane, i):
    """(row, column) of D that register i of a lane holds after
    ``wgmma`` m64nNk16 (PTX's accumulator fragment layout)."""
    gid, tig = divmod(lane, 4)
    return (16 * warp + gid + 8 * ((i % 4) // 2),
            8 * (i // 4) + 2 * tig + i % 2)


def kernel_store(g, warp, lane, i):
    """(b, v) of out where the kernel stores register i: ``row = 64 g + 16
    warp + gid``, ``b = 8 j + 2 tig``; registers 4 j .. 4 j + 3 to (b, row),
    (b + 1, row), (b, row + 8), (b + 1, row + 8)."""
    gid, tig = divmod(lane, 4)
    j, e = divmod(i, 4)
    row = GROUP_ROWS * g + 16 * warp + gid
    return 8 * j + 2 * tig + (e % 2), row + 8 * (e // 2)


@pytest.mark.parametrize("b_frames", [8, 32, 128])
def test_stores_write_every_output_once(b_frames):
    """Through the kernel's stores, the accumulators of both warpgroups
    write each out[b, v] once, with D_g[v - 64 g, b] of D = W^T rf^T."""
    d = np.random.default_rng(b_frames).standard_normal((LANE, b_frames))
    out = np.full((b_frames, LANE), np.nan)
    count = np.zeros((b_frames, LANE), int)
    for g in range(GROUPS):
        for warp in range(4):
            for lane in range(32):
                for i in range(b_frames // 2):
                    m, n = wgmma_accumulator(warp, lane, i)
                    b, v = kernel_store(g, warp, lane, i)
                    out[b, v] = d[GROUP_ROWS * g + m, n]
                    count[b, v] += 1
    assert (count == 1).all()
    np.testing.assert_array_equal(out, d.T)


def test_shared_memory_fits_two_blocks_at_b128():
    for b_frames, per_sm in ((8, 3), (32, 3), (128, 2)):
        smem = 2 * W_BYTES + b_frames * LANE * 2 + ATOM_BYTES
        assert per_sm * (smem + 1024) <= 228 * 1024, b_frames


def test_sass_counts_the_unit_loop():
    """kernels/sass.py finds each instantiation's unit loop (the innermost
    backward branch around a tensor-core product) on a synthetic cuobjdump
    listing, and counts only its body."""
    from ogl_beamforming_tpu_torch.kernels import sass
    prefix = "_ZN12_GLOBAL__N_1"

    def function(name, body):
        lines = [f"\t\tFunction : {prefix}{name}"]
        lines += [f"        /*{16 * i:04x}*/  {ins} ;"
                  for i, ins in enumerate(body)]
        return "\n".join(lines)

    loop = ["WARPGROUP.ARRIVE", "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24",
            "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0",
            "WARPGROUP.DEPBAR.LE gsb0, 0x1", "@P0 STS.U16 [R3], R5",
            "BAR.SYNC R2, 0x80", "@P1 BRA 0x40"]
    text = "\n".join([
        function("13onehot_kernelILi128EEEvPKfPKiS3_Pfiii",
                 ["STS.128 [R1], RZ", "@P2 BRA 0x0", "BAR.SYNC.DEFER_BLOCKING 0x0",
                  "MOV R1, R2"] + loop + ["STG.E [R4], R24", "EXIT"]),
        function("13onehot_kernelILi8EEEvPKfPKiS3_Pfiii",
                 ["HMMA.16816.F32.BF16 R4, R8, R12, R4", "EXIT"]),
        function("13hermite_kernelILb1ELb1EEEvPKiS2_S2_PKfPfii",
                 ["HGMMA R1", "BRA 0x0"])])
    counts = sass.onehot_loops(text)
    assert set(counts) == {128, 8} and counts[8] is None
    c = counts[128]
    assert c["instructions"] == len(loop)
    assert [c[op] for op in ("HGMMA", "HMMA", "STS", "BAR", "WARPGROUP")] \
        == [2, 0, 1, 1, 2]


def test_onehot_arguments_are_checked_before_a_launch():
    """The launcher's argument check refuses CPU tensors and a B the
    kernel has no path for, before anything is built."""
    from ogl_beamforming_tpu_torch.experiments import onehot_micro
    x = onehot_micro.make_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        experiments.check_onehot_args(x["rf8"], x["kvox"], x["wt4"])
    with pytest.raises(ValueError, match="B in"):
        experiments.check_onehot_args(x["rf8"][:4], x["kvox"], x["wt4"])


def test_ablations_apply_to_the_source():
    """Each ablation of ``experiments.onehot_ab`` finds the line it
    replaces in the kernel's source."""
    from ogl_beamforming_tpu_torch.experiments import onehot_ab
    srcs = onehot_ab.sources([], True)
    assert list(srcs) == ["change", *onehot_ab.ABLATIONS]
    mine = srcs["change"][0]
    assert all(text != mine and not checked
               for label, (text, checked) in srcs.items() if label != "change")
