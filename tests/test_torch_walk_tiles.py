"""The walk kernel (``csrc/micro_gather.cu``: ``gather_walk_kernel``, K7 and
the K8/K9 gather bundle) on the CPU: a numpy model of its launch, its lane
dealing and its addressing, its constants and formulas read from the
source.

* The launch: a persistent grid, each warp a run of units (``base`` each,
  one more for the first ``extra`` warps), a unit 32 elements of a step,
  lane l of unit u the element of slot (u % 64) * 32 + l: every (step,
  element) is taken once, over SM counts, blocks a SM and steps.
* The lanes (``deal_lanes``): each element's 16-byte bank group at its
  walk's first load, a stable counting sort by it, sorted position i dealt
  to lane i // 256 of quarter-warp i % 256.  A permutation of the tile's
  elements for idx tiles of several seeds, an all-equal tile, the extremes
  0 and LANE - 4, and for every walk's first offset; on the TPU files'
  tiles (seed 5 for K7, seed 7 for the bundle) its conflicts, the sum over
  a warp's four quarter-warps of the largest count of one group, per 32
  words, are at most the prediction (1.23 and 1.24; 2.55 and 2.65 in
  element order).
* The addressing: four copies of each row shifted by 0-3 words, 32 quads
  and their first four again; an element reads copy (start & 3) from quad
  start >> 2, turns of four quads then a tail of a chain period, wrapped
  at 32 quads.  At every word of every variant's walk (REPS and UNITS with
  and without a tail, so across the wrap) the quad gives word (idx +
  origin + k) & 127.
* The arithmetic: through those words, the walk's keep range (a word kept
  before end = 128 - idx - origin, word 0 only if idx + origin >= 0) taken
  a quad at a time, the quad that end falls inside added afterwards by the
  fix-up, every kept word added once; the conversions of the staged halves
  (the hi halves signed, through I2F or added to 1.5 x 2^23, the lo halves
  biased and ORed under 2^23, the slope plane's halved) and the chains in turn order: the model's tile
  equals the plain version's bit for bit with products and sums rounded
  apart (the kernel contracts them into FMAs: NRMSE 1e-6 on the card),
  K8's bundle in ``k8_units``' order too.
* The Python side agrees with the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu_torch import experiments  # noqa: E402
from ogl_beamforming_tpu_torch.experiments import gather_micro3 as k7  # noqa: E402
from ogl_beamforming_tpu_torch.experiments import onehot_micro as k8  # noqa: E402

SOURCE = (Path(experiments.__file__).resolve().parent.parent / "csrc"
          / "micro_gather.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


ENUM = re.search(r"enum Variant \{([^}]*)\}", SOURCE).group(1)
VARIANTS = [v.strip() for v in ENUM.split(",") if v.strip()]
ROWS, LANE = _constant("kRows"), _constant("kLane")
TILE = ROWS * LANE
THREADS = _constant("kWalkThreads")
WARPS = THREADS // 32
TURN = _constant("kTurnQuads")
COPIES = _constant("kCopies")
GROUPS = _constant("kGroups")
COPY_QUADS = LANE // 4 + TURN
UNITS = TILE // 32                   # units a step
QUARTERS = TILE // GROUPS            # quarter-warps a step
K9, K8 = VARIANTS.index("K9_BUNDLE"), VARIANTS.index("K8_BUNDLE")
ID = {v: VARIANTS.index(f"K7_{v.upper()}") for v in k7.VARIANTS}
ORIGIN = {ID["f32_direct"]: 0, ID["idx_fresh"]: -1, ID["unpack"]: -1,
          ID["hermite_pair"]: -1, K9: 0}
CHAINS = {ID["f32_direct"]: 8, ID["idx_fresh"]: 8, ID["unpack"]: 8,
          ID["hermite_pair"]: 4, K9: 4}
WALKS = tuple(ORIGIN)


def test_python_side_matches_the_source():
    assert experiments.WALK_WARPS == WARPS == 12
    assert experiments.WALK_UNITS == UNITS
    assert experiments.WALK_TURN_QUADS == TURN
    assert experiments.HERMITE_IDS == {True: K8, False: K9}
    assert k7.VARIANT_IDS == ID
    for text in (
            "constexpr int kCopyQuads = kLane / 4 + kTurnQuads;",
            "constexpr int kWalkUnitsPerStep = kTile / 32;",
            "constexpr int kQuarters = kTile / kGroups;",
            "return (v == K7_IDX_FRESH || v == K7_UNPACK || v == K7_HERMITE_PAIR)"
            " ? -1 : 0;",
            "return (v == K7_HERMITE_PAIR || v == K9_BUNDLE || v == K8_BUNDLE)"
            " ? 4 : 8;",
            "return ((row * kCopies + (s & 3)) * kCopyQuads + (s >> 2)) & "
            "(kGroups - 1);",
            "w[i] = w[row * kRowWords + ((k + c) & (kLane - 1))] ^ word_bias(V);",
            "const Walker<V, SMEM> start{s_walk + (row * kCopies + (s & 3)) * "
            "L::kCopyBytes,",
            "slot((pos % kQuarters) * kGroups + pos / kQuarters, e);",
            "table[i] = make_uint2(static_cast<unsigned>(e | idx[e] << 16), "
            "__float_as_uint(w[e]));",
            "const int i = (u % kWalkUnitsPerStep) * 32 + lane;",
            "if constexpr (SMEM) pb = (pb + 16 * quads) & (kLane * 4 - 1);",
            "const int end = kLane - ix - walk_origin(V);",
            "walk_turn<V, kPeriod, SMEM, kByQuadLead>(acc, wk, ix + walk_origin(V) < 0, "
            "end, wv);",
            "const float wq = 4 * t + 4 <= hi ? w : 0.0f;",
            "if (S == kFixUp && j == 3) continue;",
            "const float ws = S == kFixUp ? (kk >= lo && kk < hi ? w : 0.0f)",
            ": S == kByQuadLead && kk == 0 && lo ? 0.0f : wq;",
            "const bool fix = end % 4 && qb < kPeriod * (1 + tail) + kTurnQuads * turns;",
            "const int p0 = fix ? qb / kPeriod * kPeriod : 0;",
            "walk_turn<V, kPeriod, SMEM, kFixUp>(acc, wf, fix ? 4 * (qb - p0) : 0,",
            "const int quads = walk_words(V, count) / 4 - period;",
            "return int_src(v) ? 0x8000u : 0u;",
            "return (kHiI2F >> (4 * p + q % kTurnQuads)) & 1;",
            "__constant__ unsigned kExpWords[4] = {0x4B000000u, 0x4A800000u, "
            "0x4B400000u, 0x4AC00000u};",
            "const unsigned bits = kExpWords[2 + P] + (static_cast<int>(v) >> 16);",
            "return __fsub_rn(__uint_as_float(bits), P ? 6291456.0f : 12582912.0f);",
            "const unsigned bits = (v & 0xFFFFu) | kExpWords[P];",
            "return __fsub_rn(__uint_as_float(bits), P ? 4210688.0f : 8421376.0f);",
            "cvt.rn.f32.s16 %0, h;",
            "c = __fmaf_rn(i2f_b ? __fmul_rn(ws, 0.5f) : ws,"):
        assert text in SOURCE, text


# ---------------------------------------------------------------------------
# The launch and the lanes
# ---------------------------------------------------------------------------

def groups(idx, vid):
    """``walk_group``: each element's bank group at its walk's first load."""
    s = (np.asarray(idx).ravel() + ORIGIN[vid]) & (LANE - 1)
    row = np.arange(TILE) // LANE
    return ((row * COPIES + (s & 3)) * COPY_QUADS + (s >> 2)) & (GROUPS - 1)


def deal(idx, vid):
    """``deal_lanes``: the element of each lane slot of a step."""
    g = groups(idx, vid)
    order = np.argsort(g, kind="stable")
    pos = np.empty(TILE, np.int64)
    pos[order] = np.arange(TILE)
    perm = np.full(TILE, -1, np.int64)
    perm[(pos % QUARTERS) * GROUPS + pos // QUARTERS] = np.arange(TILE)
    return perm


def conflicts(idx, vid, perm):
    """Cycles per 32 words of a warp's 16-byte load: each quarter-warp
    takes as many passes as its most frequent bank group holds lanes."""
    g = groups(idx, vid)[perm].reshape(-1, 8)
    most = np.array([np.bincount(q, minlength=GROUPS).max() for q in g])
    return most.reshape(-1, 4).sum(1).mean() / 4


def _tiles():
    out = {f"seed {s}": np.random.default_rng(s).integers(
        0, LANE - 3, (ROWS, LANE), np.int32) for s in (3, 11, 23)}
    out["seed 5 (K7)"] = k7.make_inputs("cpu")["idx"].numpy()
    out["seed 7 (bundle)"] = k8.make_inputs("cpu")["idx"].numpy()
    out["all 60"] = np.full((ROWS, LANE), 60, np.int32)
    out["all 0"] = np.zeros((ROWS, LANE), np.int32)
    out[f"all {LANE - 4}"] = np.full((ROWS, LANE), LANE - 4, np.int32)
    out["0 and 124"] = np.where(np.arange(TILE).reshape(ROWS, LANE) % 3, 0,
                                LANE - 4).astype(np.int32)
    return out


TILES = _tiles()


@pytest.mark.parametrize("vid", WALKS)
@pytest.mark.parametrize("tile", list(TILES))
def test_lanes_are_a_permutation(tile, vid):
    perm = deal(TILES[tile], vid)
    np.testing.assert_array_equal(np.sort(perm), np.arange(TILE))


@pytest.mark.parametrize("vid, tile, predicted, in_order", [
    (ID["hermite_pair"], "seed 5 (K7)", 1.23, 2.55),
    (K9, "seed 7 (bundle)", 1.24, 2.65)])
def test_dealt_lanes_spread_the_banks(vid, tile, predicted, in_order):
    idx = TILES[tile]
    dealt = conflicts(idx, vid, deal(idx, vid))
    ordered = conflicts(idx, vid, np.arange(TILE))
    assert dealt <= predicted and ordered >= in_order
    # an all-equal tile puts every lane of a quarter-warp in one group
    assert conflicts(TILES["all 60"], vid, deal(TILES["all 60"], vid)) == 8


def _launch(sms, per_sm, steps):
    units = steps * UNITS
    grid = min(per_sm * sms, -(-units // WARPS))
    warps = grid * WARPS
    base, extra = divmod(units, warps)
    w = np.arange(warps, dtype=np.int64)
    start = w * base + np.minimum(w, extra)
    return grid, start, start + base + (w < extra)


@pytest.mark.parametrize("steps", (1, 3, 7, 512, 2048))
@pytest.mark.parametrize("sms, per_sm", ((1, 1), (7, 2), (132, 2)))
def test_launch_takes_every_element_step_once(sms, per_sm, steps):
    grid, start, end = _launch(sms, per_sm, steps)
    assert start[0] == 0 and end[-1] == steps * UNITS
    np.testing.assert_array_equal(start[1:], end[:-1])
    n = end - start
    assert n.max() - n.min() <= 1 and (n.reshape(grid, WARPS)[:, 0] > 0).all()
    perm = deal(TILES["seed 5 (K7)"], ID["hermite_pair"])
    u = np.arange(steps * UNITS)
    taken = (u[:, None] // UNITS) * TILE + perm[
        (u[:, None] % UNITS) * 32 + np.arange(32)[None, :]]
    np.testing.assert_array_equal(np.sort(taken.ravel()),
                                  np.arange(steps * TILE))


# ---------------------------------------------------------------------------
# The addressing and the arithmetic
# ---------------------------------------------------------------------------

def trips(vid, count):
    """``walk_launch``: after the first chain period, turns of TURN quads
    and tail trips of a period, checked against experiments.walk_trips."""
    words = {ID["hermite_pair"]: count // 2, K9: 2 * count}.get(vid, count)
    period = CHAINS[vid] // 4
    quads = words // 4 - period
    out = quads // TURN, quads % TURN // period
    assert experiments.walk_trips(vid, count) == out
    return out


HI_I2F = int(re.search(r"constexpr int kHiI2F = 0x([0-9A-Fa-f]+);",
                       SOURCE).group(1), 16)
BIAS_LO = np.uint32(0x8000)      # ``word_bias``: the lo half of an int word


def magic16(v, hi, half):
    """``half16`` by the exponent trick: the biased lo half ORed under 2^23
    (2^22), less 2^23 + 2^15, or the signed hi half added to 1.5 x 2^23
    (2^22), less that (each halved for ``half``)."""
    if hi:
        exp, off = ((0x4AC00000, 6291456.0) if half else (0x4B400000, 12582912.0))
        bits = np.uint32(exp) + (v.view(np.int32) >> 16).astype(np.uint32)
    else:
        exp, off = ((0x4A800000, 4210688.0) if half else (0x4B000000, 8421376.0))
        bits = (v & np.uint32(0xFFFF)) | np.uint32(exp)
    return bits.view(np.float32) - np.float32(off)


def half16(v, plane, hi, i2f=False):
    """``half16`` of a staged word of ``plane``, the slope plane's (plane
    1) halved: through I2F of the signed hi half (``i2f``, the halving then
    the weight's, exact either way), else by the exponent trick."""
    if not (hi and i2f):
        return magic16(v, hi, plane == 1)
    f = (v.view(np.int32) >> 16).astype(np.float32)
    return f * np.float32(0.5) if plane else f


ROW_QUADS = COPIES * COPY_QUADS               # a row's copies


def copies(plane, bias):
    """A plane's staged words as ``build_copies`` lays them out: row r's
    copy c from quad (r * COPIES + c) * COPY_QUADS, holding word (k + c) &
    127 at word k."""
    flat = np.full(ROWS * ROW_QUADS * 4, -1, np.int64)
    k = np.arange(COPY_QUADS * 4)
    for r in range(ROWS):
        for c in range(COPIES):
            at = (r * ROW_QUADS + c * COPY_QUADS) * 4 + k
            flat[at] = plane.view(np.uint32)[r, (k + c) & (LANE - 1)] ^ bias
    assert (flat >= 0).all()
    return flat


def model(vid, src, src2, idx, w, count):
    """The walk of every element of a tile through the shifted copies, in
    the kernel's order (the first period word by word, turns and the tail
    quad by quad, then the fix-up of the quad the kept range ends inside),
    products and sums rounded apart."""
    idx, w = idx.ravel(), w.ravel()
    b = BIAS_LO if src.dtype == np.int32 else np.uint32(0)
    bias = (b, b)
    cp = [copies(p, b) for p, b in zip((src, src2), bias)]
    row = np.arange(TILE) // LANE
    o0 = ORIGIN[vid]
    s = (idx + o0) & (LANE - 1)
    end = LANE - idx - o0
    acc = np.zeros((8, TILE), np.float32)
    zero = np.float32(0)
    period = CHAINS[vid] // 4
    turns, tail = trips(vid, count)
    quads = period * (1 + tail) + TURN * turns
    taken = np.zeros((quads * 4, TILE), np.int64)   # adds of each word

    def stretch(q0, nq, keep, fix_up=False):
        """Quads q0 .. q0 + nq of every walk; keep(kk) the kept mask of
        word kk of the stretch (the fix-up leaves out each quad's last
        word, which it never keeps)."""
        pb = (((s >> 2) + q0) & 31) * 16
        for t in range(nq):
            for j in range(3 if fix_up else 4):
                kk = 4 * t + j
                at = pb // 4 + kk
                assert (at < COPY_QUADS * 4).all()
                word_at = (row * ROW_QUADS + (s & 3) * COPY_QUADS) * 4 + at
                va, vb = (c[word_at].astype(np.uint32) for c in cp)
                word = 4 * q0 + kk
                np.testing.assert_array_equal(
                    va, src.view(np.uint32)[row, (idx + o0 + word)
                                            & (LANE - 1)] ^ bias[0])
                np.testing.assert_array_equal(
                    vb, src2.view(np.uint32)[row, (idx + o0 + word)
                                             & (LANE - 1)] ^ bias[1])
                k = keep(kk)
                taken[word] += k
                ws = np.where(k, w, zero)
                c = kk % CHAINS[vid]
                if vid == ID["f32_direct"]:
                    acc[c] = acc[c] + va.view(np.float32)
                elif vid == ID["idx_fresh"]:
                    acc[c] = acc[c] + ws * va.view(np.float32)
                else:
                    q = t % TURN
                    acc[c] = acc[c] + ws * half16(va, 0, True,
                                                  HI_I2F >> q & 1)
                    if vid != ID["unpack"]:
                        acc[c] = acc[c] + ws * half16(vb, 1, True,
                                                      HI_I2F >> (4 + q) & 1)
                    acc[c] = acc[c] + ws * half16(va, 0, False)
                    if vid != ID["unpack"]:
                        acc[c] = acc[c] + ws * half16(vb, 1, False)

    lead = idx + o0 < 0
    stretch(0, period, lambda kk: (np.full(TILE, 4 * (kk // 4) + 4) <= end)
            & ~((kk == 0) & lead))
    q = period
    for nq, n in ((TURN, turns), (period, tail)):
        for _ in range(n):
            hi = end - 4 * q
            stretch(q, nq, lambda kk, hi=hi: np.full(TILE, 4 * (kk // 4) + 4)
                    <= hi)
            q += nq
    assert q == quads
    if vid != ID["f32_direct"]:
        qb = end // 4
        fix = (end % 4 > 0) & (qb < quads)
        p0 = np.where(fix, qb // period * period, 0)
        lo, hi = np.where(fix, 4 * (qb - p0), 0), np.where(fix, end - 4 * p0, 0)
        # the fix-up reads period p0 of each walk; the model takes one p0 at
        # a time, the other walks adding +-0 there
        for first in np.unique(p0):
            sel = p0 == first
            stretch(int(first), period,
                    lambda kk, sel=sel: sel & (kk >= lo) & (kk < hi),
                    fix_up=True)
        # every kept word taken once, no masked word taken
        words = np.arange(quads * 4)[:, None]
        want = (words >= lead[None, :]) & (words < end[None, :])
        np.testing.assert_array_equal(taken, want)
    out = acc[0]
    for c in range(1, CHAINS[vid]):
        out = out + acc[c]
    return out.reshape(ROWS, LANE)


def k8_model(src, src2, idx, w, units):
    """K8's bundle: five offsets of row 0 taken once, units in turns of 4
    and a tail of 2, ``k8_units``' order."""
    idx, w = idx.ravel(), w.ravel()
    zero = np.float32(0)
    ws, h = [], []
    for off in range(5):
        rr = idx + off
        ws.append(np.where(rr < LANE, w, zero))
        va = src.view(np.uint32)[0, rr & (LANE - 1)] ^ BIAS_LO
        vb = src2.view(np.uint32)[0, rr & (LANE - 1)] ^ BIAS_LO
        h.append((half16(va, 0, True, HI_I2F & 1),
                  half16(vb, 1, True, HI_I2F >> 4 & 1),
                  half16(va, 0, False), half16(vb, 1, False)))
    acc = np.zeros((4, TILE), np.float32)
    for n, reps in ((4, units // 4), (2, units % 4 // 2)):
        for _ in range(reps):
            for off in range(n + 1):
                for term in range(4):
                    for b in range(2):
                        u, p = off - 1 + b, 1 - b
                        if 0 <= u < n:
                            c = (2 * u + p) & 3
                            acc[c] = acc[c] + ws[off] * h[off][term]
    return (acc[0] + acc[1] + acc[2] + acc[3]).reshape(ROWS, LANE)


def test_exponent_trick_is_exact_for_every_half():
    """Both routes of ``half16`` in both planes, at every 16-bit value of
    each half, the other half arbitrary."""
    v = np.arange(1 << 16, dtype=np.uint32)
    want = ((v ^ 0x8000).astype(np.int64) - 0x8000).astype(np.float32)
    other = np.random.default_rng(3).integers(0, 1 << 16, v.size).astype(np.uint32)
    for hi in (True, False):
        word = ((v << np.uint32(16)) | other) if hi else ((other << np.uint32(16)) | v)
        for plane in (0, 1):
            for i2f in ((False, True) if hi else (False,)):
                np.testing.assert_array_equal(
                    half16(word ^ BIAS_LO, plane, hi, i2f),
                    want / 2 if plane else want)
    # the value plane's hi halves go through I2F in every quad of a turn
    assert HI_I2F & 0xF == 0xF


def _inputs(vid, tile):
    x = (k7.make_inputs("cpu") if vid in ID.values()
         else k8.make_inputs("cpu"))
    if vid in ID.values():
        name = {v: k for k, v in ID.items()}[vid]
        src, src2 = k7.sources(name, x)
    else:
        src, src2 = x["src"], x["src2"]
    return src.numpy(), src2.numpy(), TILES[tile], x["w"].numpy()


@pytest.mark.parametrize("tile", ["seed 5 (K7)", "seed 11", "all 0",
                                  f"all {LANE - 4}", "0 and 124"])
@pytest.mark.parametrize("vid, count", [
    (ID["f32_direct"], 224), (ID["f32_direct"], 40),
    (ID["idx_fresh"], 224), (ID["unpack"], 40),
    (ID["hermite_pair"], 224), (ID["hermite_pair"], 40),
    (K9, 28), (K9, 2), (K8, 16), (K8, 6)])
def test_walk_model_equals_the_plain_version(vid, count, tile):
    src, src2, idx, w = _inputs(vid, tile)
    if vid == K8:
        got = k8_model(src, src2, idx, w, count)
    else:
        got = model(vid, src, src2, idx, w, count)
    tensors = [torch.from_numpy(a) for a in (src, src2, idx, w)]
    if vid in ID.values():
        name = {v: k for k, v in ID.items()}[vid]
        ref = k7.kernel_ref(name, *tensors, count)
    else:
        ref = experiments.gather_hermite_ref(*tensors, count, vid == K8)
    np.testing.assert_array_equal(got, ref.numpy())
