"""The redesigned gather-floor kernel (``csrc/micro_gather.cu``:
``gather_floor_kernel``, K5 and K6) on the CPU: a numpy model of its launch,
its constants and staging table read from the source.

* The launch: a persistent grid of at most the blocks the card holds at
  once (blocks a SM x SMs), and no more than ceil(units / warps a block)
  for the ``steps x 16`` units (a row of a step, one warp's); each warp a
  run of consecutive units, ``base`` each and one more for the first
  ``extra`` warps; lane l of a unit the 16-byte word ``(l + step) % 32`` of
  its row.  Over SM counts 1, 7 and 132, 1, 2 and 4 blocks a SM and steps
  1, 3, 7, 512 and 16384: every (step, element) is taken exactly once, the
  warps' unit counts differ by at most one, no block is idle, and no
  thread takes one element twice among its first 2048 element-steps, while
  a thread's elements repeat with period 2048 element-steps (so any 2048 in
  a row are distinct; only a thread with more than 2048, at steps above its
  grid's threads, meets an element again).
* The staging: each variant stages exactly the planes and rows that its
  plain version gathers from, found by perturbing each row of each source
  plane of the plain version (at even columns: a change at another element
  is a gather, a change at the perturbed element alone is ``fma``'s own
  value).
* The Python side agrees with the source: the variant ids below K7's,
  the warps a block.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu_torch import experiments  # noqa: E402
from ogl_beamforming_tpu_torch.experiments import gather_micro as k5  # noqa: E402
from ogl_beamforming_tpu_torch.experiments import gather_micro2 as k6  # noqa: E402
from ogl_beamforming_tpu_torch.experiments import gather_micro3 as k7  # noqa: E402

SOURCE = (Path(experiments.__file__).resolve().parent.parent / "csrc"
          / "micro_gather.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


def _table(name: str) -> list:
    m = re.search(rf"constexpr int {name}\[kFloorVariants\] = \{{([^}}]*)\}};",
                  SOURCE)
    assert m, name
    return [int(x) for x in m.group(1).split(",")]


ENUM = re.search(r"enum Variant \{([^}]*)\}", SOURCE).group(1)
VARIANTS = [v.strip() for v in ENUM.split(",") if v.strip()]
assert re.search(r"constexpr int kFloorVariants = K7_FMA;", SOURCE)
FLOOR_VARIANTS = VARIANTS.index("K7_FMA")
THREADS = _constant("kFloorThreads")
WARPS = THREADS // 32
QUAD = _constant("kQuad")
ROWS = _constant("kRows")
LANE = _constant("kLane")
TILE = ROWS * LANE
PLANES = _table("kPlanesOf")
ROWS_OF = _table("kRowsOf")
UNIT = 32 * QUAD                 # a unit's elements: one warp's
UNITS = TILE // UNIT             # units a step
PERIOD = TILE // QUAD            # units before a lane meets a word again


def test_python_side_matches_the_source():
    assert FLOOR_VARIANTS == experiments.FLOOR_VARIANTS == 12
    assert WARPS == experiments.FLOOR_WARPS
    assert UNITS == experiments.FLOOR_UNITS and LANE % UNIT == 0
    assert (ROWS, LANE) == (experiments.ROWS, experiments.LANE)
    ids = list(k5.VARIANT_IDS.values()) + list(k6.VARIANT_IDS.values())
    assert sorted(ids) == list(range(FLOOR_VARIANTS))
    assert min(k7.VARIANT_IDS.values()) == FLOOR_VARIANTS
    assert len(PLANES) == len(ROWS_OF) == FLOOR_VARIANTS


# ---------------------------------------------------------------------------
# The launch, modelled in numpy
# ---------------------------------------------------------------------------

def _launch(sms: int, per_sm: int, steps: int):
    """``floor_launch`` and the kernel's split: the grid, and each warp's
    run of units [start, end)."""
    units = steps * UNITS
    grid = min(per_sm * sms, -(-units // WARPS))
    warps = grid * WARPS
    base, extra = divmod(units, warps)
    w = np.arange(warps, dtype=np.int64)
    start = w * base + np.minimum(w, extra)
    return grid, start, start + base + (w < extra)


def _words(u, lane):
    """``floor_offset``: the first element of lane ``lane``'s word of unit
    ``u`` (part u % UNITS of step u / UNITS, word (lane + step) % 32), and
    its step."""
    step = u // UNITS
    return (u % UNITS) * UNIT + QUAD * ((lane + step) % 32), step


STEPS = (1, 3, 7, 512, 16384)


@pytest.mark.parametrize("steps", STEPS)
def test_units_take_every_element_step_once(steps):
    """Unit u is part u % UNITS of step u / UNITS, and its 32 lanes take
    the 32 words of that part once each, so the units of a step take its
    2048 elements once each (the warps' runs partition the units: the next
    test)."""
    u = np.arange(steps * UNITS, dtype=np.int32)
    first, step = _words(u[:, None], np.arange(32, dtype=np.int32)[None, :])
    np.testing.assert_array_equal(step[:, 0], u // UNITS)
    assert (first // UNIT == (u % UNITS)[:, None]).all()
    word = (first % UNIT) // QUAD
    assert (first % QUAD == 0).all()
    counts = np.bincount((u[:, None] * 32 + word).ravel(),
                         minlength=u.size * 32)
    assert (counts == 1).all()


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("per_sm", (1, 2, 4))
@pytest.mark.parametrize("sms", (1, 7, 132))
def test_launch_splits_the_units(sms, per_sm, steps):
    """The grid, each warp's run of units, and each thread's elements."""
    units = steps * UNITS
    grid, start, end = _launch(sms, per_sm, steps)
    assert 1 <= grid <= per_sm * sms
    # the runs partition [0, units), their lengths differ by at most one
    assert start[0] == 0 and end[-1] == units
    np.testing.assert_array_equal(start[1:], end[:-1])
    n = end - start
    assert n.max() - n.min() <= 1
    # no block without a unit
    assert (n.reshape(grid, WARPS)[:, 0] > 0).all()
    # each thread: its first PERIOD units take distinct words of the tile,
    # and unit k + PERIOD of a run takes unit k's word
    u = np.arange(units, dtype=np.int32)
    warp = (np.searchsorted(start, u, side="right") - 1).astype(np.int32)
    lane = np.arange(32, dtype=np.int32)[None, :]
    word = _words(u[:, None], lane)[0] // QUAD      # 0 .. PERIOD - 1
    head = u - start[warp] < PERIOD
    key = ((warp[head, None] * 32 + lane) * PERIOD + word[head]).ravel()
    assert np.unique(key).size == key.size
    later = u[PERIOD:][warp[PERIOD:] == warp[:-PERIOD]] if units > PERIOD \
        else u[:0]
    np.testing.assert_array_equal(word[later], word[later - PERIOD])
    if n.max() <= PERIOD:
        assert head.all()     # then no thread takes one element twice


# ---------------------------------------------------------------------------
# The staging: what each variant's plain version gathers
# ---------------------------------------------------------------------------

def _plain(variant_id: int):
    """The plain version of variant ``variant_id`` as a function of its two
    source planes, at the TPU files' inputs and 8 repetitions."""
    if variant_id in k5.VARIANT_IDS.values():
        v = {i: n for n, i in k5.VARIANT_IDS.items()}[variant_id]
        x = k5.make_inputs("cpu")
        return (lambda a, b: k5.kernel_ref(v, a, x["idx"], reps=8)), \
            (x["src"], x["src"].clone())
    v = {i: n for n, i in k6.VARIANT_IDS.items()}[variant_id]
    x = k6.make_inputs("cpu")
    src, src2 = x[v]
    return (lambda a, b: k6.kernel_ref(v, a, b, x["idx"], x["w"], reps=8)), \
        (src.clone(), src2.clone())


def _gathered(variant_id: int) -> set:
    """{(plane, row)} the plain version gathers from: perturbing the row's
    even columns changes an output at an element it did not perturb."""
    fn, planes = _plain(variant_id)
    ref = fn(*planes)
    out = set()
    for p in range(2):
        for r in range(ROWS):
            moved = [t.clone() for t in planes]
            bump = 1.0 if moved[p].is_floating_point() else 1 + (1 << 16)
            moved[p][r, 0::2] += bump
            changed = (fn(*moved) != ref).numpy()
            changed[r, 0::2] = False
            if changed.any():
                out.add((p, r))
    return out


@pytest.mark.parametrize("variant_id", range(12))
def test_each_variant_stages_what_it_gathers(variant_id):
    assert variant_id < FLOOR_VARIANTS
    staged = {(p, r) for p in range(PLANES[variant_id])
              for r in range(ROWS_OF[variant_id])}
    assert staged == _gathered(variant_id)


def test_ab_ablations_find_their_lines():
    """Each ablation of ``experiments.gather_ab`` finds the line it
    replaces, once, in this tree's source; the harness measures the card
    alone."""
    from ogl_beamforming_tpu_torch.experiments import gather_ab
    srcs = gather_ab.sources([], True)
    assert list(srcs) == ["change", *gather_ab.ABLATIONS]
    assert all(srcs[n] != srcs["change"] for n in gather_ab.ABLATIONS)
    with pytest.raises(RuntimeError):
        gather_ab.main([], device="cpu")
