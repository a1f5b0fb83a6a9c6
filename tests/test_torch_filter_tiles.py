"""The redesigned filter kernels (``csrc/filter.cu``: K3 ``demodulate``, K4
``fir``) on the CPU: the plan's rotation table, and a numpy model of the
kernels' tiling.

* The plan's omega is ``demod_omega``'s and the JAX package's float32
  omega, bit for bit; its table is the twin's cos and sin of the same
  float32 argument, bit for bit.
* The tiling: each block stages a window of pairs (demodulate) or samples
  (fir) from 16-byte words of its row, element by element where the row's
  start, end or odd offset cuts a word; each thread then reads the window
  slots of its V outputs (V consecutive ones for the 16-tap register
  window at D = 1, else V outputs THREADS apart).  The model follows the
  kernel's index arithmetic (its constants read from the source) and checks that every output reads
  exactly the twin's (output, tap) -> input index set, zeros outside the
  row, every 16-byte word aligned and inside its row, and each output
  written once.
* Demodulation through a CPU plan, whose table the twin then reads, against
  JAX and golden (the tolerances of ``test_torch_filtering.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import filtering as jax_filtering  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu_torch import DataKind, ShaderKind  # noqa: E402
from ogl_beamforming_tpu_torch.models import presets  # noqa: E402
from ogl_beamforming_tpu_torch.ops import filtering  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.plan import build_plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu_torch.utils.filters import Filter  # noqa: E402

SOURCE = (Path(filtering.__file__).resolve().parent.parent / "csrc"
          / "filter.cu").read_text()


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


THREADS = _constant("kThreads")
FIXED_TAPS = _constant("kFixedTaps")
WINDOW_OUTPUTS = _constant("kWindowOutputs")   # V of the register window
LOOP_OUTPUTS = _constant("kLoopOutputs")       # V of the runtime-L loop


def _plan(fd, fs, c=4, a=2, s=256, d=1, taps=None, data_kind=DataKind.Int16):
    p, _ = presets.forces_compounding(channel_count=c, transmit_count=a,
                                      sample_count=s)
    p.demodulation_frequency = fd
    p.sampling_frequency = fs
    p.decimation_rate = d
    taps = np.ones(16, np.float32) if taps is None else taps
    pipe = PipelineSpec.from_shaders([ShaderKind.Demodulate], data_kind)
    return build_plan(p, pipe, {0: Filter(taps, 0.0, None)}, device="cpu")


FREQUENCIES = [(7.8e6, 40e6), (5e6, 20e6), (3.3e6, 31.25e6)]


def _jax_omega(fd, fs) -> np.float32:
    # as the JAX package's demodulate computes it from its plan's float32
    # frequencies
    fd, fs = jnp.float32(fd), jnp.float32(fs)
    return np.float32(2 * jnp.pi * fd / (fs / 2.0))


@pytest.mark.parametrize("fd, fs", FREQUENCIES)
def test_plan_omega_is_demod_omega_and_jax(fd, fs):
    plan = _plan(fd, fs)
    omega = filtering.demod_omega(plan.dyn["demodulation_frequency"],
                                  plan.dyn["sampling_frequency"], "cpu")
    assert omega.dtype == torch.float32
    assert omega.item() == filtering.demod_omega(fd, fs, "cpu").item()
    assert np.float32(omega.item()) == _jax_omega(fd, fs)


@pytest.mark.parametrize("fd, fs", FREQUENCIES)
def test_plan_table_is_the_twins_rotation(fd, fs):
    """cos and sin of the float32 argument omega * p, bit for bit; at path
    B's 2048 pairs the argument reaches 5e3 rad."""
    s = 4096
    table = _plan(fd, fs, s=s).dyn["phasor0"]
    assert table.dtype == torch.float32 and table.shape == (s // 2, 2)
    arg = (torch.tensor(_jax_omega(fd, fs))
           * torch.arange(s // 2, dtype=torch.float32))
    assert torch.equal(table[:, 0], torch.cos(arg))
    assert torch.equal(table[:, 1], torch.sin(arg))


# ---------------------------------------------------------------------------
# The tiling, modelled in numpy
# ---------------------------------------------------------------------------

def _round4(n: int) -> int:
    return (n + 3) & ~3


def _stage(first: int, w: int, n_in: int, start: int, per_word: int,
           unit: int, vec: bool):
    """The staging loop of one block (its threads take the words in turn,
    so together they take each word once).  Window slot i holds input unit
    ``first + i`` (a pair or a sample) of a row of ``n_in`` units whose
    first element sits ``start`` elements past a 16-byte boundary; a word
    holds ``per_word`` units of ``unit`` elements.  Returns the slots (-1:
    a zero, -2: never written) and the first elements of the words read
    whole, and the elements read one by one, as offsets in the row."""
    elems = per_word * unit
    if vec:
        phase = (elems - start) % elems // unit
        first_word = first - (first - phase) % per_word
    else:
        first_word = first
    u = np.arange(first_word, first + w, per_word)       # each word's unit
    whole = vec & (u >= 0) & (u + per_word <= n_in)
    units = (u[:, None] + np.arange(per_word)).ravel()   # every unit read
    el = (units[:, None] * unit + np.arange(unit)).ravel()
    singles = el[np.repeat(~whole, elems) & (el >= 0) & (el < n_in * unit)]
    slot = units - first
    keep = (slot >= 0) & (slot < w)
    assert len(np.unique(slot[keep])) == keep.sum(), "a slot written twice"
    slots = np.full(_round4(w + 3), -2, np.int64)
    slots[slot[keep]] = np.where((units >= 0) & (units < n_in), units,
                                 -1)[keep]
    return slots, u[whole] * unit, singles


def _model(n_in: int, stride: int, length: int, d: int, per_word: int,
           unit: int, rows: int = 4):
    """Run every block of a launch over ``rows`` rows of ``n_in`` units
    (the pairs of an int16 or float32 row, or the samples of a float32 or
    complex64 one), ``stride`` elements apart, and check it against the
    twin's index set."""
    n_out = n_in // d
    fixed = length == FIXED_TAPS and d == 1
    v = WINDOW_OUTPUTS if fixed else LOOP_OUTPUTS
    tile = THREADS * v
    w = d * (tile - 1) + length
    # the register window's V consecutive outputs a thread, or the runtime-L
    # loop's V outputs THREADS apart
    step = 1 if fixed else THREADS
    elems = per_word * unit
    t = np.arange(THREADS)
    taps = np.arange(length)
    written = np.zeros((rows, n_out), np.int64)
    for row in range(rows):
        start = row * stride % elems      # the tensor starts aligned
        vec = start % unit == 0
        for b in range(-(-n_out // tile)):
            n0 = b * tile
            first = d * n0 - (length - 1)
            slots, words, singles = _stage(first, w, n_in, start, per_word,
                                           unit, vec)
            assert vec or not len(words)
            assert ((start + words) % elems == 0).all()
            assert ((words >= 0) & (words + elems <= n_in * unit)).all()
            assert ((singles >= 0) & (singles < n_in * unit)).all()
            assert (slots[:w] != -2).all()
            n = (n0 + (t * v if fixed else t))[:, None] + step * np.arange(v)
            k = d * (n[:, 0] - n0)
            if fixed:
                assert (k + _round4(v + length - 1) <= len(slots)).all()
                assert (k % (4 if v % 4 == 0 else 2) == 0).all()
            valid = n < n_out
            read = (k[:, None, None] + d * step * np.arange(v)[:, None]
                    + taps)[valid]
            want = d * n[valid][:, None] - (length - 1) + taps
            want = np.where((want >= 0) & (want < n_in), want, -1)
            np.testing.assert_array_equal(slots[read], want)
            np.add.at(written[row], n[valid], 1)
    assert (written == 1).all()


@pytest.mark.parametrize("s_in", [1001, 1002, 514])
@pytest.mark.parametrize("length", [1, 16, 37, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_demodulate_tiles_read_the_twins_window(dtype, d, length, s_in):
    """Pairs of int16 (4 a word) and float32 (2) rows; at odd S_in every
    other row starts at an odd sample and is staged sample by sample."""
    pairs_per_word = 16 // (2 if dtype == "int16" else 4) // 2
    _model(s_in // 2, s_in, length, d, pairs_per_word, 2)


@pytest.mark.parametrize("s", [777, 1001, 2048, 514])
@pytest.mark.parametrize("length", [1, 16, 37, 64])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("cplx", [False, True])
def test_fir_tiles_read_the_twins_window(cplx, d, length, s):
    """float32 rows (4 samples a word) and complex64 rows (2)."""
    _model(s, s, length, d, 2 if cplx else 4, 1)


# ---------------------------------------------------------------------------
# Demodulation through a plan's table
# ---------------------------------------------------------------------------

C, A, S, L = 4, 2, 256, 16
FD, FS = 5e6, 20e6


def _taps(cplx: bool) -> np.ndarray:
    rng = np.random.default_rng(17 + cplx)
    h = rng.standard_normal(L).astype(np.float32)
    if cplx:
        h = (h + 1j * rng.standard_normal(L)).astype(np.complex64)
    return h


def _data(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"int16": 1, "f32": 2}[kind])
    if kind == "int16":
        return rng.integers(-2048, 2048, (C, A, S)).astype(np.int16)
    return rng.standard_normal((C, A, S)).astype(np.float32)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("kind", ["int16", "f32"])
def test_demodulate_with_plan_table_matches_jax_and_golden(kind, cplx_taps,
                                                           d):
    """``test_filtering``'s inputs through a [Demodulate] plan: the stage
    reads the plan's table."""
    x, h = _data(kind), _taps(cplx_taps)
    plan = _plan(FD, FS, C, A, S, d, h,
                 DataKind.Int16 if kind == "int16" else DataKind.Float32)
    assert plan.dyn["phasor0"].shape == (S // 2, 2)
    out = plan(torch.from_numpy(x)).numpy()
    assert out.dtype == np.complex64 and out.shape == (C, A, S // 2 // d)
    assert np.array_equal(out, filtering.demodulate_ref(
        torch.from_numpy(x), torch.from_numpy(h), FD, FS, d,
        cplx_taps).numpy())
    xla = np.asarray(jax_filtering.demodulate(
        jnp.asarray(x), jnp.asarray(h), FD, FS, decimation_rate=d,
        complex_filter=cplx_taps))
    assert nrmse(xla, out) <= 1e-5
    ref = golden.demodulate(x, h, FD, FS, d, complex_filter=cplx_taps)
    assert nrmse(ref, out) <= 1e-3


def test_demodulate_rejects_a_table_of_another_length():
    rf = torch.zeros((2, 64), dtype=torch.int16)
    table = filtering.demod_phasor(torch.tensor(0.5), 31)
    with pytest.raises(ValueError, match="phasor"):
        filtering.demodulate(rf, torch.ones(4), FD, FS, phasor=table)
