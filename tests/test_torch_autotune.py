"""The port's autotune surface (``ops/das_cuda.py`` and ``ops/decode.py``)
on the CPU, against the JAX package's ``das_pallas``/``decode`` autotune
where the two must agree: the table key of a configuration, the JSON row
format, the lazy shipped table that user entries win over, the order
ABLATE > TUNED > default, the refusal of a table of TPU knobs, and the
ranking of an autotune sweep (minima over passes, a failing candidate
None, the prior entry restored, DECODE_ABLATE untouched) with the CUDA-event
timer replaced by a stub.  Timing itself needs the card
(``tests/test_torch_cuda.py``); nothing here launches a kernel.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ogl_beamforming_tpu.ops import das as jax_das  # noqa: E402
from ogl_beamforming_tpu.ops import das_pallas  # noqa: E402
from ogl_beamforming_tpu.ops import golden as jax_golden  # noqa: E402
from ogl_beamforming_tpu.params import enums as jax_enums  # noqa: E402
from ogl_beamforming_tpu_torch.kernels import build  # noqa: E402
from ogl_beamforming_tpu_torch.ops import das, das_cuda, decode  # noqa: E402
from ogl_beamforming_tpu_torch.ops import golden  # noqa: E402
from ogl_beamforming_tpu_torch.params import enums  # noqa: E402
from ogl_beamforming_tpu_torch.utils import (  # noqa: E402
    device as device_utils)
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz, das_transform_3d)

REPO = Path(__file__).resolve().parent.parent
PITCH = 0.3e-3


@pytest.fixture(autouse=True)
def tables(monkeypatch, tmp_path):
    """Empty knob tables for each test, the shipped tables pointed at files
    under ``tmp_path`` that do not exist yet and marked unloaded; all put
    back after the test."""
    for module, names in ((das_cuda, ("TUNED", "ABLATE")),
                          (decode, ("DECODE_TUNED", "DECODE_ABLATE"))):
        for name in names:
            monkeypatch.setattr(module, name, {})
    monkeypatch.setattr(das_cuda, "_SHIPPED_TUNED_LOADED", False)
    monkeypatch.setattr(decode, "_DECODE_SHIPPED_LOADED", False)
    monkeypatch.setattr(das_cuda, "TUNED_PATH", tmp_path / "tuned.json")
    monkeypatch.setattr(decode, "DECODE_TUNED_PATH",
                        tmp_path / "decode_tuned.json")


def _fields(kind: str) -> dict:
    """DasParams fields of one acquisition of each family, enums by name."""
    kw = dict(channel_count=8, sample_count=256, sampling_frequency=20e6,
              demodulation_frequency=5e6, speed_of_sound=1500.0,
              time_offset=1e-7, f_number=0.8,
              xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
              interpolation_mode="Cubic")
    if kind in ("FORCES", "UFORCES", "Flash"):
        kw.update(voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                      [7 * PITCH, 8e-3]),
                  output_points=(12, 16, 1))
    else:
        kw.update(voxel_transform=das_transform_3d(
            [0, 0, 1e-3], [7 * PITCH, 7 * PITCH, 8e-3]),
            output_points=(6, 5, 7), interpolation_mode="Linear")
    a = {"FORCES": 4, "UFORCES": 5, "HERCULES": 4, "Flash": 1}[kind]
    if kind == "UFORCES":
        kw.update(sparse=True,
                  sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    return dict(kw, acquisition_kind=kind, acquisition_count=a)


def _statics(kind: str, iq: bool, batch: int = 1):
    """(JAX DasStatic, port DasStatic) of ``kind``, each from its own
    package's DasParams and make_static."""
    out = []
    for mod, en, make in ((jax_golden, jax_enums, jax_das.make_static),
                          (golden, enums, das.make_static)):
        kw = _fields(kind)
        kw["acquisition_kind"] = en.AcquisitionKind[kw["acquisition_kind"]]
        kw["interpolation_mode"] = en.InterpolationMode[
            kw["interpolation_mode"]]
        st = make(mod.DasParams(**kw), iq=iq)
        out.append(dataclasses.replace(st, frame_batch=batch))
    return out


def _port(kind: str, iq: bool = False, batch: int = 1):
    kw = _fields(kind)
    kw["acquisition_kind"] = enums.AcquisitionKind[kw["acquisition_kind"]]
    kw["interpolation_mode"] = enums.InterpolationMode[
        kw["interpolation_mode"]]
    p = golden.DasParams(**kw)
    st = dataclasses.replace(das.make_static(p, iq=iq), frame_batch=batch)
    return st, das.make_dynamic(p, "cpu")


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["FORCES", "UFORCES", "HERCULES", "Flash"])
def test_tune_key_is_the_jax_key(kind, iq, batch):
    jax_st, port_st = _statics(kind, iq, batch)
    assert das_cuda._tune_key(port_st) == das_pallas._tune_key(jax_st)
    assert (len(das_cuda._tune_key(port_st)) == 8) == (batch > 1)


def _entries():
    hercules = das_cuda._tune_key(_port("HERCULES")[0])
    batched = das_cuda._tune_key(_port("Flash", iq=True, batch=4)[0])
    forces = das_cuda._tune_key(_port("FORCES")[0])
    return {hercules: {"thread": [2, 4, 0], "tx_walk": 0},
            batched: {"fb": 1},
            forces: {"tx_pass": 16}}


def test_das_table_round_trip(tmp_path):
    """save_tuned writes the JAX package's rows; load_tuned reads them back
    exactly, batched keys included; JAX's loader reads the single-frame
    rows back to the same keys."""
    entries = _entries()
    das_cuda.TUNED.update(entries)
    path = tmp_path / "t.json"
    das_cuda.save_tuned(path)
    rows = json.loads(path.read_text())
    assert all(set(r) == {"key", "knobs"} for r in rows)
    assert [r["key"][6] for r in rows] == [list(k[6]) for k in entries]
    das_cuda.TUNED.clear()
    das_cuda.load_tuned(path)
    assert das_cuda.TUNED == entries
    saved = dict(das_pallas.TUNED)
    try:
        das_pallas.load_tuned(path)
        for k, v in entries.items():
            if len(k) == 7:
                assert das_pallas.TUNED[k] == v
    finally:
        das_pallas.TUNED.clear()
        das_pallas.TUNED.update(saved)


def test_decode_table_round_trip(tmp_path):
    entries = {(128, 128, 4096): {"tile_s": 128, "row_warps": 1},
               (128, 128, 4096 * 2): {},
               (256, 256, 4096): {"row_warps": 2}}
    decode.DECODE_TUNED.update(entries)
    path = tmp_path / "d.json"
    decode.save_decode_tuned(path)
    assert json.loads(path.read_text())[0] == {
        "key": [128, 128, 4096], "knobs": {"tile_s": 128, "row_warps": 1}}
    decode.DECODE_TUNED.clear()
    decode.load_decode_tuned(path)
    assert decode.DECODE_TUNED == entries


def test_shipped_tables_load_lazily_and_yield_to_the_user():
    """The shipped tables are read on first use, once; an entry the user
    installed before stays."""
    entries = _entries()
    das_cuda.TUNED.update(entries)
    das_cuda.save_tuned(das_cuda.TUNED_PATH)
    decode.DECODE_TUNED[(4, 16, 512)] = {"tile_s": 128}
    decode.DECODE_TUNED[(4, 16, 1024)] = {"row_warps": 2}
    decode.save_decode_tuned(decode.DECODE_TUNED_PATH)
    st, dyn = _port("HERCULES")
    user = {"thread": [3, 4, 0]}        # the shipped entry says (2, 4, 0)
    das_cuda.TUNED.clear()
    das_cuda.TUNED[das_cuda._tune_key(st)] = user
    decode.DECODE_TUNED.clear()
    decode.DECODE_TUNED[(4, 16, 512)] = {"row_warps": 2}
    assert not das_cuda._SHIPPED_TUNED_LOADED
    assert das_cuda.launch_tables(st, dyn)["thread"] == (3, 4, 0)
    assert das_cuda._SHIPPED_TUNED_LOADED
    assert das_cuda.TUNED == {**entries, das_cuda._tune_key(st): user}
    assert decode.decode_knobs((4, 16, 512)) == {"row_warps": 2}
    assert decode.decode_knobs((4, 16, 1024)) == {"row_warps": 2}
    das_cuda.TUNED_PATH.unlink()
    das_cuda.TUNED.clear()
    das_cuda._load_shipped_tuned()        # once: the file is not read again
    assert das_cuda.TUNED == {}


@pytest.mark.parametrize("kind", ["FORCES", "HERCULES", "Flash"])
def test_ablate_over_tuned_over_default(kind):
    """What launch_tables chooses for each knob of the family: the measured
    default, then the TUNED entry, then ABLATE over it."""
    st, dyn = _port(kind)
    key = das_cuda._tune_key(st)
    tables = das_cuda.launch_tables(st, dyn)
    if kind == "FORCES":
        name, tuned, ablate = "tx_pass", 16, 4
        default = das_cuda.index_table_pass(st, dyn)
    elif kind == "HERCULES":
        name, tuned, ablate = "thread", [2, 4, 0], [3, 4, 0]
        default = build.THREAD_SHAPES["hercules"][0]
        assert tables["tx_walk"] == das_cuda.INTERVAL_WALK
    else:
        name, tuned, ablate = "thread", [1, 32, 1], [1, 1, 1]
        default = build.THREAD_SHAPES["rca"][0]
    assert tables[name] == default and "fb" not in tables
    das_cuda.TUNED[key] = {name: tuned}
    norm = tuple if name == "thread" else int
    assert das_cuda.launch_tables(st, dyn)[name] == norm(tuned)
    das_cuda.ABLATE[name] = ablate
    assert das_cuda.launch_tables(st, dyn)[name] == norm(ablate)
    batched, bdyn = _port(kind, batch=5)
    assert das_cuda.launch_tables(batched, bdyn)["fb"] == 4
    das_cuda.TUNED[das_cuda._tune_key(batched)] = {"fb": 1}
    assert das_cuda.launch_tables(batched, bdyn)["fb"] == 1
    assert list(das_cuda._chunks(5, 4)) == [(0, 4), (4, 1)]
    assert list(das_cuda._chunks(5, 1)) == [(i, 1) for i in range(5)]


def test_decode_knobs_ablate_over_tuned():
    key = (8, 64, 2048)
    assert decode.decode_knobs(key) == {}
    decode.DECODE_TUNED[key] = {"tile_s": 64, "row_warps": 2}
    assert decode.decode_knobs(key) == {"tile_s": 64, "row_warps": 2}
    decode.DECODE_ABLATE["tile_s"] = 128
    assert decode.decode_knobs(key) == {"tile_s": 128, "row_warps": 2}


def test_tpu_tables_do_not_load():
    """The JAX package's v5e tables name Mosaic knobs: loading them
    raises and installs nothing."""
    data = REPO / "ogl_beamforming_tpu" / "data"
    with pytest.raises(ValueError, match="unknown DAS knob"):
        das_cuda.load_tuned(data / "tuned_v5e.json")
    with pytest.raises(ValueError, match="unknown decode knobs"):
        decode.load_decode_tuned(data / "decode_tuned_v5e.json")
    assert das_cuda.TUNED == {} and decode.DECODE_TUNED == {}


@pytest.mark.parametrize("knobs, kind, match", [
    ({"thread": [5, 4, 0]}, "HERCULES", "not one of"),
    ({"thread": [1, 32, 1]}, "HERCULES", "not one of"),
    ({"tx_pass": 33}, "FORCES", "outside"),
    ({"tx_walk": 0}, "FORCES", "does not apply"),
    ({"fb": 1}, "HERCULES", "does not apply"),
    ({"tile_sub": 16}, "Flash", "unknown DAS knob"),
])
def test_check_knobs_refuses(knobs, kind, match):
    key = das_cuda._tune_key(_port(kind)[0])
    with pytest.raises(ValueError, match=match):
        das_cuda.check_knobs(key, knobs)


def test_batched_shapes_need_single_frame_launches():
    key = das_cuda._tune_key(_port("HERCULES", batch=4)[0])
    with pytest.raises(ValueError, match="single-frame"):
        das_cuda.check_knobs(key, {"thread": [2, 4, 0]})
    das_cuda.check_knobs(key, {"thread": [2, 4, 0], "fb": 1})
    for cand in das_cuda._default_candidates(_port("HERCULES", batch=4)[0]):
        das_cuda.check_knobs(key, cand)


def test_autotuners_refuse_cpu_tensors():
    st, dyn = _port("FORCES")
    with pytest.raises(ValueError, match="CUDA"):
        das_cuda.autotune_das(torch.zeros(8, 4, 256), dyn, st)
    with pytest.raises(ValueError, match="CUDA"):
        decode.autotune_decode(torch.zeros(2, 16, 64, dtype=torch.int16),
                               decode.hadamard_matrix(16, "cpu"))


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it is on the card, so the autotuners reach
    their sweep with the timer stubbed."""

    @property
    def is_cuda(self):
        return True


def _stub_timer(monkeypatch, current, times):
    """Replace the CUDA-event timer: the candidate running (``current()``)
    takes the next of its ``times``, seconds, one a pass; an Exception
    raises."""
    calls = []

    def event_seconds(fn, iters, warmup):
        name = repr(current())
        calls.append(name)
        t = times[name][sum(c == name for c in calls) - 1]
        if isinstance(t, Exception):
            raise t
        return t

    monkeypatch.setattr(device_utils, "event_seconds", event_seconds)
    return calls


def test_autotune_das_ranks_minima_and_records_failures(monkeypatch):
    st, dyn = _port("HERCULES")
    key = das_cuda._tune_key(st)
    assert das_cuda._default_candidates(st) == [{}, {"thread": [2, 4, 0]}]
    cands = [{}, {"thread": [2, 4, 0]}, {"tx_walk": 0},
             {"thread": [3, 4, 0]}]
    times = {repr(c): [3.0, 3.0] for c in cands}
    times[repr(cands[1])] = [2.5, 1.0]       # best on its second pass
    times[repr(cands[2])] = [0.5, 4.0]       # best on one pass only: its
    times[repr(cands[3])] = [RuntimeError("launch"), 0.1]    # minimum wins
    calls = _stub_timer(monkeypatch, lambda: das_cuda.TUNED[key], times)
    rf = torch.zeros(8, 4, 256).as_subclass(_CudaLooking)
    best, results = das_cuda.autotune_das(rf, dyn, st, candidates=cands,
                                          passes=2)
    assert best == cands[2] and das_cuda.TUNED[key] == cands[2]
    assert results[repr(cands[1])] == 1.0 and results[repr(cands[2])] == 0.5
    assert results[repr(cands[3])] is None
    assert calls.count(repr(cands[3])) == 1   # not run again after failing
    assert list(results) == [repr(c) for c in cands]


def test_autotune_das_restores_the_prior_entry(monkeypatch, tmp_path):
    st, dyn = _port("Flash", iq=True)
    key = das_cuda._tune_key(st)
    prior = {"thread": [1, 32, 1]}
    das_cuda.TUNED[key] = prior
    cands = [{}, {"thread": [1, 32, 1]}]
    _stub_timer(monkeypatch, lambda: das_cuda.TUNED[key],
                {repr(c): [ValueError("no")] for c in cands})
    rf = torch.zeros(8, 1, 256, dtype=torch.complex64).as_subclass(
        _CudaLooking)
    path = tmp_path / "saved.json"
    best, results = das_cuda.autotune_das(rf, dyn, st, candidates=cands,
                                          save_path=path)
    assert best == {} and results == {repr(c): None for c in cands}
    assert das_cuda.TUNED == {key: prior}
    assert json.loads(path.read_text())[0]["knobs"] == prior
    del das_cuda.TUNED[key]
    _stub_timer(monkeypatch, lambda: das_cuda.TUNED[key],
                {repr(c): [ValueError("no")] for c in cands})
    das_cuda.autotune_das(rf, dyn, st, candidates=cands)
    assert key not in das_cuda.TUNED


class _Interrupted(Exception):
    """Neither RuntimeError nor ValueError: not a candidate's failure."""


@pytest.mark.parametrize("prior", [None, {"thread": [3, 4, 0]}])
def test_autotune_das_interrupted_restores_the_prior_entry(monkeypatch,
                                                           prior):
    """A sweep cut by an exception that is not a candidate's failure (an
    interrupt, say) leaves no candidate installed: the entry in place
    before, or none."""
    st, dyn = _port("HERCULES")
    key = das_cuda._tune_key(st)
    if prior is not None:
        das_cuda.TUNED[key] = prior
    cands = [{}, {"thread": [2, 4, 0]}]
    _stub_timer(monkeypatch, lambda: das_cuda.TUNED[key],
                {repr(cands[0]): [1.0], repr(cands[1]): [_Interrupted()]})
    rf = torch.zeros(8, 4, 256).as_subclass(_CudaLooking)
    with pytest.raises(_Interrupted):
        das_cuda.autotune_das(rf, dyn, st, candidates=cands)
    assert das_cuda.TUNED == ({} if prior is None else {key: prior})


def test_autotune_decode_ranks_and_leaves_ablate(monkeypatch):
    """Minima over passes, a failing candidate None, the shape's entry out
    of the way while candidates run and DECODE_ABLATE left as found; a
    float frame of the same key (complex: the interleaved shape) times the
    default alone and keeps the int16 knobs."""
    decode.DECODE_ABLATE["tile_s"] = 128
    key = (2, 16, 1024)
    decode.DECODE_TUNED[key] = {"row_warps": 2}
    cands = [{}, {"tile_s": 128}, {"row_warps": 2},
             {"tile_s": 64, "row_warps": 1}]
    seen = []

    def current():
        seen.append(decode.DECODE_TUNED.get(key))
        return dict(decode.DECODE_ABLATE)

    times = {repr(cands[0]): [2.0, 2.0], repr(cands[1]): [1.5, 0.7],
             repr(cands[2]): [0.9, 0.8], repr(cands[3]): [RuntimeError("x")],
             repr({}): [2.0, 2.0, 2.0, 2.0]}
    _stub_timer(monkeypatch, current, times)
    i16 = torch.zeros(2, 16, 1024, dtype=torch.int16).as_subclass(
        _CudaLooking)
    h = decode.hadamard_matrix(16, "cpu")
    best, results = decode.autotune_decode(i16, h, candidates=cands,
                                           passes=2)
    assert best == {"tile_s": 128}
    assert results == {repr(cands[0]): 2.0, repr(cands[1]): 0.7,
                       repr(cands[2]): 0.8, repr(cands[3]): None}
    assert seen == [None] * len(seen)
    assert decode.DECODE_TUNED[key] == {"tile_s": 128}
    assert decode.DECODE_ABLATE == {"tile_s": 128}
    # a complex frame of the same key: the default alone, the entry kept
    cplx = torch.zeros(2, 16, 512, dtype=torch.complex64).as_subclass(
        _CudaLooking)
    assert decode.decode_candidates(cplx) == [{}]
    best, results = decode.autotune_decode(cplx, h, passes=2)
    assert best == {} and results == {repr({}): 2.0}
    assert decode.DECODE_TUNED[key] == {"tile_s": 128}
    with pytest.raises(ValueError, match="no knobs"):
        decode.autotune_decode(cplx, h, candidates=cands)
    del decode.DECODE_TUNED[key]
    _stub_timer(monkeypatch, current, {repr({}): [1.0]})
    decode.autotune_decode(cplx, h, passes=1)
    assert decode.DECODE_TUNED[key] == {}
    decode.DECODE_TUNED[key] = {"tile_s": 128}
    # every candidate failing: the entry in place is put back
    _stub_timer(monkeypatch, current,
                {repr(c): [RuntimeError("x")] * 2 for c in cands})
    best, _ = decode.autotune_decode(i16, h, candidates=cands)
    assert best == {} and decode.DECODE_TUNED[key] == {"tile_s": 128}
    assert decode.DECODE_ABLATE == {"tile_s": 128}


@pytest.mark.parametrize("kind", ["FORCES", "HERCULES", "Flash"])
def test_default_candidates_are_valid(kind):
    for batch in (1, 4):
        st = _port(kind, batch=batch)[0]
        cands = das_cuda._default_candidates(st)
        assert cands[0] == {} and len(cands) >= 2
        for c in cands:
            das_cuda.check_knobs(das_cuda._tune_key(st), c)


def test_default_shapes_are_the_kernels_constants():
    """The default thread shapes in ``kernels/build.py`` are
    ``csrc/das.cu``'s constants; every other shape the tables allow has its
    branch in the launch, and every decode tile of ``ops/decode.py`` its
    case in ``csrc/decode.cu``."""
    import re

    csrc = REPO / "ogl_beamforming_tpu_torch" / "csrc"
    src = (csrc / "das.cu").read_text()

    def const(name):
        v = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", src)[1]
        return {"true": 1, "false": 0}.get(v, None) if not v.isdigit() \
            else int(v)

    for family, prefix in (("hercules", "kHercules"), ("rca", "kRca")):
        default = (const(prefix + "Voxels"), const(prefix + "Lanes"),
                   const(prefix + "RunsFirst"))
        assert build.THREAD_SHAPES[family][0] == default
        for v, lanes, first in build.THREAD_SHAPES[family][1:]:
            case = (f"if (shape == shape_code({v}, {lanes}, "
                    f"{'true' if first else 'false'}))")
            assert case in src, case
    dsrc = (csrc / "decode.cu").read_text()
    tile = re.search(r"constexpr int kTileS = (\d+);", dsrc)[1]
    assert decode.I8_TILES[0] == (int(tile), 1)
    cases = re.findall(r"case (\w+) \* 4 \+ (\d):", dsrc)
    assert [(int(t) if t.isdigit() else int(tile), int(w))
            for t, w in cases] == list(decode.I8_TILES)


def test_sass_keys_of_thread_shapes():
    """A default shape's kernel keeps its key without the shape (so
    ``--same-as`` pairs it with a source from before the shape was a
    template argument); another shape's key carries it."""
    from ogl_beamforming_tpu_torch.kernels import sass
    old = "_ZN12_GLOBAL__N_119das_hercules_kernelILi2ELb1ELb0ELi1EEEvNS_4ArgsE"
    new = old.replace("ELi1EEEv", "ELi1ELi3ELi4ELb0EEEv")
    other = old.replace("ELi1EEEv", "ELi1ELi2ELi4ELb0EEEv")
    assert sass.same_key(new) == sass.same_key(old) == (
        "das_hercules_kernel Li2ELb1ELb0ELi1E")
    assert sass.same_key(other).endswith("Li2ELi4ELb0E")


def test_tune_ab_needs_the_card_and_leaves_ablate(monkeypatch):
    """``experiments.tune_ab`` raises without a GPU; it times B's knobs
    over the defaults (no table entry applies) through the autotuners'
    timer, and leaves DECODE_ABLATE as it was, also where a timing
    fails."""
    from ogl_beamforming_tpu_torch.experiments import tune_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tune_ab.main(["--shape", "4,16,64"])
    decode.DECODE_ABLATE["tile_s"] = 128
    rf = torch.zeros(4, 16, 64, dtype=torch.int16)
    h = decode.hadamard_matrix(16, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tune_ab.time_knobs([rf], h, {"row_warps": 2}, 2)
    assert decode.DECODE_ABLATE == {"tile_s": 128}
    decode.DECODE_TUNED[(4, 16, 64)] = {"tile_s": 128}
    seen = []
    monkeypatch.setattr(decode, "decode_hadamard_cuda",
                        lambda x, h: seen.append(
                            (x, dict(decode.DECODE_ABLATE))))
    monkeypatch.setattr(device_utils, "event_seconds",
                        lambda fn, iters, warmup: [
                            fn() for _ in range(warmup + iters)] and 0.002)
    rfs = [rf, rf.clone()]
    assert tune_ab.time_knobs(rfs, h, {"row_warps": 2}, 3) == 2.0
    assert [x is r for (x, _), r in zip(seen, rfs * 3)] == [True] * 5
    assert all(k == {"tile_s": 64, "row_warps": 2} for _, k in seen)
    assert decode.DECODE_ABLATE == {"tile_s": 128}
