"""Runs of the miniature cells on the CPU: the result line, the card
refusal, the imports, and ``correct`` coming out false under the control
and under each fault a cell can have."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from ogl_beamforming_tpu_torch.pipeline.plan import CompiledPlan

from h100bench import harness, run
from h100bench.reference import chain
from h100bench.spec import Bench

from .conftest import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, cell: str, traced: bool = False, seed: int = 2 ** 31 + 9,
             seconds: float = 0.3):
    result, compared, info, _ = harness.run_cell(
        Bench(root), cell, seed, seconds, traced, "cpu", time.time())
    return result, compared


@pytest.mark.parametrize("cell", ["tiny_forces.stream",
                                  "tiny_hercules.stream", "tiny_forces.live"])
@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line(tiny_root, cell, traced):
    result, compared = run_tiny(tiny_root, cell, traced)
    assert list(result)[:5] == KEYS and list(result)[-1] == "compared"
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    bench = Bench(tiny_root)
    want = {m["name"] for m in bench.metrics(cell, traced)}
    # the CPU has no kernel events: the rooflines find nothing to read
    got = set(result["metrics"])
    assert got <= want and got >= want - {"das_roofline", "decode_roofline",
                                          "demod_roofline", "h2d_copy_ms.live"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(result["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert [line.split(":")[0] for line in compared] == [
        f"compared {k}" for k in result["compared"]]
    json.dumps(result)


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "forces128_2d.stream", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def loaded(code: str) -> set:
    """The top-level names of the modules a fresh interpreter has loaded
    after ``code``."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    names = loaded("import h100bench.run, h100bench.harness, "
                   "h100bench.readings, h100bench.sweep")
    assert "torch" in names and "ogl_beamforming_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import h100bench.reference.chain, h100bench.check, "
                   "h100bench.frames, h100bench.reference.demodulate, "
                   "h100bench.reference.kinds.forces, "
                   "h100bench.reference.kinds.hercules")
    assert not names & {"ogl_beamforming_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "ogl_beamforming_tpu.ops", sys)
    assert harness.forbidden_modules() == ["jax.numpy",
                                           "ogl_beamforming_tpu.ops"]


def broken(monkeypatch, step):
    """Replace the program's plan call by ``step(plan, rf, mark, real)``."""
    real = CompiledPlan.__call__
    monkeypatch.setattr(CompiledPlan, "__call__",
                        lambda self, rf, mark=None: step(self, rf, mark,
                                                         real))


def marks(plan, mark):
    for _ in plan.descriptor.stages:
        if mark is not None:
            mark()


@pytest.mark.parametrize("cell", ["tiny_forces.stream",
                                  "tiny_hercules.stream"])
def test_the_control_is_not_correct(tiny_root, monkeypatch, cell):
    """The reference in the program's place, every stage's input and output
    rounded to bfloat16."""
    cfg = Bench(tiny_root).config(cell.split(".")[0])

    def control(plan, rf, mark, real):
        marks(plan, mark)
        return chain.run_stages(cfg, rf, rf.device, "bfloat16")

    broken(monkeypatch, control)
    result, _ = run_tiny(tiny_root, cell)
    assert not result["correct"]
    c = result["compared"]["envelope_nrmse"]
    assert c["value"] > c["limit"]


def stale(plan, rf, mark, real):
    """A step that returns its state unchanged: the first frame, ever."""
    out = real(plan, rf, mark)
    return STALE.setdefault(id(plan), out)


def half_the_channels(plan, rf, mark, real):
    """Half of the channels left out, the rest scaled as their mean."""
    x = rf.to(torch.float32)
    c = x.shape[0]
    x[c // 2:] = 0
    x[:c // 2] *= 2
    return real(plan, x, mark)


def altered(plan, rf, mark, real):
    """An answer altered where it is produced: the brightest voxel."""
    out = real(plan, rf, mark).clone()
    out.view(-1)[out.abs().argmax()] = 0
    return out


def conjugated(plan, rf, mark, real):
    """An I/Q frame's phase turned the wrong way: its envelope holds."""
    return real(plan, rf, mark).conj()


def raises(plan, rf, mark, real):
    """A frame that raises."""
    RAISED.append(1)
    if len(RAISED) == 8:
        raise RuntimeError("a frame failed")
    return real(plan, rf, mark)


STALE: dict = {}
RAISED: list = []


@pytest.mark.parametrize("fault", [stale, half_the_channels, altered,
                                   raises])
@pytest.mark.parametrize("cell", ["tiny_forces.stream", "tiny_forces.live"])
def test_each_fault_is_not_correct(tiny_root, monkeypatch, fault, cell):
    STALE.clear()
    RAISED.clear()
    broken(monkeypatch, fault)
    result, _ = run_tiny(tiny_root, cell)
    assert not result["correct"]
    if fault is raises:
        assert result["failed"] == 1


def test_a_wrong_phase_is_not_correct(tiny_root, monkeypatch):
    """The envelope cannot see it; the complex NRMSE does."""
    broken(monkeypatch, conjugated)
    result, _ = run_tiny(tiny_root, "tiny_forces.stream")
    assert not result["correct"]
    c = result["compared"]
    assert c["envelope_nrmse"]["value"] <= c["envelope_nrmse"]["limit"]
    assert c["complex_nrmse"]["value"] > c["complex_nrmse"]["limit"]


def test_every_frame_of_the_window_is_compared(tiny_root):
    _, _, _, run = harness.run_cell(Bench(tiny_root), "tiny_forces.stream",
                                    2 ** 31 + 9, 1.0, False, "cpu",
                                    time.time())
    assert run.checked == run.window and len(run.window) > len(run.pool)
    assert set(run.readings) == set(run.window)


def test_one_bad_frame_in_a_window_is_not_correct(tiny_root, monkeypatch):
    """A fault in one frame of the window, past the first ring of slots."""
    calls = []

    def one_frame(plan, rf, mark, real):
        calls.append(1)
        out = real(plan, rf, mark)
        return out * 1.01 if len(calls) == 8 else out

    broken(monkeypatch, one_frame)
    result, _ = run_tiny(tiny_root, "tiny_forces.stream", seconds=1.0)
    assert result["attempted"] >= 6 and not result["correct"]
