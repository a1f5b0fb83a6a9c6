"""The cells on the card: a short run of each comes out correct, and the
control in the program's place does not.  They skip without a card (the
``card`` fixture); on the card: ``python -m pytest -m cuda
h100bench/tests/test_h100bench_cuda.py``."""

from __future__ import annotations

import time

import pytest

from ogl_beamforming_tpu_torch.pipeline.plan import CompiledPlan

from h100bench import harness
from h100bench.reference import chain
from h100bench.spec import Bench

CELLS = [w["name"] for w in Bench().spec["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    result, _, _, _ = harness.run_cell(Bench(), cell, 2 ** 31 + 77, 2.0,
                                       False, card, time.time())
    assert result["correct"] and result["failed"] == 0
    assert result["device"]["kind"].startswith("NVIDIA")


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["forces128_2d"])
def test_the_control_is_not_correct_at_full_size(card, monkeypatch, config):
    cfg = Bench().config(config)

    def control(plan, rf, mark=None):
        for _ in plan.descriptor.stages:
            if mark is not None:
                mark()
        return chain.run_stages(cfg, rf, rf.device, "bfloat16")

    monkeypatch.setattr(CompiledPlan, "__call__", control)
    result, _, _, _ = harness.run_cell(Bench(), f"{config}.stream",
                                       2 ** 31 + 78, 1.0, False, card,
                                       time.time())
    assert not result["correct"]
