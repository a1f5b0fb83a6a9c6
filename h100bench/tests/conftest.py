"""A miniature of the benchmark for the CPU: the repository's generator,
metric and work files, two small configurations (``data/``), the cells that
mirror the real ones and a HERCULES cell added as files and entries, under
a root of their own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
CELLS = {"forces128_2d.stream": "tiny_forces.stream",
         "forces128_2d.live": "tiny_forces.live"}
TRAFFIC = {"depth": 3, "pool_frames": 3, "warmup_frames": 3, "targets": 2,
           "noise_lsb": 40.0}


def make_root(root: Path) -> Path:
    """A benchmark root: ``BENCHMARK.json`` with the real metrics over the
    miniature cells, and ``h100bench/`` with the real metric, work and
    generator files, the miniature configurations and small traffic mixes.
    ``tiny_hercules.stream`` reports what the real closed-loop cell does,
    less Demodulate's roofline."""
    bench = root / "h100bench"
    for d in ("metrics", "work"):
        shutil.copytree(REPO / "h100bench" / d, bench / d)
    shutil.copytree(REPO / "h100bench" / "traffic", bench / "traffic",
                    ignore=shutil.ignore_patterns("*.json", "__pycache__"))
    (bench / "configs").mkdir(parents=True)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = []
    for name in ("tiny_forces", "tiny_hercules"):
        shutil.copy(DATA / f"{name}.json", bench / "configs")
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"h100bench/configs/{name}.json",
                                "reduced": [], "why": "test"})
    (bench / "traffic" / "stream.json").write_text(
        json.dumps({"generator": "closed", **TRAFFIC}))
    (bench / "traffic" / "live.json").write_text(
        json.dumps({"generator": "clock", "rate_per_s": 40.0, **TRAFFIC}))
    for w in spec["workloads"]:
        w["name"] = CELLS[w["name"]]
        w["config"] = "tiny_" + w["config"].split("128")[0]
    spec["workloads"].append({"name": "tiny_hercules.stream",
                              "config": "tiny_hercules", "traffic": "stream",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELLS[c] for c in m["workloads"]]
            if "tiny_forces.stream" in m["workloads"] \
                    and m["name"] != "demod_roofline":
                m["workloads"].append("tiny_hercules.stream")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda:0")
