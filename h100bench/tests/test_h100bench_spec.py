"""BENCHMARK.json against the benchmark's contract, and its files found by
name; a new configuration, traffic mix, generator and metric added as files
and entries alone."""

from __future__ import annotations

import json
import re
import time

import pytest

from h100bench import harness
from h100bench.spec import ROOT, Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    spec = json.loads(raw)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["h100bench"]
    assert 1 <= len(spec["command"]) <= 32
    assert all(line(w) and not w.startswith("/") and ".." not in w
               for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) \
        and 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("h100bench/")
        assert (ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads(
            (ROOT / c["file"]).read_text())["reduced"]
        names.add(c["name"])
    cells = {}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4) and line(w["why"])
        cells[w["name"]] = w
    assert len(cells) == len(spec["workloads"])
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) \
        == len(cells)
    assert {w["config"] for w in cells.values()} == names
    e2e = {}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert e2e["setup_s"]["bound"] == 0.25
    assert "workloads" not in e2e["setup_s"]
    layers = set()
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
        layers.add(m["layer"])
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    bench = Bench()
    for cell in cells:
        reported = [m["name"] for m in bench.metrics(cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert bench.metrics(cell, True)


def test_every_cell_finds_its_files():
    bench = Bench()
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"] and "limits" in cfg
        traffic = bench.traffic(w["traffic"])
        assert callable(bench.generator(traffic["generator"]))
        for traced in (False, True):
            for m in bench.metrics(w["name"], traced):
                assert callable(bench.reader(m["name"]))
    for stage in ("das", "decode", "demod"):
        assert callable(bench.work(stage))


def test_a_new_config_mix_and_metric_are_files_and_entries(tiny_root):
    """A throwaway cell: a configuration, a traffic mix with a generator of
    its own (frames due ever faster, a ramp) and a per-layer metric, each a
    new file, and new entries in BENCHMARK.json; no file there is
    edited."""
    bench_dir = tiny_root / "h100bench"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = json.loads(
        (bench_dir / "configs" / "tiny_hercules.json").read_text())
    cfg["name"] = "tiny_hercules_deep"
    cfg["parameters"]["das_voxel_transform"][2][2] *= 1.5
    (bench_dir / "configs" / "tiny_hercules_deep.json").write_text(
        json.dumps(cfg))
    (bench_dir / "traffic" / "ramp.py").write_text(
        "def due(traffic, k):\n"
        "    return (2 * k / traffic['per_s2']) ** 0.5\n")
    (bench_dir / "traffic" / "pairs.json").write_text(json.dumps(
        {"generator": "ramp", "per_s2": 400.0, "depth": 2,
         "pool_frames": 2, "warmup_frames": 2, "targets": 1,
         "noise_lsb": 10.0}))
    (bench_dir / "metrics" / "frames_checked.py").write_text(
        "def read(run):\n    return float(len(run.checked))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_hercules_deep", "source": "test",
                            "file": "h100bench/configs/"
                                    "tiny_hercules_deep.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny_hercules_deep.pairs",
                              "config": "tiny_hercules_deep",
                              "traffic": "pairs", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tiny_hercules_deep.pairs")
    spec["per_layer"].append({"name": "frames_checked", "unit": "frames",
                              "better": "higher", "source": "host_clock",
                              "layer": "check", "moves": "frames_per_s",
                              "workloads": ["tiny_hercules_deep.pairs"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny_root)
    for traced, want in ((False, {"frames_per_s", "setup_s"}),
                         (True, {"frames_checked"})):
        result, _, _, _ = harness.run_cell(
            bench, "tiny_hercules_deep.pairs", 5, 0.3, traced, "cpu",
            time.time())
        assert result["correct"]
        assert want <= set(result["metrics"])
    _, _, _, run = harness.run_cell(bench, "tiny_hercules_deep.pairs", 5,
                                    0.3, False, "cpu", time.time())
    # frame j of the window is due sqrt(2 j / 400) s after it opens
    assert [run.due[k] - run.t0 for k in run.window[:3]] == \
        pytest.approx([0.0, 0.0707107, 0.1])
    assert result["metrics"]["frames_checked"]["value"] == \
        float(result["attempted"]) > 0
    for p, data in before.items():
        assert p.read_bytes() == data
