"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, ``h100bench/traffic/<mix>.json``,
which names its generator, ``h100bench/traffic/<generator>.py``.  Every
metric ``<name>`` is read by ``h100bench/metrics/<name>.py``, and a
stage's operations and bytes are counted by ``h100bench/work/<stage>.py``.
A later cell, mix or metric is new files and a new entry: nothing here
changes.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "h100bench"


class Bench:
    """The benchmark under ``root``: ``root/BENCHMARK.json`` and
    ``root/h100bench/{traffic,metrics,work}``."""

    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.root / PACKAGE / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's metrics: its end-to-end ones untraced, its per-layer
        ones traced.  An entry without ``workloads`` belongs to every cell
        that reports its end-to-end metric (``moves``)."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not traced:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def generator(self, name: str):
        """The ``due(traffic, k)`` of ``h100bench/traffic/<name>.py``."""
        return _load(self.root / PACKAGE / "traffic" / f"{name}.py").due

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``h100bench/metrics/<metric>.py``."""
        return _load(self.root / PACKAGE / "metrics" / f"{metric}.py").read

    def work(self, stage: str):
        """The ``count(cfg, device)`` of ``h100bench/work/<stage>.py``."""
        return _load(self.root / PACKAGE / "work" / f"{stage}.py").count


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    """A module of its own from a file (a metric's name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}._files.{path.parent.name}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
