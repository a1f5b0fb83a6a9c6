"""The roofline counts of ``work/`` against geometries small enough to
work out by hand, and against every triple enumerated."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from h100bench import peaks
from h100bench.reference import chain, das, kinds
from h100bench.reference.kinds import hercules
from h100bench.spec import Bench

from .conftest import DATA


def tiny(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def one_voxel(cfg: dict, x: float, z: float) -> dict:
    """``cfg`` with a 1 x 1 grid at the world point (x, 0, z)."""
    p = cfg["parameters"]
    p["output_points"] = [1, 1, 1, 0]
    p["das_voxel_transform"] = [[0, 0, 0, x], [0, 0, 0, 0], [0, 0, 0, z],
                                [0, 0, 0, 1]]
    return cfg


def test_ops_per_triple_from_the_equations():
    from h100bench.work import das as work
    # delay 1 + fraction 1 + 2 x 8 taps + rotation 6 + 2 x 1 sum
    assert work.ops_per_triple(kinds.load("FORCES"), "Cubic", True) == 26
    # delay 4 + fraction 1 + 3 taps + an FMA into the sum
    assert work.ops_per_triple(kinds.load("HERCULES"), "Linear", False) == 10


def test_forces_triples_by_hand():
    """A voxel straight under element 0, so deep that only channel 0 lies
    inside f# 0.5's aperture (|x - c px| < z): each of the A transmits
    reads a sample inside the record."""
    cfg = tiny("tiny_forces")
    p = cfg["parameters"]
    pitch = p["xdc_element_pitch"][0]
    z = 0.9 * pitch / (2 * p["f_number"])
    one_voxel(cfg, 0.0, z)
    work = Bench().work("das")(cfg, "cpu")
    a = p["acquisition_count"]
    assert work["triples"] == 1 * a
    assert work["flops"] == a * 26
    st = chain.stages(cfg)[-1]
    assert work["bytes"] == (p["channel_count"] * a * st["samples"] + 1) * 8


def test_forces_triples_outside_the_record_count_nothing():
    cfg = one_voxel(tiny("tiny_forces"), 0.0, 1.0)      # 1 m deep
    assert Bench().work("das")(cfg, "cpu")["triples"] == 0


def enumerate_triples(cfg: dict) -> int:
    """Every (voxel, channel, transmit) inside the aperture whose sample
    lies inside the interpolation's window, one by one."""
    st = next(s for s in chain.stages(cfg) if s["kind"] == "DAS")
    g = das.Geometry(cfg["parameters"], st["samples"], st["fs"],
                     st["time_offset"], st["iq"], "cpu")
    world = das.world_points(g.voxel_transform, g.shape, "cpu")
    n = 0
    if g.kind is kinds.load("FORCES"):
        lo, hi = (1, g.samples - 3) if g.mode == "Cubic" \
            else (0, g.samples - 2)
        x, y, z = world[:, 0], world[:, 1], world[:, 2]
        px, py = g.pitch
        ty = y - py * (g.channels / 2)
        for t in range(g.transmits):
            dx = x - px * t
            tx = torch.sqrt(ty * ty + z * z + dx * dx) * (g.fs / g.c)
            for c in range(g.channels):
                rx_dx = x - float(c) * px
                inside = torch.abs(g.fnum * rx_dx / z) < 0.5
                k = torch.floor(g.index(torch.sqrt(rx_dx * rx_dx + z * z))
                                + tx)
                n += int((inside & (k >= lo) & (k <= hi)).sum())
        return n
    xdc = das.apply(g.xdc, world)
    z = xdc[:, 2]
    tx_index = g.index(hercules.transmit_distance(g, world))
    limit = 0.25 / (g.fnum / z) ** 2
    for t in range(g.transmits):
        for c in range(g.channels):
            d2 = (xdc[:, 0] - float(c) * g.pitch[0]) ** 2 \
                + (xdc[:, 1] - float(t) * g.pitch[1]) ** 2
            k = torch.floor(tx_index + torch.sqrt(z * z + d2) * g.fs / g.c)
            n += int(((d2 < limit) & (k >= 0) & (k <= g.samples - 2)).sum())
    return n


@pytest.mark.parametrize("name", ["tiny_forces", "tiny_hercules"])
def test_triples_match_every_triple_enumerated(name):
    cfg = tiny(name)
    got = Bench().work("das")(cfg, "cpu")["triples"]
    want = enumerate_triples(cfg)
    assert want > 0
    # the count compares delays with the window's edges, the enumeration
    # floors them: they may part at a triple that lies on an edge
    assert abs(got - want) <= max(2, want // 1000)


def test_decode_and_demodulate_counts_by_hand():
    cfg = tiny("tiny_forces")
    p = cfg["parameters"]
    c, a, s = p["channel_count"], p["acquisition_count"], p["sample_count"]
    taps = cfg["filters"][0]["kaiser"]["length"]
    bench = Bench()
    dec = bench.work("decode")(cfg, "cpu")
    # complex64 (C, A, S / 2) in and out, and the (A, A) float32 matrix
    assert dec["bytes"] == c * a * (s // 2) * 16 + a * a * 4
    assert dec["flops"] == c * (s // 2) * 2 * a * (math.log2(a) + 1)
    dem = bench.work("demod")(cfg, "cpu")
    assert dem["bytes"] == c * a * s * 2 + c * a * (s // 2) * 8 + taps * 4
    assert dem["flops"] == c * a * (s // 2) * (8 + 4 * taps)
    assert bench.work("demod")(tiny("tiny_hercules"), "cpu") is None
    herc = bench.work("decode")(tiny("tiny_hercules"), "cpu")
    hp = tiny("tiny_hercules")["parameters"]
    n = hp["channel_count"] * hp["acquisition_count"] * hp["sample_count"]
    assert herc["bytes"] == n * (2 + 4) + hp["acquisition_count"] ** 2 * 4


def test_bound_takes_the_larger_time():
    assert peaks.bound(peaks.HBM_BYTES_PER_S, 0.0) == (1.0, "bytes")
    assert peaks.bound(0.0, 2 * peaks.FP32_FLOPS) == (2.0, "operations")
    assert np.isclose(peaks.bound(1.0, 1.0, 1.0)[0], 1.0)
