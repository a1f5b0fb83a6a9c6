"""Raw frames made from the seed: point targets and noise, as the scanner
records them.

Each frame of a pool holds ``targets`` point scatterers at seeded places in
the configuration's imaging region (no deeper than the record reaches) with
seeded amplitudes.  A target's echo on (channel, transmit) is a Gaussian
cosine burst on the configuration's carrier, delayed by the path of the
configuration's geometry; the echoes are Hadamard-encoded across transmits,
scaled to a peak of 30000, given Gaussian noise of ``noise_lsb`` and cut to
int16, and the rows are put in the scanner's order through the channel
mapping.  The frames are drawn on ``device`` with a ``torch.Generator`` and
handed to the program and the reference alike as host arrays.

The burst, the encoding and each acquisition kind's echo paths
(``reference/kinds/<kind>.py``) are frozen copies of the smoke run's
generators (``chip_smoke.py``: ``sine_burst``, ``zbp_echoes``,
``zbp_acquisition``, ``synthesize_hercules_frame``), taken on the device
and given a carrier, targets and noise of their own.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import kinds
from .reference.decode import hadamard

PEAK = 30000.0
REACH = 0.45
"""Targets lie no deeper than this share of the record's round trip."""


def sine_burst(u: torch.Tensor, f0: float) -> torch.Tensor:
    """A Gaussian-enveloped cosine burst on carrier ``f0`` at times ``u``
    (copied from ``chip_smoke.sine_burst``)."""
    env = torch.exp(-0.5 * (u / (2 / f0 / 4)) ** 2)
    return env * torch.cos(2 * np.pi * f0 * u)


def region(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """The corners (low, high) of the imaging region in world space (a grid
    axis of one voxel stays at its origin), the depth cut where the
    record's round trip ends."""
    m = np.asarray(p["das_voxel_transform"], np.float64)
    ends = [(0, 1) if int(n) > 1 else (0,) for n in p["output_points"][:3]]
    corners = np.array([[i, j, k, 1.0] for i in ends[0] for j in ends[1]
                        for k in ends[2]]) @ m.T
    lo, hi = corners[:, :3].min(0), corners[:, :3].max(0)
    reach = (REACH * int(p["sample_count"]) / float(p["sampling_frequency"])
             * float(p["speed_of_sound"]))
    hi[2] = min(hi[2], reach)
    return lo, hi


def frame(cfg: dict, gen: torch.Generator, targets: int,
          noise_lsb: float) -> np.ndarray:
    """One raw frame (raw channels, A S) int16 in the scanner's row order."""
    p = cfg["parameters"]
    dev = gen.device
    c, a, s = (int(p["channel_count"]), int(p["acquisition_count"]),
               int(p["sample_count"]))
    f0 = float(cfg["echo"]["carrier_frequency"])
    kind = kinds.load(p["acquisition_kind"])
    lo, hi = (torch.from_numpy(v).to(dev) for v in region(p))
    t = torch.arange(s, device=dev, dtype=torch.float64) / float(
        p["sampling_frequency"])
    echo = torch.zeros((c, a, s), dtype=torch.float32, device=dev)
    for _ in range(targets):
        u = torch.rand(4, generator=gen, device=dev, dtype=torch.float64)
        where = lo + (hi - lo) * (0.1 + 0.8 * u[:3])
        amplitude = 0.25 + 0.75 * u[3]
        dist = kind.echo_paths(p, where)
        delay = dist / float(p["speed_of_sound"])
        when = (t[None, None, :] - delay[:, :, None]).to(torch.float32)
        echo += amplitude.to(torch.float32) * sine_burst(when, f0)
    h = torch.from_numpy(hadamard(a)).to(dev)
    encoded = torch.matmul(h.T, echo)
    encoded *= PEAK / encoded.abs().max()
    encoded += noise_lsb * torch.randn(encoded.shape, generator=gen,
                                       device=dev)
    rows = torch.round(encoded).clamp(-32768, 32767).to(torch.int16)
    canonical = rows.reshape(c, a * s).cpu().numpy()
    raw = np.empty_like(canonical)
    raw[np.asarray(cfg["channel_mapping"][:c], np.int64)] = canonical
    return raw


def pool(cfg: dict, traffic: dict, seed: int, device) -> list[np.ndarray]:
    """``traffic["pool_frames"]`` distinct raw frames made from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return [frame(cfg, gen, int(traffic["targets"]),
                  float(traffic["noise_lsb"]))
            for _ in range(int(traffic["pool_frames"]))]
