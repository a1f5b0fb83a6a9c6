"""The pipeline's Demodulate stage (``filters.demodulate`` through the
stage's filter), and what it hands on: half the samples at half the rate,
I/Q, and its filter's delay added to the time offset."""

from __future__ import annotations

import torch

from . import filters


def passes_on(cfg: dict, st: dict) -> dict:
    """What the next stage receives, where it differs from this one's."""
    if int(cfg["parameters"]["decimation_rate"]) > 1:
        raise ValueError("the reference demodulates without decimation")
    return {"fs": st["fs"] / 2.0, "samples": st["samples"] // 2, "iq": True,
            "time_offset": st["time_offset"]
            + filters.design(st["filter"])[1]}


def stage(cfg: dict, st: dict, x: torch.Tensor,
          voxel_block: int) -> torch.Tensor:
    taps, _ = filters.design(st["filter"])
    return filters.demodulate(x, taps,
                              cfg["parameters"]["demodulation_frequency"],
                              st["fs"])
