"""A configuration's pipeline on one raw frame, stage by stage."""

from __future__ import annotations

import importlib

import numpy as np
import torch

PRECISIONS = ("float32", "bfloat16")


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as float32 (complex64), first rounded to ``precision``."""
    if precision == "float32":
        return x if x.is_complex() else x.to(torch.float32)
    if x.is_complex():
        return torch.complex(_round(x.real, precision),
                             _round(x.imag, precision))
    return x.to(torch.bfloat16).to(torch.float32)


def canonical(raw: np.ndarray, cfg: dict) -> np.ndarray:
    """The (C, A, S) frame of a raw (raw channels, raw samples) int16
    frame: channel ``c`` is raw row ``channel_mapping[c]``."""
    p = cfg["parameters"]
    if cfg["pipeline"]["data_kind"] != "Int16" \
            or p["contrast_mode"] != "NoContrast":
        raise ValueError("the reference reads Int16 frames without a "
                         "contrast mode only")
    c, a, s = (int(p["channel_count"]), int(p["acquisition_count"]),
               int(p["sample_count"]))
    rows = np.asarray(cfg["channel_mapping"][:c], np.int64)
    return raw[rows, :a * s].reshape(c, a, s)


def beamform(cfg: dict, raw: np.ndarray, device,
             precision: str = "float32",
             voxel_block: int = 131072) -> torch.Tensor:
    """The frame the configuration's pipeline makes of ``raw`` (the raw
    scanner layout), on ``device``.  ``precision="bfloat16"`` rounds every
    stage's input and output to bfloat16 (the control)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{PRECISIONS}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(cfg, raw, torch.device(device), precision, voxel_block)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def stage_module(kind: str):
    """The reference's module of a pipeline stage, found by the stage
    kind's name in lower case (``DAS`` -> ``das.py``): ``stage(cfg, st, x,
    voxel_block)`` runs it, and ``passes_on(cfg, st)``, where the module has
    it, says what the next stage receives instead."""
    try:
        module = importlib.import_module(f"{__package__}.{kind.lower()}")
    except ModuleNotFoundError as e:
        raise ValueError(f"stage {kind!r} is not in the reference") from e
    if not hasattr(module, "stage"):
        raise ValueError(f"stage {kind!r} is not in the reference")
    return module


def stages(cfg: dict) -> list[dict]:
    """Each stage of the configuration's pipeline with what it receives:
    its ``kind``, its ``filter`` (the slot's entry, if any), ``samples`` a
    row, rate ``fs``, the ``time_offset`` so far and whether the data is
    I/Q (``iq``)."""
    p = cfg["parameters"]
    slots = {int(f["slot"]): f for f in cfg.get("filters", [])}
    now = dict(fs=float(p["sampling_frequency"]),
               samples=int(p["sample_count"]),
               time_offset=float(p["time_offset"]), iq=False)
    out = []
    for kind, slot in zip(cfg["pipeline"]["shaders"],
                          cfg["pipeline"]["stage_parameters"]):
        stage = dict(now, kind=kind, filter=slots.get(int(slot)))
        module = stage_module(kind)
        if hasattr(module, "passes_on"):
            now = dict(now, **module.passes_on(cfg, stage))
        out.append(stage)
    return out


def _run(cfg, raw, device, precision, voxel_block):
    x = torch.from_numpy(np.ascontiguousarray(canonical(raw, cfg))).to(device)
    return run_stages(cfg, x, device, precision, voxel_block)


def run_stages(cfg: dict, x: torch.Tensor, device, precision: str,
               voxel_block: int = 131072) -> torch.Tensor:
    """The pipeline's stages on the canonical (C, A, S) frame ``x``."""
    for st in stages(cfg):
        x = _round(x, precision)
        x = stage_module(st["kind"]).stage(cfg, st, x, voxel_block)
        x = _round(x, precision)
    return x
