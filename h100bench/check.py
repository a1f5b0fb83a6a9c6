"""The comparison that decides ``correct``.

After the window the plain reference (``reference/chain.py``, float32)
beamforms each raw frame of the pool once, and every frame of the window
that completed is held against the reference of its own raw frame (the
run's frame ``k`` is pool frame ``k mod len(pool)``).  The numbers compared
are those the configuration's ``limits`` name, each the worst over the
window's frames:

- ``envelope_nrmse``: the RMS of ``|frame| - |reference|`` over the RMS of
  ``|reference|``, the envelope a B-mode image shows;
- ``complex_nrmse``: the RMS of ``frame - reference`` over the RMS of
  ``reference``, the values themselves, an I/Q frame's phase with them;

and ``failed_frames``, the window's frames that raised or never completed,
held to 0.  Their readings and limits are in ``PERF.md``.
"""

from __future__ import annotations

import torch

from .reference import chain

FAR = 1e30
"""The reading of a frame of the wrong shape or kind, with a value that is
not finite, or of a window with no frame to compare."""


def envelope_nrmse(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    a, b = out.abs(), ref.abs()
    return (a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()


def complex_nrmse(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (out - ref).abs().pow(2).mean().sqrt() \
        / ref.abs().pow(2).mean().sqrt()


NUMBERS = {"envelope_nrmse": envelope_nrmse, "complex_nrmse": complex_nrmse}


def references(cfg: dict, pool, device,
               precision: str = "float32") -> list[torch.Tensor]:
    """The reference's frame of each raw frame of the pool."""
    return [chain.beamform(cfg, raw, device, precision) for raw in pool]


def readings(cfg: dict, out: torch.Tensor,
             ref: torch.Tensor) -> torch.Tensor:
    """The configuration's compared numbers of one frame, on the
    reference's device (``FAR`` for a frame of the wrong shape or kind, or
    one that is not finite)."""
    names = list(cfg["limits"])
    if out.shape != ref.shape or out.is_complex() != ref.is_complex():
        return torch.full((len(names),), FAR, device=ref.device)
    out = out.to(ref.device)
    values = torch.stack([NUMBERS[n](out, ref) for n in names])
    return torch.where(torch.isfinite(values), values, FAR)


def compare(cfg: dict, outputs, refs, failed: int):
    """The compared numbers of ``outputs`` [(frame index, frame)], each with
    its limit, and each frame's readings {frame index: [number, ...]}."""
    names = list(cfg["limits"])
    per_frame = {}
    for k, out in outputs:
        per_frame[k] = readings(cfg, out, refs[k % len(refs)])
    if per_frame:
        table = torch.stack(list(per_frame.values())).double().cpu()
        worst = table.amax(0).tolist()
        per_frame = dict(zip(per_frame, table.tolist()))
    else:
        worst = [FAR] * len(names)
    compared = {n: {"value": w, "limit": cfg["limits"][n]}
                for n, w in zip(names, worst)}
    compared["failed_frames"] = {"value": failed, "limit": 0}
    return compared, per_frame


def lines(compared: dict) -> list[str]:
    return [f"compared {name}: {v['value']!r} (limit {v['limit']!r})"
            for name, v in compared.items()]
