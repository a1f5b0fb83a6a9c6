"""The Demodulate stage's least work.

Bytes: the raw int16 frame (C, A, S) read once, the complex64 baseband
frame (C, A, S / 2) written once, and the filter's float32 taps.

Operations, per output sample: the pair's rotation, ``i cos - q sin`` and
``-q cos - i sin`` scaled by sqrt(2), 8 (its cosine and sine depend on the
pair index alone and are not counted), and the FIR, ``L`` multiply-adds
per component, ``4 L``; held against float32 on the CUDA cores (67
TFLOP/s).  The bytes set the bound at these shapes.
"""

from __future__ import annotations

from h100bench import peaks
from h100bench.reference import chain, filters

ROTATION = 8


def count(cfg: dict, device) -> dict | None:
    st = next((s for s in chain.stages(cfg) if s["kind"] == "Demodulate"),
              None)
    if st is None:
        return None
    p = cfg["parameters"]
    rows = int(p["channel_count"]) * int(p["acquisition_count"])
    taps = len(filters.design(st["filter"])[0])
    outputs = rows * (st["samples"] // 2)
    nbytes = rows * st["samples"] * 2 + outputs * 8 + taps * 4
    flops = outputs * (ROTATION + 4 * taps)
    seconds, bound = peaks.bound(nbytes, flops)
    return {"flops": flops, "bytes": nbytes, "seconds": seconds,
            "bound": bound}
