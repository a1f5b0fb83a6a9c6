"""The Hadamard decode stage's least work.

Bytes: the stage's input frame (C, A, S) read once (int16 straight from
the scanner, or complex64 after Demodulate), the decoded frame written once
(float32, or complex64), and the float32 (A, A) matrix.

Operations: a fast Walsh-Hadamard transform of each (channel, sample)
column and component, ``A log2 A`` adds, and the ``1 / A`` scale, one
multiply an output: the least any implementation of the decode computes,
held against float32 on the CUDA cores (67 TFLOP/s).  The bytes set the
bound at these shapes (so a kernel that multiplies by the whole matrix on
tensor cores is held to the same bound).
"""

from __future__ import annotations

import math

from h100bench import peaks
from h100bench.reference import chain


def count(cfg: dict, device) -> dict | None:
    st = next((s for s in chain.stages(cfg) if s["kind"] == "Decode"),
              None)
    if st is None:
        return None
    p = cfg["parameters"]
    c, a, s = int(p["channel_count"]), int(p["acquisition_count"]), \
        st["samples"]
    parts = 2 if st["iq"] else 1
    element_in = 8 if st["iq"] else 2       # complex64 or int16
    element_out = 4 * parts
    nbytes = c * a * s * (element_in + element_out) + a * a * 4
    flops = c * s * parts * a * (math.log2(a) + 1)
    seconds, bound = peaks.bound(nbytes, flops)
    return {"flops": flops, "bytes": nbytes, "seconds": seconds,
            "bound": bound}
