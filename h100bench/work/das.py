"""The delay-and-sum stage's least work, from a configuration's geometry.

Bytes: the stage's input frame (C, A, S) read once and the frame written
once.

Operations: only the (voxel, channel, transmit) triples that contribute,
worked out from the geometry by ``reference/das.py``'s equations: inside
the f-number aperture (FORCES: the receive leg's ``|f# (x - c px) / z| <
1/2``; HERCULES: the 2-D ``d2 < z^2 / (4 f#^2)``) and reading a sample
inside the interpolation's window (a triple outside adds 0, so an
implementation may skip it).  Each counts the float32 operations that no
implementation of the equations avoids, an FMA as two:

- the delay: the kind's ``DELAY_OPS`` (``reference/kinds/<kind>.py``:
  FORCES 1 add, receive plus transmit index, each shared by a whole row or
  column of triples; HERCULES 4, ``d2``, ``z^2 + d2`` and an FMA to scale
  the root and add the transmit index, the root itself not counted);
- the sample's fraction: 1;
- the taps, per real component: linear 3 (a subtract and an FMA), cubic 8
  (four FMAs; the weights of the fraction are not counted);
- I/Q: the rotation by the delay's phase, a complex multiply, 6 (its
  cosine and sine not counted: a phase shared by rows and columns can
  replace them);
- the sum: the kind's ``SUM_OPS`` per component (FORCES 1 add, its
  apodization depending on voxel and channel only and factoring out of the
  transmit sum; HERCULES an FMA, its 2-D apodization being per triple, its
  cosine not counted).

The triples of each kind are counted by its ``triples``.

The peak is float32 on the CUDA cores (67 TFLOP/s): the configurations
state float32, and TF32 and bfloat16 tensor cores are lower precisions.
No correct implementation does less, so no share exceeds 100 %.  At these
shapes the operations set the bound.
"""

from __future__ import annotations

from h100bench import peaks
from h100bench.reference import chain, das

TAPS = {"Linear": 3, "Cubic": 8}
ROTATION = 6
VOXEL_BLOCK = 65536


def ops_per_triple(kind, mode: str, iq: bool) -> int:
    """The operations of a triple of acquisition kind module ``kind``."""
    parts = 2 if iq else 1
    return (kind.DELAY_OPS + 1 + parts * TAPS[mode]
            + (ROTATION if iq else 0) + parts * kind.SUM_OPS)


def triples(cfg: dict, device) -> int:
    """The contributing (voxel, channel, transmit) triples."""
    st = next(s for s in chain.stages(cfg) if s["kind"] == "DAS")
    g = das.Geometry(cfg["parameters"], st["samples"], st["fs"],
                     st["time_offset"], st["iq"], device)
    world = das.world_points(g.voxel_transform, g.shape, g.device)
    return sum(g.kind.triples(g, world[v:v + VOXEL_BLOCK])
               for v in range(0, world.shape[0], VOXEL_BLOCK))


def count(cfg: dict, device) -> dict | None:
    """``{"flops", "bytes", "seconds", "bound", "triples"}`` of the DAS
    stage, or None without one."""
    st = next((s for s in chain.stages(cfg) if s["kind"] == "DAS"), None)
    if st is None:
        return None
    p = cfg["parameters"]
    g = das.Geometry(p, st["samples"], st["fs"], st["time_offset"],
                     st["iq"], device)
    n = triples(cfg, device)
    element = 8 if st["iq"] else 4
    voxels = g.shape[0] * g.shape[1] * g.shape[2]
    nbytes = (g.channels * g.transmits * g.samples + voxels) * element
    flops = n * ops_per_triple(g.kind, g.mode, st["iq"])
    seconds, bound = peaks.bound(nbytes, flops)
    return {"flops": flops, "bytes": nbytes, "seconds": seconds,
            "bound": bound, "triples": n}
