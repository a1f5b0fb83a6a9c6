"""Delay-and-sum (``shaders/das.glsl``), one frame, plain torch in float32:
what every acquisition kind shares.  What is its own (the delays, the
aperture, the sum over a block of voxels) is in ``kinds/<kind>.py``.

Voxel ``(ix, iy, iz)`` of an ``(nx, ny, nz)`` grid lies at the voxel
transform applied to ``(ix / (nx - 1), iy / (ny - 1), iz / (nz - 1), 1)``
(a denominator of at least 1).  A sample index is
``(distance / c + time_offset) fs``; a sample outside the interpolation's
window reads 0; I/Q data is rotated by ``exp(+j 2 pi f_d index / fs)``.
The apodization is ``cos(pi a)^2`` inside the f-number aperture
``a < 1/2`` and 0 outside.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kinds

PI_F32 = float(np.float32(np.pi))
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
DEG_F32 = float(np.float32(np.pi / 180))


def grid_shape(points) -> tuple[int, int, int]:
    """The (nx, ny, nz) of a configuration's ``output_points``, which must
    already be the upstream's canonical form (a 2-D grid on x and y)."""
    p = tuple(max(int(v), 1) for v in points[:3])
    if p[2] > 1 and p[1] == 1 or p[1] > 1 and p[0] == 1:
        raise ValueError(f"output points {p} are not canonical")
    return p


def world_points(transform: np.ndarray, shape, device) -> torch.Tensor:
    """(V, 3) float32 voxel positions, voxels in C order over the grid."""
    m = torch.from_numpy(np.asarray(transform, np.float32)).to(device)
    axes = [torch.arange(n, dtype=torch.float32, device=device)
            / float(max(n - 1, 1)) for n in shape]
    u = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return apply(m, u)


def apply(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``m`` (4, 4) applied to points (V, 3), term by term left to right."""
    return torch.stack([m[i, 0] * pts[:, 0] + m[i, 1] * pts[:, 1]
                        + m[i, 2] * pts[:, 2] + m[i, 3] for i in range(3)],
                       dim=-1)


def interpolate(lines: torch.Tensor, index: torch.Tensor,
                mode: str) -> torch.Tensor:
    """``lines`` (N, S) read at fractional ``index`` (N, V): ``Linear`` or
    ``Cubic`` (Catmull-Rom); 0 outside the window."""
    s = lines.shape[-1]
    k = torch.floor(index)
    t = index - k

    def at(i):
        return torch.gather(lines, 1, i)

    if mode == "Linear":
        valid = (k >= 0) & (k < s - 1)
        kk = torch.where(valid, k, 0.0).long()
        return torch.where(valid, (1 - t) * at(kk) + t * at(kk + 1), 0)
    if mode != "Cubic":
        raise ValueError(f"interpolation {mode!r} is not in the reference")
    valid = (k > 0) & (k < s - 2)
    kk = torch.where(valid, k, 1.0).long()
    p0, p1, p2, p3 = at(kk - 1), at(kk), at(kk + 1), at(kk + 2)
    m1 = 0.5 * (p2 - p0)
    m2 = 0.5 * (p3 - p1)
    tt = t * t
    ttt = tt * t
    val = ((2 * ttt - 3 * tt + 1) * p1 + (-2 * ttt + 3 * tt) * p2
           + (ttt - 2 * tt + t) * m1 + (ttt - tt) * m2)
    return torch.where(valid, val, 0)


class Geometry:
    """The DAS stage's scalars and tables of one configuration, as float32
    values: worked out from its parameters and the stage's rate."""

    def __init__(self, p: dict, sample_count: int, fs: float,
                 time_offset: float, iq: bool, device):
        self.p = p
        self.kind = kinds.load(p["acquisition_kind"])
        self.iq = iq
        self.mode = p["interpolation_mode"]
        self.channels = int(p["channel_count"])
        self.transmits = int(p["acquisition_count"])
        self.samples = int(sample_count)
        self.shape = grid_shape(p["output_points"])
        self.device = device

        def f32(v):
            return torch.tensor(np.float32(v), device=device)

        self.fs = f32(fs)
        self.fd = f32(p["demodulation_frequency"])
        self.c = f32(p["speed_of_sound"])
        self.t0 = f32(time_offset)
        self.fnum = f32(p["f_number"])
        self.pitch = torch.tensor(np.asarray(p["xdc_element_pitch"],
                                             np.float32), device=device)
        xdc = np.asarray(p["xdc_transform"], np.float32)
        vt = np.asarray(p["das_voxel_transform"], np.float32)
        if self.kind.TRANSDUCER_FRAME:
            vt = xdc @ vt
        self.voxel_transform = vt
        self.xdc = torch.from_numpy(xdc).to(device)
        fv = [float(v) for v in p["focal_vector"]]
        self.angle, self.depth = fv[0], fv[1]
        self.orientation = int(p["transmit_receive_orientation"])

    def index(self, distance: torch.Tensor) -> torch.Tensor:
        return (distance / self.c + self.t0) * self.fs

    def sample(self, lines, index):
        val = interpolate(lines, index, self.mode)
        if self.iq:
            arg = (TWO_PI_F32 * self.fd) * (index / self.fs)
            val = val * torch.complex(torch.cos(arg), torch.sin(arg))
        return val


def apodize(a: torch.Tensor) -> torch.Tensor:
    w = torch.cos(PI_F32 * a)
    return w * w


def das(g: Geometry, rf: torch.Tensor, voxel_block: int = 131072):
    """DAS of ``rf`` (C, A, S) onto the configuration's grid, ``voxel_block``
    voxels at a time."""
    world = world_points(g.voxel_transform, g.shape, g.device)
    parts = [g.kind.das_block(g, rf, world[v:v + voxel_block])
             for v in range(0, world.shape[0], voxel_block)]
    return torch.cat(parts).reshape(g.shape)


def stage(cfg: dict, st: dict, x: torch.Tensor,
          voxel_block: int) -> torch.Tensor:
    """The pipeline's DAS stage (``chain.run_stages``)."""
    g = Geometry(cfg["parameters"], st["samples"], st["fs"],
                 st["time_offset"], st["iq"], x.device)
    return das(g, x.contiguous(), voxel_block)
