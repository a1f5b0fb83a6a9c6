"""HERCULES (``shaders/das.glsl``), a row-column array; acquisition 0's
orientation packs the transmit orientation in its high nibble and the
receive one in its low nibble: a plane or cylindrical transmit from the
rows, the receive leg ``sqrt(z^2 + d2)`` with ``d2`` the squared lateral
distance to column ``c`` and row ``t``, a 2-D aperture
``a = |f# / z| sqrt(d2)``; transmit 0 of a dense frame weighs
``1 / sqrt(A)``."""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference import das

TRANSDUCER_FRAME = False
ROWS, COLUMNS = 1, 2          # the RCA orientations of the upstream
DELAY_OPS = 4
"""``d2``, ``z^2 + d2``, and an FMA to scale the root and add the transmit
index (the root itself is not counted)."""
SUM_OPS = 2
"""An FMA per component: the 2-D apodization is per triple (its cosine
is not counted)."""


def echo_paths(p: dict, target) -> torch.Tensor:
    """(C, A) path lengths of a point target: acquisition 0's plane wave
    from the rows, then ``sqrt(z^2 + d2)`` to column ``c`` at ``x = c p``
    and row ``j`` at ``y = j p`` (copied from
    ``chip_smoke.synthesize_hercules_frame``)."""
    x, y, z = target
    pitch = float(p["xdc_element_pitch"][0])
    angle = np.radians(float(p["focal_vector"][0]))
    tx = y * np.sin(angle) + z * np.cos(angle)
    cols = torch.arange(int(p["channel_count"]), dtype=torch.float64,
                        device=x.device) * pitch
    rows = torch.arange(int(p["acquisition_count"]), dtype=torch.float64,
                        device=x.device) * pitch
    d2 = ((x - cols) ** 2)[:, None] + ((y - rows) ** 2)[None, :]
    return tx + torch.sqrt(z * z + d2)


def transmit_distance(g, world: torch.Tensor) -> torch.Tensor:
    """Acquisition 0's plane (infinite depth) or cylindrical transmit."""
    tx_o = (g.orientation >> 4) & 0xF
    lat = world[:, 1] if tx_o == ROWS else world[:, 0]
    z = world[:, 2]
    angle = torch.tensor(np.float32(g.angle), device=g.device) * das.DEG_F32
    sin_a, cos_a = torch.sin(angle), torch.cos(angle)
    if tx_o == 0:
        return torch.zeros_like(z)
    if np.isinf(g.depth):
        return lat * sin_a + z * cos_a
    depth = torch.tensor(np.float32(g.depth), device=g.device)
    d_lat = lat - depth * sin_a
    d_z = z - depth * cos_a
    return torch.sqrt(d_lat * d_lat + d_z * d_z)


def das_block(g, rf: torch.Tensor, world: torch.Tensor) -> torch.Tensor:
    xdc = das.apply(g.xdc, world)
    rx_cols = (g.orientation & 0xF) == COLUMNS
    tx_index = g.index(transmit_distance(g, world))
    z = xdc[:, 2]
    z2 = z * z
    fnum_over_z = torch.abs(g.fnum / z)
    limit = 0.25 / (fnum_over_z * fnum_over_z)
    rx_lat = xdc[:, 0] if rx_cols else xdc[:, 1]
    rx_pitch = g.pitch[0] if rx_cols else g.pitch[1]
    tx_pitch = g.pitch[1] if rx_cols else g.pitch[0]
    tx = torch.arange(g.transmits, dtype=torch.float32,
                      device=g.device) * tx_pitch
    weight = torch.ones(g.transmits, dtype=torch.float32, device=g.device)
    weight[0] = float(np.float32(1.0 / np.sqrt(g.transmits)))
    tx_dd = (xdc[:, 1] if rx_cols else xdc[:, 0])[None, :] - tx[:, None]
    tx_d2 = tx_dd * tx_dd
    fs_over_c = g.fs / g.c
    out = torch.zeros(world.shape[0], device=g.device,
                      dtype=torch.complex64 if g.iq else torch.float32)
    for c in range(rf.shape[0]):
        rx_dd = rx_lat - float(c) * rx_pitch
        d2 = (rx_dd * rx_dd)[None, :] + tx_d2
        inside = d2 < limit[None, :]
        apod = weight[:, None] * das.apodize(
            torch.where(inside, fnum_over_z[None, :] * torch.sqrt(d2), 0.0))
        index = tx_index[None, :] + torch.sqrt(z2[None, :] + d2) * fs_over_c
        vals = g.sample(rf[c], index)
        out = out + torch.where(inside, apod * vals, 0).sum(dim=0)
    return out


def triples(g, world: torch.Tensor) -> int:
    """Triples inside the 2-D aperture whose sample lies inside the linear
    window: for each (voxel, column), the rows whose ``d2`` stays under
    both the aperture's and the record's bound, by a search over the
    sorted row terms."""
    if g.mode != "Linear" or (g.orientation & 0xF) != COLUMNS:
        raise ValueError("counted for linear HERCULES receiving on columns")
    xdc = das.apply(g.xdc, world)
    z = xdc[:, 2]
    tx_index = g.index(transmit_distance(g, world))
    aperture = 0.25 / (g.fnum / z) ** 2
    # index = tx_index + sqrt(z^2 + d2) fs / c < S - 1
    room = torch.clamp((g.samples - 1) - tx_index, min=0) * (g.c / g.fs)
    bound = torch.minimum(aperture, room * room - z * z)
    rows = g.pitch[1] * torch.arange(g.transmits, dtype=torch.float32,
                                     device=g.device)
    tx_d2 = (xdc[:, 1:2] - rows[None, :]) ** 2
    tx_d2, _ = torch.sort(tx_d2.contiguous(), dim=1)
    cols = g.pitch[0] * torch.arange(g.channels, dtype=torch.float32,
                                     device=g.device)
    rx_d2 = (xdc[:, 0:1] - cols[None, :]) ** 2
    n = torch.searchsorted(tx_d2, (bound[:, None] - rx_d2).contiguous())
    return int(n.sum())
