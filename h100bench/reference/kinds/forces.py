"""FORCES (``shaders/das.glsl``): transmit ``t`` fires element ``t`` at
``x = t px``; elements receive at ``x = c px``, ``y = 0``; the transmit leg
runs from ``y = py C / 2``.  Receive index ``|r_c - v|``, transmit index
``sqrt((y - py C / 2)^2 + z^2 + (x - t px)^2)``, the aperture on the
receive leg, ``a = |f# (x - c px) / z|``.  The voxel transform is taken
into the transducer's frame first."""

from __future__ import annotations

import torch

from h100bench.reference import das

TRANSDUCER_FRAME = True
DELAY_OPS = 1
"""The delay: receive plus transmit index, each shared by a whole row or
column of triples."""
SUM_OPS = 1
"""An add per component: the apodization depends on voxel and channel
only and factors out of the transmit sum."""


def echo_paths(p: dict, target) -> torch.Tensor:
    """(C, A) path lengths of a point target (copied from
    ``chip_smoke.zbp_acquisition``)."""
    x, y, z = target
    c = int(p["channel_count"])
    pitch = float(p["xdc_element_pitch"][0])
    xe = torch.arange(c, dtype=torch.float64, device=x.device) * pitch
    rx = torch.sqrt((x - xe) ** 2 + z ** 2)
    a = torch.arange(int(p["acquisition_count"]), dtype=torch.float64,
                     device=x.device) * pitch
    tx = torch.sqrt((y - pitch * c / 2) ** 2 + z ** 2 + (x - a) ** 2)
    return rx[:, None] + tx[None, :]


def das_block(g, rf: torch.Tensor, world: torch.Tensor) -> torch.Tensor:
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    z2 = z * z
    px, py = g.pitch[0], g.pitch[1]
    ty = y - py * (g.channels / 2)
    t_yz2 = ty * ty + z2
    tx = px * torch.arange(g.transmits, dtype=torch.float32,
                           device=g.device)
    tx_dx = x[None, :] - tx[:, None]
    tx_index = torch.sqrt(t_yz2[None, :] + tx_dx * tx_dx) * (g.fs / g.c)
    out = torch.zeros(world.shape[0], device=g.device,
                      dtype=torch.complex64 if g.iq else torch.float32)
    for c in range(rf.shape[0]):
        rx_dx = x - float(c) * px
        a = torch.abs(g.fnum * rx_dx / z)
        inside = a < 0.5
        apod = das.apodize(torch.where(inside, a, 0.0))
        rx_index = g.index(torch.sqrt(rx_dx * rx_dx + z2))
        vals = g.sample(rf[c], rx_index[None, :] + tx_index)
        vals = torch.where(inside[None, :], apod[None, :] * vals, 0)
        out = out + vals.sum(dim=0)
    return out


def triples(g, world: torch.Tensor) -> int:
    """Triples inside the receive aperture whose sample lies inside the
    interpolation's window: for each (voxel, channel), the transmits whose
    index falls in the window, by a search over the sorted transmit
    indices."""
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    px, py = g.pitch[0], g.pitch[1]
    ty = y - py * (g.channels / 2)
    t = px * torch.arange(g.transmits, dtype=torch.float32, device=g.device)
    tx_dx = x[:, None] - t[None, :]
    tx = torch.sqrt((ty * ty + z * z)[:, None] + tx_dx * tx_dx) \
        * (g.fs / g.c)
    tx, _ = torch.sort(tx.contiguous(), dim=1)
    ch = px * torch.arange(g.channels, dtype=torch.float32, device=g.device)
    rx_dx = x[:, None] - ch[None, :]
    inside = torch.abs(g.fnum * rx_dx / z[:, None]) < 0.5
    rx = g.index(torch.sqrt(rx_dx * rx_dx + (z * z)[:, None]))
    if g.mode == "Cubic":       # sample k with 0 < k < S - 2
        lo, hi = 1.0 - rx, (g.samples - 2) - rx
    else:                       # 0 <= k < S - 1
        lo, hi = -rx, (g.samples - 1) - rx
    n = (torch.searchsorted(tx, hi.contiguous())
         - torch.searchsorted(tx, lo.contiguous()))
    return int((n * inside).sum())
