"""Demodulation of real RF to baseband I/Q and the FIR that follows it.

The upstream's Demodulate stage (``shaders/demod.glsl``): the sample pairs
``(RF[2n], RF[2n + 1])`` become ``RF[2n] - j RF[2n + 1]`` at the pair rate
fs / 2, are rotated by ``exp(-j 2 pi f_d n / (fs / 2))`` and scaled by
sqrt(2) (1 for a complex filter), then filtered:
``y[n] = sum_j h[j] x[n - L + 1 + j]`` with zeros before the record.  The
Kaiser low-pass taps follow ``math.c``'s design, whose centre is
``L / 2``; the filter delays the signal by ``L / 2`` pair samples, which
the delay-and-sum takes off its time axis.
"""

from __future__ import annotations

import numpy as np
import torch

TWO_PI_F32 = float(np.float32(2.0 * np.pi))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def kaiser_low_pass(cutoff: float, fs: float, beta: float,
                    length: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass taps (``math.c``'s design, centre
    ``length / 2``), float32."""
    n = np.arange(length, dtype=np.float32)
    wc = np.float32(2 * np.pi * cutoff / fs)
    a = np.float32(length / 2.0)
    t = n - a
    impulse = np.where(t != 0, np.sin(wc * t) / np.where(t != 0, t, 1), wc)
    tn = t / a
    window = (np.i0(beta * np.sqrt(np.maximum(1 - tn * tn, 0)))
              / (np.pi * np.i0(beta)))
    return (impulse * window).astype(np.float32)


def design(filt: dict) -> tuple[np.ndarray, float]:
    """The taps and the delay in seconds of a configuration's filter
    entry (a Kaiser low-pass; other kinds raise)."""
    if filt["kind"] != "Kaiser":
        raise ValueError(f"the reference designs Kaiser filters only, "
                         f"not {filt['kind']!r}")
    k = filt["kaiser"]
    fs = float(filt["sampling_frequency"])
    taps = kaiser_low_pass(float(k["cutoff_frequency"]), fs,
                           float(k["beta"]), int(k["length"]))
    return taps, int(k["length"]) / 2.0 / fs


def fir(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Causal FIR of real taps along the last axis of complex ``x``: tap by
    tap, each product added in tap order."""
    length = taps.shape[0]
    s = x.shape[-1]
    xp = torch.nn.functional.pad(torch.view_as_real(x).transpose(-1, -2),
                                 (length - 1, 0))
    acc = None
    for j in range(length):
        term = taps[j] * xp[..., j:j + s]
        acc = term if acc is None else acc + term
    return torch.view_as_complex(acc.transpose(-1, -2).contiguous())


def demodulate(rf: torch.Tensor, taps: np.ndarray, fd: float,
               fs: float) -> torch.Tensor:
    """Real ``rf`` (..., S) -> complex64 (..., S // 2) baseband at fs / 2
    through the real low-pass ``taps``."""
    pairs = rf.shape[-1] // 2
    x = rf[..., :2 * pairs].to(torch.float32)
    i, q = x[..., 0::2], x[..., 1::2]
    omega = ((np.float32(TWO_PI_F32) * np.float32(fd))
             / (np.float32(fs) / np.float32(2)))
    arg = float(omega) * torch.arange(pairs, dtype=torch.float32,
                                      device=rf.device)
    c, s = torch.cos(arg), torch.sin(arg)
    re = SQRT2_F32 * (i * c - q * s)
    im = SQRT2_F32 * (-q * c - i * s)
    h = torch.from_numpy(taps).to(rf.device)
    return fir(torch.complex(re, im), h)
