"""Host-side FIR filter design and windows.

Reference: math.c:713-797 plus the filter factory in beamformer_core.c:211-264.
All design happens on host in NumPy (tiny, not perf critical); the taps are
then uploaded as device arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..params.enums import BeamformerError, ErrorKind, FilterKind
from ..params.types import FilterParameters


def tukey_window(t: np.ndarray | float, tapering: float) -> np.ndarray:
    """Tukey (tapered-cosine) window evaluated at normalized position ``t``
    in [0, 1].  Reference: math.c:739-747."""
    t = np.asarray(t, dtype=np.float32)
    r = tapering
    result = np.ones_like(t)
    lo = t < r / 2
    hi = t >= 1 - r / 2
    result = np.where(lo, 0.5 * (1 + np.cos(2 * np.pi * (t - r / 2) / r)), result)
    result = np.where(hi, 0.5 * (1 + np.cos(2 * np.pi * (t - 1 + r / 2) / r)), result)
    return result.astype(np.float32)


def kaiser_low_pass_filter(cutoff_frequency: float, sampling_frequency: float,
                           beta: float, length: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass FIR (reference: math.c:750-767).

    Matches the reference sample-for-sample, including its slightly
    unconventional center ``a = length / 2`` (not ``(length - 1) / 2``).
    """
    n = np.arange(length, dtype=np.float32)
    wc = np.float32(2 * np.pi * cutoff_frequency / sampling_frequency)
    a = np.float32(length / 2.0)
    t = n - a
    impulse = np.where(t != 0, np.sin(wc * t) / np.where(t != 0, t, 1), wc)
    tn = t / a
    window = np.i0(beta * np.sqrt(np.maximum(1 - tn * tn, 0))) / (np.pi * np.i0(beta))
    return (impulse * window).astype(np.float32)


def rf_chirp(min_frequency: float, max_frequency: float,
             sampling_frequency: float, length: int,
             reverse: bool = False) -> np.ndarray:
    """Real linear chirp with Tukey(0.2) taper (reference: math.c:769-781)."""
    i = np.arange(length, dtype=np.float32)
    fc = min_frequency + i * (max_frequency - min_frequency) / (2 * length)
    arg = 2 * np.pi * fc * i / sampling_frequency
    vals = (np.sin(arg) * tukey_window(i / length, 0.2)).astype(np.float32)
    if reverse:
        vals = vals[::-1].copy()
    return vals


def baseband_chirp(min_frequency: float, max_frequency: float,
                   sampling_frequency: float, length: int,
                   reverse: bool = False, scale: float = 1.0) -> np.ndarray:
    """Complex baseband chirp (reference: math.c:783-797).

    Returns a complex64 array; ``reverse`` conjugates and time-reverses
    (matched-filter form).
    """
    i = np.arange(length, dtype=np.float32)
    fc = min_frequency + i * (max_frequency - min_frequency) / (2 * length)
    arg = 2 * np.pi * fc * i / sampling_frequency
    conjugate = -1.0 if reverse else 1.0
    w = tukey_window(i / length, 0.2)
    vals = (scale * w * (np.cos(arg) + 1j * conjugate * np.sin(arg))).astype(np.complex64)
    if reverse:
        vals = vals[::-1].copy()
    return vals


def filter_first_moment(taps: np.ndarray, sampling_frequency: float) -> float:
    """Energy-weighted first moment (group delay, seconds) of FIR taps.

    Reference: math.c:713-737 (real and complex variants unified — the
    reference's complex path uses |h|^2, which reduces to h^2 for real taps).
    """
    power = np.abs(np.asarray(taps)) ** 2
    n = np.arange(len(taps))
    return float((n * power).sum() / power.sum() / sampling_frequency)


@dataclass
class Filter:
    """A realized filter slot: taps plus the time-delay compensation fed into
    the DAS time offset (reference: beamformer_core.c:211-264)."""

    taps: np.ndarray          # float32 or complex64
    time_delay: float         # seconds
    parameters: FilterParameters

    @property
    def complex(self) -> bool:
        return np.iscomplexobj(self.taps)

    @property
    def length(self) -> int:
        return len(self.taps)


def make_filter(params: FilterParameters) -> Filter:
    """Build filter taps for a slot (reference: beamformer_core.c:211-264).

    * Kaiser: low-pass prototype; complex=True keeps the real taps (they are
      applied to IQ data) — the reference stores Kaiser taps as real either way.
    * MatchedChirp: time-reversed chirp; complex=True uses the conjugated
      baseband chirp with a sqrt(2) scale (demodulated data path), else the
      real RF chirp.

    The returned ``time_delay`` is the negated first moment: it advances the
    DAS time axis to compensate the filter's group delay.
    """
    fs = params.sampling_frequency
    if params.kind == FilterKind.Kaiser:
        k = params.kaiser
        if k.length <= 0:
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  "kaiser filter length must be > 0")
        taps = kaiser_low_pass_filter(k.cutoff_frequency, fs, k.beta, k.length)
        delay = k.length / 2.0 / fs
    elif params.kind == FilterKind.MatchedChirp:
        c = params.matched_chirp
        length = int(c.duration * fs)
        if length <= 0:
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  "matched chirp duration too short")
        if params.complex:
            taps = baseband_chirp(c.min_frequency, c.max_frequency, fs, length,
                                  reverse=True, scale=0.5)
        else:
            taps = rf_chirp(c.min_frequency, c.max_frequency, fs, length,
                            reverse=True)
        delay = filter_first_moment(taps, fs)
    else:
        raise BeamformerError(ErrorKind.InvalidFilterKind, str(params.kind))

    return Filter(taps=taps, time_delay=delay, parameters=params)
