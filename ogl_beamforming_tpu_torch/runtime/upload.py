"""Host-side RF ingest: channel-mapping permutation and contrast reduction.

Mirrors the client library's copy-into-scratch path
(lib/ogl_beamformer_lib.c:492-570): raw scanner data is
``(raw_channels, raw_samples)`` with ``raw_data_dimensions = (x=samples,
y=channels)``; output channel ``c`` takes raw channel
``channel_mapping[c]`` reshaped to ``(acquisitions, samples)``.
"""

from __future__ import annotations

import numpy as np

from ..params.enums import (BeamformerError, ContrastMode, DataKind,
                            ErrorKind)


def prepare_rf(raw: np.ndarray, channel_mapping: np.ndarray,
               channel_count: int, acquisition_count: int, sample_count: int,
               contrast_mode: ContrastMode = ContrastMode.NoContrast,
               data_kind: DataKind = DataKind.Int16) -> np.ndarray:
    """Permute + (optionally) contrast-reduce raw RF into the canonical
    ``(C, A, S_wire)`` layout, where ``S_wire`` counts scalar elements
    (2x sample_count for interleaved complex kinds).

    ``raw``: (raw_channels, raw_samples) scalar array.
    """
    elements = DataKind(data_kind).element_count
    s_wire = sample_count * elements
    per_channel = acquisition_count * s_wire
    mapping = np.asarray(channel_mapping[:channel_count], np.int64)
    if raw.ndim != 2:
        raise BeamformerError(ErrorKind.DataSizeMismatch,
                              f"raw must be 2-D, got shape {raw.shape}")
    if mapping.max(initial=0) >= raw.shape[0]:
        raise BeamformerError(
            ErrorKind.DataSizeMismatch,
            f"channel mapping exceeds raw channel count {raw.shape[0]}")

    if contrast_mode == ContrastMode.A1S2:
        # out[:S] = a - b - c over three ensembles spaced ``sample_count``
        # apart; the remainder of the channel block is zeroed — exactly the
        # reference's reduce (lib/ogl_beamformer_lib.c:478-490,533-560).
        if raw.shape[1] < 3 * s_wire:
            raise BeamformerError(
                ErrorKind.DataSizeMismatch,
                f"A1S2 needs {3 * s_wire} samples/channel, "
                f"raw has {raw.shape[1]}")
        sel = raw[mapping]
        out = np.zeros((channel_count, per_channel), raw.dtype)
        out[:, :s_wire] = (sel[:, 0 * s_wire: 1 * s_wire]
                           - sel[:, 1 * s_wire: 2 * s_wire]
                           - sel[:, 2 * s_wire: 3 * s_wire])
    else:
        if raw.shape[1] < per_channel:
            raise BeamformerError(
                ErrorKind.DataSizeMismatch,
                f"need {per_channel} samples/channel, raw has {raw.shape[1]}")
        out = raw[mapping, :per_channel]
    return np.ascontiguousarray(
        out.reshape(channel_count, acquisition_count, s_wire))
