"""RF ingest: channel-mapping permutation and contrast reduction, on the host
(:func:`prepare_rf`) or on the device (:func:`prepare_rf_device`, for the
streaming session's uploaded raw frames).

Mirrors the client library's copy-into-scratch path
(lib/ogl_beamformer_lib.c:492-570): raw scanner data is
``(raw_channels, raw_samples)`` with ``raw_data_dimensions = (x=samples,
y=channels)``; output channel ``c`` takes raw channel
``channel_mapping[c]`` reshaped to ``(acquisitions, samples)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params.enums import (BeamformerError, ContrastMode, DataKind,
                            ErrorKind)


def raw_columns(raw_shape: tuple, channel_mapping: np.ndarray,
                channel_count: int, acquisition_count: int,
                sample_count: int,
                contrast_mode: ContrastMode = ContrastMode.NoContrast,
                data_kind: DataKind = DataKind.Int16) -> int:
    """Check a raw frame's shape ``(raw_channels, raw_samples)`` against a
    parameter block, raising :class:`BeamformerError` as :func:`prepare_rf`
    does, and return how many leading raw columns the canonical frame reads:
    ``3 S_wire`` under A1S2, else ``A S_wire``."""
    s_wire = sample_count * DataKind(data_kind).element_count
    mapping = np.asarray(channel_mapping[:channel_count], np.int64)
    if len(raw_shape) != 2:
        raise BeamformerError(ErrorKind.DataSizeMismatch,
                              f"raw must be 2-D, got shape {raw_shape}")
    if mapping.max(initial=0) >= raw_shape[0]:
        raise BeamformerError(
            ErrorKind.DataSizeMismatch,
            f"channel mapping exceeds raw channel count {raw_shape[0]}")
    if contrast_mode == ContrastMode.A1S2:
        if raw_shape[1] < 3 * s_wire:
            raise BeamformerError(
                ErrorKind.DataSizeMismatch,
                f"A1S2 needs {3 * s_wire} samples/channel, "
                f"raw has {raw_shape[1]}")
        return 3 * s_wire
    per_channel = acquisition_count * s_wire
    if raw_shape[1] < per_channel:
        raise BeamformerError(
            ErrorKind.DataSizeMismatch,
            f"need {per_channel} samples/channel, raw has {raw_shape[1]}")
    return per_channel


def prepare_rf(raw: np.ndarray, channel_mapping: np.ndarray,
               channel_count: int, acquisition_count: int, sample_count: int,
               contrast_mode: ContrastMode = ContrastMode.NoContrast,
               data_kind: DataKind = DataKind.Int16) -> np.ndarray:
    """Permute + (optionally) contrast-reduce raw RF into the canonical
    ``(C, A, S_wire)`` layout, where ``S_wire`` counts scalar elements
    (2x sample_count for interleaved complex kinds).

    ``raw``: (raw_channels, raw_samples) scalar array.
    """
    s_wire = sample_count * DataKind(data_kind).element_count
    per_channel = acquisition_count * s_wire
    mapping = np.asarray(channel_mapping[:channel_count], np.int64)
    raw_columns(raw.shape, mapping, channel_count, acquisition_count,
                sample_count, contrast_mode, data_kind)

    if contrast_mode == ContrastMode.A1S2:
        # out[:S] = a - b - c over three ensembles spaced ``sample_count``
        # apart; the remainder of the channel block is zeroed — exactly the
        # reference's reduce (lib/ogl_beamformer_lib.c:478-490,533-560).
        sel = raw[mapping]
        out = np.zeros((channel_count, per_channel), raw.dtype)
        out[:, :s_wire] = (sel[:, 0 * s_wire: 1 * s_wire]
                           - sel[:, 1 * s_wire: 2 * s_wire]
                           - sel[:, 2 * s_wire: 3 * s_wire])
    else:
        out = raw[mapping, :per_channel]
    return np.ascontiguousarray(
        out.reshape(channel_count, acquisition_count, s_wire))


def mapping_rows(channel_mapping: np.ndarray, channel_count: int,
                 raw_channels: int) -> np.ndarray:
    """The raw row each output channel reads, as int64 in
    ``[0, raw_channels)``: a negative entry counts from the end and one out
    of range raises ``IndexError``, as numpy's indexing in
    :func:`prepare_rf` does."""
    return np.arange(raw_channels)[
        np.asarray(channel_mapping[:channel_count], np.int64)]


def prepare_rf_device(raw: torch.Tensor, rows: torch.Tensor,
                      channel_count: int, acquisition_count: int,
                      sample_count: int,
                      contrast_mode: ContrastMode = ContrastMode.NoContrast,
                      data_kind: DataKind = DataKind.Int16) -> torch.Tensor:
    """:func:`prepare_rf` of a raw frame already on its device: bit for bit
    the same ``(C, A, S_wire)`` tensor, in ``raw``'s dtype (int16 wraps and
    float16 rounds after each subtraction, as numpy's do).

    ``raw``: (raw_channels, at least :func:`raw_columns`) on the device,
    its shape already checked by :func:`raw_columns`; ``rows``: the
    :func:`mapping_rows` of the block as an int64 tensor on that device."""
    s_wire = sample_count * DataKind(data_kind).element_count
    per_channel = acquisition_count * s_wire
    if contrast_mode == ContrastMode.A1S2:
        sel = raw[:, :3 * s_wire].index_select(0, rows)
        out = torch.zeros((channel_count, per_channel), dtype=raw.dtype,
                          device=raw.device)
        out[:, :s_wire] = (sel[:, 0 * s_wire: 1 * s_wire]
                           - sel[:, 1 * s_wire: 2 * s_wire]
                           - sel[:, 2 * s_wire: 3 * s_wire])
    else:
        out = raw[:, :per_channel].index_select(0, rows)
    return out.view(channel_count, acquisition_count, s_wire)
