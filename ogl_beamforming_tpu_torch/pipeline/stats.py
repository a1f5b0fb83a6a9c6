"""Compute timing statistics table.

Mirrors the reference's exported stats ABI
(beamformer_compute_stats.c:3-10): per-stage times over a rolling 32-frame
window plus RF inter-arrival deltas, coalesced the same way as
beamformer_core.c:1655-1719.

On TPU a fused pipeline executes as one XLA program, so per-stage GPU
timestamps have no direct analogue; the executor records whole-pipeline
device time per frame by default and optionally per-stage times when run in
``profile`` mode (stages dispatched as separate programs).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..params.constants import STATS_FRAME_WINDOW, STATS_MAX_STAGES
from ..params.enums import ShaderKind


@dataclass
class ComputeStatsTable:
    """Binary-compatible contents of BeamformerComputeStatsTable."""

    shader_ids: np.ndarray = field(
        default_factory=lambda: np.full(STATS_MAX_STAGES, -1, np.int32))
    times: np.ndarray = field(
        default_factory=lambda: np.zeros(
            (STATS_FRAME_WINDOW, STATS_MAX_STAGES), np.float32))
    rf_time_deltas: np.ndarray = field(
        default_factory=lambda: np.zeros(STATS_FRAME_WINDOW, np.float32))


class ComputeStats:
    """Rolling stats collector (reference: beamformer_core.c:1655-1719)."""

    def __init__(self):
        self.table = ComputeStatsTable()
        self._frame_index = 0
        self._rf_index = 0
        self._last_rf_time: float | None = None

    def set_stages(self, kinds: list[ShaderKind]):
        ids = np.full(STATS_MAX_STAGES, -1, np.int32)
        for i, k in enumerate(kinds[:STATS_MAX_STAGES]):
            ids[i] = int(k)
        if not np.array_equal(ids, self.table.shader_ids):
            self.table.shader_ids = ids
            self.table.times[:] = 0

    def record_frame(self, stage_seconds: list[float]):
        row = self._frame_index % STATS_FRAME_WINDOW
        self.table.times[row, :] = 0
        for i, t in enumerate(stage_seconds[:STATS_MAX_STAGES]):
            self.table.times[row, i] = t
        self._frame_index += 1

    def record_rf_upload(self, now: float | None = None):
        now = time.perf_counter() if now is None else now
        if self._last_rf_time is not None:
            self.table.rf_time_deltas[self._rf_index % STATS_FRAME_WINDOW] = \
                now - self._last_rf_time
            self._rf_index += 1
        self._last_rf_time = now

    # -- rolling summaries (the UI-facing view, beamformer_core.c:1697-1712)

    def average_times(self) -> np.ndarray:
        n = min(self._frame_index, STATS_FRAME_WINDOW)
        if n == 0:
            return np.zeros(STATS_MAX_STAGES, np.float32)
        return self.table.times[:n].mean(axis=0)

    def average_frame_time(self) -> float:
        return float(self.average_times().sum())

    def average_rf_delta(self) -> float:
        n = min(self._rf_index, STATS_FRAME_WINDOW)
        return float(self.table.rf_time_deltas[:n].mean()) if n else 0.0
