"""The traffic generator's schedule: when each frame of the window is due.

A traffic file names its generator (``"generator": "<name>"``): the
``due(traffic, k)`` of ``h100bench/traffic/<name>.py``, the seconds after
the window opens at which frame ``k`` of the window is due, or None where
frames go as fast as the session takes them (its back-pressure paces the
client).  A frame is submitted at its due time, or at once when the client
runs late; a late frame keeps its due time, so its latency counts the
wait, and the schedule never shifts.
"""

from __future__ import annotations

import time


class Schedule:
    """When frame ``k`` of the window is due, on the host clock, once the
    window has opened (:meth:`start`)."""

    def __init__(self, due, traffic: dict):
        self._due = due
        self.traffic = traffic
        self.t0 = 0.0
        self.paced = due(traffic, 0) is not None
        """Whether frames have due times (else the session paces them)."""

    def start(self, t0: float) -> None:
        self.t0 = t0

    def due(self, k: int) -> float | None:
        offset = self._due(self.traffic, k)
        return None if offset is None else self.t0 + float(offset)

    def wait(self, k: int, clock=time.perf_counter,
             sleep=time.sleep) -> float:
        """Sleep until frame ``k`` is due; return how late the generator
        is (0 when on time, and for a frame with no due time)."""
        due = self.due(k)
        if due is None:
            return 0.0
        ahead = due - clock()
        if ahead > 0:
            sleep(ahead)
            return max(clock() - due, 0.0)
        return -ahead
