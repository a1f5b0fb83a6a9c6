"""The traffic generators and the schedule: a frame clock's due times,
evenly and in bursts, a late submit that keeps its lateness, and a closed
loop that has none."""

from __future__ import annotations

import pytest

from h100bench.loop import Schedule
from h100bench.spec import Bench


class Clock:
    """A clock that moves only when slept or set."""

    def __init__(self, now: float):
        self.now = now
        self.slept = []

    def __call__(self) -> float:
        return self.now

    def sleep(self, seconds: float) -> None:
        self.slept.append(seconds)
        self.now += seconds


def schedule(traffic: dict, t0: float) -> Schedule:
    s = Schedule(Bench().generator(traffic["generator"]), traffic)
    s.start(t0)
    return s


CLOCK = {"generator": "clock", "rate_per_s": 40.0}


def test_open_loop_frames_are_due_on_the_frame_clock():
    s = schedule(CLOCK, t0=100.0)
    assert s.paced
    assert [s.due(k) for k in range(3)] == [100.0, 100.025, 100.05]


def test_bursts_keep_the_mean_rate():
    """Bursts of 8 at twice the mean rate: the frames of a burst 1/80 s
    apart, a burst every 8/40 s."""
    s = schedule({"generator": "clock", "rate_per_s": 40.0, "burst": 8,
                  "burst_rate_per_s": 80.0}, t0=0.0)
    due = [s.due(k) for k in range(17)]
    assert due[:8] == pytest.approx([k / 80.0 for k in range(8)])
    assert due[8] == pytest.approx(0.2) and due[16] == pytest.approx(0.4)
    assert due[9] - due[8] == pytest.approx(1 / 80.0)


def test_an_early_generator_sleeps_until_the_due_time():
    s = schedule(CLOCK, t0=100.0)
    clock = Clock(100.01)
    assert s.wait(1, clock, clock.sleep) == pytest.approx(0.0)
    assert clock.slept == [pytest.approx(0.015)]


def test_a_late_submit_keeps_its_lateness_and_the_schedule_holds():
    s = schedule(CLOCK, t0=100.0)
    clock = Clock(100.1)                # frames 0-3 are late already
    assert s.wait(1, clock, clock.sleep) == pytest.approx(0.075)
    assert clock.slept == []            # submitted at once
    assert s.due(1) == pytest.approx(100.025)   # latency counts from here
    assert s.due(5) == pytest.approx(100.125)   # no shift after a late one
    assert s.wait(5, clock, clock.sleep) == pytest.approx(0.0)
    assert clock.slept == [pytest.approx(0.025)]


def test_a_closed_loop_has_no_due_times():
    s = schedule({"generator": "closed"}, t0=5.0)
    clock = Clock(9.0)
    assert not s.paced
    assert s.due(3) is None
    assert s.wait(3, clock, clock.sleep) == 0.0 and clock.slept == []


def test_an_unknown_generator_is_refused():
    with pytest.raises(FileNotFoundError):
        Bench().generator("no_such_generator")
