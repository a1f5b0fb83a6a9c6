"""A scanner's frame clock, evenly or in bursts: frames come in bursts of
``burst`` (default 1), one burst every ``burst / rate_per_s`` seconds, and
the frames of a burst ``1 / burst_rate_per_s`` seconds apart (default
``rate_per_s``).  Frame ``k`` is due

    (k // burst) * burst / rate_per_s + (k % burst) / burst_rate_per_s

seconds after the window opens, so ``rate_per_s`` is the mean rate; with
one frame a burst, frame ``k`` is due at ``k / rate_per_s``."""


def due(traffic: dict, k: int) -> float:
    rate = float(traffic["rate_per_s"])
    burst = int(traffic.get("burst", 1))
    inner = float(traffic.get("burst_rate_per_s", rate))
    return (k // burst) * burst / rate + (k % burst) / inner
