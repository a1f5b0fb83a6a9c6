"""Percent of the traced window of a closed loop in which the card ran no
kernel and no copy."""

from h100bench.readers import idle_share


def read(run):
    return idle_share(run)
