"""Frames whose own last kernel completed inside the window, over the
window's seconds (host clock)."""


def read(run):
    return run.completed_in_window() / run.seconds
