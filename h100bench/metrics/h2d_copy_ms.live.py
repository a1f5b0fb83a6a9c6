"""The trace's host-to-device copy time in the window, per frame of the
window."""


def read(run):
    if run.trace is None or not run.window:
        return None
    lo, hi = run.window_us()
    secs = sum(s for name, start, s in run.trace.copies
               if "HtoD" in name and lo <= start < hi)
    return secs * 1e3 / len(run.window) if secs else None
