"""The median over the window of a frame's stage times in the program's
stats table (``Beamformer.compute_timings()``, CUDA events), summed."""

from h100bench.readers import median_ms


def read(run):
    return median_ms([sum(r) for r in run.rows])
