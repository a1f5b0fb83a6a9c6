"""The median over the window's frames of the host clock from ``submit``
to the frame's future resolving: the copy into the pinned slot, the
upload's enqueue, the ingest and the plan enqueued."""

from h100bench.readers import median_ms


def read(run):
    r = run.tracker.resolved
    return median_ms([r[k] - run.submitted[k] for k in run.window
                      if k in r])
