"""The 95th percentile, over the window's frames that completed, of the
time from a frame's due time to the completion of its own last kernel
(host clock); a frame that failed is counted in ``failed``."""

import numpy as np


def read(run):
    lat = [run.tracker.done[k] - run.due[k] for k in run.window
           if k in run.tracker.done and k in run.due]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
