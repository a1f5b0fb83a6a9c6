"""Seconds from the process's start to the window's opening: imports, the
card, the kernels' library (built in a checkout's first run), the frame
pool, the plan and the warm-up frames."""


def read(run):
    return run.setup_s
