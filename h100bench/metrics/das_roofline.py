"""The DAS kernel (K1, ``das_*_kernel``) against ``work/das.py``."""

from h100bench.readers import stage_roofline


def read(run):
    return stage_roofline(run, "das", "das_")
