"""The demodulate kernel (K3, ``demodulate_kernel``) against
``work/demod.py``."""

from h100bench.readers import stage_roofline


def read(run):
    return stage_roofline(run, "demod", "demodulate_kernel")
