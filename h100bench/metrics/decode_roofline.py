"""The decode kernel (K2, ``decode_*_kernel``) against
``work/decode.py``."""

from h100bench.readers import stage_roofline


def read(run):
    return stage_roofline(run, "decode", "decode_")
