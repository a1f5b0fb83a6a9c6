"""What belongs to one acquisition kind, one file each, found by the
kind's name in lower case (``FORCES`` -> ``forces.py``): the reference's
delay-and-sum over a block of voxels (``das_block``), the echo paths of a
point target for the frame generator (``echo_paths``), and the
contributing (voxel, channel, transmit) triples and float32 operations a
triple for ``work/das.py`` (``triples``, ``DELAY_OPS``, ``SUM_OPS``).
``TRANSDUCER_FRAME`` says whether the kind's delays are worked out in the
transducer's frame.  A configuration of another kind is a new file here.
"""

from __future__ import annotations

import importlib


def load(kind: str):
    """The module of acquisition kind ``kind``."""
    try:
        return importlib.import_module(f"{__name__}.{kind.lower()}")
    except ModuleNotFoundError as e:
        raise ValueError(f"acquisition kind {kind!r} is not in the "
                         "reference") from e
