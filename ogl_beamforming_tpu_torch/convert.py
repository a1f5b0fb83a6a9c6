"""The JAX package's parameters -> this package's.

The port imports nothing of the JAX package, so values cross as plain data:

* :func:`parameters_from_fields` and :func:`filter_parameters_from_fields`
  take a ``Parameters`` / ``FilterParameters`` block as its fields
  (``dataclasses.asdict`` of either package's block: numpy arrays, ints,
  floats, and enums, which cross as ints) and build this package's block, so
  that both packages compute from the same parameters.
* :func:`dyn_from_numpy` takes a JAX plan's dynamic parameters converted to
  numpy first (``jax.tree.map(np.asarray, plan.dyn)``) and places them on a
  torch device with their dtypes kept: ``hadamard{i}`` and ``taps{i}`` of
  the pre-DAS stages, the top-level frequencies, and every key of the DAS
  dict, ``channel_offset`` and ``x_offset`` included.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .params.types import FilterParameters, Parameters


def _from_fields(cls, fields: dict):
    """An instance of the dataclass ``cls`` from ``fields``: each value is
    cast to the type of the field's default (enum, nested dataclass, numpy
    array of the default's dtype, bool, int or float); absent fields keep
    their default."""
    default = cls()
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v, d = fields[f.name], getattr(default, f.name)
        if isinstance(d, enum.Enum):
            v = type(d)(int(v))
        elif dataclasses.is_dataclass(d):
            v = _from_fields(type(d), v if isinstance(v, dict)
                             else dataclasses.asdict(v))
        elif isinstance(d, np.ndarray):
            v = np.array(v, dtype=d.dtype)
        elif isinstance(d, (bool, int, float, str)):
            v = type(d)(v)
        kw[f.name] = v
    return cls(**kw)


def parameters_from_fields(fields: dict) -> Parameters:
    """This package's :class:`Parameters` from the fields of either
    package's block (``dataclasses.asdict(p)``)."""
    return _from_fields(Parameters, fields)


def filter_parameters_from_fields(fields: dict) -> FilterParameters:
    """This package's :class:`FilterParameters` from the fields of either
    package's block (``dataclasses.asdict(fp)``)."""
    return _from_fields(FilterParameters, fields)


def dyn_from_numpy(dyn: dict, device) -> dict:
    """Nested dict of numpy arrays (or scalars) -> same keys, tensors on
    ``device``."""
    return {k: dyn_from_numpy(v, device) if isinstance(v, dict)
            else torch.tensor(np.asarray(v), device=device)
            for k, v in dyn.items()}
