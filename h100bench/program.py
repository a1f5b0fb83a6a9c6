"""The system under test, set up from a configuration file through its
public calls: ``Beamformer(device=...)``, ``push_parameters``,
``push_pipeline``, ``create_filter`` and ``push_channel_mapping``."""

from __future__ import annotations

import builtins
import dataclasses
import enum

import numpy as np

from ogl_beamforming_tpu_torch.params import enums, types
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer


def _value(type_name: str, value):
    """A JSON value as a dataclass field whose annotation is ``type_name``
    holds it: enums by name, nested dataclasses by their fields."""
    kind = next(getattr(ns, type_name) for ns in (types, enums, builtins)
                if hasattr(ns, type_name))
    if issubclass(kind, enum.Enum):
        return kind[value]
    if dataclasses.is_dataclass(kind):
        return _dataclass(kind, value)
    return kind(value)


def _dataclass(cls, values: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(values) - set(fields)
    if unknown:
        raise KeyError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**{k: _value(fields[k].type, v) for k, v in values.items()})


def _floats(value):
    """Nested lists of numbers (or ``"inf"``) as nested lists of floats."""
    if isinstance(value, list):
        return [_floats(v) for v in value]
    return float(value)


def _array(value, dtype) -> np.ndarray:
    return np.array(_floats(value), np.float64).astype(dtype)


ARRAYS = {"das_voxel_transform": np.float32, "xdc_transform": np.float32,
          "xdc_element_pitch": np.float32, "raw_data_dimensions": np.uint32,
          "focal_vector": np.float32, "output_points": np.int32}
"""The array fields of ``Parameters`` and their dtypes."""


def parameters(cfg: dict) -> types.Parameters:
    """The configuration's ``Parameters``, every field as the file gives
    it."""
    values = dict(cfg["parameters"])
    arrays = {k: _array(values.pop(k), dt) for k, dt in ARRAYS.items()
              if k in values}
    p = _dataclass(types.Parameters, values)
    for k, v in arrays.items():
        setattr(p, k, v)
    return p


def configure(cfg: dict, device) -> Beamformer:
    """A Beamformer on ``device`` set up for the configuration."""
    bf = Beamformer(device=device)
    bf.push_parameters(parameters(cfg))
    pipe = cfg["pipeline"]
    bf.push_pipeline([enums.ShaderKind[s] for s in pipe["shaders"]],
                     enums.DataKind[pipe["data_kind"]],
                     pipe["stage_parameters"])
    for f in cfg.get("filters", []):
        values = {k: v for k, v in f.items() if k != "slot"}
        bf.create_filter(_dataclass(types.FilterParameters, values),
                         filter_slot=int(f["slot"]))
    bf.push_channel_mapping(np.asarray(cfg["channel_mapping"], np.int16))
    return bf
