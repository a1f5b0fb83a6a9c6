"""Parameter structures for the beamformer.

Mirrors the reference's single-source-of-truth parameter schema
(reference: beamformer.meta:98-276, generated/beamformer.c:296-520) as Python
dataclasses.  Matrices follow the mathematical convention ``world = M @ [p, 1]``
with ``M`` stored row-major ``(4, 4)``; the reference stores column vectors
(`math.c` m4.c[i]) — conversion is a plain transpose of the flat storage.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from .constants import (MAX_CHANNEL_COUNT, MAX_COMPUTE_SHADER_STAGES,
                        MAX_EMISSIONS_COUNT)
from .enums import (AcquisitionKind, ContrastMode, DataKind, DecodeMode,
                    EmissionKind, FilterKind, InterpolationMode, SamplingMode,
                    ShaderKind, ViewPlaneTag)


def _m4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


@dataclass
class SineParameters:
    """Reference: beamformer.meta:98-102."""

    cycles: float = 0.0
    frequency: float = 0.0


@dataclass
class ChirpParameters:
    """Reference: beamformer.meta:105-110."""

    duration: float = 0.0
    min_frequency: float = 0.0
    max_frequency: float = 0.0


@dataclass
class EmissionParameters:
    """Reference: beamformer.meta:122-126."""

    kind: EmissionKind = EmissionKind.Sine
    sine: SineParameters = field(default_factory=SineParameters)
    chirp: ChirpParameters = field(default_factory=ChirpParameters)


@dataclass
class KaiserFilterParameters:
    """Reference: beamformer.meta:137-142."""

    cutoff_frequency: float = 0.0
    beta: float = 0.0
    length: int = 0


@dataclass
class MatchedChirpFilterParameters:
    """Reference: beamformer.meta:145-150."""

    duration: float = 0.0
    min_frequency: float = 0.0
    max_frequency: float = 0.0


@dataclass
class FilterParameters:
    """Reference: beamformer.meta:162-168."""

    kind: FilterKind = FilterKind.Kaiser
    sampling_frequency: float = 0.0
    complex: bool = False
    kaiser: KaiserFilterParameters = field(default_factory=KaiserFilterParameters)
    matched_chirp: MatchedChirpFilterParameters = field(
        default_factory=MatchedChirpFilterParameters)


@dataclass
class Parameters:
    """Full parameter block: ParametersHead + UIParameters + ExtraParameters.

    Reference: beamformer.meta:172-218.
    """

    # --- ParametersHead (beamformer.meta:172-189) ---
    das_voxel_transform: np.ndarray = field(default_factory=_m4_identity)
    xdc_transform: np.ndarray = field(default_factory=_m4_identity)
    xdc_element_pitch: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.float32))
    raw_data_dimensions: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.uint32))
    focal_vector: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.float32))
    """(transmit_angle [degrees], focal_depth [m]); depth=inf => plane wave."""
    transmit_receive_orientation: int = 0
    sample_count: int = 0
    channel_count: int = 0
    acquisition_count: int = 0
    acquisition_kind: AcquisitionKind = AcquisitionKind.FORCES
    decode_mode: DecodeMode = DecodeMode.Hadamard
    sampling_mode: SamplingMode = SamplingMode.X2
    time_offset: float = 0.0
    single_focus: bool = True
    single_orientation: bool = True

    # --- UIParameters (beamformer.meta:191-201) ---
    output_points: np.ndarray = field(
        default_factory=lambda: np.array([512, 1, 512, 0], np.int32))
    """(x, y, z, average_frame_count)."""
    sampling_frequency: float = 0.0
    demodulation_frequency: float = 0.0
    speed_of_sound: float = 1540.0
    f_number: float = 1.0
    interpolation_mode: InterpolationMode = InterpolationMode.Linear
    coherency_weighting: bool = False
    decimation_rate: int = 1

    # --- ExtraParameters (beamformer.meta:203-209) ---
    contrast_mode: ContrastMode = ContrastMode.NoContrast
    emission_parameters: EmissionParameters = field(
        default_factory=EmissionParameters)
    readi_group_count: int = 0
    readi_group: int = 0

    def copy(self) -> "Parameters":
        new = dataclasses.replace(self)
        for f in dataclasses.fields(self):
            v = getattr(new, f.name)
            if isinstance(v, np.ndarray):
                setattr(new, f.name, v.copy())
        return new


def _i16s(n: int) -> np.ndarray:
    return np.zeros(n, np.int16)


@dataclass
class SimpleParameters:
    """Parameters plus per-element tables and the pipeline description.

    Reference: beamformer.meta:220-235.  This is the one-struct "simple API"
    surface used by ``beamformer_beamform_data`` (lib/ogl_beamformer_lib.c:704).
    """

    parameters: Parameters = field(default_factory=Parameters)
    channel_mapping: np.ndarray = field(
        default_factory=lambda: np.arange(MAX_CHANNEL_COUNT, dtype=np.int16))
    sparse_elements: np.ndarray = field(
        default_factory=lambda: _i16s(MAX_EMISSIONS_COUNT))
    transmit_receive_orientations: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.uint8))
    steering_angles: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.float32))
    focal_depths: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.float32))
    compute_stages: list[ShaderKind] = field(default_factory=list)
    compute_stage_parameters: list[int] = field(
        default_factory=lambda: [0] * MAX_COMPUTE_SHADER_STAGES)
    data_kind: DataKind = DataKind.Int16

    @property
    def focal_vectors(self) -> np.ndarray:
        """Interleaved (angle, depth) pairs as pushed by
        ``beamformer_push_focal_vectors`` (lib/ogl_beamformer_lib.c)."""
        return np.stack([self.steering_angles, self.focal_depths],
                        axis=-1).astype(np.float32)


@dataclass
class LiveImagingParameters:
    """Reference: beamformer.meta:254-268."""

    active: int = 0
    save_enabled: int = 0
    save_active: int = 0
    acquisition_kind: int = 0
    acquisition_kind_enabled_flags: int = 0
    transmit_power: float = 0.0
    image_plane_offsets: np.ndarray = field(
        default_factory=lambda: np.zeros(len(ViewPlaneTag), np.float32))
    tgc_control_points: np.ndarray = field(
        default_factory=lambda: np.zeros(8, np.float32))
    save_name_tag: str = ""
