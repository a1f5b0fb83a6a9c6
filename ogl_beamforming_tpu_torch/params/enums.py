"""Enumerations for the beamforming pipeline.

Values mirror the reference ABI exactly (reference: generated/beamformer.c:16-166,
single-sourced from beamformer.meta) so that parameter blocks, client-library
calls and exported data are interchangeable with the reference's C API.
"""

from __future__ import annotations

import enum


class ShaderKind(enum.IntEnum):
    """Compute/helper/render stage identifiers.

    Reference: generated/beamformer.c:145-166.  Pipelines submitted by
    clients are arrays of these values.
    """

    Decode = 0
    Filter = 1
    Demodulate = 2
    DAS = 3
    Sum = 4
    MinMax = 5
    Hilbert = 6
    CoherencyWeighting = 7
    Reshape = 8
    RenderBeamformed = 9

    @property
    def is_compute(self) -> bool:
        return ShaderKind.Decode <= self <= ShaderKind.Hilbert


class DataKind(enum.IntEnum):
    """Element type of raw RF data (reference: generated/beamformer.c:46-54)."""

    Int16 = 0
    Int16Complex = 1
    Float32 = 2
    Float32Complex = 3
    Float16 = 4
    Float16Complex = 5

    @property
    def is_complex(self) -> bool:
        return self in (DataKind.Int16Complex, DataKind.Float32Complex,
                        DataKind.Float16Complex)

    @property
    def element_size(self) -> int:
        """Byte size of one scalar lane (reference: beamformer.meta:41-49)."""
        return {DataKind.Int16: 2, DataKind.Int16Complex: 2,
                DataKind.Float32: 4, DataKind.Float32Complex: 4,
                DataKind.Float16: 2, DataKind.Float16Complex: 2}[self]

    @property
    def element_count(self) -> int:
        return 2 if self.is_complex else 1

    @property
    def byte_size(self) -> int:
        return self.element_size * self.element_count


class DecodeMode(enum.IntEnum):
    """Reference: generated/beamformer.c:27-31, plus the Walsh
    (sequency-ordered Hadamard) mode of the zemp_bp container
    (external/zemp_bp.h:33-38) that the reference runtime drops —
    a strict superset, existing values unchanged."""

    NoDecode = 0
    Hadamard = 1
    Walsh = 2


class RCAOrientation(enum.IntEnum):
    """Row-column-array element orientation (generated/beamformer.c:33-38)."""

    NoOrientation = 0
    Rows = 1
    Columns = 2


class SamplingMode(enum.IntEnum):
    """Reference: generated/beamformer.c:40-44."""

    X2 = 0
    X4 = 1


class ContrastMode(enum.IntEnum):
    """Reference: generated/beamformer.c:56-60.

    A1S2 reduces 3 consecutive ensembles ``a - b - c`` on upload
    (reference: lib/ogl_beamformer_lib.c:466-557).
    """

    NoContrast = 0
    A1S2 = 1

    @property
    def samples(self) -> int:
        return 3 if self is ContrastMode.A1S2 else 1


class EmissionKind(enum.IntEnum):
    """Reference: generated/beamformer.c:62-66."""

    Sine = 0
    Chirp = 1


class InterpolationMode(enum.IntEnum):
    """RF sample interpolation in DAS (generated/beamformer.c:68-73,
    das.glsl:97-122)."""

    Nearest = 0
    Linear = 1
    Cubic = 2


class ViewPlaneTag(enum.IntEnum):
    """Reference: generated/beamformer.c:75-81."""

    XZ = 0
    YZ = 1
    XY = 2
    Arbitrary = 3


class AcquisitionKind(enum.IntEnum):
    """Transmit-sequence geometry (generated/beamformer.c:83-98).

    Dispatch groups (das.glsl:381-400):
      * FORCES/UFORCES -> separable rx/tx distance FORCES path
        (READI variant when ``readi_group_count > 1``)
      * HERCULES/UHERCULES/HERO_PA -> 2D-apodized HERCULES path
      * Flash/RCA_TPW/RCA_VLS -> row-column plane/cylindrical-wave path
    """

    FORCES = 0
    UFORCES = 1
    HERCULES = 2
    RCA_VLS = 3
    RCA_TPW = 4
    UHERCULES = 5
    RACES = 6
    EPIC_FORCES = 7
    EPIC_UFORCES = 8
    EPIC_UHERCULES = 9
    Flash = 10
    HERO_PA = 11
    ULM = 12

    @property
    def sparse(self) -> bool:
        """Whether transmit elements come from the sparse-element table
        (reference: beamformer_core.c:766)."""
        return self in (AcquisitionKind.UFORCES, AcquisitionKind.UHERCULES)

    @property
    def das_family(self) -> str:
        """DAS dispatch group (das.glsl:381-400).  Kinds outside the
        reference's switch (RACES, EPIC_*, ULM) return "none": the shader
        leaves the accumulator at zero for them."""
        if self in (AcquisitionKind.FORCES, AcquisitionKind.UFORCES):
            return "forces"
        if self in (AcquisitionKind.HERCULES, AcquisitionKind.UHERCULES,
                    AcquisitionKind.HERO_PA):
            return "hercules"
        if self in (AcquisitionKind.Flash, AcquisitionKind.RCA_TPW,
                    AcquisitionKind.RCA_VLS):
            return "rca"
        return "none"


class FilterKind(enum.IntEnum):
    """Reference: generated/beamformer.c:100-104."""

    Kaiser = 0
    MatchedChirp = 1


class LiveImagingDirtyFlags(enum.IntFlag):
    """Reference: generated/beamformer.c:117-125."""

    ImagePlaneOffsets = 1 << 0
    TransmitPower = 1 << 1
    TGCControlPoints = 1 << 2
    SaveData = 1 << 3
    SaveNameTag = 1 << 4
    StopImaging = 1 << 5
    AcquisitionKind = 1 << 6


class ErrorKind(enum.IntEnum):
    """Client-library error kinds (reference: lib/ogl_beamformer_lib_base.h:10-31)."""

    NoError = 0
    VersionMismatch = 1
    InvalidAccess = 2
    ParameterBlockOverflow = 3
    ParameterBlockUnallocated = 4
    ComputeStageOverflow = 5
    InvalidComputeStage = 6
    InvalidStartShader = 7
    InvalidDemodulationDataKind = 8
    InvalidImagePlane = 9
    InvalidFilterKind = 10
    InvalidDataKind = 11
    InvalidContrastMode = 12
    BufferOverflow = 13
    DataSizeMismatch = 14
    WorkQueueFull = 15
    ExportSpaceOverflow = 16
    SharedMemory = 17
    SyncVariable = 18
    FrameSizeOverflow = 19
    RFDataSizeOverflow = 20


ERROR_STRINGS = {
    ErrorKind.NoError: "None",
    ErrorKind.VersionMismatch: "host-library version mismatch",
    ErrorKind.InvalidAccess: "library in invalid state",
    ErrorKind.ParameterBlockOverflow: "parameter block count overflow",
    ErrorKind.ParameterBlockUnallocated: "push to unallocated parameter block",
    ErrorKind.ComputeStageOverflow: "compute stage overflow",
    ErrorKind.InvalidComputeStage: "invalid compute shader stage",
    ErrorKind.InvalidStartShader: "starting shader not Decode or Demodulate",
    ErrorKind.InvalidDemodulationDataKind:
        "data kind for demodulation not Int16 or Float",
    ErrorKind.InvalidImagePlane: "invalid image plane",
    ErrorKind.InvalidFilterKind: "invalid filter kind",
    ErrorKind.InvalidDataKind: "invalid data kind",
    ErrorKind.InvalidContrastMode: "invalid contrast mode",
    ErrorKind.BufferOverflow: "passed buffer size exceeds available space",
    ErrorKind.DataSizeMismatch:
        "data size doesn't match the size specified in parameters",
    ErrorKind.WorkQueueFull: "work queue full",
    ErrorKind.ExportSpaceOverflow: "not enough space for data export",
    ErrorKind.SharedMemory: "failed to open shared memory region",
    ErrorKind.SyncVariable: "failed to acquire lock within timeout period",
    ErrorKind.FrameSizeOverflow: "maximum frame size exceeded",
    ErrorKind.RFDataSizeOverflow: "raw rf size exceeds available GPU space",
}


class BeamformerError(Exception):
    """Python-side surfacing of a client-library error kind."""

    def __init__(self, kind: ErrorKind, detail: str = ""):
        self.kind = kind
        msg = ERROR_STRINGS.get(kind, str(kind))
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


def unpack_tx_rx_orientation(packed: int) -> tuple[RCAOrientation, RCAOrientation]:
    """Split a packed transmit/receive orientation byte.

    Reference: das.glsl:46-47 — rx in bits [0,4), tx in bits [4,8).
    Returns ``(tx, rx)``.
    """
    return RCAOrientation((packed >> 4) & 0xF), RCAOrientation(packed & 0xF)


def pack_tx_rx_orientation(tx: RCAOrientation, rx: RCAOrientation) -> int:
    return ((int(tx) & 0xF) << 4) | (int(rx) & 0xF)
