"""``.zbp`` parameter/data container loader.

Reads the zemp_bp V1/V2 format used by the reference's throughput benchmark
(reference: external/zemp_bp.h, tests/throughput.c:150-374): a packed header
with acquisition geometry + optionally zstd-compressed raw RF data.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..params.enums import AcquisitionKind, DataKind, DecodeMode

ZBP_MAGIC = 0x5042504D455AFECA

_DATA_DTYPES = {
    0: (np.int16, 1), 1: (np.int16, 2), 2: (np.float32, 1),
    3: (np.float32, 2), 4: (np.float16, 1), 5: (np.float16, 2),
}


@dataclass
class RCATransmitFocus:
    focal_depth: float = 0.0
    steering_angle: float = 0.0
    origin_offset: float = 0.0
    transmit_receive_orientation: int = 0


@dataclass
class ZbpFile:
    version: tuple[int, int]
    raw_data_dimension: tuple[int, int, int, int]
    data_kind: DataKind
    decode_mode: DecodeMode
    sampling_mode: int
    sampling_frequency: float
    demodulation_frequency: float
    speed_of_sound: float
    sample_count: int
    channel_count: int
    receive_event_count: int
    xdc_transform: np.ndarray            # (4,4) row-major
    xdc_element_pitch: np.ndarray        # (2,)
    time_offset: float
    acquisition_kind: AcquisitionKind
    channel_mapping: np.ndarray | None = None
    sparse_elements: np.ndarray | None = None
    steering_angles: np.ndarray | None = None
    focal_depths: np.ndarray | None = None
    transmit_receive_orientations: np.ndarray | None = None
    transmit_focus: RCATransmitFocus = field(default_factory=RCATransmitFocus)
    emissions: list[dict] = field(default_factory=list)
    data: np.ndarray | None = None       # raw scalar data, flat

    @property
    def acquisition_count(self) -> int:
        return self.receive_event_count


def _decode_mode(value: int) -> DecodeMode:
    """Map a zemp decode mode explicitly (external/zemp_bp.h:33-38):
    None/Hadamard pass through, Walsh (2) is supported natively
    (utils/hadamard.walsh); anything else is rejected rather than
    silently clamped."""
    try:
        return DecodeMode(value)
    except ValueError:
        raise ValueError(f"unsupported zbp decode mode {value} "
                         f"(known: 0=None, 1=Hadamard, 2=Walsh)")


def _read_struct(buf, offset, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack_from(fmt, buf, offset), offset + size


def _read_i32_array(buf, offset, count):
    return np.frombuffer(buf, np.int32, count, offset)


def load_zbp(path) -> ZbpFile:
    buf = Path(path).read_bytes()
    (magic, major, minor), _ = _read_struct(buf, 0, "<QII")
    if magic != ZBP_MAGIC:
        raise ValueError(f"{path}: bad zbp magic {magic:#x}")
    if major == 1 or (major == 0):
        return _load_v1(buf)
    return _load_v2(buf)


def _load_v1(buf) -> ZbpFile:
    """ZBP_HeaderV1 (zemp_bp.h:95-117); data follows the header, int16."""
    fmt = "<QIhh4I4I2f16f"  # through transducer_transform_matrix
    off = 0
    (magic, version, decode_mode, beamform_mode,
     rd0, rd1, rd2, rd3, sample_count, channel_count, receive_event_count,
     frame_count, pitch0, pitch1, *xform), off = _read_struct(buf, off, fmt)
    channel_mapping = np.frombuffer(buf, np.int16, 256, off); off += 512
    steering = np.frombuffer(buf, np.float32, 256, off); off += 1024
    focal = np.frombuffer(buf, np.float32, 256, off); off += 1024
    sparse = np.frombuffer(buf, np.int16, 256, off); off += 512
    _hadamard_rows = np.frombuffer(buf, np.int16, 256, off); off += 512
    (sos, fdemod, fs, t0, transmit_mode), off = _read_struct(buf, off, "<4fI")

    data = np.frombuffer(buf, np.int16, offset=off)
    return ZbpFile(
        version=(1, version),
        raw_data_dimension=(rd0, rd1, rd2, rd3),
        data_kind=DataKind.Int16,
        decode_mode=_decode_mode(decode_mode),
        sampling_mode=0,
        sampling_frequency=fs, demodulation_frequency=fdemod,
        speed_of_sound=sos,
        sample_count=sample_count, channel_count=channel_count,
        receive_event_count=receive_event_count,
        xdc_transform=np.array(xform, np.float32).reshape(4, 4).T,
        xdc_element_pitch=np.array([pitch0, pitch1], np.float32),
        time_offset=t0,
        acquisition_kind=AcquisitionKind(beamform_mode
                                         if 0 <= beamform_mode < 13 else 0),
        channel_mapping=channel_mapping.copy(),
        sparse_elements=sparse.copy(),
        steering_angles=steering.copy(), focal_depths=focal.copy(),
        data=data.copy())


def _load_v2(buf) -> ZbpFile:
    """ZBP_HeaderV2 (zemp_bp.h:119-146) with offset-linked sub-tables."""
    fmt = "<QII4Iiii iif f f i III 16f 2f f f f i i i i i".replace(" ", "")
    off0 = 0
    vals, _ = _read_struct(buf, off0, fmt)
    (magic, major, minor, rd0, rd1, rd2, rd3, raw_data_kind, raw_data_offset,
     raw_compression, decode_mode, sampling_mode, fs, fdemod, sos,
     channel_mapping_offset, sample_count, channel_count,
     receive_event_count, *rest) = vals
    xform = rest[:16]
    pitch = rest[16:18]
    (time_offset, group_acq_time, ensemble_rep,
     acquisition_mode, acq_params_offset, contrast_mode,
     contrast_params_offset, emission_desc_offset) = rest[18:]

    dtype, elements = _DATA_DTYPES[raw_data_kind]

    channel_mapping = None
    if channel_mapping_offset > 0:
        channel_mapping = np.frombuffer(buf, np.int16, channel_count,
                                        channel_mapping_offset).copy()

    z = ZbpFile(
        version=(major, minor),
        raw_data_dimension=(rd0, rd1, rd2, rd3),
        data_kind=DataKind(raw_data_kind),
        decode_mode=_decode_mode(decode_mode),
        sampling_mode=sampling_mode,
        sampling_frequency=fs, demodulation_frequency=fdemod,
        speed_of_sound=sos,
        sample_count=sample_count, channel_count=channel_count,
        receive_event_count=receive_event_count,
        xdc_transform=np.array(xform, np.float32).reshape(4, 4).T,
        xdc_element_pitch=np.array(pitch, np.float32),
        time_offset=time_offset,
        acquisition_kind=AcquisitionKind(acquisition_mode
                                         if 0 <= acquisition_mode < 13 else 0),
        channel_mapping=channel_mapping)

    # Acquisition-mode parameter blocks (zemp_bp.h:171-199)
    if acq_params_offset > 0:
        kind = z.acquisition_kind
        if kind in (AcquisitionKind.FORCES, AcquisitionKind.UFORCES,
                    AcquisitionKind.HERCULES, AcquisitionKind.UHERCULES):
            (fd, sa, oo, tro), off = _read_struct(buf, acq_params_offset,
                                                  "<3fI")
            z.transmit_focus = RCATransmitFocus(fd, sa, oo, tro)
            if kind in (AcquisitionKind.UFORCES, AcquisitionKind.UHERCULES):
                (sparse_off,), _ = _read_struct(buf, off, "<i")
                if sparse_off > 0:
                    z.sparse_elements = np.frombuffer(
                        buf, np.int16, receive_event_count, sparse_off).copy()
        elif kind == AcquisitionKind.RCA_TPW:
            (angles_off, tro_off), _ = _read_struct(buf, acq_params_offset,
                                                    "<2i")
            if angles_off > 0:
                z.steering_angles = np.frombuffer(
                    buf, np.float32, receive_event_count, angles_off).copy()
                z.focal_depths = np.full(receive_event_count, np.inf,
                                         np.float32)
            if tro_off > 0:
                z.transmit_receive_orientations = np.frombuffer(
                    buf, np.uint32, receive_event_count, tro_off
                ).astype(np.uint8)
        elif kind == AcquisitionKind.RCA_VLS:
            (fd_off, oo_off, tro_off), _ = _read_struct(
                buf, acq_params_offset, "<3i")
            if fd_off > 0:
                z.focal_depths = np.frombuffer(
                    buf, np.float32, receive_event_count, fd_off).copy()
                z.steering_angles = np.zeros(receive_event_count, np.float32)
            if tro_off > 0:
                z.transmit_receive_orientations = np.frombuffer(
                    buf, np.uint32, receive_event_count, tro_off
                ).astype(np.uint8)

    # Emission descriptors
    if emission_desc_offset > 0:
        (em_kind, em_params_off), _ = _read_struct(buf, emission_desc_offset,
                                                   "<2i")
        em = {"kind": em_kind}
        if em_params_off > 0:
            if em_kind == 0:
                (cycles, freq), _ = _read_struct(buf, em_params_off, "<2f")
                em.update(cycles=cycles, frequency=freq)
            else:
                (dur, fmin, fmax), _ = _read_struct(buf, em_params_off, "<3f")
                em.update(duration=dur, min_frequency=fmin,
                          max_frequency=fmax)
        z.emissions.append(em)

    # Raw data (optionally zstd)
    if raw_data_offset > 0:
        payload = buf[raw_data_offset:]
        if raw_compression == 1:
            import zstandard
            payload = zstandard.ZstdDecompressor().decompress(
                payload,
                max_output_size=int(rd0) * int(max(rd1, 1))
                * int(max(rd2, 1)) * int(max(rd3, 1))
                * np.dtype(dtype).itemsize * elements)
        z.data = np.frombuffer(payload, dtype).copy()
    return z


def save_zbp_v1(path, z: ZbpFile):
    """Write a minimal V1 file (round-trip/testing support)."""
    out = bytearray()
    out += struct.pack("<QIhh", ZBP_MAGIC, 1, int(z.decode_mode),
                       int(z.acquisition_kind))
    out += struct.pack("<4I", *z.raw_data_dimension)
    out += struct.pack("<4I", z.sample_count, z.channel_count,
                       z.receive_event_count, 1)
    out += struct.pack("<2f", *map(float, z.xdc_element_pitch))
    out += struct.pack("<16f", *np.asarray(z.xdc_transform, np.float32
                                           ).T.ravel())
    for arr, dt, n in [(z.channel_mapping, np.int16, 256),
                       (z.steering_angles, np.float32, 256),
                       (z.focal_depths, np.float32, 256),
                       (z.sparse_elements, np.int16, 256),
                       (None, np.int16, 256)]:
        a = np.zeros(n, dt)
        if arr is not None:
            a[:len(arr)] = arr[:n]
        out += a.tobytes()
    out += struct.pack("<4fI", z.speed_of_sound, z.demodulation_frequency,
                       z.sampling_frequency, z.time_offset, 0)
    if z.data is not None:
        out += np.asarray(z.data, np.int16).tobytes()
    Path(path).write_bytes(bytes(out))


def save_zbp_v2(path, z: ZbpFile, compress: bool = True):
    """Write a V2 file with offset-linked sub-tables (zemp_bp.h:119-146).

    Supports the acquisition-parameter blocks for FORCES/UFORCES (transmit
    focus + sparse elements) and RCA TPW/VLS (angle/depth tables), emission
    descriptors, and zstd-compressed raw data.
    """
    head_fmt = "<QII4Iiii iif f f i III 16f 2f f f f i i i i i".replace(" ", "")
    head_size = struct.calcsize(head_fmt)

    def align(n):
        return (n + 3) & ~3

    tail = bytearray()
    offsets = {}

    def append(tag, payload: bytes) -> int:
        off = head_size + len(tail)
        tail.extend(payload)
        tail.extend(b"\x00" * (align(len(tail)) - len(tail)))
        offsets[tag] = off
        return off

    channel_mapping_offset = 0
    if z.channel_mapping is not None:
        channel_mapping_offset = append(
            "chmap", np.asarray(z.channel_mapping[:z.channel_count],
                                np.int16).tobytes())

    acq_params_offset = 0
    kind = z.acquisition_kind
    if kind in (AcquisitionKind.FORCES, AcquisitionKind.UFORCES,
                AcquisitionKind.HERCULES, AcquisitionKind.UHERCULES):
        tf = z.transmit_focus or RCATransmitFocus()
        blob = struct.pack("<3fI", tf.focal_depth, tf.steering_angle,
                           tf.origin_offset,
                           tf.transmit_receive_orientation)
        if kind in (AcquisitionKind.UFORCES, AcquisitionKind.UHERCULES):
            sparse_off = 0
            if z.sparse_elements is not None:
                sparse_off = append(
                    "sparse",
                    np.asarray(z.sparse_elements[:z.receive_event_count],
                               np.int16).tobytes())
            blob += struct.pack("<i", sparse_off)
        acq_params_offset = append("acq", blob)
    elif kind == AcquisitionKind.RCA_TPW:
        angles_off = append("angles", np.asarray(
            z.steering_angles[:z.receive_event_count], np.float32).tobytes()) \
            if z.steering_angles is not None else 0
        tro_off = 0
        if z.transmit_receive_orientations is not None:
            tro_off = append("tro", np.asarray(
                z.transmit_receive_orientations[:z.receive_event_count],
                np.uint32).tobytes())
        acq_params_offset = append("acq", struct.pack("<2i", angles_off,
                                                      tro_off))
    elif kind == AcquisitionKind.RCA_VLS:
        fd_off = append("depths", np.asarray(
            z.focal_depths[:z.receive_event_count], np.float32).tobytes()) \
            if z.focal_depths is not None else 0
        tro_off = 0
        if z.transmit_receive_orientations is not None:
            tro_off = append("tro", np.asarray(
                z.transmit_receive_orientations[:z.receive_event_count],
                np.uint32).tobytes())
        acq_params_offset = append("acq", struct.pack("<3i", fd_off, 0,
                                                      tro_off))

    emission_desc_offset = 0
    if z.emissions:
        em = z.emissions[0]
        if em.get("kind") == 1:
            em_params = append("emp", struct.pack(
                "<3f", em.get("duration", 0.0), em.get("min_frequency", 0.0),
                em.get("max_frequency", 0.0)))
        else:
            em_params = append("emp", struct.pack(
                "<2f", em.get("cycles", 0.0), em.get("frequency", 0.0)))
        emission_desc_offset = append(
            "emd", struct.pack("<2i", em.get("kind", 0), em_params))

    raw_data_offset = 0
    compression = 0
    if z.data is not None:
        payload = np.asarray(z.data).tobytes()
        if compress:
            import zstandard
            payload = zstandard.ZstdCompressor(level=3).compress(payload)
            compression = 1
        raw_data_offset = append("raw", payload)

    head = struct.pack(
        head_fmt, ZBP_MAGIC, 2, 0,
        *[int(v) for v in z.raw_data_dimension],
        int(z.data_kind), raw_data_offset, compression,
        int(z.decode_mode), int(z.sampling_mode),
        z.sampling_frequency, z.demodulation_frequency, z.speed_of_sound,
        channel_mapping_offset,
        z.sample_count, z.channel_count, z.receive_event_count,
        *np.asarray(z.xdc_transform, np.float32).T.ravel().tolist(),
        *np.asarray(z.xdc_element_pitch, np.float32).tolist(),
        z.time_offset, 0.0, 0.0,
        int(z.acquisition_kind), acq_params_offset,
        0, 0, emission_desc_offset)
    Path(path).write_bytes(head + bytes(tail))
