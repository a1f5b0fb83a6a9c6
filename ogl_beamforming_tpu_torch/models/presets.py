"""Pre-configured imaging pipelines — the framework's "model zoo".

Each preset mirrors one of the benchmark/validation configurations from
BASELINE.json plus the reference's test harness setups (tests/decode.c,
tests/throughput.c:20-23,450-461): a complete Parameters + pipeline pair
ready to run or fine-tune.
"""

from __future__ import annotations

import numpy as np

from ..params.enums import (AcquisitionKind, DataKind, DecodeMode,
                            InterpolationMode, RCAOrientation, ShaderKind,
                            pack_tx_rx_orientation)
from ..params.types import Parameters
from ..pipeline.spec import PipelineSpec
from ..utils.transforms import das_transform_2d_xz, das_transform_3d


def decode_benchmark(transmit_count: int = 96, channel_count: int = 256,
                     sample_count: int = 4096) -> tuple[Parameters, PipelineSpec]:
    """Hadamard-decode-only config (reference: tests/decode.c:15-19)."""
    p = Parameters(
        sample_count=sample_count, channel_count=channel_count,
        acquisition_count=transmit_count,
        raw_data_dimensions=np.array(
            [sample_count * transmit_count, channel_count], np.uint32),
        decode_mode=DecodeMode.Hadamard,
        sampling_frequency=40e6)
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode], DataKind.Int16)
    return p, pipe


def plane_wave_2d(channel_count: int = 256, sample_count: int = 4096,
                  pitch: float = 0.2e-3, sampling_frequency: float = 40e6,
                  demodulation_frequency: float = 7.8e6,
                  output_points=(512, 1024),
                  lateral_mm=(-60.0, 60.0), axial_mm=(10.0, 165.0),
                  f_number: float = 0.5,
                  data_kind: DataKind = DataKind.Float32
                  ) -> tuple[Parameters, PipelineSpec]:
    """Single plane-wave RCA (Flash) 2D image — BASELINE config 2 and the
    throughput.c output grid (tests/throughput.c:20-23).

    ``data_kind=DataKind.Float32Complex`` is the client-expressible IQ
    configuration: interleaved I/Q wire data, ``decode_mode=NoDecode``
    strips the (mandatory-first) Decode stage in the planner exactly like
    the reference (beamformer_core.c:487-489), and DAS runs complex
    baseband.  ``sample_count`` counts complex samples; the wire carries
    ``2 * sample_count`` scalars per acquisition."""
    vt = das_transform_2d_xz([lateral_mm[0] * 1e-3, axial_mm[0] * 1e-3],
                             [lateral_mm[1] * 1e-3, axial_mm[1] * 1e-3])
    p = Parameters(
        sample_count=sample_count, channel_count=channel_count,
        acquisition_count=1,
        acquisition_kind=AcquisitionKind.Flash,
        decode_mode=DecodeMode.NoDecode,
        das_voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        transmit_receive_orientation=pack_tx_rx_orientation(
            RCAOrientation.Columns, RCAOrientation.Columns),
        focal_vector=np.array([0.0, np.inf], np.float32),
        sampling_frequency=sampling_frequency,
        demodulation_frequency=demodulation_frequency,
        f_number=f_number,
        interpolation_mode=InterpolationMode.Cubic,
        output_points=np.array([*output_points, 1, 0], np.int32))
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     data_kind)
    return p, pipe


def forces_compounding(channel_count: int = 128, transmit_count: int = 128,
                       sample_count: int = 4096, pitch: float = 0.3e-3,
                       sampling_frequency: float = 40e6,
                       demodulation_frequency: float = 7.8e6,
                       output_points=(512, 1024), f_number: float = 0.8,
                       demodulate: bool = True,
                       filter_slot: int = 0) -> tuple[Parameters, PipelineSpec]:
    """Multi-transmit FORCES compounding: demodulate -> decode -> DAS —
    BASELINE config 3 / throughput.c pipeline (tests/throughput.c:455-461)."""
    aperture = (channel_count - 1) * pitch
    vt = das_transform_2d_xz([0.0, 5e-3], [aperture, 60e-3])
    p = Parameters(
        sample_count=sample_count, channel_count=channel_count,
        acquisition_count=transmit_count,
        acquisition_kind=AcquisitionKind.FORCES,
        decode_mode=DecodeMode.Hadamard,
        das_voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        sampling_frequency=sampling_frequency,
        demodulation_frequency=demodulation_frequency,
        f_number=f_number,
        interpolation_mode=InterpolationMode.Cubic,
        output_points=np.array([*output_points, 1, 0], np.int32))
    stages = ([ShaderKind.Demodulate] if demodulate else []) + \
        [ShaderKind.Decode, ShaderKind.DAS]
    params = [filter_slot if s == ShaderKind.Demodulate else 0
              for s in stages]
    pipe = PipelineSpec.from_shaders(stages, DataKind.Int16, params)
    return p, pipe


def uforces_volumetric(channel_count: int = 256, acquisition_count: int = 64,
                       sample_count: int = 2048, pitch: float = 0.3e-3,
                       output_points=(128, 128, 128),
                       sparse_elements=None,
                       coherency_weighting: bool = True
                       ) -> tuple[Parameters, PipelineSpec, np.ndarray]:
    """3D volumetric uFORCES with sparse transmits + coherency weighting —
    BASELINE config 4.  Returns (params, pipeline, sparse_elements).

    ``acquisition_count`` must be a valid Hadamard order (decode runs over
    all acquisitions; DAS skips the first, using the A-1 sparse elements).
    """
    aperture = (channel_count - 1) * pitch
    vt = das_transform_3d([0.0, -aperture / 2, 5e-3],
                          [aperture, aperture / 2, 45e-3])
    if sparse_elements is None:
        sparse_elements = np.linspace(
            0, channel_count - 1, acquisition_count - 1).astype(np.int16)
    p = Parameters(
        sample_count=sample_count, channel_count=channel_count,
        acquisition_count=acquisition_count,
        acquisition_kind=AcquisitionKind.UFORCES,
        decode_mode=DecodeMode.Hadamard,
        das_voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        sampling_frequency=20e6, demodulation_frequency=5e6,
        f_number=1.0,
        coherency_weighting=coherency_weighting,
        interpolation_mode=InterpolationMode.Linear,
        output_points=np.array([*output_points, 0], np.int32))
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16)
    return p, pipe, sparse_elements


def hercules_3d(channel_count: int = 128, acquisition_count: int = 128,
                sample_count: int = 2048, pitch: float = 0.3e-3,
                output_points=(96, 96, 96)) -> tuple[Parameters, PipelineSpec]:
    """HERCULES matrix-array 3D imaging."""
    aperture = (channel_count - 1) * pitch
    vt = das_transform_3d([0.0, 0.0, 5e-3], [aperture, aperture, 40e-3])
    p = Parameters(
        sample_count=sample_count, channel_count=channel_count,
        acquisition_count=acquisition_count,
        acquisition_kind=AcquisitionKind.HERCULES,
        decode_mode=DecodeMode.Hadamard,
        das_voxel_transform=vt,
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        transmit_receive_orientation=pack_tx_rx_orientation(
            RCAOrientation.Rows, RCAOrientation.Columns),
        focal_vector=np.array([0.0, np.inf], np.float32),
        sampling_frequency=20e6, demodulation_frequency=5e6,
        f_number=1.0,
        interpolation_mode=InterpolationMode.Linear,
        output_points=np.array([*output_points, 0], np.int32))
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16)
    return p, pipe


def from_zbp(z, output_points=(512, 1024), lateral_mm=(-60.0, 60.0),
             axial_mm=(10.0, 165.0), f_number: float = 0.5,
             interpolation=InterpolationMode.Cubic
             ) -> tuple[Parameters, PipelineSpec]:
    """Build a run configuration from a loaded .zbp dataset — the
    throughput.c setup path (tests/throughput.c:393-461)."""
    vt = das_transform_2d_xz([lateral_mm[0] * 1e-3, axial_mm[0] * 1e-3],
                             [lateral_mm[1] * 1e-3, axial_mm[1] * 1e-3])
    p = Parameters(
        sample_count=z.sample_count, channel_count=z.channel_count,
        acquisition_count=z.receive_event_count,
        acquisition_kind=z.acquisition_kind,
        decode_mode=z.decode_mode,
        das_voxel_transform=vt,
        xdc_transform=np.asarray(z.xdc_transform, np.float32),
        xdc_element_pitch=np.asarray(z.xdc_element_pitch, np.float32),
        raw_data_dimensions=np.array(z.raw_data_dimension[:2], np.uint32),
        sampling_frequency=z.sampling_frequency,
        demodulation_frequency=z.demodulation_frequency,
        speed_of_sound=z.speed_of_sound,
        time_offset=z.time_offset,
        f_number=f_number, interpolation_mode=interpolation,
        output_points=np.array([*output_points, 1, 0], np.int32))
    if z.transmit_focus is not None:
        p.focal_vector = np.array([z.transmit_focus.steering_angle,
                                   z.transmit_focus.focal_depth or np.inf],
                                  np.float32)
        p.transmit_receive_orientation = \
            z.transmit_focus.transmit_receive_orientation
    stages = []
    if z.demodulation_frequency > 0:
        stages.append(ShaderKind.Demodulate)
    if z.decode_mode != DecodeMode.NoDecode:
        stages.append(ShaderKind.Decode)
    stages.append(ShaderKind.DAS)
    pipe = PipelineSpec.from_shaders(stages, z.data_kind)
    return p, pipe
