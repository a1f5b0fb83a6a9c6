"""Frame batches and frame averaging in the port on the CPU, against the JAX
package, on the same numpy-seeded raw frames:

  * ``build_plan(frame_batch=2)`` against the JAX package's batched plan
    (XLA backend) on the Quickstart's decode -> FORCES DAS, the plane-wave
    headline (NoDecode, Float32Complex wire data), the demodulate chain and
    uFORCES with coherency weighting;
  * ``Beamformer.push_batch`` against ``push_data_with_compute`` of each
    frame and against the JAX package's ``Beamformer.push_batch``; the
    batched-plan cache, cleared by a parameter push;
  * ``Beamformer.averaged_frame`` and ``ops/display.py`` against the JAX
    package's functions.

Tolerances (NRMSE): 1e-4 against the JAX package (the same f32 arithmetic
in another summation order); 1e-6 between a batch and the frame-by-frame
path of the port, and for the frame average (against the JAX package's
``sum_frames`` of the same frames) and the display mapping (sums of a few
values in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.models import presets  # noqa: E402
from ogl_beamforming_tpu.ops import display as jax_display  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, FilterKind, InterpolationMode, ShaderKind)
from ogl_beamforming_tpu.params.types import (  # noqa: E402
    FilterParameters, KaiserFilterParameters, Parameters)
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.pipeline import plan as jax_plan  # noqa: E402
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu.utils.filters import make_filter  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz, das_transform_3d)
from ogl_beamforming_tpu_torch import convert  # noqa: E402
from ogl_beamforming_tpu_torch.ops import display  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline import executor, plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import (  # noqa: E402
    PipelineSpec as PortPipelineSpec)
from ogl_beamforming_tpu_torch.utils import filters as port_filters  # noqa: E402

torch.set_num_threads(1)

C, A, S, PITCH, B = 8, 4, 256, 0.3e-3, 2


def _kaiser_fp(fs):
    return FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=fs,
                            kaiser=KaiserFilterParameters(2e6, 4.0, 16))


def _case(name):
    """(parameters, pipeline, filters, sparse elements, raw batch
    (B, channels, samples)) of a reduced configuration."""
    rng = np.random.default_rng(sum(map(ord, name)))
    filters, sparse = {}, None
    if name == "quickstart":
        p = Parameters(
            sample_count=S, channel_count=C, acquisition_count=A,
            sampling_frequency=20e6, demodulation_frequency=5e6,
            speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
            acquisition_kind=AcquisitionKind.FORCES,
            interpolation_mode=InterpolationMode.Cubic,
            das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                    [(C - 1) * PITCH, 8e-3]),
            xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
            output_points=np.array([12, 16, 1, 0], np.int32))
        pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                         DataKind.Int16)
    elif name == "plane_wave":
        p, pipe = presets.plane_wave_2d(
            channel_count=16, sample_count=1024, output_points=(16, 16),
            lateral_mm=(-2.0, 5.0), axial_mm=(5.0, 15.0),
            data_kind=DataKind.Float32Complex)
        return p, pipe, filters, sparse, rng.standard_normal(
            (B, 16, 2 * 1024)).astype(np.float32)
    elif name == "demod":
        p, pipe = presets.forces_compounding(
            channel_count=C, transmit_count=A, sample_count=2 * S,
            output_points=(12, 16))
        p.das_voxel_transform = das_transform_2d_xz([0, 2e-3],
                                                    [(C - 1) * PITCH, 9e-3])
        filters = {0: _kaiser_fp(p.sampling_frequency / 2)}
    else:                                   # uFORCES 3D with coherency
        p, pipe, sparse = presets.uforces_volumetric(
            channel_count=C, acquisition_count=A, sample_count=S,
            output_points=(6, 5, 7))
        ap = (C - 1) * PITCH
        p.das_voxel_transform = das_transform_3d([0, -ap / 2, 1e-3],
                                                 [ap, ap / 2, 5e-3])
    raw = rng.integers(-2048, 2048, (B, p.channel_count,
                                     A * p.sample_count)).astype(np.int16)
    return p, pipe, filters, sparse, raw


CASES = ["quickstart", "plane_wave", "demod", "uforces_coherency"]


def _port_beamformer(p, pipe, filters, sparse):
    bf = executor.Beamformer(device="cpu")
    for slot, fp in filters.items():
        bf.create_filter(convert.filter_parameters_from_fields(
            dataclasses.asdict(fp)), filter_slot=slot)
    bf.push_parameters(convert.parameters_from_fields(dataclasses.asdict(p)))
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    if sparse is not None:
        bf.push_sparse_elements(sparse)
    return bf


@pytest.mark.parametrize("name", CASES)
def test_batched_plan_matches_jax(name):
    p, pipe, filters, sparse, raw = _case(name)
    rf = raw.reshape(B, p.channel_count, p.acquisition_count, -1)
    jp = jax_plan.build_plan(p, pipe, {k: make_filter(f)
                                       for k, f in filters.items()},
                             sparse_elements=sparse, das_backend="xla",
                             frame_batch=B)
    ref = np.asarray(jp(rf))
    port_filters_ = {k: port_filters.make_filter(
        convert.filter_parameters_from_fields(dataclasses.asdict(f)))
        for k, f in filters.items()}
    pp = plan.build_plan(
        convert.parameters_from_fields(dataclasses.asdict(p)),
        PortPipelineSpec.from_shaders(pipe.shaders, pipe.data_kind),
        port_filters_, sparse_elements=sparse, device="cpu", frame_batch=B)
    assert pp.descriptor.frame_batch == B
    out = pp(torch.from_numpy(rf)).numpy()
    assert out.shape == ref.shape and out.shape[0] == B
    for b in range(B):
        assert np.abs(ref[b]).max() > 0
        assert nrmse(ref[b], out[b]) <= 1e-4


@pytest.mark.parametrize("name", ["quickstart", "uforces_coherency"])
def test_push_batch_matches_single_frames_and_jax(name):
    p, pipe, filters, sparse, raw = _case(name)
    bf = _port_beamformer(p, pipe, filters, sparse)
    frames = bf.push_batch(raw)
    assert [f.id for f in frames] == [0, 1]
    assert len(bf.get_last_frames(5)) == B
    times = bf.compute_timings().times[:B]
    n_stages = len(bf._blocks[0]._plan.descriptor.stages)
    assert (times[:, :n_stages] > 0).all()
    np.testing.assert_array_equal(times[0], times[1])

    single = _port_beamformer(p, pipe, filters, sparse)
    jbf = jax_executor.Beamformer(voxel_block=128)
    jbf.push_parameters(p)
    jbf.push_pipeline(pipe.shaders, pipe.data_kind)
    if sparse is not None:
        jbf.push_sparse_elements(sparse)
    jax_frames = jbf.push_batch(raw)
    for b in range(B):
        out = frames[b].to_numpy()
        assert nrmse(single.push_data_with_compute(raw[b]).to_numpy(),
                     out) <= 1e-6
        assert nrmse(jax_frames[b].to_numpy(), out) <= 1e-4


def test_batched_plan_cache_is_cleared_by_a_parameter_push():
    p, pipe, filters, sparse, raw = _case("quickstart")
    bf = _port_beamformer(p, pipe, filters, sparse)
    block = bf._blocks[0]
    bf.push_batch(raw)
    first = block._batched_plans[B]
    bf.push_batch(raw)
    assert block._batched_plans[B] is first       # reused while clean
    p2 = dataclasses.replace(p, f_number=1.3)
    bf.push_parameters(convert.parameters_from_fields(dataclasses.asdict(p2)))
    frames = bf.push_batch(raw)
    assert block._batched_plans[B] is not first
    assert list(block._batched_plans) == [B]
    fresh = _port_beamformer(p2, pipe, filters, sparse)
    for b in range(B):
        assert nrmse(fresh.push_data_with_compute(raw[b]).to_numpy(),
                     frames[b].to_numpy()) <= 1e-6


def test_push_batch_of_one_frame_and_bad_shapes():
    p, pipe, filters, sparse, raw = _case("quickstart")
    bf = _port_beamformer(p, pipe, filters, sparse)
    (frame,) = bf.push_batch(raw[:1])
    assert frame.output_points == (12, 16, 1)
    assert not bf._blocks[0]._batched_plans
    single = _port_beamformer(p, pipe, filters, sparse)
    np.testing.assert_array_equal(
        single.push_data_with_compute(raw[0]).to_numpy(), frame.to_numpy())
    with pytest.raises(Exception, match="raw_channels"):
        bf.push_batch(raw[0])


def test_averaged_frame_matches_jax():
    p, pipe, filters, sparse, raw = _case("plane_wave")
    p.output_points = np.array([16, 16, 1, 2], np.int32)
    bf = _port_beamformer(p, pipe, filters, sparse)
    jbf = jax_executor.Beamformer(voxel_block=128)
    jbf.push_parameters(p)
    jbf.push_pipeline(pipe.shaders, pipe.data_kind)
    for i in range(3):
        frame = raw[i % B] * (1.0 + i)
        bf.push_data_with_compute(frame)
        jbf.push_data_with_compute(frame)
    for count in (None, 3):                 # output_points.w = 2 by default
        avg = bf.averaged_frame(count)
        ref = jbf.averaged_frame(count)
        assert avg.id == ref.id == 2
        assert avg.complex
        own = np.stack([f.to_numpy() for f in bf.get_last_frames(count or 2)])
        assert nrmse(np.asarray(jax_display.sum_frames(own)),
                     avg.to_numpy()) <= 1e-6
        assert nrmse(ref.to_numpy(), avg.to_numpy()) <= 1e-4
    with pytest.raises(Exception, match="no frames"):
        _port_beamformer(p, pipe, filters, sparse).averaged_frame()


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_display_ops_match_jax(dtype):
    rng = np.random.default_rng(11)
    vol = rng.standard_normal((3, 6, 5, 7)).astype(np.float32)
    if dtype == np.complex64:
        vol = (vol + 1j * rng.standard_normal(vol.shape)).astype(dtype)
    t = torch.from_numpy(vol)
    assert nrmse(np.asarray(jax_display.sum_frames(vol)),
                 display.sum_frames(t).numpy()) <= 1e-6
    assert nrmse(np.asarray(jax_display.sum_frames(vol, 0.25)),
                 display.sum_frames(t, 0.25).numpy()) <= 1e-6
    lo, hi = display.min_max(t[0])
    jlo, jhi = jax_display.min_max(vol[0])
    assert float(lo) == pytest.approx(float(jlo), rel=1e-6)
    assert float(hi) == pytest.approx(float(jhi), rel=1e-6)
    for kw in ({}, dict(db_cutoff=-40.0, threshold=0.8, gamma=2.0)):
        ref = np.asarray(jax_display.display_map(vol[0], **kw))
        out = display.display_map(t[0], **kw).numpy()
        assert out.dtype == np.float32 and out.shape == ref.shape
        assert nrmse(ref, out) <= 1e-6
