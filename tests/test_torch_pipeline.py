"""The port's paths end to end on the CPU, through the port's Beamformer
against the JAX package's Beamformer (XLA), its Pallas kernels in
interpret mode and the golden composition, on the same numpy-seeded raw
frames:

  * raw int16 -> Decode -> FORCES DAS (the Quickstart's path), and the
    same on Int16Complex and real Float16 wire data;
  * path A, the plane-wave headline reduced: Float32Complex wire -> RCA
    Flash DAS (NoDecode);
  * path B, the demodulate chain reduced: int16 -> Demodulate (Kaiser) ->
    Decode -> FORCES IQ DAS;
  * [Decode, Filter (complex MatchedChirp), DAS] on Int16Complex wire data
    and [Decode, Hilbert, DAS] on int16 (a pipeline starts with Decode or
    Demodulate, pipeline/spec.py);
  * path C, HERCULES 3D reduced: int16 -> Decode -> HERCULES DAS;
  * path D, uFORCES 3D with coherency weighting reduced: int16 -> Decode ->
    UFORCES DAS over the sparse transmits -> coherency weighting.

Also: planner parity on every preset, plan parameters converted from a JAX
plan, the port's parameter copies against the JAX package's (presets,
filters, Hadamard/Walsh, output dimensions, prepare_rf, the parameter
converter), and the device and JAX-free guarantees.

Tolerances (NRMSE): 1e-4 against the JAX XLA pipeline (the same f32
arithmetic in another summation order), 2e-4 against the Pallas pipeline
(its int16 line quantisation and polynomial apodization), 1e-3 against the
golden composition.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.models import presets  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, ContrastMode, DataKind, FilterKind, InterpolationMode,
    ShaderKind)
from ogl_beamforming_tpu.params.types import (  # noqa: E402
    FilterParameters, KaiserFilterParameters, MatchedChirpFilterParameters,
    Parameters)
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.pipeline import plan as jax_plan  # noqa: E402
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu.runtime.upload import prepare_rf  # noqa: E402
from ogl_beamforming_tpu.utils.filters import make_filter  # noqa: E402
from ogl_beamforming_tpu.utils.hadamard import hadamard, walsh  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_output_dimension, das_transform_2d_xz, das_transform_3d)
from ogl_beamforming_tpu.utils.zbp import load_zbp  # noqa: E402
from ogl_beamforming_tpu_torch import convert  # noqa: E402
from ogl_beamforming_tpu_torch.models import presets as port_presets  # noqa: E402
from ogl_beamforming_tpu_torch.ops import filtering as port_filtering  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline import executor, plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import (  # noqa: E402
    PipelineSpec as PortPipelineSpec)
from ogl_beamforming_tpu_torch.runtime.upload import (  # noqa: E402
    prepare_rf as port_prepare_rf)
from ogl_beamforming_tpu_torch.utils import filters as port_filters  # noqa: E402
from ogl_beamforming_tpu_torch.utils import hadamard as port_hadamard  # noqa: E402
from ogl_beamforming_tpu_torch.utils import transforms as port_transforms  # noqa: E402

torch.set_num_threads(1)

C, A, S, PITCH = 8, 4, 256, 0.3e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(**kw) -> Parameters:
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
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _raw(kind: DataKind):
    """Integer-valued raw data of ``kind``'s wire type (float16 holds
    these integers exactly)."""
    rng = np.random.default_rng(0x5EED + int(kind))
    return rng.integers(-1024, 1024, (C, A * S * kind.element_count)
                        ).astype(np.float16 if kind == DataKind.Float16
                                 else np.int16)


def _golden(raw, kind, p):
    rf = raw.reshape(C, A, -1).astype(np.float32)
    if kind.is_complex:
        rf = (rf[..., 0::2] + 1j * rf[..., 1::2]).astype(np.complex64)
    dec = golden.decode_hadamard(rf, hadamard(A))
    dp = golden.DasParams(
        acquisition_kind=p.acquisition_kind, acquisition_count=A,
        channel_count=C, sample_count=S, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0, time_offset=1e-7,
        interpolation_mode=p.interpolation_mode, f_number=0.8,
        voxel_transform=np.asarray(p.das_voxel_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=(12, 16, 1))
    return golden.das(dec, dp)


def _run(bf, p, shaders, kind, raw, filters=(), focal_vectors=None,
         sparse_elements=None):
    """Configure a Beamformer of either package the same way and run one
    frame; the port gets the parameter blocks through ``convert``."""
    port = isinstance(bf, executor.Beamformer)
    for slot, fp in filters:
        if port:
            fp = convert.filter_parameters_from_fields(dataclasses.asdict(fp))
        bf.create_filter(fp, filter_slot=slot)
    bf.push_parameters(convert.parameters_from_fields(dataclasses.asdict(p))
                       if port else p)
    bf.push_pipeline(shaders, kind)
    if focal_vectors is not None:
        bf.push_focal_vectors(focal_vectors)
    if sparse_elements is not None:
        bf.push_sparse_elements(sparse_elements)
    return bf.push_data_with_compute(raw)


def _port_frame(p, kind, raw, shaders=(ShaderKind.Decode, ShaderKind.DAS),
                **kw):
    bf = executor.Beamformer(device="cpu")
    frame = _run(bf, p, list(shaders), kind, raw, **kw)
    times = bf.compute_timings().times[0]
    assert (times[:len(bf._blocks[0]._plan.descriptor.stages)] > 0).all()
    return frame


def _jax_frame(p, kind, raw, shaders=(ShaderKind.Decode, ShaderKind.DAS),
               **kw):
    jbf = jax_executor.Beamformer(voxel_block=128)
    return _run(jbf, p, list(shaders), kind, raw, **kw).to_numpy()


@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Int16Complex,
                                  DataKind.Float16])
def test_beamformer_matches_jax(kind):
    p = _params()
    raw = _raw(kind)
    frame = _port_frame(p, kind, raw)
    assert frame.output_points == (12, 16, 1)
    assert frame.complex == kind.is_complex
    out = frame.to_numpy()
    assert nrmse(_jax_frame(p, kind, raw), out) <= 1e-4
    assert nrmse(_golden(raw, kind, p), out) <= 1e-3


def test_pipeline_matches_pallas_interpret():
    """The flagship FORCES cubic decode -> DAS through the JAX planner with
    both Pallas kernels in interpret mode."""
    p = _params()
    raw = _raw(DataKind.Int16)
    out = _port_frame(p, DataKind.Int16, raw).to_numpy()
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16)
    jp = jax_plan.build_plan(p, pipe, {}, das_backend="pallas_interpret")
    ref = np.asarray(jax_plan.compose_stages(
        jp.descriptor, raw.reshape(C, A, S), jp.dyn))
    assert nrmse(ref, out) <= 2e-4


# ---------------------------------------------------------------------------
# Paths A and B, reduced, and the Filter and Hilbert stages
# ---------------------------------------------------------------------------

def _golden_das(p, rf, sample_count, fs, time_offset, vt=None, **kw):
    """Golden DAS of ``rf`` (C, A, S') with ``p``'s geometry at the DAS
    stage's sample count, rate and time offset (``kw``: further
    ``DasParams`` fields)."""
    return golden.das(rf, golden.DasParams(
        acquisition_kind=p.acquisition_kind,
        acquisition_count=p.acquisition_count,
        channel_count=p.channel_count, sample_count=sample_count,
        sampling_frequency=fs,
        demodulation_frequency=p.demodulation_frequency,
        speed_of_sound=p.speed_of_sound, time_offset=time_offset,
        interpolation_mode=p.interpolation_mode, f_number=p.f_number,
        voxel_transform=np.asarray(p.das_voxel_transform
                                   if vt is None else vt),
        xdc_transform=np.asarray(p.xdc_transform),
        xdc_element_pitch=np.asarray(p.xdc_element_pitch),
        output_points=tuple(das_output_dimension(p.output_points[:3])),
        transmit_receive_orientation=p.transmit_receive_orientation,
        transmit_angle=float(p.focal_vector[0]),
        focus_depth=float(p.focal_vector[1]), **kw))


def _path_a():
    """Plane-wave Flash on Float32Complex wire data, 16 ch x 1024 complex
    samples -> 16 x 16 voxels (the preset's widths cut)."""
    p, pipe = presets.plane_wave_2d(
        channel_count=16, sample_count=1024, output_points=(16, 16),
        lateral_mm=(-2.0, 5.0), axial_mm=(5.0, 15.0),
        data_kind=DataKind.Float32Complex)
    rng = np.random.default_rng(0xA)
    raw = rng.standard_normal((16, 2 * 1024)).astype(np.float32)
    return p, pipe, raw


def test_path_a_plane_wave_matches_jax_and_golden():
    p, pipe, raw = _path_a()
    frame = _port_frame(p, pipe.data_kind, raw, pipe.shaders)
    assert frame.output_points == (16, 16, 1) and frame.complex
    out = frame.to_numpy()
    rf = (raw[:, 0::2] + 1j * raw[:, 1::2]).astype(np.complex64)[:, None]
    ref = _golden_das(p, rf, 1024, p.sampling_frequency, p.time_offset)
    assert np.abs(ref).max() > 0
    assert nrmse(_jax_frame(p, pipe.data_kind, raw, pipe.shaders), out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def _kaiser_fp(fs):
    return FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=fs,
                            kaiser=KaiserFilterParameters(2e6, 4.0, 16))


def _chirp_fp(fs):
    return FilterParameters(
        kind=FilterKind.MatchedChirp, sampling_frequency=fs, complex=True,
        matched_chirp=MatchedChirpFilterParameters(1e-6, 3e6, 7e6))


def _path_b():
    """forces_compounding with demodulation, 8 ch x 4 tx x 512 int16
    samples -> 12 x 16 voxels (widths and depth cut)."""
    p, pipe = presets.forces_compounding(
        channel_count=C, transmit_count=A, sample_count=512,
        output_points=(12, 16))
    p.das_voxel_transform = das_transform_2d_xz([0, 2e-3],
                                                [(C - 1) * PITCH, 9e-3])
    return p, pipe


def test_path_b_demodulate_chain_matches_jax_and_golden():
    p, pipe = _path_b()
    fp = _kaiser_fp(p.sampling_frequency)
    raw = np.random.default_rng(0xB).integers(
        -2048, 2048, (C, A * 512)).astype(np.int16)
    frame = _port_frame(p, pipe.data_kind, raw, pipe.shaders,
                        filters=[(0, fp)])
    assert frame.output_points == (12, 16, 1) and frame.complex
    out = frame.to_numpy()
    filt = make_filter(fp)
    iq = golden.demodulate(raw.reshape(C, A, 512), filt.taps,
                           p.demodulation_frequency, p.sampling_frequency)
    dec = golden.decode_hadamard(iq, hadamard(A))
    ref = _golden_das(p, dec, 256, p.sampling_frequency / 2,
                      p.time_offset + filt.time_delay)
    assert np.abs(ref).max() > 0
    jax_out = _jax_frame(p, pipe.data_kind, raw, pipe.shaders,
                         filters=[(0, fp)])
    assert nrmse(jax_out, out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


@pytest.mark.parametrize("shaders", [
    (ShaderKind.Decode, ShaderKind.Filter, ShaderKind.DAS),
    (ShaderKind.Decode, ShaderKind.Hilbert, ShaderKind.DAS)],
    ids=["filter_chirp", "hilbert"])
def test_filter_and_hilbert_stages_match_jax_and_golden(shaders):
    """The complex matched filter runs on baseband (Int16Complex wire) data,
    the Hilbert transform on real data."""
    p = _params()
    fp = _chirp_fp(p.sampling_frequency)
    filtered = ShaderKind.Filter in shaders
    kind = DataKind.Int16Complex if filtered else DataKind.Int16
    raw = _raw(kind)
    kw = dict(filters=[(0, fp)]) if filtered else {}
    out = _port_frame(p, kind, raw, shaders, **kw).to_numpy()
    rf = raw.reshape(C, A, -1).astype(np.float32)
    if filtered:
        rf = (rf[..., 0::2] + 1j * rf[..., 1::2]).astype(np.complex64)
    t0 = p.time_offset
    dec = golden.decode_hadamard(rf, hadamard(A))
    if filtered:
        filt = make_filter(fp)
        dec = golden.fir_filter(dec, filt.taps)
        t0 += filt.time_delay
    else:
        dec = golden.hilbert(dec)
    ref = _golden_das(p, dec, S, p.sampling_frequency, t0)
    assert np.abs(ref).max() > 0
    assert nrmse(_jax_frame(p, kind, raw, shaders, **kw), out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def _path_c_or_d(path):
    """Path C, ``presets.hercules_3d`` (8 ch x 8 tx x 256 int16 -> 6 x 5 x 7),
    or path D, ``presets.uforces_volumetric`` (8 ch x 8 acquisitions x 256,
    7 sparse transmits, coherency weighting -> 6 x 5 x 7): widths and depth
    cut, the voxel grid moved up to the first 4 mm under the array."""
    c, a, s = 8, 8, 256
    ap = (c - 1) * PITCH
    if path == "C":
        p, pipe = presets.hercules_3d(channel_count=c, acquisition_count=a,
                                      sample_count=s, output_points=(6, 5, 7))
        p.das_voxel_transform = das_transform_3d([0, 0, 1e-3], [ap, ap, 4e-3])
        sparse = None
    else:
        p, pipe, sparse = presets.uforces_volumetric(
            channel_count=c, acquisition_count=a, sample_count=s,
            output_points=(6, 5, 7))
        p.das_voxel_transform = das_transform_3d([0, -ap / 2, 1e-3],
                                                 [ap, ap / 2, 4e-3])
    raw = np.random.default_rng(ord(path)).integers(
        -2048, 2048, (c, a * s)).astype(np.int16)
    return p, pipe, sparse, raw


@pytest.mark.parametrize("path", ["C", "D"])
def test_paths_c_and_d_match_jax_and_golden(path):
    p, pipe, sparse, raw = _path_c_or_d(path)
    c, a = p.channel_count, p.acquisition_count
    kw = dict(sparse_elements=sparse)
    frame = _port_frame(p, pipe.data_kind, raw, pipe.shaders, **kw)
    assert frame.output_points == (6, 5, 7) and not frame.complex
    out = frame.to_numpy()
    dec = golden.decode_hadamard(raw.reshape(c, a, -1), hadamard(a))
    extra = {} if sparse is None else dict(
        sparse=True, sparse_elements=sparse, coherency_weighting=True)
    ref = _golden_das(p, dec, p.sample_count, p.sampling_frequency,
                      p.time_offset, **extra)
    if sparse is not None:
        ref = golden.coherency_weighting(*ref)
    assert np.abs(ref).max() > 0
    assert nrmse(_jax_frame(p, pipe.data_kind, raw, pipe.shaders, **kw),
                 out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def test_warmup_runs_float32_complex_wire_data():
    p, pipe, _ = _path_a()
    bf = executor.Beamformer(device="cpu")
    bf.push_parameters(convert.parameters_from_fields(dataclasses.asdict(p)))
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    frame = bf.warmup()
    assert frame.output_points == (16, 16, 1) and frame.complex
    assert not frame.to_numpy().any()


# ---------------------------------------------------------------------------
# Planner and parameter parity
# ---------------------------------------------------------------------------

def _kaiser(fs):
    return make_filter(_kaiser_fp(fs))


def _preset_cases(pkg=presets):
    zbp = load_zbp(os.path.join(REPO, "tests", "data", "point_targets.zbp"))
    uf = pkg.uforces_volumetric()
    return {
        "decode_benchmark": pkg.decode_benchmark(),
        "plane_wave_2d": pkg.plane_wave_2d(),
        "plane_wave_iq": pkg.plane_wave_2d(
            data_kind=DataKind.Float32Complex),
        "forces_demod": pkg.forces_compounding(),
        "forces": pkg.forces_compounding(demodulate=False),
        "uforces_volumetric": uf[:2],
        "hercules_3d": pkg.hercules_3d(),
        "from_zbp": pkg.from_zbp(zbp, output_points=(16, 32)),
    }


@pytest.mark.parametrize("name", list(_preset_cases()))
def test_plan_stages_parity(name):
    params, pipe = _preset_cases()[name]
    filters = {0: _kaiser(params.sampling_frequency / 2)}
    ours = plan._plan_stages(params, pipe, filters)
    ref = jax_plan._plan_stages(params, pipe, filters)
    fields = ("kind", "filter_length", "filter_complex", "decimation_rate")
    assert [[getattr(sd, f) for f in fields] for sd in ours[0]] == \
        [[getattr(sd, f) for f in fields] for sd in ref[0]]
    assert ours[1:] == ref[1:]


def _assert_fields_equal(ours, ref, path=""):
    """Two values of the two packages' parameter types are equal field by
    field: arrays by dtype and value, enums as ints."""
    if dataclasses.is_dataclass(ref):
        assert type(ours).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ref):
            _assert_fields_equal(getattr(ours, f.name), getattr(ref, f.name),
                                 f"{path}.{f.name}")
    elif isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    elif isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref), path
        for i, (o, r) in enumerate(zip(ours, ref)):
            _assert_fields_equal(o, r, f"{path}[{i}]")
    else:
        assert type(ours).__name__ == type(ref).__name__, path
        assert ours == ref, path


@pytest.mark.parametrize("name", list(_preset_cases()))
def test_presets_equal_the_jax_package(name):
    ours = _preset_cases(port_presets)[name]
    ref = _preset_cases()[name]
    _assert_fields_equal(ours[0], ref[0], "parameters")
    assert isinstance(ours[1], PortPipelineSpec)
    assert [(int(s.kind), s.parameter) for s in ours[1].stages] == \
        [(int(s.kind), s.parameter) for s in ref[1].stages]
    assert int(ours[1].data_kind) == int(ref[1].data_kind)


@pytest.mark.parametrize("name", list(_preset_cases()))
def test_convert_parameters_round_trip(name):
    """The JAX package's block crosses into the port's unchanged, and the
    port's own block converts to itself."""
    ours = _preset_cases(port_presets)[name][0]
    ref = _preset_cases()[name][0]
    crossed = convert.parameters_from_fields(dataclasses.asdict(ref))
    assert isinstance(crossed, type(ours))
    _assert_fields_equal(crossed, ours)
    _assert_fields_equal(
        convert.parameters_from_fields(dataclasses.asdict(ours)), ours)


@pytest.mark.parametrize("fp", [
    _kaiser_fp(40e6), _chirp_fp(20e6),
    dataclasses.replace(_chirp_fp(20e6), complex=False)],
    ids=["kaiser", "chirp_complex", "chirp_real"])
def test_make_filter_equals_the_jax_package(fp):
    ours = port_filters.make_filter(
        convert.filter_parameters_from_fields(dataclasses.asdict(fp)))
    ref = make_filter(fp)
    assert ours.taps.dtype == ref.taps.dtype
    np.testing.assert_array_equal(ours.taps, ref.taps)
    assert ours.time_delay == ref.time_delay
    _assert_fields_equal(ours.parameters, ref.parameters)


def test_hadamard_walsh_and_output_dimension_equal_the_jax_package():
    for n in (2, 4, 12, 16, 20, 24, 40, 128):
        np.testing.assert_array_equal(port_hadamard.hadamard(n), hadamard(n))
    for n in (2, 8, 64):
        np.testing.assert_array_equal(port_hadamard.walsh(n), walsh(n))
    for pts in ((512, 1024, 1), (1, 300, 1), (96, 96, 96), (64, 1, 32),
                (0, 0, 7)):
        np.testing.assert_array_equal(
            port_transforms.das_output_dimension(pts),
            das_output_dimension(pts))


@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Float32Complex])
@pytest.mark.parametrize("contrast", [ContrastMode.NoContrast,
                                      ContrastMode.A1S2])
def test_prepare_rf_equals_the_jax_package(kind, contrast):
    rng = np.random.default_rng(int(kind) + 7 * int(contrast))
    c, a, s = 6, 3, 10
    mapping = rng.permutation(8).astype(np.int16)
    dt = np.int16 if kind == DataKind.Int16 else np.float32
    raw = (rng.standard_normal((8, 3 * a * s * kind.element_count)) * 100
           ).astype(dt)
    ours = port_prepare_rf(raw, mapping, c, a, s, contrast, kind)
    ref = prepare_rf(raw, mapping, c, a, s, contrast, kind)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


def _assert_dyn_equal(ours, ref, path=""):
    assert set(ours) == set(ref), path
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_dyn_equal(ours[k], ref[k], f"{path}{k}.")
        else:
            assert ours[k].dtype == ref[k].dtype, f"{path}{k}"
            assert torch.equal(ours[k], ref[k]), f"{path}{k}"


@pytest.mark.parametrize("case", [AcquisitionKind.FORCES,
                                  AcquisitionKind.UFORCES, "demod", "flash"])
def test_dyn_from_numpy_matches_build_plan(case):
    shaders = [ShaderKind.Decode, ShaderKind.DAS]
    filters = {}
    extra = {}
    if case == AcquisitionKind.FORCES:
        extra = dict(readi_group_count=2, readi_group=1)
    elif case == AcquisitionKind.UFORCES:
        extra = dict(acquisition_kind=AcquisitionKind.UFORCES)
    elif case == "demod":
        shaders = [ShaderKind.Demodulate] + shaders
        filters = {0: make_filter(_chirp_fp(10e6))}
    else:
        p, pipe, _ = _path_a()
        extra = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
        shaders = pipe.shaders
    p = _params(**extra)
    kind = (DataKind.Float32Complex if case == "flash" else DataKind.Int16)
    sparse = np.array([1, 3, 5, 7], np.int16)
    jp = jax_plan.build_plan(p, PipelineSpec.from_shaders(shaders, kind),
                             filters, sparse_elements=sparse,
                             das_backend="xla")
    port_filters_ = {k: port_filters.make_filter(
        convert.filter_parameters_from_fields(
            dataclasses.asdict(f.parameters))) for k, f in filters.items()}
    ours = plan.build_plan(
        convert.parameters_from_fields(dataclasses.asdict(p)),
        PortPipelineSpec.from_shaders(shaders, kind), port_filters_,
        sparse_elements=sparse, device="cpu").dyn
    ref = convert.dyn_from_numpy(jax.tree.map(np.asarray, jp.dyn), "cpu")
    if case == "demod":
        # the one key the port adds: the Demodulate stage's rotation table,
        # built once per plan from the JAX plan's own frequencies
        omega = port_filtering.demod_omega(ref["demodulation_frequency"],
                                           ref["sampling_frequency"], "cpu")
        assert torch.equal(ours.pop("phasor0"), port_filtering.demod_phasor(
            omega, p.sample_count // 2))
    _assert_dyn_equal(ours, ref)


# ---------------------------------------------------------------------------
# Devices, and what the port imports
# ---------------------------------------------------------------------------

def test_cuda_beamformer_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        executor.Beamformer(device="cuda")


def test_entry_points_default_to_the_gpu():
    """``Beamformer()`` and ``build_plan()`` ask for the GPU unless told
    otherwise: without one they raise, they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        executor.Beamformer()
    p, pipe = port_presets.forces_compounding(demodulate=False)
    with pytest.raises(RuntimeError, match="cuda"):
        plan.build_plan(p, pipe, {})


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor any module
    of the JAX package (a subprocess: this test process imported both)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ogl_beamforming_tpu_torch as pkg\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "want = {'ogl_beamforming_tpu_torch.utils.profiling',\n"
        "        'ogl_beamforming_tpu_torch.runtime.streaming',\n"
        "        'ogl_beamforming_tpu_torch.runtime.abi',\n"
        "        'ogl_beamforming_tpu_torch.runtime.server',\n"
        "        'ogl_beamforming_tpu_torch.runtime.hotreload',\n"
        "        'ogl_beamforming_tpu_torch.params.codegen',\n"
        "        'ogl_beamforming_tpu_torch.utils.zbp',\n"
        "        'ogl_beamforming_tpu_torch.viewer',\n"
        "        'ogl_beamforming_tpu_torch.viewer_xplane',\n"
        "        'ogl_beamforming_tpu_torch.viewer_web',\n"
        "        'ogl_beamforming_tpu_torch.entry',\n"
        "        'ogl_beamforming_tpu_torch.pretune',\n"
        "        'ogl_beamforming_tpu_torch.parallel.sharding',\n"
        "        'ogl_beamforming_tpu_torch.parallel.multihost'} | {\n"
        "    'ogl_beamforming_tpu_torch.examples.' + n for n in (\n"
        "        'throughput', 'decode_sweep', 'point_scatterer',\n"
        "        'live_streaming', 'multihost_feeders')} | {\n"
        "    'ogl_beamforming_tpu_torch.experiments.' + n for n in (\n"
        "        'gather_micro', 'gather_micro2', 'gather_micro3',\n"
        "        'onehot_micro', 'onehot_micro2', 'probe_i8', 'probe_i8b',\n"
        "        'mesh_sweep')}\n"
        "assert want <= names, want - names\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "bad = [m for m in sys.modules if m == 'ogl_beamforming_tpu'\n"
        "       or m.startswith('ogl_beamforming_tpu.')\n"
        "       or m == 'experiments' or m.startswith('experiments.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
