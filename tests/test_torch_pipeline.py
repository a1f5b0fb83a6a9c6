"""The port's slice end to end on the CPU: raw int16 -> Decode -> FORCES DAS
through ``ogl_beamforming_tpu_torch``'s Beamformer vs the JAX package's
Beamformer (XLA) and its Pallas kernels in interpret mode, on the same
numpy-seeded raw frame; planner parity on every preset; plan parameters
converted from a JAX plan; and the no-fallback and JAX-free guarantees.

Tolerances (NRMSE): 1e-4 against the JAX XLA pipeline (the same f32
arithmetic in another summation order), 2e-4 against the Pallas pipeline
(its int16 line quantisation and polynomial apodization), 1e-3 against the
golden composition.
"""

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
    AcquisitionKind, DataKind, FilterKind, InterpolationMode, ShaderKind)
from ogl_beamforming_tpu.params.types import (  # noqa: E402
    FilterParameters, KaiserFilterParameters, Parameters)
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.pipeline import plan as jax_plan  # noqa: E402
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu.utils.filters import make_filter  # noqa: E402
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import das_transform_2d_xz  # noqa: E402
from ogl_beamforming_tpu.utils.zbp import load_zbp  # noqa: E402
from ogl_beamforming_tpu_torch.convert import dyn_from_numpy  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline import executor, plan  # noqa: E402

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
    rng = np.random.default_rng(0x5EED + int(kind))
    return rng.integers(-1024, 1024, (C, A * S * kind.element_count)
                        ).astype(np.int16)


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


def _port_frame(p, kind, raw):
    bf = executor.Beamformer(device="cpu")
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], kind)
    frame = bf.push_data_with_compute(raw)
    times = bf.compute_timings().times[0]
    assert times[0] > 0 and times[1] > 0        # decode, DAS stage times
    return frame


@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Int16Complex])
def test_beamformer_matches_jax(kind):
    p = _params()
    raw = _raw(kind)
    frame = _port_frame(p, kind, raw)
    assert frame.output_points == (12, 16, 1)
    assert frame.complex == kind.is_complex

    jbf = jax_executor.Beamformer(voxel_block=128)
    jbf.push_parameters(p)
    jbf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], kind)
    ref = jbf.push_data_with_compute(raw).to_numpy()
    out = frame.to_numpy()
    assert nrmse(ref, out) <= 1e-4
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


def _kaiser(fs):
    return make_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16)))


def _preset_cases():
    zbp = load_zbp(os.path.join(REPO, "tests", "data", "point_targets.zbp"))
    uf = presets.uforces_volumetric()
    return {
        "decode_benchmark": presets.decode_benchmark(),
        "plane_wave_2d": presets.plane_wave_2d(),
        "plane_wave_iq": presets.plane_wave_2d(
            data_kind=DataKind.Float32Complex),
        "forces_demod": presets.forces_compounding(),
        "forces": presets.forces_compounding(demodulate=False),
        "uforces_volumetric": uf[:2],
        "hercules_3d": presets.hercules_3d(),
        "from_zbp": presets.from_zbp(zbp, output_points=(16, 32)),
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


def _assert_dyn_equal(ours, ref, path=""):
    assert set(ours) == set(ref), path
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_dyn_equal(ours[k], ref[k], f"{path}{k}.")
        else:
            assert ours[k].dtype == ref[k].dtype, f"{path}{k}"
            assert torch.equal(ours[k], ref[k]), f"{path}{k}"


@pytest.mark.parametrize("kind", [AcquisitionKind.FORCES,
                                  AcquisitionKind.UFORCES])
def test_dyn_from_numpy_matches_build_plan(kind):
    extra = {}
    if kind == AcquisitionKind.FORCES:
        extra = dict(readi_group_count=2, readi_group=1)
    p = _params(acquisition_kind=kind, **extra)
    pipe = PipelineSpec.from_shaders([ShaderKind.Decode, ShaderKind.DAS],
                                     DataKind.Int16)
    sparse = np.array([1, 3, 5, 7], np.int16)
    jp = jax_plan.build_plan(p, pipe, {}, sparse_elements=sparse,
                             das_backend="xla")
    ours = plan.build_plan(p, pipe, {}, sparse_elements=sparse).dyn
    ref = dyn_from_numpy(jax.tree.map(np.asarray, jp.dyn))
    _assert_dyn_equal(ours, ref)


def test_unported_stage_raises_at_plan_build():
    p = _params()
    bf = executor.Beamformer(device="cpu")
    bf.create_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=10e6,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16)), filter_slot=0)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Demodulate, ShaderKind.Decode,
                      ShaderKind.DAS], DataKind.Int16)
    with pytest.raises(NotImplementedError, match="Demodulate"):
        bf.push_data_with_compute(_raw(DataKind.Int16))


def test_cuda_beamformer_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        executor.Beamformer(device="cuda")


def test_port_imports_no_jax():
    """Importing every module of the port loads no jax (a subprocess: this
    test process already imported jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ogl_beamforming_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
