"""The port's CUDA kernels against their plain-torch twins on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips.  This file imports no jax,
so it runs on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int16 decode is exact (int32 accumulation on both sides);
float32 decode 1e-6 of the peak (summation order); DAS NRMSE 1e-4 (the
sample index is evaluated bit-identically, so what remains is FMA
contraction in the interpolation, summation order and libm).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu_torch import (AcquisitionKind,  # noqa: E402
                                       DataKind, InterpolationMode,
                                       Parameters, ShaderKind)
from ogl_beamforming_tpu_torch.ops import das, das_cuda, decode  # noqa: E402
from ogl_beamforming_tpu_torch.ops.golden import DasParams  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402

pytestmark = pytest.mark.cuda

PITCH = 0.3e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("a", [2, 4, 12, 16, 20, 128, 256])
def test_decode_int16_exact(dev, a):
    rng = np.random.default_rng(a)
    rf = torch.from_numpy(rng.integers(-32768, 32767, (3, a, 1000),
                                       dtype=np.int16)).to(dev)
    h = decode.hadamard_matrix(a, device=dev)
    assert torch.equal(decode.decode_hadamard(rf, h),
                       decode.decode_hadamard_ref(rf, h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_decode_float_and_complex(dev, dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 32, 700)).astype(np.float32)
    rf = torch.from_numpy(x).to(dev)
    if dtype == torch.complex64:
        rf = torch.complex(rf, torch.from_numpy(x[::-1].copy()).to(dev))
    h = decode.hadamard_matrix(32, device=dev)
    out = decode.decode_hadamard(rf, h)
    ref = decode.decode_hadamard_ref(rf, h)
    assert out.dtype == dtype and out.shape == rf.shape
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-6


def test_decode_rejects_unsupported_dtype(dev):
    rf = torch.zeros((2, 4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        decode.decode_hadamard(rf, decode.hadamard_matrix(4, device=dev))


def _das_params(family, interp, coherency, points=(12, 16, 1)):
    kw, a, kind = {}, 4, AcquisitionKind.FORCES
    if family == "uforces":
        a, kind = 5, AcquisitionKind.UFORCES
        kw = dict(sparse=True,
                  sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    elif family == "readi":
        kw = dict(readi_group_count=2, readi_group=1,
                  das_hadamard=np.array([[1, 1], [1, -1]], np.float32))
    vt = np.zeros((4, 4), np.float32)
    vt[0, 0], vt[2, 1], vt[2, 3], vt[3, 3] = 7 * PITCH, 7e-3, 1e-3, 1.0
    return DasParams(
        acquisition_kind=kind, acquisition_count=a, channel_count=8,
        sample_count=256, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0, time_offset=1e-7,
        f_number=0.8, voxel_transform=vt,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=points, interpolation_mode=interp,
        coherency_weighting=coherency, **kw)


def _rf(p, iq, dev):
    rng = np.random.default_rng(p.acquisition_count + 2 * iq)
    x = rng.standard_normal((8, p.acquisition_count, 256)).astype(np.float32)
    rf = torch.from_numpy(x).to(dev)
    if iq:
        rf = torch.complex(rf, torch.from_numpy(x[:, :, ::-1].copy()).to(dev))
    return rf


def _compare(out, ref):
    if isinstance(ref, tuple):
        for o, r in zip(out, ref):
            assert nrmse(r.cpu().numpy(), o.cpu().numpy()) <= 1e-4
    else:
        assert out.dtype == ref.dtype and out.shape == ref.shape
        assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= 1e-4


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("family", ["forces", "uforces", "readi"])
def test_das_kernel_matches_twin(dev, family, interp, iq, coherency):
    p = _das_params(family, interp, coherency)
    rf = _rf(p, iq, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    before = das_cuda.LAUNCHES
    out = das.das(rf, dyn, st)
    assert das_cuda.LAUNCHES == before + 1
    _compare(out, das.das_ref(rf, dyn, st))


def test_das_kernel_slab_offsets(dev):
    """A slab of a larger grid (x_offset, global_points) read from a
    channel shard (channel_offset), as a sharded run would."""
    import dataclasses
    p = _das_params("forces", InterpolationMode.Cubic, False, (6, 16, 1))
    rf = _rf(p, False, dev)[:5]
    dyn = das.make_dynamic(p, dev)
    dyn["channel_offset"] = torch.tensor(3, dtype=torch.int32, device=dev)
    dyn["x_offset"] = torch.tensor(4, dtype=torch.int32, device=dev)
    st = dataclasses.replace(das.make_static(p, iq=False),
                             global_points=(12, 16, 1))
    _compare(das.das(rf, dyn, st), das.das_ref(rf, dyn, st))


def test_beamformer_cuda_matches_cpu(dev):
    p = Parameters(
        sample_count=256, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=_das_params(
            "forces", InterpolationMode.Cubic, False).voxel_transform,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    raw = np.random.default_rng(3).integers(-1024, 1024, (8, 4 * 256),
                                            dtype=np.int16)
    frames = []
    for device in ("cpu", dev):
        bf = Beamformer(device=device)
        bf.push_parameters(p)
        bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
        frames.append(bf.push_data_with_compute(raw).to_numpy())
    assert nrmse(frames[0], frames[1]) <= 1e-4
