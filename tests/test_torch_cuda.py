"""The port's CUDA kernels against their plain-torch twins on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips.  This file imports no jax,
so it runs on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int16 decode is exact (int32 accumulation on both sides);
float32 decode 1e-6 of the peak (summation order); DAS NRMSE 1e-4 (the
sample index is evaluated bit-identically, so what remains is FMA
contraction in the interpolation, summation order and libm); demodulate and
FIR NRMSE 1e-6 (every product and sum is rounded as the twin rounds it, in
the same order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu_torch import (AcquisitionKind,  # noqa: E402
                                       DataKind, FilterKind,
                                       FilterParameters, InterpolationMode,
                                       KaiserFilterParameters, Parameters,
                                       RCAOrientation, ShaderKind)
from ogl_beamforming_tpu_torch.kernels import build  # noqa: E402
from ogl_beamforming_tpu_torch.models import presets  # noqa: E402
from ogl_beamforming_tpu_torch.ops import das, decode, filtering  # noqa: E402
from ogl_beamforming_tpu_torch.ops.golden import DasParams  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    pack_tx_rx_orientation)
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)

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
    elif family in ("flash", "tpw", "vls"):
        kind, a, kw = _rca(family)
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


def _rca(kind):
    """An RCA frame: Flash, or TPW / VLS with three steering angles, mixed
    orientations and (VLS) a finite focal depth; the XDC transform moves the
    array 0.4 mm along x."""
    xdc = np.eye(4, dtype=np.float32)
    xdc[0, 3] = -0.4e-3
    cols = pack_tx_rx_orientation(RCAOrientation.Columns,
                                  RCAOrientation.Columns)
    rows = pack_tx_rx_orientation(RCAOrientation.Rows, RCAOrientation.Rows)
    kw = dict(xdc_transform=xdc, transmit_receive_orientation=cols)
    if kind == "flash":
        return AcquisitionKind.Flash, 1, kw
    depth = np.float32(np.inf if kind == "tpw" else -2e-3)
    kw.update(single_focus=False, single_orientation=False,
              focal_vectors=np.stack([np.array([-8.0, 0.0, 11.0], np.float32),
                                      np.full(3, depth)], axis=-1),
              transmit_receive_orientations=np.array([cols, rows, cols],
                                                     np.uint8))
    return (AcquisitionKind.RCA_TPW if kind == "tpw"
            else AcquisitionKind.RCA_VLS), 3, kw


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
@pytest.mark.parametrize("family", ["forces", "uforces", "readi", "flash",
                                    "tpw", "vls"])
def test_das_kernel_matches_twin(dev, family, interp, iq, coherency):
    p = _das_params(family, interp, coherency)
    rf = _rf(p, iq, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    name = "das_rca" if st.family == "rca" else "das_forces"
    before = build.LAUNCHES[name]
    out = das.das(rf, dyn, st)
    assert build.LAUNCHES[name] == before + 1
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


def _close(out, ref, tol=1e-6):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= tol


def _taps(cplx, dev, n=16):
    rng = np.random.default_rng(40 + cplx)
    h = rng.standard_normal(n).astype(np.float32)
    if cplx:
        h = (h + 1j * rng.standard_normal(n)).astype(np.complex64)
    return torch.from_numpy(h).to(dev)


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_demodulate_kernel_matches_twin(dev, dtype, cplx_taps, d):
    rng = np.random.default_rng(7)
    rf = torch.from_numpy(rng.integers(-2048, 2048, (3, 5, 1001))).to(
        device=dev, dtype=dtype)
    h = _taps(cplx_taps, dev)
    before = build.LAUNCHES["demodulate"]
    out = filtering.demodulate(rf, h, 7.8e6, 40e6, d, cplx_taps)
    assert build.LAUNCHES["demodulate"] == before + 1
    _close(out, filtering.demodulate_ref(rf, h, 7.8e6, 40e6, d, cplx_taps))


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_fir_kernel_matches_twin(dev, dtype, cplx_taps, d):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 3, 777)).astype(
        np.float32)).to(dev)
    if dtype == torch.complex64:
        x = torch.complex(x, x.flip(-1))
    h = _taps(cplx_taps, dev, n=37)
    before = build.LAUNCHES["fir"]
    out = filtering.fir_filter(x, h, d)
    assert build.LAUNCHES["fir"] == before + 1
    _close(out, filtering.fir_filter_ref(x, h, d))


def test_beamformer_cuda_matches_cpu_on_paths_a_and_b(dev):
    """Reduced path A (plane-wave Flash, Float32Complex) and path B
    (Demodulate -> Decode -> FORCES IQ DAS) on the GPU and the CPU."""
    pa, pipe_a = presets.plane_wave_2d(
        channel_count=16, sample_count=1024, output_points=(16, 16),
        lateral_mm=(-2.0, 5.0), axial_mm=(5.0, 15.0),
        data_kind=DataKind.Float32Complex)
    pb, pipe_b = presets.forces_compounding(
        channel_count=8, transmit_count=4, sample_count=512,
        output_points=(12, 16))
    pb.das_voxel_transform = das_transform_2d_xz([0, 2e-3], [7 * PITCH, 9e-3])
    fp = FilterParameters(kind=FilterKind.Kaiser, sampling_frequency=40e6,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    rng = np.random.default_rng(9)
    cases = [(pa, pipe_a, rng.standard_normal((16, 2048)).astype(np.float32)),
             (pb, pipe_b, rng.integers(-2048, 2048, (8, 4 * 512),
                                       dtype=np.int16))]
    for p, pipe, raw in cases:
        frames = []
        for device in ("cpu", dev):
            bf = Beamformer(device=device)
            bf.create_filter(fp, filter_slot=0)
            bf.push_parameters(p)
            bf.push_pipeline(pipe.shaders, pipe.data_kind)
            frames.append(bf.push_data_with_compute(raw).to_numpy())
        assert np.abs(frames[0]).max() > 0
        assert nrmse(frames[0], frames[1]) <= 1e-4


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
