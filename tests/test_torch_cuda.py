"""The port's CUDA kernels against their plain-torch twins on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test skips.  This file imports no jax,
so it runs on a GPU machine without the JAX package's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int16 decode is exact (int32 accumulation on both sides);
float32 decode 1e-6 of the peak (summation order); DAS NRMSE 1e-4 (the
sample index is evaluated bit-identically, so what remains is FMA
contraction in the interpolation, summation order and libm); a frame of a
four-frame DAS launch against a single-frame launch on it 1e-6 (the same
arithmetic); demodulate and FIR NRMSE 1e-6 (every product and sum is
rounded as the twin rounds it, in the same order).
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
from ogl_beamforming_tpu_torch.ops import (  # noqa: E402
    das, das_cuda, decode, filtering)
from ogl_beamforming_tpu_torch.ops.golden import DasParams  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    pack_tx_rx_orientation)
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz, das_transform_3d)

pytestmark = pytest.mark.cuda

PITCH = 0.3e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("a", [2, 4, 12, 16, 20, 32, 64, 128, 256])
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


@pytest.mark.parametrize("s", [64, 999, 1000, 4097])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("a", [12, 16, 20, 32, 64, 128, 256])
def test_decode_int16_edges(dev, a, c, s):
    """Bit-equal at every order the paths use, C = 1 and odd C, sample
    counts off the kernel's 64-sample tile and off its 16-byte copies (999:
    rows not 16-byte aligned), with the int16 extremes in every row."""
    rng = np.random.default_rng(1000 * a + 10 * c + s % 7)
    x = rng.integers(-32768, 32768, (c, a, s)).astype(np.int16)
    x[:, :, 0] = -32768
    x[:, :, -1] = 32767
    x[:, ::2, s // 2] = -32768
    x[:, 1::2, s // 2] = 32767
    rf = torch.from_numpy(x).to(dev)
    h = decode.hadamard_matrix(a, device=dev)
    before = build.LAUNCHES["decode_hadamard"]
    out = decode.decode_hadamard(rf, h)
    assert build.LAUNCHES["decode_hadamard"] == before + 1
    assert torch.equal(out, decode.decode_hadamard_ref(rf, h))


def test_decode_int16_all_extremes(dev):
    """Every product at its extreme: H's rows against +-32768 and 32767."""
    h = decode.hadamard_matrix(128, device=dev)
    signs = h[3].to(torch.int32)
    x = torch.where(signs > 0, 32767, -32768).to(torch.int16)
    rf = x[None, :, None].expand(2, 128, 130).contiguous()
    assert torch.equal(decode.decode_hadamard(rf, h),
                       decode.decode_hadamard_ref(rf, h))


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("c, a, s", [(1, 12, 999), (3, 20, 1000),
                                     (1, 64, 4097), (3, 128, 2048),
                                     (1, 256, 700)])
def test_decode_float_orders(dev, dtype, c, a, s):
    """float32 and complex64 at 1e-6 of the peak, across orders and ragged
    sample counts."""
    rng = np.random.default_rng(a + s)
    x = rng.standard_normal((c, a, s)).astype(np.float32) * 1000
    rf = torch.from_numpy(x).to(dev)
    if dtype == torch.complex64:
        rf = torch.complex(rf, torch.from_numpy(x[:, ::-1].copy()).to(dev))
    h = decode.hadamard_matrix(a, device=dev)
    out = decode.decode_hadamard(rf, h)
    ref = decode.decode_hadamard_ref(rf, h)
    assert out.dtype == dtype and out.shape == rf.shape
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-6


def test_decode_float16_equals_the_float32_launch(dev):
    """float16 RF (Float16 wire data) goes through the float32 kernel on
    its exact float32 values: one launch, equal to the float32 launch."""
    rng = np.random.default_rng(16)
    x = rng.integers(-2048, 2048, (3, 64, 1000)).astype(np.float16)
    rf = torch.from_numpy(x).to(dev)
    h = decode.hadamard_matrix(64, device=dev)
    before = build.LAUNCHES["decode_hadamard"]
    out = decode.decode_hadamard(rf, h)
    assert build.LAUNCHES["decode_hadamard"] == before + 1
    assert out.dtype == torch.float32
    assert torch.equal(out, decode.decode_hadamard(rf.to(torch.float32), h))


def test_float16_pipeline_runs_on_the_card(dev):
    """[Decode, DAS] on Float16 wire data through Beamformer on the card
    against the CPU Beamformer (the twins)."""
    p = Parameters(
        sample_count=256, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [7 * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    raw = np.random.default_rng(17).integers(-1024, 1024, (8, 4 * 256)
                                             ).astype(np.float16)
    frames = []
    for device in (dev, "cpu"):
        bf = Beamformer(device=device)
        bf.push_parameters(p)
        bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS],
                         DataKind.Float16)
        frames.append(bf.push_data_with_compute(raw).to_numpy())
    assert np.abs(frames[1]).max() > 0
    assert nrmse(frames[1], frames[0]) <= 1e-4


def test_decode_rejects_order_above_limit(dev):
    rf = torch.zeros((1, decode.MAX_ORDER + 1, 8), dtype=torch.int16,
                     device=dev)
    h = torch.ones((decode.MAX_ORDER + 1,) * 2, device=dev)
    with pytest.raises(ValueError, match="order"):
        decode.decode_hadamard(rf, h)


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


@pytest.mark.parametrize("tx_pass", [das_cuda.NARROW_PASS,
                                     das_cuda.WIDE_PASS])
@pytest.mark.parametrize("fb", [1, 4])
@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("n_tx", [1, das_cuda.MAX_FORCES_TRANSMITS])
def test_forces_kernel_transmit_extremes(dev, n_tx, interp, iq, coherency,
                                         fb, tx_pass):
    """FORCES at one transmit and at the most the kernel takes, with either
    pass of the index table, over 13 x 11 voxels (not a multiple of the
    128-voxel block): each frame against a single-frame launch (1e-6) and
    the twin (1e-4)."""
    import dataclasses
    p = dataclasses.replace(
        _das_params("forces", interp, coherency, (13, 11, 1)),
        acquisition_count=n_tx)
    dyn, st1 = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    dyn["launch"] = dict(das_cuda.launch_tables(st1, dyn), tx_pass=tx_pass)
    st = dataclasses.replace(st1, frame_batch=fb)
    frames = torch.stack([_rf(p, iq, dev) * (1.0 + b) for b in range(fb)])
    name = "das_forces" + ("_fb4" if fb == 4 else "")
    before = build.LAUNCHES[name]
    out = das.das(frames if fb > 1 else frames[0], dyn, st)
    assert build.LAUNCHES[name] == before + 1
    ref = das.das_ref(frames if fb > 1 else frames[0], dyn, st)
    _compare(out, ref)
    if fb > 1:
        for b in range(fb):
            one = das.das(frames[b].contiguous(), dyn, st1)
            pairs = zip(out, one) if coherency else [(out, one)]
            for o, r in pairs:
                _close(o[b], r)


def test_forces_kernel_rejects_too_many_transmits(dev):
    import dataclasses
    p = dataclasses.replace(
        _das_params("forces", InterpolationMode.Linear, False),
        acquisition_count=das_cuda.MAX_FORCES_TRANSMITS + 1)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=False)
    rf = _rf(p, False, dev)
    with pytest.raises(ValueError, match="transmits"):
        das.das(rf, dyn, st)


def _hercules_params(kind, orient, interp, coherency, focus=np.inf):
    a, kw = 4, {}
    if kind == "uhercules":
        a, kw = 5, dict(sparse=True,
                        sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    tx, rx = RCAOrientation.Rows, RCAOrientation.Columns
    if orient == "tx_columns":
        tx, rx = rx, tx
    xdc = np.eye(4, dtype=np.float32)
    xdc[0, 3] = -0.4e-3
    return DasParams(
        acquisition_kind=(AcquisitionKind.UHERCULES if kind == "uhercules"
                          else AcquisitionKind.HERCULES),
        acquisition_count=a, channel_count=8, sample_count=256,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=das_transform_3d([0, 0, 1e-3],
                                         [7 * PITCH, 7 * PITCH, 8e-3]),
        xdc_transform=xdc,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=(6, 5, 7), interpolation_mode=interp,
        transmit_receive_orientation=pack_tx_rx_orientation(tx, rx),
        transmit_angle=3.0, focus_depth=focus,
        coherency_weighting=coherency, **kw)


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("orient", ["tx_rows", "tx_columns"])
@pytest.mark.parametrize("kind", ["hercules", "uhercules"])
def test_hercules_kernel_matches_twin(dev, kind, orient, interp, iq,
                                      coherency):
    p = _hercules_params(kind, orient, interp, coherency,
                         focus=np.inf if orient == "tx_rows" else 6e-3)
    rf = _rf(p, iq, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    before = build.LAUNCHES["das_hercules"]
    out = das.das(rf, dyn, st)
    assert build.LAUNCHES["das_hercules"] == before + 1
    _compare(out, das.das_ref(rf, dyn, st))


def _tilted(vt, degrees):
    """``vt`` rotated about y: depth then moves x, so no two voxels of a
    column share their lateral coordinates."""
    a = np.radians(degrees)
    rot = np.eye(4, dtype=np.float32)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = (np.cos(a), np.sin(a),
                                                  -np.sin(a), np.cos(a))
    return (rot @ vt).astype(np.float32)


def _same_either_way(out, rf, dyn, st):
    """The launch ``out`` equals, bit for bit, launches of the per-voxel
    path (runs of one voxel) and, for HERCULES, of the full transmit walk:
    the same triples, summed in the same order."""
    tables = das_cuda.launch_tables(st, dyn)
    variants = [dict(tables, run=1)]
    if st.family == "hercules":
        variants.append(dict(tables, tx_walk=das_cuda.FULL_WALK))
    for t in variants:
        other = das.das(rf, dict(dyn, launch=t), st)
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        other if isinstance(other, tuple) else (other,)):
            assert torch.equal(o, r)


@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("nz", [1, 31, 33, 96])
@pytest.mark.parametrize("kind", ["hercules", "uhercules"])
def test_hercules_kernel_runs_along_depth(dev, kind, nz, tilted, iq):
    """HERCULES and UHERCULES (sparse elements out of order) on 3 x 2 x nz
    grids: columns of 1, 31, 33 (not a multiple of the voxels a thread
    takes) and 96 depths, and the same grids tilted, which take the
    per-voxel path; against the twin (1e-4), and equal to the per-voxel
    path and the full walk."""
    import dataclasses
    p = _hercules_params(kind, "tx_rows", InterpolationMode.Linear, True)
    p = dataclasses.replace(p, output_points=(3, 2, nz))
    if kind == "uhercules":
        p = dataclasses.replace(
            p, sparse_elements=np.array([6, 0, 7, 2, 4], np.int16))
    if tilted:
        p = dataclasses.replace(p, voxel_transform=_tilted(p.voxel_transform,
                                                           10.0))
    rf = _rf(p, iq, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    assert das_cuda.launch_tables(st, dyn)["run"] == (
        1 if tilted or nz == 1 else nz)
    out = das.das(rf, dyn, st)
    _compare(out, das.das_ref(rf, dyn, st))
    _same_either_way(out, rf, dyn, st)


@pytest.mark.parametrize("tilted", [False, True])
def test_rca_kernel_at_path_a_phase_range(dev, tilted):
    """Flash cubic IQ with path A's sampling (4096 samples at 40 MHz,
    f_d 7.8 MHz: phase arguments up to about 5e3 rad) and depth range on a
    reduced grid, against the twin (1e-4) and equal to the per-voxel path;
    tilted, the per-voxel path."""
    p, _ = presets.plane_wave_2d(channel_count=64, output_points=(24, 160),
                                 data_kind=DataKind.Float32Complex)
    if tilted:
        p.das_voxel_transform = _tilted(p.das_voxel_transform, 4.0)
    gp = DasParams(
        acquisition_kind=p.acquisition_kind, acquisition_count=1,
        channel_count=p.channel_count, sample_count=p.sample_count,
        sampling_frequency=p.sampling_frequency,
        demodulation_frequency=p.demodulation_frequency,
        speed_of_sound=p.speed_of_sound, time_offset=p.time_offset,
        f_number=p.f_number, voxel_transform=p.das_voxel_transform,
        xdc_transform=p.xdc_transform,
        xdc_element_pitch=p.xdc_element_pitch, output_points=(24, 160, 1),
        interpolation_mode=p.interpolation_mode,
        transmit_receive_orientation=p.transmit_receive_orientation)
    rng = np.random.default_rng(160)
    shape = (p.channel_count, 1, p.sample_count)
    rf = torch.complex(
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)),
        torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    ).to(dev)
    dyn, st = das.make_dynamic(gp, dev), das.make_static(gp, iq=True)
    assert das_cuda.launch_tables(st, dyn)["run"] == (1 if tilted else 160)
    out = das.das(rf, dyn, st)
    _compare(out, das.das_ref(rf, dyn, st))
    _same_either_way(out, rf, dyn, st)


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("family", ["hercules", "flash"])
def test_frame_batch_is_bit_equal_to_single_frames(dev, family, iq,
                                                   coherency):
    """A frame of a four-frame HERCULES or RCA launch equals, bit for bit,
    a single-frame launch on it (a pair's geometry is shared, each frame
    summed in the single-frame order)."""
    import dataclasses
    if family == "hercules":
        p = _hercules_params("uhercules", "tx_columns",
                             InterpolationMode.Cubic, coherency, focus=6e-3)
    else:
        p = _das_params("tpw", InterpolationMode.Cubic, coherency)
    frames = torch.stack([_rf(p, iq, dev) * (1.0 + b) - b for b in range(4)])
    dyn, st1 = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    out = das.das(frames, dyn, dataclasses.replace(st1, frame_batch=4))
    for b in range(4):
        one = das.das(frames[b].contiguous(), dyn, st1)
        pairs = zip(out, one) if coherency else [(out, one)]
        for o, r in pairs:
            assert torch.equal(o[b], r)


@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("family", ["forces", "hercules", "flash"])
def test_frame_batch_kernel_matches_single_frames(dev, family, iq):
    """Five frames: one four-frame launch and one single-frame launch; each
    frame against a single-frame launch on it (1e-6) and the twin (1e-4)."""
    import dataclasses
    if family == "hercules":
        p = _hercules_params("hercules", "tx_rows", InterpolationMode.Cubic,
                             True)
    else:
        p = _das_params(family, InterpolationMode.Cubic, True)
    frames = torch.stack([_rf(p, iq, dev) * (1.0 + b) + b for b in range(5)])
    dyn, st1 = das.make_dynamic(p, dev), das.make_static(p, iq=iq)
    st = dataclasses.replace(st1, frame_batch=5)
    name = das_cuda.launch_name(st1)
    before = dict(build.LAUNCHES)
    coh, inco = das.das(frames, dyn, st)
    assert build.LAUNCHES[name + "_fb4"] == before.get(name + "_fb4", 0) + 1
    assert build.LAUNCHES[name] == before.get(name, 0) + 1
    assert coh.shape == (5,) + tuple(p.output_points)
    ref_coh, ref_inco = das.das_ref(frames, dyn, st)
    for b in range(5):
        one_coh, one_inco = das.das(frames[b].contiguous(), dyn, st1)
        _close(coh[b], one_coh)
        _close(inco[b], one_inco)
    _compare((coh, inco), (ref_coh, ref_inco))


def _close(out, ref, tol=1e-6):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= tol


def _taps(cplx, dev, n=16):
    rng = np.random.default_rng(40 + cplx)
    h = rng.standard_normal(n).astype(np.float32)
    if cplx:
        h = (h + 1j * rng.standard_normal(n)).astype(np.complex64)
    return torch.from_numpy(h).to(dev)


# (shape, taps): odd S (every other row at an odd sample offset), S not a
# multiple of 8 or of a tile, a row count that is prime, L = 1, 16 (the
# register window at D = 1), 37 and 64 (the runtime-L loop)
DEMOD_SHAPES = [((3, 5, 1001), 16), ((7, 1002), 1), ((2, 3, 4097), 64),
                ((11, 514), 37)]
FIR_SHAPES = [((4, 3, 777), 37), ((7, 1001), 16), ((5, 1026), 1),
              ((3, 2, 2048), 64)]


@pytest.mark.parametrize("shape, taps", DEMOD_SHAPES)
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_demodulate_kernel_matches_twin(dev, dtype, cplx_taps, d, shape,
                                        taps):
    rng = np.random.default_rng(7)
    rf = torch.from_numpy(rng.integers(-2048, 2048, shape)).to(
        device=dev, dtype=dtype)
    h = _taps(cplx_taps, dev, n=taps)
    before = build.LAUNCHES["demodulate"]
    out = filtering.demodulate(rf, h, 7.8e6, 40e6, d, cplx_taps)
    assert build.LAUNCHES["demodulate"] == before + 1
    _close(out, filtering.demodulate_ref(rf, h, 7.8e6, 40e6, d, cplx_taps))


@pytest.mark.parametrize("shape, taps", FIR_SHAPES)
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_fir_kernel_matches_twin(dev, dtype, cplx_taps, d, shape, taps):
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev)
    if dtype == torch.complex64:
        x = torch.complex(x, x.flip(-1))
    h = _taps(cplx_taps, dev, n=taps)
    before = build.LAUNCHES["fir"]
    out = filtering.fir_filter(x, h, d)
    assert build.LAUNCHES["fir"] == before + 1
    _close(out, filtering.fir_filter_ref(x, h, d))


def test_filter_kernels_at_path_b_shapes(dev):
    """Path B's demodulate (128 x 128 x 4096 int16, its 16-tap Kaiser at
    the pair rate, the plan's table) and the FIR on its complex output."""
    from ogl_beamforming_tpu_torch.utils.filters import make_filter
    fs, fd = 40e6, 7.8e6
    taps = torch.from_numpy(make_filter(FilterParameters(
        kind=FilterKind.Kaiser, sampling_frequency=fs / 2,
        kaiser=KaiserFilterParameters(2e6, 4.0, 16))).taps).to(dev)
    rng = np.random.default_rng(12)
    rf = torch.from_numpy(rng.integers(-2048, 2048, (128, 128, 4096),
                                       dtype=np.int16)).to(dev)
    table = filtering.demod_phasor(filtering.demod_omega(fd, fs, dev), 2048)
    out = filtering.demodulate(rf, taps, fd, fs, phasor=table)
    _close(out, filtering.demodulate_ref(rf, taps, fd, fs))
    _close(filtering.fir_filter(out, taps),
           filtering.fir_filter_ref(out, taps))


@pytest.mark.parametrize("d, length", [(28, 16), (29, 16), (64, 16),
                                       (200, 16), (1, 16384), (64, 16384),
                                       (200, 16384)])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("kind", ["demodulate", "fir real", "fir complex"])
def test_fir_decimation_beyond_shared_memory_raises(dev, kind, cplx_taps, d,
                                                    length):
    """The runtime-L loop once staged a tile of D * 1023 + L samples, which
    fits the H100's shared memory only up to D = 28, and raised beyond;
    the name is that check's, kept for the cases it now holds to the
    twin.  The tile is chosen at launch and L = 16,384 takes its taps in
    chunks (at D = 200 with a tile of 73 outputs, below one of 128):
    demodulate (int16) and fir (real and complex data), real and complex
    taps, at D = 28, 29, 64 and 200 with 16 taps and at D = 1, 64 and 200
    with 16,384, each one launch and bit-equal to its twin."""
    rng = np.random.default_rng(d + length)
    s = max(d * 1100, 20000) + 7
    h = _taps(cplx_taps, dev, n=length)
    name = "demodulate" if kind == "demodulate" else "fir"
    before = build.LAUNCHES[name]
    if kind == "demodulate":
        x = torch.from_numpy(rng.integers(-2048, 2048, (3, s),
                                          dtype=np.int16)).to(dev)
        out = filtering.demodulate(x, h, 5e6, 20e6, d, cplx_taps)
        ref = filtering.demodulate_ref(x, h, 5e6, 20e6, d, cplx_taps)
    else:
        x = torch.from_numpy(rng.standard_normal((3, s)).astype(
            np.float32)).to(dev)
        if kind == "fir complex":
            x = torch.complex(x, x.flip(-1))
        out = filtering.fir_filter(x, h, d)
        ref = filtering.fir_filter_ref(x, h, d)
    assert build.LAUNCHES[name] == before + 1
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, ref)


def test_plan_rebuilt_with_another_demodulation_frequency(dev):
    """A parameter push rebuilds the plan's rotation table: the Demodulate
    stage then gives the twin's result at the new frequency."""
    p, _ = presets.forces_compounding(channel_count=4, transmit_count=2,
                                      sample_count=1024)
    fp = FilterParameters(kind=FilterKind.Kaiser,
                          sampling_frequency=p.sampling_frequency / 2,
                          kaiser=KaiserFilterParameters(2e6, 4.0, 16))
    rng = np.random.default_rng(14)
    raw = rng.integers(-2048, 2048, (4, 2 * 1024), dtype=np.int16)
    bf = Beamformer(device=dev)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Demodulate], DataKind.Int16)
    bf.create_filter(fp, 0)
    taps = torch.from_numpy(bf._blocks[0].filters[0].taps).to(dev)
    rf = torch.from_numpy(raw.reshape(4, 2, 1024)).to(dev)
    outs = []
    for fd in (p.demodulation_frequency, 3.1e6):
        p.demodulation_frequency = fd
        bf.push_parameters(p)
        before = build.LAUNCHES["demodulate"]
        out = bf.push_data_with_compute(raw).data
        assert build.LAUNCHES["demodulate"] == before + 1
        _close(out, filtering.demodulate_ref(rf, taps, fd,
                                             p.sampling_frequency))
        outs.append(out)
    assert not torch.equal(outs[0], outs[1])


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


def test_push_batch_cuda_matches_cpu(dev):
    """Reduced path E (plane-wave Flash, Float32Complex, five frames) and
    path C (HERCULES 3D, two frames) through push_batch on the GPU and the
    CPU."""
    pe, pipe_e = presets.plane_wave_2d(
        channel_count=16, sample_count=1024, output_points=(16, 16),
        lateral_mm=(-2.0, 5.0), axial_mm=(5.0, 15.0),
        data_kind=DataKind.Float32Complex)
    pc, pipe_c = presets.hercules_3d(channel_count=8, acquisition_count=8,
                                     sample_count=256, output_points=(6, 5, 7))
    pc.das_voxel_transform = das_transform_3d([0, 0, 1e-3],
                                              [7 * PITCH, 7 * PITCH, 4e-3])
    rng = np.random.default_rng(12)
    cases = [(pe, pipe_e,
              rng.standard_normal((5, 16, 2048)).astype(np.float32)),
             (pc, pipe_c, rng.integers(-2048, 2048, (2, 8, 8 * 256),
                                       dtype=np.int16))]
    for p, pipe, raw in cases:
        outs = []
        for device in ("cpu", dev):
            bf = Beamformer(device=device)
            bf.push_parameters(p)
            bf.push_pipeline(pipe.shaders, pipe.data_kind)
            outs.append(np.stack([f.to_numpy() for f in bf.push_batch(raw)]))
        assert np.abs(outs[0]).max() > 0
        assert nrmse(outs[0], outs[1]) <= 1e-4


# --- microbenchmark kernels (K5-K11) against their plain versions --------
# Gather-and-add variants and the int8 probes are bit-equal; the variants
# that multiply may contract to FMA (an ulp), and the one-hot product sums
# in another order: NRMSE 1e-6.

_MICRO_ADD_ONLY = {"clip", "mod", "raw", "f32_direct", "i32_direct",
                   "bcast_hoist", "bcast_chunk"}


def _micro_close(out, ref, exact):
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    if exact:
        np.testing.assert_array_equal(out, ref)
    else:
        assert nrmse(ref, out) <= 1e-6


def _gather_cases():
    """K5 and K6 (the persistent floor kernel) at steps 1, 3, 133 (more
    steps than SMs) and 512 (the TPU files' STEPS, where some warps take one
    unit more than others); K7 (a block a step) at steps 3."""
    from ogl_beamforming_tpu_torch.experiments import (gather_micro,
                                                       gather_micro2,
                                                       gather_micro3)
    return ([("k5", v, r, s) for v in gather_micro.VARIANTS for r in (64,)
             for s in (1, 3, 133, 512)]
            + [("k6", v, r, s) for v in gather_micro2.VARIANTS for r in (64,)
               for s in (1, 3, 133, 512)]
            + [("k7", v, r, 3) for v in gather_micro3.VARIANTS
               for r in (32, 224)])


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("case", _gather_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_micro_gather_kernel_matches_plain(dev, case, smem):
    from ogl_beamforming_tpu_torch.experiments import (gather_micro,
                                                       gather_micro2,
                                                       gather_micro3)
    k, variant, reps, steps = case
    before = build.LAUNCHES["micro_gather"]
    if k == "k5":
        x = gather_micro.make_inputs(dev)
        out = gather_micro.kernel(variant, x["src"], x["idx"], reps,
                                  steps=steps, smem=smem)
        ref = gather_micro.kernel_ref(variant, x["src"], x["idx"], reps)
    else:
        mod = gather_micro2 if k == "k6" else gather_micro3
        x = mod.make_inputs(dev)
        src, src2 = x[variant] if k == "k6" else mod.sources(variant, x)
        out = mod.kernel(variant, src, src2, x["idx"], x["w"], reps,
                         steps=steps, smem=smem)
        ref = mod.kernel_ref(variant, src, src2, x["idx"], x["w"], reps)
    assert build.LAUNCHES["micro_gather"] == before + 1
    _micro_close(out, ref, variant in _MICRO_ADD_ONLY)


def _every_step_cases():
    from ogl_beamforming_tpu_torch.experiments import (gather_micro,
                                                       gather_micro2)
    return ([("k5", v, s) for v in gather_micro.VARIANTS for s in (3, 133)]
            + [("k6", v, s) for v in gather_micro2.VARIANTS for s in (3, 133)])


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("case", _every_step_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_micro_gather_every_step_stores_the_plain_tile(dev, monkeypatch, case,
                                                       smem):
    """The K5/K6 kernel stores step 0's units alone, so the test above sees
    one step's element mapping.  Built with every unit storing
    (``gather_ab``'s ablation ``store_every``), every step writes its
    elements over the tile, and each element keeps whichever write lands
    last, mostly a later step's: a step beyond 0 that computes an element
    wrongly or writes it to another position fails here."""
    from ogl_beamforming_tpu_torch.experiments import (compile_source,
                                                       gather_ab,
                                                       gather_micro,
                                                       gather_micro2)
    k, variant, steps = case
    lib = compile_source(gather_ab.sources([], True)["store_every"],
                         "store_every", "micro_gather")
    monkeypatch.setattr(build, "library", lambda: lib)
    if k == "k5":
        x = gather_micro.make_inputs(dev)
        out = gather_micro.kernel(variant, x["src"], x["idx"], 64,
                                  steps=steps, smem=smem)
        ref = gather_micro.kernel_ref(variant, x["src"], x["idx"], 64)
    else:
        x = gather_micro2.make_inputs(dev)
        src, src2 = x[variant]
        out = gather_micro2.kernel(variant, src, src2, x["idx"], x["w"], 64,
                                   steps=steps, smem=smem)
        ref = gather_micro2.kernel_ref(variant, src, src2, x["idx"], x["w"],
                                       64)
    _micro_close(out, ref, variant in _MICRO_ADD_ONLY)


def _walk_tile(name):
    """An idx tile for the walk kernel (K7 and the bundle): the module's
    own (None), random over the whole range the kernel takes, all equal,
    and the extremes 0 and LANE - 4."""
    if name == "seed 11":
        return np.random.default_rng(11).integers(0, 125, (16, 128),
                                                  dtype=np.int32)
    return None if name == "own" else np.full((16, 128), int(name), np.int32)


_WALK_TILES = ("own", "seed 11", "60", "0", "124")


def _walk_case(dev, form, variant, count, steps, smem, tile, lib=None):
    """(kernel tile, plain tile) of K7 ``variant`` (form "k7") or the
    bundle (form "k8", "k9") at ``count`` (REPS or UNITS) and ``steps``,
    on idx tile ``tile``, through ``lib`` where given."""
    from ogl_beamforming_tpu_torch.experiments import (gather_micro3,
                                                       onehot_micro,
                                                       onehot_micro2)
    idx = _walk_tile(tile)
    if form == "k7":
        x = gather_micro3.make_inputs(dev)
        src, src2 = gather_micro3.sources(variant, x)
        args = (src, src2, x["idx"] if idx is None
                else torch.from_numpy(idx).to(dev), x["w"])
        steps = gather_micro3.STEPS if steps is None else steps
        out = gather_micro3.kernel(variant, *args, count, steps=steps,
                                   smem=smem)
        return out, gather_micro3.kernel_ref(variant, *args, count)
    mod = onehot_micro if form == "k8" else onehot_micro2
    x = onehot_micro.make_inputs(dev)
    args = (x["src"], x["src2"], x["idx"] if idx is None
            else torch.from_numpy(idx).to(dev), x["w"])
    steps = mod.STEPS if steps is None else steps
    out = mod.gather_kernel(*args, units=count, steps=steps, smem=smem)
    return out, mod.gather_kernel_ref(*args, units=count)


def _walk_cases():
    """K7's five variants at REPS 224 (turns alone) and 40 (a tail), the
    bundle's K9 form at UNITS 28 and 2, its K8 form at 16 and 6; at steps
    1, 3, 7 and the module's STEPS (None)."""
    from ogl_beamforming_tpu_torch.experiments import gather_micro3
    forms = ([("k7", v, r) for v in gather_micro3.VARIANTS for r in (224, 40)]
             + [("k9", "gather", u) for u in (28, 2)]
             + [("k8", "gather", u) for u in (16, 6)])
    return [f + (s,) for f in forms for s in (1, 3, 7, None)]


@pytest.mark.parametrize("tile", _WALK_TILES)
@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("case", _walk_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_micro_walk_matches_plain(dev, case, smem, tile):
    """The walk kernel against the plain versions: ``f32_direct``
    bit-equal, the rest NRMSE 1e-6; one launch each."""
    form, variant, count, steps = case
    before = build.LAUNCHES["micro_gather"]
    out, ref = _walk_case(dev, form, variant, count, steps, smem, tile)
    assert build.LAUNCHES["micro_gather"] == before + 1
    _micro_close(out, ref, variant in _MICRO_ADD_ONLY)


@pytest.mark.parametrize("steps", [3, 133])
@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("case", [c[:3] for c in _walk_cases()
                                  if c[3] == 1 and c[2] in (224, 28, 16)],
                         ids=lambda c: "-".join(map(str, c)))
def test_micro_walk_every_step_stores_the_plain_tile(dev, monkeypatch, case,
                                                     smem, steps):
    """As the floor kernel's test below: built with every unit storing
    (``store_every``), every step's units write their elements over the
    tile, so a step beyond 0 that computes an element wrongly or writes it
    to another lane's position fails here."""
    from ogl_beamforming_tpu_torch.experiments import (compile_source,
                                                       gather_ab)
    lib = compile_source(gather_ab.sources([], True)["store_every"],
                         "store_every", "micro_gather")
    monkeypatch.setattr(build, "library", lambda: lib)
    form, variant, count = case
    out, ref = _walk_case(dev, form, variant, count, steps, smem, "own")
    _micro_close(out, ref, variant in _MICRO_ADD_ONLY)


@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("k8", [True, False])
def test_micro_gather_hermite_matches_plain(dev, k8, smem):
    from ogl_beamforming_tpu_torch.experiments import onehot_micro, \
        onehot_micro2
    mod = onehot_micro if k8 else onehot_micro2
    x = onehot_micro.make_inputs(dev)
    args = (x["src"], x["src2"], x["idx"], x["w"])
    out = mod.gather_kernel(*args, units=12, steps=3, smem=smem)
    _micro_close(out, mod.gather_kernel_ref(*args, units=12), False)


@pytest.mark.parametrize("steps", [1, 3, 400])
@pytest.mark.parametrize("units", [1, 2, 5, 12, 28])
@pytest.mark.parametrize("batch", [8, 32, 128])
@pytest.mark.parametrize("k8", [True, False])
def test_micro_onehot_matches_plain(dev, k8, batch, units, steps):
    """Odd unit counts and 1 end the kernel's double buffer on either tile;
    400 blocks are more than the card holds at once."""
    from ogl_beamforming_tpu_torch.experiments import onehot_micro, \
        onehot_micro2
    mod = onehot_micro if k8 else onehot_micro2
    x = onehot_micro.make_inputs(dev)
    args = (x[f"rf{batch}"], x["kvox"], x["wt4"])
    before = build.LAUNCHES["micro_onehot"]
    out = mod.onehot_kernel(*args, units=units, steps=steps)
    assert build.LAUNCHES["micro_onehot"] == before + 1
    _micro_close(out, mod.onehot_kernel_ref(*args, units=units), False)


def test_micro_onehot_raises_on_bad_input(dev):
    """A B the kernel has no path for, or a tensor off the card, raises; the
    C entry point itself refuses B = 16 and a count of 0."""
    from ogl_beamforming_tpu_torch.experiments import (launch_onehot, onehot,
                                                       onehot_micro)
    x = onehot_micro.make_inputs(dev)
    rf16 = torch.zeros((16, 128), dtype=torch.float32, device=dev)
    bad = [lambda: onehot(rf16, x["kvox"], x["wt4"], 2, True, 1),
           lambda: onehot(x["rf8"], x["kvox"].cpu(), x["wt4"], 2, True, 1),
           lambda: onehot(x["rf8"], x["kvox"], x["wt4"].cpu(), 2, False, 1),
           lambda: onehot(x["rf8"], x["kvox"].to(torch.int64), x["wt4"], 2,
                          True, 1),
           lambda: launch_onehot(x["rf8"], x["kvox"], x["wt4"], 0, True, 1)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    before = build.LAUNCHES["micro_onehot"]
    with pytest.raises(RuntimeError, match="micro_onehot"):
        launch_onehot(rf16, x["kvox"], x["wt4"], 2, True, 1)
    assert build.LAUNCHES["micro_onehot"] == before


@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32])
def test_micro_probe_i8_exact(dev, out_dtype):
    from ogl_beamforming_tpu_torch.experiments import probe_i8
    x = probe_i8.make_inputs(dev)
    out = probe_i8.kernel2(x["a"], x["b"], out_dtype)
    assert out.dtype == out_dtype
    exact = x["a"].cpu().to(torch.int64) @ x["b"].cpu().to(torch.int64)
    np.testing.assert_array_equal(out.cpu().to(torch.int64).numpy(),
                                  exact.numpy())


@pytest.mark.parametrize("shape", [(16, 64), (128, 256), (128, 1000),
                                   (64, 4096)])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.float32])
def test_micro_k10_shapes(dev, out_dtype, shape):
    """K10 at N a multiple of 16 and not (1000), equal to the exact int64
    product and to torch._int_mm (which takes only more than 16 rows), in
    one launch."""
    from ogl_beamforming_tpu_torch.experiments import probe_i8
    k, n = shape
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (k, k), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n), dtype=np.int8)).to(dev)
    before = build.LAUNCHES["micro_i8"]
    out = probe_i8.kernel2(a, b, out_dtype)
    assert build.LAUNCHES["micro_i8"] == before + 1
    assert out.dtype == out_dtype and out.shape == (k, n)
    exact = a.cpu().to(torch.int64) @ b.cpu().to(torch.int64)
    assert torch.equal(out.cpu().to(torch.int64), exact)
    if k > 16:
        assert torch.equal(out.to(torch.int32), torch._int_mm(a, b))


def test_micro_i8_wrappers_raise_on_bad_input(dev):
    from ogl_beamforming_tpu_torch.experiments import probe_i8, probe_i8b
    a = torch.ones((32, 32), dtype=torch.int8, device=dev)
    b = torch.ones((32, 64), dtype=torch.int8, device=dev)
    x = torch.ones((32, 64), dtype=torch.int16, device=dev)
    bad = [lambda: probe_i8.kernel2(a, b.to(torch.int16)),
           lambda: probe_i8.kernel2(a[:16], b),
           lambda: probe_i8.kernel2(a, b.cpu()),
           lambda: probe_i8.kernel2(a, b.t().contiguous().t()),
           lambda: probe_i8.kernel2(torch.ones((129, 129), dtype=torch.int8,
                                               device=dev),
                                    torch.ones((129, 8), dtype=torch.int8,
                                               device=dev)),
           lambda: probe_i8b.k("full", a, b),
           lambda: probe_i8b.k("dot", a.to(torch.int16), x),
           lambda: probe_i8b.k("shift", a, x.cpu()),
           lambda: probe_i8b.k("rowsum", a[:, :16], x)]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize("shape", [(16, 256), (128, 128 * 64), (128, 1000),
                                   (40, 4100)])
@pytest.mark.parametrize("body", ["shift", "split8", "dot", "rowsum", "full"])
def test_micro_probe_i8b_exact(dev, body, shape):
    from ogl_beamforming_tpu_torch.experiments import probe_i8b
    x = probe_i8b.make_inputs(dev, *shape)
    before = build.LAUNCHES["micro_i8"]
    out = probe_i8b.k(body, x["h"], x["x"])
    assert build.LAUNCHES["micro_i8"] == before + 1
    assert torch.equal(out, probe_i8b.k_ref(body, x["h"], x["x"]))
    if body == "full":
        np.testing.assert_array_equal(
            out.cpu().numpy().astype(np.float64),
            probe_i8b.full_exact(x["h"], x["x"]))


def test_device_time_on_the_card(dev):
    from ogl_beamforming_tpu_torch.utils.profiling import device_time
    x = torch.ones((1024, 1024), device=dev)
    prof = device_time(lambda t: t @ t, x)
    assert prof.module_seconds > 0.0 and prof.kernel_count >= 1
    assert 0.0 < prof.busy_share <= 1.0


def test_profile_device_stages_on_the_card(dev):
    p, pipe = presets.forces_compounding(
        channel_count=8, transmit_count=4, sample_count=512,
        output_points=(12, 16), demodulate=False)
    bf = Beamformer(device=dev)
    bf.push_parameters(p)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    rf = np.random.default_rng(4).integers(-512, 512, (8, 4, 512)
                                           ).astype(np.int16)
    times = bf.profile_device_stages(rf, record=True)
    assert [k for k, _ in times] == [ShaderKind.Decode, ShaderKind.DAS]
    assert all(t > 0.0 for _, t in times)


# --- the streaming session (runtime/streaming.py) and the device ingest ---

def _stream_bf(dev, sample_count=256, points=(12, 16)):
    """[Decode, DAS] FORCES cubic on int16, 8 channels read from 10 raw
    rows in another order."""
    from ogl_beamforming_tpu_torch.params.enums import ContrastMode
    p = Parameters(
        sample_count=sample_count, channel_count=8, acquisition_count=4,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        contrast_mode=ContrastMode.NoContrast,
        das_voxel_transform=_das_params(
            "forces", InterpolationMode.Cubic, False).voxel_transform,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([*points, 1, 0], np.int32))
    bf = Beamformer(device=dev)
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    bf.push_channel_mapping([9, 0, 4, 2, 7, 1, 8, 3])
    return bf


def _stream_raws(n, sample_count=256, seed=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(-1024, 1024, (10, 4 * sample_count + 13),
                         dtype=np.int16) for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 3])
def test_streamed_frames_equal_synchronous(dev, depth):
    """Six frames through a session on the card: pinned host slots, a side
    stream, each kernel once per frame, a stats row per frame, each frame
    bit for bit the synchronous frame of its raw frame."""
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    bf = _stream_bf(dev)
    raws = _stream_raws(6)
    refs = [bf.push_data_with_compute(r).data.clone() for r in raws]
    first = bf.stats._frame_index
    build.LAUNCHES.clear()
    with StreamingSession(bf, depth=depth) as stream:
        handles = [stream.submit(r) for r in raws]
        stream.drain(timeout=120)
        frames = [h.result(timeout=120) for h in handles]
        ring = stream._ring
        assert len(ring.host) == len(ring.dev) == depth
        assert all(t.is_pinned() for t in ring.host)
        assert all(t.is_cuda for t in ring.dev)
        assert stream._side != torch.cuda.default_stream(dev)
    assert build.LAUNCHES["decode_hadamard"] == build.LAUNCHES[
        "das_forces"] == 6
    assert bf.stats._frame_index - first == 6
    assert (bf.compute_timings().times[first:first + 6, :2] > 0).all()
    for frame, ref in zip(frames, refs):
        assert frame.data.is_cuda and torch.equal(frame.data, ref)


def test_streaming_plan_rebuilt_midstream_on_the_card(dev):
    """A parameter push between frames rebuilds the plan; a new sample
    count resizes the rings.  Each frame equals the synchronous frame under
    its own parameters."""
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    bf = _stream_bf(dev)
    new = _stream_bf(dev, sample_count=128, points=(10, 6))
    before, after = _stream_raws(3), _stream_raws(3, 128, seed=31)
    refs = [bf.push_data_with_compute(r).data.clone() for r in before] + [
        new.push_data_with_compute(r).data.clone() for r in after]
    with StreamingSession(bf) as stream:
        handles = [stream.submit(r) for r in before]
        stream.flush(timeout=120)
        key = stream._ring.key
        bf.push_parameters(new._blocks[0].parameters)
        handles += [stream.submit(r) for r in after]
        stream.drain(timeout=120)
        assert stream._ring.key != key
        frames = [h.result(timeout=120) for h in handles]
    for frame, ref in zip(frames, refs):
        assert torch.equal(frame.data, ref)


def test_frames_read_on_the_main_thread_while_the_worker_runs(dev):
    """``frame.to_numpy()`` on the caller's thread, on the default stream,
    while the worker enqueues later frames: each equals its synchronous
    frame."""
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    bf = _stream_bf(dev)
    raws = _stream_raws(4)
    refs = [bf.push_data_with_compute(r).to_numpy() for r in raws]
    with StreamingSession(bf) as stream:
        handles = [stream.submit(raws[i % 4]) for i in range(16)]
        for i, h in enumerate(handles):
            np.testing.assert_array_equal(h.result(timeout=120).to_numpy(),
                                          refs[i % 4])
        stream.drain(timeout=120)


def test_streaming_error_reaches_the_handle_on_the_card(dev):
    from ogl_beamforming_tpu_torch import BeamformerError
    from ogl_beamforming_tpu_torch.runtime.streaming import StreamingSession
    bf = _stream_bf(dev)
    with StreamingSession(bf) as stream:
        bad = stream.submit(np.zeros((10, 7), np.int16))
        good = stream.submit(_stream_raws(1)[0])
        with pytest.raises(BeamformerError):
            bad.result(timeout=120)
        assert good.result(timeout=120).data.is_cuda


@pytest.mark.parametrize("mapping", ["identity", "subset"])
@pytest.mark.parametrize("a1s2", [False, True])
@pytest.mark.parametrize("dtype", [np.int16, np.float16, np.float32])
def test_device_ingest_on_the_card_equals_prepare_rf(dev, dtype, a1s2,
                                                      mapping):
    from ogl_beamforming_tpu_torch.params.enums import ContrastMode
    from ogl_beamforming_tpu_torch.runtime import upload
    rng = np.random.default_rng(40)
    c, a, s = 6, 4, 100
    rows = 6 if mapping == "identity" else 9
    m = (np.arange(6) if mapping == "identity"
         else rng.choice(9, 6, replace=False)).astype(np.int16)
    if dtype == np.int16:
        raw = rng.integers(-32768, 32768, (rows, a * s + 5)).astype(dtype)
    else:
        raw = (rng.standard_normal((rows, a * s + 5)) * 1000).astype(dtype)
    args = (c, a, s, ContrastMode.A1S2 if a1s2 else ContrastMode.NoContrast,
            DataKind.Int16)
    cols = upload.raw_columns(raw.shape, m, *args)
    out = upload.prepare_rf_device(
        torch.from_numpy(raw).to(dev)[:, :cols],
        torch.from_numpy(upload.mapping_rows(m, c, rows)).to(dev), *args)
    assert out.is_cuda
    assert out.cpu().numpy().tobytes() == upload.prepare_rf(raw, m,
                                                            *args).tobytes()


def test_served_frames_equal_push_data_with_compute(dev):
    """A BeamformerServer on the card (runtime/server.py), driven through
    the port's native library by a client in this process: six frames
    pushed in a row and read back at once, each equal to
    push_data_with_compute of its raw frame on the card, bit for bit, each
    kernel once a frame."""
    import ctypes as ct
    import os

    from ogl_beamforming_tpu_torch.runtime.server import (
        BeamformerServer, simple_parameters_to_c)
    p, pipe = presets.forces_compounding(channel_count=16, transmit_count=8,
                                         sample_count=1024, demodulate=False)
    p.output_points[:] = [64, 96, 1, 0]
    sp = simple_parameters_to_c(p, pipe.shaders, pipe.data_kind)
    rng = np.random.default_rng(21)
    raws = [rng.integers(-2048, 2048, (16, 8 * 1024), dtype=np.int16)
            for _ in range(6)]
    name = f"/bf_torch_cuda_{os.getpid()}"
    os.environ["OGL_BEAMFORMER_SHM_NAME"] = name
    srv = BeamformerServer(shm_size=64 << 20, device=dev).start()
    try:
        lib = srv.lib
        lib.beamformer_set_global_timeout(60000)
        assert lib.beamformer_push_simple_parameters(ct.byref(sp)) == 1
        out = np.zeros((6, 64 * 96), np.float32)
        before = {k: build.LAUNCHES[k]
                  for k in ("decode_hadamard", "das_forces")}
        for raw in raws:
            assert lib.beamformer_push_data_with_compute(
                raw.ctypes.data_as(ct.c_void_p), raw.nbytes, 0, 0) == 1
        assert lib.beamformer_get_last_frames(
            out.ctypes.data_as(ct.c_void_p), out.nbytes, 6) == 1
        assert all(build.LAUNCHES[k] == n + 6 for k, n in before.items())
        block = srv.beamformer._blocks[0]
        ref = Beamformer(device=dev)
        ref.push_parameters(block.parameters)
        ref.push_pipeline([s.kind for s in block.pipeline.stages],
                          block.pipeline.data_kind)
        for raw, got in zip(raws, out):
            want = ref.push_data_with_compute(raw).to_reference_layout()
            assert np.array_equal(want, got)
    finally:
        os.environ["OGL_BEAMFORMER_SHM_NAME"] = name
        srv.stop(timeout=30)
    assert not srv._thread.is_alive()


# ---------------------------------------------------------------------------
# Recorded acquisitions and display

@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("kind", ["FORCES", "RCA_TPW"])
def test_das_from_params_on_the_card_equals_the_twin(dev, kind, iq):
    """A CUDA tensor takes the kernel (one launch), a numpy array goes to
    the device asked for; both against the twin of the same input."""
    p = DasParams(
        acquisition_kind=AcquisitionKind[kind],
        acquisition_count=4 if kind == "FORCES" else 1, channel_count=16,
        sample_count=512, sampling_frequency=20e6,
        demodulation_frequency=5e6, speed_of_sound=1500.0,
        time_offset=1e-7, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3], [15 * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=(24, 32, 1),
        interpolation_mode=InterpolationMode.Cubic)
    rng = np.random.default_rng(14)
    rf = rng.standard_normal((16, p.acquisition_count, 512)).astype(
        np.float32)
    if iq:
        rf = (rf + 1j * rng.standard_normal(rf.shape)).astype(np.complex64)
    before = sum(build.LAUNCHES.values())
    out = das.das_from_params(torch.from_numpy(rf).to(dev), p)
    assert sum(build.LAUNCHES.values()) == before + 1
    twin = das.das_from_params(torch.from_numpy(rf), p)
    assert out.is_cuda and twin.device.type == "cpu"
    assert nrmse(twin.numpy(), out.cpu().numpy()) <= 1e-4
    np.testing.assert_array_equal(
        das.das_from_params(rf, p, device=dev).cpu().numpy(),
        out.cpu().numpy())


def test_viewer_on_a_card_frame_equals_the_cpu_frame(dev):
    """``display_map`` runs on the frame's device: a frame on the card
    gives the CPU frame's B-mode image and A-scan."""
    from ogl_beamforming_tpu_torch import viewer
    from ogl_beamforming_tpu_torch.pipeline.executor import Frame
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((64, 128, 1))
         + 1j * rng.standard_normal((64, 128, 1))).astype(np.complex64)
    card = Frame(data=torch.from_numpy(v).to(dev), id=0)
    host = Frame(data=torch.from_numpy(v), id=0)
    np.testing.assert_allclose(viewer.bmode_image(card, db_cutoff=-40),
                               viewer.bmode_image(host, db_cutoff=-40),
                               atol=1e-6)
    np.testing.assert_array_equal(viewer.a_scan(card, 17),
                                  viewer.a_scan(host, 17))


def test_entry_forward_on_the_card_equals_the_cpu_entry(dev):
    from ogl_beamforming_tpu_torch import entry
    forward, (rf,) = entry.entry()
    assert rf.is_cuda
    raw = np.random.default_rng(5).integers(-2048, 2048, tuple(rf.shape),
                                            dtype=np.int16)
    out = forward(torch.from_numpy(raw).to(dev))
    cpu_forward, _ = entry.entry(device="cpu")
    ref = cpu_forward(torch.from_numpy(raw))
    assert out.is_cuda and out.shape == ref.shape
    assert nrmse(ref.numpy(), out.cpu().numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# Launch knobs (ops/das_cuda.py TUNED, ops/decode.py DECODE_TUNED) and the
# autotuners.


@pytest.fixture
def tables():
    """das_cuda's and decode's knob tables, emptied for the test (the
    shipped tables not loaded) and put back after it."""
    dicts = (das_cuda.TUNED, das_cuda.ABLATE, decode.DECODE_TUNED,
             decode.DECODE_ABLATE)
    saved = [dict(t) for t in dicts]
    loaded = (das_cuda._SHIPPED_TUNED_LOADED, decode._DECODE_SHIPPED_LOADED)
    for t in dicts:
        t.clear()
    das_cuda._SHIPPED_TUNED_LOADED = decode._DECODE_SHIPPED_LOADED = True
    yield
    for t, old in zip(dicts, saved):
        t.clear()
        t.update(old)
    das_cuda._SHIPPED_TUNED_LOADED, decode._DECODE_SHIPPED_LOADED = loaded


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _knob_params(family, interp, coherency):
    if family in ("hercules", "uhercules"):
        return _hercules_params(family, "tx_columns", interp, coherency,
                                focus=6e-3)
    return _das_params(family, interp, coherency)


# Knobs that keep every voxel's order of accumulation, so the output is the
# default's bit for bit: the thread shape, the HERCULES walk and, for
# HERCULES and RCA, single-frame launches of a batch.  The FORCES index
# table's pass sums a voxel's pairs in passes (a channel's transmits of one
# pass, then the next pass), so another pass rounds differently: held to
# the twin bound, 1e-4, against the default and the twin.  FORCES frames a
# launch: 1e-6, as test_frame_batch_kernel_matches_single_frames.
def _same_order(family, knobs) -> bool:
    return "tx_pass" not in knobs and not (family == "forces"
                                           and "fb" in knobs)


@pytest.mark.parametrize("fb", [1, 4])
@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("family", ["forces", "uforces", "readi", "hercules",
                                    "uhercules", "flash", "tpw", "vls"])
def test_every_das_knob_equals_the_default(dev, tables, family, interp, iq,
                                           coherency, fb):
    """Every default candidate of autotune_das, installed in TUNED, against
    the default knobs (bit for bit where the knob keeps the order of
    accumulation) and the twin (1e-4); a thread shape's launch is counted
    under its shape."""
    import dataclasses
    p = _knob_params(family, interp, coherency)
    st = das.make_static(p, iq=iq)
    dyn = das.make_dynamic(p, dev)
    if fb > 1:
        st = dataclasses.replace(st, frame_batch=fb)
        rf = torch.stack([_rf(p, iq, dev) * (1.0 + b) - b for b in range(fb)])
    else:
        rf = _rf(p, iq, dev)
    key = das_cuda._tune_key(st)
    ref = _outputs(das.das(rf, dyn, st))
    twin = _outputs(das.das_ref(rf, dyn, st))
    candidates = das_cuda._default_candidates(st)
    assert candidates[0] == {} and len(candidates) > 1
    for knobs in candidates[1:]:
        das_cuda.TUNED[key] = knobs
        tables = das_cuda.launch_tables(st, dyn)
        for name, value in knobs.items():
            assert tables[name] == (tuple(value) if name == "thread"
                                    else value)
        before = dict(build.VARIANT_LAUNCHES)
        out = _outputs(das.das(rf, dyn, st))
        if "thread" in knobs:
            shape = f"das_{st.family} thread " + ".".join(
                str(v) for v in knobs["thread"])
            assert build.VARIANT_LAUNCHES[shape] == before.get(shape, 0) + 1
        for o, r, t in zip(out, ref, twin):
            if _same_order(st.family, knobs):
                assert torch.equal(o, r), knobs
            else:
                tol = 1e-6 if "fb" in knobs else 1e-4
                assert nrmse(r.cpu().numpy(), o.cpu().numpy()) <= tol, knobs
            assert nrmse(t.cpu().numpy(), o.cpu().numpy()) <= 1e-4, knobs


@pytest.mark.parametrize("shape", [(3, 2, 33), (2, 3, 96)])
@pytest.mark.parametrize("family", ["hercules", "flash"])
def test_thread_shapes_on_ragged_runs(dev, tables, family, shape):
    """Every thread shape on grids whose runs (33, 96 depths) the shape's
    voxels and lanes do not divide: bit-equal to the default shape."""
    import dataclasses
    p = _knob_params(family, InterpolationMode.Cubic, True)
    p = dataclasses.replace(p, output_points=shape)
    rf = _rf(p, True, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=True)
    ref = das.das(rf, dyn, st)
    for thread in build.THREAD_SHAPES[st.family][1:]:
        das_cuda.TUNED[das_cuda._tune_key(st)] = {"thread": list(thread)}
        for o, r in zip(das.das(rf, dyn, st), ref):
            assert torch.equal(o, r), thread


def test_thread_shape_occupancy(dev, tables):
    """das_occupancy answers for every thread shape; a four-frame launch has
    only the default."""
    for family in ("hercules", "flash"):
        p = _knob_params(family, InterpolationMode.Cubic, False)
        st = das.make_static(p, iq=True)
        for thread in build.THREAD_SHAPES[st.family]:
            assert das_cuda.blocks_per_sm(st, 4, thread=thread) > 0
        with pytest.raises(RuntimeError, match="das_occupancy"):
            das_cuda.blocks_per_sm(st, 4, frames=4,
                                   thread=build.THREAD_SHAPES[st.family][1])


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32,
                                   torch.complex64])
@pytest.mark.parametrize("a", [12, 16, 64, 256])
def test_every_decode_knob_equals_the_default(dev, tables, a, dtype):
    """Every decode candidate the card launches at order ``a``, installed in
    DECODE_TUNED, bit-equal to the default launch, on a ragged and a
    vectorised sample count; float input has the default alone."""
    rng = np.random.default_rng(a)
    h = decode.hadamard_matrix(a, dev)
    for c, s in ((3, 1000), (2, 4097)):
        if dtype == torch.int16:
            x = rng.integers(-32768, 32768, (c, a, s), dtype=np.int16)
        else:
            x = rng.standard_normal((c, a, s)).astype(np.float32)
            if dtype == torch.complex64:
                x = x + 1j * rng.standard_normal((c, a, s)).astype(np.float32)
        rf = torch.from_numpy(x).to(dev)
        ref = decode.decode_hadamard(rf, h)
        candidates = decode.decode_candidates(rf)
        assert candidates[0] == {}
        if dtype == torch.int16:   # 128-sample tiles do not fit at 256
            assert len(candidates) == (2 if a == 256 else 3)
        else:
            assert candidates == [{}]
        key = (c, a, s * (2 if dtype == torch.complex64 else 1))
        for knobs in candidates[1:]:
            decode.DECODE_TUNED[key] = knobs
            assert decode.decode_knobs(key) == knobs
            before = build.kernel_launches()
            assert torch.equal(decode.decode_hadamard(rf, h), ref), knobs
            kernel = "decode_i8_tile_kernel"
            assert build.kernel_launches()[kernel] == before.get(kernel,
                                                                 0) + 1
        decode.DECODE_TUNED.pop(key, None)


def test_autotune_das_installs_its_best(dev, tables):
    """autotune_das on a HERCULES frame installs its fastest candidate under
    the configuration's key, and a plan's launch tables built after it
    carry those knobs."""
    p = _knob_params("hercules", InterpolationMode.Linear, False)
    rf = _rf(p, False, dev)
    dyn, st = das.make_dynamic(p, dev), das.make_static(p, iq=False)
    best, results = das_cuda.autotune_das(rf, dyn, st, iters=2, passes=1)
    key = das_cuda._tune_key(st)
    assert das_cuda.TUNED[key] == best
    assert set(results) == {repr(k) for k in das_cuda._default_candidates(st)}
    assert all(isinstance(t, float) and t > 0 for t in results.values())
    assert best in das_cuda._default_candidates(st)
    tables = das_cuda.launch_tables(st, dyn)
    assert tables["thread"] == tuple(best.get(
        "thread", build.THREAD_SHAPES["hercules"][0]))


def test_autotune_decode_installs_its_best(dev, tables):
    rf = torch.from_numpy(np.random.default_rng(1).integers(
        -2048, 2048, (4, 64, 2048), dtype=np.int16)).to(dev)
    h = decode.hadamard_matrix(64, dev)
    best, results = decode.autotune_decode(rf, h, iters=3, warmup=1,
                                           passes=1)
    assert decode.DECODE_TUNED[(4, 64, 2048)] == best
    assert decode.DECODE_ABLATE == {}
    assert set(results) == {repr(k) for k in decode.decode_candidates(rf)}
    assert all(isinstance(t, float) for t in results.values())
    cplx = torch.complex(rf[:, :, :1024].float(), rf[:, :, 1024:].float())
    best_c, _ = decode.autotune_decode(cplx, h, iters=3, warmup=1, passes=1)
    # the interleaved key is the int16 frame's, whose knobs stay: the
    # float32 kernel has none
    assert best_c == {} and decode.DECODE_TUNED[(4, 64, 2048)] == best


def test_plan_launches_the_installed_knobs(dev, tables, tmp_path):
    """A plan built after load_tuned launches the table's knobs (the thread
    shape's launch counted), and its frame equals the frame of a plan built
    before, bit for bit."""
    from ogl_beamforming_tpu_torch.pipeline.plan import (build_plan,
                                                         compose_stages)
    p, pipe = presets.hercules_3d(channel_count=16, acquisition_count=16,
                                  sample_count=512, output_points=(8, 8, 24))
    raw = torch.from_numpy(np.random.default_rng(2).integers(
        -2048, 2048, (16, 16, 512), dtype=np.int16)).to(dev)
    before = build_plan(p, pipe, {}, device=dev)
    ref = compose_stages(before.descriptor, raw, before.dyn)
    st = next(sd.das for sd in before.descriptor.stages if sd.das)
    das_cuda.TUNED[das_cuda._tune_key(st)] = {"thread": [2, 4, 0],
                                              "tx_walk": 0}
    path = tmp_path / "tuned.json"
    das_cuda.save_tuned(path)
    das_cuda.TUNED.clear()
    das_cuda.load_tuned(path)
    after = build_plan(p, pipe, {}, device=dev)
    assert before.dyn["das"]["launch"]["thread"] == (3, 4, 0)
    assert after.dyn["das"]["launch"]["thread"] == (2, 4, 0)
    assert after.dyn["das"]["launch"]["tx_walk"] == 0
    n = build.VARIANT_LAUNCHES["das_hercules thread 2.4.0"]
    out = compose_stages(after.descriptor, raw, after.dyn)
    assert build.VARIANT_LAUNCHES["das_hercules thread 2.4.0"] == n + 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32,
                                   torch.complex64])
def test_pretune_inputs_on_the_card(dev, dtype):
    """pretune's inputs are drawn on the card from a seed: the same seed
    gives the same tensor, another seed another."""
    from ogl_beamforming_tpu_torch import pretune
    a = pretune.device_input((3, 4, 5), dtype, 7)
    assert a.is_cuda and a.dtype == dtype and a.shape == (3, 4, 5)
    assert torch.equal(a, pretune.device_input((3, 4, 5), dtype, 7))
    assert not torch.equal(a, pretune.device_input((3, 4, 5), dtype, 8))
    p = _knob_params("flash", InterpolationMode.Cubic, False)
    st = das.make_static(p, iq=dtype == torch.complex64)
    rf = pretune.das_input(st, 1)
    assert rf.shape == (8, 1, 256) and rf.is_cuda


# ---------------------------------------------------------------------------
# Sharded plans (parallel/sharding.py) on virtual meshes of cuda:0
# ---------------------------------------------------------------------------

def _mesh_case(family, coherency, a=8):
    """A reduced configuration of ``family`` (FORCES and HERCULES with
    Decode; RCA: plane-wave Flash, or TPW over ``a`` steered angles when
    ``a > 1``, decode-free) with ``coherency``, its focal vectors and a raw
    (C, A, S) frame made from a seed."""
    fv = None
    if family == "forces":
        p, pipe = presets.forces_compounding(
            channel_count=16, transmit_count=8, sample_count=2048,
            output_points=(16, 24), demodulate=False)
    elif family == "hercules":
        p, pipe = presets.hercules_3d(channel_count=16, acquisition_count=16,
                                      sample_count=1024,
                                      output_points=(8, 6, 10))
    else:
        p, pipe = presets.plane_wave_2d(
            channel_count=16, sample_count=1024, output_points=(16, 24),
            lateral_mm=(-1.0, 4.0), axial_mm=(5.0, 15.0))
        if a > 1:
            angles = np.linspace(-8, 8, a).astype(np.float32)
            fv = np.stack([angles, np.full(a, np.inf, np.float32)], axis=1)
            p.acquisition_kind = AcquisitionKind.RCA_TPW
            p.acquisition_count = a
            p.single_focus = 0
    p.coherency_weighting = coherency
    rng = np.random.default_rng(0x5EED)
    shape = (p.channel_count, p.acquisition_count, p.sample_count)
    rf = (rng.integers(-1024, 1024, shape).astype(np.int16)
          if pipe.data_kind == DataKind.Int16
          else rng.standard_normal(shape).astype(np.float32))
    return p, pipe, fv, rf


def _sharded_against_unsharded(dev, p, pipe, fv, rf, splan_of, shards):
    """The sharded plan's frame against the unsharded plan's (NRMSE 1e-5),
    each shard launching the DAS kernel (and the decode kernel, where the
    plan decodes) once."""
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    plan = build_plan(p, pipe, {}, device=dev, focal_vectors=fv)
    x = torch.from_numpy(rf).to(dev)
    ref = plan(x)
    splan = splan_of(plan)
    st = next(sd.das for sd in plan.descriptor.stages if sd.das)
    names = [das_cuda.launch_name(st)] + (
        ["decode_hadamard"] if any(sd.kind == ShaderKind.Decode
                                   for sd in plan.descriptor.stages) else [])
    before = {k: build.LAUNCHES[k] for k in names}
    out = splan(x)
    assert {k: build.LAUNCHES[k] - before[k] for k in names} == \
        {k: shards for k in names}
    assert out.shape == ref.shape and out.is_cuda
    assert float(ref.abs().max()) > 0
    assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= 1e-5


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_sharded_plan_matches_unsharded(dev, family, coherency, n):
    from ogl_beamforming_tpu_torch.parallel import sharding
    p, pipe, fv, rf = _mesh_case(family, coherency, a=1)
    _sharded_against_unsharded(
        dev, p, pipe, fv, rf,
        lambda plan: sharding.shard_plan(plan,
                                         sharding.make_mesh([dev] * n)), n)


@pytest.mark.parametrize("coherency", [False, True])
def test_sharded_2d_plan_matches_unsharded(dev, coherency):
    from ogl_beamforming_tpu_torch.parallel import sharding
    p, pipe, fv, rf = _mesh_case("forces", coherency)
    _sharded_against_unsharded(
        dev, p, pipe, fv, rf,
        lambda plan: sharding.shard_plan_2d(
            plan, sharding.make_mesh_2d(2, 2, [dev] * 4)), 4)


@pytest.mark.parametrize("coherency", [False, True])
def test_sharded_tx_plan_matches_unsharded(dev, coherency):
    from ogl_beamforming_tpu_torch.parallel import sharding
    p, pipe, fv, rf = _mesh_case("rca", coherency, a=8)
    _sharded_against_unsharded(
        dev, p, pipe, fv, rf,
        lambda plan: sharding.shard_plan_tx(
            plan, sharding.make_mesh_tx(2, 4, [dev] * 8)), 8)


# Sharded plans on meshes of distinct cards (skipped on a one-card machine):
# each position's kernels launch on its own card while cuda:0 is current.

@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs or more")
    n = torch.cuda.device_count()
    n = 4 if n >= 4 else 2           # a power of two dividing 16 channels
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_sharded_plan_across_cards_matches_unsharded(cards, family,
                                                     coherency):
    from ogl_beamforming_tpu_torch.parallel import sharding
    p, pipe, fv, rf = _mesh_case(family, coherency, a=1)
    _sharded_against_unsharded(
        cards[0], p, pipe, fv, rf,
        lambda plan: sharding.shard_plan(plan, sharding.make_mesh(cards)),
        len(cards))


def test_sharded_2d_and_tx_plans_across_cards(cards):
    from ogl_beamforming_tpu_torch.parallel import sharding
    if len(cards) < 4:
        pytest.skip("needs four CUDA GPUs")
    p, pipe, fv, rf = _mesh_case("forces", True)
    _sharded_against_unsharded(
        cards[0], p, pipe, fv, rf,
        lambda plan: sharding.shard_plan_2d(
            plan, sharding.make_mesh_2d(2, 2, cards)), 4)
    p, pipe, fv, rf = _mesh_case("rca", True, a=8)
    _sharded_against_unsharded(
        cards[0], p, pipe, fv, rf,
        lambda plan: sharding.shard_plan_tx(
            plan, sharding.make_mesh_tx(2, 2, cards)), 4)


def test_beamformer_mesh_across_cards_times_every_card(cards, monkeypatch):
    """``Beamformer(mesh=make_mesh(cards))`` against the unsharded
    Beamformer on the same frame (NRMSE 1e-5), and its stats row's Decode
    stage spanning every card's decode: with a sleep kernel queued on the
    last card just before its decode, the Decode stage lasts at least half
    the sleep (the first card's stream waits for the others at each
    stage's end; without that wait the sleep would fall in the DAS stage,
    where the partial volumes are copied to the first card)."""
    from ogl_beamforming_tpu_torch.params.constants import STATS_FRAME_WINDOW
    from ogl_beamforming_tpu_torch.parallel import sharding
    from ogl_beamforming_tpu_torch.pipeline import plan as plan_mod
    from ogl_beamforming_tpu_torch.utils.device import event_seconds
    p, pipe, fv, rf = _mesh_case("forces", False)
    raw = rf.reshape(rf.shape[0], -1)

    def session(**kw):
        bf = Beamformer(device=cards[0], **kw)
        bf.push_parameters(p)
        bf.push_pipeline(pipe.shaders, pipe.data_kind)
        return bf

    ref = session().push_data_with_compute(raw).to_numpy()
    bf = session(mesh=sharding.make_mesh(cards))
    assert nrmse(ref, bf.push_data_with_compute(raw).to_numpy()) <= 1e-5

    cycles = 100_000_000
    with torch.cuda.device(cards[-1]):
        sleep_ms = 1e3 * event_seconds(lambda: torch.cuda._sleep(cycles),
                                       1, 1)
    decode = plan_mod.decode_hadamard

    def late_decode(x, h):
        if x.device == cards[-1]:
            torch.cuda._sleep(cycles)
        return decode(x, h)

    monkeypatch.setattr(plan_mod, "decode_hadamard", late_decode)
    out = bf.push_data_with_compute(raw).to_numpy()
    assert nrmse(ref, out) <= 1e-5
    row = (bf.stats._frame_index - 1) % STATS_FRAME_WINDOW
    decode_ms = bf.compute_timings().times[row, 0] * 1e3
    assert decode_ms >= 0.5 * sleep_ms > 0


# ---------------------------------------------------------------------------
# The JAX package's API on the card (smoke phase 13 at a small size)
# ---------------------------------------------------------------------------

def _frames_of(plan, x):
    """The plan's frame and its stages' callables chained on ``x``."""
    from ogl_beamforming_tpu_torch.pipeline.plan import compiled_stage_fns
    chained = x
    for fn in compiled_stage_fns(plan.descriptor):
        chained = fn(chained, plan.dyn)
    return plan(x), chained


def test_compiled_stage_fns_and_backends_on_the_card(dev):
    """The reduced Quickstart: ``compiled_stage_fns`` chained, the plan,
    ``Beamformer.push_data_with_compute`` and a ``das_backend="cuda"``
    plan all bit-equal, each through K2 and K1."""
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    p, pipe, _, rf = _mesh_case("forces", False)
    x = torch.from_numpy(rf).to(dev)
    auto = build_plan(p, pipe, {}, device=dev)
    cuda = build_plan(p, pipe, {}, das_backend="cuda", device=dev)
    bf = Beamformer(device=dev)
    bf.push_parameters(p)
    bf.push_pipeline(pipe.shaders, pipe.data_kind)
    before = {k: build.LAUNCHES[k] for k in ("decode_hadamard",
                                             "das_forces")}
    frame, chained = _frames_of(auto, x)
    pushed = bf.push_data_with_compute(rf.reshape(rf.shape[0], -1)).data
    assert {k: build.LAUNCHES[k] - n for k, n in before.items()} == \
        {"decode_hadamard": 3, "das_forces": 3}
    assert float(frame.abs().max()) > 0
    assert torch.equal(chained, frame) and torch.equal(pushed, frame)
    assert torch.equal(cuda(x), frame)


@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_plain_das_backend_on_the_card(dev, family):
    """``das_backend="xla"`` runs the plain twin on the card, in blocks of
    ``voxel_block`` voxels, launching no K1: within the twin bound of
    K1's frame."""
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    p, pipe, fv, rf = _mesh_case(family, False, a=1)
    x = torch.from_numpy(rf).to(dev)
    ref = build_plan(p, pipe, {}, device=dev, focal_vectors=fv)(x)
    plain = build_plan(p, pipe, {}, device=dev, focal_vectors=fv,
                       das_backend="xla", voxel_block=128)
    st = next(sd.das for sd in plain.descriptor.stages if sd.das)
    assert st.backend == "torch" and st.voxel_block == 128
    name = das_cuda.launch_name(st)
    before = build.LAUNCHES[name]
    out = plain(x)
    assert build.LAUNCHES[name] == before
    assert out.is_cuda and float(ref.abs().max()) > 0
    assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= 1e-4


def test_beamformer_profile_options_on_the_card(dev):
    p, pipe, _, rf = _mesh_case("forces", True)
    raw = rf.reshape(rf.shape[0], -1)
    frames = []
    for kw in ({}, dict(voxel_block=4096, profile=True,
                        stage_timing="device")):
        bf = Beamformer(device=dev, **kw)
        bf.push_parameters(p)
        bf.push_pipeline(pipe.shaders, pipe.data_kind)
        frames.append(bf.push_data_with_compute(raw).data)
        assert (bf.compute_timings().times[0][:2] > 0).all()
    assert torch.equal(*frames)


def test_shard_rf_tx_frame_on_the_card(dev):
    """The 8-angle TPW frame placed by ``shard_rf_tx`` on 2 x 4 positions
    of the card: within 1e-6 of the unsharded frame, each position
    launching K1 once on its (channel, transmit) block."""
    from ogl_beamforming_tpu_torch.parallel import sharding
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    p, pipe, fv, rf = _mesh_case("rca", False, a=8)
    plan = build_plan(p, pipe, {}, device=dev, focal_vectors=fv)
    x = torch.from_numpy(rf).to(dev)
    ref = plan(x)
    mesh = sharding.make_mesh_tx(2, 4, [dev] * 8)
    placed = sharding.shard_rf_tx(x, mesh)
    assert {tuple(b.shape) for b in placed.blocks.values()} == {
        (rf.shape[0] // 2, 2, rf.shape[2])}
    before = build.LAUNCHES["das_rca"]
    out = sharding.shard_plan_tx(plan, mesh)(placed)
    assert build.LAUNCHES["das_rca"] - before == 8
    assert nrmse(ref.cpu().numpy(), out.cpu().numpy()) <= 1e-6


# A plan, a Beamformer and the launchers on a card that is not the current
# one (roadmap C3; skipped on a one-card machine): every launcher makes its
# tensor's card current for the launch.

@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_plan_on_another_card_than_the_current_one(cards, family):
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    p, pipe, fv, rf = _mesh_case(family, True, a=1)
    first, other = cards[0], cards[1]
    with torch.cuda.device(first):
        ref = build_plan(p, pipe, {}, device=first, focal_vectors=fv)(
            torch.from_numpy(rf).to(first))
        out = build_plan(p, pipe, {}, device=other, focal_vectors=fv)(
            torch.from_numpy(rf).to(other))
        assert torch.cuda.current_device() == first.index
    torch.cuda.synchronize(first)
    torch.cuda.synchronize(other)
    assert out.device == other and float(ref.abs().max()) > 0
    assert torch.equal(out.cpu(), ref.cpu())


def test_beamformer_on_another_card_than_the_current_one(cards):
    p, pipe, _, rf = _mesh_case("forces", True)
    raw = rf.reshape(rf.shape[0], -1)
    frames = []
    with torch.cuda.device(cards[0]):
        for card in cards[:2]:
            bf = Beamformer(device=card)
            bf.push_parameters(p)
            bf.push_pipeline(pipe.shaders, pipe.data_kind)
            frames.append(bf.push_data_with_compute(raw).data)
            assert torch.cuda.current_device() == cards[0].index
    for card in cards[:2]:
        torch.cuda.synchronize(card)
    assert frames[1].device == cards[1]
    assert torch.equal(frames[0].cpu(), frames[1].cpu())


def test_launchers_on_another_card_than_the_current_one(cards):
    """``decode_hadamard_cuda``, ``fir_filter`` and ``demodulate`` on
    cuda:1 while cuda:0 is current: bit-equal to the same launches on
    cuda:0."""
    rng = np.random.default_rng(0x0621)
    rf = rng.integers(-1024, 1024, (8, 16, 512)).astype(np.int16)
    taps = np.hanning(16).astype(np.float32)
    outs = []
    with torch.cuda.device(cards[0]):
        for card in cards[:2]:
            x = torch.from_numpy(rf).to(card)
            h = decode.hadamard_matrix(16, device=card)
            t = torch.from_numpy(taps).to(card)
            dec = decode.decode_hadamard_cuda(x, h)
            outs.append([dec, filtering.fir_filter(dec, t, 2),
                         filtering.demodulate(x, t, 5e6, 20e6, 1)])
            assert torch.cuda.current_device() == cards[0].index
    for card in cards[:2]:
        torch.cuda.synchronize(card)
    for a, b in zip(*outs):
        assert b.device == cards[1]
        assert torch.equal(a.cpu(), b.cpu())
