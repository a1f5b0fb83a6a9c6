"""Port DAS (ogl_beamforming_tpu_torch.ops.das, plain twin on the CPU) vs the
JAX package's DAS and the golden oracle, on the same numpy-seeded RF: the
FORCES family (FORCES, UFORCES, READI), the RCA family (Flash, TPW with
three steering angles and mixed orientations, VLS with a finite focal
depth), the HERCULES family on a 3D grid (HERCULES and UHERCULES,
transmitting on rows or on columns, plane or cylindrical focus), and frame
batches (B = 2) against the JAX package's batched DAS.  Also the design of
the HERCULES and RCA kernels in numpy and the twin: the interval walk over
the sorted transmit table keeps the full mask's triples, the sorted table
leaves the twin within 1e-6, the plan-time lateral runs, and the phase
reduction.

Tolerances (NRMSE):
  * vs JAX ``ops.das.das`` (the same f32 formula through XLA): 1e-4.
    Transcendentals and summation order alone put JAX's own XLA DAS
    1e-7..2.3e-5 from golden at these shapes.
  * vs JAX ``das_pallas(..., interpret=True)``: 2e-4.  The Pallas kernel
    quantises each RF line to int16 against its peak (about 3e-5,
    das_pallas.py:520-530) and uses polynomial apodization and sincos.
  * vs golden: 1e-3, the repo's contract.

The JAX XLA reference runs once per (family, mode, IQ) with coherency on:
its coherent output does not depend on the flag.  The Pallas comparison
runs on one configuration per family (FORCES: READI weights, IQ rotation and
the incoherent sum; RCA: TPW, cubic IQ; HERCULES: cylindrical focus,
transmitting on columns, linear IQ): interpret mode costs 10-30 s of
compilation per configuration on one core; the FORCES cubic flagship goes
through it end to end in test_torch_pipeline.py.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import das as jax_das  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.ops.das_pallas import das_pallas  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, InterpolationMode, RCAOrientation,
    pack_tx_rx_orientation)
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz, das_transform_3d)
from ogl_beamforming_tpu_torch.ops import das  # noqa: E402
from ogl_beamforming_tpu_torch.ops import golden as port_golden  # noqa: E402

torch.set_num_threads(1)

C, S, PITCH, POINTS = 8, 256, 0.3e-3, (12, 16, 1)
FAMILIES = ["forces", "uforces", "readi"]
RCA_KINDS = ["flash", "tpw", "vls"]


def _params(family, interp, coherency) -> golden.DasParams:
    kw = {}
    a = 4
    kind = AcquisitionKind.FORCES
    if family == "uforces":
        a = 5
        kind = AcquisitionKind.UFORCES
        kw = dict(sparse=True,
                  sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    elif family == "readi":
        kw = dict(readi_group_count=2, readi_group=1,
                  das_hadamard=hadamard(2).T)
    elif family in RCA_KINDS:
        kind, a, kw = _rca(family)
    return golden.DasParams(
        acquisition_kind=kind, acquisition_count=a, channel_count=C,
        sample_count=S, sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=das_transform_2d_xz([0, 1e-3],
                                            [(C - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=POINTS, interpolation_mode=interp,
        coherency_weighting=coherency, **kw)


def _rca(kind):
    """(acquisition kind, count, DasParams fields) of an RCA frame; the XDC
    transform moves the array 0.4 mm along x, so the receive geometry is not
    the world's."""
    xdc = np.eye(4, dtype=np.float32)
    xdc[0, 3] = -0.4e-3
    cols = pack_tx_rx_orientation(RCAOrientation.Columns,
                                  RCAOrientation.Columns)
    rows = pack_tx_rx_orientation(RCAOrientation.Rows, RCAOrientation.Rows)
    kw = dict(xdc_transform=xdc, transmit_receive_orientation=cols)
    if kind == "flash":
        return AcquisitionKind.Flash, 1, kw
    angles = np.array([-8.0, 0.0, 11.0], np.float32)
    depth = np.float32(np.inf if kind == "tpw" else -2e-3)
    kw.update(single_focus=False, single_orientation=False,
              focal_vectors=np.stack([angles, np.full(3, depth)], axis=-1),
              transmit_receive_orientations=np.array([cols, rows, cols],
                                                     np.uint8))
    return (AcquisitionKind.RCA_TPW if kind == "tpw"
            else AcquisitionKind.RCA_VLS), 3, kw


def _rf(p, iq):
    rng = np.random.default_rng(0x0621 + p.acquisition_count + 2 * iq)
    rf = rng.standard_normal((C, p.acquisition_count, S)).astype(np.float32)
    if iq:
        rf = (rf + 1j * rng.standard_normal(rf.shape)).astype(np.complex64)
    return rf


def _port(rf, p, iq):
    out = das.das(torch.from_numpy(rf), das.make_dynamic(p, "cpu"),
                  das.make_static(p, iq=iq))
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _jax_xla(family, interp, iq):
    """(coherent, incoherent) from the JAX package's XLA DAS."""
    p = _params(family, interp, coherency=True)
    out = jax_das.das_jit(_rf(p, iq), jax_das.make_dynamic(p),
                          jax_das.make_static(p, iq=iq))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("family", FAMILIES + RCA_KINDS)
def test_das_matches_jax_and_golden(family, interp, iq, coherency):
    p = _params(family, interp, coherency)
    rf = _rf(p, iq)
    out = _port(rf, p, iq)
    ref = golden.das(rf, p)
    coh, inco = _jax_xla(family, interp, iq)
    if coherency:
        out, out_inco = out
        ref, ref_inco = ref
        assert nrmse(inco, out_inco) <= 1e-4
        assert nrmse(ref_inco, out_inco) <= 1e-3
    assert out.shape == POINTS
    assert out.dtype == (np.complex64 if iq else np.float32)
    assert np.abs(ref).max() > 0
    assert nrmse(coh, out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def test_das_matches_pallas_interpret():
    p = _params("readi", InterpolationMode.Linear, coherency=True)
    rf = _rf(p, iq=True)
    coh, inco = _port(rf, p, iq=True)
    st = jax_das.make_static(p, iq=True)
    ref_coh, ref_inco = das_pallas(rf, jax_das.make_dynamic(p), st,
                                   interpret=True)
    assert nrmse(np.asarray(ref_coh), coh) <= 2e-4
    assert nrmse(np.asarray(ref_inco), inco) <= 2e-4


def test_rca_matches_pallas_interpret():
    p = _params("tpw", InterpolationMode.Cubic, coherency=True)
    rf = _rf(p, iq=True)
    coh, inco = _port(rf, p, iq=True)
    st = jax_das.make_static(p, iq=True)
    ref_coh, ref_inco = das_pallas(rf, jax_das.make_dynamic(p), st,
                                   interpret=True)
    assert nrmse(np.asarray(ref_coh), coh) <= 2e-4
    assert nrmse(np.asarray(ref_inco), inco) <= 2e-4


def test_rca_golden_is_the_port_copy():
    """The port's own golden oracle (what the card's canaries hold the
    kernels against) gives the JAX package's golden RCA frame."""
    p = _params("vls", InterpolationMode.Linear, coherency=False)
    rf = _rf(p, iq=True)
    port_p = port_golden.DasParams(**{
        f.name: getattr(p, f.name) for f in dataclasses.fields(p)})
    np.testing.assert_array_equal(port_golden.das(rf, port_p),
                                  golden.das(rf, p))


# ---------------------------------------------------------------------------
# HERCULES family, 3D
# ---------------------------------------------------------------------------

HERC_POINTS = (6, 5, 7)


def _hercules_params(kind, orient, focus, interp, coherency):
    """A HERCULES or UHERCULES frame on a 6 x 5 x 7 grid under the square
    aperture; ``orient`` "tx_rows" transmits on rows and receives on
    columns, "tx_columns" the other way; ``focus`` "plane" or a cylindrical
    focus 6 mm deep, steered 3 degrees.  The XDC transform moves the array
    0.4 mm along x."""
    a, kw = 4, {}
    if kind == "uhercules":
        a, kw = 5, dict(sparse=True,
                        sparse_elements=np.array([0, 2, 4, 6, 7], np.int16))
    tx, rx = (RCAOrientation.Rows, RCAOrientation.Columns)
    if orient == "tx_columns":
        tx, rx = rx, tx
    xdc = np.eye(4, dtype=np.float32)
    xdc[0, 3] = -0.4e-3
    ap = (C - 1) * PITCH
    return golden.DasParams(
        acquisition_kind=(AcquisitionKind.UHERCULES if kind == "uhercules"
                          else AcquisitionKind.HERCULES),
        acquisition_count=a, channel_count=C, sample_count=S,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        voxel_transform=das_transform_3d([0, 0, 1e-3], [ap, ap, 8e-3]),
        xdc_transform=xdc,
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=HERC_POINTS, interpolation_mode=interp,
        transmit_receive_orientation=pack_tx_rx_orientation(tx, rx),
        transmit_angle=3.0, focus_depth=np.inf if focus == "plane" else 6e-3,
        coherency_weighting=coherency, **kw)


@functools.lru_cache(maxsize=None)
def _jax_hercules(kind, orient, focus, interp, iq):
    p = _hercules_params(kind, orient, focus, interp, coherency=True)
    out = jax_das.das_jit(_rf(p, iq), jax_das.make_dynamic(p),
                          jax_das.make_static(p, iq=iq))
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("coherency", [False, True])
@pytest.mark.parametrize("iq", [False, True])
@pytest.mark.parametrize("interp", list(InterpolationMode))
@pytest.mark.parametrize("focus", ["plane", "cylindrical"])
@pytest.mark.parametrize("orient", ["tx_rows", "tx_columns"])
@pytest.mark.parametrize("kind", ["hercules", "uhercules"])
def test_hercules_matches_jax_and_golden(kind, orient, focus, interp, iq,
                                         coherency):
    p = _hercules_params(kind, orient, focus, interp, coherency)
    rf = _rf(p, iq)
    out = _port(rf, p, iq)
    ref = golden.das(rf, p)
    coh, inco = _jax_hercules(kind, orient, focus, interp, iq)
    if coherency:
        out, out_inco = out
        ref, ref_inco = ref
        assert nrmse(inco, out_inco) <= 1e-4
        assert nrmse(ref_inco, out_inco) <= 1e-3
    assert out.shape == HERC_POINTS
    assert out.dtype == (np.complex64 if iq else np.float32)
    assert np.abs(ref).max() > 0
    assert nrmse(coh, out) <= 1e-4
    assert nrmse(ref, out) <= 1e-3


def test_hercules_matches_pallas_interpret():
    p = _hercules_params("hercules", "tx_columns", "cylindrical",
                         InterpolationMode.Linear, coherency=True)
    rf = _rf(p, iq=True)
    coh, inco = _port(rf, p, iq=True)
    ref_coh, ref_inco = das_pallas(rf, jax_das.make_dynamic(p),
                                   jax_das.make_static(p, iq=True),
                                   interpret=True)
    assert np.abs(np.asarray(ref_coh)).max() > 0
    assert nrmse(np.asarray(ref_coh), coh) <= 2e-4
    assert nrmse(np.asarray(ref_inco), inco) <= 2e-4


# ---------------------------------------------------------------------------
# Frame batches
# ---------------------------------------------------------------------------

def _batch_case(family):
    if family == "forces":
        return _params("forces", InterpolationMode.Cubic, True), True
    if family == "hercules":
        return _hercules_params("hercules", "tx_rows", "plane",
                                InterpolationMode.Linear, True), False
    return _params("tpw", InterpolationMode.Cubic, True), True


@pytest.mark.parametrize("family", ["forces", "hercules", "rca"])
def test_frame_batch_matches_jax_batched_das(family):
    """(B, C, A, S) with ``frame_batch = 2`` against the JAX package's
    batched DAS (XLA: ``vmap`` of the single frame); the batch's frames
    equal single-frame calls of the twin."""
    p, iq = _batch_case(family)
    rf = np.stack([_rf(p, iq), _rf(p, iq)[:, :, ::-1].copy()])
    st = jax_das.make_static(p, iq=iq)
    ref_coh, ref_inco = jax_das.das_jit(
        rf, jax_das.make_dynamic(p), dataclasses.replace(st, frame_batch=2))
    dyn = das.make_dynamic(p, "cpu")
    port_st = das.make_static(p, iq=iq)
    coh, inco = das.das(torch.from_numpy(rf), dyn,
                        dataclasses.replace(port_st, frame_batch=2))
    assert coh.shape == (2,) + tuple(p.output_points)
    assert nrmse(np.asarray(ref_coh), coh.numpy()) <= 1e-4
    assert nrmse(np.asarray(ref_inco), inco.numpy()) <= 1e-4
    for b in range(2):
        one_coh, one_inco = das.das(torch.from_numpy(rf[b]), dyn, port_st)
        assert torch.equal(one_coh, coh[b]) and torch.equal(one_inco, inco[b])


def test_frame_batch_rejects_a_wrong_leading_axis():
    p, iq = _batch_case("forces")
    st = dataclasses.replace(das.make_static(p, iq=iq), frame_batch=3)
    rf = torch.from_numpy(np.stack([_rf(p, iq)] * 2))
    with pytest.raises(ValueError, match="batch of 3"):
        das.das(rf, das.make_dynamic(p, "cpu"), st)


def test_undispatched_kind_gives_zero_frame():
    """RACES has no das.glsl dispatch case: the frame stays zero, as in
    golden and the JAX package."""
    p = _params("forces", InterpolationMode.Linear, False)
    p.acquisition_kind = AcquisitionKind.RACES
    out = _port(_rf(p, False), p, False)
    assert out.shape == POINTS and not out.any()


@pytest.mark.parametrize("preset, iq, want", [
    ("quickstart", False, "wide"), ("path_b", True, "wide"),
    ("path_d", False, "narrow")])
def test_index_table_pass_follows_the_sample_spread(preset, iq, want):
    """The FORCES kernel's index table takes the wide pass where a warp's
    voxels read nearby samples (the 2D presets) and the narrow one where
    they are scattered (uFORCES 128^3), as measured on the card."""
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das_cuda
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    from ogl_beamforming_tpu_torch.utils.filters import make_filter
    from ogl_beamforming_tpu_torch import (FilterKind, FilterParameters,
                                           KaiserFilterParameters)
    filters, sparse = {}, None
    if preset == "path_d":
        p, pipe, sparse = presets.uforces_volumetric(channel_count=16,
                                                     acquisition_count=8)
    else:
        p, pipe = presets.forces_compounding(
            channel_count=8, transmit_count=8, sample_count=4096,
            demodulate=preset == "path_b")
        filters = {0: make_filter(FilterParameters(
            kind=FilterKind.Kaiser, sampling_frequency=20e6,
            kaiser=KaiserFilterParameters(2e6, 4.0, 16)))}
    plan = build_plan(p, pipe, filters, sparse_elements=sparse, device="cpu")
    st, dyn = plan.descriptor.stages[-1].das, plan.dyn["das"]
    assert st.iq == iq
    assert das_cuda.index_table_pass(st, dyn) == (
        das_cuda.WIDE_PASS if want == "wide" else das_cuda.NARROW_PASS)


# ---------------------------------------------------------------------------
# The HERCULES and RCA kernels' design on the CPU: the interval walk, the
# sorted transmit table, the lateral runs and the phase reduction
# ---------------------------------------------------------------------------

def _hercules_plan(case):
    """Path C's plan (hercules_3d, 96^3, 128 x 128) on the CPU; "uhercules"
    the same geometry under UHERCULES with its sparse elements shuffled,
    "one_tx" with one transmit."""
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.params.enums import (
        AcquisitionKind as PortKind)
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    sparse = None
    p, pipe = presets.hercules_3d(acquisition_count=1 if case == "one_tx"
                                  else 128)
    if case == "uhercules":
        p.acquisition_kind = PortKind.UHERCULES
        sparse = np.random.default_rng(3).permutation(128).astype(np.int16)
    plan = build_plan(p, pipe, {}, sparse_elements=sparse, device="cpu")
    return plan.descriptor.stages[-1].das, plan.dyn["das"]


def _walk_model(pos, chans, pitch, rx_lat, tx_lat, tests):
    """The kernel's walk over one run in float32 (csrc/das.cu
    das_hercules_kernel, transmit_interval): the (voxel, channel,
    transmit) triples it keeps, the twin's full mask, and the candidates
    it visits."""
    f = np.float32
    n = pos.shape[0]
    test_max = tests.max()
    rx_dd = f(rx_lat) - chans * f(pitch)
    rx_d2 = rx_dd * rx_dd                                     # (C,)
    tx_dd = f(tx_lat) - pos
    d2 = rx_d2[:, None] + tx_dd * tx_dd                       # (C, n)
    full = d2[None] < tests[:, None, None]                    # (V, C, n)
    room = np.maximum(f(test_max) - rx_d2, f(0)) + f(test_max) * f(2 ** -16)
    r = np.sqrt(room) * f(1 + 2 ** -16) + np.abs(f(tx_lat)) * f(2 ** -20)
    j0 = np.maximum(np.searchsorted(pos, f(tx_lat) - r, "left") - 1, 0)
    j1 = np.minimum(np.searchsorted(pos, f(tx_lat) + r, "left"), n - 1)
    j = np.arange(n)
    walked = ((j[None] >= j0[:, None]) & (j[None] <= j1[:, None])
              & (rx_d2 < test_max)[:, None])
    return full & walked[None], full, int(walked.sum())


@pytest.mark.parametrize("case", ["path_c", "uhercules", "one_tx"])
def test_interval_walk_visits_the_full_mask(case):
    """The HERCULES kernel's interval walk over the sorted table keeps
    exactly the twin's (voxel, channel, transmit) triples, at path C's
    geometry on every 12th (x, y) column with all its depths, under
    UHERCULES with shuffled sparse elements and with one transmit."""
    from ogl_beamforming_tpu_torch.ops import das_cuda
    st, dyn = _hercules_plan(case)
    assert das_cuda.lateral_run(st, dyn) == st.output_points[2]
    pos = das_cuda.sorted_transmits(st, dyn)[0].numpy()
    assert (np.diff(pos) >= 0).all()
    xdc = das._apply_m4(dyn["xdc_transform"],
                        das._world_points(st, dyn)).numpy()
    xdc = xdc.reshape(tuple(st.output_points) + (3,))[::12, ::12]
    chans = das._channels(dyn, st.channel_count).numpy()
    fnum = np.float32(dyn["f_number"])
    pitch = np.float32(dyn["xdc_element_pitch"][0])     # receive on columns
    kept = visited = 0
    for col in xdc.reshape(-1, st.output_points[2], 3):
        foz = np.abs(fnum / col[:, 2])
        tests = np.float32(0.25) / (foz * foz)
        walk, full, cand = _walk_model(pos, chans, pitch, col[0, 0],
                                       col[0, 1], tests)
        assert np.array_equal(walk, full)
        kept += int(full.sum())
        visited += cand
    assert kept > 0
    if case != "one_tx":
        # the interval is narrower than the table it searches
        assert visited < 0.6 * chans.size * pos.size * (xdc.size // 3 // 96)


@pytest.mark.parametrize("kind", ["hercules", "uhercules"])
def test_sorted_transmit_table_leaves_the_twin(kind):
    """The twin over the kernel's table, sorted by position, equals the twin
    over the original table to NRMSE 1e-6 (only the order of the transmit
    sum changes); UHERCULES with its sparse elements out of order."""
    from ogl_beamforming_tpu_torch.ops import das_cuda
    p = _hercules_params(kind, "tx_rows", "plane", InterpolationMode.Linear,
                         coherency=False)
    if kind == "uhercules":
        p.sparse_elements = np.array([6, 0, 7, 2, 4], np.int16)
    rf = torch.from_numpy(_rf(p, iq=True))
    dyn, st = das.make_dynamic(p, "cpu"), das.make_static(p, iq=True)
    world = das._world_points(st, dyn)
    table = das_cuda.sorted_transmits(st, dyn)
    if kind == "uhercules":
        assert not torch.equal(table[0], das.transmit_tables(st, dyn)[0])
    ref, _ = das._hercules_block(st, dyn, rf, world)
    out, _ = das._hercules_block(st, dyn, rf, world, table)
    assert np.abs(ref.numpy()).max() > 0
    assert nrmse(ref.numpy(), out.numpy()) <= 1e-6


@pytest.mark.parametrize("case, want", [
    ("hercules_3d", 96), ("plane_wave_2d", 1024), ("tilted_voxels", 1),
    ("tilted_xdc", 1)])
def test_lateral_run_follows_the_transforms(case, want):
    """The plan-time decision that a run of voxels shares its XDC lateral
    coordinates: a column of depths of path C, a line of depths of path A;
    none under a voxel transform tilted about y or an XDC transform whose
    lateral rows read z."""
    from ogl_beamforming_tpu_torch.models import presets
    from ogl_beamforming_tpu_torch.ops import das_cuda
    from ogl_beamforming_tpu_torch.pipeline.plan import build_plan
    if case == "plane_wave_2d":
        p, pipe = presets.plane_wave_2d()
    else:
        p, pipe = presets.hercules_3d()
    if case == "tilted_voxels":
        a = np.radians(5.0)
        rot = np.eye(4, dtype=np.float32)
        rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = (
            np.cos(a), np.sin(a), -np.sin(a), np.cos(a))
        p.das_voxel_transform = (rot @ p.das_voxel_transform).astype(
            np.float32)
    elif case == "tilted_xdc":
        xdc = np.eye(4, dtype=np.float32)
        xdc[1, 2] = 0.05
        p.xdc_transform = xdc
    plan = build_plan(p, pipe, {}, device="cpu")
    st, dyn = plan.descriptor.stages[-1].das, plan.dyn["das"]
    assert das_cuda.lateral_run(st, dyn) == want
    assert das_cuda.launch_tables(st, dyn)["run"] == want


def _cu_constant(text, name):
    import re
    m = re.search(rf"constexpr float {name} = (-?0x[0-9a-f.]+p[+-]?\d+)f;",
                  text)
    return float.fromhex(m.group(1))


def test_exact_phase_reduction_model():
    """A float32 model of the HERCULES and RCA kernels' phase reduction
    (csrc/das.cu pair_weight: k = rint(p / 2 pi), p - k 2 pi with 2 pi in
    three parts, each step one FMA) lands within an ulp of a half turn of
    [-pi, pi] and gives sin and cos within 2e-6 of
    float64 sin and cos of the same float32 argument over [0, 1e4] rad.
    The FMAs are float64 sums rounded once to float32 (exact for the hi and
    mid steps)."""
    from pathlib import Path

    from ogl_beamforming_tpu_torch.ops import das_cuda
    text = (Path(das_cuda.__file__).parent.parent / "csrc" / "das.cu"
            ).read_text()
    split = tuple(_cu_constant(text, n)
                  for n in ("kTwoPiHi", "kTwoPiMid", "kTwoPiLo"))
    assert split == das_cuda.TWO_PI_SPLIT
    inv = np.float32(_cu_constant(text, "kInvTwoPi"))
    assert inv == np.float32(1 / (2 * np.pi))
    rng = np.random.default_rng(11)
    p = np.concatenate([np.linspace(0, 1e4, 1_000_001, dtype=np.float32),
                        rng.uniform(0, 1e4, 1_000_000).astype(np.float32)])
    k = np.rint(p * inv).astype(np.float32)
    r = p
    for part in split:
        r = (-k.astype(np.float64) * np.float32(part)
             + r.astype(np.float64)).astype(np.float32)
    # p / 2 pi rounds to float32 before rint: near a half turn k may be
    # the neighbour, by at most an ulp of p / 2 pi (2^-13 turns at 1e4)
    assert np.abs(r).max() <= np.pi + 2 * np.pi * 2 ** -13
    p64 = p.astype(np.float64)
    assert np.abs(np.sin(r) - np.sin(p64)).max() <= 2e-6
    assert np.abs(np.cos(r) - np.cos(p64)).max() <= 2e-6


def _sass_function(name, loop_loads, pairs_per_body):
    """A cuobjdump-style listing of one function whose pair loop holds
    ``loop_loads`` sample loads and a nested load-free loop."""
    lines = [f"\t\tFunction : {name}",
             "        /*0000*/  MOV R1, c[0x0][0x28] ;", ".L_x_1:"]
    addr = 0x10
    body = (["FADD R2, R2, R3"] + ["LDG.E R4, [R6.64]"] * loop_loads
            + ["FFMA R2, R4, R5, R2"] * pairs_per_body + ["LDS R7, [R8]"])
    for ins in body:
        lines.append(f"        /*{addr:04x}*/  {ins} ;")
        addr += 0x10
    lines.append(".L_x_2:")
    lines.append(f"        /*{addr:04x}*/  IADD3 R9, R9, 0x1, RZ ;")
    addr += 0x10
    lines.append(f"        /*{addr:04x}*/  @P0 BRA `(.L_x_2) ;")
    addr += 0x10
    lines.append(f"        /*{addr:04x}*/  @P1 BRA `(.L_x_1) ;")
    return "\n".join(lines)


def test_sass_pair_loops_count_each_family():
    """kernels/sass.py finds the pair loop of each DAS kernel family's
    instantiation and divides it among the pairs its unrolled body holds
    (a HERCULES linear body of four voxels: eight sample loads), leaving
    out the nested loop."""
    from ogl_beamforming_tpu_torch.kernels import sass
    prefix = "_ZN12_GLOBAL__N_1"
    text = "\n".join([
        _sass_function(prefix + "19das_hercules_kernelILi1ELb0ELb0ELi1EEEvNS_4ArgsE",
                       8, 4),
        _sass_function(prefix + "17das_forces_kernelILi2ELb0ELb0ELi1EEEvNS_4ArgsE",
                       4, 1)])
    herc = sass.pair_loops(text, "hercules")
    forces = sass.pair_loops(text, "forces")
    assert set(herc) == {"linear real fb1"}
    assert set(forces) == {"cubic real fb1"}
    assert sass.pair_loops(text, "rca") == {}
    h = herc["linear real fb1"]
    assert (h["pairs"], h["LDG"], h["LDS"], h["nested"]) == (4, 8, 1, 2)
    assert h["instructions"] == 1 + 8 + 4 + 1 + 1
    assert h["per_pair"] == h["instructions"] / 4
    assert forces["cubic real fb1"]["pairs"] == 1
