"""The port's channel, slab and transmit sharding (``ogl_beamforming_tpu_torch.
parallel.sharding``) on an 8-position CPU mesh, against the port's
unsharded plan (NRMSE 1e-5, the bound of ``tests/test_sharding.py``) and
the JAX package's own sharded plan on its 8 virtual CPU devices, from the
same numpy inputs made from a seed (NRMSE 1e-4, the bound
``tests/test_torch_pipeline.py`` holds the port to against JAX).

Every function of ``tests/test_sharding.py`` has a case here; also the
refusals (a batched plan, ``push_batch`` with a mesh), a streaming session
on a meshed Beamformer, the tuning key of a channel shard against JAX's,
and each position's DAS launch scalars carrying its own offsets.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import das_pallas  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, InterpolationMode, RCAOrientation, ShaderKind,
    pack_tx_rx_orientation)
from ogl_beamforming_tpu.params.types import Parameters  # noqa: E402
from ogl_beamforming_tpu.parallel import sharding as jax_sharding  # noqa: E402
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.pipeline.plan import (  # noqa: E402
    build_plan as jax_build_plan)
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)
from ogl_beamforming_tpu_torch import convert  # noqa: E402
from ogl_beamforming_tpu_torch.ops import das_cuda  # noqa: E402
from ogl_beamforming_tpu_torch.parallel import sharding  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    BeamformerError, ErrorKind)
from ogl_beamforming_tpu_torch.pipeline import executor  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline import plan as port_plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import (  # noqa: E402
    PipelineSpec as PortPipelineSpec)
from ogl_beamforming_tpu_torch.runtime.streaming import (  # noqa: E402
    StreamingSession)

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
DECODE_DAS = [ShaderKind.Decode, ShaderKind.DAS]


def _params(c=16, a=4, s=256, nx=12, nz=16, **kw):
    pitch = 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([nx, nz, 1, 0], np.int32))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _plans(p, shaders, data_kind, **kw):
    """The JAX plan and the port's plan (on the CPU) of ``p``."""
    jp = jax_build_plan(p, PipelineSpec.from_shaders(shaders, data_kind), {},
                        voxel_block=128, **kw)
    pp = port_plan.build_plan(
        convert.parameters_from_fields(dataclasses.asdict(p)),
        PortPipelineSpec.from_shaders(shaders, data_kind), {}, device="cpu",
        **kw)
    return jp, pp


def _check(port_sharded, port_plan_, jax_out, rf):
    """The port's sharded frame against its unsharded frame (1e-5) and the
    JAX package's sharded frame (1e-4)."""
    ref = port_plan_(torch.from_numpy(rf)).numpy()
    out = port_sharded(rf).numpy()
    assert out.shape == ref.shape == np.asarray(jax_out).shape
    assert np.abs(ref).max() > 0
    assert nrmse(ref, out) <= 1e-5
    assert nrmse(np.asarray(jax_out), out) <= 1e-4
    return out


def test_eight_positions_available():
    assert len(jax.devices()) == 8
    mesh = sharding.make_mesh(CPU8)
    assert mesh.axis_names == (sharding.CHANNEL_AXIS,)
    assert mesh.shape == {sharding.CHANNEL_AXIS: 8}
    assert len(mesh.local()) == 8 and mesh.group is None
    assert list(mesh.devices) == CPU8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sharding.make_mesh()


@pytest.mark.parametrize("coherency", [False, True])
def test_sharded_decode_das_matches_single(rng, coherency):
    p = _params(coherency_weighting=coherency)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    jmesh = jax_sharding.make_mesh()
    jout = jax_sharding.shard_plan(jp, jmesh)(
        jax_sharding.shard_rf(rf, jmesh))
    mesh = sharding.make_mesh(CPU8)
    splan = sharding.shard_plan(pp, mesh)
    out = _check(splan, pp, jout, rf)
    # a frame placed on the mesh beforehand gives the same frame
    np.testing.assert_array_equal(
        splan(sharding.shard_rf(rf, mesh)).numpy(), out)


def test_sharded_rca_matches_single(rng):
    p = _params(acquisition_kind=AcquisitionKind.Flash,
                transmit_receive_orientation=pack_tx_rx_orientation(
                    RCAOrientation.Columns, RCAOrientation.Columns))
    p.focal_vector = np.array([0.0, np.inf], np.float32)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    jmesh = jax_sharding.make_mesh()
    jout = jax_sharding.shard_plan(jp, jmesh)(
        jax_sharding.shard_rf(rf, jmesh))
    _check(sharding.shard_plan(pp, sharding.make_mesh(CPU8)), pp, jout, rf)


def test_sharded_channel_count_must_divide():
    p = _params(channel_count=12)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    with pytest.raises(ValueError, match="not divisible"):
        jax_sharding.shard_plan(jp, jax_sharding.make_mesh())
    with pytest.raises(ValueError, match="not divisible"):
        sharding.shard_plan(pp, sharding.make_mesh(CPU8))


def _beamformers(p, mesh):
    """A port Beamformer on the CPU with and without ``mesh``, both with
    ``p`` and the decode -> DAS pipeline."""
    out = []
    for m in (None, mesh):
        bf = executor.Beamformer(device="cpu", mesh=m)
        bf.push_parameters(
            convert.parameters_from_fields(dataclasses.asdict(p)))
        bf.push_pipeline(DECODE_DAS, DataKind.Int16)
        out.append(bf)
    return out


def test_executor_with_mesh(rng):
    """Beamformer session running channel-sharded over the mesh."""
    p = _params()
    raw = rng.integers(-1024, 1024, (16, 4 * 256)).astype(np.int16)

    jbf = jax_executor.Beamformer(voxel_block=128,
                                  mesh=jax_sharding.make_mesh())
    jbf.push_parameters(p)
    jbf.push_pipeline(DECODE_DAS, DataKind.Int16)
    jout = jbf.push_data_with_compute(raw).to_numpy()

    bf1, bf8 = _beamformers(p, sharding.make_mesh(CPU8))
    ref = bf1.push_data_with_compute(raw).to_numpy()
    out = bf8.push_data_with_compute(raw).to_numpy()
    assert nrmse(ref, out) <= 1e-5
    assert nrmse(jout, out) <= 1e-4
    assert isinstance(bf8._blocks[0]._plan, sharding.ShardedPlan)
    # one time per planned stage in the stats row, as without a mesh
    times = bf8.compute_timings().times[0]
    assert (times[:2] > 0).all() and (times[2:] == 0).all()

    with pytest.raises(ValueError, match="first position"):
        executor.Beamformer(device="cpu", mesh=sharding.make_mesh(
            [torch.device("meta")] * 2))


def test_sharded_2d_mesh_matches_single(rng):
    """channels x slabs mesh: summed over channels, slab-local output."""
    p = _params(c=16, nx=16, nz=32)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    jmesh = jax_sharding.make_mesh_2d(4, 2)
    jout = jax_sharding.shard_plan_2d(jp, jmesh)(
        jax_sharding.shard_rf_2d(rf, jmesh))
    _check(sharding.shard_plan_2d(pp, sharding.make_mesh_2d(4, 2, CPU8)),
           pp, jout, rf)


def test_sharded_2d_coherency(rng):
    p = _params(c=16, nx=16, nz=32, coherency_weighting=True)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    rf = rng.integers(-1024, 1024, (16, 4, 256)).astype(np.int16)
    jmesh = jax_sharding.make_mesh_2d(2, 4)
    jout = jax_sharding.shard_plan_2d(jp, jmesh)(
        jax_sharding.shard_rf_2d(rf, jmesh))
    _check(sharding.shard_plan_2d(pp, sharding.make_mesh_2d(2, 4, CPU8)),
           pp, jout, rf)


def _tpw(a=8):
    angles = np.linspace(-8, 8, a).astype(np.float32)
    fv = np.stack([angles, np.full(a, np.inf, np.float32)], axis=1)
    p = _params(a=a, acquisition_kind=AcquisitionKind.RCA_TPW,
                decode_mode=0, single_focus=0, single_orientation=1)
    return p, fv


def test_sharded_tx_mesh_matches_single(rng):
    """channels x transmits mesh (multi-angle TPW compounding) parity."""
    p, fv = _tpw()
    jp, pp = _plans(p, [ShaderKind.DAS], DataKind.Float32, focal_vectors=fv)
    rf = rng.standard_normal((16, 8, 256)).astype(np.float32)
    jmesh = jax_sharding.make_mesh_tx(2, 4)
    jout = jax_sharding.shard_plan_tx(jp, jmesh).fn(
        jax_sharding.shard_rf_tx(rf, jmesh), jp.dyn)
    splan = sharding.shard_plan_tx(pp, sharding.make_mesh_tx(2, 4, CPU8))
    _check(splan, pp, jout, rf)
    # each position beamforms its two of the eight steered transmits
    for sh in splan.shards:
        t = sh.index[1]
        assert sh.descriptor.acquisition_count == 2
        np.testing.assert_array_equal(
            sh.dyn["das"]["focal_vectors"].numpy(), fv[2 * t:2 * t + 2])


def test_sharded_tx_rejects_decode():
    p = _params()
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    with pytest.raises(ValueError, match="decode-free"):
        jax_sharding.shard_plan_tx(jp, jax_sharding.make_mesh_tx(2, 4))
    with pytest.raises(ValueError, match="decode-free"):
        sharding.shard_plan_tx(pp, sharding.make_mesh_tx(2, 4, CPU8))
    # and a decode-free plan of another family
    p.decode_mode = 0
    _, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    with pytest.raises(ValueError, match="RCA"):
        sharding.shard_plan_tx(pp, sharding.make_mesh_tx(2, 4, CPU8))


def test_batched_plan_is_refused():
    """A batched plan cannot be sharded (the JAX package's shard_plan
    splits its leading axis, the batch, and fails on it too)."""
    _, pp = _plans(_params(), DECODE_DAS, DataKind.Int16, frame_batch=2)
    with pytest.raises(ValueError, match="batched plan"):
        sharding.shard_plan(pp, sharding.make_mesh(CPU8))


def test_push_batch_refuses_a_mesh(rng):
    bf = _beamformers(_params(), sharding.make_mesh(CPU8))[1]
    raw = rng.integers(-1024, 1024, (2, 16, 4 * 256)).astype(np.int16)
    with pytest.raises(BeamformerError, match="device mesh") as e:
        bf.push_batch(raw)
    assert e.value.kind == ErrorKind.InvalidComputeStage


def test_streaming_session_on_a_mesh(rng):
    """Five frames through a StreamingSession on a meshed Beamformer, each
    equal to the synchronous frame of its raw frame."""
    bf = _beamformers(_params(coherency_weighting=True),
                      sharding.make_mesh(CPU8))[1]
    raws = [rng.integers(-1024, 1024, (16, 4 * 256)).astype(np.int16)
            for _ in range(5)]
    sync = [bf.push_data_with_compute(r).to_numpy() for r in raws]
    with StreamingSession(bf, depth=2) as session:
        handles = [session.submit(r) for r in raws]
        frames = [h.future.result(timeout=60) for h in handles]
        session.drain(timeout=60)
    for frame, want in zip(frames, sync):
        np.testing.assert_array_equal(frame.to_numpy(), want)
    # ten stats rows, each with one time per planned stage
    times = bf.compute_timings().times
    assert (times[:10, :2] > 0).all() and (times[10:] == 0).all()


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_tune_key_of_a_channel_shard(mesh_shape):
    """A shard's DAS tuning key is das_pallas._tune_key of the JAX shard's
    static (``grid_channels``, and the slab's output points)."""
    p = _params(c=16, nx=16, nz=32)
    jp, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    n_ch, n_slab = mesh_shape
    splan = sharding.shard_plan_2d(pp, sharding.make_mesh_2d(n_ch, n_slab,
                                                             CPU8))
    jst = next(sd.das for sd in jp.descriptor.stages if sd.das is not None)
    jst = dataclasses.replace(jst, grid_channels=16 // n_ch,
                              output_points=(16 // n_slab, 32, 1),
                              global_points=(16, 32, 1))
    for sh in splan.shards:
        st = next(sd.das for sd in sh.descriptor.stages if sd.das)
        assert st.local_channels == 16 // n_ch and st.channel_count == 16
        assert das_cuda._tune_key(st) == das_pallas._tune_key(jst)
    # an unsharded plan keys on its whole channel count, as before
    st = next(sd.das for sd in pp.descriptor.stages if sd.das)
    assert das_cuda._tune_key(st)[4] == 16


@pytest.mark.parametrize("kind", ["channels", "slabs", "transmits"])
def test_each_position_launches_its_own_offsets(kind):
    """Each position's DAS launch scalars (``das_cuda.prepare`` of its
    dyn, and ``launch_tables``) carry its own channel_offset and x_offset:
    the global plan's launch tables hold offset 0, and a shard that reused
    them would beamform every channel block as the first one on the card
    (its CPU twin reads the offsets from dyn and would not show it)."""
    if kind == "transmits":
        p, fv = _tpw()
        _, pp = _plans(p, [ShaderKind.DAS], DataKind.Float32,
                       focal_vectors=fv)
    else:
        _, pp = _plans(_params(c=16, nx=16, nz=32), DECODE_DAS,
                       DataKind.Int16)
    st = next(sd.das for sd in pp.descriptor.stages if sd.das)
    # a plan built on a GPU carries launch tables for the global range
    pp.dyn["das"]["launch"] = das_cuda.launch_tables(st, pp.dyn["das"])
    assert pp.dyn["das"]["launch"]["scalars"][19:21].tolist() == [0, 0]
    if kind == "channels":
        splan = sharding.shard_plan(pp, sharding.make_mesh(CPU8))
    elif kind == "slabs":
        splan = sharding.shard_plan_2d(pp, sharding.make_mesh_2d(2, 4, CPU8))
    else:
        splan = sharding.shard_plan_tx(pp, sharding.make_mesh_tx(2, 4, CPU8))
    offsets = set()
    for sh in splan.shards:
        das = sh.dyn["das"]
        want = [sh.channels.start, 4 * sh.slab]      # 16 x over 4 slabs
        assert [int(das["channel_offset"]), int(das["x_offset"])] == want
        assert das_cuda.prepare(das)[19:21].tolist() == want
        assert das["launch"]["scalars"][19:21].tolist() == want
        if kind == "transmits":
            t = sh.index[1]
            np.testing.assert_array_equal(
                das["launch"]["rca"].numpy(),
                pp.dyn["das"]["launch"]["rca"][2 * t:2 * t + 2].numpy())
        offsets.add(tuple(want))
    assert len(offsets) == len(splan.shards) // (4 if kind == "transmits"
                                                 else 1)


def test_each_position_launches_on_its_own_device(monkeypatch):
    """Each position's kernels launch, and its launch tables are built,
    with its own device current: the port's launchers pass the current
    stream's handle, which the CUDA runtime reads on the current device,
    so a position on another card launching under the first card's
    device would address the other card's memory from the first.  The
    device switch is stubbed here to record which position's device is
    current at each decode and DAS launch and each table build, on four
    positions named ``cpu:0`` .. ``cpu:3``."""
    from ogl_beamforming_tpu_torch.ops import das as port_das

    assert isinstance(sharding.device_scope(torch.device("cuda", 1)),
                      torch.cuda.device)
    current = [None]

    @contextlib.contextmanager
    def on(device):
        prev, current[0] = current[0], device
        try:
            yield
        finally:
            current[0] = prev

    seen = {"decode": [], "das": [], "tables": []}

    def recorder(name, fn, offset_of):
        def wrapped(*args):
            seen[name].append((current[0], offset_of(args)))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(sharding, "device_scope", on)
    monkeypatch.setattr(port_plan, "decode_hadamard", recorder(
        "decode", port_plan.decode_hadamard, lambda a: None))
    monkeypatch.setattr(port_das, "das", recorder(
        "das", port_das.das, lambda a: int(a[1]["channel_offset"])))
    monkeypatch.setattr(sharding, "launch_tables", recorder(
        "tables", sharding.launch_tables,
        lambda a: int(a[1]["channel_offset"])))

    p = _params(c=16, nx=16, nz=32)
    _, pp = _plans(p, DECODE_DAS, DataKind.Int16)
    st = next(sd.das for sd in pp.descriptor.stages if sd.das)
    pp.dyn["das"]["launch"] = das_cuda.launch_tables(st, pp.dyn["das"])
    cpus = [torch.device("cpu", k) for k in range(4)]
    splan = sharding.shard_plan(pp, sharding.make_mesh(cpus))
    device_at = {sh.channels.start: sh.device for sh in splan.shards}
    assert [d for d, _ in seen["tables"]] == cpus
    assert all(device_at[o] == d for d, o in seen["tables"])

    rf = np.random.default_rng(7).integers(
        -1024, 1024, (16, p.acquisition_count, p.sample_count)
    ).astype(np.int16)
    splan(rf)
    assert [d for d, _ in seen["decode"]] == cpus
    assert [d for d, _ in seen["das"]] == cpus
    assert all(device_at[o] == d for d, o in seen["das"])
    assert current[0] is None
