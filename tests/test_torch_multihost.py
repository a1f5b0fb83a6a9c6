"""The port's multi-host feeders (``ogl_beamforming_tpu_torch.parallel.
multihost``) on the CPU: the cases of ``tests/test_multihost.py`` one by
one (the single-process behaviour every helper must keep: host-major mesh
order, local channel ownership, the fed frame against the unsharded plan),
and two gloo ranks on the CPU, each feeding only its own channel rows.
This file is its own worker (``python tests/test_torch_multihost.py RANK
WORLD PORT OUT [BACKEND]``), each rank single-threaded; the ranks are
joined under a timeout and killed if they outlive it.  Also
``entry.dryrun_multichip`` on CPU positions, and (marked ``cuda``, on a
machine with two cards or more) the same two-process feed with NCCL, rank
r on cuda:r.

Frames are held against the port's unsharded plan (NRMSE 1e-5) and the JAX
package's plan of the same case (NRMSE 1e-4).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu_torch import entry  # noqa: E402
from ogl_beamforming_tpu_torch.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, InterpolationMode, ShaderKind)
from ogl_beamforming_tpu_torch.params.types import Parameters  # noqa: E402
from ogl_beamforming_tpu_torch.parallel import (  # noqa: E402
    multihost, sharding)
from ogl_beamforming_tpu_torch.pipeline.plan import build_plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu_torch.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)

torch.set_num_threads(1)

CPU = torch.device("cpu")
RANK_TIMEOUT = 120


def _case(device="cpu"):
    """The 16-channel FORCES case of ``tests/multihost_worker.make_case``
    (the same parameters and seeded frame) as a port plan on ``device``."""
    c, a, s = 16, 4, 256
    pitch = 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [15 * pitch, 10e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([16, 32, 1, 0], np.int32))
    plan = build_plan(p, PipelineSpec.from_shaders(
        [ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16), {},
        device=device)
    rf = np.random.default_rng(0x0621).integers(
        -512, 512, (c, a, s)).astype(np.int16)
    return plan, rf


def _reference(plan, rf):
    """The port's unsharded frame, checked against the JAX package's plan
    of the same case."""
    import multihost_worker
    ref = plan(torch.from_numpy(rf)).numpy()
    jplan, jrf = multihost_worker.make_case()
    np.testing.assert_array_equal(jrf, rf)
    assert nrmse(np.asarray(jplan(jrf)), ref) <= 1e-4
    assert np.abs(ref).max() > 0
    return ref


def test_init_single_process_noop():
    assert multihost.init_multihost() is False
    assert multihost.init_multihost(num_processes=1) is False
    assert not dist.is_initialized()


def test_host_mesh_orders_devices_host_major():
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = multihost.make_host_mesh(devices=devs)
    assert mesh.axis_names == (sharding.CHANNEL_AXIS,)
    assert mesh.size == 8 and mesh.group is None
    # single process: host-major order is just device order
    assert list(mesh.devices.reshape(-1)) == devs
    assert {r for r, _ in mesh.positions.reshape(-1)} == {0}

    mesh2 = multihost.make_host_mesh(slab_axis=sharding.SLAB_AXIS,
                                     slab_devices=2, devices=devs)
    assert mesh2.devices.shape == (4, 2)
    assert mesh2.axis_names == (sharding.CHANNEL_AXIS, sharding.SLAB_AXIS)
    with pytest.raises(ValueError, match="not divisible into 3 slabs"):
        multihost.make_host_mesh(slab_axis=sharding.SLAB_AXIS,
                                 slab_devices=3, devices=devs)


def test_local_channel_slice_covers_everything():
    sl = multihost.local_channel_slice(64)
    assert (sl.start, sl.stop) == (0, 64)      # single process owns all
    assert multihost.local_channel_slice(63) == slice(0, 63)


def test_feed_rf_matches_unsharded_pipeline():
    plan, rf = _case()
    ref = _reference(plan, rf)

    mesh = multihost.make_host_mesh(devices=[CPU] * 8)
    local = rf[multihost.local_channel_slice(rf.shape[0])]
    fed = multihost.feed_rf(local, mesh)
    assert fed.shape == rf.shape
    assert sorted(fed.blocks) == [(i,) for i in range(8)]
    for (i,), block in fed.blocks.items():
        np.testing.assert_array_equal(block.numpy(), rf[2 * i:2 * i + 2])

    out = sharding.shard_plan(plan, mesh)(fed)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-4)
    assert nrmse(ref, out.numpy()) <= 1e-5
    assert multihost.gathered_frame(out).shape == ref.shape


def test_two_process_feed_rf_matches_single_process(tmp_path):
    """Two gloo ranks on the CPU, four positions each: each rank feeds only
    its local channel rows; the frames rank 0 gathers must match the
    single-process plan: channels summed across the ranks by all_reduce (a
    1-D mesh and a channels x slabs mesh), and slabs held by one rank each
    brought together by all_gather."""
    plan, rf = _case()
    ref = _reference(plan, rf)
    got = _run_ranks(tmp_path, "gloo")
    assert sorted(got.files) == ["channels", "slabs", "slabs_across"]
    for name in got.files:
        assert got[name].shape == ref.shape, name
        assert nrmse(ref, got[name]) <= 1e-5, name


@pytest.mark.cuda
def test_two_nccl_ranks_on_two_cards_match_single_process(tmp_path):
    """The two-process feed with NCCL, rank r on cuda:r (no rank sets its
    current device: the port does), against the unsharded plan on cuda:0
    (NRMSE 1e-5) and the CPU plan (1e-4, the kernels against their
    twins)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    plan, rf = _case("cuda:0")
    ref = plan(torch.from_numpy(rf).cuda()).cpu().numpy()
    cpu_plan, _ = _case()
    assert nrmse(cpu_plan(torch.from_numpy(rf)).numpy(), ref) <= 1e-4
    got = _run_ranks(tmp_path, "nccl")
    assert sorted(got.files) == ["channels", "slabs", "slabs_across"]
    for name in got.files:
        assert got[name].shape == ref.shape, name
        assert nrmse(ref, got[name]) <= 1e-5, name


def _run_ranks(tmp_path, backend: str):
    """Two ranks of this file's worker on ``backend``, joined under
    RANK_TIMEOUT and killed if they outlive it; rank 0's frames."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = tmp_path / "mh_out.npz"
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo] + ([os.environ["PYTHONPATH"]]
                  if os.environ.get("PYTHONPATH") else [])))
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(i), "2", str(port), str(out),
         backend], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for p in procs:
            o, _ = p.communicate(timeout=RANK_TIMEOUT)
            assert p.returncode == 0, o.decode(errors="replace")[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return np.load(out)


@pytest.mark.parametrize("n_devices", [8, 3])
def test_dryrun_multichip_on_cpu_positions(n_devices):
    entry.dryrun_multichip(n_devices, device="cpu")


def _worker(rank: int, world: int, port: str, out_path: str,
            backend: str = "gloo") -> None:
    """One rank of the two-process tests (no JAX here): gloo with its
    positions on the CPU, or NCCL with rank r's on cuda:r."""
    assert multihost.init_multihost(f"localhost:{port}", world, rank,
                                    backend=backend, timeout=RANK_TIMEOUT)

    def device(r):
        return CPU if backend == "gloo" else torch.device("cuda", r)

    try:
        plan, rf = _case(device(rank))
        local = rf[multihost.local_channel_slice(rf.shape[0])]
        results = {}

        mesh = multihost.make_host_mesh(devices=[device(rank)] * 4)
        assert mesh.size == 4 * world and len(mesh.local()) == 4
        fed = multihost.feed_rf(local, mesh)
        assert fed.shape == rf.shape
        results["channels"] = multihost.gathered_frame(
            sharding.shard_plan(plan, mesh)(fed))

        mesh2 = multihost.make_host_mesh(slab_axis=sharding.SLAB_AXIS,
                                         slab_devices=2,
                                         devices=[device(rank)] * 4)
        results["slabs"] = multihost.gathered_frame(
            sharding.shard_plan_2d(plan, mesh2)(
                multihost.feed_rf(local, mesh2)))

        # slab s on rank s, its four channel shards there (whole frames)
        grid = [(s, device(s)) for _ in range(4) for s in range(world)]
        mesh3 = sharding.Mesh(sharding.positions_array(grid, (4, world)),
                              (sharding.CHANNEL_AXIS, sharding.SLAB_AXIS),
                              dist.group.WORLD)
        splan3 = sharding.shard_plan_2d(plan, mesh3)
        assert splan3.gathers_slabs             # the all_gather layout
        results["slabs_across"] = multihost.gathered_frame(splan3(rf))
        if rank == 0:
            np.savez(out_path, **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            *sys.argv[5:6])
