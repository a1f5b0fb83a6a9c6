"""Multi-host scale-out: per-host RF feeders into one mesh, the counterpart of
``ogl_beamforming_tpu.parallel.multihost`` on ``torch.distributed``.

The reference's ingest is one producer process writing RF into the shared
scratch (lib/ogl_beamformer_lib.c:491-570).  At cluster scale the
acquisition front end fans out across hosts: each host's feeder owns the
channel rows cabled to it, uploads them to its own cards only, and the DAS
partial volumes are summed across processes (``parallel/sharding.py``).
:func:`feed_rf` places this process's channel rows on its positions of a
host-major mesh: no process ever holds another's RF.

One process (tests, a one-card machine) degenerates cleanly: the local
block is the whole frame and every helper works on a virtual mesh.  The
axis-name parameters keep the JAX package's signatures; the port itself
uses only the defaults (``slab_axis`` of :func:`make_host_mesh` also turns
the slab axis on).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import to_host
from .sharding import (CHANNEL_AXIS, Mesh, ShardedRF, as_frame,
                       device_scope, devices_of, positions_array, world)


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, backend: str = "nccl",
                   timeout: float = 120.0) -> bool:
    """Join the ``torch.distributed`` group of ``num_processes`` feeders
    (no-op when single-process).  ``coordinator_address`` is process 0's
    ``HOST:PORT`` (or a ``tcp://`` URL); ``backend`` is ``"nccl"`` for CUDA
    positions or ``"gloo"``; joining waits at most ``timeout`` seconds.
    Call once per feeder before any device use, as the reference's platform
    layer creates its shared memory before workers start
    (beamformer.c:246-305).  Returns True when a multi-process group was
    initialized."""
    if num_processes in (None, 1):
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address and "
                         "process_id")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=timedelta(seconds=timeout))
    return True


def make_host_mesh(channel_axis: str = CHANNEL_AXIS,
                   slab_axis: str | None = None, slab_devices: int = 1,
                   devices=None) -> Mesh:
    """Global mesh whose channel axis is *host-major*: positions are
    arranged (process, local device), so consecutive channel shards of one
    process land on its cards and a feeder's rows upload over its own PCIe
    only.  ``devices``: this process's (default: its visible CUDA devices);
    every process must bring as many.  With ``slab_axis`` the local devices
    are split channels x slabs, each channel shard's slab group on one
    host."""
    mine = devices_of(devices)
    local = [str(d) for d in mine]
    n_proc = world()[1]
    if n_proc > 1:
        per_rank: list = [None] * n_proc
        # NCCL stages the objects on the current card: this process's own
        with device_scope(mine[0]):
            dist.all_gather_object(per_rank, local)
    else:
        per_rank = [local]
    n_local = len(local)
    if any(len(devs) != n_local for devs in per_rank):
        raise RuntimeError(f"uneven devices per process: "
                           f"{[len(devs) for devs in per_rank]}")
    grid = [(r, torch.device(d)) for r, devs in enumerate(per_rank)
            for d in devs]              # host-major flat order
    group = dist.group.WORLD if n_proc > 1 else None
    if slab_axis is None:
        return Mesh(positions_array(grid, (len(grid),)), (channel_axis,),
                    group)
    total = len(grid)
    if total % slab_devices:
        raise ValueError(f"{total} devices not divisible into "
                         f"{slab_devices} slabs")
    # A channel shard's slab replicas must stay on one host or feed_rf's
    # no-cross-host-copy contract breaks: the local device count must tile
    # into whole slab groups.
    if n_local % slab_devices:
        raise ValueError(
            f"slab_devices={slab_devices} must divide the local device "
            f"count {n_local}: a channel shard's slab group may not span "
            f"hosts")
    return Mesh(positions_array(grid, (total // slab_devices, slab_devices)),
                (channel_axis, slab_axis), group)


def local_channel_slice(channel_count: int) -> slice:
    """The global channel rows this process's feeder owns: the contiguous
    block matching the host-major order of :func:`make_host_mesh`."""
    rank, n_proc = world()
    if channel_count % n_proc:
        raise ValueError(f"channel count {channel_count} not divisible by "
                         f"{n_proc} hosts")
    per = channel_count // n_proc
    return slice(rank * per, (rank + 1) * per)


def feed_rf(rf_local, mesh: Mesh, channel_axis: str = CHANNEL_AXIS
            ) -> ShardedRF:
    """This process's channel rows (``rf_local``, the
    :func:`local_channel_slice` block of a (C, A, S) frame; a tensor or
    numpy) placed on its positions of ``mesh`` and tagged with the global
    shape, ready for a ``shard_plan``-wrapped plan: the multi-host analogue
    of the reference's scratch -> GPU upload (beamformer_core.c:1728-1777).
    ``ValueError`` when a position of this process needs rows of another
    (a mesh not laid out host-major)."""
    rf_local = as_frame(rf_local)
    rank, n_proc = world()
    rows = rf_local.shape[0]
    shape = (rows * n_proc,) + tuple(rf_local.shape[1:])
    n = mesh.shape[channel_axis]
    if shape[0] % n:
        raise ValueError(f"channel count {shape[0]} not divisible by {n} "
                         f"devices")
    per = shape[0] // n
    first = rank * rows
    ax = mesh.axis_names.index(channel_axis)
    blocks = {}
    for idx, dev in mesh.local():
        lo = idx[ax] * per - first
        if lo < 0 or lo + per > rows:
            raise ValueError(f"position {idx} takes channels "
                             f"{lo + first}..{lo + first + per - 1}, outside "
                             f"this process's {first}..{first + rows - 1}")
        blocks[idx] = rf_local[lo:lo + per].to(dev)
    return ShardedRF(mesh, shape, blocks, channel_axis)


def gathered_frame(out) -> np.ndarray:
    """The output volume on this host as numpy.  A sharded plan returns the
    whole volume in every process (summed by ``all_reduce``, its slabs
    brought together by ``all_gather``), so this is its host copy."""
    return np.asarray(to_host(out))
