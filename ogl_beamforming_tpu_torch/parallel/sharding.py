"""Multi-card execution: channel-axis sharding over a mesh of positions, the
counterpart of ``ogl_beamforming_tpu.parallel.sharding``.

The reference's scale axis is the 16-channel chunk loop that re-runs the
pre-DAS stages per chunk and accumulates DAS into the frame
(beamformer_core.c:1577-1587, das.glsl:406).  Here that channel axis is the
distributed axis: every pre-DAS stage (decode, filter/demodulate, Hilbert)
is channel-wise independent, and the DAS accumulation commutes with a
channel split, so each position of the mesh runs the whole plan on its
channel block with *global* element indices (the ``channel_offset`` push
constant, das.glsl:215) and the partial volumes are summed.  Coherency
weighting divides accumulated coherent energy by accumulated incoherent
energy, so it runs once, after the sum.

A :class:`Mesh` is an array of positions ``(rank, torch.device)`` shaped per
axis.  ``make_mesh([torch.device("cuda", 0)] * n)`` is a virtual mesh on one
card (its positions run one after another there, as the JAX package's
virtual CPU devices repeat one host); a mesh from
``multihost.make_host_mesh`` spans the processes of a ``torch.distributed``
group.  Each position's plan is built once, when the plan is sharded: its
descriptor with its own channel count (``DasStatic.grid_channels``), slab
(``output_points`` and ``global_points``) or transmits, and a copy of the
dynamic parameters on its device with its ``channel_offset``, ``x_offset``
and slices of the per-transmit tables.  Its DAS launch tables are built
again from that copy: the kernel's scalar vector holds both offsets, so the
global plan's tables (offset 0) are never reused by a shard.

Each position runs with its device as the current CUDA device: the port's
kernel launchers pass the current stream's handle, and the CUDA runtime
reads a default stream's handle (0) on the current device.  After each
stage the first position's stream waits for the other cards' streams, so
the executor's stage clock, which records there, spans every position.
Positions sum their partial volumes in mesh order on the process's first
position's device; across processes the sum is ``dist.all_reduce``, and
slabs that other processes hold arrive by ``dist.all_gather``.  The
collectives run on the volume's own device: NCCL takes CUDA tensors, and
gloo took CUDA tensors for both collectives on the H100 machine.

The axis-name parameters of the mesh, plan and frame functions keep the
JAX package's signatures; the port itself uses only the defaults,
:data:`CHANNEL_AXIS`, :data:`SLAB_AXIS` and :data:`TRANSMIT_AXIS`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.coherency import coherency_weighting
from ..ops.das import _zero_frame
from ..ops.das_cuda import launch_tables
from ..params.enums import ShaderKind
from ..pipeline.plan import CompiledPlan, PlanDescriptor, stage_steps
from ..utils.device import resolve_device

CHANNEL_AXIS = "channels"
SLAB_AXIS = "slabs"
TRANSMIT_AXIS = "transmits"


def world() -> tuple[int, int]:
    """This process's rank and the size of the default group, (0, 1)
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """Positions ``(rank, torch.device)`` in an object array shaped per axis
    (``axis_names``), and the process group they span, or ``None`` when
    this process holds every position."""

    positions: np.ndarray
    axis_names: tuple[str, ...]
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.positions.shape))

    @property
    def size(self) -> int:
        return self.positions.size

    @property
    def devices(self) -> np.ndarray:
        out = np.empty(self.positions.shape, dtype=object)
        for idx, (_, dev) in np.ndenumerate(self.positions):
            out[idx] = dev
        return out

    def local(self) -> list[tuple[tuple[int, ...], torch.device]]:
        """``(mesh index, device)`` of this process's positions, in mesh
        order."""
        rank = None if self.group is None else world()[0]
        return [(idx, dev) for idx, (r, dev) in np.ndenumerate(self.positions)
                if rank is None or r == rank]

    def home(self) -> torch.device:
        """The device of this process's first position."""
        local = self.local()
        if not local:
            raise ValueError("this process holds no position of the mesh")
        return local[0][1]


def devices_of(devices) -> list[torch.device]:
    """``devices`` as torch devices (``cuda`` as the current CUDA device's
    index); by default every visible CUDA device (``RuntimeError`` when
    there is none)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("a mesh over the visible CUDA devices needs "
                               "one: torch.cuda.is_available() is False")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    out = [resolve_device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in out]


def device_scope(device: torch.device):
    """A context in which ``device`` is the current CUDA device (nothing
    for a CPU position)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def positions_array(grid, shape) -> np.ndarray:
    """An object array of ``shape`` holding the ``(rank, device)`` pairs of
    ``grid`` in C order."""
    arr = np.empty(len(grid), dtype=object)
    for i, pos in enumerate(grid):
        arr[i] = pos
    return arr.reshape(shape)


def _local_mesh(devices, shape, axis_names) -> Mesh:
    n = int(np.prod(shape))
    devs = devices_of(devices)
    if len(devs) < n:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs {n} "
                         f"devices, got {len(devs)}")
    rank = world()[0]
    return Mesh(positions_array([(rank, d) for d in devs[:n]], shape),
                tuple(axis_names))


def make_mesh(devices=None, axis_name: str = CHANNEL_AXIS) -> Mesh:
    """1-D mesh over all visible CUDA devices (or ``devices``); the single
    axis is the channel axis."""
    devs = devices_of(devices)
    return _local_mesh(devs, (len(devs),), (axis_name,))


def make_mesh_2d(channel_devices: int, slab_devices: int, devices=None,
                 channel_axis: str = CHANNEL_AXIS,
                 slab_axis: str = SLAB_AXIS) -> Mesh:
    """2-D mesh: channel axis (summed DAS accumulation) x slab axis
    (independent x slabs of the output volume)."""
    return _local_mesh(devices, (channel_devices, slab_devices),
                       (channel_axis, slab_axis))


def make_mesh_tx(channel_devices: int, transmit_devices: int, devices=None,
                 channel_axis: str = CHANNEL_AXIS,
                 transmit_axis: str = TRANSMIT_AXIS) -> Mesh:
    """2-D mesh: channels x transmits.  Both axes sum into the DAS volume;
    each position beamforms its subset of the steered transmits."""
    return _local_mesh(devices, (channel_devices, transmit_devices),
                       (channel_axis, transmit_axis))


@dataclass(frozen=True, eq=False)
class ShardedRF:
    """A (C, A, S) frame placed on a mesh: ``blocks`` maps each of this
    process's positions (mesh index) to its block, on its device: its
    channel rows (``axis_name``) and, when ``transmit_axis`` is set, only
    its acquisitions along that axis; ``shape`` is the global frame's."""

    mesh: Mesh
    shape: tuple[int, ...]
    blocks: dict
    axis_name: str = CHANNEL_AXIS
    transmit_axis: str | None = None


def as_frame(rf) -> torch.Tensor:
    if isinstance(rf, torch.Tensor):
        return rf
    return torch.from_numpy(np.ascontiguousarray(rf))


@dataclass(frozen=True, eq=False)
class RFSharding:
    """How a (C, A, S) frame lies on ``mesh``, the counterpart of the JAX
    package's ``NamedSharding`` of it: each position takes the channel
    rows of its index along ``channel_axis`` and, with ``transmit_axis``,
    only the acquisitions of its index along that axis.  Along an axis it
    names neither, every index holds the same block."""

    mesh: Mesh
    channel_axis: str = CHANNEL_AXIS
    transmit_axis: str | None = None

    def _part(self, index, size: int, axis: str, what: str) -> slice:
        n = self.mesh.shape[axis]
        if size % n:
            raise ValueError(f"{what} {size} not divisible by {n} devices")
        k = index[self.mesh.axis_names.index(axis)]
        return slice(k * (size // n), (k + 1) * (size // n))

    def block(self, index, shape) -> tuple[slice, slice]:
        """The (channel rows, acquisitions) of a frame of ``shape`` that
        the position at mesh ``index`` takes."""
        rows = self._part(index, shape[0], self.channel_axis,
                          "channel count")
        if self.transmit_axis is None:
            return rows, slice(None)
        return rows, self._part(index, shape[1], self.transmit_axis,
                                "acquisition count")

    def place(self, rf) -> ShardedRF:
        """A whole (C, A, S) frame (a tensor or numpy) placed by this
        sharding on this process's positions."""
        rf = as_frame(rf)
        blocks = {idx: rf[self.block(idx, rf.shape)].to(dev).contiguous()
                  for idx, dev in self.mesh.local()}
        return ShardedRF(self.mesh, tuple(rf.shape), blocks,
                         self.channel_axis, self.transmit_axis)


def rf_sharding(mesh: Mesh, axis_name: str = CHANNEL_AXIS) -> RFSharding:
    """The sharding of a (C, A, S) frame split by channel rows over
    ``mesh``'s ``axis_name``."""
    return RFSharding(mesh, axis_name)


def shard_rf(rf, mesh: Mesh, axis_name: str = CHANNEL_AXIS) -> ShardedRF:
    """Place a whole (C, A, S) frame (a tensor or numpy) on ``mesh``: each
    of this process's positions gets the channel rows of its index along
    ``axis_name`` (:func:`rf_sharding`)."""
    return rf_sharding(mesh, axis_name).place(rf)


def shard_rf_2d(rf, mesh: Mesh, channel_axis: str = CHANNEL_AXIS
                ) -> ShardedRF:
    """A whole frame placed on a channels x slabs mesh (``make_mesh_2d``):
    each position gets its channel block, on every slab."""
    return rf_sharding(mesh, channel_axis).place(rf)


def shard_rf_tx(rf, mesh: Mesh, channel_axis: str = CHANNEL_AXIS,
                transmit_axis: str = TRANSMIT_AXIS) -> ShardedRF:
    """A whole frame placed on a channels x transmits mesh
    (``make_mesh_tx``): each position gets only its (channel block,
    transmit block), which a ``shard_plan_tx`` plan takes as it is."""
    return RFSharding(mesh, channel_axis, transmit_axis).place(rf)


@dataclass
class Shard:
    """One position's share of a sharded plan: its descriptor and dynamic
    parameters (on its device, with its own DAS launch tables), and the
    channels, acquisitions and slab it takes."""

    index: tuple[int, ...]
    device: torch.device
    descriptor: PlanDescriptor
    dyn: dict
    channels: slice
    acquisitions: slice
    slab: int


def _shard_dyn(dyn: dict, st, device, channel_offset: int, x_offset: int,
               acquisitions: slice | None) -> dict:
    """``dyn`` on ``device`` with a shard's offsets and per-transmit tables,
    and DAS launch tables built for them where the plan had some or the
    shard runs on a GPU."""
    out = {k: v.to(device) for k, v in dyn.items() if k != "das"}
    das = {k: v.to(device) for k, v in dyn["das"].items() if k != "launch"}
    das["channel_offset"] = torch.tensor(channel_offset, dtype=torch.int32,
                                         device=device)
    das["x_offset"] = torch.tensor(x_offset, dtype=torch.int32,
                                   device=device)
    if acquisitions is not None:
        for k in ("focal_vectors", "orientations", "sparse_elements"):
            das[k] = das[k][acquisitions].contiguous()
    if st.family != "none" and ("launch" in dyn["das"]
                                or device.type == "cuda"):
        with device_scope(device):
            das["launch"] = launch_tables(st, das)
    out["das"] = das
    return out


class ShardedPlan:
    """A plan run over a mesh, called like ``CompiledPlan``:
    ``plan(rf, mark=None)`` with a whole (C, A, S_wire) frame (a tensor on
    any device, or numpy) or a :class:`ShardedRF` (``shard_rf``,
    ``multihost.feed_rf``).  Returns the whole volume, coherency-weighted
    where the plan weights, on this process's first position's device, in
    every process.  ``mark`` is called once a stage, after every position
    ran it (the DAS stage's includes the sum and the weighting), so a stats
    row holds one time per planned stage.  ``descriptor`` and ``dyn`` are
    the global plan's; ``shards`` this process's positions' (a position
    whose index along an axis the plan does not shard is not its axis'
    first is a replica and runs nothing, as a replicated JAX axis computes
    the same shard)."""

    def __init__(self, plan: CompiledPlan, mesh: Mesh, channel_axis: str,
                 slab_axis: str | None = None,
                 transmit_axis: str | None = None):
        desc = plan.descriptor
        if desc.frame_batch > 1:
            raise ValueError(f"a batched plan (frame_batch={desc.frame_batch})"
                             f" cannot be sharded: shard the channel axis or "
                             f"batch frames, not both")
        st = next((sd.das for sd in desc.stages if sd.das is not None), None)
        if st is None:
            raise ValueError("sharding needs a DAS stage: the partial volumes "
                             "of channel shards are what is summed")
        names = mesh.axis_names
        for axis in (channel_axis, slab_axis, transmit_axis):
            if axis is not None and axis not in names:
                raise ValueError(f"mesh axes {names} have no {axis!r}")
        n_ch = mesh.shape[channel_axis]
        n_slab = mesh.shape[slab_axis] if slab_axis else 1
        n_tx = mesh.shape[transmit_axis] if transmit_axis else 1
        if desc.channel_count % n_ch:
            raise ValueError(f"channel count {desc.channel_count} not "
                             f"divisible by {n_ch} devices")
        gnx, gny, gnz = st.output_points
        if gnx % n_slab:
            raise ValueError(f"output x extent {gnx} not divisible by "
                             f"{n_slab} slabs")
        if desc.acquisition_count % n_tx:
            raise ValueError(f"acquisition count {desc.acquisition_count} "
                             f"not divisible by {n_tx}")
        local_channels = desc.channel_count // n_ch
        nx_local = gnx // n_slab
        local_acqs = desc.acquisition_count // n_tx

        # Kernel grids iterate the local channel shard; element geometry
        # keeps the global channel count.
        st_local = dataclasses.replace(st, grid_channels=local_channels)
        if slab_axis:
            st_local = dataclasses.replace(
                st_local, output_points=(nx_local, gny, gnz),
                global_points=(gnx, gny, gnz))
        if transmit_axis:
            st_local = dataclasses.replace(st_local,
                                           acquisition_count=local_acqs)
        local_desc = dataclasses.replace(
            desc, acquisition_count=local_acqs, stages=tuple(dataclasses.replace(sd, das=st_local)
                         if sd.das is not None else sd
                         for sd in desc.stages))

        self.descriptor = desc
        self.dyn = plan.dyn
        self.mesh = mesh
        self.channel_axis = channel_axis
        self.transmit_axis = transmit_axis
        self.home = mesh.home()
        self._others = [] if self.home.type != "cuda" else sorted(
            {dev.index for _, dev in mesh.local()
             if dev.type == "cuda" and dev.index != self.home.index})
        self.n_slab = n_slab
        self._slab_static = st_local
        axes = {names.index(a): a for a in (channel_axis, slab_axis,
                                            transmit_axis) if a}
        ci = names.index(channel_axis)
        si = names.index(slab_axis) if slab_axis else None
        ti = names.index(transmit_axis) if transmit_axis else None
        self.shards: list[Shard] = []
        for idx, dev in mesh.local():
            if any(idx[k] for k in range(len(names)) if k not in axes):
                continue                # a replica along an unsharded axis
            c, s = idx[ci], idx[si] if si is not None else 0
            acqs = (slice(idx[ti] * local_acqs, (idx[ti] + 1) * local_acqs)
                    if ti is not None else None)
            self.shards.append(Shard(
                index=idx, device=dev, descriptor=local_desc,
                dyn=_shard_dyn(plan.dyn, st_local, dev, c * local_channels,
                               s * nx_local, acqs),
                channels=slice(c * local_channels, (c + 1) * local_channels),
                acquisitions=acqs or slice(None), slab=s))
        # Across processes: all_gather when each slab's positions are all
        # on one process, the processes holding equal runs of slabs in rank
        # order; otherwise every process sums its partial volume of the
        # whole x extent (zeros where it holds no position of a slab) and
        # all_reduce adds them.
        self.gathers_slabs = False
        if mesh.group is not None:
            owner = {}
            for idx, (rank, _) in np.ndenumerate(mesh.positions):
                owner.setdefault(idx[si] if si is not None else 0,
                                 set()).add(rank)
            world = dist.get_world_size(mesh.group)
            per = n_slab // world if n_slab % world == 0 else 0
            self.gathers_slabs = per > 0 and all(
                owner[s] == {s // per} for s in range(n_slab))

    def _blocks(self, rf) -> list[torch.Tensor]:
        if isinstance(rf, ShardedRF):
            if rf.axis_name != self.channel_axis or \
                    rf.transmit_axis not in (None, self.transmit_axis) or \
                    rf.mesh.positions.shape != self.mesh.positions.shape:
                raise ValueError("the frame was placed on another mesh")
            if rf.shape[0] != self.descriptor.channel_count:
                raise ValueError(f"frame of {rf.shape[0]} channels, plan of "
                                 f"{self.descriptor.channel_count}")
            if rf.transmit_axis:        # placed with its transmits only
                return [rf.blocks[sh.index] for sh in self.shards]
            return [rf.blocks[sh.index][:, sh.acquisitions].contiguous()
                    for sh in self.shards]
        rf = as_frame(rf)
        if rf.shape[0] != self.descriptor.channel_count:
            raise ValueError(f"frame of {rf.shape[0]} channels, plan of "
                             f"{self.descriptor.channel_count}")
        return [rf[sh.channels, sh.acquisitions].to(sh.device).contiguous()
                for sh in self.shards]

    def __call__(self, rf, mark=None):
        blocks = self._blocks(rf)
        steps = [stage_steps(sh.descriptor, x, sh.dyn,
                             skip_coherency_normalize=True)
                 for sh, x in zip(self.shards, blocks)]
        outs: list = [None] * len(steps)
        n_stages = len(self.descriptor.stages)
        for k in range(n_stages):
            for j, (sh, step) in enumerate(zip(self.shards, steps)):
                with device_scope(sh.device):
                    outs[j] = next(step)
            self._join()
            if k == n_stages - 1:       # the DAS stage (the planner's last)
                volume = self._combine(outs)
            if mark is not None:
                mark()
        return volume

    def _join(self) -> None:
        """Make :attr:`home`'s current stream wait for the other cards'
        current streams (none on a one-card or CPU mesh)."""
        if not self._others:
            return
        home = torch.cuda.current_stream(self.home)
        for index in self._others:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(index))
            home.wait_event(event)

    def _combine(self, outs):
        """Sum the shards' partial volumes in mesh order, slab by slab, on
        :attr:`home`; then across processes; then coherency weighting."""
        home = self.home
        slabs: list = [None] * self.n_slab
        for sh, out in zip(self.shards, outs):
            out = _each(lambda t: t.to(home), out)
            prev = slabs[sh.slab]
            slabs[sh.slab] = out if prev is None else _each(
                torch.add, prev, out)
        group = self.mesh.group
        if group is None:
            volume = _cat(slabs)
        elif self.gathers_slabs:
            volume = _each(lambda t: _all_gather_x(t, group),
                           _cat([s for s in slabs if s is not None]))
        else:
            zero = _zero_frame(self._slab_static, home)
            volume = _cat([zero if s is None else s for s in slabs])
            _each(lambda t: dist.all_reduce(t, group=group), volume)
        if self.descriptor.coherency_weighting:
            return coherency_weighting(*volume)
        return volume


def _each(fn, *xs):
    """``fn`` over a volume, or over each of a ``(coherent, incoherent)``
    pair (elementwise over several)."""
    if isinstance(xs[0], tuple):
        return tuple(fn(*parts) for parts in zip(*xs))
    return fn(*xs)


def _cat(slabs: list):
    """Slabs concatenated along x (a single slab as it is)."""
    if len(slabs) == 1:
        return slabs[0]
    return _each(lambda *ts: torch.cat(ts, dim=0), *slabs)


def _all_gather_x(t: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def shard_plan(plan: CompiledPlan, mesh: Mesh,
               axis_name: str = CHANNEL_AXIS) -> ShardedPlan:
    """``plan`` run channel-sharded over ``mesh``: each position beamforms
    its channel block and the partial volumes are summed."""
    return ShardedPlan(plan, mesh, axis_name)


def shard_plan_2d(plan: CompiledPlan, mesh: Mesh,
                  channel_axis: str = CHANNEL_AXIS,
                  slab_axis: str = SLAB_AXIS) -> ShardedPlan:
    """``plan`` over a channels x slabs mesh: the DAS accumulation is
    summed over the channel axis while each position beamforms its x slab
    of the output (the scale-out shape for large volumes)."""
    return ShardedPlan(plan, mesh, channel_axis, slab_axis=slab_axis)


def shard_plan_tx(plan: CompiledPlan, mesh: Mesh,
                  channel_axis: str = CHANNEL_AXIS,
                  transmit_axis: str = TRANSMIT_AXIS) -> ShardedPlan:
    """An RCA compounding plan (TPW/VLS/Flash) over a channels x transmits
    mesh: every per-acquisition quantity lives in the dynamic tables
    (orientations, focal vectors), so each position beamforms its
    (channel, transmit) tile and the volume is summed over both axes.  A
    plan with Decode is refused: Hadamard decode contracts over the
    transmit axis."""
    if any(sd.kind == ShaderKind.Decode for sd in plan.descriptor.stages):
        raise ValueError("transmit sharding requires a decode-free pipeline "
                         "(Hadamard decode contracts over transmits)")
    st = next((sd.das for sd in plan.descriptor.stages if sd.das), None)
    if st is None or st.family != "rca":
        raise ValueError("transmit sharding supports the RCA compounding "
                         "family (TPW/VLS/Flash)")
    return ShardedPlan(plan, mesh, channel_axis, transmit_axis=transmit_axis)
