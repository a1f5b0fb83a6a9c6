"""Beamformer executor: the torch counterpart of
``ogl_beamforming_tpu.pipeline.executor``.

Parameter blocks with dirty tracking, four filter slots per block, a frame
backlog with N-most-recent export, and the exported compute-timing stats
table, on one explicit device.  Each frame's stages run eagerly and are
bracketed by CUDA events (on the GPU) or host clock reads (on the CPU, where
torch runs synchronously), so the stats table holds true per-stage times.
A frame is enqueued (:meth:`Beamformer._enqueue`) and its times read once
its last event has completed (:meth:`Beamformer._finish`): the synchronous
path does both in turn, the streaming session (``runtime/streaming.py``)
reads frame n's times while frame n + 1 runs.
:meth:`Beamformer.push_batch` beamforms B frames per call through a batched
plan, and :meth:`Beamformer.averaged_frame` averages the newest frames.
With ``mesh=`` every plan runs channel-sharded over the mesh's positions
(``parallel/sharding.py``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..params.constants import (FILTER_SLOTS, MAX_CHANNEL_COUNT,
                                MAX_EMISSIONS_COUNT, MAX_PARAMETER_BLOCKS)
from ..params.enums import (BeamformerError, ContrastMode, ErrorKind,
                            LiveImagingDirtyFlags, ViewPlaneTag)
from ..params.types import (FilterParameters, LiveImagingParameters,
                            Parameters, SimpleParameters)
from ..ops.display import sum_frames
from ..runtime.upload import (mapping_rows, prepare_rf, prepare_rf_device,
                              raw_columns)
from ..utils.device import resolve_device, to_host
from ..utils.filters import Filter, make_filter
from .plan import CompiledPlan, build_plan
from .spec import (PipelineSpec, validate_block, validate_parameters,
                   validate_pipeline)
from .stats import ComputeStats


@dataclass
class Frame:
    """A beamformed frame (reference: BeamformerFrame).

    A frame enters the backlog once its kernels are enqueued, before they
    finish.  They run on the device's default stream, which is every
    thread's current stream unless the thread sets another, so a reader in
    any thread (the live view's HTTP handlers, ``viewer_web.LiveView``)
    reads ``data`` after the frame's work without a device-wide wait."""

    data: torch.Tensor               # (nx, ny, nz) f32 or c64, on device
    id: int
    view_plane: ViewPlaneTag = ViewPlaneTag.XZ

    @property
    def output_points(self):
        return tuple(self.data.shape)

    @property
    def complex(self) -> bool:
        return self.data.is_complex()

    def to_numpy(self) -> np.ndarray:
        return to_host(self.data)

    def to_reference_layout(self) -> np.ndarray:
        """Flatten x-fastest as the reference exports frames
        (das.glsl:130-134): linear index = x + nx*y + nx*ny*z."""
        return self.to_numpy().transpose(2, 1, 0).ravel()


@dataclass
class ParameterBlock:
    """One of up to 16 parameter blocks (beamformer_shared_memory.c:95-131)."""

    parameters: Parameters = field(default_factory=Parameters)
    pipeline: PipelineSpec = field(default_factory=PipelineSpec)
    channel_mapping: np.ndarray = field(
        default_factory=lambda: np.arange(MAX_CHANNEL_COUNT, dtype=np.int16))
    sparse_elements: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.int16))
    focal_vectors: np.ndarray = field(
        default_factory=lambda: np.zeros((MAX_EMISSIONS_COUNT, 2), np.float32))
    transmit_receive_orientations: np.ndarray = field(
        default_factory=lambda: np.zeros(MAX_EMISSIONS_COUNT, np.uint8))
    filters: dict[int, Filter] = field(default_factory=dict)
    dirty: bool = True
    _plan: CompiledPlan | None = None
    _batched_plans: dict = field(default_factory=dict)   # frame_batch -> plan
    # ((mapping bytes, raw channels), the mapping's raw rows as an int64
    # tensor on the device) for the device-side ingest
    _rows: tuple | None = None

    def mark_dirty(self):
        self.dirty = True


class _StageClock:
    """Per-stage times of one frame: CUDA events on the GPU, the host
    clock on the CPU (where every torch op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.mark()

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(self.device))
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def done(self) -> bool:
        """Whether the last stage has completed (without waiting)."""
        return not self.cuda or self.marks[-1].query()

    def seconds(self) -> list[float]:
        """Seconds per stage; waits for the last stage on the GPU."""
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is the current
    CUDA device)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index or 0
    return a.type == b.type and index(a) == index(b)


class Beamformer:
    """A beamforming session on one device: the user-facing API.

    Method names follow the client library's exported surface
    (lib/ogl_beamformer_lib_base.h:37-173) minus the ``beamformer_`` prefix;
    each ``*_at`` variant of the reference maps to the ``block=`` keyword.
    It runs on the GPU (``device="cuda"``, the default) with the CUDA kernels
    and raises ``RuntimeError`` when no GPU is available; it never falls
    back to the CPU.  ``device="cpu"`` runs the plain twins.  ``mesh``: a
    ``parallel.sharding.Mesh`` over which every plan runs channel-sharded
    (its channel count must divide the mesh's channel axis); ``device``
    must be the mesh's first position of this process, where frames land.
    """

    def __init__(self, device="cuda", backlog_bytes: int = 1 << 30,
                 mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and not _same_device(mesh.home(), self.device):
            raise ValueError(f"device {self.device} is not the mesh's first "
                             f"position of this process ({mesh.home()})")
        self._blocks: list[ParameterBlock] = [ParameterBlock()]
        self._reserved = 1
        self._backlog: list[Frame] = []
        self._backlog_bytes = backlog_bytes
        self._frame_id = 0
        self.stats = ComputeStats()
        self.live_parameters = LiveImagingParameters()
        self._live_dirty = 0
        self._stop_latch = False
        # Guards frame-id allocation, the backlog and the stats table:
        # a streaming session records frames from its worker thread.
        self._frame_lock = threading.RLock()

    # ------------------------------------------------------------------
    # Parameter configuration
    # ------------------------------------------------------------------

    def reserve_parameter_blocks(self, count: int):
        """lib/ogl_beamformer_lib.c:239-251."""
        if count > MAX_PARAMETER_BLOCKS:
            raise BeamformerError(ErrorKind.ParameterBlockOverflow, str(count))
        while len(self._blocks) < count:
            self._blocks.append(ParameterBlock())
        self._reserved = max(count, 1)

    def _block(self, block: int) -> ParameterBlock:
        validate_block(block)
        if block >= self._reserved:
            raise BeamformerError(ErrorKind.ParameterBlockUnallocated,
                                  str(block))
        return self._blocks[block]

    def push_parameters(self, parameters: Parameters, block: int = 0):
        validate_parameters(parameters)
        b = self._block(block)
        b.parameters = parameters.copy()
        b.mark_dirty()

    def push_pipeline(self, shaders, data_kind, stage_parameters=None,
                      block: int = 0):
        validate_pipeline(shaders, data_kind)
        b = self._block(block)
        b.pipeline = PipelineSpec.from_shaders(shaders, data_kind,
                                               stage_parameters)
        b.mark_dirty()

    def set_pipeline_stage_parameters(self, stage_index: int, parameter: int,
                                      block: int = 0):
        b = self._block(block)
        if stage_index >= len(b.pipeline.stages):
            raise BeamformerError(ErrorKind.ComputeStageOverflow,
                                  str(stage_index))
        stages = list(b.pipeline.stages)
        stages[stage_index] = type(stages[stage_index])(
            kind=stages[stage_index].kind, parameter=parameter)
        b.pipeline = PipelineSpec(stages=tuple(stages),
                                  data_kind=b.pipeline.data_kind)
        b.mark_dirty()

    def push_channel_mapping(self, mapping, block: int = 0):
        b = self._block(block)
        m = np.asarray(mapping, np.int16)
        b.channel_mapping[:len(m)] = m

    def push_sparse_elements(self, elements, block: int = 0):
        b = self._block(block)
        e = np.asarray(elements, np.int16)
        b.sparse_elements[:len(e)] = e
        b.mark_dirty()

    def push_focal_vectors(self, vectors, block: int = 0):
        """``vectors``: (N, 2) interleaved (angle_degrees, focal_depth)."""
        b = self._block(block)
        v = np.asarray(vectors, np.float32).reshape(-1, 2)
        b.focal_vectors[:len(v)] = v
        b.mark_dirty()

    def push_transmit_receive_orientations(self, values, block: int = 0):
        b = self._block(block)
        v = np.asarray(values, np.uint8)
        b.transmit_receive_orientations[:len(v)] = v
        b.mark_dirty()

    def create_filter(self, filter_parameters: FilterParameters,
                      filter_slot: int, block: int = 0):
        """lib/ogl_beamformer_lib.c beamformer_create_filter."""
        if not (0 <= filter_slot < FILTER_SLOTS):
            raise BeamformerError(ErrorKind.InvalidFilterKind,
                                  f"slot {filter_slot}")
        b = self._block(block)
        b.filters[filter_slot] = make_filter(filter_parameters)
        b.mark_dirty()

    # ------------------------------------------------------------------
    # Compute
    # ------------------------------------------------------------------

    def _ensure_plan(self, b: ParameterBlock) -> CompiledPlan:
        """Rebuild the plan if the block is dirty (the analogue of
        beamformer_commit_parameter_block, beamformer_core.c:1008-1120)."""
        if b.dirty or b._plan is None:
            if not b.pipeline.stages:
                raise BeamformerError(ErrorKind.InvalidStartShader,
                                      "no pipeline pushed")
            b._batched_plans.clear()
            b._plan = self._build_plan(b)
            if self.mesh is not None:
                from ..parallel.sharding import shard_plan
                b._plan = shard_plan(b._plan, self.mesh)
            self.stats.set_stages([sd.kind for sd in b._plan.descriptor.stages])
            b.dirty = False
        return b._plan

    def _build_plan(self, b: ParameterBlock,
                    frame_batch: int = 1) -> CompiledPlan:
        a = max(b.parameters.acquisition_count, 1)
        return build_plan(
            b.parameters, b.pipeline, b.filters,
            sparse_elements=b.sparse_elements[:a],
            focal_vectors=b.focal_vectors[:a],
            transmit_receive_orientations=b.transmit_receive_orientations[:a],
            device=self.device, frame_batch=frame_batch)

    def push_data_with_compute(self, data: np.ndarray,
                               image_plane_tag: int = 0,
                               block: int = 0) -> Frame:
        """Upload one raw frame and run the block's pipeline on it.

        ``data``: raw scanner layout (raw_channels, raw_samples) — channel
        mapping and contrast reduction are applied host-side exactly as the
        reference client does (lib/ogl_beamformer_lib.c:491-570).
        """
        if not (0 <= image_plane_tag < len(ViewPlaneTag)):
            raise BeamformerError(ErrorKind.InvalidImagePlane,
                                  str(image_plane_tag))
        b = self._block(block)
        rf = self._prepare(b, data)
        self.stats.record_rf_upload()
        return self._compute(rf, image_plane_tag, block)

    def _raw_columns(self, b: ParameterBlock, shape: tuple) -> int:
        """Host-side check of a raw frame's shape for the device ingest
        (the errors of :meth:`_prepare`); the raw columns it reads."""
        p = b.parameters
        return raw_columns(shape, b.channel_mapping, p.channel_count,
                           p.acquisition_count, p.sample_count,
                           ContrastMode(p.contrast_mode),
                           b.pipeline.data_kind)

    def _ingest(self, b: ParameterBlock, raw: torch.Tensor) -> torch.Tensor:
        """:meth:`_prepare` of a raw frame on the device (checked by
        :meth:`_raw_columns`), with the block's channel mapping kept there."""
        p = b.parameters
        key = (b.channel_mapping[:p.channel_count].tobytes(), raw.shape[0])
        if b._rows is None or b._rows[0] != key:
            rows = mapping_rows(b.channel_mapping, p.channel_count,
                                raw.shape[0])
            b._rows = (key, torch.from_numpy(rows).to(raw.device))
        return prepare_rf_device(raw, b._rows[1], p.channel_count,
                                 p.acquisition_count, p.sample_count,
                                 ContrastMode(p.contrast_mode),
                                 b.pipeline.data_kind)

    @staticmethod
    def _prepare(b: ParameterBlock, data) -> np.ndarray:
        p = b.parameters
        return prepare_rf(np.asarray(data), b.channel_mapping,
                          p.channel_count, p.acquisition_count,
                          p.sample_count, ContrastMode(p.contrast_mode),
                          b.pipeline.data_kind)

    def push_batch(self, data: np.ndarray, image_plane_tag: int = 0,
                   block: int = 0) -> list[Frame]:
        """Upload B raw frames and beamform them together.

        ``data``: (B, raw_channels, raw_samples), each frame in the layout
        of :meth:`push_data_with_compute`.  The block's batched plan for B
        (built once, dropped when a parameter push rebuilds the plan) runs
        the pre-DAS stages on all B frames at once and the DAS kernel on
        four frames per launch, sharing each pair's geometry across them;
        for offline datasets and frame averaging (:meth:`averaged_frame`).
        Returns one :class:`Frame` per input frame, all in the backlog; the
        stats table gets B rows, each the batch's stage times over B.  Not
        with a device mesh (shard the channel axis or batch, not both)."""
        if not (0 <= image_plane_tag < len(ViewPlaneTag)):
            raise BeamformerError(ErrorKind.InvalidImagePlane,
                                  str(image_plane_tag))
        if self.mesh is not None:
            raise BeamformerError(ErrorKind.InvalidComputeStage,
                                  "push_batch with a device mesh")
        data = np.asarray(data)
        if data.ndim != 3 or data.shape[0] < 1:
            raise BeamformerError(ErrorKind.DataSizeMismatch,
                                  f"expected (B, raw_channels, raw_samples),"
                                  f" got {data.shape}")
        batch = data.shape[0]
        b = self._block(block)
        single = self._ensure_plan(b)            # commit dirty state first
        plan = single if batch == 1 else b._batched_plans.get(batch)
        if plan is None:
            plan = b._batched_plans[batch] = self._build_plan(b, batch)
        # each prepared frame goes straight into its slice of the batch on
        # the device: no second host copy of the whole batch
        x = None
        for i, frame in enumerate(data):
            rf = torch.from_numpy(self._prepare(b, frame))
            if x is None:
                x = torch.empty((batch,) + tuple(rf.shape), dtype=rf.dtype,
                                device=self.device)
            x[i].copy_(rf)
            self.stats.record_rf_upload()
        clock = _StageClock(self.device)
        # one frame runs through the ordinary plan: squeeze(0) drops the
        # batch axis only when B = 1, and the reshape puts it back
        out = plan(x.squeeze(0), mark=clock.mark)
        out = out.reshape((batch,) + tuple(out.shape[-3:]))
        stage_times = [t / batch for t in clock.seconds()]
        with self._frame_lock:
            for _ in range(batch):
                self.stats.record_frame(stage_times)
        view = ViewPlaneTag(image_plane_tag)
        return [self._register_frame(o, view) for o in out]

    def compute_prepared(self, rf: np.ndarray, image_plane_tag: int = 0,
                         block: int = 0) -> Frame:
        """Run the pipeline on already-canonical (C, A, S_wire) data."""
        return self._compute(np.asarray(rf), image_plane_tag, block)

    def warmup(self, block: int = 0) -> Frame:
        """Run one zero frame through the block's current configuration
        (builds the CUDA kernels on first use, outside real frames)."""
        b = self._block(block)
        p = b.parameters
        wire = b.pipeline.data_kind
        dt = {"Int16": np.int16, "Float32": np.float32,
              "Float16": np.float16}.get(wire.name.replace("Complex", ""),
                                         np.float32)
        n = p.acquisition_count * p.sample_count * wire.element_count
        raw = np.zeros((p.channel_count, n), dt)
        return self.push_data_with_compute(raw, block=block)

    def _compute(self, rf: np.ndarray, image_plane_tag, block) -> Frame:
        plan = self._ensure_plan(self._block(block))
        x = torch.from_numpy(np.ascontiguousarray(rf)).to(self.device)
        frame, clock = self._enqueue(plan, x, image_plane_tag)
        self._finish(clock)
        return frame

    def _enqueue(self, plan: CompiledPlan, x: torch.Tensor,
                 image_plane_tag) -> tuple[Frame, _StageClock]:
        """Run ``plan`` on canonical RF ``x`` on the device (a sharded plan
        takes the whole frame and splits it over its positions) and register
        the frame; on the GPU it returns once the stages are enqueued.  The
        clock's times go into the stats table through :meth:`_finish`."""
        clock = _StageClock(self.device)
        out = plan(x, mark=clock.mark)
        return self._register_frame(out, ViewPlaneTag(image_plane_tag)), clock

    def _finish(self, clock: _StageClock):
        """Record an enqueued frame's stage times as a stats row (waits for
        its last stage on the GPU)."""
        stage_times = clock.seconds()
        with self._frame_lock:
            self.stats.record_frame(stage_times)

    def profile_device_stages(self, rf: np.ndarray, block: int = 0,
                              record: bool = False):
        """Per-stage DEVICE times of the block's plan from a
        ``torch.profiler`` trace (``utils/profiling.py``), the counterpart of
        the reference bracketing every dispatch with GPU timestamps
        (vulkan.c:2616-2637).

        ``rf``: canonical (C, A, S_wire) data, uploaded once.  After an
        untraced warm-up, one frame runs under the profiler with an
        annotation at the end of each stage; a kernel belongs to the stage
        during which it was launched (its launch call shares the kernel's
        correlation id in the trace).  A trace that lacks the event of a
        kernel the frame launched (its profile's ``lost``, roadmap C2) is
        taken again, up to ``utils.profiling.TRACE_ATTEMPTS`` traces; the
        last one counts, and each that lost one warned
        (``LostKernelEvents``).  Returns a list of
        ``(ShaderKind, device_seconds)``; ``record=True`` also puts the
        times into the stats table as one frame.  On the CPU every time is
        0.0 (no kernel events)."""
        from ..utils.profiling import TRACE_ATTEMPTS, device_time
        b = self._block(block)
        plan = self._ensure_plan(b)
        x = torch.from_numpy(np.ascontiguousarray(rf)).to(self.device)
        marks = [f"stage_end:{i}" for i in range(len(plan.descriptor.stages))]

        def frame(x):
            ends = iter(marks)

            def mark():
                with torch.profiler.record_function(next(ends)):
                    pass

            return plan(x, mark=mark)

        for attempt in range(TRACE_ATTEMPTS):
            prof = device_time(frame, x, warmup=int(attempt == 0))
            if not prof.lost:
                break
        seconds = prof.split(marks) if prof.kernels else [0.0] * len(marks)
        times = [(sd.kind, t) for sd, t in zip(plan.descriptor.stages,
                                                seconds)]
        if record:
            with self._frame_lock:
                self.stats.record_frame(seconds)
        return times

    def _register_frame(self, out, view_plane) -> Frame:
        with self._frame_lock:
            frame = Frame(data=out, id=self._frame_id, view_plane=view_plane)
            self._frame_id += 1
            self._push_backlog(frame)
        return frame

    # ------------------------------------------------------------------
    # Export
    # ------------------------------------------------------------------

    def _push_backlog(self, frame: Frame):
        self._backlog.append(frame)
        total = 0
        keep: list[Frame] = []
        for f in reversed(self._backlog):
            total += f.data.numel() * f.data.element_size()
            if total > self._backlog_bytes and keep:
                break
            keep.append(f)
        self._backlog = list(reversed(keep))

    def get_last_frames(self, count: int = 1) -> list[Frame]:
        """N most recent frames, oldest -> newest
        (lib/ogl_beamformer_lib_base.h:89-103)."""
        return self._backlog[-count:]

    def averaged_frame(self, count: int | None = None,
                       block: int = 0) -> Frame:
        """Average of the ``count`` newest frames (the reference's
        ``output_points.w`` frame averaging, sum.glsl), by default the
        block's ``output_points[3]`` (at least 1)."""
        if count is None:
            count = max(int(self._block(block).parameters.output_points[3]), 1)
        frames = self.get_last_frames(count)
        if not frames:
            raise BeamformerError(ErrorKind.ExportSpaceOverflow,
                                  "no frames in backlog")
        stack = torch.stack([f.data for f in frames])
        return Frame(data=sum_frames(stack), id=frames[-1].id,
                     view_plane=frames[-1].view_plane)

    def compute_timings(self):
        """Exported stats table (lib/ogl_beamformer_lib.c:738-754); per-stage
        seconds of the last 32 frames."""
        return self.stats.table

    # ------------------------------------------------------------------
    # Simple API
    # ------------------------------------------------------------------

    def beamform_data(self, simple: SimpleParameters,
                      data: np.ndarray) -> Frame:
        """One-shot: push parameters + pipeline + tables, run, return frame
        (lib/ogl_beamformer_lib.c:704-736 beamformer_beamform_data)."""
        shaders = [s for s in simple.compute_stages]
        validate_pipeline(shaders, simple.data_kind)
        self.push_parameters(simple.parameters)
        self.push_pipeline(shaders, simple.data_kind,
                           simple.compute_stage_parameters[:len(shaders)])
        self.push_channel_mapping(simple.channel_mapping)
        self.push_sparse_elements(simple.sparse_elements)
        self.push_focal_vectors(simple.focal_vectors)
        self.push_transmit_receive_orientations(
            simple.transmit_receive_orientations)
        return self.push_data_with_compute(data)

    # ------------------------------------------------------------------
    # Live imaging controls
    # ------------------------------------------------------------------

    def set_live_parameters(self, params: LiveImagingParameters,
                            dirty_flags: int = 0):
        self.live_parameters = params
        self._live_dirty |= dirty_flags
        # Latch StopImaging so the control is not lost when a polling
        # client consumes the dirty flag before a session checks it.
        if dirty_flags & LiveImagingDirtyFlags.StopImaging \
                and not params.active:
            self._stop_latch = True
        elif params.active:
            self._stop_latch = False

    def get_live_parameters(self) -> LiveImagingParameters:
        return self.live_parameters

    def live_parameters_get_dirty_flag(self) -> int:
        """Returns and clears the accumulated dirty flags
        (lib/ogl_beamformer_lib.c:756-788)."""
        flags = self._live_dirty
        self._live_dirty = 0
        return flags
