"""Beamformer executor: the torch counterpart of
``ogl_beamforming_tpu.pipeline.executor``.

Parameter blocks with dirty tracking, four filter slots per block, a frame
backlog with N-most-recent export, and the exported compute-timing stats
table, on one explicit device.  Each frame's stages run eagerly and are
bracketed by CUDA events (on the GPU) or host clock reads (on the CPU, where
torch runs synchronously), so the stats table holds true per-stage times.
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
                            ViewPlaneTag)
from ..params.types import (FilterParameters, LiveImagingParameters,
                            Parameters, SimpleParameters)
from ..runtime.upload import prepare_rf
from ..utils.device import resolve_device, to_host
from ..utils.filters import Filter, make_filter
from .plan import CompiledPlan, build_plan
from .spec import (PipelineSpec, validate_block, validate_parameters,
                   validate_pipeline)
from .stats import ComputeStats


@dataclass
class Frame:
    """A beamformed frame (reference: BeamformerFrame)."""

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

    def mark_dirty(self):
        self.dirty = True


class _StageClock:
    """Per-stage times of one frame: CUDA events on the GPU, the host
    clock on the CPU (where every torch op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.mark()

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append(event)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list[float]:
        """Seconds per stage; waits for the last stage on the GPU."""
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return [a.elapsed_time(b) * 1e-3 for a, b in zip(m, m[1:])]
        return [b - a for a, b in zip(m, m[1:])]


class Beamformer:
    """A beamforming session on one device: the user-facing API.

    Method names follow the client library's exported surface
    (lib/ogl_beamformer_lib_base.h:37-173) minus the ``beamformer_`` prefix;
    each ``*_at`` variant of the reference maps to the ``block=`` keyword.
    It runs on the GPU (``device="cuda"``, the default) with the CUDA kernels
    and raises ``RuntimeError`` when no GPU is available; it never falls
    back to the CPU.  ``device="cpu"`` runs the plain twins.
    """

    def __init__(self, device="cuda", backlog_bytes: int = 1 << 30):
        self.device = resolve_device(device)
        self._blocks: list[ParameterBlock] = [ParameterBlock()]
        self._reserved = 1
        self._backlog: list[Frame] = []
        self._backlog_bytes = backlog_bytes
        self._frame_id = 0
        self.stats = ComputeStats()
        self.live_parameters = LiveImagingParameters()
        self._live_dirty = 0
        # Guards frame-id allocation, the backlog and the stats table.
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
            a = max(b.parameters.acquisition_count, 1)
            b._plan = build_plan(
                b.parameters, b.pipeline, b.filters,
                sparse_elements=b.sparse_elements[:a],
                focal_vectors=b.focal_vectors[:a],
                transmit_receive_orientations=(
                    b.transmit_receive_orientations[:a]),
                device=self.device)
            self.stats.set_stages([sd.kind for sd in b._plan.descriptor.stages])
            b.dirty = False
        return b._plan

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
        p = b.parameters
        rf = prepare_rf(np.asarray(data), b.channel_mapping,
                        p.channel_count, p.acquisition_count, p.sample_count,
                        ContrastMode(p.contrast_mode), b.pipeline.data_kind)
        self.stats.record_rf_upload()
        return self._compute(rf, image_plane_tag, block)

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
        b = self._block(block)
        plan = self._ensure_plan(b)
        x = torch.from_numpy(np.ascontiguousarray(rf)).to(self.device)
        clock = _StageClock(self.device)
        out = plan(x, mark=clock.mark)
        stage_times = clock.seconds()
        with self._frame_lock:
            self.stats.record_frame(stage_times)
        return self._register_frame(out, ViewPlaneTag(image_plane_tag))

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

    def get_live_parameters(self) -> LiveImagingParameters:
        return self.live_parameters

    def live_parameters_get_dirty_flag(self) -> int:
        """Returns and clears the accumulated dirty flags
        (lib/ogl_beamformer_lib.c:756-788)."""
        flags = self._live_dirty
        self._live_dirty = 0
        return flags
