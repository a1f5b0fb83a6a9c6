"""Shared-memory server: the torch counterpart of
``ogl_beamforming_tpu.runtime.server``, bridging the native client ABI into
the port's executor.

The counterpart of the reference's compute worker (beamformer.c:292-305,
beamformer_core.c:1420-1726): creates the shared memory region, sleeps on
the work futex, and for each work item commits dirty parameter regions into
the :class:`..pipeline.executor.Beamformer`, runs the block's plan on RF
read from the scratch arena, and serves frame/stats exports back through
the scratch.  The server's :class:`Beamformer` runs on the card
(``device="cuda"``, the default) and raises without one; ``device="cpu"``
runs the plain twins.

A client built against ``generated/ogl_beamformer_lib.h`` links the port's
library (``runtime/abi.build_native``) and finds the region by the name in
``OGL_BEAMFORMER_SHM_NAME``.  The region lives in ``/dev/shm``: the server
refuses a size that does not fit its free space, since a region beyond it
dies with SIGBUS on first touch instead of an error.
"""

from __future__ import annotations

import ctypes as ct
import logging
import os
import threading

import numpy as np

from ..params.enums import (AcquisitionKind, BeamformerError, ContrastMode,
                            DataKind, DecodeMode, ErrorKind, FilterKind,
                            InterpolationMode, LiveImagingDirtyFlags,
                            SamplingMode)
from ..params.types import (ChirpParameters, EmissionParameters,
                            FilterParameters, KaiserFilterParameters,
                            MatchedChirpFilterParameters, Parameters)
from ..pipeline.executor import Beamformer
from . import abi

log = logging.getLogger("ogl_beamforming_tpu_torch.server")

SHM_DIR = "/dev/shm"


def _m4_from_c(cm4) -> np.ndarray:
    """Column-major flat (reference m4) -> row-major (4,4)."""
    return np.array(cm4.E, np.float32).reshape(4, 4).T


def _parameters_from_c(cp: abi.CParameters) -> Parameters:
    p = Parameters()
    p.das_voxel_transform = _m4_from_c(cp.das_voxel_transform)
    p.xdc_transform = _m4_from_c(cp.xdc_transform)
    p.xdc_element_pitch = np.array(cp.xdc_element_pitch.E, np.float32)
    p.raw_data_dimensions = np.array(cp.raw_data_dimensions.E, np.uint32)
    p.focal_vector = np.array(cp.focal_vector.E, np.float32)
    p.transmit_receive_orientation = int(cp.transmit_receive_orientation)
    p.sample_count = int(cp.sample_count)
    p.channel_count = int(cp.channel_count)
    p.acquisition_count = int(cp.acquisition_count)
    p.acquisition_kind = AcquisitionKind(cp.acquisition_kind)
    p.decode_mode = DecodeMode(cp.decode_mode)
    p.sampling_mode = SamplingMode(cp.sampling_mode)
    p.time_offset = float(cp.time_offset)
    p.single_focus = bool(cp.single_focus)
    p.single_orientation = bool(cp.single_orientation)
    p.output_points = np.array(cp.output_points.E, np.int32)
    p.sampling_frequency = float(cp.sampling_frequency)
    p.demodulation_frequency = float(cp.demodulation_frequency)
    p.speed_of_sound = float(cp.speed_of_sound)
    p.f_number = float(cp.f_number)
    p.interpolation_mode = InterpolationMode(cp.interpolation_mode)
    p.coherency_weighting = bool(cp.coherency_weighting)
    p.decimation_rate = int(cp.decimation_rate)
    p.contrast_mode = ContrastMode(cp.contrast_mode)
    em = EmissionParameters()
    em.kind = cp.emission_parameters.kind
    em.sine.cycles = cp.emission_parameters.sine.cycles
    em.sine.frequency = cp.emission_parameters.sine.frequency
    em.chirp = ChirpParameters(cp.emission_parameters.chirp.duration,
                               cp.emission_parameters.chirp.min_frequency,
                               cp.emission_parameters.chirp.max_frequency)
    p.emission_parameters = em
    p.readi_group_count = int(cp.readi_group_count)
    p.readi_group = int(cp.readi_group)
    return p


def parameters_to_c(p: Parameters) -> abi.CParameters:
    """A client's :class:`abi.CParameters` of ``p`` (the inverse of the
    server's conversion; the transforms go column-major, as the reference's
    m4)."""
    cp = abi.CParameters()
    cp.das_voxel_transform.E[:] = list(
        np.asarray(p.das_voxel_transform, np.float32).T.ravel())
    cp.xdc_transform.E[:] = list(
        np.asarray(p.xdc_transform, np.float32).T.ravel())
    cp.xdc_element_pitch.E[:] = [float(v) for v in p.xdc_element_pitch]
    cp.raw_data_dimensions.E[:] = [int(v) for v in p.raw_data_dimensions]
    cp.focal_vector.E[:] = [float(v) for v in p.focal_vector]
    for name in ("transmit_receive_orientation", "sample_count",
                 "channel_count", "acquisition_count", "acquisition_kind",
                 "decode_mode", "sampling_mode", "single_focus",
                 "single_orientation", "interpolation_mode",
                 "coherency_weighting", "decimation_rate", "contrast_mode",
                 "readi_group_count", "readi_group"):
        setattr(cp, name, int(getattr(p, name)))
    for name in ("time_offset", "sampling_frequency",
                 "demodulation_frequency", "speed_of_sound", "f_number"):
        setattr(cp, name, float(getattr(p, name)))
    cp.output_points.E[:] = [int(v) for v in p.output_points]
    em = p.emission_parameters
    cp.emission_parameters.kind = int(em.kind)
    if int(em.kind) == 0:
        cp.emission_parameters.sine.cycles = float(em.sine.cycles)
        cp.emission_parameters.sine.frequency = float(em.sine.frequency)
    else:
        cp.emission_parameters.chirp.duration = float(em.chirp.duration)
        cp.emission_parameters.chirp.min_frequency = float(
            em.chirp.min_frequency)
        cp.emission_parameters.chirp.max_frequency = float(
            em.chirp.max_frequency)
    return cp


def simple_parameters_to_c(p: Parameters, shaders,
                           data_kind: DataKind) -> abi.CSimpleParameters:
    """A client's :class:`abi.CSimpleParameters`: ``p``, the identity
    channel mapping and the pipeline ``shaders`` on ``data_kind``."""
    sp = abi.CSimpleParameters()
    sp.parameters = parameters_to_c(p)
    for i in range(len(sp.channel_mapping)):
        sp.channel_mapping[i] = i
    for i, kind in enumerate(shaders):
        sp.compute_stages[i] = int(kind)
    sp.compute_stages_count = len(shaders)
    sp.data_kind = int(data_kind)
    return sp


def _filter_from_c(cf: abi.FilterParameters) -> FilterParameters:
    fp = FilterParameters(kind=FilterKind(cf.kind),
                          sampling_frequency=float(cf.sampling_frequency),
                          complex=bool(cf.complex))
    fp.kaiser = KaiserFilterParameters(float(cf.kaiser.cutoff_frequency),
                                       float(cf.kaiser.beta),
                                       int(cf.kaiser.length))
    fp.matched_chirp = MatchedChirpFilterParameters(
        float(cf.matched_chirp.duration),
        float(cf.matched_chirp.min_frequency),
        float(cf.matched_chirp.max_frequency))
    return fp


_WIRE_DTYPE = {
    DataKind.Int16: np.int16,
    DataKind.Int16Complex: np.int16,
    DataKind.Float32: np.float32,
    DataKind.Float32Complex: np.float32,
    DataKind.Float16: np.float16,
    DataKind.Float16Complex: np.float16,
}


def shm_free_bytes() -> int | None:
    """Free bytes of ``/dev/shm`` (None where there is no such mount)."""
    try:
        st = os.statvfs(SHM_DIR)
    except OSError:
        return None
    return st.f_bavail * st.f_frsize


class BeamformerServer:
    """Owns the shm region and a worker thread servicing client requests.
    ``pipelined`` (the default) takes each block's frames through a
    ``StreamingSession``; ``pipelined=False`` computes each frame in the
    worker with ``Beamformer.push_data_with_compute`` before it takes the
    next request, as the JAX package's server does."""

    def __init__(self, beamformer: Beamformer | None = None,
                 shm_size: int = 1 << 30, pipelined: bool = True,
                 device="cuda"):
        # the executor first: without a card it raises before a region
        # exists
        self.beamformer = beamformer or Beamformer(device=device)
        free = shm_free_bytes()
        if free is not None and shm_size > free:
            raise BeamformerError(
                ErrorKind.SharedMemory,
                f"a region of {shm_size} bytes does not fit the {free} "
                f"bytes free in {SHM_DIR}")
        self.lib = abi.load_library()
        if not self.lib.bf_server_create(shm_size):
            raise BeamformerError(ErrorKind.SharedMemory,
                                  "bf_server_create failed")
        size = ct.c_uint64()
        self._scratch_ptr = self.lib.bf_server_scratch(ct.byref(size))
        self._scratch_size = size.value
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._pipelined = pipelined
        # With pipelined, ComputeIndirect work is routed through a per-block
        # StreamingSession so the host copy, the upload and compute overlap
        # (the reference's upload+compute worker threads + 3-slot RF ring,
        # beamformer.c:292-305, beamformer_core.c:1728-1777).
        self._sessions: dict[int, object] = {}
        live_dirty = ct.POINTER(ct.c_uint32)()
        self._live = self.lib.bf_server_live(ct.byref(live_dirty))
        self._live_dirty_ptr = live_dirty
        self._imaging_stopped = False

    # -- lifecycle ------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="beamformer-server")
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0):
        """Stop the worker (joined for at most ``timeout`` seconds), close
        the sessions and unlink the region."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=timeout)
        for s in self._sessions.values():
            s.close(timeout=timeout)
        self._sessions.clear()
        self.lib.bf_server_destroy()

    # -- streaming sessions ----------------------------------------------

    def _live_stop_requested(self) -> bool:
        """Stop when the live control asked to (throughput.c:558-560).

        ``set_live`` latches StopImaging directly (dirty flags originate
        server-side); the shm peek is a fallback that does not consume the
        flag — the flag queue belongs to polling clients, and their consume
        can race this check (hence the latch)."""
        pending = self._live_dirty_ptr.contents.value
        if (not self._live.contents.active
                and pending & LiveImagingDirtyFlags.StopImaging):
            self._imaging_stopped = True
        elif self._live.contents.active:
            self._imaging_stopped = False    # restart
        return self._imaging_stopped

    def _session(self, block: int):
        s = self._sessions.get(block)
        if s is None:
            from .streaming import StreamingSession
            s = StreamingSession(self.beamformer, block=block,
                                 stop_check=self._live_stop_requested)
            self._sessions[block] = s
        return s

    def _drain_sessions(self):
        for s in self._sessions.values():
            s.drain()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- scratch access -------------------------------------------------

    def _scratch(self, nbytes: int, offset: int = 0) -> np.ndarray:
        return np.ctypeslib.as_array(
            ct.cast(ct.addressof(self._scratch_ptr.contents) + offset,
                    ct.POINTER(ct.c_uint8)),
            shape=(nbytes,))

    # -- work loop ------------------------------------------------------

    def _run(self):
        work = abi.CWork()
        while not self._stop.is_set():
            if not self.lib.bf_server_wait_work(ct.byref(work), 100):
                continue
            try:
                err = self._dispatch(work)
            except BeamformerError as e:
                log.warning("work failed: %s", e)
                err = int(e.kind)
            except Exception:
                log.exception("server work error")
                err = int(ErrorKind.InvalidAccess)
            if work.kind in (abi.WorkKind.EXPORT_FRAMES,
                             abi.WorkKind.EXPORT_STATS):
                if err:
                    self.lib.bf_server_set_export(0, err)
                self.lib.bf_server_complete_work()
            elif err:
                log.warning("compute error: %s",
                            ErrorKind(err).name if err >= 0 else err)

    def _commit_block(self, index: int):
        """Apply dirty shm regions to the executor block — the analogue of
        beamformer_commit_parameter_block (beamformer_core.c:1008-1120)."""
        dirty = self.lib.bf_server_take_dirty(index)
        if not dirty:
            return 0
        cb = self.lib.bf_server_block(index).contents
        bf = self.beamformer
        if index >= bf._reserved:
            bf.reserve_parameter_blocks(index + 1)
        if dirty & abi.Region.PARAMETERS:
            bf.push_parameters(_parameters_from_c(cb.parameters), block=index)
        if dirty & abi.Region.CHANNEL_MAPPING:
            bf.push_channel_mapping(np.array(cb.channel_mapping, np.int16),
                                    block=index)
        if dirty & abi.Region.SPARSE_ELEMENTS:
            bf.push_sparse_elements(np.array(cb.sparse_elements, np.int16),
                                    block=index)
        if dirty & abi.Region.FOCAL_VECTORS:
            bf.push_focal_vectors(np.array(cb.focal_vectors, np.float32),
                                  block=index)
        if dirty & abi.Region.ORIENTATIONS:
            bf.push_transmit_receive_orientations(
                np.array(cb.transmit_receive_orientations, np.uint8),
                block=index)
        if dirty & abi.Region.PIPELINE:
            n = int(cb.pipeline_count)
            bf.push_pipeline(list(cb.pipeline_shaders[:n]),
                             DataKind(cb.data_kind),
                             list(cb.pipeline_parameters[:n]), block=index)
        if dirty & abi.Region.FILTERS:
            for slot in range(4):
                if cb.filter_valid_mask & (1 << slot):
                    bf.create_filter(_filter_from_c(cb.filters[slot]), slot,
                                     block=index)
        return dirty

    def _take_rf(self, block: int, rf_bytes: int) -> np.ndarray:
        """Commit the block; its raw frame, a view of the scratch."""
        # Parameter commits rebuild plans: let the block's session enqueue
        # the frames it holds before the executor state changes.
        if (block in self._sessions
                and self.lib.bf_server_block(block).contents.dirty_regions):
            self._sessions[block].flush()
        self._commit_block(block)
        b = self.beamformer._blocks[block]
        p = b.parameters
        wire = _WIRE_DTYPE[b.pipeline.data_kind]
        raw = self._scratch(rf_bytes).view(wire)
        channels = int(p.raw_data_dimensions[1]) or p.channel_count
        return raw.reshape(channels, -1)

    def _dispatch(self, work: abi.CWork) -> int:
        kind = work.kind
        if kind == abi.WorkKind.COMPUTE_INDIRECT:
            info = self.lib.bf_server_rf_info()
            block = int((info >> 32) & 0xFFFFFFFF)
            rf_bytes = info & 0xFFFFFFFF
            if rf_bytes == 0:
                return int(ErrorKind.DataSizeMismatch)
            # Releasing the upload lets the client fill the scratch with its
            # next frame.  The session's copy into its pinned slot reads the
            # scratch and releases the upload when done, where the JAX
            # server copies the frame out first (that copy alone took
            # longer than a DAS kernel).
            release = self.lib.bf_server_release_upload
            try:
                raw = self._take_rf(block, rf_bytes)
                if not self._pipelined:
                    self.beamformer.push_data_with_compute(
                        raw, image_plane_tag=int(work.view_plane),
                        block=block)
                elif not self._live_stop_requested():
                    session = self._session(block)
                    session.stop_requested = False   # restart after stop
                    session.submit(raw, image_plane_tag=int(work.view_plane),
                                   on_read=release)
                    release = None
                # else: imaging stopped — drop the frame (reference client
                # loops stop pushing; we also guard server-side).
            finally:
                if release is not None:
                    release()
            self._publish_stats()
            return 0

        if kind == abi.WorkKind.EXPORT_FRAMES:
            # A client may push-then-export immediately: every queued frame
            # completes first, and its stats row is published with it.
            self._drain_sessions()
            frames = self.beamformer.get_last_frames(int(work.arg0))
            out_limit = min(int(work.arg1), self._scratch_size)
            offset = 0
            for f in frames:
                flat = f.to_reference_layout()
                # 64-byte aligned frame sizes (lib_base.h:95-96)
                nbytes = (flat.nbytes + 63) & ~63
                if offset + nbytes > out_limit:
                    break
                view = flat.view(np.uint8).reshape(-1)
                self._scratch(view.nbytes, offset)[:] = view
                offset += nbytes
            self._publish_stats()
            self.lib.bf_server_set_export(offset, 0)
            return 0

        if kind == abi.WorkKind.EXPORT_STATS:
            self._drain_sessions()
            self._publish_stats()
            self.lib.bf_server_set_export(
                ct.sizeof(abi.CStatsTable), 0)
            return 0

        if kind == abi.WorkKind.SHUTDOWN:
            self._stop.set()
            return 0
        return 0

    # -- live imaging bridge (reference: beamformer UI <-> scanner client
    # via LiveImagingParameters + dirty flags, generated/beamformer.c:443-454)

    def get_live(self) -> abi.CLiveImagingParameters:
        """Read the live-imaging parameter block shared with clients."""
        return self.lib.bf_server_live(None).contents

    def set_live(self, dirty_flags: int = 0, **fields):
        """Update live-imaging parameters and mark dirty flags for clients
        to poll (the UI-side of the reference's live-control loop)."""
        live = self.lib.bf_server_live(None).contents
        for name, value in fields.items():
            setattr(live, name, value)
        if dirty_flags:
            self.lib.bf_server_mark_live_dirty(dirty_flags)
        # Latch StopImaging here: polling clients consume the dirty flag,
        # so the later peek in _live_stop_requested could miss it.
        if dirty_flags & LiveImagingDirtyFlags.StopImaging \
                and not live.active:
            self._imaging_stopped = True
        elif fields.get("active"):
            self._imaging_stopped = False

    def _publish_stats(self):
        """Copy the executor's stats table into the region, where
        ``beamformer_compute_timings`` reads it."""
        cstats = self.lib.bf_server_stats().contents
        with self.beamformer._frame_lock:
            t = self.beamformer.stats.table
            np.ctypeslib.as_array(cstats.shader_ids)[:] = t.shader_ids
            np.ctypeslib.as_array(cstats.times)[:] = t.times
            np.ctypeslib.as_array(cstats.rf_time_deltas)[:] = \
                t.rf_time_deltas
