"""Streaming ingest: the torch counterpart of
``ogl_beamforming_tpu.runtime.streaming``, with its API and semantics.

A worker thread takes each submitted raw frame through a ring of ``depth``
slots (the reference's MaxRawDataFramesInFlight ring, beamformer.c:292-305)
so that the host copy and the upload of frame n + 1 overlap frame n's
kernels.  On the GPU, for slot ``k``:

1. after slot ``k``'s copy-done event, the columns the block reads are
   copied into pinned host slot ``k`` (a torch copy: it releases the GIL
   and runs on the intra-op threads);
2. on a side stream that first waits on device buffer ``k``'s consumed
   event, the slot is uploaded with ``non_blocking=True`` into persistent
   device buffer ``k``; copy-done is recorded there;
3. on the device's default stream, which waits on copy-done, the channel
   mapping and contrast reduction run on the device
   (``runtime/upload.prepare_rf_device``), consumed is recorded, and the
   plan is enqueued (``Beamformer._enqueue``).

A caller that hands the session memory it must reuse (the server's
scratch arena, ``runtime/server.py``) passes ``on_read`` to
:meth:`StreamingSession.submit`: the worker calls it once it no longer reads
the raw frame, right after the copy into the pinned slot (on the CPU after
the ingest; at once for a frame that is dropped or fails).

The frame's future resolves once it is enqueued, as the JAX worker's does
after dispatch; its stats row is recorded once its last stage event has
completed (``Beamformer._finish``), at the latest when ``depth`` frames are
on the device or at :meth:`StreamingSession.drain`.  Compute stays on the
default stream: streams from ``torch.cuda.Stream()`` do not synchronise with
it, and a consumer's ``frame.to_numpy()`` copies on the default stream,
after the frame's kernels.  Ring buffers are allocated once per raw shape,
so no memory written on the side stream returns to the allocator while a
copy may still write it.

On the CPU the worker runs the same ingest and plan synchronously, with no
pinned memory and no streams.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from ..params.constants import MAX_RAW_DATA_FRAMES_IN_FLIGHT
from ..params.enums import LiveImagingDirtyFlags
from ..pipeline.executor import Beamformer, Frame


@dataclass
class FrameHandle:
    """A frame whose compute may still be in flight."""

    future: Future

    def result(self, timeout: float | None = None) -> Frame:
        return self.future.result(timeout)

    def done(self) -> bool:
        return self.future.done()


class _Ring:
    """``depth`` pinned host slots and device buffers of one raw shape and
    dtype, with each slot's copy-done and consumed events."""

    def __init__(self, depth: int, shape: tuple, dtype, device):
        self.key = (shape, dtype)
        self.host = [torch.empty(shape, dtype=dtype, pin_memory=True)
                     for _ in range(depth)]
        self.dev = [torch.empty(shape, dtype=dtype, device=device)
                    for _ in range(depth)]
        self.copied = [torch.cuda.Event() for _ in range(depth)]
        self.consumed = [torch.cuda.Event() for _ in range(depth)]
        self.next = 0


_DRAIN = object()


class _Once:
    """Calls ``fn`` (if any) the first time it is called, and never
    again."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self):
        fn, self._fn = self._fn, None
        if fn is not None:
            fn()


class StreamingSession:
    """Continuous-ingest wrapper around a :class:`Beamformer`.

    Usage::

        with StreamingSession(bf, block=0) as stream:
            for raw in scanner:
                handle = stream.submit(raw)       # non-blocking
            last = handle.result()

    ``submit`` returns immediately once fewer than ``depth`` frames are
    queued (applying back-pressure beyond that, like the reference's ring
    slot spin-wait, beamformer_core.c:1560-1575).  Frames resolve in submit
    order; an exception raised for a frame reaches its handle.
    """

    def __init__(self, beamformer: Beamformer, block: int = 0,
                 depth: int = MAX_RAW_DATA_FRAMES_IN_FLIGHT,
                 image_plane_tag: int = 0, stop_check=None):
        if depth < 1:
            raise ValueError(f"depth must be at least 1, got {depth}")
        self.beamformer = beamformer
        self.block = block
        self.depth = depth
        self.image_plane_tag = image_plane_tag
        self._stop_check = (self._live_stop_requested if stop_check is None
                            else stop_check)
        self.stop_requested = False
        self._cuda = beamformer.device.type == "cuda"
        self._device = beamformer.device
        self._side = None
        if self._cuda:
            if self._device.index is None:
                self._device = torch.device("cuda",
                                            torch.cuda.current_device())
            self._side = torch.cuda.Stream(self._device)
        self._ring: _Ring | None = None
        self._pending: collections.deque = collections.deque()  # clocks
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._idle = threading.Condition()
        self._unfinished = 0        # items queued and not yet processed
        self._close_error: BaseException | None = None
        self._stopped = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="beamformer-stream")
        self._thread.start()

    def _live_stop_requested(self) -> bool:
        """Default stop predicate: live-imaging control asked to stop
        (reference client loop, tests/throughput.c:558-560).  Peeks at the
        pending dirty flags without consuming them (the flag queue belongs
        to polling clients) and reads the executor's StopImaging latch."""
        bf = self.beamformer
        if bf._stop_latch:
            return True
        live = bf.get_live_parameters()
        return bool(not live.active
                    and bf._live_dirty & LiveImagingDirtyFlags.StopImaging)

    # -- producer side --------------------------------------------------

    def _put(self, item):
        with self._idle:
            self._unfinished += 1
        self._queue.put(item)

    def submit(self, raw: np.ndarray, image_plane_tag: int | None = None,
               on_read=None) -> FrameHandle:
        """Queue one raw frame; blocks only when ``depth`` frames are
        already queued.  After a live StopImaging request the frame is
        dropped and the handle resolves to ``None``.  ``on_read``: called
        once, when the session no longer reads ``raw``."""
        if self._stopped:
            raise RuntimeError("session closed")
        read = _Once(on_read)
        fut: Future = Future()
        if self.stop_requested:
            read()
            fut.set_result(None)
            return FrameHandle(future=fut)
        tag = self.image_plane_tag if image_plane_tag is None \
            else image_plane_tag
        self._put((np.asarray(raw), tag, fut, read))
        return FrameHandle(future=fut)

    def flush(self, timeout: float | None = None):
        """Block until every queued frame has been uploaded and enqueued
        (not necessarily completed on the device: see :meth:`drain`);
        ``TimeoutError`` after ``timeout`` seconds."""
        with self._idle:
            if not self._idle.wait_for(lambda: self._unfinished == 0,
                                       timeout):
                raise TimeoutError(f"frames still queued after {timeout} s")

    def drain(self, timeout: float | None = None):
        """Wait until every submitted frame has completed on the device and
        its stats row is in ``Beamformer.compute_timings()``."""
        if self._stopped:
            return
        done: Future = Future()
        self._put((_DRAIN, done))
        done.result(timeout)

    # -- worker ---------------------------------------------------------

    def _finish(self, wait: bool):
        """Record the stats rows of the enqueued frames that have completed,
        in order; with ``wait``, first wait for the oldest."""
        bf = self.beamformer
        if wait and self._pending:
            bf._finish(self._pending.popleft())
        while self._pending and self._pending[0].done():
            bf._finish(self._pending.popleft())

    def _finish_all(self):
        while self._pending:
            self._finish(wait=True)

    def _ring_for(self, shape: tuple, dtype) -> _Ring:
        if self._ring is None or self._ring.key != (shape, dtype):
            if self._ring is not None:
                # nothing may still write the buffers that are let go
                self._side.synchronize()
            self._ring = _Ring(self.depth, shape, dtype, self._device)
        return self._ring

    def _upload(self, b, raw: np.ndarray, columns: int,
                read) -> torch.Tensor:
        """The canonical (C, A, S_wire) frame of ``raw`` on the device;
        ``read()`` once ``raw`` is read."""
        bf = self.beamformer
        src = torch.from_numpy(raw)[:, :columns]
        if not self._cuda:
            x = bf._ingest(b, src)
            read()
            return x
        ring = self._ring_for(tuple(src.shape), src.dtype)
        k = ring.next
        ring.next = (k + 1) % self.depth
        ring.copied[k].synchronize()     # slot k's last upload has left it
        ring.host[k].copy_(src)
        read()
        with torch.cuda.stream(self._side):
            self._side.wait_event(ring.consumed[k])
            ring.dev[k].copy_(ring.host[k], non_blocking=True)
            ring.copied[k].record(self._side)
        compute = torch.cuda.current_stream(self._device)
        compute.wait_event(ring.copied[k])
        x = bf._ingest(b, ring.dev[k])
        ring.consumed[k].record(compute)
        return x

    def _frame(self, raw: np.ndarray, tag: int, fut: Future, read):
        try:
            if not self.stop_requested and self._stop_check is not None \
                    and self._stop_check():
                self.stop_requested = True
            if self.stop_requested:
                fut.set_result(None)
                return
            self._finish(wait=len(self._pending) >= self.depth)
            bf = self.beamformer
            b = bf._block(self.block)
            plan = bf._ensure_plan(b)
            columns = bf._raw_columns(b, raw.shape)
            bf.stats.record_rf_upload()
            x = self._upload(b, raw, columns, read)
            frame, clock = bf._enqueue(plan, x, tag)
            self._pending.append(clock)
            fut.set_result(frame)
        finally:
            read()

    def _worker(self):
        if self._cuda:
            torch.cuda.set_device(self._device)
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    self._finish_all()
                    return
                if item[0] is _DRAIN:
                    try:
                        self._finish_all()
                    except Exception as e:
                        item[1].set_exception(e)
                    else:
                        item[1].set_result(None)
                    continue
                raw, tag, fut, read = item
                try:
                    self._frame(raw, tag, fut, read)
                except Exception as e:          # propagate to the caller
                    fut.set_exception(e)
            except Exception as e:              # raised again by close()
                self._close_error = e
                return
            finally:
                with self._idle:
                    self._unfinished -= 1
                    self._idle.notify_all()

    # -- lifecycle ------------------------------------------------------

    def close(self, timeout: float | None = 5.0):
        """Process the frames still queued, record their stats rows and stop
        the worker (joined for at most ``timeout`` seconds).  Idempotent;
        raises an error met while recording the last rows."""
        if not self._stopped:
            self._stopped = True
            self._put(None)
            self._thread.join(timeout=timeout)
            if self._close_error is not None:
                raise self._close_error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
