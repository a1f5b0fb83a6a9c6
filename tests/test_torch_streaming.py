"""The port's streaming runtime (``runtime/streaming.py``) and its device-side
ingest (``runtime/upload.prepare_rf_device``) on the CPU, against the JAX
package:

  * the four tests of ``tests/test_streaming.py`` on the port's
    ``Beamformer(device="cpu")``: frames in order and equal to the
    synchronous path, an error reaching the handle, ``close`` idempotent,
    StopImaging dropping frames and latching;
  * a streamed frame against the JAX ``Beamformer``'s
    ``push_data_with_compute`` of the same seeded raw frame (NRMSE 1e-4) and
    against golden (1e-3), the tolerances of ``test_torch_pipeline.py``;
  * the device ingest against the JAX package's ``prepare_rf`` and the
    port's host copy, bit for bit, and its errors;
  * the StopImaging latch against the JAX executor's;
  * the locked launch count under threads.

Every wait has a timeout; the file takes a few seconds.
"""

import dataclasses
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, BeamformerError, ContrastMode, DataKind,
    InterpolationMode, LiveImagingDirtyFlags, ShaderKind)
from ogl_beamforming_tpu.params.types import (  # noqa: E402
    LiveImagingParameters, Parameters)
from ogl_beamforming_tpu.pipeline import executor as jax_executor  # noqa: E402
from ogl_beamforming_tpu.runtime import streaming as jax_streaming  # noqa: E402
from ogl_beamforming_tpu.runtime.upload import prepare_rf  # noqa: E402
from ogl_beamforming_tpu.utils.hadamard import hadamard  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)
from ogl_beamforming_tpu_torch import convert  # noqa: E402
from ogl_beamforming_tpu_torch.kernels import build  # noqa: E402
from ogl_beamforming_tpu_torch.params import enums as port_enums  # noqa: E402
from ogl_beamforming_tpu_torch.params import types as port_types  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer  # noqa: E402
from ogl_beamforming_tpu_torch.runtime import upload  # noqa: E402
from ogl_beamforming_tpu_torch.runtime.streaming import (  # noqa: E402
    StreamingSession)

torch.set_num_threads(1)

TIMEOUT = 30          # seconds, for every result, flush, drain and join
PITCH = 0.3e-3


def _params(c=8, a=4, s=256, **kw) -> Parameters:
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _setup(p=None, mapping=None) -> Beamformer:
    """The port's counterpart of ``tests/test_streaming.py``'s setup."""
    p = _params() if p is None else p
    bf = Beamformer(device="cpu")
    bf.push_parameters(convert.parameters_from_fields(dataclasses.asdict(p)))
    bf.push_pipeline([port_enums.ShaderKind.Decode, port_enums.ShaderKind.DAS],
                     port_enums.DataKind.Int16)
    if mapping is not None:
        bf.push_channel_mapping(mapping)
    return bf


def _stop(bf, live_parameters):
    """A live StopImaging request, with ``bf``'s package's
    ``LiveImagingParameters``."""
    bf.set_live_parameters(
        live_parameters(active=0),
        dirty_flags=int(LiveImagingDirtyFlags.StopImaging))


def _closed(stream) -> bool:
    stream.close(timeout=TIMEOUT)
    return not stream._thread.is_alive()


# ---------------------------------------------------------------------------
# tests/test_streaming.py on the port
# ---------------------------------------------------------------------------

def test_streaming_frames_ordered(rng):
    bf = _setup()
    raws = [rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
            for _ in range(6)]
    stream = StreamingSession(bf)
    handles = [stream.submit(r) for r in raws]
    frames = [h.result(timeout=TIMEOUT) for h in handles]
    stream.drain(timeout=TIMEOUT)
    assert _closed(stream)
    ids = [f.id for f in frames]
    assert ids == sorted(ids)
    assert len(bf.get_last_frames(6)) == 6
    # every streamed frame has its stats row, with a time for each stage
    assert bf.stats._frame_index == 6
    assert (bf.compute_timings().times[:6, :2] > 0).all()
    # on the CPU no pinned ring and no side stream
    assert stream._ring is None and stream._side is None
    # the same data as the synchronous path, bit for bit
    for raw, frame in zip(raws, frames):
        direct = bf.push_data_with_compute(raw)
        np.testing.assert_array_equal(frame.to_numpy(), direct.to_numpy())


def test_streaming_error_propagates(rng):
    bf = _setup()
    with StreamingSession(bf) as stream:
        h = stream.submit(np.zeros((2, 4), np.int16))   # wrong shape
        with pytest.raises(port_enums.BeamformerError) as err:
            h.result(timeout=TIMEOUT)
        # the session goes on after the error
        good = stream.submit(rng.integers(-512, 512, (8, 1024)
                                          ).astype(np.int16))
        assert good.result(timeout=TIMEOUT) is not None
    assert err.value.kind == port_enums.ErrorKind.DataSizeMismatch


def test_streaming_close_idempotent():
    bf = _setup()
    s = StreamingSession(bf)
    s.close(timeout=TIMEOUT)
    s.close(timeout=TIMEOUT)
    assert not s._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        s.submit(np.zeros((8, 1024), np.int16))


def test_streaming_stop_imaging(rng):
    """Live StopImaging control halts the session's compute loop
    (reference: tests/throughput.c:558-560 + live dirty-flag plumbing)."""
    bf = _setup()
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    with StreamingSession(bf) as stream:
        h = stream.submit(raw)
        assert h.result(timeout=TIMEOUT) is not None
        _stop(bf, port_types.LiveImagingParameters)
        h2 = stream.submit(raw)
        assert h2.result(timeout=TIMEOUT) is None      # dropped
        assert stream.stop_requested
        h3 = stream.submit(raw)                        # latched: dropped
        assert h3.result(timeout=TIMEOUT) is None
    assert len(bf.get_last_frames(8)) == 1


# ---------------------------------------------------------------------------
# Streaming beyond the JAX tests: depth, parameter pushes, flush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3])
def test_streaming_depth_and_a_plan_rebuilt_midstream(rng, depth):
    """Frames before and after a parameter push that rebuilds the plan each
    equal the synchronous path under their own parameters."""
    bf = _setup()
    raws = [rng.integers(-512, 512, (8, 1024)).astype(np.int16)
            for _ in range(4)]
    with StreamingSession(bf, depth=depth) as stream:
        first = [stream.submit(r) for r in raws[:2]]
        stream.flush(timeout=TIMEOUT)
        p = _params(output_points=np.array([6, 10, 1, 0], np.int32))
        bf.push_parameters(convert.parameters_from_fields(
            dataclasses.asdict(p)))
        second = [stream.submit(r) for r in raws[2:]]
        frames = [h.result(timeout=TIMEOUT) for h in first + second]
        stream.drain(timeout=TIMEOUT)
    assert [f.output_points for f in frames] == [(12, 16, 1)] * 2 \
        + [(6, 10, 1)] * 2
    ref = _setup(p)
    for raw, frame in zip(raws[2:], frames[2:]):
        np.testing.assert_array_equal(
            frame.to_numpy(), ref.push_data_with_compute(raw).to_numpy())


@pytest.mark.parametrize("case", ["computed", "failed", "dropped",
                                  "latched"])
def test_on_read_runs_once_after_the_raw_frame_is_read(rng, case):
    """``submit(..., on_read=)`` (how the server hands over its scratch):
    called exactly once, after the frame's ingest has read the raw frame
    (the worker's ``_ingest``), also for a frame that fails, one dropped by
    StopImaging in the worker and one dropped at ``submit``; the frame
    computed from a buffer overwritten right after ``on_read`` is the
    buffer's frame before."""
    bf = _setup()
    raw = rng.integers(-512, 512, (8, 4 * 256)).astype(np.int16)
    if case == "failed":
        raw = raw[:2]                                   # wrong shape
    events = []
    ingest = bf._ingest

    def logged_ingest(b, x):
        events.append("ingest")
        return ingest(b, x)

    def on_read():
        events.append("read")
        raw[...] = 0                                    # the buffer reused

    bf._ingest = logged_ingest
    want = None if case != "computed" else \
        bf.push_data_with_compute(raw.copy()).to_numpy()
    with StreamingSession(bf) as stream:
        if case == "latched":
            stream.stop_requested = True
        elif case == "dropped":
            _stop(bf, port_types.LiveImagingParameters)
        h = stream.submit(raw, on_read=on_read)
        if case == "failed":
            with pytest.raises(port_enums.BeamformerError):
                h.result(timeout=TIMEOUT)
        else:
            frame = h.result(timeout=TIMEOUT)
            assert (frame is None) == (case != "computed")
        stream.drain(timeout=TIMEOUT)
    assert events == (["ingest", "read"] if case == "computed"
                      else ["read"])
    if case == "computed":
        np.testing.assert_array_equal(frame.to_numpy(), want)


def test_flush_times_out_while_a_frame_is_queued(rng):
    bf = _setup()
    gate = threading.Event()
    stream = StreamingSession(bf, stop_check=lambda: not gate.wait(TIMEOUT))
    try:
        h = stream.submit(rng.integers(-512, 512, (8, 1024)
                                       ).astype(np.int16))
        with pytest.raises(TimeoutError):
            stream.flush(timeout=0.05)
        gate.set()
        stream.flush(timeout=TIMEOUT)
        assert h.result(timeout=TIMEOUT) is not None
    finally:
        gate.set()
        assert _closed(stream)


# ---------------------------------------------------------------------------
# The streamed frame against the JAX Beamformer and golden
# ---------------------------------------------------------------------------

def test_streamed_frame_matches_jax_and_golden():
    """Cubic FORCES decode -> DAS with a channel mapping that takes 6 of 9
    raw rows in another order, raw columns beyond the block's: the streamed
    frame against JAX's ``push_data_with_compute`` of the same raw frame
    and the golden composition of JAX's ``prepare_rf`` of it."""
    c, a, s = 6, 4, 256
    p = _params(c=c, a=a, s=s, time_offset=1e-7,
                interpolation_mode=InterpolationMode.Cubic)
    rng = np.random.default_rng(0x57E4)
    mapping = np.array([4, 0, 7, 2, 8, 5], np.int16)
    raw = rng.integers(-1024, 1024, (9, a * s + 37)).astype(np.int16)

    bf = _setup(p, mapping)
    with StreamingSession(bf) as stream:
        out = stream.submit(raw).result(timeout=TIMEOUT).to_numpy()
        stream.drain(timeout=TIMEOUT)

    jbf = jax_executor.Beamformer(voxel_block=128)
    jbf.push_parameters(p)
    jbf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    jbf.push_channel_mapping(mapping)
    ref = jbf.push_data_with_compute(raw).to_numpy()

    rf = prepare_rf(raw, mapping, c, a, s).astype(np.float32)
    gold = golden.das(golden.decode_hadamard(rf, hadamard(a)),
                      golden.DasParams(
                          acquisition_kind=p.acquisition_kind,
                          acquisition_count=a, channel_count=c,
                          sample_count=s, sampling_frequency=20e6,
                          demodulation_frequency=5e6, speed_of_sound=1500.0,
                          time_offset=1e-7,
                          interpolation_mode=p.interpolation_mode,
                          f_number=0.8,
                          voxel_transform=np.asarray(p.das_voxel_transform),
                          xdc_element_pitch=np.asarray(p.xdc_element_pitch),
                          output_points=(12, 16, 1)))
    assert out.shape == ref.shape == (12, 16, 1)
    assert nrmse(ref, out) <= 1e-4
    assert nrmse(gold, out) <= 1e-3


# ---------------------------------------------------------------------------
# Device-side ingest against prepare_rf
# ---------------------------------------------------------------------------

C_INGEST, A_INGEST, S_INGEST = 6, 4, 10


def _mapping(kind: str, rng) -> tuple[np.ndarray, int]:
    """A channel mapping and the raw channel count it reads from."""
    if kind == "identity":
        return np.arange(C_INGEST, dtype=np.int16), C_INGEST
    if kind == "permuted":
        return rng.permutation(C_INGEST).astype(np.int16), C_INGEST
    return rng.choice(10, C_INGEST, replace=False).astype(np.int16), 10


def _raw_values(kind: DataKind, shape, rng) -> np.ndarray:
    """Full-range int16 (so A1S2 wraps), float16 whose differences round,
    float32."""
    if kind == DataKind.Int16:
        return rng.integers(-32768, 32768, shape).astype(np.int16)
    x = rng.standard_normal(shape) * 1000
    return x.astype(np.float16 if kind == DataKind.Float16 else np.float32)


@pytest.mark.parametrize("mapping_kind", ["identity", "permuted", "subset"])
@pytest.mark.parametrize("contrast", [ContrastMode.NoContrast,
                                      ContrastMode.A1S2])
@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Float16,
                                  DataKind.Float32, DataKind.Float32Complex])
def test_device_ingest_equals_prepare_rf(kind, contrast, mapping_kind):
    rng = np.random.default_rng(
        100 * int(kind) + 10 * int(contrast) + len(mapping_kind))
    mapping, rows = _mapping(mapping_kind, rng)
    s_wire = S_INGEST * kind.element_count
    raw = _raw_values(kind, (rows, A_INGEST * s_wire + 7), rng)
    args = (C_INGEST, A_INGEST, S_INGEST, contrast, kind)
    ref = prepare_rf(raw, mapping, *args)
    host = upload.prepare_rf(raw, mapping, *args)
    columns = upload.raw_columns(raw.shape, mapping, *args)
    assert columns == (3 if contrast == ContrastMode.A1S2
                       else A_INGEST) * s_wire
    rows_dev = torch.from_numpy(upload.mapping_rows(mapping, C_INGEST, rows))
    dev = upload.prepare_rf_device(torch.from_numpy(raw)[:, :columns],
                                   rows_dev, *args).numpy()
    assert ref.dtype == host.dtype == dev.dtype == raw.dtype
    assert ref.shape == dev.shape == (C_INGEST, A_INGEST, s_wire)
    assert ref.tobytes() == host.tobytes() == dev.tobytes()
    if contrast == ContrastMode.A1S2 and kind == DataKind.Int16:
        wide = (raw[mapping, :s_wire].astype(np.int32)
                - raw[mapping, s_wire:2 * s_wire]
                - raw[mapping, 2 * s_wire:3 * s_wire])
        assert (np.abs(wide) > 32767).any()       # the case wraps


@pytest.mark.parametrize("case", ["1-d", "3-d", "mapping", "short",
                                  "a1s2_short"])
def test_device_ingest_raises_as_prepare_rf(case):
    """Each bad shape raises the same error kind from the host check before
    any upload, from ``prepare_rf`` and through a session's handle."""
    c, a, s = 4, 2, 8
    mapping = np.arange(c, dtype=np.int16)
    contrast = ContrastMode.NoContrast
    raw = np.zeros((c, a * s), np.int16)
    if case == "1-d":
        raw = raw.ravel()
    elif case == "3-d":
        raw = raw[None]
    elif case == "mapping":
        mapping = np.array([0, 1, 2, 4], np.int16)
    elif case == "short":
        raw = raw[:, :-1]
    else:
        contrast = ContrastMode.A1S2
        raw = np.zeros((c, 3 * s - 1), np.int16)
    args = (c, a, s, contrast, DataKind.Int16)
    with pytest.raises(BeamformerError) as ref:
        prepare_rf(raw, mapping, *args)
    with pytest.raises(port_enums.BeamformerError) as host:
        upload.prepare_rf(raw, mapping, *args)
    with pytest.raises(port_enums.BeamformerError) as check:
        upload.raw_columns(raw.shape, mapping, *args)
    assert ref.value.kind == host.value.kind == check.value.kind \
        == port_enums.ErrorKind.DataSizeMismatch
    assert str(ref.value) == str(host.value) == str(check.value)

    bf = _setup(_params(c=c, a=a, s=s, contrast_mode=contrast), mapping)
    with StreamingSession(bf) as stream:
        with pytest.raises(port_enums.BeamformerError) as streamed:
            stream.submit(raw).result(timeout=TIMEOUT)
    assert str(streamed.value) == str(ref.value)


def test_mapping_rows_index_as_numpy():
    """Negative entries count from the end and out-of-range ones raise, as
    numpy's fancy indexing in ``prepare_rf`` does."""
    np.testing.assert_array_equal(
        upload.mapping_rows(np.array([-1, 0, -3, 2, 1], np.int16), 4, 5),
        [4, 0, 2, 2])
    with pytest.raises(IndexError):
        upload.mapping_rows(np.array([0, -6], np.int16), 2, 5)


# ---------------------------------------------------------------------------
# The StopImaging latch against the JAX executor
# ---------------------------------------------------------------------------

def test_stop_latch_matches_jax():
    """After a polling client consumes the dirty flag, both sessions stop:
    the executor's latch keeps the request.  ``active`` clears the latch."""
    jbf = jax_executor.Beamformer(voxel_block=128)
    bf = _setup()
    assert bf._stop_latch is jbf._stop_latch is False
    raw = np.zeros((8, 1024), np.int16)
    with jax_streaming.StreamingSession(jbf) as jstream, \
            StreamingSession(bf) as stream:
        _stop(jbf, LiveImagingParameters)
        _stop(bf, port_types.LiveImagingParameters)
        # a polling client consumes the flag before the sessions look
        assert jbf.live_parameters_get_dirty_flag() \
            == bf.live_parameters_get_dirty_flag() \
            == int(LiveImagingDirtyFlags.StopImaging)
        assert jbf._live_dirty == bf._live_dirty == 0
        assert jstream.submit(raw).result(timeout=TIMEOUT) is None
        assert stream.submit(raw).result(timeout=TIMEOUT) is None
        assert jstream.stop_requested and stream.stop_requested
    assert len(bf.get_last_frames(8)) == 0

    sequence = [(1, 0), (0, 0), (0, int(LiveImagingDirtyFlags.StopImaging)),
                (0, 0), (1, 0),
                (0, int(LiveImagingDirtyFlags.StopImaging
                        | LiveImagingDirtyFlags.ImagePlaneOffsets)),
                (1, int(LiveImagingDirtyFlags.StopImaging))]
    for active, flags in sequence:
        jbf.set_live_parameters(LiveImagingParameters(active=active),
                                dirty_flags=flags)
        bf.set_live_parameters(port_types.LiveImagingParameters(
            active=active), dirty_flags=flags)
        assert bf._stop_latch is jbf._stop_latch


# ---------------------------------------------------------------------------
# The launch count under threads
# ---------------------------------------------------------------------------

def test_count_launch_is_exact_across_threads():
    """A streaming worker and the caller's thread may launch at once: no
    count may be lost."""
    threads, per_thread = 16, 2000
    build.LAUNCHES.pop("stress", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [build.count_launch("stress")
                            for _ in range(per_thread)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=TIMEOUT)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert build.LAUNCHES.pop("stress") == threads * per_thread
