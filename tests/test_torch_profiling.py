"""The port's trace-based device timing (``utils/profiling.py``) and
``Beamformer.profile_device_stages`` on the CPU, mirroring
``tests/test_profiling.py``: the parser against a synthetic Chrome trace in
``torch.profiler``'s layout, and the zero device time of CPU work (a CPU
trace holds no kernel events).  Device times need the card:
``tests/test_torch_cuda.py`` checks them there."""

import json
import os

import numpy as np
import pytest
import torch

from ogl_beamforming_tpu_torch import (AcquisitionKind, DataKind,
                                       InterpolationMode, Parameters,
                                       ShaderKind)
from ogl_beamforming_tpu_torch.pipeline.executor import Beamformer
from ogl_beamforming_tpu_torch.utils import profiling
from ogl_beamforming_tpu_torch.utils.profiling import (DeviceProfile,
                                                       _parse_trace,
                                                       device_time)
from ogl_beamforming_tpu_torch.utils.transforms import das_transform_2d_xz


def _write_trace(tmpdir, events, name="host.pt.trace.json"):
    with open(os.path.join(tmpdir, name), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_parse_trace_sums_kernels_by_name(tmp_path):
    events = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        # host events, ignored whatever their names
        {"ph": "X", "cat": "cpu_op", "name": "aten::matmul", "pid": 11,
         "tid": 11, "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 11, "tid": 11, "ts": 1.0, "dur": 5.0,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": "das_forces_kernel",
         "pid": 11, "tid": 11, "ts": 0.0, "dur": 999.0},
        # device events: kernels summed by name, copies apart
        {"ph": "X", "cat": "kernel", "name": "das_forces_kernel", "pid": 0,
         "tid": 7, "ts": 10.0, "dur": 100.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "decode_kernel<short>",
         "pid": 0, "tid": 7, "ts": 120.0, "dur": 20.0},
        {"ph": "X", "cat": "Kernel", "name": "decode_kernel<short>",
         "pid": 0, "tid": 7, "ts": 150.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> "
         "Device)", "pid": 0, "tid": 7, "ts": 0.0, "dur": 8.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 9.0, "dur": 1.0},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0, "tid": 7,
         "ts": 10.0, "id": 7},
    ]
    _write_trace(str(tmp_path), events)
    prof = _parse_trace(str(tmp_path))
    assert abs(prof.module_seconds - 150e-6) < 1e-12
    assert abs(prof.op_seconds["das_forces_kernel"] - 100e-6) < 1e-12
    assert abs(prof.op_seconds["decode_kernel<short>"] - 50e-6) < 1e-12
    assert abs(prof.copy_seconds - 9e-6) < 1e-12
    assert set(prof.op_seconds) == {"das_forces_kernel",
                                    "decode_kernel<short>"}
    assert prof.kernel_count == 3
    assert prof.top_ops[0][0] == "das_forces_kernel"


def test_copy_overlap_counts_copy_time_under_kernels(tmp_path):
    """Each copy's time inside the union of the kernels' device spans: two
    kernels that overlap count once, a copy across two kernels counts
    both parts, a copy on an idle card counts nothing."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10.0, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 105.0, "dur": 45.0},
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 300.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "ts": 0.0, "dur": 20.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> "
         "Device)", "ts": 140.0, "dur": 170.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "ts": 400.0, "dur": 10.0},
    ]
    _write_trace(str(tmp_path), events)
    prof = _parse_trace(str(tmp_path))
    np.testing.assert_allclose(
        np.array(prof.kernel_spans),
        [(10.0, 100e-6), (105.0, 45e-6), (300.0, 20e-6)], rtol=0, atol=1e-12)
    assert [s for s, _ in prof.copy_spans] == [0.0, 140.0, 400.0]
    # 10 us of the first copy, 10 + 10 us of the second, none of the memset
    assert abs(prof.copy_overlap_seconds - 30e-6) < 1e-12
    assert DeviceProfile(0.0, {}).copy_overlap_seconds == 0.0


def test_parse_trace_leaves_out_work_launched_before_the_call(tmp_path):
    """The kernel launched before ``device_time``'s annotation around its
    call (the one it launches to take a lost first event, roadmap C2) and
    its launch call are left out; without the annotation nothing is."""
    def launch(corr, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 2.0, "args": {"correlation": corr}}

    def kernel(name, corr, ts, dur):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"correlation": corr}}

    call = {"ph": "X", "cat": "user_annotation", "name": profiling._CALL,
            "ts": 100.0, "dur": 500.0}
    events = [launch(1, 0.0), kernel("fill", 1, 5.0, 1.0), call,
              launch(2, 110.0), kernel("das_forces_kernel", 2, 120.0, 300.0),
              launch(3, 115.0)]
    _write_trace(str(tmp_path), events)
    prof = _parse_trace(str(tmp_path))
    assert [k[0] for k in prof.kernels] == ["das_forces_kernel"]
    assert abs(prof.module_seconds - 300e-6) < 1e-12
    assert prof.launch_calls == [110.0, 115.0]
    assert prof.orphan_launches == [115.0]
    events.remove(call)
    _write_trace(str(tmp_path), events)
    whole = _parse_trace(str(tmp_path))
    assert [k[0] for k in whole.kernels] == ["fill", "das_forces_kernel"]
    assert whole.launch_calls == [0.0, 110.0, 115.0]


def test_parse_trace_without_a_trace_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no trace"):
        _parse_trace(str(tmp_path))


def test_card_work_without_kernel_events_raises(monkeypatch):
    """Work on the card must show kernel events: none is an error, never a
    device time of 0."""
    monkeypatch.setattr(profiling, "_on_card", lambda values: True)
    with pytest.raises(RuntimeError, match="no CUDA kernel events"):
        device_time(lambda x: x * 2.0, torch.ones(8))


def test_lost_kernels_names_the_kernel_and_the_call():
    """A kernel counted in kernels/build.KERNEL_LAUNCHES (by the name a
    trace shows it under) of which the trace holds fewer events is named
    with the call; kernels not launched in the call are not checked."""
    prof = DeviceProfile(module_seconds=0.0, op_seconds={}, kernels=[
        ("void (anonymous namespace)::das_forces_kernel<2, true>(...)", 1.0,
         1e-3),
        ("void at::native::vectorized_elementwise_kernel<...>", 2.0, 1e-6)])
    lines = profiling.lost_kernels(
        prof, {"das_forces_kernel": 1, "demodulate_kernel": 1,
               "i8_mma_kernel": 0}, "frame")
    assert lines == ["demodulate_kernel: 1 launched by frame, 0 in the "
                     "trace of 2 kernel events; launch calls without a "
                     "kernel event, of 0: none"]
    assert profiling.lost_kernels(prof, {"das_forces_kernel": 1},
                                  "frame") == []
    assert profiling.lost_kernels(prof, {"das_forces_kernel": 2},
                                  "frame") != []


def test_parse_trace_finds_launches_without_a_kernel(tmp_path):
    """A kernel launch call whose correlation id no kernel event carries is
    an orphan; the lost line says which launch call of the window it was
    and when.  Copies and other runtime calls are not launch calls."""
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1000.0, "dur": 2.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 1500.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2000.0, "dur": 2.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 3500.0, "dur": 2.0, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "void gather_kernel<16, true>",
         "ts": 1010.0, "dur": 900.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "void gather_kernel<16, true>",
         "ts": 3600.0, "dur": 900.0, "args": {"correlation": 4}},
    ]
    _write_trace(str(tmp_path), events)
    prof = _parse_trace(str(tmp_path))
    assert prof.launch_calls == [1000.0, 2000.0, 3500.0]
    assert prof.orphan_launches == [2000.0]
    (line,) = profiling.lost_kernels(prof, {"gather_kernel": 3}, "3 calls")
    assert line.endswith("2 in the trace of 2 kernel events; launch calls "
                         "without a kernel event, of 3: #2 at +1.000 ms; "
                         "kernel start minus launch call 10 to 100 us")
    assert prof.start_lags_us == [10.0, 100.0]


def test_start_lags_show_the_clock_conversion(tmp_path):
    """A kernel whose device start, on the host clock, lies before its
    launch call shows the trace's clock conversion error as a negative
    start lag."""
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 5000.0, "dur": 2.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "fir_kernel",
         "ts": 2000.0, "dur": 3.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "no_launch_event",
         "ts": 2100.0, "dur": 3.0, "args": {"correlation": 8}},
    ]
    _write_trace(str(tmp_path), events)
    assert _parse_trace(str(tmp_path)).start_lags_us == [-3000.0]


def test_trace_window_measures_the_card_alone():
    from ogl_beamforming_tpu_torch.experiments import trace_window
    with pytest.raises(RuntimeError):
        trace_window.main(["--seconds", "0"], device="cpu")


def test_device_time_records_a_lost_kernel(monkeypatch):
    """A trace with kernel events but one gather launch of two missing is
    returned as it is (no retrace), with the kernel and the call named in
    its ``lost`` and in a LostKernelEvents warning."""
    from ogl_beamforming_tpu_torch.kernels import build
    monkeypatch.setattr(build, "LAUNCHES", build.collections.Counter())
    monkeypatch.setattr(build, "KERNEL_LAUNCHES", build.collections.Counter())
    monkeypatch.setattr(profiling, "_on_card", lambda values: True)
    traces = []

    def one_kernel(path):
        traces.append(path)
        return DeviceProfile(module_seconds=1e-6, op_seconds={}, kernels=[
            ("void (anonymous namespace)::gather_floor_kernel<1, true>(...)",
             1.0, 1e-6)])

    monkeypatch.setattr(profiling, "_parse_trace", one_kernel)

    def two_gathers(x):
        build.count_launch("micro_gather", "gather_floor_kernel")
        build.count_launch("micro_gather", "gather_floor_kernel")
        return x * 2.0

    with pytest.warns(profiling.LostKernelEvents) as caught:
        prof = device_time(two_gathers, torch.ones(8))
    assert len(traces) == 1
    assert len(prof.lost) == 1
    assert [str(w.message) for w in caught] == prof.lost
    assert prof.lost[0].startswith("gather_floor_kernel: ")
    assert "2 launched by " in prof.lost[0] and "two_gathers" in prof.lost[0]
    assert ": 2 launched by" in prof.lost[0] and ", 1 in the trace" in \
        prof.lost[0]


def test_split_attributes_kernels_by_launch(tmp_path):
    """A kernel belongs to the segment during which it was launched: the
    launch call shares its correlation id, and annotations close
    segments."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "stage_end:0",
         "ts": 100.0, "dur": 1.0},
        {"ph": "X", "cat": "user_annotation", "name": "stage_end:1",
         "ts": 200.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50.0, "dur": 2.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 150.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 160.0, "dur": 2.0, "args": {"correlation": 3}},
        # device time runs late: the launch, not the kernel, decides
        {"ph": "X", "cat": "kernel", "name": "decode", "ts": 180.0,
         "dur": 40.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "das", "ts": 230.0,
         "dur": 300.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "cast", "ts": 540.0,
         "dur": 5.0, "args": {"correlation": 3}},
    ]
    _write_trace(str(tmp_path), events)
    prof = _parse_trace(str(tmp_path))
    marks = ["stage_end:0", "stage_end:1"]
    got = prof.split(marks)
    assert abs(got[0] - 40e-6) < 1e-12 and abs(got[1] - 305e-6) < 1e-12
    events.append({"ph": "X", "cat": "kernel", "name": "orphan", "ts": 9.0,
                   "dur": 1.0, "args": {"correlation": 99}})
    _write_trace(str(tmp_path), events, name="later.json")
    with pytest.raises(RuntimeError, match="no launch event"):
        _parse_trace(str(tmp_path)).split(marks)


def test_device_time_runs_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2.0).sum()

    prof = device_time(fn, torch.ones((64, 64)))
    assert isinstance(prof, DeviceProfile)
    assert len(calls) == 2                  # one warm-up, one traced
    assert prof.module_seconds == 0.0 and prof.op_seconds == {}
    assert prof.window_seconds > 0.0 and prof.busy_share == 0.0


def test_profile_device_stages_cpu():
    """One entry per stage of the plan, 0.0 each on the CPU, recorded as one
    row of the stats table when asked; the frame is unaffected."""
    c, a, s, pitch = 8, 4, 256, 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(device="cpu")
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    raw = np.random.default_rng(3).integers(-512, 512, (c, a * s)
                                            ).astype(np.int16)
    before = bf.push_data_with_compute(raw).to_numpy()
    times = bf.profile_device_stages(raw.reshape(c, a, s), record=True)
    assert [k for k, _ in times] == [ShaderKind.Decode, ShaderKind.DAS]
    assert all(t == 0.0 for _, t in times)
    row = (bf.stats._frame_index - 1) % 32
    assert bf.stats._frame_index == 2
    assert list(bf.stats.table.times[row, :2]) == [0.0, 0.0]
    np.testing.assert_array_equal(bf.push_data_with_compute(raw).to_numpy(),
                                  before)


def _stages_beamformer():
    c, a, s, pitch = 8, 4, 256, 0.3e-3
    p = Parameters(
        sample_count=s, channel_count=c, acquisition_count=a,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Linear,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(c - 1) * pitch, 8e-3]),
        xdc_element_pitch=np.array([pitch, pitch], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    bf = Beamformer(device="cpu")
    bf.push_parameters(p)
    bf.push_pipeline([ShaderKind.Decode, ShaderKind.DAS], DataKind.Int16)
    return bf, np.zeros((c, a, s), np.int16)


@pytest.mark.parametrize("lost_traces", [0, 1, 2, profiling.TRACE_ATTEMPTS])
def test_profile_device_stages_retakes_a_trace_that_lost_a_kernel(
        monkeypatch, lost_traces):
    """A trace whose profile names a lost kernel (roadmap C2) is taken
    again, up to TRACE_ATTEMPTS traces, the warm-up only before the first;
    the last trace gives the stage times."""
    bf, rf = _stages_beamformer()
    calls = []

    def fake_device_time(fn, *args, warmup=1):
        calls.append(warmup)
        fn(*args)
        n = len(calls)
        prof = DeviceProfile(module_seconds=n * 1e-3, op_seconds={})
        prof.annotations = {"stage_end:0": 10.0, "stage_end:1": 20.0}
        prof.kernels = [("decode_i8_kernel", 5.0, n * 1e-3),
                        ("das_forces_kernel", 15.0, 2e-3)]
        prof.lost = (["das_forces: 1 launched, 0 in the trace"]
                     if n <= lost_traces else [])
        return prof

    monkeypatch.setattr(profiling, "device_time", fake_device_time)
    times = bf.profile_device_stages(rf)
    taken = min(lost_traces + 1, profiling.TRACE_ATTEMPTS)
    assert calls == [1] + [0] * (taken - 1)
    assert [t for _, t in times] == [pytest.approx(taken * 1e-3),
                                     pytest.approx(2e-3)]


def test_traced_ms_over_the_calls_whose_events_it_holds(monkeypatch):
    """``experiments.traced_ms`` with a kernel filter: the filtered kernels'
    time over the calls, or over the events the trace holds where it lost
    some (one kernel of 20 calls missing: the mean, not 19/20 of it)."""
    from ogl_beamforming_tpu_torch import experiments
    k = ("void gather_kernel<16, true>(...)", 0.0, 1e-3)
    other = ("void at::native::elementwise_kernel", 0.0, 5e-3)
    prof = DeviceProfile(module_seconds=0.0, op_seconds={})
    monkeypatch.setattr(profiling, "device_time", lambda fn: prof)
    for kernels, want in (([k] * 20 + [other], 1.0), ([k] * 19, 1.0),
                          ([k] * 40, 2.0)):
        prof.kernels = kernels
        got = experiments.traced_ms(lambda: None, iters=20,
                                    kernel="gather_kernel")
        assert abs(got - want) < 1e-12
