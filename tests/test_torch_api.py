"""The JAX package's remaining public API on the port, on the CPU, against
the JAX package on the same numpy inputs made from a seed:

  * each launcher of K1-K4 makes its tensor's card current before it takes
    the stream handle and launches, and puts the previous card back (with
    ``torch.cuda`` stubbed: a CPU tensor that says it lies on cuda:1 and a
    stand-in kernel library);
  * ``compiled_stage_fns`` stage by stage against the JAX package's on a
    Decode -> DAS plan (decode bit for bit, DAS NRMSE 1e-4), chained bit
    for bit ``compose_stages`` and the plan; ``clear_plan_cache`` and the
    hot reload dropping them;
  * ``resolve_das_backend`` on every name, and ``build_plan``'s
    ``das_backend`` and ``voxel_block``; the plan's facts against JAX's;
  * ``decode_hadamard(..., precision=p)`` against JAX at each ``p``;
  * ``Beamformer(voxel_block=, profile=, stage_timing=)``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import decode as jax_decode  # noqa: E402
from ogl_beamforming_tpu.params.enums import (  # noqa: E402
    AcquisitionKind, DataKind, InterpolationMode, ShaderKind)
from ogl_beamforming_tpu.params.types import Parameters  # noqa: E402
from ogl_beamforming_tpu.pipeline import plan as jax_plan  # noqa: E402
from ogl_beamforming_tpu.pipeline.spec import PipelineSpec  # noqa: E402
from ogl_beamforming_tpu.utils.transforms import (  # noqa: E402
    das_transform_2d_xz)
from ogl_beamforming_tpu_torch import convert  # noqa: E402
from ogl_beamforming_tpu_torch.kernels import build  # noqa: E402
from ogl_beamforming_tpu_torch.ops import (  # noqa: E402
    das, das_cuda, decode, filtering)
from ogl_beamforming_tpu_torch.pipeline import executor, plan  # noqa: E402
from ogl_beamforming_tpu_torch.pipeline.spec import (  # noqa: E402
    PipelineSpec as PortPipelineSpec)
from ogl_beamforming_tpu_torch.runtime import hotreload  # noqa: E402

torch.set_num_threads(1)

C, A, S, PITCH = 16, 4, 256, 0.3e-3
DECODE_DAS = [ShaderKind.Decode, ShaderKind.DAS]


def _params(**kw) -> Parameters:
    p = Parameters(
        sample_count=S, channel_count=C, acquisition_count=A,
        sampling_frequency=20e6, demodulation_frequency=5e6,
        speed_of_sound=1500.0, time_offset=1e-7, f_number=0.8,
        acquisition_kind=AcquisitionKind.FORCES,
        interpolation_mode=InterpolationMode.Cubic,
        das_voxel_transform=das_transform_2d_xz([0, 1e-3],
                                                [(C - 1) * PITCH, 8e-3]),
        xdc_element_pitch=np.array([PITCH, PITCH], np.float32),
        output_points=np.array([12, 16, 1, 0], np.int32))
    for k, v in kw.items():
        setattr(p, k, v)
    return p


def _port_plan(p, shaders=DECODE_DAS, kind=DataKind.Int16, **kw):
    return plan.build_plan(
        convert.parameters_from_fields(dataclasses.asdict(p)),
        PortPipelineSpec.from_shaders(shaders, kind), {}, device="cpu", **kw)


def _das_static(p_plan):
    return next(sd.das for sd in p_plan.descriptor.stages if sd.das)


# ---------------------------------------------------------------------------
# C3: each launcher runs on its own tensor's card
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on cuda:1: all a launcher reads of
    its inputs before the launch."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 1)


def _card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t.contiguous())


@pytest.fixture
def stub_cuda(monkeypatch):
    """``torch.cuda``'s current device, device switch and current stream,
    the kernel library and ``torch.empty`` stubbed; returns the events,
    ``("set", card)``, ``("stream", current card, stream's card)`` and
    ``("launch", entry point, current card, stream handle)``, and the
    current card (``state["current"]``, 0 at first)."""
    state = {"current": 0, "events": []}
    events = state["events"]

    def set_device(index):
        events.append(("set", int(index)))
        state["current"] = int(index)

    class Stream:
        cuda_stream = 0x5EED

    def current_stream(device=None):
        events.append(("stream", state["current"],
                       torch.device(device).index))
        return Stream()

    class Library:
        def __getattr__(self, name):
            def entry(*args):
                events.append(("launch", name, state["current"], args[-1]))
                return 0
            return entry

    empty = torch.empty
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(build, "library", Library)
    monkeypatch.setattr(build, "count_launch", lambda *a, **k: None)
    return state


def _launch_decode():
    rf = np.random.default_rng(1).integers(-512, 512, (C, A, S))
    decode.decode_hadamard(_card(torch.from_numpy(rf.astype(np.int16))),
                           _card(decode.hadamard_matrix(A, "cpu")))
    return "decode_int16"


def _launch_das():
    pp = _port_plan(_params(), [ShaderKind.DAS], DataKind.Float32)
    st = _das_static(pp)
    tables = das_cuda.launch_tables(st, pp.dyn["das"])
    tables = {k: _card(v) if isinstance(v, torch.Tensor) else v
              for k, v in tables.items()}
    das_cuda.das_cuda(_card(torch.zeros(C, A, S)), {"launch": tables}, st)
    return "das_launch"


def _launch_demodulate():
    omega = filtering.demod_omega(torch.tensor(np.float32(5e6)),
                                  torch.tensor(np.float32(20e6)), "cpu")
    filtering.demodulate_cuda(
        _card(torch.zeros(C, A, S, dtype=torch.int16)),
        _card(torch.ones(16)), 5e6, 20e6,
        phasor=_card(filtering.demod_phasor(omega, S // 2)))
    return "demodulate"


def _launch_fir():
    filtering.fir_cuda(_card(torch.zeros(C, A, S)), _card(torch.ones(8)))
    return "fir"


LAUNCHERS = {"K1 das_cuda": _launch_das, "K2 decode": _launch_decode,
             "K3 demodulate": _launch_demodulate, "K4 fir": _launch_fir}


@pytest.mark.parametrize("current", [0, 1], ids=["other_card_current",
                                                 "its_card_current"])
@pytest.mark.parametrize("launcher", list(LAUNCHERS))
def test_launcher_enters_its_tensors_device(stub_cuda, launcher, current):
    """A launch on cuda:1 while cuda:0 is current makes cuda:1 current,
    then takes cuda:1's stream, launches with that handle, and makes
    cuda:0 current again; with cuda:1 current nothing is switched."""
    stub_cuda["current"] = current
    entry = LAUNCHERS[launcher]()
    run = [("stream", 1, 1), ("launch", entry, 1, 0x5EED)]
    want = [("set", 1)] + run + [("set", 0)] if current == 0 else run
    assert stub_cuda["events"] == want
    assert stub_cuda["current"] == current


def test_occupancy_query_runs_on_the_card_asked_for(stub_cuda):
    st = _das_static(_port_plan(_params(), [ShaderKind.DAS],
                                DataKind.Float32))
    das_cuda.blocks_per_sm(st, A, device="cuda:1")
    events = stub_cuda["events"]
    assert [e[:3] for e in events] == [("set", 1),
                                       ("launch", "das_occupancy", 1),
                                       ("set", 0)]
    events.clear()
    das_cuda.blocks_per_sm(st, A)        # the current card
    assert [e[:3] for e in events] == [("launch", "das_occupancy", 0)]


def test_on_device_leaves_a_cpu_tensor_alone(stub_cuda):
    from ogl_beamforming_tpu_torch.utils.device import on_device
    with on_device(torch.zeros(1)):
        pass
    with on_device("cuda"):              # the current card, whichever
        pass
    assert stub_cuda["events"] == []


# ---------------------------------------------------------------------------
# The planner's JAX surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", [DataKind.Int16, DataKind.Int16Complex],
                         ids=lambda k: k.name)
def test_compiled_stage_fns_match_jax_stage_by_stage(kind):
    p = _params(coherency_weighting=True)
    jp = jax_plan.build_plan(p, PipelineSpec.from_shaders(DECODE_DAS, kind),
                             {}, voxel_block=128)
    pp = _port_plan(p, DECODE_DAS, kind)
    rng = np.random.default_rng(0x0621)
    rf = rng.integers(-1024, 1024, (C, A, S * kind.element_count)
                      ).astype(np.int16)
    fns = plan.compiled_stage_fns(pp.descriptor)
    jfns = jax_plan.compiled_stage_fns(jp.descriptor)
    assert len(fns) == len(jfns) == 2
    x, jx = torch.from_numpy(rf), rf
    outs = []
    for fn, jfn, bound in zip(fns, jfns, (0.0, 1e-4)):
        x, jx = fn(x, pp.dyn), np.asarray(jfn(jx, jp.dyn))
        assert x.shape == jx.shape
        assert np.abs(jx).max() > 0
        if bound:
            assert nrmse(jx, x.numpy()) <= bound
        else:                        # int16 decode is exact in both
            np.testing.assert_array_equal(x.numpy(), jx)
        outs.append(x)
    frame = torch.from_numpy(rf)
    assert torch.equal(outs[-1], plan.compose_stages(pp.descriptor, frame,
                                                     pp.dyn))
    assert torch.equal(outs[-1], pp(frame))
    assert torch.equal(outs[-1], pp.fn(frame, pp.dyn))


def test_compose_stages_keyword_arguments():
    """``skip_coherency_normalize`` returns the (coherent, incoherent)
    pair; ``stage_key_offset`` reads a later stage's dyn entries."""
    pp = _port_plan(_params(coherency_weighting=True))
    rf = torch.from_numpy(np.random.default_rng(2).integers(
        -1024, 1024, (C, A, S)).astype(np.int16))
    coh, inco = plan.compose_stages(pp.descriptor, rf, pp.dyn,
                                    skip_coherency_normalize=True)
    assert coh.shape == inco.shape == (12, 16, 1)
    desc = dataclasses.replace(pp.descriptor,
                               stages=pp.descriptor.stages[:1])
    dyn = {"hadamard3": pp.dyn["hadamard0"]}
    assert torch.equal(
        plan.compose_stages(desc, rf, dyn, stage_key_offset=3),
        plan.compose_stages(desc, rf, pp.dyn))


def test_clear_plan_cache_drops_the_stage_fns():
    pp = _port_plan(_params())
    fns = plan.compiled_stage_fns(pp.descriptor)
    assert plan.compiled_stage_fns(pp.descriptor) is fns
    plan.clear_plan_cache()
    again = plan.compiled_stage_fns(pp.descriptor)
    assert again is not fns
    hotreload.invalidate_compiled()
    assert plan.compiled_stage_fns(pp.descriptor) is not again


@pytest.mark.parametrize("backend", sorted(plan.DAS_BACKENDS))
def test_resolve_das_backend(backend):
    kernel = backend in ("auto", "cuda", "pallas")
    assert plan.resolve_das_backend(backend, "cuda") == (
        "cuda" if kernel else "torch")
    if backend in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            plan.resolve_das_backend(backend, "cpu")
        with pytest.raises(ValueError, match="CUDA kernel"):
            _port_plan(_params(), das_backend=backend)
    else:
        assert plan.resolve_das_backend(backend, "cpu") == "torch"
        # "auto" stays "auto" in the plan: the DAS of the data's device
        assert _das_static(_port_plan(_params(), das_backend=backend)
                           ).backend == ("auto" if backend == "auto"
                                         else "torch")


def test_resolve_das_backend_refuses_other_names():
    assert plan.resolve_das_backend() == "cuda"
    with pytest.raises(ValueError, match="not one of"):
        plan.resolve_das_backend("mosaic", "cpu")


def test_das_backend_cuda_refuses_a_cpu_tensor():
    pp = _port_plan(_params(), [ShaderKind.DAS], DataKind.Float32)
    st = dataclasses.replace(_das_static(pp), backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        das.das(torch.zeros(C, A, S), pp.dyn["das"], st)
    assert das.das_jit is das.das


def test_plan_keywords_and_facts_match_jax():
    """``voxel_block`` reaches the DAS static; ``channel_mapping`` is
    taken; the plan's facts are the JAX plan's."""
    p = _params()
    jp = jax_plan.build_plan(p, PipelineSpec.from_shaders(
        DECODE_DAS, DataKind.Int16), {}, channel_mapping=np.arange(C),
        voxel_block=128)
    pp = _port_plan(p, channel_mapping=np.arange(C), voxel_block=128)
    assert _das_static(pp).voxel_block == 128
    for name in ("output_points", "iq", "time_offset", "das_sample_count",
                 "das_sampling_frequency"):
        assert getattr(pp, name) == getattr(jp, name), name


@pytest.mark.parametrize("precision", ["default", "high", "highest"])
@pytest.mark.parametrize("dtype", ["int16", "float32", "complex64"])
def test_decode_precision_matches_jax(precision, dtype):
    rng = np.random.default_rng(3)
    rf = rng.integers(-1024, 1024, (C, A, S)).astype(np.float32)
    if dtype == "complex64":
        rf = (rf + 1j * rng.integers(-1024, 1024, rf.shape)
              ).astype(np.complex64)
    rf = rf.astype(dtype)
    h = decode.hadamard_matrix(A, "cpu")
    out = decode.decode_hadamard(torch.from_numpy(rf), h, precision)
    ref = np.asarray(jax_decode.decode_hadamard(
        rf, jax_decode.hadamard_matrix(A), precision=precision))
    if dtype == "int16":
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        assert nrmse(ref, out.numpy()) <= 1e-6
    np.testing.assert_array_equal(
        decode.decode_hadamard_ref(torch.from_numpy(rf), h).numpy(),
        out.numpy())


def test_decode_refuses_another_precision():
    with pytest.raises(ValueError, match="precision"):
        decode.decode_hadamard(torch.zeros(C, A, S),
                               decode.hadamard_matrix(A, "cpu"), "fastest")


def test_beamformer_options():
    """``voxel_block`` reaches the plan; ``profile`` and every
    ``stage_timing`` give the stats row of every stage; another
    ``stage_timing`` raises."""
    p = convert.parameters_from_fields(dataclasses.asdict(_params()))
    raw = np.random.default_rng(4).integers(
        -1024, 1024, (C, A * S)).astype(np.int16)
    frames = []
    for kw in ({}, dict(voxel_block=128, profile=True,
                        stage_timing="device")):
        bf = executor.Beamformer(device="cpu", **kw)
        bf.push_parameters(p)
        bf.push_pipeline(DECODE_DAS, DataKind.Int16)
        frames.append(bf.push_data_with_compute(raw).data)
        assert (bf.compute_timings().times[0][:2] > 0).all()
        assert _das_static(bf._blocks[0]._plan).voxel_block == kw.get(
            "voxel_block", 65536)
        assert bf.profile == kw.get("profile", False)
    assert torch.equal(*frames)
    with pytest.raises(ValueError, match="stage_timing"):
        executor.Beamformer(device="cpu", stage_timing="wall")
