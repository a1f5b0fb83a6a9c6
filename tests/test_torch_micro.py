"""The port's microbenchmark bodies (``ogl_beamforming_tpu_torch.
experiments``, K5-K11) against the JAX package's Pallas bodies themselves.

Each ``experiments/<file>.main()`` runs once with ``pl.pallas_call``
replaced by a stub that records ``(kernel, grid, out_shape)`` and returns
zeros, so no Pallas program is built or interpreted.  Each recorded body
then runs eagerly under JAX on the CPU with numpy arrays as its refs, on the
inputs the port's ``make_inputs`` draws, and the port's plain version (its
wrapper on CPU tensors) gets the same inputs.

Tolerances: the variants that only gather and add, and both int8 probes,
are bit-equal (the same integer or float32 additions in the same order);
the variants that multiply, and the one-hot products, are within NRMSE
1e-6 (the same float32 operations, summed in another order in the one-hot
product).
"""

import contextlib
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from helpers import nrmse

from ogl_beamforming_tpu_torch.experiments import ONEHOT_BATCHES
from ogl_beamforming_tpu_torch.experiments import gather_micro as k5
from ogl_beamforming_tpu_torch.experiments import gather_micro2 as k6
from ogl_beamforming_tpu_torch.experiments import gather_micro3 as k7
from ogl_beamforming_tpu_torch.experiments import onehot_micro as k8
from ogl_beamforming_tpu_torch.experiments import onehot_micro2 as k9
from ogl_beamforming_tpu_torch.experiments import probe_i8 as k10
from ogl_beamforming_tpu_torch.experiments import probe_i8b as k11

FILES = ("gather_micro", "gather_micro2", "gather_micro3", "onehot_micro",
         "onehot_micro2", "probe_i8", "probe_i8b")
PORT = dict(zip(FILES, (k5, k6, k7, k8, k9, k10, k11)))
ADD_ONLY = {"clip", "mod", "raw", "f32_direct", "i32_direct", "bcast_hoist",
            "bcast_chunk"}


@pytest.fixture(scope="module")
def bodies():
    """file -> the (kernel, grid, out_shape) its main() hands pallas_call,
    in call order."""
    recorded = {}
    orig = pl.pallas_call
    try:
        for name in FILES:
            calls = recorded[name] = []

            def stub(kernel, *args, out_shape=None, grid=None, calls=calls,
                     **kw):
                calls.append((kernel, grid, out_shape))
                return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

            pl.pallas_call = stub
            mod = importlib.import_module(f"experiments.{name}")
            with contextlib.redirect_stdout(io.StringIO()):
                mod.main()
    finally:
        pl.pallas_call = orig
    return recorded


def run_body(kernel, out_shape, *inputs):
    """A Pallas body run eagerly on numpy refs; returns its output ref."""
    out = np.zeros(out_shape.shape, out_shape.dtype)
    with jax.default_device(jax.devices("cpu")[0]):
        kernel(*[np.asarray(x) for x in inputs], out)
    return out


def numpy_of(inputs: dict) -> dict:
    return {k: (tuple(t.numpy() for t in v) if isinstance(v, tuple)
                else v.numpy()) for k, v in inputs.items()}


def check(port, ref, exact: bool):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    assert port.shape == ref.shape
    assert np.isfinite(port).all() and np.abs(ref).max() > 0
    if exact:
        np.testing.assert_array_equal(port, ref)
    else:
        assert nrmse(ref, port) <= 1e-6


def test_every_file_hands_its_bodies_over(bodies):
    counts = {name: len(calls) for name, calls in bodies.items()}
    assert counts == {"gather_micro": 4, "gather_micro2": 8,
                      "gather_micro3": 15, "onehot_micro": 4,
                      "onehot_micro2": 12, "probe_i8": 2, "probe_i8b": 5}
    assert bodies["gather_micro3"][0][1] == (k7.STEPS,)
    assert bodies["onehot_micro2"][0][1] == (k9.STEPS,)


@pytest.mark.parametrize("i", range(len(k5.VARIANTS)),
                         ids=list(k5.VARIANTS))
def test_gather_micro_k5(bodies, i):
    variant = k5.VARIANTS[i]
    kernel, grid, out_shape = bodies["gather_micro"][i]
    assert grid == (k5.STEPS,)
    x = k5.make_inputs("cpu")
    ref = run_body(kernel, out_shape, x["src"].numpy(), x["idx"].numpy())
    check(k5.kernel(variant, x["src"], x["idx"]), ref, variant in ADD_ONLY)


@pytest.mark.parametrize("i", range(len(k6.VARIANTS)),
                         ids=list(k6.VARIANTS))
def test_gather_micro2_k6(bodies, i):
    variant = k6.VARIANTS[i]
    kernel, grid, out_shape = bodies["gather_micro2"][i]
    assert grid == (k6.STEPS,)
    x = k6.make_inputs("cpu")
    src, src2 = x[variant]
    ref = run_body(kernel, out_shape, src.numpy(), src2.numpy(),
                   x["idx"].numpy(), x["w"].numpy())
    check(k6.kernel(variant, src, src2, x["idx"], x["w"]), ref,
          variant in ADD_ONLY)


K7_CASES = [(v, reps) for v in k7.VARIANTS for reps in k7.REPS_SWEEP]


@pytest.mark.parametrize("i", range(len(K7_CASES)),
                         ids=[f"{v}-{r}" for v, r in K7_CASES])
def test_gather_micro3_k7(bodies, i):
    variant, reps = K7_CASES[i]
    kernel, grid, out_shape = bodies["gather_micro3"][i]
    assert grid == (k7.STEPS,)
    x = k7.make_inputs("cpu")
    src, src2 = k7.sources(variant, x)
    ref = run_body(kernel, out_shape, src.numpy(), src2.numpy(),
                   x["idx"].numpy(), x["w"].numpy())
    check(k7.kernel(variant, src, src2, x["idx"], x["w"], reps), ref,
          variant in ADD_ONLY)


def _onehot_cases(units_sweep):
    return ([("gather", u) for u in units_sweep]
            + [(b, u) for b in ONEHOT_BATCHES for u in units_sweep])


def _check_onehot_file(name, mod, bodies, i, units, case):
    kernel, _, out_shape = bodies[name][i]
    x = mod.make_inputs("cpu")
    if case == "gather":
        args = (x["src"], x["src2"], x["idx"], x["w"])
        port = mod.gather_kernel(*args, units=units)
    else:
        args = (x[f"rf{case}"], x["kvox"], x["wt4"])
        port = mod.onehot_kernel(*args, units=units)
    ref = run_body(kernel, out_shape, *[t.numpy() for t in args])
    check(port, ref, exact=False)


K8_CASES = _onehot_cases((k8.UNITS,))


@pytest.mark.parametrize("i", range(len(K8_CASES)),
                         ids=[str(c) for c, _ in K8_CASES])
def test_onehot_micro_k8(bodies, i):
    case, units = K8_CASES[i]
    _check_onehot_file("onehot_micro", k8, bodies, i, units, case)


K9_CASES = _onehot_cases(k9.UNITS_SWEEP)


@pytest.mark.parametrize("i", range(len(K9_CASES)),
                         ids=[f"{c}-{u}" for c, u in K9_CASES])
def test_onehot_micro2_k9(bodies, i):
    case, units = K9_CASES[i]
    _check_onehot_file("onehot_micro2", k9, bodies, i, units, case)


@pytest.mark.parametrize("i", range(len(k10.BODIES)), ids=list(k10.BODIES))
def test_probe_i8_k10(bodies, i):
    name, od = list(k10.BODIES.items())[i]
    kernel, _, out_shape = bodies["probe_i8"][i]
    x = k10.make_inputs("cpu")
    a, b = x["a"].numpy(), x["b"].numpy()
    ref = run_body(kernel, out_shape, a, b)
    port = k10.kernel2(x["a"], x["b"], od)
    check(port, ref, exact=True)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    np.testing.assert_array_equal(port.numpy().astype(np.int64), exact)


@pytest.mark.parametrize("i", range(len(k11.BODIES)), ids=list(k11.BODIES))
def test_probe_i8b_k11(bodies, i):
    body = k11.BODIES[i]
    kernel, _, out_shape = bodies["probe_i8b"][i]
    x = k11.make_inputs("cpu")
    ref = run_body(kernel, out_shape, x["h"].numpy(), x["x"].numpy())
    port = k11.k(body, x["h"], x["x"])
    check(port, ref, exact=True)
    if body == "full":
        np.testing.assert_array_equal(port.numpy().astype(np.float64),
                                      k11.full_exact(x["h"], x["x"]))


def test_probe_i8b_full_exact_over_the_int16_range():
    """The split X = 256 hi + lo + 128 is exact at the int16 extremes."""
    x = torch.tensor([[-32768, -32767, -1, 0, 1, 255, 256, 32767]] * 16,
                     dtype=torch.int16).repeat(1, 8)
    h = k11.make_inputs("cpu")["h"]
    np.testing.assert_array_equal(k11.k("full", h, x).numpy(),
                                  k11.full_exact(h, x))


@pytest.mark.parametrize("name", FILES)
def test_main_needs_a_gpu(name, monkeypatch):
    """Every main() measures the card: RuntimeError without one, and for a
    CPU device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PORT[name].main()
    with pytest.raises(RuntimeError):
        PORT[name].main(device="cpu")


def _listing(functions: dict) -> str:
    """A cuobjdump -sass listing of ``{mangled name: [instruction]}``."""
    lines = []
    for name, body in functions.items():
        lines.append(f"\t\tFunction : _ZN12_GLOBAL__N_1{name}")
        lines += [f"        /*{16 * i:04x}*/  {ins} ;"
                  for i, ins in enumerate(body)]
    return "\n".join(lines)


def _gather_counts(instructions=0, LDS=0, LDG=0, FADD=0, FMUL=0, FFMA=0,
                   integer=0, convert=0, LDS128=0):
    return {"instructions": instructions, "LDS": LDS, "LDG": LDG,
            "LDS128": LDS128, "float": FADD + FMUL + FFMA, "FADD": FADD,
            "FMUL": FMUL, "FFMA": FFMA, "integer": integer,
            "convert": convert}


def test_sass_counts_the_gather_loops():
    """kernels/sass.gather_loops on a synthetic listing of each kernel.
    K7's and the bundle's persistent ``gather_walk_kernel``: the lane
    dealing and the staging wait (loops without float arithmetic) left
    out, the walk's turn loop and its tail loop inside the unit loop, the
    unit loop's own code (the table and index loads, the joining add, the
    store) apart from both.  K5/K6's persistent ``gather_floor_kernel``:
    the staging wait left out, the repetition loop inside the unit loop,
    the unit loop's own code (the joining adds, the conversions, the store)
    apart from both.  experiments.gather_work scales each to a launch: the
    outside code once a warp of the grid, the unit loop once per unit (a
    row of a step; 32 elements of a step), the walk's loops as
    ``walk_trips`` turns them."""
    from ogl_beamforming_tpu_torch.experiments import (FLOOR_UNITS,
                                                       FLOOR_WARPS,
                                                       HERMITE_IDS,
                                                       WALK_UNITS,
                                                       WALK_WARPS,
                                                       gather_work,
                                                       walk_trips)
    from ogl_beamforming_tpu_torch.kernels import sass
    walk = ["LDG.E R2, desc[UR4][R6.64]",                  # 0x00 dealing
            "STS.U8 [R3], R2",                             # 0x10
            "ISETP.GE.AND P0, PT, R3, 0x800, PT",          # 0x20
            "@!P0 BRA 0x0",                                # 0x30
            "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], RZ",  # 0x40
            "@!P0 BRA 0x40",                               # 0x50 wait
            "LDS.U16 R8, [R9]",                            # 0x60 unit loop
            "LDG.E R10, desc[UR4][R8.64]",                 # 0x70
            "LDS.128 R12, [R9+0x10]",                      # 0x80 turn loop
            "PRMT R16, R12, 0x7632, R17",                  # 0x90
            "FADD R18, R16, -8.421376e+06",                # 0xa0
            "FFMA R20, R18, R11, R20",                     # 0xb0
            "FFMA R21, R18, R11, R21",                     # 0xc0
            "@!P1 BRA 0x80",                               # 0xd0
            "LDS.128 R12, [R9]",                           # 0xe0 tail
            "FFMA R20, R18, R11, R20",                     # 0xf0
            "@!P2 BRA 0xe0",                               # 0x100
            "FADD R22, R20, R21",                          # 0x110
            "STG.E desc[UR4][R6.64], R22",                 # 0x120
            "@P3 BRA 0x60",                                # 0x130
            "EXIT"]                                        # 0x140
    floor = ["SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], RZ",  # 0x00
             "@!P0 BRA 0x0",                                # 0x10 wait
             "LDG.E.128 R4, desc[UR4][R2.64]",              # 0x20 unit loop
             "LDS R8, [R9]",                                # 0x30
             "I2F.S16 R10, R8",                             # 0x40
             "FFMA R12, R10, R11, R12",                     # 0x50 rep loop
             "FFMA R13, R10, R11, R13",                     # 0x60
             "FFMA R14, R10, R11, R14",                     # 0x70
             "IADD3 R20, R20, 0x10, RZ",                    # 0x80
             "ISETP.GE.AND P1, PT, R20, R21, PT",           # 0x90
             "@!P1 BRA 0x50",                               # 0xa0
             "FADD R12, R12, R13",                          # 0xb0
             "STG.E.128 desc[UR4][R2.64], R12",             # 0xc0
             "IADD3 R22, R22, 0x1, RZ",                     # 0xd0
             "@P2 BRA 0x20",                                # 0xe0
             "EXIT"]                                        # 0xf0
    walk_name = "18gather_walk_kernelILi{}ELb1EEEvPKiS1_S1_PKfPfiiiiif"
    text = _listing({walk_name.format(16): walk,
                     walk_name.format(HERMITE_IDS[False]): walk,
                     "13hermite_kernelILb1ELb1EEEvPKiS1_S1_PKfPfi": walk,
                     "19gather_floor_kernelILi10ELb1EEEvPKiS1_S1_PKfPfiii":
                         floor})
    counts = sass.gather_loops(text)
    assert set(counts) == {(16, True), (HERMITE_IDS[False], True),
                           (10, True)}
    c = counts[(16, True)]
    assert c["kernel"] == "gather_walk_kernel" and c["step"] is None
    assert c["body"] == _gather_counts(6, LDS=1, LDS128=1, FADD=1, FFMA=2,
                                       integer=1)
    assert c["tail"] == _gather_counts(3, LDS=1, LDS128=1, FFMA=1)
    assert c["unit"] == _gather_counts(5, LDS=1, LDG=1, FADD=1)
    assert c["outside"] == _gather_counts(1)
    # K7 hermite_pair at REPS 224: 112 words, 28 quads, the first in the
    # unit loop's own code, then 6 turns and 3 tails
    assert walk_trips(16, 224) == (6, 3)
    work = gather_work(c, reps=224, steps=3, grid=5, variant_id=16)
    units = 3 * WALK_UNITS
    assert work["FFMA"] == units * (6 * 2 + 3 * 1)
    assert work["LDS128"] == units * (6 + 3)
    assert work["instructions"] == 5 * WALK_WARPS + units * (5 + 6 * 6
                                                             + 3 * 3)
    # the K9 bundle at UNITS 28: 56 words, 14 quads: the first, 3 turns and
    # a tail
    k9 = HERMITE_IDS[False]
    assert walk_trips(k9, 28) == (3, 1)
    work = gather_work(counts[(k9, True)], reps=28, steps=3, grid=5,
                       variant_id=k9)
    assert work["FFMA"] == units * (3 * 2 + 1 * 1)
    assert work["LDS128"] == units * (3 + 1)

    f = counts[(10, True)]
    assert f["kernel"] == "gather_floor_kernel" and f["step"] == 16
    assert f["body"] == _gather_counts(6, FFMA=3, integer=2)
    assert f["unit"] == _gather_counts(7, LDS=1, LDG=1, FADD=1, integer=1,
                                       convert=1)
    assert f["tail"] is None
    assert f["outside"] == _gather_counts(1)
    work = gather_work(f, reps=64, steps=3, grid=5)
    units = 3 * FLOOR_UNITS
    assert work["FFMA"] == units * 4 * 3
    assert work["FADD"] == units
    assert work["instructions"] == 5 * FLOOR_WARPS + units * (7 + 4 * 6)
    with pytest.raises(ValueError):
        gather_work(f, reps=64, steps=3)


def test_sass_same_as_keys_the_gather_kernels():
    """K7's and the K8/K9 bundle's kernel, ``gather_walk_kernel``, keeps
    its instantiations' keys, so ``same_as`` holds them against an older
    ``micro_gather.cu``; the K5/K6 floor kernel is not keyed."""
    from ogl_beamforming_tpu_torch.kernels import sass
    assert sass.same_key("_ZN12_GLOBAL__N_118gather_walk_kernelILi16ELb1EEEv"
                         "PKiS1_S1_PKfPfiiiiif") == "gather_walk_kernel Li16ELb1E"
    assert sass.same_key("_ZN12_GLOBAL__N_118gather_walk_kernelILi18ELb0EEEv"
                         "PKiS1_S1_PKfPfiiiiif") == "gather_walk_kernel Li18ELb0E"
    assert sass.same_key("_ZN12_GLOBAL__N_119gather_floor_kernelILi1ELb1EEEv"
                         "PKiS1_S1_PKfPfiii") is None


def test_sass_same_as_keys_the_filter_kernels():
    from ogl_beamforming_tpu_torch.kernels import sass
    assert sass.same_key("_ZN12_GLOBAL__N_117demodulate_kernelIsLb0ELi4ELi16E"
                         "EEvPKT_PK6float2PKfPS3_iiiiifii") == \
        "demodulate sLb0ELi4ELi16E"
    assert sass.same_key("_ZN12_GLOBAL__N_110fir_kernelILb1ELb0ELi8ELi0EEEvPK"
                         "fS2_Pviiiiiii") == "fir Lb1ELb0ELi8ELi0E"
    assert sass.same_key("_ZN12_GLOBAL__N_115das_rca_kernelILi2EEEvv") is None
