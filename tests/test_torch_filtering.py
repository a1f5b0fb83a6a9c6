"""Port filtering (ogl_beamforming_tpu_torch.ops.filtering, plain twins on the
CPU) vs the JAX package's ``ops.filtering`` (its tap-unrolled XLA path), its
Pallas kernels in interpret mode and the golden oracle, on the same
numpy-seeded inputs.

Tolerances (NRMSE):
  * vs JAX XLA and vs Pallas interpret: 1e-5.  The twin takes the XLA
    path's products and sums in the same order; what remains is libm (the
    rotation's cos/sin at phases up to ~300 rad here) and, against Pallas,
    its interleaved complex tap sums.
  * vs golden: 1e-3, the repo's contract (golden computes in float64 where
    numpy promotes).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import filtering as jax_filtering  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.ops.demod_pallas import (  # noqa: E402
    demodulate_pallas, fir_pallas)
from ogl_beamforming_tpu_torch.ops import filtering  # noqa: E402

torch.set_num_threads(1)

C, A, S, L = 4, 2, 256, 16
FD, FS = 5e6, 20e6


def _taps(cplx: bool) -> np.ndarray:
    rng = np.random.default_rng(17 + cplx)
    h = rng.standard_normal(L).astype(np.float32)
    if cplx:
        h = (h + 1j * rng.standard_normal(L)).astype(np.complex64)
    return h


def _data(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"int16": 1, "f32": 2, "c64": 3}[kind])
    if kind == "int16":
        return rng.integers(-2048, 2048, (C, A, S)).astype(np.int16)
    x = rng.standard_normal((C, A, S)).astype(np.float32)
    if kind == "c64":
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    return x


@functools.lru_cache(maxsize=None)
def _jax_demodulate(kind, cplx_taps, d):
    return np.asarray(jax_filtering.demodulate(
        jnp.asarray(_data(kind)), jnp.asarray(_taps(cplx_taps)), FD, FS,
        decimation_rate=d, complex_filter=cplx_taps))


def _port_demodulate(kind, cplx_taps, d):
    return filtering.demodulate(
        torch.from_numpy(_data(kind)), torch.from_numpy(_taps(cplx_taps)),
        FD, FS, d, cplx_taps).numpy()


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("kind", ["int16", "f32"])
def test_demodulate_matches_jax_and_golden(kind, cplx_taps, d):
    out = _port_demodulate(kind, cplx_taps, d)
    assert out.dtype == np.complex64 and out.shape == (C, A, S // 2 // d)
    ref = golden.demodulate(_data(kind), _taps(cplx_taps), FD, FS, d,
                            complex_filter=cplx_taps)
    assert nrmse(_jax_demodulate(kind, cplx_taps, d), out) <= 1e-5
    assert nrmse(ref, out) <= 1e-3


@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("cplx_taps", [False, True])
@pytest.mark.parametrize("kind", ["f32", "c64"])
def test_fir_matches_jax_and_golden(kind, cplx_taps, d):
    x, h = _data(kind), _taps(cplx_taps)
    out = filtering.fir_filter(torch.from_numpy(x), torch.from_numpy(h),
                               d).numpy()
    cplx = kind == "c64" or cplx_taps
    assert out.dtype == (np.complex64 if cplx else np.float32)
    assert out.shape == (C, A, S // d)
    xla = np.asarray(jax_filtering.fir_filter(jnp.asarray(x), jnp.asarray(h),
                                              d))
    assert nrmse(xla, out) <= 1e-5
    assert nrmse(golden.fir_filter(x, h, d), out) <= 1e-3


@pytest.mark.parametrize("n", [S, S - 1])
def test_hilbert_matches_jax_and_golden(n):
    x = _data("f32")[..., :n]
    out = filtering.hilbert(torch.from_numpy(x)).numpy()
    assert out.dtype == np.complex64 and out.shape == x.shape
    xla = np.asarray(jax_filtering.hilbert(jnp.asarray(x)))
    assert nrmse(xla, out) <= 1e-5
    assert nrmse(golden.hilbert(x), out) <= 1e-3


def test_demodulate_matches_pallas_interpret():
    """The TPU kernel's own configuration: int16, real taps, D = 1."""
    ref = np.asarray(demodulate_pallas(
        jnp.asarray(_data("int16")), jnp.asarray(_taps(False)), FD, FS,
        interpret=True))
    assert nrmse(ref, _port_demodulate("int16", False, 1)) <= 1e-5


def test_fir_matches_pallas_interpret():
    """Complex data with complex taps, the kernel's widest case."""
    x, h = _data("c64"), _taps(True)
    ref = np.asarray(fir_pallas(jnp.asarray(x), jnp.asarray(h),
                                interpret=True))
    out = filtering.fir_filter(torch.from_numpy(x), torch.from_numpy(h))
    assert nrmse(ref, out.numpy()) <= 1e-5


def test_fir_delay_is_the_left_zeros():
    """A one-tap-at-k filter delays the signal by k - (L - 1) samples."""
    x = torch.arange(1, 33, dtype=torch.float32)
    h = torch.zeros(4)
    h[3] = 1.0
    assert torch.equal(filtering.fir_filter(x, h), x)
    h = torch.zeros(4)
    h[1] = 1.0
    assert torch.equal(filtering.fir_filter(x, h)[2:], x[:-2])
    assert not filtering.fir_filter(x, h)[:2].any()


@pytest.mark.parametrize("wrapper", ["demodulate_cuda", "fir_cuda"])
def test_cuda_wrappers_reject_cpu_tensors(wrapper):
    """The kernel wrappers never run the plain twin: a CPU tensor raises."""
    x = torch.zeros((2, 8), dtype=torch.float32)
    h = torch.ones(3)
    fn = getattr(filtering, wrapper)
    args = (x, h, FD, FS) if wrapper == "demodulate_cuda" else (x, h)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
