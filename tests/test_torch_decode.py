"""Port decode (ogl_beamforming_tpu_torch.ops.decode, plain twin on the CPU)
vs the JAX package's decode (XLA on the CPU, and the Pallas kernel in
interpret mode) and the golden oracle, on the same numpy-seeded inputs.

int16 decode is exact in every implementation, so those comparisons are
bit equality.  float32/complex input sums in another order than XLA's dot
(max error <= 1e-6 of the peak) and, against Pallas, through its bf16
hi/lo split (about 2e-5 relative, decode.py:117-118).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from helpers import nrmse  # noqa: E402

from ogl_beamforming_tpu.ops import decode as jax_decode  # noqa: E402
from ogl_beamforming_tpu.ops import golden  # noqa: E402
from ogl_beamforming_tpu.utils.hadamard import hadamard, walsh  # noqa: E402
from ogl_beamforming_tpu_torch.kernels import build  # noqa: E402
from ogl_beamforming_tpu_torch.ops import decode  # noqa: E402

torch.set_num_threads(1)

C, S = 8, 256


def _port(rf, h):
    out = decode.decode_hadamard(torch.from_numpy(rf), torch.from_numpy(h))
    return out.numpy()


def _max_rel(test, ref):
    return float(np.abs(test - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("a", [4, 12, 16])
def test_int16_exact(a):
    rng = np.random.default_rng(100 + a)
    rf = rng.integers(-32768, 32767, (C, a, S)).astype(np.int16)
    h = hadamard(a)
    out = _port(rf, h)
    assert out.dtype == np.float32 and out.shape == (C, a, S)
    xla = np.asarray(jax_decode.decode_hadamard(jnp.asarray(rf),
                                                jnp.asarray(h)))
    pallas = np.asarray(jax_decode.decode_hadamard_pallas(
        jnp.asarray(rf), jnp.asarray(h), interpret=True))
    assert np.array_equal(out, xla)
    assert np.array_equal(out, pallas)
    np.testing.assert_allclose(out, golden.decode_hadamard(rf, h),
                               rtol=1e-6, atol=0)


def test_walsh_exact():
    rng = np.random.default_rng(7)
    rf = rng.integers(-32768, 32767, (C, 16, S)).astype(np.int16)
    h = walsh(16)
    xla = np.asarray(jax_decode.decode_hadamard(jnp.asarray(rf),
                                                jnp.asarray(h)))
    assert np.array_equal(_port(rf, h), xla)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_float_and_complex(dtype):
    rng = np.random.default_rng(11)
    rf = rng.standard_normal((C, 16, S)).astype(np.float32) * 100
    if dtype == np.complex64:
        rf = (rf + 1j * rng.standard_normal(rf.shape) * 100).astype(dtype)
    h = hadamard(16)
    out = _port(rf, h)
    assert out.dtype == dtype and out.shape == rf.shape
    xla = np.asarray(jax_decode.decode_hadamard(jnp.asarray(rf),
                                                jnp.asarray(h)))
    pallas = np.asarray(jax_decode.decode_hadamard_pallas(
        jnp.asarray(rf), jnp.asarray(h), interpret=True))
    assert _max_rel(out, xla) <= 1e-6
    assert nrmse(pallas, out) <= 3e-5
    assert _max_rel(out, golden.decode_hadamard(rf, h)) <= 1e-6


def test_cuda_wrapper_rejects_cpu_tensor():
    """The kernel wrapper never runs the plain twin: a CPU tensor raises."""
    rf = torch.zeros((2, 4, 8), dtype=torch.int16)
    with pytest.raises(ValueError, match="CUDA"):
        decode.decode_hadamard_cuda(rf, decode.hadamard_matrix(4, "cpu"))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build()
