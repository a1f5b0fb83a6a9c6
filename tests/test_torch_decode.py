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


def _k_column(l):
    """csrc/decode.cu ``k_column``: the H column at logical K position
    ``l`` of a 32-deep MMA step (the order ldmatrix.trans delivers rows)."""
    half, q = divmod(l, 16)
    t, i = divmod(q, 4)
    return half * 16 + 8 * (i // 2) + 2 * t + i % 2


@pytest.mark.parametrize("a", [12, 20, 64, 128, 256])
def test_int8_split_identity(a):
    """The int16 kernel's integer arithmetic, in int64: with x = 256 hi +
    lo + 128 (hi = x >> 8, lo = (x & 255) - 128, both int8), H zero-padded
    to a multiple of 32 and its columns in the kernel's K order, the padded
    rf rows holding anything, 256 (H @ hi) + H @ lo + 128 rowsum(H) scaled
    by the f32 1/T equals the twin's output exactly over the int16 range."""
    rng = np.random.default_rng(a)
    s = 67
    rf = rng.integers(-32768, 32768, (2, a, s)).astype(np.int16)
    rf[:, :, 0], rf[:, :, 1] = -32768, 32767
    h = hadamard(a).astype(np.int64)
    kpad = -(-a // 32) * 32
    order = [32 * (l // 32) + _k_column(l % 32) for l in range(kpad)]
    assert sorted(order) == list(range(kpad))
    staged = np.zeros((kpad, kpad), np.int64)
    staged[:a, :a] = h
    staged = staged[:, order]                 # logical column l = H[:, order[l]]
    x = rng.integers(-32768, 32768, (2, kpad, s)).astype(np.int64)
    x[:, :a] = rf                             # rows a.. are left as garbage
    hi, lo = x >> 8, (x & 255) - 128
    assert hi.min() >= -128 and hi.max() <= 127
    assert lo.min() >= -128 and lo.max() <= 127
    rowsum = np.zeros(kpad, np.int64)
    rowsum[:a] = h.sum(axis=1)
    acc = (256 * (staged @ hi[:, order]) + staged @ lo[:, order]
           + 128 * rowsum[:, None])[:, :a]
    assert np.abs(acc).max() < 2 ** 24         # exact in float32
    out = acc.astype(np.float32) * decode._inv_order(a)
    assert np.array_equal(out, _port(rf, hadamard(a)))


def _bf16(x):
    """float32 rounded to bfloat16 (nearest, ties to even), as float32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def test_bf16_three_term_split_is_exact():
    """The float32 kernel's split x = hi + mid + lo, each term bf16: exact
    for magnitudes from 1e-30 up to 3e38 (below bf16's largest finite value,
    where hi would round to infinity), so every product with H = +-1 is
    exact and only the sums round."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(200_000)
         * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    x[:4] = [0.0, -0.0, 3e38, np.finfo(np.float32).tiny]
    hi = _bf16(x)
    r1 = x - hi
    mid = _bf16(r1)
    r2 = r1 - mid
    lo = _bf16(r2)
    assert np.array_equal(lo, r2)
    total = hi.astype(np.float64) + mid.astype(np.float64) + lo
    assert np.array_equal(total, x.astype(np.float64))


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
