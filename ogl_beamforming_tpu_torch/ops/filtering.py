"""FIR filtering, demodulation and the Hilbert transform: the torch
counterpart of ``ogl_beamforming_tpu.ops.filtering``.

:func:`fir_filter_ref` and :func:`demodulate_ref` are the plain-torch twins,
translations of the JAX package's tap-unrolled XLA path: L - 1 zeros on the
left, decimation D, and each tap's product added in tap order; complex data
with complex taps is four real FIRs, ``rr - ii`` and ``ri + ir``.
:func:`fir_filter` and :func:`demodulate` dispatch on the tensor's device: a
CPU tensor takes the twin, a CUDA tensor takes the hand-written kernel
(``csrc/filter.cu``) or raises.  The rotation's cos and sin depend on the
pair index only: :func:`demod_phasor` tabulates them once per plan, and
both the twin and the kernel read that table.  :func:`hilbert` is
``torch.fft`` on either device, as the JAX package's is ``jnp.fft``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build

TWO_PI_F32 = float(np.float32(2.0 * np.pi))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))

def _fir_real(x: torch.Tensor, h: torch.Tensor, d: int) -> torch.Tensor:
    """Real strided FIR ``y[n] = sum_j h[j] * xpad[D n + j]`` with L - 1
    left zeros, output length ``S // D`` (the JAX ``_fir_unrolled``)."""
    length = h.shape[0]
    n_out = x.shape[-1] // d
    xp = F.pad(x.to(torch.float32), (length - 1, d))
    span = (n_out - 1) * d + 1
    acc = None
    for j in range(length):
        term = h[j] * xp[..., j:j + span:d]
        acc = term if acc is None else acc + term
    return acc


def fir_filter_ref(x: torch.Tensor, taps: torch.Tensor,
                   decimation_rate: int = 1) -> torch.Tensor:
    """Plain-torch FIR along the last axis of ``x`` (real or complex) with
    ``taps`` (L,) (real or complex).  Returns float32 when neither is
    complex, else complex64."""
    d = decimation_rate
    h = taps.to(x.device)
    if not x.is_complex() and not h.is_complex():
        return _fir_real(x, h.to(torch.float32), d)
    if not h.is_complex():
        h = h.to(torch.float32)
        return torch.complex(_fir_real(x.real, h, d), _fir_real(x.imag, h, d))
    hr, hi = h.real.to(torch.float32), h.imag.to(torch.float32)
    if not x.is_complex():
        return torch.complex(_fir_real(x, hr, d), _fir_real(x, hi, d))
    rr = _fir_real(x.real, hr, d)
    ii = _fir_real(x.imag, hi, d)
    ri = _fir_real(x.real, hi, d)
    ir = _fir_real(x.imag, hr, d)
    return torch.complex(rr - ii, ri + ir)


def demod_omega(demodulation_frequency, sampling_frequency,
                device) -> torch.Tensor:
    """The rotation's angular step per pair, ``2 pi f_d / (fs / 2)``, as
    the float32 the JAX package computes (0-d tensor on ``device``)."""
    fd = torch.as_tensor(demodulation_frequency, dtype=torch.float32,
                         device=device)
    fs = torch.as_tensor(sampling_frequency, dtype=torch.float32,
                         device=device)
    return (TWO_PI_F32 * fd) / (fs / 2.0)


def demod_phasor(omega: torch.Tensor, s_pairs: int) -> torch.Tensor:
    """The rotation's table: cos and sin of the float32 argument ``omega *
    p`` for each pair p in [0, s_pairs), float32 (s_pairs, 2) on
    ``omega``'s device.  A plan builds it once (``pipeline/plan.py``)."""
    n = torch.arange(s_pairs, dtype=torch.float32, device=omega.device)
    arg = omega * n
    return torch.stack([torch.cos(arg), torch.sin(arg)], dim=-1)


def _demod_scale(complex_filter: bool) -> float:
    return 1.0 if complex_filter else SQRT2_F32


def _phasor_for(rf: torch.Tensor, phasor, demodulation_frequency,
                sampling_frequency) -> torch.Tensor:
    """``phasor`` checked against ``rf``, or built when it is None."""
    s_pairs = rf.shape[-1] // 2
    if phasor is None:
        return demod_phasor(demod_omega(demodulation_frequency,
                                        sampling_frequency, rf.device),
                            s_pairs)
    if (phasor.shape != (s_pairs, 2) or phasor.dtype != torch.float32
            or phasor.device != rf.device or not phasor.is_contiguous()):
        raise ValueError(
            f"phasor must be contiguous float32 ({s_pairs}, 2) on "
            f"{rf.device}, got {phasor.dtype} {tuple(phasor.shape)} on "
            f"{phasor.device}")
    return phasor


def demodulate_ref(rf: torch.Tensor, taps: torch.Tensor,
                   demodulation_frequency, sampling_frequency,
                   decimation_rate: int = 1,
                   complex_filter: bool = False,
                   phasor: torch.Tensor | None = None) -> torch.Tensor:
    """Plain-torch demodulation of real ``rf`` (..., S): ``IQ[n] = RF[2n] -
    j RF[2n+1]`` at pair rate fs/2, rotated by ``exp(-j 2 pi f_d n /
    (fs/2))``, scaled by sqrt(2) unless the filter is complex, then the FIR
    with decimation.  ``phasor``: the rotation's table
    (:func:`demod_phasor`), built here when None.  Returns complex64 (...,
    S // 2 // D)."""
    s_pairs = rf.shape[-1] // 2
    x = rf[..., :2 * s_pairs].to(torch.float32)
    i = x[..., 0::2]
    q = x[..., 1::2]
    c, s = _phasor_for(rf, phasor, demodulation_frequency,
                       sampling_frequency).unbind(-1)
    scale = _demod_scale(complex_filter)
    # (i - j q) * (cos - j sin), scaled
    re = scale * (i * c - q * s)
    im = scale * (-q * c - i * s)
    return fir_filter_ref(torch.complex(re, im), taps, decimation_rate)


def hilbert(rf: torch.Tensor) -> torch.Tensor:
    """Analytic signal along the last axis (FFT method), complex64."""
    x = rf.to(torch.float32)
    n = x.shape[-1]
    h = torch.zeros(n, dtype=torch.float32, device=x.device)
    h[0] = 1
    if n % 2 == 0:
        h[n // 2] = 1
        h[1:n // 2] = 2
    else:
        h[1:(n + 1) // 2] = 2
    xf = torch.fft.fft(x, dim=-1)
    return torch.fft.ifft(xf * h, dim=-1).to(torch.complex64)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/filter.cu)
# ---------------------------------------------------------------------------

def _kernel_taps(taps: torch.Tensor, device) -> torch.Tensor:
    """Taps as the kernels read them: float32 (L,), or (2L,) re | im."""
    if taps.dim() != 1 or taps.shape[0] < 1:
        raise ValueError(f"taps must be (L,) with L >= 1, got "
                         f"{tuple(taps.shape)}")
    if taps.device != device:
        raise ValueError(f"taps on {taps.device}, data on {device}")
    if taps.is_complex():
        return torch.cat([taps.real, taps.imag]).to(torch.float32).contiguous()
    return taps.to(torch.float32).contiguous()


def _check_cuda(x: torch.Tensor, name: str, dtypes) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         f"({', '.join(map(str, dtypes))})")
    if x.dim() < 1 or not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor of rank >= 1")


def demodulate_cuda(rf: torch.Tensor, taps: torch.Tensor,
                    demodulation_frequency, sampling_frequency,
                    decimation_rate: int = 1,
                    complex_filter: bool = False,
                    phasor: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the fused demodulate kernel on ``rf`` (..., S): contiguous CUDA
    int16 or float32; ``taps`` (L,) float32 or complex64 on the same
    device; ``phasor`` the plan's rotation table (:func:`demod_phasor`),
    built here when None.  Same outputs as :func:`demodulate_ref`."""
    _check_cuda(rf, "demodulate_cuda", (torch.int16, torch.float32))
    if decimation_rate < 1:
        raise ValueError(f"decimation rate {decimation_rate} < 1")
    h = _kernel_taps(taps, rf.device)
    table = _phasor_for(rf, phasor, demodulation_frequency,
                        sampling_frequency)
    s_in = rf.shape[-1]
    n_out = s_in // 2 // decimation_rate
    rows = rf.numel() // s_in if s_in else 0
    out = torch.empty(rf.shape[:-1] + (n_out,), dtype=torch.complex64,
                      device=rf.device)
    lib = build.library()
    stream = torch._C._cuda_getCurrentRawStream(rf.device.index)
    code = lib.demodulate(
        rf.data_ptr(), table.data_ptr(), h.data_ptr(), out.data_ptr(), rows,
        s_in, n_out, taps.shape[0], decimation_rate,
        int(rf.dtype == torch.int16), int(taps.is_complex()),
        _demod_scale(complex_filter), stream)
    build.check("demodulate", code)
    build.count_launch("demodulate", "demodulate_kernel")
    return out


def fir_cuda(x: torch.Tensor, taps: torch.Tensor,
             decimation_rate: int = 1) -> torch.Tensor:
    """Launch the FIR kernel on ``x`` (..., S): contiguous CUDA float32 or
    complex64; ``taps`` (L,) float32 or complex64 on the same device.  Same
    outputs as :func:`fir_filter_ref`."""
    _check_cuda(x, "fir_cuda", (torch.float32, torch.complex64))
    if decimation_rate < 1:
        raise ValueError(f"decimation rate {decimation_rate} < 1")
    h = _kernel_taps(taps, x.device)
    s = x.shape[-1]
    n_out = s // decimation_rate
    rows = x.numel() // s if s else 0
    cplx = x.is_complex() or taps.is_complex()
    out = torch.empty(x.shape[:-1] + (n_out,),
                      dtype=torch.complex64 if cplx else torch.float32,
                      device=x.device)
    lib = build.library()
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    code = lib.fir(x.data_ptr(), h.data_ptr(), out.data_ptr(), rows, s, n_out,
                   taps.shape[0], decimation_rate, int(x.is_complex()),
                   int(taps.is_complex()), stream)
    build.check("fir", code)
    build.count_launch("fir", "fir_kernel")
    return out


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"no {name} for device {x.device}")
    return True


def fir_filter(x: torch.Tensor, taps: torch.Tensor,
               decimation_rate: int = 1) -> torch.Tensor:
    """FIR along the last axis: the CUDA kernel for a CUDA tensor (integer
    data is converted to float32 first, as the twin does), the plain twin
    for a CPU tensor."""
    if _on_cpu(x, "FIR"):
        return fir_filter_ref(x, taps, decimation_rate)
    if not x.is_complex():
        x = x.to(torch.float32)
    return fir_cuda(x.contiguous(), taps, decimation_rate)


def demodulate(rf: torch.Tensor, taps: torch.Tensor, demodulation_frequency,
               sampling_frequency, decimation_rate: int = 1,
               complex_filter: bool = False,
               phasor: torch.Tensor | None = None) -> torch.Tensor:
    """Demodulate real ``rf`` (..., S): the CUDA kernel for a CUDA tensor
    (data other than int16 is converted to float32 first, as the twin
    does), the plain twin for a CPU tensor.  ``phasor``: the plan's
    rotation table (:func:`demod_phasor`), built here when None."""
    if _on_cpu(rf, "demodulation"):
        return demodulate_ref(rf, taps, demodulation_frequency,
                              sampling_frequency, decimation_rate,
                              complex_filter, phasor)
    if rf.dtype != torch.int16:
        rf = rf.to(torch.float32)
    return demodulate_cuda(rf.contiguous(), taps, demodulation_frequency,
                           sampling_frequency, decimation_rate,
                           complex_filter, phasor)
