// Demodulation and FIR filtering for Hopper (sm_90a).
//
// demodulate replaces the TPU kernel
// ogl_beamforming_tpu/ops/demod_pallas.py::_call (body _kernel, wrapper
// demodulate_pallas): implicit-IQ pairing of consecutive RF samples,
// IQ[p] = RF[2p] - j RF[2p+1], rotation by exp(-j omega p) with
// omega = 2 pi f_d / (fs / 2), a sqrt(2) scale unless the filter is complex,
// then the FIR with decimation D:
//     out[n] = sum_j h[j] * IQ'[D n - (L - 1) + j]      (zero below p = 0)
// fir replaces ogl_beamforming_tpu/ops/demod_pallas.py::_fir_call (body
// _fir_kernel, wrapper fir_pallas): the same FIR on float32 or complex64
// rows, real or complex taps.  Unlike the TPU kernels, both cover every
// input type, real and complex taps and any D >= 1: on the card there is no
// XLA path to fall back to.
//
// What bounds them on this card: device memory.  At the demodulate chain's
// shape (16,384 rows of 4096 int16 samples -> 2048 complex64) demodulate
// reads 128 MiB and writes 256 MiB, about 0.12 ms at 3.35 TB/s, against
// about 2 GFLOP of taps (0.03 ms at the CUDA cores' 67 TFLOP/s) and one
// sincos per pair; fir on complex64 (16,384 x 2048) moves 512 MiB, about
// 0.16 ms.
//
// What the design does about it: one block per (row, tile of kTile
// outputs), one thread per output sample.  The block stages its input
// window -- D * (kTile - 1) + L samples, the L - 1 halo included -- in shared
// memory once (demodulate stages the rotated IQ pairs, so each pair costs one
// sincos however many taps read it), and the taps beside it; each thread
// then runs the tap loop over shared memory.  Loads and stores of
// neighbouring threads are neighbouring words.
//
// Numerics follow the plain twin (ops/filtering.py, itself the JAX package's
// tap-unrolled XLA path) operation for operation: omega is the float32 value
// the twin computes, the phase is __fmul_rn(omega, p) with p counted from the
// first pair, cosf/sinf are the full-range library functions (no
// --use_fast_math), and every product and sum of the rotation and of the tap
// loop is explicitly rounded (__fmul_rn/__fadd_rn, never contracted into an
// FMA), taps summed in tap order.  Complex data with complex taps is four
// real sums, rr - ii and ri + ir, as the twin takes them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;      // outputs per block = threads per block

// The tap loop of one output: `wr`/`wi` point at the window sample that
// tap 0 reads (wi unused for real data), `hr`/`hi` at the taps.
template <bool CX_X, bool CX_H>
__device__ __forceinline__ float2 fir_point(const float* wr, const float* wi,
                                            const float* hr, const float* hi,
                                            int L) {
  float rr = 0.f, ii = 0.f, ri = 0.f, ir = 0.f;
  for (int j = 0; j < L; ++j) {
    rr = __fadd_rn(rr, __fmul_rn(hr[j], wr[j]));
    if (CX_X) ir = __fadd_rn(ir, __fmul_rn(hr[j], wi[j]));
    if (CX_H) ri = __fadd_rn(ri, __fmul_rn(hi[j], wr[j]));
    if (CX_X && CX_H) ii = __fadd_rn(ii, __fmul_rn(hi[j], wi[j]));
  }
  if (CX_X && CX_H) return make_float2(__fsub_rn(rr, ii), __fadd_rn(ri, ir));
  if (CX_X) return make_float2(rr, ir);
  if (CX_H) return make_float2(rr, ri);
  return make_float2(rr, 0.f);
}

// Shared memory of one block: taps (re | im), then the window (re | im).
__device__ __forceinline__ void stage_taps(const float* taps, bool cx_h, int L,
                                           float* hr, float* hi) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    hr[j] = taps[j];
    hi[j] = cx_h ? taps[L + j] : 0.f;
  }
}

size_t window_len(int L, int D) { return (size_t)D * (kTile - 1) + L; }

size_t smem_bytes(int L, int D) { return (2 * (size_t)L + 2 * window_len(L, D)) * sizeof(float); }

template <typename T, bool CX_H>
__global__ void __launch_bounds__(kTile)
demodulate_kernel(const T* __restrict__ x, const float* __restrict__ omega_p,
                  const float* __restrict__ taps, float2* __restrict__ out,
                  int S_in, int n_out, int L, int D, int tiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int W = D * (kTile - 1) + L;
  float* hr = smem;
  float* hi = hr + L;
  float* wr = hi + L;
  float* wi = wr + W;
  const int row = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kTile;
  const int s_pairs = S_in / 2;
  const int p0 = D * n0 - (L - 1);
  const T* src = x + (size_t)row * S_in;
  const float omega = *omega_p;

  stage_taps(taps, CX_H, L, hr, hi);
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    const int p = p0 + k;
    float re = 0.f, im = 0.f;
    if (p >= 0 && p < s_pairs) {
      const float i = static_cast<float>(src[2 * p]);
      const float q = static_cast<float>(src[2 * p + 1]);
      const float arg = __fmul_rn(omega, static_cast<float>(p));
      const float c = cosf(arg), s = sinf(arg);
      // (i - j q) * (cos - j sin), scaled (ops/filtering.py::demodulate_ref)
      re = __fmul_rn(scale, __fsub_rn(__fmul_rn(i, c), __fmul_rn(q, s)));
      im = __fmul_rn(scale, __fsub_rn(__fmul_rn(-q, c), __fmul_rn(i, s)));
    }
    wr[k] = re;
    wi[k] = im;
  }
  __syncthreads();

  const int n = n0 + threadIdx.x;
  if (n >= n_out) return;
  const int k = D * threadIdx.x;
  out[(size_t)row * n_out + n] = fir_point<true, CX_H>(wr + k, wi + k, hr, hi, L);
}

template <bool CX_X, bool CX_H>
__global__ void __launch_bounds__(kTile)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps,
           void* __restrict__ out, int S, int n_out, int L, int D, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int W = D * (kTile - 1) + L;
  float* hr = smem;
  float* hi = hr + L;
  float* wr = hi + L;
  float* wi = wr + W;
  const int row = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * kTile;
  const int s0 = D * n0 - (L - 1);

  stage_taps(taps, CX_H, L, hr, hi);
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    const int s = s0 + k;
    float re = 0.f, im = 0.f;
    if (s >= 0 && s < S) {
      if (CX_X) {
        const float2 v = reinterpret_cast<const float2*>(x)[(size_t)row * S + s];
        re = v.x;
        im = v.y;
      } else {
        re = x[(size_t)row * S + s];
      }
    }
    wr[k] = re;
    wi[k] = im;
  }
  __syncthreads();

  const int n = n0 + threadIdx.x;
  if (n >= n_out) return;
  const int k = D * threadIdx.x;
  const float2 y = fir_point<CX_X, CX_H>(wr + k, wi + k, hr, hi, L);
  if (CX_X || CX_H)
    static_cast<float2*>(out)[(size_t)row * n_out + n] = y;
  else
    static_cast<float*>(out)[(size_t)row * n_out + n] = y.x;
}

template <typename Kernel>
int prepare_launch(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, bool CX_H>
int launch_demodulate(const void* x, const void* omega, const void* taps, void* out,
                      int rows, int S_in, int n_out, int L, int D, float scale,
                      cudaStream_t stream) {
  auto kernel = demodulate_kernel<T, CX_H>;
  const size_t smem = smem_bytes(L, D);
  if (int err = prepare_launch(kernel, smem)) return err;
  const int tiles = (n_out + kTile - 1) / kTile;
  kernel<<<(unsigned)rows * tiles, kTile, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(omega),
      static_cast<const float*>(taps), static_cast<float2*>(out), S_in, n_out, L, D,
      tiles, scale);
  return (int)cudaGetLastError();
}

template <bool CX_X, bool CX_H>
int launch_fir(const void* x, const void* taps, void* out, int rows, int S, int n_out,
               int L, int D, cudaStream_t stream) {
  auto kernel = fir_kernel<CX_X, CX_H>;
  const size_t smem = smem_bytes(L, D);
  if (int err = prepare_launch(kernel, smem)) return err;
  const int tiles = (n_out + kTile - 1) / kTile;
  kernel<<<(unsigned)rows * tiles, kTile, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps), out, S, n_out, L,
      D, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x (rows, S_in) int16 or float32; omega: one float32 on the device; taps
// (L,) float32, or (2L,) re | im when complex; out (rows, S_in / 2 / D)
// complex64.
extern "C" int demodulate(const void* x, const void* omega, const void* taps,
                          void* out, int rows, int S_in, int n_out, int L, int D,
                          int int16_input, int complex_taps, float scale,
                          void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (int16_input)
    return complex_taps
        ? launch_demodulate<int16_t, true>(x, omega, taps, out, rows, S_in, n_out, L, D, scale, s)
        : launch_demodulate<int16_t, false>(x, omega, taps, out, rows, S_in, n_out, L, D, scale, s);
  return complex_taps
      ? launch_demodulate<float, true>(x, omega, taps, out, rows, S_in, n_out, L, D, scale, s)
      : launch_demodulate<float, false>(x, omega, taps, out, rows, S_in, n_out, L, D, scale, s);
}

// x (rows, S) float32 or complex64; taps as above; out (rows, S / D)
// float32 when neither is complex, else complex64.
extern "C" int fir(const void* x, const void* taps, void* out, int rows, int S,
                   int n_out, int L, int D, int complex_input, int complex_taps,
                   void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (complex_input)
    return complex_taps ? launch_fir<true, true>(x, taps, out, rows, S, n_out, L, D, s)
                        : launch_fir<true, false>(x, taps, out, rows, S, n_out, L, D, s);
  return complex_taps ? launch_fir<false, true>(x, taps, out, rows, S, n_out, L, D, s)
                      : launch_fir<false, false>(x, taps, out, rows, S, n_out, L, D, s);
}
