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
// reads 128 MiB and writes 256 MiB, about 0.12 ms at 3.35 TB/s; its 1.1 G
// tap products and 1.1 G sums take about 0.07 ms on the CUDA cores, and
// with the staging its instructions take about as long as its bytes.  fir
// on complex64 (16,384 x 2048) moves 512 MiB, about 0.16 ms.
//
// What the design does about it:
//   * The rotation is a table.  cos and sin of omega * p depend on the pair
//     p only, so the plan computes them once (ops/filtering.py::
//     demod_phasor, float2 per pair, L1- and L2-resident) and the kernel
//     does no transcendental per (row, pair).
//   * One block per (row, tile of kThreads * V outputs).  The block stages
//     its input window -- D * (tile - 1) + L samples, the L - 1 halo
//     included -- in shared memory once (demodulate stages the rotated IQ
//     pairs), reading the row in 16-byte chunks: 8 int16 samples, 4 floats
//     or 2 complex.  Chunks that a row's start, its end or an odd sample
//     offset (odd S_in) cut are read element by element in the same loop.
//   * Register-blocked taps: each thread computes V outputs and reads each
//     tap once per V outputs (a broadcast).  For the 16-tap filter at D = 1
//     (path B's Kaiser) they are V consecutive outputs: the thread loads its
//     V + 15 window samples from shared memory once, as 16- or 8-byte words,
//     into registers, and its outputs leave as 16-byte streaming stores (two
//     complex or four real), element by element where a row's end or
//     alignment cuts one.  Every other (L, D) takes the runtime-L loop over
//     shared memory, with a thread's V outputs kThreads apart so that a warp
//     reads consecutive words at each tap (no bank conflicts) and stores
//     consecutive outputs.
//   V is fixed for each path, by measurement on the H100 (4, 6 and 8
//   timed): 4 for the register window, whose 32 registers keep 16 blocks
//   on an SM (8 needs 50 and keeps 10), and 8 for the runtime-L loop, whose
//   window of D * 1023 + L samples fits the card's 227 KB of shared memory
//   up to D = 28 (a larger D fails the launch, and the wrapper raises).  A
//   ring of two cp.async buffers that brought a block's next tile in while
//   it filtered the current one (8 tiles a block) measured no faster, so a
//   block stages one tile.
//
// Numerics follow the plain twin (ops/filtering.py, itself the JAX package's
// tap-unrolled XLA path) operation for operation: the phasor is the twin's
// own cos and sin of the float32 argument omega * p, p counted from the
// first pair, and every product and sum of the rotation and of the tap loop
// is explicitly rounded (__fmul_rn/__fadd_rn, never contracted into an
// FMA), taps summed in tap order.  Complex data with complex taps is four
// real sums, rr - ii and ri + ir, as the twin takes them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kFixedTaps = 16;  // the tap count unrolled into registers (D = 1)
constexpr int kWindowOutputs = 4;  // V, outputs a thread, of the register window
constexpr int kLoopOutputs = 8;    // V of the runtime-L loop

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Window length of a tile of `tile` outputs, and its shared-memory stride:
// the register window of the last thread reads up to 3 past its end.
__host__ __device__ int window_len(int tile, int L, int D) { return D * (tile - 1) + L; }
__host__ __device__ int window_stride(int tile, int L, int D) {
  return round4(window_len(tile, L, D) + 3);
}

size_t smem_bytes(int tile, int L, int D) {
  return (2 * (size_t)round4(L) + 2 * (size_t)window_stride(tile, L, D)) * sizeof(float);
}

__device__ __forceinline__ int mod(int a, int m) { return ((a % m) + m) % m; }

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Shared memory of one block: taps (re | im), each padded to a multiple of
// four floats, then the window (re | im).
struct Smem {
  float *hr, *hi, *wr, *wi;
  __device__ Smem(float* smem, int L, int ws) {
    hr = smem;
    hi = hr + round4(L);
    wr = hi + round4(L);
    wi = wr + ws;
  }
};

__device__ __forceinline__ void stage_taps(const float* __restrict__ taps, bool cx_h, int L,
                                           const Smem& s) {
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    s.hr[j] = taps[j];
    s.hi[j] = cx_h ? taps[L + j] : 0.f;
  }
}

// N consecutive floats of shared memory into registers, in the widest
// words that `ALIGN` (the start's alignment in floats: 4, 2 or 1) allows.
template <int N, int ALIGN>
__device__ __forceinline__ void load_window(const float* w, float (&x)[N]) {
  if constexpr (ALIGN % 4 == 0 && N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + k);
      x[k] = v.x; x[k + 1] = v.y; x[k + 2] = v.z; x[k + 3] = v.w;
    }
  } else if constexpr (ALIGN % 2 == 0 && N % 2 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 2) {
      const float2 v = *reinterpret_cast<const float2*>(w + k);
      x[k] = v.x; x[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = w[k];
  }
}

// The outputs of one thread in a tile: LT > 0 (the tap count LT at D = 1),
// V consecutive ones, whose window sits in the thread's registers; LT = 0
// (L and D at run time), V outputs kThreads apart, so that at each tap a
// warp reads consecutive words of shared memory (consecutive outputs would
// put a warp's reads V D words apart, 4- to 8-way bank conflicts).
template <int V, int LT>
struct Outputs {
  static constexpr int kStep = LT > 0 ? 1 : kThreads;
  __device__ static int first(int t) { return LT > 0 ? t * V : t; }
};

// The tap loop of one thread's V outputs (Outputs<V, LT>): `wr`/`wi` point
// at the window sample that tap 0 of its first output reads (wi unused for
// real data), `hr`/`hi` at the taps.
template <bool CX_X, bool CX_H, int V, int LT>
__device__ __forceinline__ void fir_outputs(const float* wr, const float* wi, const float* hr,
                                            const float* hi, int L, int D, float (&yr)[V],
                                            float (&yi)[V]) {
  float rr[V], ii[V], ri[V], ir[V];
#pragma unroll
  for (int v = 0; v < V; ++v) rr[v] = ii[v] = ri[v] = ir[v] = 0.f;
  if constexpr (LT > 0) {
    constexpr int NW = round4(V + LT - 1);
    constexpr int ALIGN = V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
    float xr[NW], xi[NW];
    load_window<NW, ALIGN>(wr, xr);
    if (CX_X) load_window<NW, ALIGN>(wi, xi);
#pragma unroll
    for (int j = 0; j < LT; ++j) {
      const float h_r = hr[j];
      const float h_i = CX_H ? hi[j] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        rr[v] = __fadd_rn(rr[v], __fmul_rn(h_r, xr[v + j]));
        if (CX_X) ir[v] = __fadd_rn(ir[v], __fmul_rn(h_r, xi[v + j]));
        if (CX_H) ri[v] = __fadd_rn(ri[v], __fmul_rn(h_i, xr[v + j]));
        if (CX_X && CX_H) ii[v] = __fadd_rn(ii[v], __fmul_rn(h_i, xi[v + j]));
      }
    }
  } else {
    const int step = Outputs<V, LT>::kStep * D;
    for (int j = 0; j < L; ++j) {
      const float h_r = hr[j];
      const float h_i = CX_H ? hi[j] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float a = wr[v * step + j];
        rr[v] = __fadd_rn(rr[v], __fmul_rn(h_r, a));
        if (CX_X) ir[v] = __fadd_rn(ir[v], __fmul_rn(h_r, wi[v * step + j]));
        if (CX_H) ri[v] = __fadd_rn(ri[v], __fmul_rn(h_i, a));
        if (CX_X && CX_H) ii[v] = __fadd_rn(ii[v], __fmul_rn(h_i, wi[v * step + j]));
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    yr[v] = CX_X && CX_H ? __fsub_rn(rr[v], ii[v]) : rr[v];
    yi[v] = CX_X && CX_H ? __fadd_rn(ri[v], ir[v]) : CX_X ? ir[v] : CX_H ? ri[v] : 0.f;
  }
}

// The V outputs of one thread (Outputs<V, LT>), from `dst` on; `valid`
// outputs of the row lie from `dst` on.  Consecutive outputs leave as
// 16-byte streaming stores where aligned (two complex, four real), else
// element by element; outputs kThreads apart, one by one (a warp's stores
// are consecutive words).
template <int V, int LT>
__device__ __forceinline__ void store_complex(float2* dst, int valid, const float (&yr)[V],
                                              const float (&yi)[V]) {
  constexpr int step = Outputs<V, LT>::kStep;
#pragma unroll
  for (int v = 0; v < V; v += step > 1 ? 1 : 2) {
    if (step == 1 && v + 1 < V && v + 1 < valid && aligned16(dst + v)) {
      __stcs(reinterpret_cast<float4*>(dst + v), make_float4(yr[v], yi[v], yr[v + 1], yi[v + 1]));
    } else {
      if (v * step < valid) dst[v * step] = make_float2(yr[v], yi[v]);
      if (step == 1 && v + 1 < V && v + 1 < valid) dst[v + 1] = make_float2(yr[v + 1], yi[v + 1]);
    }
  }
}

template <int V, int LT>
__device__ __forceinline__ void store_real(float* dst, int valid, const float (&yr)[V]) {
  constexpr int step = Outputs<V, LT>::kStep;
#pragma unroll
  for (int v = 0; v < V; v += step > 1 ? 1 : 4) {
    if (step == 1 && v + 3 < V && v + 3 < valid && aligned16(dst + v)) {
      __stcs(reinterpret_cast<float4*>(dst + v), make_float4(yr[v], yr[v + 1], yr[v + 2], yr[v + 3]));
    } else {
#pragma unroll
      for (int k = v; k < v + (step > 1 ? 1 : 4) && k < V; ++k)
        if (k * step < valid) dst[k * step] = yr[k];
    }
  }
}

// 16 bytes of a row as floats: 8 int16 samples or 4 floats.
__device__ __forceinline__ void load16(const int16_t* p, float (&x)[8]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = static_cast<float>(static_cast<int16_t>(w[k] & 0xFFFF));
    x[2 * k + 1] = static_cast<float>(static_cast<int16_t>(w[k] >> 16));
  }
}

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

template <typename T, bool CX_H, int V, int LT>
__global__ void __launch_bounds__(kThreads)
demodulate_kernel(const T* __restrict__ x, const float2* __restrict__ phasor,
                  const float* __restrict__ taps, float2* __restrict__ out, int S_in,
                  int n_out, int L, int D, int tiles, float scale) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TILE = kThreads * V;
  const int W = window_len(TILE, L, D);
  const Smem sm(smem, L, window_stride(TILE, L, D));
  const int row = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * TILE;
  const int s_pairs = S_in / 2;
  const int pw0 = D * n0 - (L - 1);  // the window's first pair
  const T* src = x + (size_t)row * S_in;

  stage_taps(taps, CX_H, L, sm);

  // Stage the rotated pairs [pw0, pw0 + W) in chunks of PC pairs, each one
  // 16-byte word of the row where the row's sample offset is even (pairs
  // then start at 4-byte boundaries), else sample by sample.
  constexpr int E = 16 / sizeof(T);  // samples per 16-byte word
  constexpr int PC = E / 2;          // pairs per chunk
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(T)) % E);
  const bool vec = (mis & 1) == 0;
  // pairs p with (mis + 2 p) % E == 0 start a 16-byte word
  const int pa = vec ? pw0 - mod(pw0 - (E - mis) % E / 2, PC) : pw0;
  for (int p = pa + threadIdx.x * PC; p < pw0 + W; p += kThreads * PC) {
    float s[E];
    if (vec && p >= 0 && p + PC <= s_pairs) {
      load16(src + 2 * p, s);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int q = p + e / 2;
        s[e] = q >= 0 && q < s_pairs ? static_cast<float>(src[2 * p + e]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < PC; ++k) {
      const int q = p + k;
      const int idx = q - pw0;
      if (idx < 0 || idx >= W) continue;
      float re = 0.f, im = 0.f;
      if (q >= 0 && q < s_pairs) {
        const float2 cs = __ldg(phasor + q);
        const float i = s[2 * k], qv = s[2 * k + 1];
        // (i - j q) * (cos - j sin), scaled (ops/filtering.py::demodulate_ref)
        re = __fmul_rn(scale, __fsub_rn(__fmul_rn(i, cs.x), __fmul_rn(qv, cs.y)));
        im = __fmul_rn(scale, __fsub_rn(__fmul_rn(-qv, cs.x), __fmul_rn(i, cs.y)));
      }
      sm.wr[idx] = re;
      sm.wi[idx] = im;
    }
  }
  __syncthreads();

  const int n = n0 + Outputs<V, LT>::first(threadIdx.x);
  if (n >= n_out) return;
  const int k = D * (n - n0);
  float yr[V], yi[V];
  fir_outputs<true, CX_H, V, LT>(sm.wr + k, sm.wi + k, sm.hr, sm.hi, L, D, yr, yi);
  store_complex<V, LT>(out + (size_t)row * n_out + n, n_out - n, yr, yi);
}

template <bool CX_X, bool CX_H, int V, int LT>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const float* __restrict__ x, const float* __restrict__ taps, void* __restrict__ out,
           int S, int n_out, int L, int D, int tiles) {
  extern __shared__ __align__(16) float smem[];
  constexpr int TILE = kThreads * V;
  const int W = window_len(TILE, L, D);
  const Smem sm(smem, L, window_stride(TILE, L, D));
  const int row = blockIdx.x / tiles;
  const int n0 = (blockIdx.x % tiles) * TILE;
  const int sw0 = D * n0 - (L - 1);  // the window's first sample

  stage_taps(taps, CX_H, L, sm);

  // Stage samples [sw0, sw0 + W) in chunks of one 16-byte word of the row
  // (4 floats or 2 complex), element by element where the row cuts one.
  constexpr int F = CX_X ? 2 : 1;  // floats per element
  constexpr int E = 4 / F;         // elements per 16-byte word
  const float* src = x + (size_t)row * S * F;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(src) / (4 * F)) % E);
  const int sa = sw0 - mod(sw0 - (E - mis) % E, E);
  for (int s = sa + threadIdx.x * E; s < sw0 + W; s += kThreads * E) {
    float v[4];
    if (s >= 0 && s + E <= S) {
      load16(src + s * F, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = s + e / F;
        v[e] = q >= 0 && q < S ? src[s * F + e] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int idx = s + k - sw0;
      if (idx < 0 || idx >= W) continue;
      sm.wr[idx] = v[k * F];
      if (CX_X) sm.wi[idx] = v[k * F + 1];
    }
  }
  __syncthreads();

  const int n = n0 + Outputs<V, LT>::first(threadIdx.x);
  if (n >= n_out) return;
  const int k = D * (n - n0);
  float yr[V], yi[V];
  fir_outputs<CX_X, CX_H, V, LT>(sm.wr + k, sm.wi + k, sm.hr, sm.hi, L, D, yr, yi);
  if (CX_X || CX_H)
    store_complex<V, LT>(static_cast<float2*>(out) + (size_t)row * n_out + n, n_out - n, yr,
                         yi);
  else
    store_real<V, LT>(static_cast<float*>(out) + (size_t)row * n_out + n, n_out - n, yr);
}

template <typename Kernel>
int prepare_launch(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // reported here, not by the next launch
  return (int)err;
}

template <typename T, bool CX_H, int V, int LT>
int launch_demodulate(const void* x, const void* phasor, const void* taps, void* out, int rows,
                      int S_in, int n_out, int L, int D, float scale, cudaStream_t stream) {
  auto kernel = demodulate_kernel<T, CX_H, V, LT>;
  constexpr int tile = kThreads * V;
  const size_t smem = smem_bytes(tile, L, D);
  if (int err = prepare_launch(kernel, smem)) return err;
  const int tiles = (n_out + tile - 1) / tile;
  kernel<<<(unsigned)rows * tiles, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float2*>(phasor),
      static_cast<const float*>(taps), static_cast<float2*>(out), S_in, n_out, L, D, tiles,
      scale);
  return (int)cudaGetLastError();
}

template <bool CX_X, bool CX_H, int V, int LT>
int launch_fir(const void* x, const void* taps, void* out, int rows, int S, int n_out, int L,
               int D, cudaStream_t stream) {
  auto kernel = fir_kernel<CX_X, CX_H, V, LT>;
  constexpr int tile = kThreads * V;
  const size_t smem = smem_bytes(tile, L, D);
  if (int err = prepare_launch(kernel, smem)) return err;
  const int tiles = (n_out + tile - 1) / tile;
  kernel<<<(unsigned)rows * tiles, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(taps), out, S, n_out, L, D,
      tiles);
  return (int)cudaGetLastError();
}

// The instantiation of (L, D): the 16-tap register window at D = 1, else
// the runtime-L loop.
template <template <int, int> class Launch, typename... Args>
int dispatch(int L, int D, Args... args) {
  return L == kFixedTaps && D == 1 ? Launch<kWindowOutputs, kFixedTaps>::run(args...)
                                   : Launch<kLoopOutputs, 0>::run(args...);
}

template <typename T, bool CX_H>
struct Demod {
  template <int V, int LT>
  struct At {
    template <typename... Args>
    static int run(Args... args) { return launch_demodulate<T, CX_H, V, LT>(args...); }
  };
};

template <bool CX_X, bool CX_H>
struct Fir {
  template <int V, int LT>
  struct At {
    template <typename... Args>
    static int run(Args... args) { return launch_fir<CX_X, CX_H, V, LT>(args...); }
  };
};

}  // namespace

// x (rows, S_in) int16 or float32; phasor (S_in / 2, 2) float32, cos and sin
// of omega * p (ops/filtering.py::demod_phasor); taps (L,) float32, or (2L,)
// re | im when complex; out (rows, S_in / 2 / D) complex64.
extern "C" int demodulate(const void* x, const void* phasor, const void* taps, void* out,
                          int rows, int S_in, int n_out, int L, int D, int int16_input,
                          int complex_taps, float scale, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (int16_input)
    return complex_taps
        ? dispatch<Demod<int16_t, true>::At>(L, D, x, phasor, taps, out, rows, S_in, n_out, L, D, scale, s)
        : dispatch<Demod<int16_t, false>::At>(L, D, x, phasor, taps, out, rows, S_in, n_out, L, D, scale, s);
  return complex_taps
      ? dispatch<Demod<float, true>::At>(L, D, x, phasor, taps, out, rows, S_in, n_out, L, D, scale, s)
      : dispatch<Demod<float, false>::At>(L, D, x, phasor, taps, out, rows, S_in, n_out, L, D, scale, s);
}

// x (rows, S) float32 or complex64; taps as above; out (rows, S / D)
// float32 when neither is complex, else complex64.
extern "C" int fir(const void* x, const void* taps, void* out, int rows, int S, int n_out,
                   int L, int D, int complex_input, int complex_taps, void* stream) {
  if (rows <= 0 || n_out <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (complex_input)
    return complex_taps
        ? dispatch<Fir<true, true>::At>(L, D, x, taps, out, rows, S, n_out, L, D, s)
        : dispatch<Fir<true, false>::At>(L, D, x, taps, out, rows, S, n_out, L, D, s);
  return complex_taps
      ? dispatch<Fir<false, true>::At>(L, D, x, taps, out, rows, S, n_out, L, D, s)
      : dispatch<Fir<false, false>::At>(L, D, x, taps, out, rows, S, n_out, L, D, s);
}
