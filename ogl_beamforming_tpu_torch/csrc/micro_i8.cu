// int8 tensor-core probes for Hopper (sm_90a).
//
// Replaces the TPU probe kernels experiments/probe_i8.py (K10: `kernel2`,
// the arithmetic of `kernel`) and experiments/probe_i8b.py (K11: `k_shift`,
// `k_split8`, `k_dot`, `k_rowsum`, `k_full`).
//   K10: out = A @ B for int8 A (K x K) and B (K x N), read out as int32 or
//        as float32.
//   K11: for int8 H (K x K) and int16 X (K x N), with X = 256 hi + lo + 128,
//        hi = X >> 8 (arithmetic) and lo = (X & 255) - 128, both int8:
//        shift   float(X >> 8);
//        split8  256 float(hi) + float(lo);
//        dot     float(H @ hi);
//        rowsum  float(128 rowsum(H)), broadcast along N;
//        full    float(256 H @ hi + H @ lo + 128 rowsum(H)) * scale, which
//                is the int8 two-pass form of the Hadamard decode
//                (ogl_beamforming_tpu/ops/decode.py::_decode_kernel_i8).
//        The split is exact for the whole int16 range and the int32 sums
//        are exact, so `full` equals the exact product H @ X times scale.
//
// What bounds it: at the decode's width (K = 128, N = 128 x 4096) `full`
// reads 128 MiB of int16 and writes 256 MiB of float32, 0.120 ms at
// 3.35 TB/s, against 2 x 17.2 G int8 operations, 0.017 ms at 1979 TOP/s:
// device memory.  K10 at its probe's shape (128 x 128 @ 128 x 256) moves
// 176 KB and does 8.4 M operations: one wave of short blocks, whose time is
// the latency of one block's chain (load, stage, 8 MMAs a tile, store) and
// the launch.
//
// Design: `dot`, `full` and K10 are instantiations of the int8 skeleton of
// i8_mma.cuh, the one the decode kernel (decode.cu, K2) runs.  `full` is the
// decode's body on X as one channel of width N (scale 1/16 here); `dot` its
// high half alone, one product per tile.  K10 puts int8 B through the same B
// path: a b16 element of B holds columns 2n and 2n+1 as an int16 of X holds
// its hi and lo bytes, and A takes H's place.  K10 at its size is one
// block's latency chain, so it spreads rows and columns over more, shorter
// blocks than the decode's tile: blocks of 4 warps over 16 columns and 64
// rows, 32 blocks at 128 x 256 (launch_k10; the fastest by the trace of
// five tiles measured on the H100, PERF.md).  K is at most 128 and N any; a
// ragged last tile is handled as the decode handles it.  shift, split8 and
// rowsum are elementwise; rowsum sums each row once per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "i8_mma.cuh"

namespace {

constexpr int kMaxK = 128;

enum Body { K10_I32, K10_F32, K11_DOT, K11_FULL };
enum Elementwise { K11_SHIFT, K11_SPLIT8, K11_ROWSUM };

template <int KSTEPS, int BODY, int WN, int WM, int ROWS>
__global__ void __launch_bounds__(32 * WN * WM)
i8_mma_kernel(const typename I8Tiles<KSTEPS, BODY, WN, WM, ROWS>::T* __restrict__ x,
              const int8_t* __restrict__ h, void* __restrict__ out, int C, int A,
              int S, float scale, bool vec_in, bool vec_out) {
  i8_tiles<KSTEPS, BODY, WN, WM, ROWS>(x, h, out, C, A, S, scale, vec_in, vec_out);
}

template <int KSTEPS, int BODY, int WN, int WM, int ROWS>
int launch_mma(const void* a, const void* b, void* out, int K, int N, float scale,
               cudaStream_t stream) {
  using G = I8Tiles<KSTEPS, BODY, WN, WM, ROWS>;
  static std::atomic<int> cache[kMaxDevices];
  return launch_i8_tiles<G>(i8_mma_kernel<KSTEPS, BODY, WN, WM, ROWS>, cache,
                            static_cast<const typename G::T*>(b),
                            static_cast<const int8_t*>(a), out, 1, K, N, scale, stream);
}

// K10's tile, (WN, WM, ROWS) as in i8_mma.cuh: a block of 4 warps takes 16
// columns of 64 rows (of all rows where K <= 64), one m-tile a warp.
template <int BODY, int KSTEPS>
int launch_k10(const void* a, const void* b, void* out, int K, int N,
               cudaStream_t stream) {
  return launch_mma<KSTEPS, BODY, 1, 4, (64 < KSTEPS * 32 ? 64 : KSTEPS * 32)>(
      a, b, out, K, N, 1.f, stream);
}

template <int BODY>
__global__ void i8_elementwise_kernel(const int8_t* __restrict__ h,
                                      const int16_t* __restrict__ x,
                                      float* __restrict__ out, int K, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)K * N) return;
  if (BODY == K11_SHIFT) {
    out[i] = static_cast<float>(x[i] >> 8);
  } else {
    const int8_t hi = static_cast<int8_t>(x[i] >> 8);
    const int8_t lo = static_cast<int8_t>((x[i] & 255) - 128);
    out[i] = static_cast<float>(hi) * 256.0f + static_cast<float>(lo);
  }
}

// 128 rowsum(H) broadcast along N: block (x, row) sums its row once, with
// its first warp, and writes blockDim.x columns of it.
__global__ void i8_rowsum_kernel(const int8_t* __restrict__ h, float* __restrict__ out,
                                 int K, int N) {
  __shared__ int s_sum;
  const int r = blockIdx.y;
  if (threadIdx.x < 32) {
    int s = 0;
    for (int j = threadIdx.x; j < K; j += 32) s += h[(size_t)r * K + j];
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) s_sum = s;
  }
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col < N) out[(size_t)r * N + col] = static_cast<float>(s_sum * 128);
}

}  // namespace

// body: 0 K10 int32, 1 K10 float32, 2 K11 dot, 3 K11 full.  a: int8 K x K;
// b: int8 (K10) or int16 (K11) K x N; out K x N; 0 < K <= 128, N > 0.
extern "C" int micro_i8_mma(int body, const void* a, const void* b, void* out,
                            int K, int N, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || K > kMaxK || N <= 0 || body < K10_I32 || body > K11_FULL)
    return (int)cudaErrorInvalidValue;
  return by_steps<kMaxK / 32>(K, [&](auto k) {
    constexpr int KS = decltype(k)::value;
    switch (body) {
      case K10_I32: return launch_k10<kI8PairI32, KS>(a, b, out, K, N, st);
      case K10_F32: return launch_k10<kI8PairF32, KS>(a, b, out, K, N, st);
      case K11_DOT: return launch_mma<KS, kI8Hi, 8, 1, 0>(a, b, out, K, N, 1.f, st);
      default: return launch_mma<KS, kI8Decode, 8, 1, 0>(a, b, out, K, N, scale, st);
    }
  });
}

// body: 0 shift, 1 split8, 2 rowsum.  h: int8 K x K; x: int16 K x N.
extern "C" int micro_i8_elementwise(int body, const void* h, const void* x,
                                    void* out, int K, int N, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const auto* h8 = static_cast<const int8_t*>(h);
  const auto* x16 = static_cast<const int16_t*>(x);
  auto* o = static_cast<float*>(out);
  const size_t n = (size_t)K * N;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  switch (body) {
    case K11_SHIFT:
      i8_elementwise_kernel<K11_SHIFT><<<blocks, 256, 0, st>>>(h8, x16, o, K, N);
      break;
    case K11_SPLIT8:
      i8_elementwise_kernel<K11_SPLIT8><<<blocks, 256, 0, st>>>(h8, x16, o, K, N);
      break;
    case K11_ROWSUM:
      if (K > 65535) return (int)cudaErrorInvalidValue;   // a grid row each
      i8_rowsum_kernel<<<dim3((N + 255) / 256, K), 256, 0, st>>>(h8, o, K, N);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
