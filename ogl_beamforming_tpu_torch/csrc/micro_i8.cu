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
// device memory.  At the probes' own shapes every launch is a few blocks.
//
// Design: one block of 8 warps per 64 output columns.  The block stages H
// (or A, as 32-bit words) and its 64-column slice of X (two columns a
// load) split into hi and lo in shared memory, each laid out as 16 x 16
// sub-tiles of 256 bytes (WMMA loads need 32-byte aligned tiles; an int8
// row-major k-step is 16 bytes).  Each warp takes 16 x 16 output tiles in
// turn and runs WMMA m16n16k16 signed-char products into int32
// accumulators (`full`: two, combined elementwise as 256 hi + lo, valid
// because both accumulators share one layout), stores them to shared
// memory, and the block writes its K x 64 slice with coalesced stores,
// adding 128 rowsum(H) per row (two threads a row, __dp4a over its words).
// K is a multiple of 16 up to 128 (K = 16, the probe's depth, is one
// k-step: no padding to mma.sync's k = 32).

#include <cstdint>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kCols = 64;        // output columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 16;         // WMMA m = n = k
constexpr int kMaxK = 128;

enum Body { K10_I32, K10_F32, K11_DOT, K11_FULL };
enum Elementwise { K11_SHIFT, K11_SPLIT8, K11_ROWSUM };

// (r, c) of an R x C matrix stored as 16 x 16 sub-tiles, row-major inside
// and across tiles.
__device__ __forceinline__ int tiled(int r, int c, int cols) {
  return ((r / kSub) * (cols / kSub) + c / kSub) * kSub * kSub +
         (r % kSub) * kSub + c % kSub;
}

template <int BODY>
__global__ void __launch_bounds__(kThreads)
i8_mma_kernel(const int8_t* __restrict__ a, const void* __restrict__ b,
              void* __restrict__ out, int K, int N, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* s_a = reinterpret_cast<int8_t*>(smem);        // K x K
  int8_t* s_hi = s_a + K * K;                           // K x kCols
  int8_t* s_lo = s_hi + K * kCols;                      // K x kCols (full)
  int* s_out = reinterpret_cast<int*>(s_lo + K * kCols);  // K x kCols
  __shared__ int s_row[kMaxK];                          // 128 rowsum (full)
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int col0 = blockIdx.x * kCols;

  // A as 32-bit words: four bytes of a row stay together in a sub-tile
  const int* a4 = reinterpret_cast<const int*>(a);
  for (int i = t; i < K * K / 4; i += kThreads) {
    const int r = 4 * i / K, c = 4 * i % K;
    *reinterpret_cast<int*>(s_a + tiled(r, c, K)) = a4[i];
  }
  // the block's K x kCols slice of B, two columns at a time
  for (int i = t; i < K * kCols / 2; i += kThreads) {
    const int r = 2 * i / kCols, c = 2 * i % kCols;
    const size_t g = (size_t)r * N + col0 + c;
    const int o = tiled(r, c, kCols);
    if (BODY == K10_I32 || BODY == K10_F32) {
      *reinterpret_cast<int16_t*>(s_hi + o) =
          *reinterpret_cast<const int16_t*>(static_cast<const int8_t*>(b) + g);
    } else {
      const int pair = *reinterpret_cast<const int*>(
          static_cast<const int16_t*>(b) + g);
      const int x0 = static_cast<int16_t>(pair & 0xFFFF), x1 = pair >> 16;
      *reinterpret_cast<uint16_t*>(s_hi + o) = static_cast<uint16_t>(
          ((x0 >> 8) & 255) | (((x1 >> 8) & 255) << 8));
      if (BODY == K11_FULL)
        *reinterpret_cast<uint16_t*>(s_lo + o) = static_cast<uint16_t>(
            (((x0 & 255) - 128) & 255) | ((((x1 & 255) - 128) & 255) << 8));
    }
  }
  if (BODY == K11_FULL && t < 2 * K) {
    // 128 rowsum(A): two threads a row, 4 bytes a step (__dp4a), then a
    // shuffle (2 K is a multiple of 32: whole warps take part)
    const int r = t / 2, half = t % 2;
    const int* row = a4 + (r * K + half * (K / 2)) / 4;
    int s = 0;
    for (int w = 0; w < K / 8; ++w) s = __dp4a(row[w], 0x01010101, s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0) s_row[r] = s * 128;
  }
  __syncthreads();

  const int tiles_n = kCols / kSub;
  const int tiles = (K / kSub) * tiles_n;
  for (int tile = warp; tile < tiles; tile += kWarps) {
    const int tm = tile / tiles_n, tn = tile % tiles_n;
    wmma::fragment<wmma::accumulator, kSub, kSub, kSub, int> hi, lo;
    wmma::fill_fragment(hi, 0);
    wmma::fill_fragment(lo, 0);
    for (int kt = 0; kt < K / kSub; ++kt) {
      wmma::fragment<wmma::matrix_a, kSub, kSub, kSub, signed char,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, kSub, kSub, kSub, signed char,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, s_a + (tm * (K / kSub) + kt) * kSub * kSub,
                             kSub);
      wmma::load_matrix_sync(fb, s_hi + (kt * tiles_n + tn) * kSub * kSub,
                             kSub);
      wmma::mma_sync(hi, fa, fb, hi);
      if (BODY == K11_FULL) {
        wmma::load_matrix_sync(fb, s_lo + (kt * tiles_n + tn) * kSub * kSub,
                               kSub);
        wmma::mma_sync(lo, fa, fb, lo);
      }
    }
    if (BODY == K11_FULL) {
#pragma unroll
      for (int i = 0; i < hi.num_elements; ++i) hi.x[i] = hi.x[i] * 256 + lo.x[i];
    }
    wmma::store_matrix_sync(s_out + tm * kSub * kCols + tn * kSub, hi, kCols,
                            wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = t; i < K * kCols; i += kThreads) {
    const int r = i / kCols;
    const size_t g = (size_t)r * N + col0 + i % kCols;
    const int v = s_out[i];
    if (BODY == K10_I32)
      static_cast<int*>(out)[g] = v;
    else if (BODY == K11_FULL)
      static_cast<float*>(out)[g] = static_cast<float>(v + s_row[r]) * scale;
    else
      static_cast<float*>(out)[g] = static_cast<float>(v);
  }
}

template <int BODY>
__global__ void i8_elementwise_kernel(const int8_t* __restrict__ h,
                                      const int16_t* __restrict__ x,
                                      float* __restrict__ out, int K, int N) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)K * N) return;
  if (BODY == K11_SHIFT) {
    out[i] = static_cast<float>(x[i] >> 8);
  } else if (BODY == K11_SPLIT8) {
    const int8_t hi = static_cast<int8_t>(x[i] >> 8);
    const int8_t lo = static_cast<int8_t>((x[i] & 255) - 128);
    out[i] = static_cast<float>(hi) * 256.0f + static_cast<float>(lo);
  } else {
    const int r = static_cast<int>(i / N);
    int s = 0;
    for (int j = 0; j < K; ++j) s += h[r * K + j];
    out[i] = static_cast<float>(s * 128);
  }
}

template <int BODY>
int launch_mma(const void* a, const void* b, void* out, int K, int N,
               float scale, cudaStream_t stream) {
  const int smem = K * K + 2 * K * kCols + K * kCols * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      i8_mma_kernel<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  i8_mma_kernel<BODY><<<N / kCols, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(a), b, out, K, N, scale);
  return (int)cudaGetLastError();
}

template <int BODY>
int launch_elementwise(const void* h, const void* x, void* out, int K, int N,
                       cudaStream_t stream) {
  const size_t n = (size_t)K * N;
  i8_elementwise_kernel<BODY><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const int8_t*>(h), static_cast<const int16_t*>(x),
      static_cast<float*>(out), K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// body: 0 K10 int32, 1 K10 float32, 2 K11 dot, 3 K11 full.  a: int8 K x K;
// b: int8 (K10) or int16 (K11) K x N; K a multiple of 16 up to 128, N a
// multiple of 64.
extern "C" int micro_i8_mma(int body, const void* a, const void* b, void* out,
                            int K, int N, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || K % kSub || K > kMaxK || N <= 0 || N % kCols)
    return (int)cudaErrorInvalidValue;
  switch (body) {
    case K10_I32: return launch_mma<K10_I32>(a, b, out, K, N, scale, st);
    case K10_F32: return launch_mma<K10_F32>(a, b, out, K, N, scale, st);
    case K11_DOT: return launch_mma<K11_DOT>(a, b, out, K, N, scale, st);
    case K11_FULL: return launch_mma<K11_FULL>(a, b, out, K, N, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// body: 0 shift, 1 split8, 2 rowsum.  h: int8 K x K; x: int16 K x N.
extern "C" int micro_i8_elementwise(int body, const void* h, const void* x,
                                    void* out, int K, int N, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  switch (body) {
    case K11_SHIFT: return launch_elementwise<K11_SHIFT>(h, x, out, K, N, st);
    case K11_SPLIT8: return launch_elementwise<K11_SPLIT8>(h, x, out, K, N, st);
    case K11_ROWSUM: return launch_elementwise<K11_ROWSUM>(h, x, out, K, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
