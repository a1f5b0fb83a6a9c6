// One-hot matrix-product interpolation microbenchmark for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark kernels experiments/onehot_micro.py
// (K8: `make_onehot.kernel`) and experiments/onehot_micro2.py (K9:
// `make_onehot.kernel`): DAS sampling recast as a matrix product over a
// frame batch.  Per unit u, a banded weight matrix
//     W[s, v] = sum_t wt[t, v] * [s == k[v] + t + off(u)],  t = 0..3,
// is built from compares on a 128 x 128 tile (no gathers), rounded to bf16,
// and the (B x 128) bf16 RF rows are multiplied by it into a float32 sum:
//     out[b, v] += sum_s bf16(rf[b, s]) * W[s, v].
// off(u) = u & 3 (K8) or 4u (K9).  The TPU ran `steps` grid steps in order,
// each recomputing the tile; here each step is a block, and every block
// stores its tile to the same output (identical values).
//
// What bounds it: operations.  The W build, 13 float32 operations for each
// of the 128 x 128 entries per unit on the CUDA cores (67 TFLOP/s), is the
// larger term at B = 8 and 32; the 2 B 128^2 bf16 operations of the product
// on the tensor cores (989 TFLOP/s) at B = 128.
//
// Design: 256 threads (8 warps).  The RF rows are staged once as bf16 in
// shared memory; per unit the threads write W (34 KiB of bf16 with padded
// rows, one column v per thread, its four tap weights and k[v] in
// registers) and the warps
// multiply with WMMA's m8n32k16 bf16 shape, which takes B = 8 without
// padding rows; each warp keeps its output tiles' float32 accumulators in
// registers across all units.  bf16 x bf16 products are exact in float32;
// only the order of the sums differs from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kM = 8, kN = 32, kK = 16;     // WMMA bf16 shape m8n32k16
// shared rows padded by 8 bf16 (16 bytes): rows 256 bytes apart would put
// every row of a fragment on the same banks
constexpr int kLd = kLane + 8;

template <int B>
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const float* __restrict__ rf, const int* __restrict__ k,
              const float* __restrict__ wt, float* __restrict__ out,
              int units, int off_mask, int off_mul) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(smem);  // [s][v]
  __nv_bfloat16* s_rf = s_w + kLane * kLd;                         // [b][s]
  const int t = threadIdx.x;
  const int warp = t / 32;
  for (int i = t; i < B * kLane; i += kThreads)
    s_rf[i / kLane * kLd + i % kLane] = __float2bfloat16_rn(rf[i]);

  const int v = t % kLane;
  const int kv = k[v];                       // row 0 of the index tile
  float wtv[4];
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) wtv[tap] = wt[tap * kLane + v];

  constexpr int kTilesN = kLane / kN;
  constexpr int kTiles = (B / kM) * kTilesN;
  constexpr int kPerWarp = (kTiles + kWarps - 1) / kWarps;
  wmma::fragment<wmma::accumulator, kM, kN, kK, float> acc[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) wmma::fill_fragment(acc[i], 0.0f);

  for (int u = 0; u < units; ++u) {
    const int off = (u & off_mask) * off_mul;
    __syncthreads();                         // the last unit's reads of W
    for (int s = t / kLane; s < kLane; s += kThreads / kLane) {
      float val = 0.0f;
#pragma unroll
      for (int tap = 0; tap < 4; ++tap)
        val = val + (s == kv + tap + off ? wtv[tap] : 0.0f);
      s_w[s * kLd + v] = __float2bfloat16_rn(val);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < kTiles) {                   // the same for a whole warp
        const int tm = tile / kTilesN, tn = tile % kTilesN;
#pragma unroll
        for (int kk = 0; kk < kLane; kk += kK) {
          wmma::fragment<wmma::matrix_a, kM, kN, kK, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, kM, kN, kK, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, s_rf + tm * kM * kLd + kk, kLd);
          wmma::load_matrix_sync(fb, s_w + kk * kLd + tn * kN, kLd);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < kTiles) {
      const int tm = tile / kTilesN, tn = tile % kTilesN;
      wmma::store_matrix_sync(out + tm * kM * kLane + tn * kN, acc[i], kLane,
                              wmma::mem_row_major);
    }
  }
}

template <int B>
int launch(const void* rf, const void* k, const void* wt, void* out,
           int units, int off_mask, int off_mul, int steps,
           cudaStream_t stream) {
  const int smem = (kLane + B) * kLd * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      onehot_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  onehot_kernel<B><<<steps, kThreads, smem, stream>>>(
      static_cast<const float*>(rf), static_cast<const int*>(k),
      static_cast<const float*>(wt), static_cast<float*>(out), units,
      off_mask, off_mul);
  return (int)cudaGetLastError();
}

}  // namespace

// k8 != 0: off(u) = u & 3 (K8), else off(u) = 4u (K9).
extern "C" int micro_onehot(int batch, int k8, const void* rf, const void* k,
                            const void* wt, void* out, int units, int steps,
                            void* stream) {
  const int mask = k8 ? 3 : -1, mul = k8 ? 1 : 4;
  auto st = static_cast<cudaStream_t>(stream);
  if (units <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  switch (batch) {
    case 8: return launch<8>(rf, k, wt, out, units, mask, mul, steps, st);
    case 32: return launch<32>(rf, k, wt, out, units, mask, mul, steps, st);
    case 128: return launch<128>(rf, k, wt, out, units, mask, mul, steps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
