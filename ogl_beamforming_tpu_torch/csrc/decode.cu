// Hadamard decode for Hopper (sm_90a).
//
// Replaces the TPU kernel ogl_beamforming_tpu/ops/decode.py::_decode_call
// (its bodies _decode_kernel, _decode_kernel_cb, _decode_kernel_pipe and
// _decode_kernel_i8):
//     out[c, t, s] = (1/T) * sum_j H[t, j] * rf[c, j, s]
// for rf (C, A, S) int16 or float32 and out (C, A, S) float32.
//
// What bounds it on this card: at the main path's shape (C = A = 128,
// S = 4096) the kernel reads 128 MiB of int16 and writes 256 MiB of float32,
// about 0.12 ms at 3.35 TB/s, against 8.6 G multiply-adds, about 0.6 ms on
// the CUDA cores' int32 pipes.  This simple form is therefore bound by
// arithmetic and shared-memory issue, not by device memory.
//
// What the design does about it: one block per (channel, 64-sample tile)
// stages H (as int8, exact for +-1) and the A x 64 RF tile in shared memory,
// then each thread keeps eight output rows in registers, so one shared load
// of an RF value feeds eight multiply-adds.  Tensor cores (int8 wgmma) are
// the later step.  int16 input accumulates in int32, which is exact for the
// whole int16 range, and the result is float(acc) * (1/T) with 1/T the f32
// constant: bit for bit what the JAX package computes.  float32 input
// (complex frames interleaved re|im along S by the wrapper) accumulates in
// float32.  Any order A works (12*2^k and 20*2^k included) without padding,
// as long as H and the tile fit in shared memory (A <= 256, the reference's
// emission limit, needs 128 KiB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // samples per block
constexpr int kGroups = 4;     // row groups per block (blockDim.y)
constexpr int kRows = 8;       // output rows per thread per pass

template <typename T> struct Acc;
template <> struct Acc<int16_t> { using type = int; };
template <> struct Acc<float> { using type = float; };

template <typename T>
__global__ void decode_kernel(const T* __restrict__ rf,
                              const int8_t* __restrict__ h,
                              float* __restrict__ out,
                              int A, int S, float scale) {
  using acc_t = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* hs = reinterpret_cast<int8_t*>(smem);
  T* xs = reinterpret_cast<T*>(smem + ((A * A + 15) / 16) * 16);

  const int c = blockIdx.y;
  const int s0 = blockIdx.x * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kGroups;
  const T* src = rf + (size_t)c * A * S;

  for (int i = tid; i < A * A; i += nthreads) hs[i] = h[i];
  for (int i = tid; i < A * kTile; i += nthreads) {
    const int j = i / kTile, s = s0 + i % kTile;
    xs[i] = s < S ? src[(size_t)j * S + s] : T(0);
  }
  __syncthreads();

  const int s = s0 + threadIdx.x;
  if (s >= S) return;
  float* dst = out + (size_t)c * A * S + s;
  for (int t0 = threadIdx.y * kRows; t0 < A; t0 += kGroups * kRows) {
    const int rows = min(kRows, A - t0);
    acc_t acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int j = 0; j < A; ++j) {
      const acc_t x = static_cast<acc_t>(xs[j * kTile + threadIdx.x]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] += static_cast<acc_t>(hs[(t0 + r) * A + j]) * x;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < rows) dst[(size_t)(t0 + r) * S] = static_cast<float>(acc[r]) * scale;
  }
}

template <typename T>
int launch(const void* rf, const void* h, void* out, int C, int A, int S,
           float scale, void* stream) {
  const size_t smem = ((size_t)(A * A + 15) / 16) * 16 + (size_t)A * kTile * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTile - 1) / kTile, C);
  dim3 block(kTile, kGroups);
  decode_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rf), static_cast<const int8_t*>(h),
      static_cast<float*>(out), A, S, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_int16(const void* rf, const void* h, void* out, int C,
                            int A, int S, float scale, void* stream) {
  return launch<int16_t>(rf, h, out, C, A, S, scale, stream);
}

extern "C" int decode_f32(const void* rf, const void* h, void* out, int C,
                          int A, int S, float scale, void* stream) {
  return launch<float>(rf, h, out, C, A, S, scale, stream);
}
