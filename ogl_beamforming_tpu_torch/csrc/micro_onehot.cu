// One-hot matrix-product interpolation microbenchmark for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark kernels experiments/onehot_micro.py:86
// (K8: `make_onehot.kernel`) and experiments/onehot_micro2.py:98 (K9:
// `make_onehot.kernel`): DAS sampling recast as a matrix product over a
// frame batch.  Per unit u, a banded weight matrix
//     W_u[s, v] = wt[t, v]  where s = k[0, v] + t + off(u), t = 0..3,
//                           0 <= s < 128, and 0 elsewhere,
// rounded to bf16, multiplies the (B x 128) bf16 RF rows into a float32 sum:
//     out[b, v] += sum_s bf16(rf[b, s]) * bf16(W_u[s, v]).
// off(u) = u & 3 (K8) or 4u (K9).  The TPU ran `steps` grid steps in order,
// each recomputing the tile; here each step is a block, and every block
// stores its tile to the same output (identical values).  Each unit keeps
// its own band and its own dense 128-deep product: no unit's product is
// summed into another's, and no all-zero tile of W is skipped.
//
// What bounds it: the function's bound is operations, the 2 B 128^2 bf16
// operations per unit on the tensor cores (989 TFLOP/s); W's 4 x 128
// nonzeros per unit are the only CUDA-core work it needs.  B = 128 runs
// near that bound.  At B = 8 and 32 the wgmma still read all of W from
// shared memory, 32 KB a unit and block whatever B is, and those reads,
// not the products, set the time.
//
// Design.  The product is taken transposed, out^T = W^T rf^T: its M is the
// 128 voxels v, its N the B frames, so wgmma's 64-row minimum falls on the
// voxels and B = 8, 32 and 128 run one path, m64nBk16, with no padded row.
// A block is two warpgroups; warpgroup g multiplies voxel rows 64 g .. 64 g
// + 63 of W^T (A, K-major in shared memory) by the RF rows (B, K-major in
// shared memory, staged as bf16 once per block), 8 wgmma a unit, the float32
// sums in registers across all units.  Both tiles use the 128-byte swizzle
// (two 64-wide halves of K, 8-row atoms of 1024 bytes).
//   * W is a scattered band, not a rebuilt matrix.  Two W^T tiles, zeroed
//     once per block; threads i and i + 64 of warpgroup g share voxel v =
//     64 g + i % 64, each with k[0, v] and two of its tap weights (the even
//     taps or the odd ones) as bf16 in registers.  Per unit a thread erases
//     the 2 entries it wrote two units earlier into the tile (their places
//     kept in registers), then writes the unit's 2.  K8's offsets two units
//     apart differ by 2, so an old entry and a new one share a place only
//     for taps of one parity: one thread's, erased before written.  Entries
//     with s outside 0 .. 127 are never written to a tile and never erased
//     there: their stores go to a trash slot, so the band has no branch.
//   * The next unit's band overlaps this unit's product.  After issuing
//     unit u's wgmma, a warpgroup waits only for unit u - 1's
//     (`wgmma.wait_group 1`), which read the other tile, scatters unit u + 1
//     into that tile, makes the stores visible to the tensor cores
//     (`fence.proxy.async`) and meets its own 128 threads at a named
//     barrier; unit u's product runs meanwhile.  A warpgroup only ever
//     touches its own 64 rows of either tile, so the two warpgroups never
//     wait for each other inside the loop.  (Measured on the H100: with 4
//     stores a thread a unit, the band after the product instead is within
//     3 %; the SM's other 3 to 5 warpgroups keep the tensor cores fed.)

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;         // samples s (the product's K) and voxels v
constexpr int kTaps = 4;
constexpr int kTapsEach = 2;       // taps of a row a thread writes
static_assert(kTaps == 2 * kTapsEach, "a row's taps by parity over two threads");
constexpr int kThreads = 256;      // two warpgroups
constexpr int kGroupRows = 64;     // W^T rows a warpgroup multiplies: wgmma's M
constexpr int kStepK = 16;         // wgmma's K for bf16
constexpr int kAtomK = 64;         // bf16 of a 128-byte swizzle row
constexpr int kAtomBytes = 1024;   // 8 rows of 128 bytes
constexpr int kWBytes = kLane * kLane * 2;   // one W^T tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) in a K-major bf16 tile of `rows` rows by
// 128: two halves of 64 along K, each `rows` rows of 128 bytes, the 16-byte
// chunk index XORed with r % 8 (the 128-byte swizzle of a 1024-byte-aligned
// atom, as the descriptor below names it).
__device__ __forceinline__ unsigned tile_offset(int rows, int r, int k) {
  return (k / kAtomK) * rows * 128 + r * 128 +
         ((((k % kAtomK) / 8) ^ (r % 8)) * 16) + (k % 8) * 2;
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: start address >> 4, leading offset 16 bytes (unused within a
// swizzle row), stride 1024 bytes between 8-row groups, layout 1 (128B).
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(kAtomBytes >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The threads' shared-memory stores, visible to the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
// Keeps the compiler from moving accumulator accesses across a wgmma
// fence or wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define OH_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define OH_D16(i) OH_D4(i), OH_D4(i + 4), OH_D4(i + 8), OH_D4(i + 12)

// d (64 x N float32, wgmma's accumulator layout) += A (64 x 16) B^T, A and
// B (N x 16) bf16 K-major in shared memory, named by descriptors.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<8>(float (&d)[4], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : OH_D4(0)
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a,
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : OH_D16(0)
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : OH_D16(0), OH_D16(16), OH_D16(32), OH_D16(48)
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

#undef OH_D16
#undef OH_D4

template <int B>
constexpr int smem_bytes() {
  // two W^T tiles, the rf tile, a 16-byte trash slot, alignment slack
  return 2 * kWBytes + B * kLane * 2 + 16 + kAtomBytes;
}

template <int B>
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const float* __restrict__ rf, const int* __restrict__ k,
              const float* __restrict__ wt, float* __restrict__ out,
              int units, int off_mask, int off_mul) {
  static_assert(B % 8 == 0 && B <= 256, "wgmma's N");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (kAtomBytes - smem_addr(smem_raw) % kAtomBytes) % kAtomBytes;
  unsigned char* s_rf = smem + 2 * kWBytes;   // bf16 rf [b][s], B x 128
  // the stores of band entries outside the tile land here, unread
  constexpr unsigned kTrash = 2 * kWBytes + B * kLane * 2;
  const int tid = threadIdx.x, g = tid / 128, i = tid % 128;

  // both W^T tiles zeroed; rf as bf16, 8 samples (16 bytes) a store
  for (int j = tid; j < 2 * kWBytes / 16; j += kThreads)
    reinterpret_cast<uint4*>(smem)[j] = make_uint4(0u, 0u, 0u, 0u);
  for (int j = tid; j < B * kLane / 8; j += kThreads) {
    const int b = j / (kLane / 8), s = 8 * (j % (kLane / 8));
    const float4 x0 = reinterpret_cast<const float4*>(rf)[2 * j];
    const float4 x1 = reinterpret_cast<const float4*>(rf)[2 * j + 1];
    const __nv_bfloat162 p0 = __floats2bfloat162_rn(x0.x, x0.y);
    const __nv_bfloat162 p1 = __floats2bfloat162_rn(x0.z, x0.w);
    const __nv_bfloat162 p2 = __floats2bfloat162_rn(x1.x, x1.y);
    const __nv_bfloat162 p3 = __floats2bfloat162_rn(x1.z, x1.w);
    *reinterpret_cast<uint4*>(s_rf + tile_offset(B, b, s)) = make_uint4(
        *reinterpret_cast<const unsigned*>(&p0),
        *reinterpret_cast<const unsigned*>(&p1),
        *reinterpret_cast<const unsigned*>(&p2),
        *reinterpret_cast<const unsigned*>(&p3));
  }

  // threads i and i + 64 of warpgroup g share W^T row v = 64 g + i % 64,
  // taps t = 2 j + i / 64 (j = 0, 1) each: the row's band start, the two
  // weights and the places of the entries written for the last two units
  // stay in its registers.  Unit u - 1's places and unit u + 1's meet only
  // for taps two apart (K8: off(u + 1) - off(u - 1) = +-2; K9: 8, never),
  // the same thread's, which erases before it writes.
  const int v = g * kGroupRows + i % kGroupRows, parity = i / kGroupRows;
  const int kv = k[v];                          // row 0 of the index tile
  __nv_bfloat16 w[kTapsEach];
#pragma unroll
  for (int j = 0; j < kTapsEach; ++j)
    w[j] = __float2bfloat16_rn(wt[(2 * j + parity) * kLane + v]);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  // where unit u's entries of row v go: tile u & 1, or the trash slot for
  // s outside 0 .. 127
  auto band_at = [&](int u, unsigned (&at)[kTapsEach]) {
    const int off = (u & off_mask) * off_mul;
#pragma unroll
    for (int j = 0; j < kTapsEach; ++j) {
      const int s = kv + 2 * j + parity + off;
      at[j] = (unsigned)s < (unsigned)kLane
                  ? (u & 1) * kWBytes + tile_offset(kLane, v, s) : kTrash;
    }
  };
  auto store = [&](const unsigned (&at)[kTapsEach], bool erase) {
#pragma unroll
    for (int j = 0; j < kTapsEach; ++j)
      *reinterpret_cast<__nv_bfloat16*>(smem + at[j]) = erase ? zero : w[j];
  };
  unsigned prev[kTapsEach], cur[kTapsEach], next[kTapsEach];  // u - 1, u, u + 1
#pragma unroll
  for (int j = 0; j < kTapsEach; ++j) prev[j] = kTrash;

  __syncthreads();                              // the zeros before the band
  band_at(0, cur);
  store(cur, false);
  fence_proxy_async();
  __syncthreads();

  float acc[B / 2];
#pragma unroll
  for (int j = 0; j < B / 2; ++j) acc[j] = 0.0f;
  fence_operands(acc);
  // warpgroup g's rows of tile 0, and the rf tile
  const uint64_t desc_w = sw128_desc(smem_addr(smem) + g * kGroupRows * 128);
  const uint64_t desc_rf = sw128_desc(smem_addr(s_rf));

#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    const uint64_t dw = desc_w + (uint64_t)((u & 1) * (kWBytes >> 4));
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kLane / kStepK; ++ks) {
      // K step ks: half ks / 4 of the tile, 32 bytes into its rows per step
      const int half = ks * kStepK / kAtomK, in = (ks * kStepK % kAtomK) * 2;
      wgmma_bf16<B>(acc, dw + ((half * kLane * 128 + in) >> 4),
                    desc_rf + ((half * B * 128 + in) >> 4));
    }
    wgmma_commit();
    if (u + 1 < units) {
      wgmma_wait<1>();      // unit u - 1's products, the readers of tile (u + 1) & 1
      band_at(u + 1, next);
      store(prev, true);    // unit u - 1's entries, then unit u + 1's
      store(next, false);
      fence_proxy_async();
#pragma unroll
      for (int j = 0; j < kTapsEach; ++j) {
        prev[j] = cur[j];
        cur[j] = next[j];
      }
      warpgroup_barrier(1 + g);
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator layout: warp w of the warpgroup holds rows 16 w .. 16 w +
  // 15 (voxels), lane (gid, tig) rows gid and gid + 8 at columns (frames)
  // 8 j + 2 tig and + 1
  const int warp = i / 32, lane = i % 32, gid = lane / 4, tig = lane % 4;
  const int row = g * kGroupRows + warp * 16 + gid;
#pragma unroll
  for (int j = 0; j < B / 8; ++j) {
    const int b = 8 * j + 2 * tig;
    out[b * kLane + row] = acc[4 * j];
    out[(b + 1) * kLane + row] = acc[4 * j + 1];
    out[b * kLane + row + 8] = acc[4 * j + 2];
    out[(b + 1) * kLane + row + 8] = acc[4 * j + 3];
  }
}

template <int B>
int launch(const void* rf, const void* k, const void* wt, void* out,
           int units, int off_mask, int off_mul, int steps,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<B>();
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
