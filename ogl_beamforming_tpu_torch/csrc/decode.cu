// Hadamard decode for Hopper (sm_90a).
//
// Replaces the TPU kernel ogl_beamforming_tpu/ops/decode.py::_decode_call
// (its bodies _decode_kernel, _decode_kernel_cb, _decode_kernel_pipe and
// _decode_kernel_i8):
//     out[c, t, s] = (1/T) * sum_j H[t, j] * rf[c, j, s]
// for rf (C, A, S) int16 or float32 and out (C, A, S) float32, any order
// A <= 256 (12 * 2^k and 20 * 2^k included).
//
// What bounds it on this card: at the main path's shape (C = A = 128,
// S = 4096) the decode reads 128 MiB of int16 and writes 256 MiB of float32,
// 0.120 ms at 3.35 TB/s.  Its 8.6 G multiply-adds are 0.017 ms on the int8
// tensor cores (the int16 input split into two exact int8 halves) but
// 0.256 ms on the float32 CUDA cores.  So the int16 kernel is bound by
// device memory, and everything in it serves the memory path.
//
// decode_i8_kernel (int16 input), the int8 two-pass form of the JAX
// package's _decode_kernel_i8, is the int8 tensor-core skeleton of
// i8_mma.cuh (shared with the K10/K11 probes of micro_i8.cu) with its
// decode body:
//   * x = 256 hi + lo + 128 with hi = x >> 8 and lo = (x & 255) - 128, both
//     int8; H (+-1) is int8; two mma.sync.m16n8k32 s8 products per tile and
//     acc = 256 P_hi + P_lo + 128 rowsum(H) in int32, exact for the whole
//     int16 range (|acc| <= 2^23); out = float(acc) * (1/T) with the f32
//     constant of ops/decode.py::_inv_order, bit for bit the plain twin.
//   * Persistent blocks (as many as fit on the card) stage H once each, as
//     int8 zero-padded to a multiple of 32, then walk over (channel,
//     64-sample) tiles that come in by 16-byte cp.async into a ring of three
//     stages.
//   * The transpose: the product contracts over A, the rows of the tile,
//     while samples are contiguous.  ldmatrix.trans and two __byte_perm
//     give the B fragments of both halves, and the K order this produces is
//     applied to H's columns when H is staged.  This was taken over a
//     transposing write into shared memory because it needs no second pass
//     over the tile and no second buffer.
//   * Output: one shuffle between neighbouring threads gives each thread
//     four consecutive samples of one row, a 16-byte streaming store.
//
// decode_f32_kernel (float32 input, complex frames interleaved re|im along S
// by the wrapper): float32 has no exact int8 split, but it has an exact
// three-term bf16 one, x = hi + mid + lo (8 + 8 + 8 significant bits), and
// with H = +-1 every bf16 product is exact.  So the same skeleton runs three
// bf16 mma.sync.m16n8k16 products per tile on the tensor cores: bound by
// bytes (0.160 ms at path B's shape) where the float32 CUDA cores are bound
// by operations (0.256 ms), and a register-tiled CUDA-core kernel of this
// skeleton stayed slower than the cuBLAS float32 product on the card.  The
// tensor cores' float32 accumulator is not an IEEE adder, so each 16-deep k
// step sums its lo, mid and hi products from zero on the tensor cores and
// the running sum is an IEEE float32 add on the CUDA cores: the error stays
// within 1e-6 of the output's peak up to order 256 (chip_smoke.py,
// tests/test_torch_cuda.py).  Each block owns a slice of up to 128 output
// rows, whose H it stages once as bf16; a thread holds its share of the next
// 64-sample tile in registers (16-byte loads issued before the products of
// the current tile), splits it into three bf16 planes in shared memory, and
// ldmatrix.trans gives the B fragments directly (for 16-bit operands the
// order it delivers is the MMA's own).  Outputs are 16-byte stores as above.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "i8_mma.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps a block
constexpr int kTileS = 64;             // samples per tile, 8 per warp
constexpr int kRowBytes = kTileS * 2 + 16;  // padded 16-bit tile row
constexpr int kMaxOrder = 256;

constexpr int kF32Rows = 128;          // float32 kernel: output rows a block owns
// The largest dynamic shared memory a block of the H100 takes (opt-in): a
// knob's instantiation that needs more is not built.
constexpr size_t kMaxSmem = 232448;

// Launch knobs of the int16 kernel (ops/decode.py DECODE_TUNED, chosen per
// shape by autotune_decode), each only a schedule: its tile of samples
// (kTileS by default; 8 of them a warp across the tile) and its warps
// across H's m-tiles (1 by default), as decode_i8_tile_kernel.  Every
// output is the same sum in the same order whatever the knobs, so they are
// bit-equal to the defaults.

// The int16 kernel: the int8 skeleton (i8_mma.cuh) with the decode's body,
// 8 warps across a 64-sample tile, all of H's rows in every block.
template <int KSTEPS>
using DecodeI8 = I8Tiles<KSTEPS, kI8Decode, 8, 1, 0>;

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads)
decode_i8_kernel(const int16_t* __restrict__ rf, const int8_t* __restrict__ h,
                 void* __restrict__ out, int C, int A, int S, float scale,
                 bool vec_in, bool vec_out) {
  static_assert(DecodeI8<KSTEPS>::kThreads == kThreads &&
                DecodeI8<KSTEPS>::kCols == kTileS, "the decode's tile");
  i8_tiles<KSTEPS, kI8Decode, 8, 1, 0>(rf, h, out, C, A, S, scale, vec_in, vec_out);
}

// The int16 kernel with WN warps across a tile of 8 WN samples and WM
// warps across H's m-tiles.
template <int KSTEPS, int WN, int WM>
__global__ void __launch_bounds__(32 * WN * WM)
decode_i8_tile_kernel(const int16_t* __restrict__ rf, const int8_t* __restrict__ h,
                      void* __restrict__ out, int C, int A, int S, float scale,
                      bool vec_in, bool vec_out) {
  i8_tiles<KSTEPS, kI8Decode, WN, WM, 0>(rf, h, out, C, A, S, scale, vec_in, vec_out);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_value(unsigned b) {
  return __uint_as_float(b << 16);
}

template <int KSTEPS>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const float* __restrict__ rf, const int8_t* __restrict__ h,
                  float* __restrict__ out, int C, int A, int S, float scale,
                  bool vec_in, bool vec_out) {
  constexpr int kPad = KSTEPS * 32;              // A padded to the MMA's K
  constexpr int kSlice = kPad < kF32Rows ? kPad : kF32Rows;  // rows a block owns
  constexpr int kPlane = kPad * kRowBytes;       // one bf16 plane, rows of 144 B
  constexpr int kHRow = 2 * kPad + 16;           // padded bf16 H row, bytes
  constexpr int kVec = kPad * (kTileS / 4) / kThreads;  // float4 a thread holds
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_p = smem;                     // hi, mid, lo planes
  unsigned char* s_h = smem + 3 * kPlane;        // kSlice x kHRow

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int slices = (A + kSlice - 1) / kSlice;
  const int slice = blockIdx.x % slices;
  const int group = blockIdx.x / slices, groups = gridDim.x / slices;
  const int tiles = (S + kTileS - 1) / kTileS;
  const int units = C * tiles;
  if (group >= units) return;

  // Tile `u` into registers: float4 i of this thread is row idx / 16,
  // samples 4 (idx % 16) .. of the tile, idx = tid + i kThreads.
  float4 x[kVec];
  auto fetch = [&](int u) {
    const int c = u / tiles, s0 = (u % tiles) * kTileS;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = tid + i * kThreads, j = idx / (kTileS / 4);
      const int s = s0 + 4 * (idx % (kTileS / 4));
      x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j >= A) continue;
      const float* src = rf + ((size_t)c * A + j) * S + s;
      if (vec_in && s + 4 <= S) {
        x[i] = __ldcs(reinterpret_cast<const float4*>(src));
      } else {
        float e[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) e[k] = s + k < S ? src[k] : 0.f;
        x[i] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  };
  fetch(group);

  // H's rows of this slice as bf16 (exact for +-1), zero outside A x A.
  const int t0 = slice * kSlice;
  for (int i = tid; i < kSlice * kPad; i += kThreads) {
    const int t = i / kPad, j = i % kPad;
    const float v = (t0 + t < A && j < A) ? static_cast<float>(h[(t0 + t) * A + j]) : 0.f;
    reinterpret_cast<unsigned short*>(s_h + t * kHRow)[j] = bf16_bits(v);
  }

  const int m_tiles = min(kSlice, A - t0 + 15) / 16;
  for (int u = group; u < units; u += groups) {
    // x = hi + mid + lo, three bf16 terms, exactly (8 + 8 + 8 significant
    // bits), each into its plane; the padded rows hold zeros
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int idx = tid + i * kThreads, j = idx / (kTileS / 4);
      const int q = 4 * (idx % (kTileS / 4));
      const float v[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
      unsigned b[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        b[0][e] = bf16_bits(v[e]);
        const float r1 = v[e] - bf16_value(b[0][e]);
        b[1][e] = bf16_bits(r1);
        b[2][e] = bf16_bits(r1 - bf16_value(b[1][e]));
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(s_p + p * kPlane + j * kRowBytes + 2 * q) =
            make_uint2(b[p][0] | b[p][1] << 16, b[p][2] | b[p][3] << 16);
    }
    __syncthreads();
    if (u + groups < units) fetch(u + groups);   // in flight during the products

    float acc[kSlice / 16][4];
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
      // B fragments of this warp's 8 samples, K rows 32 k .. 32 k + 31: for
      // bf16 the order ldmatrix.trans delivers is the MMA's own
      unsigned b[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        ldmatrix_x4_trans(b[p], s_p + p * kPlane + (32 * k + lane) * kRowBytes + warp * 16);
#pragma unroll
      for (int m = 0; m < kSlice / 16; ++m) {
        if (m >= m_tiles) break;
        const unsigned char* hr = s_h + (m * 16 + gid) * kHRow + 64 * k + 4 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned a[4];
          a[0] = *reinterpret_cast<const unsigned*>(hr + 32 * half);
          a[1] = *reinterpret_cast<const unsigned*>(hr + 8 * kHRow + 32 * half);
          a[2] = *reinterpret_cast<const unsigned*>(hr + 32 * half + 16);
          a[3] = *reinterpret_cast<const unsigned*>(hr + 8 * kHRow + 32 * half + 16);
          // lo, mid and hi of this k step from zero on the tensor cores;
          // the running sum is an IEEE float32 add on the CUDA cores
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int p = 2; p >= 0; --p)
            mma_bf16(d, a, b[p][2 * half], b[p][2 * half + 1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][i] += d[i];
        }
      }
    }

    const int c = u / tiles;
    const int s = (u % tiles) * kTileS + warp * 8 + 4 * (tig / 2);
    const bool odd = tig & 1;
#pragma unroll
    for (int m = 0; m < kSlice / 16; ++m) {
      if (m >= m_tiles) break;
      float f[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = acc[m][i] * scale;
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? f[0] : f[2], 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? f[1] : f[3], 1);
      const float4 v = odd ? make_float4(g0, g1, f[2], f[3])
                           : make_float4(f[0], f[1], g0, g1);
      const int row = t0 + m * 16 + gid + (odd ? 8 : 0);
      if (row < A) {
        float* dst = out + ((size_t)c * A + row) * S + s;
        if (vec_out && s + 4 <= S) {
          __stcs(reinterpret_cast<float4*>(dst), v);
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (s + i < S) dst[i] = e[i];
        }
      }
    }
    __syncthreads();   // the planes are free for the next tile
  }
}

template <int KSTEPS>
int launch_i8(const int16_t* rf, const int8_t* h, float* out, int C, int A,
              int S, float scale, cudaStream_t stream) {
  static std::atomic<int> cache[kMaxDevices];
  return launch_i8_tiles<DecodeI8<KSTEPS>>(decode_i8_kernel<KSTEPS>, cache, rf, h, out,
                                           C, A, S, scale, stream);
}

template <int KSTEPS, int WN, int WM>
int launch_i8_tile(const int16_t* rf, const int8_t* h, float* out, int C, int A, int S,
                   float scale, cudaStream_t stream) {
  using G = I8Tiles<KSTEPS, kI8Decode, WN, WM, 0>;
  if constexpr (G::kSmem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  } else {
    static std::atomic<int> cache[kMaxDevices];
    return launch_i8_tiles<G>(decode_i8_tile_kernel<KSTEPS, WN, WM>, cache, rf, h, out, C, A,
                              S, scale, stream);
  }
}

// f(WN, WM) as std::integral_constants for the int16 kernel's tile of
// `tile_s` samples (8 WN) and `row_warps` (WM) warps across H's m-tiles:
// the default (kTileS, 1), (128, 1) or (64, 2) (ops/decode.py I8_TILES).
template <typename F>
int by_i8_tile(int tile_s, int row_warps, F f) {
  using std::integral_constant;
  switch (tile_s * 4 + row_warps) {
    case kTileS * 4 + 1:
      return f(integral_constant<int, kTileS / 8>(), integral_constant<int, 1>());
    case 128 * 4 + 1: return f(integral_constant<int, 16>(), integral_constant<int, 1>());
    case 64 * 4 + 2: return f(integral_constant<int, 8>(), integral_constant<int, 2>());
  }
  return (int)cudaErrorInvalidValue;
}

template <int KSTEPS>
int launch_i8_knobs(const int16_t* rf, const int8_t* h, float* out, int C, int A, int S,
                    float scale, int tile_s, int row_warps, cudaStream_t stream) {
  return by_i8_tile(tile_s, row_warps, [&](auto wn, auto wm) {
    constexpr int WN = decltype(wn)::value, WM = decltype(wm)::value;
    if constexpr (WN * 8 == kTileS && WM == 1)
      return launch_i8<KSTEPS>(rf, h, out, C, A, S, scale, stream);
    else
      return launch_i8_tile<KSTEPS, WN, WM>(rf, h, out, C, A, S, scale, stream);
  });
}

template <int KSTEPS>
int launch_f32(const float* rf, const int8_t* h, float* out, int C, int A, int S,
               float scale, cudaStream_t stream) {
  constexpr int kPad = KSTEPS * 32;
  constexpr int kSlice = kPad < kF32Rows ? kPad : kF32Rows;
  const size_t smem = 3 * (size_t)kPad * kRowBytes + (size_t)kSlice * (2 * kPad + 16);
  const int slices = (A + kSlice - 1) / kSlice;
  const long long units = (long long)C * ((S + kTileS - 1) / kTileS);
  static std::atomic<int> cache[kMaxDevices];
  int grid = 0;
  const int err = persistent_grid(decode_f32_kernel<KSTEPS>, cache, kThreads, smem,
                                  units * slices, slices, &grid);
  if (err) return err;
  const bool vec_in = S % 4 == 0 && reinterpret_cast<uintptr_t>(rf) % 16 == 0;
  const bool vec_out = S % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  decode_f32_kernel<KSTEPS><<<grid, kThreads, smem, stream>>>(rf, h, out, C, A, S, scale,
                                                               vec_in, vec_out);
  return (int)cudaGetLastError();
}

bool valid(int C, int A, int S) {
  return C > 0 && A > 0 && A <= kMaxOrder && S > 0;
}

}  // namespace

// int16 rf (C, A, S), int8 h (A, A) with entries +-1, float32 out (C, A, S);
// 0 < A <= 256; the tile knobs of launch_i8_knobs.
extern "C" int decode_int16(const void* rf, const void* h, void* out, int C,
                            int A, int S, float scale, int tile_s, int row_warps,
                            void* stream) {
  if (!valid(C, A, S)) return (int)cudaErrorInvalidValue;
  return by_steps<8>(A, [&](auto k) {
    return launch_i8_knobs<decltype(k)::value>(
        static_cast<const int16_t*>(rf), static_cast<const int8_t*>(h),
        static_cast<float*>(out), C, A, S, scale, tile_s, row_warps,
        static_cast<cudaStream_t>(stream));
  });
}

// float32 rf (C, A, S), int8 h (A, A) with entries +-1, float32 out
// (C, A, S); 0 < A <= 256.
extern "C" int decode_f32(const void* rf, const void* h, void* out, int C,
                          int A, int S, float scale, void* stream) {
  if (!valid(C, A, S)) return (int)cudaErrorInvalidValue;
  return by_steps<8>(A, [&](auto k) {
    return launch_f32<decltype(k)::value>(
        static_cast<const float*>(rf), static_cast<const int8_t*>(h),
        static_cast<float*>(out), C, A, S, scale, static_cast<cudaStream_t>(stream));
  });
}

// Whether the int16 kernel's knobs (tile_s, row_warps) have a kernel for
// order A that fits in kMaxSmem, into *fits (0 or 1).
extern "C" int decode_fits(int A, int tile_s, int row_warps, void* fits) {
  if (A <= 0 || A > kMaxOrder) return (int)cudaErrorInvalidValue;
  return by_steps<8>(A, [&](auto k) {
    size_t smem = 0;
    by_i8_tile(tile_s, row_warps, [&](auto wn, auto wm) {
      smem = I8Tiles<decltype(k)::value, kI8Decode, decltype(wn)::value,
                     decltype(wm)::value, 0>::kSmem;
      return 0;
    });
    *static_cast<int*>(fits) = smem > 0 && smem <= kMaxSmem;
    return 0;
  });
}
