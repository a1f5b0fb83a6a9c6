// The int8 tensor-core skeleton shared by the int16 Hadamard decode
// (decode.cu, K2) and the int8 probes (micro_i8.cu, K10 and K11).
//
// It computes, for int8 H (A x A) and C slabs X_c (A x S), the products
// H @ X_c on mma.sync.m16n8k32 (s8 x s8 -> s32), one body per use:
//   kI8Decode  X int16 = 256 hi + lo + 128 (hi = X >> 8, lo = (X & 255) -
//              128, both int8): out = float(256 P_hi + P_lo + 128
//              rowsum(H)) * scale, exact (K2; K11 `full`).
//   kI8Hi      X int16: out = float(P_hi), no row sum and no scale (K11
//              `dot`).
//   kI8PairI32, kI8PairF32
//              X int8 (K10's B): a b16 element holds two adjacent columns
//              as an int16 of X holds its hi and lo bytes, so the same two
//              byte permutes give the fragments of columns 2n and 2n+1;
//              out = the int32 products, stored as int32 or float32.
//
// The pieces:
//   * H, staged once per block as int8 zero-padded to a multiple of 32 (the
//     MMA's K; the zero columns cancel whatever the padded rows of an X tile
//     hold), with its columns in the k_column order below, byte by byte.
//     k_column keeps each 16-byte half of a 32-deep step in place, so a
//     block that owns a row group (ROWS != 0, K10), where A is a multiple of
//     16, stages its rows by 16-byte loads and four byte permutes instead.
//   * Tiles of X (all A rows, 16 WN bytes of columns) by 16-byte cp.async
//     into a ring of three stages, the next two tiles' copies in flight
//     while this one computes.  A ragged tile is copied element by element
//     and zero-filled.
//   * ldmatrix.x4.trans on the b16 view of the tile gives each thread two
//     K-consecutive b16 elements of one column per register; two __byte_perm
//     gather their high and their low bytes into one B register each (thread
//     t's register holds tile rows 2t, 2t+1, 2t+8, 2t+9, which the MMA reads
//     as K = 4t .. 4t+3: the k_column order).
//   * 16-byte streaming stores: kI8Decode and kI8Hi shuffle between
//     neighbouring threads to give each thread four consecutive samples of
//     one row; the pair bodies hold four consecutive columns as they are.
//
// Geometry: a block of WN x WM warps takes units of (row group, slab, tile).
// Its warp (wn, wm) computes columns 16 wn .. 16 wn + 15 bytes of the tile
// for the m-tiles wm, wm + WM, .. of its row group of ROWS rows (0: all of
// them).  A block stages only its group's rows of H and walks its group's
// tiles with a stride of the blocks per group (persistent where the tiles
// outnumber the blocks the card holds).  The decode's geometry is WN = 8,
// WM = 1, one group: the row-group terms fold away at compile time and H
// is staged byte by byte.  K10 at its small size splits rows and columns
// over many short blocks, since its time is one block's latency chain.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

enum I8Body { kI8Decode, kI8Hi, kI8PairI32, kI8PairF32 };

constexpr int kI8Stages = 3;      // X tiles in the ring
constexpr int kMaxDevices = 16;   // launch facts cached per device

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int d[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The column of H that sits at logical K position `l` of a 32-deep step:
// thread t's B register 0 holds tile rows 2t, 2t+1, 2t+8, 2t+9 (ldmatrix
// matrices 0 and 1), register 1 the same plus 16 (matrices 2 and 3), while
// the MMA reads them as K = 4t .. 4t+3 (and + 16).
__device__ __forceinline__ int k_column(int l) {
  const int half = l / 16, q = l % 16, t = q / 4, i = q % 4;
  return half * 16 + 8 * (i / 2) + 2 * t + (i % 2);
}

// Shapes of one instantiation of the skeleton over elements of type T.
template <int KSTEPS, int BODY, int WN, int WM, int ROWS>
struct I8Tiles {
  using T = std::conditional_t<BODY == kI8PairI32 || BODY == kI8PairF32, int8_t,
                               int16_t>;
  static constexpr int kPad = KSTEPS * 32;           // A padded to the MMA's K
  static constexpr int kRows = ROWS ? ROWS : kPad;   // rows of H a block owns
  static constexpr int kThreads = 32 * WN * WM;
  static constexpr int kCols = 16 * WN / (int)sizeof(T);  // columns of a tile
  static constexpr int kPitch = 16 * WN + 16;        // padded tile row, bytes
  static constexpr int kStage = kPad * kPitch;
  static constexpr int kHRow = kPad + 16;            // padded H row, bytes
  static constexpr size_t kSmem = (size_t)kI8Stages * kStage +
                                  (size_t)kRows * kHRow +
                                  (BODY == kI8Decode ? kRows * sizeof(int) : 0);
  static_assert(kRows % 16 == 0 && kRows <= kPad, "ROWS: m-tiles of H's rows");
};

// The skeleton, run by one block: see the notes at the top.  Launch with
// I8Tiles<..>::kThreads threads, kSmem bytes of dynamic shared memory and a
// grid that is a multiple of the row groups, ceil(A / kRows).
template <int KSTEPS, int BODY, int WN, int WM, int ROWS>
__device__ __forceinline__ void i8_tiles(
    const typename I8Tiles<KSTEPS, BODY, WN, WM, ROWS>::T* __restrict__ x,
    const int8_t* __restrict__ h, void* __restrict__ out, int C, int A, int S,
    float scale, bool vec_in, bool vec_out) {
  using G = I8Tiles<KSTEPS, BODY, WN, WM, ROWS>;
  using T = typename G::T;
  constexpr int kPad = G::kPad, kRows = G::kRows, kCols = G::kCols;
  constexpr int kPitch = G::kPitch, kStage = G::kStage, kHRow = G::kHRow;
  constexpr int kVec = 16 / (int)sizeof(T);   // columns a 16-byte copy
  constexpr bool kTwo = BODY != kI8Hi;        // a second product per tile
  constexpr bool kPair = BODY == kI8PairI32 || BODY == kI8PairF32;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* s_x = smem;          // kI8Stages stages of kPad x 16 WN bytes
  int8_t* s_h = reinterpret_cast<int8_t*>(smem + kI8Stages * kStage);  // kRows x kHRow
  int* s_rs = reinterpret_cast<int*>(smem + kI8Stages * kStage + kRows * kHRow);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wn = WM == 1 ? warp : warp % WN, wm = WM == 1 ? 0 : warp / WN;
  const int groups = ROWS ? (A + kRows - 1) / kRows : 1;
  const int row0 = (blockIdx.x % groups) * kRows;
  const int first = blockIdx.x / groups, step = gridDim.x / groups;
  const int tiles = (S + kCols - 1) / kCols;
  const int units = C * tiles;
  if (first >= units) return;

  // Bring tile `u` (slab u / tiles, columns (u % tiles) * kCols ..) into
  // stage `st`: rows j < A, 16 bytes a copy.  Rows A .. kPad are never
  // written: H's zero columns cancel whatever they hold.
  auto load = [&](int u, int st) {
    const int c = u / tiles, s0 = (u % tiles) * kCols;
    unsigned char* dst = s_x + st * kStage;
    for (int i = tid; i < A * (kCols / kVec); i += G::kThreads) {
      const int j = i / (kCols / kVec), s = s0 + kVec * (i % (kCols / kVec));
      const T* src = x + ((size_t)c * A + j) * S + s;
      T* d = reinterpret_cast<T*>(dst + j * kPitch + (s - s0) * (int)sizeof(T));
      if (vec_in && s + kVec <= S) {
        cp_async16(d, src);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) d[e] = s + e < S ? src[e] : T(0);
      }
    }
  };

  // the first kI8Stages - 1 tiles, one copy group each
  for (int i = 0; i < kI8Stages - 1; ++i) {
    const int u = first + i * step;
    if (u < units) load(u, i);
    cp_async_commit();
  }

  // H's rows row0 .. row0 + kRows, once per block: logical column l of step
  // k holds H[:, 32 k + k_column(l)], zero outside A x A.
  bool vec_h = false;
  if constexpr (ROWS != 0)
    vec_h = A % 16 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  if (vec_h) {
    // 16 bytes a row at a time: logical word w of a 16-byte half holds the
    // half's bytes 2w, 2w+1, 2w+8, 2w+9
    for (int i = tid; i < kRows * (kPad / 16); i += G::kThreads) {
      const int t = i / (kPad / 16), q = i % (kPad / 16), r = row0 + t;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < A && 16 * q < A) v = *reinterpret_cast<const uint4*>(h + r * A + 16 * q);
      *reinterpret_cast<uint4*>(s_h + t * kHRow + 16 * q) =
          make_uint4(__byte_perm(v.x, v.z, 0x5410), __byte_perm(v.x, v.z, 0x7632),
                     __byte_perm(v.y, v.w, 0x5410), __byte_perm(v.y, v.w, 0x7632));
    }
  } else {
    for (int i = tid; i < kRows * kPad; i += G::kThreads) {
      const int t = i / kPad, l = i % kPad, r = row0 + t;
      const int j = (l / 32) * 32 + k_column(l % 32);
      s_h[t * kHRow + l] = (r < A && j < A) ? h[r * A + j] : int8_t(0);
    }
  }
  if constexpr (BODY == kI8Decode) {
    // 128 rowsum(H) per row
    for (int t = tid; t < kRows; t += G::kThreads) {
      const int r = row0 + t;
      int sum = 0;
      if (r < A)
        for (int j = 0; j < A; ++j) sum += h[r * A + j];
      s_rs[t] = 128 * sum;
    }
  }

  const int m_tiles = ((ROWS ? min(kRows, A - row0) : A) + 15) / 16;
  int st = 0;
  for (int u = first; u < units; u += step) {
    const int ahead = u + (kI8Stages - 1) * step;
    if (ahead < units) load(ahead, (st + kI8Stages - 1) % kI8Stages);
    cp_async_commit();
    cp_async_wait<kI8Stages - 1>();   // tile u has landed
    __syncthreads();

    // B fragments of this warp's 16 bytes of columns over all of K: p from
    // the high bytes of each b16 element, q from the low ones
    const unsigned char* tile = s_x + st * kStage;
    unsigned bp[KSTEPS][2], bq[KSTEPS][2];
#pragma unroll
    for (int k = 0; k < KSTEPS; ++k) {
      unsigned r[4];
      ldmatrix_x4_trans(r, tile + (32 * k + lane) * kPitch + wn * 16);
      bp[k][0] = __byte_perm(r[0], r[1], 0x7531);
      bp[k][1] = __byte_perm(r[2], r[3], 0x7531);
      if constexpr (kTwo) {
        // the decode's lo = (X & 255) - 128 flips the low byte's top bit
        const unsigned flip = BODY == kI8Decode ? 0x80808080u : 0u;
        bq[k][0] = __byte_perm(r[0], r[1], 0x6420) ^ flip;
        bq[k][1] = __byte_perm(r[2], r[3], 0x6420) ^ flip;
      }
    }

    // the lane's first column: of four consecutive samples of one row after
    // the decode's shuffle, or of its four consecutive columns (pairs)
    const int c = u / tiles;
    const int s = (u % tiles) * kCols + wn * kVec + (kPair ? 4 * tig : 4 * (tig / 2));
    const bool odd = tig & 1;
    for (int mt = wm; mt < m_tiles; mt += WM) {
      int p[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
      const int8_t* hr = s_h + (mt * 16 + gid) * kHRow + 4 * tig;
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        unsigned a[4];
        a[0] = *reinterpret_cast<const unsigned*>(hr + 32 * k);
        a[1] = *reinterpret_cast<const unsigned*>(hr + 8 * kHRow + 32 * k);
        a[2] = *reinterpret_cast<const unsigned*>(hr + 32 * k + 16);
        a[3] = *reinterpret_cast<const unsigned*>(hr + 8 * kHRow + 32 * k + 16);
        mma_s8(p, a, bp[k][0], bp[k][1]);
        if constexpr (kTwo) mma_s8(q, a, bq[k][0], bq[k][1]);
      }
      // thread (gid, tig) holds rows gid, gid + 8 at MMA columns 2 tig,
      // 2 tig + 1 of the tile's group of 8
      const int r0 = mt * 16 + gid;
      if constexpr (!kPair) {
        float f[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (BODY == kI8Decode)
            f[i] = static_cast<float>(256 * p[i] + q[i] + s_rs[r0 + 8 * (i / 2)]) * scale;
          else
            f[i] = static_cast<float>(p[i]);
        }
        // even threads take row gid, odd ones row gid + 8, four samples each
        const float g0 = __shfl_xor_sync(0xffffffffu, odd ? f[0] : f[2], 1);
        const float g1 = __shfl_xor_sync(0xffffffffu, odd ? f[1] : f[3], 1);
        const float4 v = make_float4(odd ? g0 : f[0], odd ? g1 : f[1],
                                     odd ? f[2] : g0, odd ? f[3] : g1);
        const int row = row0 + r0 + (odd ? 8 : 0);
        if (row < A) {
          float* dst = static_cast<float*>(out) + ((size_t)c * A + row) * S + s;
          if (vec_out && s + 4 <= S) {
            __stcs(reinterpret_cast<float4*>(dst), v);
          } else {
            const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (s + i < S) dst[i] = e[i];
          }
        }
      } else {
        // MMA column n is b16 column n: q holds column 2n, p column 2n + 1,
        // so the thread holds columns 4 tig .. 4 tig + 3 of both rows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row0 + r0 + 8 * half;
          if (row >= A) continue;
          const int e[4] = {q[2 * half], p[2 * half], q[2 * half + 1], p[2 * half + 1]};
          const size_t o = ((size_t)c * A + row) * S + s;
          if constexpr (BODY == kI8PairI32) {
            int* dst = static_cast<int*>(out) + o;
            if (vec_out && s + 4 <= S) {
              __stcs(reinterpret_cast<int4*>(dst), make_int4(e[0], e[1], e[2], e[3]));
            } else {
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (s + i < S) dst[i] = e[i];
            }
          } else {
            float* dst = static_cast<float*>(out) + o;
            const float4 v = make_float4(static_cast<float>(e[0]), static_cast<float>(e[1]),
                                         static_cast<float>(e[2]), static_cast<float>(e[3]));
            if (vec_out && s + 4 <= S) {
              __stcs(reinterpret_cast<float4*>(dst), v);
            } else {
              const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
                if (s + i < S) dst[i] = f[i];
            }
          }
        }
      }
    }
    __syncthreads();   // stage st is free for the copy kI8Stages - 1 tiles on
    st = (st + 1) % kI8Stages;
  }
}

// The blocks of `kernel` that the card holds at once, at most `want`, a
// multiple of `multiple`.  The dynamic shared memory attribute, the SM count
// and the occupancy query are taken once per device and kept in `cache`
// (one per kernel instantiation; 0 until then), not on every launch.
template <typename Kernel>
int persistent_grid(Kernel kernel, std::atomic<int> (&cache)[kMaxDevices], int threads,
                    size_t smem, long long want, int multiple, int* grid) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int resident = device < kMaxDevices ? cache[device].load(std::memory_order_relaxed) : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
    if (device < kMaxDevices) cache[device].store(resident, std::memory_order_relaxed);
  }
  long long g = resident;
  if (g > want) g = want;
  g -= g % multiple;
  *grid = (int)(g < multiple ? multiple : g);
  return 0;
}

// One launch of `kernel`, an instantiation of i8_tiles for the shapes G, on
// int8 h (A x A) and C slabs x (A x S) into out (C x A x S); `cache` as in
// persistent_grid.
template <typename G, typename Kernel>
int launch_i8_tiles(Kernel kernel, std::atomic<int> (&cache)[kMaxDevices],
                    const typename G::T* x, const int8_t* h, void* out, int C, int A,
                    int S, float scale, cudaStream_t stream) {
  const int groups = (A + G::kRows - 1) / G::kRows;
  const long long units = (long long)C * ((S + G::kCols - 1) / G::kCols);
  int grid = 0;
  const int err = persistent_grid(kernel, cache, G::kThreads, G::kSmem, units * groups,
                                  groups, &grid);
  if (err) return err;
  const bool vec_in = (S * sizeof(typename G::T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = S % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<grid, G::kThreads, G::kSmem, stream>>>(x, h, out, C, A, S, scale, vec_in,
                                                  vec_out);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, K>()) for K = ceil(A / 32), the 32-deep
// steps of an order-A contraction, A <= 32 MAXSTEPS.
template <int MAXSTEPS, typename F>
int by_steps(int A, F f) {
  switch ((A + 31) / 32) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: if constexpr (MAXSTEPS >= 5) return f(std::integral_constant<int, 5>());
            break;
    case 6: if constexpr (MAXSTEPS >= 6) return f(std::integral_constant<int, 6>());
            break;
    case 7: if constexpr (MAXSTEPS >= 7) return f(std::integral_constant<int, 7>());
            break;
    case 8: if constexpr (MAXSTEPS >= 8) return f(std::integral_constant<int, 8>());
            break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
