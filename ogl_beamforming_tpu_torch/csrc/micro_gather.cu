// Gather-floor microbenchmarks for Hopper (sm_90a).
//
// Replaces the TPU microbenchmark kernels of experiments/gather_micro.py
// (K5: `kernel`, `kernel_fma`), experiments/gather_micro2.py (K6: `kernel`),
// experiments/gather_micro3.py (K7: `kernel`) and the gather bundle of
// experiments/onehot_micro.py (K8: `gather_kernel`) and onehot_micro2.py
// (K9: `make_gather.kernel`).  Each computes one (16, 128) float32 tile: per
// element, `reps` repetitions of a variant's bundle (index arithmetic, a
// gather of a (16, 128) source row at a per-element index, unpacking,
// multiply-adds) into 8 accumulator chains `accs[r & 7]` (4 chains
// `accs[(2u + pos) & 3]` for the cubic-tap bundle), then the chains summed
// left to right, as the TPU bodies write it.  The TPU ran `steps` grid
// steps in order, each recomputing the tile into one output block that it
// wrote back once; here every (step, element) is computed, and its result
// is stored or compared with a runtime value (below), so no step's work can
// be dropped.
//
// What bounds it: instruction issue, not memory.  A gather is one
// shared-memory load (LDS) per thread, whose 32 lanes hit random banks of
// one row, so a warp-wide gather costs one LDS issue plus its bank-conflict
// replays.  The DAS kernels gather every tap through __ldg from device
// memory (csrc/das.cu), so each variant is built twice: SMEM = true gathers
// the tile staged in shared memory (the analogue of a VMEM-resident tile),
// SMEM = false gathers the same tile through __ldg.  The function is the
// same; only the memory space differs.
//
// K5 and K6 (`gather_floor_kernel`, variant ids 0-11): a persistent grid,
// the blocks the card holds at once (occupancy API), at most the blocks
// whose warps have a unit.  A unit is one row of one step, taken by one
// warp, lane l the 16-byte word (4 elements) (l + step) % 32 of the row, so
// a thread's set-up outside the repetition loop, which cost more issue than
// the adds when a thread took two elements, is paid over many; a warp reads and
// writes each row as 16-byte words, and a lane's element moves on with the
// step: a thread's units are consecutive, so it takes 2048 element-steps
// (512 units) before it meets an element again.  Each warp takes its run
// of units (the host splits them: `base` each, one more for the first
// `extra` warps), so a thread pays its set-up (block start, the staging
// wait, its run) once for all its units, and the next unit's index and
// weight words load while the current one's repetitions run.  Each block
// stages only what its variant gathers (`stage_planes`, `stage_rows`: no
// plane for `fma`, row 0 for the broadcast variants, both planes only for
// `hermite_pair`) with one bulk copy (cp.async.bulk) onto an mbarrier,
// issued before the first unit's loads; the __ldg forms stage nothing.
// Step 0's units store the tile, each element once; every other unit
// compares its 4 results with `sentinel`, a NaN the host passes, and would
// store them if one matched, which none can: the compiler must compute
// every result, and the output takes one write an element, as the TPU's.
// (Storing every step's tile, 512 warp stores of 512 bytes onto each of the
// same 16 rows, is the ablation `store_every` of experiments/gather_ab.)  K6's
// cubic-tap variants take their bundle's gathers and unpacking once a unit
// and pair their multiply-adds for the register file (`hermite_reps`).
//
// K7 (`gather_kernel`, ids 12-16, the slope of its REPS sweep is the port's
// cycles per warp gather) and the K8/K9 bundle (`hermite_kernel`) keep the
// first design: 1024 threads a block and a block a step, each thread owning
// elements (row, lane) and (row + 8, lane), every block staging both planes
// and storing its tile to the same output.
//
// In both, the repetition loop runs over `reps` (a multiple of 8) eight at
// a time, unrolled, so every `r & 7`, `r & 3`, `r % 2` is a constant of the
// unrolled body and the chains stay in registers.  Integer halves are split
// without a signed left shift: lo = (int16_t)(v & 0xFFFF), hi = v >> 16
// (arithmetic); the index keep-test is the unsigned compare (unsigned)rr <
// 128.  Variants that only gather and add are bit-equal to the plain
// version; multiply-adds may contract to FMA, which moves a result by an
// ulp.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kLane = 128;
constexpr int kTile = kRows * kLane;
constexpr int kThreads = 1024;
constexpr int kElems = kTile / kThreads;   // 2: rows r0 and r0 + 8
constexpr int kChains = 8;

enum Variant {
  K5_CLIP, K5_MOD, K5_RAW, K5_FMA,
  K6_F32_DIRECT, K6_I32_DIRECT, K6_BCAST_HOIST, K6_BCAST_CHUNK,
  K6_IDX_FRESH, K6_UNPACK, K6_HERMITE_PAIR, K6_HERMITE_SAME_SRC,
  K7_FMA, K7_F32_DIRECT, K7_IDX_FRESH, K7_UNPACK, K7_HERMITE_PAIR,
  kVariants
};

// int32 sources; the others are float32 (kept as their bits)
__host__ __device__ constexpr bool int_src(int v) {
  return v == K6_I32_DIRECT || v == K6_BCAST_HOIST || v == K6_BCAST_CHUNK ||
         v == K6_IDX_FRESH || v == K6_UNPACK || v == K6_HERMITE_PAIR ||
         v == K6_HERMITE_SAME_SRC || v == K7_UNPACK || v == K7_HERMITE_PAIR;
}

// gathers from row 0 broadcast to every row
__host__ __device__ constexpr bool bcast(int v) {
  return v == K6_BCAST_HOIST || v == K6_BCAST_CHUNK || v == K6_IDX_FRESH ||
         v == K6_UNPACK || v == K6_HERMITE_PAIR || v == K6_HERMITE_SAME_SRC;
}

// The source tile, in shared memory or read through __ldg.
template <bool SMEM>
struct Tile {
  const int* g;
  const int* s;
  __device__ __forceinline__ int operator()(int row, int ix) const {
    if (SMEM) return s[row * kLane + ix];
    return __ldg(g + row * kLane + ix);
  }
};

__device__ __forceinline__ float hi16(int v) { return static_cast<float>(v >> 16); }
__device__ __forceinline__ float lo16(int v) {
  return static_cast<float>(static_cast<int16_t>(v & 0xFFFF));
}

template <int V>
__device__ __forceinline__ float value(int bits) {
  return int_src(V) ? static_cast<float>(bits) : __int_as_float(bits);
}

// One repetition r (j = r & 7, a constant of the unrolled loop) of variant
// V on one element: its index `idx`, weight `w`, own source value `own`.
template <int V, bool SMEM>
__device__ __forceinline__ float step(float acc, int r, int j, int row,
                                      int idx, float w, float own,
                                      float fidx, const Tile<SMEM>& a,
                                      const Tile<SMEM>& b) {
  const int gr = bcast(V) ? 0 : row;
  if (V == K5_CLIP) {
    const int ix = min(max(idx + (j & 3), 0), kLane - 1);
    return acc + value<V>(a(gr, ix));
  } else if (V == K5_MOD || V == K6_F32_DIRECT || V == K6_I32_DIRECT ||
             V == K6_BCAST_HOIST) {
    return acc + value<V>(a(gr, (idx + (j & 3)) & (kLane - 1)));
  } else if (V == K5_RAW) {
    return acc + value<V>(a(gr, idx + (j & 3)));
  } else if (V == K5_FMA) {
    return acc + own * (fidx + static_cast<float>(r));
  } else if (V == K6_BCAST_CHUNK) {
    return acc + value<V>(a(gr, idx));
  } else if (V == K7_FMA) {
    return acc + w * (w + static_cast<float>(r));
  } else if (V == K7_F32_DIRECT) {
    return acc + value<V>(a(gr, (idx + r) & (kLane - 1)));
  } else if (V == K6_IDX_FRESH || V == K6_UNPACK || V == K7_IDX_FRESH ||
             V == K7_UNPACK) {
    const int rr = idx + ((V == K7_IDX_FRESH || V == K7_UNPACK)
                              ? r - 1 : (j & 3) - 1);
    const bool sel = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
    const float wsel = sel ? w : 0.0f;
    const int v = a(gr, rr & (kLane - 1));
    if (V == K6_IDX_FRESH || V == K7_IDX_FRESH) return acc + wsel * value<V>(v);
    return acc + wsel * hi16(v) + wsel * lo16(v);
  } else {  // K6_HERMITE_PAIR, K6_HERMITE_SAME_SRC, K7_HERMITE_PAIR
    if (j & 1) return acc;   // two gathers per position: r counts gathers
    const int rr = idx + (V == K7_HERMITE_PAIR ? r / 2 - 1 : (j & 3) - 1);
    const bool sel = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
    const float wp = sel ? w : 0.0f;
    const float wm = sel ? w * 0.5f : 0.0f;
    const int rc = rr & (kLane - 1);
    const int vp = a(gr, rc);
    const int vm = V == K6_HERMITE_SAME_SRC ? a(gr, rc + 1) : b(gr, rc);
    return acc + wp * hi16(vp) + wm * hi16(vm) + wp * lo16(vp) + wm * lo16(vm);
  }
}

template <bool SMEM>
__device__ __forceinline__ void stage(const int* src, const int* src2,
                                      int* s_a, int* s_b) {
  if (SMEM) {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      s_a[i] = src[i];
      s_b[i] = src2[i];
    }
    __syncthreads();
  }
}

template <int V, bool SMEM>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ src, const int* __restrict__ src2,
              const int* __restrict__ idx, const float* __restrict__ w,
              float* __restrict__ out, int reps) {
  __shared__ int s_a[SMEM ? kTile : 1];
  __shared__ int s_b[SMEM ? kTile : 1];
  stage<SMEM>(src, src2, s_a, s_b);
  const Tile<SMEM> a{src, s_a}, b{src2, s_b};
  const int lane = threadIdx.x % kLane;
  const int row0 = threadIdx.x / kLane;

  int ix[kElems];
  float wv[kElems], own[kElems], fidx[kElems], acc[kElems][kChains];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = (row0 + 8 * e) * kLane + lane;
    ix[e] = idx[i];
    wv[e] = w[i];
    own[e] = __int_as_float(src[i]);
    fidx[e] = static_cast<float>(ix[e]);
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[e][c] = 0.0f;
  }
  for (int rb = 0; rb < reps; rb += kChains) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        acc[e][j] = step<V, SMEM>(acc[e][j], rb + j, j, row0 + 8 * e, ix[e],
                                  wv[e], own[e], fidx[e], a, b);
    }
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    float s = acc[e][0];
#pragma unroll
    for (int c = 1; c < kChains; ++c) s = s + acc[e][c];
    out[(row0 + 8 * e) * kLane + lane] = s;
  }
}

// The DAS cubic-tap bundle over `units` units: per unit two positions, each
// an index, a keep-test, two int32 gathers (value and slope planes), the
// unpack and four multiply-adds into chain (2u + pos) & 3.  K8 gathers row
// 0 broadcast at offset pos + (u & 3); K9 its own row at pos + 2u.
template <bool K8, bool SMEM>
__global__ void __launch_bounds__(kThreads)
hermite_kernel(const int* __restrict__ src, const int* __restrict__ src2,
               const int* __restrict__ idx, const float* __restrict__ w,
               float* __restrict__ out, int units) {
  __shared__ int s_a[SMEM ? kTile : 1];
  __shared__ int s_b[SMEM ? kTile : 1];
  stage<SMEM>(src, src2, s_a, s_b);
  const Tile<SMEM> a{src, s_a}, b{src2, s_b};
  const int lane = threadIdx.x % kLane;
  const int row0 = threadIdx.x / kLane;

  int ix[kElems];
  float wv[kElems], acc[kElems][4];
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = (row0 + 8 * e) * kLane + lane;
    ix[e] = idx[i];
    wv[e] = w[i];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[e][c] = 0.0f;
  }
  for (int ub = 0; ub < units; ub += 2) {
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
#pragma unroll
      for (int pos = 0; pos < 2; ++pos) {
        const int u = ub + uu;
        const int off = K8 ? pos + (u & 3) : pos + 2 * u;
#pragma unroll
        for (int e = 0; e < kElems; ++e) {
          const int gr = K8 ? 0 : row0 + 8 * e;
          const int rr = ix[e] + off;
          const bool sel =
              static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
          const float wp = sel ? wv[e] : 0.0f;
          const float wm = sel ? wv[e] * 0.5f : 0.0f;
          const int rc = rr & (kLane - 1);
          const int vp = a(gr, rc), vm = b(gr, rc);
          float& c = acc[e][2 * uu + pos];
          c = c + wp * hi16(vp) + wm * hi16(vm) + wp * lo16(vp) + wm * lo16(vm);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kElems; ++e)
    out[(row0 + 8 * e) * kLane + lane] =
        acc[e][0] + acc[e][1] + acc[e][2] + acc[e][3];
}

// ---------------------------------------------------------------------------
// K5 and K6: the persistent floor kernel.

constexpr int kFloorVariants = K7_FMA;   // ids 0-11; K7 keeps gather_kernel
constexpr int kFloorThreads = 256;       // 8 warps a block
constexpr int kFloorWarps = kFloorThreads / 32;
constexpr int kFloorMinBlocks = 2;       // resident a SM, at most 128 registers
constexpr int kQuad = 4;                 // elements a lane takes of a unit
constexpr int kUnitElems = 32 * kQuad;   // a unit: one warp's elements
constexpr int kUnitsPerStep = kTile / kUnitElems;
constexpr int kPad = 4;                  // words past the staged planes
static_assert(kLane % kUnitElems == 0, "a unit lies in one row");

// What a K5/K6 variant's gathers read, and so all that its shared-memory
// form stages: the planes (0: none, 1: src, 2: src and src2) and the rows of
// each (kRows, or 1: row 0, which the broadcast variants read).  `fma`
// gathers nothing (it reads its own element), `hermite_same_src` reads word
// rc + 1 of row 0 (at most 128, a pad word, where its weight is 0).
__host__ __device__ constexpr int stage_planes(int v) {
  constexpr int kPlanesOf[kFloorVariants] = {1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 2, 1};
  return kPlanesOf[v];
}
__host__ __device__ constexpr int stage_rows(int v) {
  constexpr int kRowsOf[kFloorVariants] = {16, 16, 16, 0, 16, 16, 1, 1, 1, 1, 1, 1};
  return kRowsOf[v];
}
// K6's cubic-tap variants: a bundle every second repetition, so their odd
// chains take nothing and their +0.0 sums join no value (the join leaves
// them out).
__host__ __device__ constexpr bool hermite(int v) {
  return v == K6_HERMITE_PAIR || v == K6_HERMITE_SAME_SRC;
}

__host__ __device__ constexpr bool staging_follows_bcast() {
  for (int v = 0; v < kFloorVariants; ++v)
    if ((stage_planes(v) == 0) != (v == K5_FMA) ||
        (stage_planes(v) == 2) != (v == K6_HERMITE_PAIR) ||
        (v != K5_FMA && stage_rows(v) != (bcast(v) ? 1 : kRows)))
      return false;
  return true;
}
static_assert(staging_follows_bcast(), "stage what each variant gathers");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Thread 0 starts the block's one staging copy: kPlanes planes of kWords
// words (src, then src2) onto the mbarrier `bar`, and zeroes the pad.
template <int kPlanes, int kWords>
__device__ __forceinline__ void stage_issue(const int* src, const int* src2, int* s,
                                            unsigned long long* bar) {
  constexpr unsigned kBytes = kWords * sizeof(int);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
                 : "memory");
    for (int i = 0; i < kPad; ++i) s[kPlanes * kWords + i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"(kPlanes * kBytes)
                 : "memory");
    bulk_copy(s, src, kBytes, bar);
    if (kPlanes == 2) bulk_copy(s + kWords, src2, kBytes, bar);
  }
}

__device__ __forceinline__ void stage_wait(unsigned long long* bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// The first element of lane `lane`'s word of unit u: part u %
// kUnitsPerStep of step u / kUnitsPerStep, word (lane + step) % 32.
__device__ __forceinline__ int floor_offset(unsigned u, int lane) {
  return (u % kUnitsPerStep) * kUnitElems + kQuad * ((lane + u / kUnitsPerStep) % 32);
}

// A lane's kQuad consecutive elements, loaded and stored as one word.
template <typename T>
struct alignas(sizeof(T) * kQuad) Word {
  T v[kQuad];
};

// One unit's inputs of a lane: its indices, weights and own values.
struct Quad {
  Word<int> idx;
  Word<float> w, own;
};

__device__ __forceinline__ Quad load_quad(const int* src, const int* idx, const float* w,
                                          int e0) {
  return {*reinterpret_cast<const Word<int>*>(idx + e0),
          *reinterpret_cast<const Word<float>*>(w + e0),
          *reinterpret_cast<const Word<float>*>(src + e0)};   // own: `fma` alone
}

// K6's cubic-tap bundle over one unit's repetitions.  Its index, gathers,
// weights and unpacking depend on the offset (j & 3) - 1 alone: idx - 1 for
// chains 0 and 4, idx + 1 for chains 2 and 6, so they are taken once a
// unit; then each turn runs every multiply-add into both chains of its
// offset back to back, as explicit FMAs, so the second of each pair reads
// its weight and value from the operand reuse cache.  (As `step` writes
// it, the ablation `bundle_by_step` of experiments/gather_ab, the compiler
// hoists the products, and 30 of the loop's 64 adds read both sources from
// registers of one parity, one bank.)
template <int V, bool SMEM>
__device__ __forceinline__ void hermite_reps(float (&acc)[kQuad][kChains], int reps,
                                             const int* ix, const float* wv,
                                             const Tile<SMEM>& a, const Tile<SMEM>& b) {
  float wt[kQuad][2][2];   // (wp, wm) of each element and offset
  int vt[kQuad][2][2];     // the value and slope words gathered there
#pragma unroll
  for (int e = 0; e < kQuad; ++e) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int rr = ix[e] + 2 * o - 1;
      const bool sel = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
      const int rc = rr & (kLane - 1);
      wt[e][o][0] = sel ? wv[e] : 0.0f;
      wt[e][o][1] = sel ? wv[e] * 0.5f : 0.0f;
      vt[e][o][0] = a(0, rc);
      vt[e][o][1] = V == K6_HERMITE_SAME_SRC ? a(0, rc + 1) : b(0, rc);
    }
  }
#pragma unroll 1   // a trip is one turn of 8: kernels/sass reads its count
  for (int rb = 0; rb < reps; rb += kChains) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {   // wp hi(vp), wm hi(vm), wp lo(vp), wm lo(vm)
#pragma unroll
        for (int e = 0; e < kQuad; ++e) {
          const float w = wt[e][o][t & 1];
          const int v = vt[e][o][t & 1];
          const float h = t < 2 ? hi16(v) : lo16(v);
          acc[e][2 * o] = __fmaf_rn(w, h, acc[e][2 * o]);
          acc[e][2 * o + 4] = __fmaf_rn(w, h, acc[e][2 * o + 4]);
        }
      }
    }
  }
}

template <int V, bool SMEM>
__global__ void __launch_bounds__(kFloorThreads, kFloorMinBlocks)
gather_floor_kernel(const int* __restrict__ src, const int* __restrict__ src2,
                    const int* __restrict__ idx, const float* __restrict__ w,
                    float* __restrict__ out, int reps, int base, int extra,
                    float sentinel) {
  constexpr int kPlanes = SMEM ? stage_planes(V) : 0;
  constexpr int kWords = stage_rows(V) * kLane;
  __shared__ __align__(128) int s_tile[kPlanes ? kPlanes * kWords + kPad : 1];
  __shared__ __align__(8) unsigned long long s_bar;
  if constexpr (kPlanes > 0) stage_issue<kPlanes, kWords>(src, src2, s_tile, &s_bar);

  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kFloorWarps + threadIdx.x / 32;
  unsigned u = warp * base + min(warp, extra);
  const unsigned end = u + base + (warp < extra ? 1 : 0);
  Quad next{};
  if (u < end) next = load_quad(src, idx, w, floor_offset(u, lane));
  if constexpr (kPlanes > 0) stage_wait(&s_bar);
  const Tile<SMEM> a{src, s_tile}, b{src2, s_tile + (kPlanes == 2 ? kWords : 0)};

  for (; u < end; ++u) {
    const int e0 = floor_offset(u, lane);
    const int row = e0 / kLane;
    const Quad q = next;
    if (u + 1 < end) next = load_quad(src, idx, w, floor_offset(u + 1, lane));
    const int* ix = q.idx.v;
    const float* wv = q.w.v;
    const float* own = q.own.v;
    float fidx[kQuad], acc[kQuad][kChains];
#pragma unroll
    for (int e = 0; e < kQuad; ++e) {
      fidx[e] = static_cast<float>(ix[e]);
#pragma unroll
      for (int c = 0; c < kChains; ++c) acc[e][c] = 0.0f;
    }
    if constexpr (hermite(V)) {
      hermite_reps<V, SMEM>(acc, reps, ix, wv, a, b);
    } else {
#pragma unroll 1   // as in hermite_reps
      for (int rb = 0; rb < reps; rb += kChains) {
#pragma unroll
        for (int j = 0; j < kChains; ++j) {
#pragma unroll
          for (int e = 0; e < kQuad; ++e)
            acc[e][j] = step<V, SMEM>(acc[e][j], rb + j, j, row, ix[e], wv[e], own[e],
                                      fidx[e], a, b);
        }
      }
    }
    Word<float> sum;
    bool keep = u < kUnitsPerStep;   // step 0 stores the tile
#pragma unroll
    for (int e = 0; e < kQuad; ++e) {
      sum.v[e] = acc[e][0];
#pragma unroll
      for (int c = 1; c < kChains; ++c)
        if (!(hermite(V) && (c & 1))) sum.v[e] = sum.v[e] + acc[e][c];
      keep = keep || sum.v[e] == sentinel;
    }
    if (keep) *reinterpret_cast<Word<float>*>(out + e0) = sum;
  }
}

// The launch of a K5/K6 variant: the blocks the card holds at once (the
// occupancy query and the SM count of the current device, taken once a
// process), at most the ceil(units / 8) that the steps' units need, and the
// units a warp (`base`, one more for the first `extra` warps).
struct FloorLaunch {
  int per_sm, grid, base, extra;
};

template <int V, bool SMEM>
int floor_launch(int steps, FloorLaunch* fl) {
  struct Occupancy {
    int per_sm, sms;
    cudaError_t err;
  };
  static const Occupancy occ = [] {
    Occupancy o{0, 0, cudaSuccess};
    int device = 0;
    o.err = cudaGetDevice(&device);
    if (o.err == cudaSuccess)
      o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
    if (o.err == cudaSuccess)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.per_sm, gather_floor_kernel<V, SMEM>, kFloorThreads, 0);
    return o;
  }();
  if (occ.err != cudaSuccess) return (int)occ.err;
  if (occ.per_sm < 1 || occ.sms < 1) return (int)cudaErrorInvalidConfiguration;
  const int units = steps * kUnitsPerStep;
  const int need = (units + kFloorWarps - 1) / kFloorWarps;
  const int grid = occ.per_sm * occ.sms < need ? occ.per_sm * occ.sms : need;
  const int warps = grid * kFloorWarps;
  *fl = {occ.per_sm, grid, units / warps, units % warps};
  return 0;
}

// f(std::integral_constant<int, V>()) for variant V in [First, End).
template <int V, int End, typename F>
int visit(int variant, F&& f) {
  if (variant == V) return f(std::integral_constant<int, V>());
  if constexpr (V + 1 < End) return visit<V + 1, End>(variant, f);
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_smem(int smem, F&& f) {
  return smem ? f(std::true_type()) : f(std::false_type());
}

constexpr int kMaxSteps = (1 << 30) / kUnitsPerStep;   // a launch's units fit an int

}  // namespace

extern "C" int micro_gather(int variant, int smem, const void* src,
                            const void* src2, const void* idx, const void* w,
                            void* out, int reps, int steps, void* stream) {
  auto s = static_cast<const int*>(src);
  auto s2 = static_cast<const int*>(src2);
  auto ix = static_cast<const int*>(idx);
  auto wv = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (reps <= 0 || reps % kChains || steps <= 0)
    return (int)cudaErrorInvalidValue;
  return with_smem(smem, [&](auto sm) {
    constexpr bool SMEM = decltype(sm)::value;
    if (variant < kFloorVariants) {
      if (steps > kMaxSteps) return (int)cudaErrorInvalidValue;
      return visit<0, kFloorVariants>(variant, [&](auto v) {
        constexpr int V = decltype(v)::value;
        FloorLaunch fl;
        const int err = floor_launch<V, SMEM>(steps, &fl);
        if (err) return err;
        gather_floor_kernel<V, SMEM><<<fl.grid, kFloorThreads, 0, st>>>(
            s, s2, ix, wv, o, reps, fl.base, fl.extra, __builtin_nanf(""));
        return (int)cudaGetLastError();
      });
    }
    return visit<kFloorVariants, kVariants>(variant, [&](auto v) {
      gather_kernel<decltype(v)::value, SMEM><<<steps, kThreads, 0, st>>>(
          s, s2, ix, wv, o, reps);
      return (int)cudaGetLastError();
    });
  });
}

// The launch micro_gather makes for K5/K6 `variant` at `steps`, without
// launching: the blocks of its kernel a SM holds (`per_sm`) and its grid.
extern "C" int micro_gather_grid(int variant, int smem, int steps, int* per_sm,
                                 int* grid) {
  if (steps <= 0 || steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  return with_smem(smem, [&](auto sm) {
    return visit<0, kFloorVariants>(variant, [&](auto v) {
      FloorLaunch fl;
      const int err = floor_launch<decltype(v)::value, decltype(sm)::value>(steps, &fl);
      if (err) return err;
      *per_sm = fl.per_sm;
      *grid = fl.grid;
      return 0;
    });
  });
}

extern "C" int micro_gather_hermite(int k8, int smem, const void* src,
                                    const void* src2, const void* idx,
                                    const void* w, void* out, int units,
                                    int steps, void* stream) {
  auto s = static_cast<const int*>(src);
  auto s2 = static_cast<const int*>(src2);
  auto ix = static_cast<const int*>(idx);
  auto wv = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (units <= 0 || units % 2 || steps <= 0) return (int)cudaErrorInvalidValue;
  if (k8 && smem)
    hermite_kernel<true, true><<<steps, kThreads, 0, st>>>(s, s2, ix, wv, o, units);
  else if (k8)
    hermite_kernel<true, false><<<steps, kThreads, 0, st>>>(s, s2, ix, wv, o, units);
  else if (smem)
    hermite_kernel<false, true><<<steps, kThreads, 0, st>>>(s, s2, ix, wv, o, units);
  else
    hermite_kernel<false, false><<<steps, kThreads, 0, st>>>(s, s2, ix, wv, o, units);
  return (int)cudaGetLastError();
}
