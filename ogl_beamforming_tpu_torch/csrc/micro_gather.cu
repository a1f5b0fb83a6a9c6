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
// What bounds it: instruction issue and shared-memory wavefronts, not
// device memory.  The DAS kernels gather every tap through __ldg from device
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
// K7 (ids 12-16; the slope of its REPS sweep is the port's cycles per warp
// gather) and the K8/K9 bundle (ids 18, 17) run on `gather_walk_kernel`:
// the same persistent grid, runs of units split on the host, one bulk copy
// of what the variant gathers and step 0 storing, with 12 warps a block and
// a unit of 32 elements of a step, one a lane.  Every K7 variant and the K9
// bundle read consecutive words of the element's own row, from one
// repetition (bundle) to the next: word (idx + origin + k) & 127 at walk
// word k, origin -1 (`idx_fresh`, `unpack`, `hermite_pair`) or 0.  So each
// staged row is held in four copies shifted by 0-3 words (copy c holds word
// (k + c) & 127 at word k; 32 quads of 16 bytes, then its first four quads
// again), and an element reads its walk as 16-byte loads from the copy that
// starts a quad at its first word: 4 words a load, a turn of 4 quads per
// plane, wrapped at 32 quads.  A 16-byte load is served a quarter-warp (8
// consecutive lanes) at a time over the 8 bank groups of 16 bytes; all
// lanes move on together, so an element's group at its first load fixes
// its conflicts for the whole walk.  Each block deals the elements to lanes
// from the idx tile before its first unit (`deal_lanes`: a counting sort by
// that group, then sorted position i to quarter-warp i % 256), so a
// quarter-warp's 8 loads fall in distinct groups as far as the groups'
// sizes allow, and writes each lane slot's element, index and weight into
// a table in shared memory.
//
// The keep-test is a range of walk words worked out once a unit: a word is
// kept before end = 128 - idx - origin (and word 0 only if idx + origin >=
// 0).  A weight is selected once a quad: a quad is kept whole if it ends by
// end, else multiplied by 0, so the quad that end falls inside adds +-0 in
// the walk; after the walk a fix-up takes that quad again and adds its kept
// words, each by its own compare.  Every later word added +-0, so each
// chain's sum is the in-order one (x + -0 = x, and a chain is never -0).
// Masked words are gathered and multiplied by 0 as the function does; the
// fix-up's quad is work beyond the function's (3 bundles a unit).  The
// int16 halves (`half16`): the value plane's hi half through one I2F.S16
// (16 lanes a clock an SM, so it takes only a quarter of the halves), every
// other half by the exponent trick: one integer instruction puts it in the
// mantissa of a float near 2^23 and one exact FADD takes that float away
// (the lo half, staged biased by XOR 0x8000, ORed under 2^23 by LOP3; the
// signed hi half added to 1.5 x 2^23 by LEA.HI); the slope plane's halves
// under 2^22 instead, which halves them exactly, so one weight serves all
// four products of a bundle.  K8's bundle reads five words of row 0 a
// walk: its weights and halves are taken once, and its multiply-adds run
// two bundles of an offset back to back (`k8_units`).  The __ldg forms
// gather 4-byte words through __ldg in walk order, lanes in element order,
// and stage nothing.
//
// In each, a repetition loop runs eight repetitions (or a turn of quads) at
// a time, unrolled, so every chain index is a constant of the unrolled body
// and the chains stay in registers.  Integer halves are split without a
// signed left shift: lo = (int16_t)(v & 0xFFFF), hi = v >> 16 (arithmetic);
// the floor kernel's keep-test is the unsigned compare (unsigned)rr < 128.
// Variants that only gather and add are bit-equal to the plain version;
// multiply-adds may contract to FMA (the walk's are FMAs), which moves a
// result by an ulp.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;
constexpr int kLane = 128;
constexpr int kTile = kRows * kLane;
constexpr int kChains = 8;

enum Variant {
  K5_CLIP, K5_MOD, K5_RAW, K5_FMA,
  K6_F32_DIRECT, K6_I32_DIRECT, K6_BCAST_HOIST, K6_BCAST_CHUNK,
  K6_IDX_FRESH, K6_UNPACK, K6_HERMITE_PAIR, K6_HERMITE_SAME_SRC,
  K7_FMA, K7_F32_DIRECT, K7_IDX_FRESH, K7_UNPACK, K7_HERMITE_PAIR,
  K9_BUNDLE, K8_BUNDLE,
  kVariants
};

// int32 sources; the others are float32 (kept as their bits)
__host__ __device__ constexpr bool int_src(int v) {
  return v == K6_I32_DIRECT || v == K6_BCAST_HOIST || v == K6_BCAST_CHUNK ||
         v == K6_IDX_FRESH || v == K6_UNPACK || v == K6_HERMITE_PAIR ||
         v == K6_HERMITE_SAME_SRC || v == K7_UNPACK || v == K7_HERMITE_PAIR ||
         v == K9_BUNDLE || v == K8_BUNDLE;
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

// One repetition r (j = r & 7, a constant of the unrolled loop) of K5/K6
// variant V on one element: its index `idx`, weight `w`, own source value
// `own`.
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
  } else if (V == K6_IDX_FRESH || V == K6_UNPACK) {
    const int rr = idx + (j & 3) - 1;
    const bool sel = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
    const float wsel = sel ? w : 0.0f;
    const int v = a(gr, rr & (kLane - 1));
    if (V == K6_IDX_FRESH) return acc + wsel * value<V>(v);
    return acc + wsel * hi16(v) + wsel * lo16(v);
  } else {  // K6_HERMITE_PAIR, K6_HERMITE_SAME_SRC
    if (j & 1) return acc;   // two gathers per position: r counts gathers
    const int rr = idx + (j & 3) - 1;
    const bool sel = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane);
    const float wp = sel ? w : 0.0f;
    const float wm = sel ? w * 0.5f : 0.0f;
    const int rc = rr & (kLane - 1);
    const int vp = a(gr, rc);
    const int vm = V == K6_HERMITE_SAME_SRC ? a(gr, rc + 1) : b(gr, rc);
    return acc + wp * hi16(vp) + wm * hi16(vm) + wp * lo16(vp) + wm * lo16(vm);
  }
}

// ---------------------------------------------------------------------------
// K5 and K6: the persistent floor kernel.

constexpr int kFloorVariants = K7_FMA;   // ids 0-11
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

// ---------------------------------------------------------------------------
// K7 and the K8/K9 gather bundle: the walk kernel.

constexpr int kWalkFirst = K7_FMA;       // ids 12-16 (K7); 17, 18 the bundle
constexpr int kWalkThreads = 384;        // 12 warps a block
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kWalkMinBlocks = 2;        // resident a SM, at most 80 registers
constexpr int kWalkUnitsPerStep = kTile / 32;   // a unit: 32 elements, one a lane
constexpr int kTurnQuads = 4;            // 16-byte quads a turn of the walk reads
constexpr int kCopies = 4;               // a staged row's copies, shifted 0-3 words
constexpr int kCopyQuads = kLane / 4 + kTurnQuads;   // a copy: 32 quads, then
                                                     // its first kTurnQuads again
constexpr int kGroups = 8;               // 16-byte bank groups
constexpr int kQuarters = kTile / kGroups;   // quarter-warps a step
constexpr bool kSpreadLanes = true;      // lanes dealt by bank group
constexpr int kHiI2F = 0x0F;            // bit 4 plane + quad: hi halves through I2F
constexpr int kMaxWalkSteps = (1 << 30) / kWalkUnitsPerStep;
static_assert(kWalkWarps >= kGroups, "a warp ranks each group");

// What a walk variant gathers: the planes (src, and src2 for the bundle and
// `hermite_pair`), the offset of its first word from idx, and its chains.
__host__ __device__ constexpr int walk_planes(int v) {
  return v == K7_FMA ? 0
         : (v == K7_HERMITE_PAIR || v == K9_BUNDLE || v == K8_BUNDLE) ? 2 : 1;
}
__host__ __device__ constexpr int walk_origin(int v) {
  return (v == K7_IDX_FRESH || v == K7_UNPACK || v == K7_HERMITE_PAIR) ? -1 : 0;
}
__host__ __device__ constexpr int walk_chains(int v) {
  return (v == K7_HERMITE_PAIR || v == K9_BUNDLE || v == K8_BUNDLE) ? 4 : 8;
}
// The variants that walk the element's own row through shifted copies (K8
// reads five words of row 0; `fma` gathers nothing).
__host__ __device__ constexpr bool walks(int v) {
  return v != K7_FMA && v != K8_BUNDLE;
}
// The words of one element's walk: `count` is REPS (K7) or UNITS (K9).
__host__ __device__ constexpr int walk_words(int v, int count) {
  return v == K7_HERMITE_PAIR ? count / 2 : v == K9_BUNDLE ? 2 * count : count;
}

// The dynamic shared memory of an instantiation: the shifted copies (plane,
// row, copy, kCopyQuads quads), the lane table (a slot's element, its index
// and its weight) and the dealing's scratch; or K8's row 0 of both planes.
template <int V, bool SMEM>
struct WalkSmem {
  static constexpr bool kCopied = SMEM && walks(V);
  static constexpr bool kSpread = kCopied && kSpreadLanes;
  static constexpr bool kStaged = SMEM && walk_planes(V) > 0;
  static constexpr int kCopyBytes = kCopyQuads * 16;
  static constexpr int kRowBytes = kCopies * kCopyBytes;
  static constexpr int kPlaneBytes = kCopied ? kRows * kRowBytes : kLane * 4;
  static constexpr int kTable = kStaged ? walk_planes(V) * kPlaneBytes : 0;
  static constexpr int kGroup = kTable + (kCopied ? kTile * 8 : 0);
  static constexpr int kRank = kGroup + (kSpread ? kTile : 0);
  static constexpr int kCount = kRank + (kSpread ? kTile * 2 : 0);
  static constexpr int kBytes = kCount + (kSpread ? kGroups * 4 : 0);
};

// Thread 0 starts the block's staging onto the mbarrier `bar`, warp 0 issues
// it: each gathered row by one bulk copy, into copy 0 of its row (walks) or
// packed (K8's row 0).
template <int V>
__device__ __forceinline__ void walk_stage_issue(const int* src, const int* src2,
                                                 unsigned char* s,
                                                 unsigned long long* bar) {
  using L = WalkSmem<V, true>;
  constexpr int kStagedRows = walks(V) ? kRows : 1;
  constexpr unsigned kBytes = kLane * sizeof(int);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       smem_addr(bar)),
                   "r"(walk_planes(V) * kStagedRows * kBytes)
                   : "memory");
    __syncwarp();
    const int l = threadIdx.x;
    if (l < walk_planes(V) * kStagedRows) {
      const int p = l / kStagedRows, r = l % kStagedRows;
      bulk_copy(s + p * L::kPlaneBytes + r * L::kRowBytes, (p ? src2 : src) + r * kLane,
                kBytes, bar);
    }
  }
}

// The 16-byte bank group of an element's first load: its copy's first quad,
// plus the quad its walk starts at (every lane's loads then move on together).
template <int V>
__device__ __forceinline__ int walk_group(int ix, int row) {
  const int s = (ix + walk_origin(V)) & (kLane - 1);
  return ((row * kCopies + (s & 3)) * kCopyQuads + (s >> 2)) & (kGroups - 1);
}

// The element-to-lane table of a step, from the idx tile: a stable counting
// sort of the elements by bank group (warp g ranks group g's elements by
// ballot), and sorted position i dealt to lane i / kQuarters of quarter-warp
// i % kQuarters, so a quarter-warp's 8 elements are 256 apart in the sorted
// order and lie in distinct groups where the groups' sizes allow.  Slot
// p * 32 + l (lane l of part p) holds its element e | idx << 16 and its
// weight, so a unit reads its lanes' inputs from shared memory; without
// kSpreadLanes (`lane_identity`) slot e holds element e.
template <int V>
__device__ __forceinline__ void deal_lanes(const int* idx, const float* w, unsigned char* s) {
  using L = WalkSmem<V, true>;
  auto table = reinterpret_cast<uint2*>(s + L::kTable);
  auto slot = [&](int i, int e) {
    table[i] = make_uint2(static_cast<unsigned>(e | idx[e] << 16), __float_as_uint(w[e]));
  };
  if constexpr (!kSpreadLanes) {
    for (int e = threadIdx.x; e < kTile; e += kWalkThreads) slot(e, e);
    return;
  }
  auto group = s + L::kGroup;
  auto rank = reinterpret_cast<unsigned short*>(s + L::kRank);
  auto count = reinterpret_cast<int*>(s + L::kCount);
  for (int e = threadIdx.x; e < kTile; e += kWalkThreads)
    group[e] = static_cast<unsigned char>(walk_group<V>(idx[e], e / kLane));
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp < kGroups) {
    int n = 0;
    for (int k = 0; k < kTile; k += 32) {
      const bool mine = group[k + lane] == warp;
      const unsigned ball = __ballot_sync(~0u, mine);
      if (mine) rank[k + lane] = n + __popc(ball & ((1u << lane) - 1));
      n += __popc(ball);
    }
    if (lane == 0) count[warp] = n;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile; e += kWalkThreads) {
    int pos = rank[e];
    for (int g = 0; g < group[e]; ++g) pos += count[g];
    slot((pos % kQuarters) * kGroups + pos / kQuarters, e);
  }
}

// Whether the hi halves of plane p read in quad q of a turn (of a chain
// period in the tail, fix-up and K8's form: q = 0) go through I2F.
__host__ __device__ constexpr bool hi_i2f(int p, int q) {
  return (kHiI2F >> (4 * p + q % kTurnQuads)) & 1;
}
// The bias of a staged integer word: the lo half XOR 0x8000, for the
// exponent trick; the hi half stays signed, for either route.
__host__ __device__ constexpr unsigned word_bias(int v) {
  return int_src(v) ? 0x8000u : 0u;
}

// Copies 1-3 of each staged row and copy 0's repeat of its first quads,
// from copy 0 as the bulk copy left it: copy c holds word (k + c) & 127 at
// word k, biased (word_bias).
template <int V>
__device__ __forceinline__ void build_copies(unsigned char* s) {
  using L = WalkSmem<V, true>;
  constexpr int kRowWords = L::kRowBytes / 4, kCopyWords = L::kCopyBytes / 4;
  constexpr bool kBiased = word_bias(V) != 0;
  auto w = reinterpret_cast<unsigned*>(s);
  for (int i = threadIdx.x; i < walk_planes(V) * kRows * kRowWords; i += kWalkThreads) {
    const int row = i / kRowWords, c = i % kRowWords / kCopyWords, k = i % kCopyWords;
    if (c > 0 || k >= kLane)
      w[i] = w[row * kRowWords + ((k + c) & (kLane - 1))] ^ word_bias(V);
  }
  if (kBiased) {
    __syncthreads();
    for (int i = threadIdx.x; i < walk_planes(V) * kRows * kLane; i += kWalkThreads)
      w[i / kLane * kRowWords + i % kLane] ^= word_bias(V);
  }
}

// Exponent words, read as variables: kept in a register, not folded into
// each instruction.  lo halves: 2^23 (the value plane), 2^22 (the slope
// plane); hi halves: 1.5 x 2^23, 1.5 x 2^22.
__constant__ unsigned kExpWords[4] = {0x4B000000u, 0x4A800000u, 0x4B400000u, 0x4AC00000u};

// An int16 half (hi: bits 16-31, else 0-15) of a staged word of plane P as
// float, the slope plane's (P = 1) halved, except through I2F.  By the
// exponent trick, one integer instruction and one exact FADD: the biased lo
// half ORed under 2^23 (2^22) is 2^23 + h + 2^15 (halved; LOP3); the
// signed hi half added to 1.5 x 2^23 (2^22) stays in its binade, 1.5 x 2^23
// + h (halved; LEA.HI.SX32).  Through I2F (kI2F, hi halves alone): one
// I2F.S16 of the signed half, unhalved (the caller halves the slope
// plane's weight).  I2F takes one issue slot against the trick's two but
// runs at 16 lanes a clock an SM, so kHiI2F sends the value plane's hi
// halves through it, half the hi halves; `convert_i2f` and
// `convert_magic` (experiments/gather_ab) send all of them, or none, and
// both run slower.
template <int P, bool kHi, bool kI2F = false>
__device__ __forceinline__ float half16(unsigned v) {
  if constexpr (kHi && kI2F) {
    float f;
    asm("{.reg .b16 l, h;\nmov.b32 {l, h}, %1;\ncvt.rn.f32.s16 %0, h;}" : "=f"(f) : "r"(v));
    return f;
  } else if constexpr (kHi) {
    const unsigned bits = kExpWords[2 + P] + (static_cast<int>(v) >> 16);
    return __fsub_rn(__uint_as_float(bits), P ? 6291456.0f : 12582912.0f);
  } else {
    const unsigned bits = (v & 0xFFFFu) | kExpWords[P];
    return __fsub_rn(__uint_as_float(bits), P ? 4210688.0f : 8421376.0f);
  }
}

// Where an element's walk reads: in shared memory its copy (`copy`: the one
// whose quads start at its first word) and the byte of its current quad
// (`pb`, wrapped at 32 quads); through __ldg its rows and its current word.
template <int V, bool SMEM>
struct Walker {
  const unsigned char* copy;
  unsigned pb;
  const int* ra;
  const int* rb;
  int pos;
  __device__ __forceinline__ uint4 quad(int plane, int t) const {
    if constexpr (SMEM) {
      return *reinterpret_cast<const uint4*>(
          copy + plane * WalkSmem<V, SMEM>::kPlaneBytes + pb + 16 * t);
    } else {
      constexpr unsigned bias = word_bias(V);
      const int* r = plane ? rb : ra;
      const int k = pos + 4 * t;
      return {__ldg(r + (k & (kLane - 1))) ^ bias,
              __ldg(r + ((k + 1) & (kLane - 1))) ^ bias,
              __ldg(r + ((k + 2) & (kLane - 1))) ^ bias,
              __ldg(r + ((k + 3) & (kLane - 1))) ^ bias};
    }
  }
  __device__ __forceinline__ void advance(int quads) {
    if constexpr (SMEM) pb = (pb + 16 * quads) & (kLane * 4 - 1);
    else pos += 4 * quads;
  }
};

__device__ __forceinline__ unsigned word_of(const uint4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// How a stretch of a walk selects its weights (the kept words are a range
// of walk words, [lo, hi) relative to the stretch's first word): each quad
// by one compare (kByQuad: kept where the quad ends by hi, so the quad the
// range ends inside adds +-0 there and the fix-up adds its kept words after
// the walk; kByQuadLead: and word 0 masked where lo is 1, idx 0 at offset
// -1), or, in the fix-up, each word by its own (kFixUp: kept where lo <= word
// < hi; a quad's last word never is, hi - lo being at most 3, and is left
// out).
enum Select { kByQuad, kByQuadLead, kFixUp };

// Q quads of a walk, from a word that is a multiple of the chains: word
// 4t + j of the stretch into chain (4t + j) % chains.  A masked word is
// gathered and multiplied all the same, by a weight of 0.
template <int V, int Q, bool SMEM, Select S>
__device__ __forceinline__ void walk_turn(float (&acc)[kChains], const Walker<V, SMEM>& wk,
                                          int lo, int hi, float w) {
  uint4 a[Q], b[Q];
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    a[t] = wk.quad(0, t);
    if constexpr (walk_planes(V) == 2) b[t] = wk.quad(1, t);
  }
#pragma unroll
  for (int t = 0; t < Q; ++t) {
    const float wq = 4 * t + 4 <= hi ? w : 0.0f;
    const bool i2f_a = hi_i2f(0, t), i2f_b = hi_i2f(1, t);   // constants once unrolled
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * t + j;
      const unsigned va = word_of(a[t], j);
      float& c = acc[kk % walk_chains(V)];
      if constexpr (V == K7_F32_DIRECT) {
        c = __fadd_rn(c, __uint_as_float(va));
      } else {
        if (S == kFixUp && j == 3) continue;
        const float ws = S == kFixUp ? (kk >= lo && kk < hi ? w : 0.0f)
                         : S == kByQuadLead && kk == 0 && lo ? 0.0f : wq;
        if constexpr (V == K7_IDX_FRESH) {
          c = __fmaf_rn(ws, __uint_as_float(va), c);
        } else if constexpr (V == K7_UNPACK) {
          c = __fmaf_rn(ws, i2f_a ? half16<0, true, true>(va) : half16<0, true>(va), c);
          c = __fmaf_rn(ws, half16<0, false>(va), c);
        } else {   // the cubic-tap bundle: wp hi(vp), wm hi(vm), wp lo(vp), wm lo(vm)
          const unsigned vb = word_of(b[t], j);
          c = __fmaf_rn(ws, i2f_a ? half16<0, true, true>(va) : half16<0, true>(va), c);
          c = __fmaf_rn(i2f_b ? __fmul_rn(ws, 0.5f) : ws,
                        i2f_b ? half16<1, true, true>(vb) : half16<1, true>(vb), c);
          c = __fmaf_rn(ws, half16<0, false>(va), c);
          c = __fmaf_rn(ws, half16<1, false>(vb), c);
        }
      }
    }
  }
}

// K8's bundle over N units from a unit that is a multiple of 4: unit u's
// position p reads offset u + p into chain (2u + p) & 3.  The two bundles
// at one offset run term by term back to back (ws, h: each offset's weight
// and converted halves, taken once a walk).
template <int N>
__device__ __forceinline__ void k8_units(float (&acc)[kChains], const float (&ws)[5],
                                         const float (&h)[4][5]) {
#pragma unroll
  for (int off = 0; off <= N; ++off) {
#pragma unroll
    for (int term = 0; term < 4; ++term) {   // hi(vp), hi(vm) / 2, lo(vp), lo(vm) / 2
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int u = off - 1 + b, p = 1 - b;
        if (u < 0 || u >= N) continue;
        float& c = acc[(2 * u + p) & 3];
        c = __fmaf_rn(ws[off], h[term][off], c);
      }
    }
  }
}

// Lane `lane`'s element of unit u (part u % 64 of its step), its index and
// its weight: from the lane table, or in element order from the tiles.
struct Elem {
  int e, ix;
  float w;
};

template <bool kTabled>
__device__ __forceinline__ Elem walk_elem(const uint2* table, const int* idx,
                                          const float* w, unsigned u, int lane) {
  const int i = (u % kWalkUnitsPerStep) * 32 + lane;
  if constexpr (kTabled) {
    const uint2 d = table[i];
    return {static_cast<int>(d.x & 0xFFFF), static_cast<int>(d.x >> 16),
            __uint_as_float(d.y)};
  }
  return {i, idx[i], w[i]};
}

template <int V, bool SMEM>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
gather_walk_kernel(const int* __restrict__ src, const int* __restrict__ src2,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   float* __restrict__ out, int count, int turns, int tail,
                   int base, int extra, float sentinel) {
  using L = WalkSmem<V, SMEM>;
  extern __shared__ __align__(128) unsigned char s_walk[];
  __shared__ __align__(8) unsigned long long s_bar;
  if constexpr (L::kStaged) walk_stage_issue<V>(src, src2, s_walk, &s_bar);
  if constexpr (L::kCopied) deal_lanes<V>(idx, w, s_walk);
  if constexpr (L::kStaged) {
    stage_wait(&s_bar);
    if constexpr (L::kCopied) build_copies<V>(s_walk);
    __syncthreads();
  }
  const auto table = reinterpret_cast<const uint2*>(s_walk + L::kTable);

  const int lane = threadIdx.x % 32;
  const int warp = blockIdx.x * kWalkWarps + threadIdx.x / 32;
  unsigned u = warp * base + min(warp, extra);
  const unsigned end = u + base + (warp < extra ? 1 : 0);
  Elem next{};
  if (u < end) next = walk_elem<L::kCopied>(table, idx, w, u, lane);
  for (; u < end; ++u) {
    const int e = next.e, ix = next.ix;
    const float wv = next.w;
    if (u + 1 < end) next = walk_elem<L::kCopied>(table, idx, w, u + 1, lane);
    float acc[kChains];
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[c] = 0.0f;
    if constexpr (V == K7_FMA) {
#pragma unroll 1   // a trip is one turn of 8: kernels/sass reads its count
      for (int rb = 0; rb < count; rb += kChains) {
#pragma unroll
        for (int j = 0; j < kChains; ++j)
          acc[j] = acc[j] + wv * (wv + static_cast<float>(rb + j));
      }
    } else if constexpr (V == K8_BUNDLE) {
      const unsigned* rows = reinterpret_cast<const unsigned*>(s_walk);
      float ws[5], h[4][5];
#pragma unroll
      for (int off = 0; off < 5; ++off) {
        const int rr = ix + off;
        const int rc = rr & (kLane - 1);
        ws[off] = static_cast<unsigned>(rr) < static_cast<unsigned>(kLane) ? wv : 0.0f;
        const unsigned va = (SMEM ? rows[rc] : __ldg(src + rc)) ^ word_bias(V);
        const unsigned vb = (SMEM ? rows[kLane + rc] : __ldg(src2 + rc)) ^ word_bias(V);
        h[0][off] = hi_i2f(0, 0) ? half16<0, true, true>(va) : half16<0, true>(va);
        h[1][off] = hi_i2f(1, 0) ? __fmul_rn(half16<1, true, true>(vb), 0.5f)
                                 : half16<1, true>(vb);
        h[2][off] = half16<0, false>(va);
        h[3][off] = half16<1, false>(vb);
      }
#pragma unroll 1   // turns of 4 units, then a tail of 2: kernels/sass counts both
      for (int t = 0; t < turns; ++t) k8_units<4>(acc, ws, h);
#pragma unroll 1
      for (int t = 0; t < tail; ++t) k8_units<2>(acc, ws, h);
    } else {
      // The walk: its first chain period (idx 0 at offset -1 masks word
      // 0), then turns of kTurnQuads quads and a tail of periods, quad by
      // quad; a word is kept before end = 128 - idx - origin.  Then the
      // fix-up: the period holding the quad that end falls inside, its
      // words from that quad's first to end, word by word.  The quad added
      // +-0 in its turn and every later word adds +-0, so each chain's sum
      // is the one taken in order (x + -0 = x; a chain is never -0).
      constexpr int kPeriod = walk_chains(V) / 4;   // quads of a chain period
      const int row = static_cast<unsigned>(e) / kLane;
      const int s = (ix + walk_origin(V)) & (kLane - 1);
      const Walker<V, SMEM> start{s_walk + (row * kCopies + (s & 3)) * L::kCopyBytes,
                                  static_cast<unsigned>(s >> 2) * 16u, src + row * kLane,
                                  src2 + row * kLane, s};
      const int end = kLane - ix - walk_origin(V);
      Walker<V, SMEM> wk = start;
      walk_turn<V, kPeriod, SMEM, kByQuadLead>(acc, wk, ix + walk_origin(V) < 0, end, wv);
      wk.advance(kPeriod);
      int d = end - 4 * kPeriod;
#pragma unroll 1   // turns of kTurnQuads quads, then a tail: kernels/sass counts both
      for (int t = 0; t < turns; ++t) {
        walk_turn<V, kTurnQuads, SMEM, kByQuad>(acc, wk, 0, d, wv);
        wk.advance(kTurnQuads);
        d -= 4 * kTurnQuads;
      }
#pragma unroll 1
      for (int t = 0; t < tail; ++t) {
        walk_turn<V, kPeriod, SMEM, kByQuad>(acc, wk, 0, d, wv);
        wk.advance(kPeriod);
        d -= 4 * kPeriod;
      }
      if constexpr (V != K7_F32_DIRECT) {
        const int qb = end / 4;
        const bool fix = end % 4 && qb < kPeriod * (1 + tail) + kTurnQuads * turns;
        const int p0 = fix ? qb / kPeriod * kPeriod : 0;
        Walker<V, SMEM> wf = start;
        wf.advance(p0);
        walk_turn<V, kPeriod, SMEM, kFixUp>(acc, wf, fix ? 4 * (qb - p0) : 0,
                                          fix ? end - 4 * p0 : 0, wv);
      }
    }
    float sum = acc[0];
#pragma unroll
    for (int c = 1; c < walk_chains(V); ++c) sum = sum + acc[c];
    const bool keep = u < kWalkUnitsPerStep || sum == sentinel;   // step 0 stores
    if (keep) out[e] = sum;
  }
}

// The launch of a walk variant: the persistent grid (the occupancy query with
// the instantiation's dynamic shared memory, taken once a process), each
// warp's run of units, and the turns and tail of each walk for `count`
// (REPS for K7, UNITS for the bundle).
struct WalkLaunch {
  int per_sm, grid, base, extra, turns, tail, smem;
};

template <int V, bool SMEM>
int walk_launch(int steps, int count, WalkLaunch* wl) {
  struct Occupancy {
    int per_sm, sms;
    cudaError_t err;
  };
  constexpr int kBytes = WalkSmem<V, SMEM>::kBytes;
  static const Occupancy occ = [] {
    Occupancy o{0, 0, cudaSuccess};
    int device = 0;
    o.err = cudaGetDevice(&device);
    if (o.err == cudaSuccess)
      o.err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, device);
    if (o.err == cudaSuccess)
      o.err = cudaFuncSetAttribute(gather_walk_kernel<V, SMEM>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (o.err == cudaSuccess)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.per_sm, gather_walk_kernel<V, SMEM>, kWalkThreads, kBytes);
    return o;
  }();
  if (occ.err != cudaSuccess) return (int)occ.err;
  if (occ.per_sm < 1 || occ.sms < 1) return (int)cudaErrorInvalidConfiguration;
  const int units = steps * kWalkUnitsPerStep;
  const int need = (units + kWalkWarps - 1) / kWalkWarps;
  const int grid = occ.per_sm * occ.sms < need ? occ.per_sm * occ.sms : need;
  const int warps = grid * kWalkWarps;
  int turns = 0, tail = 0;
  if (V == K8_BUNDLE) {
    turns = count / 4;
    tail = count % 4 / 2;
  } else if (V != K7_FMA) {   // after the first chain period
    const int period = walk_chains(V) / 4;
    const int quads = walk_words(V, count) / 4 - period;
    turns = quads / kTurnQuads;
    tail = quads % kTurnQuads / period;
  }
  *wl = {occ.per_sm, grid, units / warps, units % warps, turns, tail, kBytes};
  return 0;
}

template <int V, bool SMEM>
int walk_run(const int* s, const int* s2, const int* ix, const float* wv, float* o,
             int count, int steps, cudaStream_t st) {
  WalkLaunch wl;
  const int err = walk_launch<V, SMEM>(steps, count, &wl);
  if (err) return err;
  gather_walk_kernel<V, SMEM><<<wl.grid, kWalkThreads, wl.smem, st>>>(
      s, s2, ix, wv, o, count, wl.turns, wl.tail, wl.base, wl.extra,
      __builtin_nanf(""));
  return (int)cudaGetLastError();
}

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
    if (steps > kMaxWalkSteps) return (int)cudaErrorInvalidValue;
    return visit<kWalkFirst, K9_BUNDLE>(variant, [&](auto v) {
      return walk_run<decltype(v)::value, SMEM>(s, s2, ix, wv, o, reps, steps, st);
    });
  });
}

// The launch micro_gather (ids below K9_BUNDLE) or micro_gather_hermite (K9
// id 17, K8 id 18) makes for `variant` at `steps`, without launching: the
// blocks of its kernel a SM holds (`per_sm`) and its grid.
extern "C" int micro_gather_grid(int variant, int smem, int steps, int* per_sm,
                                 int* grid) {
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  return with_smem(smem, [&](auto sm) {
    constexpr bool SMEM = decltype(sm)::value;
    if (variant < kFloorVariants) {
      if (steps > kMaxSteps) return (int)cudaErrorInvalidValue;
      return visit<0, kFloorVariants>(variant, [&](auto v) {
        FloorLaunch fl;
        const int err = floor_launch<decltype(v)::value, SMEM>(steps, &fl);
        if (err) return err;
        *per_sm = fl.per_sm;
        *grid = fl.grid;
        return 0;
      });
    }
    if (steps > kMaxWalkSteps) return (int)cudaErrorInvalidValue;
    return visit<kWalkFirst, kVariants>(variant, [&](auto v) {
      WalkLaunch wl;
      const int err = walk_launch<decltype(v)::value, SMEM>(steps, kChains, &wl);
      if (err) return err;
      *per_sm = wl.per_sm;
      *grid = wl.grid;
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
  if (units <= 0 || units % 2 || steps <= 0 || steps > kMaxWalkSteps)
    return (int)cudaErrorInvalidValue;
  return with_smem(smem, [&](auto sm) {
    constexpr bool SMEM = decltype(sm)::value;
    return k8 ? walk_run<K8_BUNDLE, SMEM>(s, s2, ix, wv, o, units, steps, st)
              : walk_run<K9_BUNDLE, SMEM>(s, s2, ix, wv, o, units, steps, st);
  });
}
