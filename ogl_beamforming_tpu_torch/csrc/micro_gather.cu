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
// steps in order, each recomputing the tile; here each step is a block, and
// every block stores its tile to the same output (identical values), so no
// step's work can be dropped.
//
// What bounds it: instruction issue, not memory.  The tile is read once per
// block from L2; a gather is one shared-memory load (LDS) per thread, whose
// 32 lanes hit random banks of one row, so a warp-wide gather costs one LDS
// issue plus its bank-conflict replays.  The DAS kernels gather every tap
// through __ldg from device memory (csrc/das.cu), so each variant is built
// twice: SMEM = true gathers the tile staged in shared memory (the analogue
// of a VMEM-resident tile), SMEM = false gathers the same tile through
// __ldg.  The function is the same; only the memory space differs.
//
// Design: 1024 threads a block, each owning elements (row, lane) and
// (row + 8, lane), so a warp is 32 lanes of one row.  The repetition loop
// runs over `reps` (a multiple of 8) eight at a time, unrolled, so every
// `r & 7`, `r & 3`, `r % 2` is a constant of the unrolled body and the
// chains stay in registers.  Integer halves are split without a signed
// left shift: lo = (int16_t)(v & 0xFFFF), hi = v >> 16 (arithmetic); the
// index keep-test is the unsigned compare (unsigned)rr < 128.  Variants that
// only gather and add are bit-equal to the plain version; multiply-adds may
// contract to FMA, which moves a result by an ulp.

#include <cstdint>
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

template <int V, bool SMEM>
int dispatch(int variant, const int* src, const int* src2, const int* idx,
             const float* w, float* out, int reps, int steps,
             cudaStream_t stream) {
  if (variant == V) {
    gather_kernel<V, SMEM><<<steps, kThreads, 0, stream>>>(src, src2, idx, w,
                                                          out, reps);
    return (int)cudaGetLastError();
  }
  if constexpr (V + 1 < kVariants)
    return dispatch<V + 1, SMEM>(variant, src, src2, idx, w, out, reps, steps,
                                 stream);
  return (int)cudaErrorInvalidValue;
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
  return smem ? dispatch<0, true>(variant, s, s2, ix, wv, o, reps, steps, st)
              : dispatch<0, false>(variant, s, s2, ix, wv, o, reps, steps, st);
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
