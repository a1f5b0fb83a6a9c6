// FORCES-, HERCULES- and RCA-family delay-and-sum for Hopper (sm_90a).
//
// das_forces_kernel replaces the `forces` branch of the TPU kernel
// ogl_beamforming_tpu/ops/das_pallas.py::_das_kernel (pallas_call in
// _das_call; delays from _forces_delay, taps from _interp_weights):
// FORCES, UFORCES (sparse transmits) and READI (grouped transmits with a
// Hadamard-row weight), every interpolation mode, real or IQ, optionally
// with the incoherent sum for coherency weighting.
//
//   out[v] = sum_c sum_j apod(v, c) * w_j * interp(rf[c, row_j], idx(v, c, j))
//   idx    = (|rx(v, c)| / c_0 + t_0) * fs  +  |tx(v, j)| * fs / c_0
//
// What bounds it on this card: instruction issue, not device memory (the
// decoded frame is 256 MiB and each channel's 2 MiB of RF stays in L2 while
// every voxel block sweeps it).  The Quickstart is 8.6 G (voxel, channel,
// transmit) candidates, 6.1 G inside the tap window; each active one costs
// one to four RF loads, the tap weights and the sum, and an IQ one a
// division and a full-range sincos as well.  The transmit leg
// |tx(v, j)| * fs / c_0 -- an IEEE square root, two products and a sum --
// depends on the voxel and the transmit only.
//
// What the design does about it: one thread per voxel, voxels in the output's
// C order so that neighbouring threads read neighbouring samples.  The
// transmit leg is computed once per (voxel, transmit), with the rounded
// operations and order of before, into a table in shared memory laid out
// [transmit][voxel] (each thread reads and writes only its own column: no
// bank conflicts and no barrier), 8 or 32 transmits a pass.  A pass of 32
// halves the receive terms' share of the work (they are recomputed once a
// pass), but its 16 KB a block take L1's room: where a warp's gathers are
// scattered (3D grids) the caller takes passes of 8 (ops/das_cuda.py); the
// receive terms (apodization, receive delay) are computed once per
// (voxel, channel, pass), and channels whose apodization mask is off are
// skipped entirely.  A pair then costs an add (receive index + table entry)
// and the window test before anything else, so a pair outside the tap
// window costs an add and two compares, not a square root.  The
// per-transmit tables (x position, weight, and the rf row as a 32-bit offset
// inside the channel, so a tap's address is not 64-bit arithmetic per pair)
// sit in shared memory.
// The IQ rotation stays per pair as the twin computes it (phase below): a
// cheaper phase with another rounding would move the result by about 1e-4
// at path B's indices.  kernels/sass.py counts the inner pair loop's SASS
// instructions of each instantiation.  None of the TPU kernel's scheduling
// machinery (tile activity tables, chunk bounds, int16 line packing) is
// carried over.
//
// Numerics follow the JAX package's exact-f32 XLA path (ops/das.py), not the
// Pallas kernel's approximations: the world point and the sample index are
// evaluated with explicitly rounded operations (__fmul_rn and friends, which
// the compiler never contracts into FMAs) in the same order as the plain
// twin, so the fractional index -- thousands of samples, where one ulp moves
// the interpolation point -- matches it bit for bit; sqrt and division are
// IEEE; nearest rounds half to even (rintf); no --use_fast_math.  The FORCES
// kernel's apodization cosine and IQ rotation are the full-range library
// cosf and sincosf.  The HERCULES and RCA kernels take the apodization's
// cosine with the hardware's __cosf, whose argument there lies in
// [0, pi/2) (inside the mask |f#| * distance / |z| < 1/2), and the IQ
// rotation with __sincosf after an exact reduction of the twin's phase
// argument to about [-pi, pi] (pair_weight): about 4e-7 of the sample either
// way, far inside the 1e-4 twin check; the weight is no index.
//
// das_hercules_kernel replaces the `hercules` branch of the same TPU kernel
// (delays from _hercules_delay, per-tile terms from _hercules_tile_terms,
// distances from _hercules_rx_d2 and _hercules_tx_d2): HERCULES, UHERCULES
// (sparse transmits, acquisition 0 skipped) and HERO_PA, every
// interpolation mode, real or IQ, optionally with the incoherent sum.
//
//   out[v] = sum_c sum_j w_j * cos^2(pi |f#/z| sqrt(d2)) * interp(rf[c, row_j], idx)
//   d2     = (lat_rx - ch * p_rx)^2 + (lat_tx - pos_j)^2,  kept where d2 < z^2 / (4 f#^2)
//   idx    = (tx0(v) / c_0 + t_0) * fs  +  sqrt(z^2 + d2) * fs / c_0
//
// with tx0 acquisition 0's plane or cylindrical transmit distance of the
// world point, and (lat_rx, lat_tx) the (x, y) of the XDC-space point when
// receiving on columns, (y, x) otherwise.  It follows the XLA path
// (ops/das.py::_hercules_block), not the Pallas kernel's u-form apodization;
// the per-transmit table comes from the twin's own ops/das.py::
// transmit_tables and acquisition 0's transmit geometry from its rca_tables.
//
// What bounds it on this card: the apodization is 2D, so a cosine, a square
// root and the interpolation are paid per (voxel, channel, transmit) triple
// inside the mask, not per (voxel, channel) as for FORCES.  HERCULES 96^3 at
// 128 x 128 is 14.5 G candidate triples of which 3.26 G pass the mask:
// operations, not bytes (the decoded 128 MiB frame streams through L2, each
// channel's 1 MiB swept by every voxel block).
//
// What the design does about it:
//  * only the transmits that can pass are walked.  The per-transmit table
//    (lateral position, weight, and the rf row as a 32-bit offset inside the
//    channel) is sorted by position once per plan (ops/das_cuda.py) and sits
//    in shared memory; per channel the walk takes the transmits whose
//    position lies within a widened radius of the voxel's (transmit_interval:
//    a binary search at the first channel, a few steps from the previous
//    channel's bounds after it), and inside it the twin's exact test
//    d2 < z^2 / (4 f#^2) keeps the twin's triples.  Walking the full table
//    instead is a launch argument, so the two can be timed against each
//    other.
//  * the lateral geometry is shared along a run of voxels whose XDC lateral
//    coordinates are bit-equal (decided once per plan from the transforms,
//    ops/das_cuda.py::lateral_run; a tilted grid gets runs of one voxel):
//    each thread takes kHerculesVoxels voxels of one run and pays the
//    receive and transmit distances, d2, sqrt(d2) and the table reads once
//    for all of them.  The mask test, cosine, index, taps and gathers stay
//    per voxel.
//  * a warp takes a tile of neighbouring voxels, kHerculesLanes depths of
//    each of eight runs a slot (at path C eight columns of one row), so that
//    its lanes' masks and samples are alike (a warp down one column was
//    slower).
//  * the apodization's square root is the hardware's (the weight is no
//    index) and its cosine __cosf on [0, pi/2); the index keeps its IEEE
//    square root, in the twin's order.
// Transmits within a channel are summed in position order, and each voxel's
// pairs go straight into its total (the twin sums a channel first).

// das_rca_kernel replaces the `rca` branch of the same TPU kernel (delays
// from _rca_delay, tables from _prep_scalars): Flash, RCA_TPW and RCA_VLS,
// with a per-acquisition orientation byte and focal vector.
//
//   out[v] = sum_a sum_c apod(v, a, c) * interp(rf[c, a], idx(v, a, c))
//   idx    = ((tx(v, a) + |recv(v, a, c)|) / c_0 + t_0) * fs
//
// with tx the plane-wave (inf depth) or cylindrical transmit distance of the
// world point and recv the (lateral, z) offset of the XDC-space point from
// the receiving row or column.  The index is the XLA path's
// ((tx + rlen) / c + t0) * fs, not the Pallas kernel's split
// tx_part + rlen * fs / c, evaluated with explicitly rounded operations in
// the plain twin's order; the per-acquisition sin, cos and focal point come
// from the twin's own table (ops/das.py::rca_tables), so the twin and the
// kernel start from the same float32 values.
//
// What bounds it on this card: the plane-wave headline (256 channels x 1
// acquisition x 4096 complex samples -> 524,288 voxels) is 134 M candidate
// pairs, 110 M inside the mask, each a receive leg (an IEEE square root and
// division), four complex RF loads and the IQ rotation (a division and a
// sincos); like FORCES that is instruction issue and L1/L2 traffic.  The
// frame is 8 MiB and stays in L2.
//
// What the design does about it: the mask is a product with the voxel's
// |f#| / |z| instead of a division (its weight is about 0 where the
// rounding could flip it), the apodization __cosf on [0, pi/2), the
// rotation __sincosf after the exact reduction of the twin's phase
// argument, and a frame's sample one weighted sum times the pair's complex
// weight.  The HERCULES kernel's runs and tiles set the order of threads:
// a thread takes kRcaVoxels voxel (sharing the receive element's lateral
// offset over more voxels along depth measured slower), and a warp 32
// lateral positions at one depth, consecutive warps across the grid (a
// warp along one line of depths was slower, with four frames a launch twice
// as slow), whose samples lie closer together.  The per-acquisition
// table (orientations, sin, cos, focal point, plane flag) sits in shared
// memory.

// Frame batches (the frame_batch of das_pallas): each kernel takes FB frames
// per launch, a template parameter of 1 or 4; rf is (FB, channels, rf_rows,
// S) and the output (FB, nx, ny, nz).  A pair's geometry -- index, mask,
// apodization, interpolation taps and IQ rotation -- is computed once and
// applied to all FB frames, each gathered and summed on its own in the
// single-frame order, so a frame of a batch equals a single-frame launch on
// it.  The kernels are bound by operations, not bytes, so the shared
// geometry is what a batch saves (the Pallas kernel's fb_pack form).

#include <climits>
#include <cuda_runtime.h>

namespace {

// Scalar layout prepared by ops/das_cuda.py::prepare
enum Scalar {
  kVT = 0,        // voxel transform rows 0..2, 12 values row-major
  kFs = 12, kSos, kT0, kFnum, kPx, kPy, kFd, kCh0, kX0,
  kXdc = 21,      // XDC transform rows 0..2, 12 values row-major
  kNumScalars = 33
};

// Columns of the RCA acquisition table (ops/das.py::rca_tables)
enum RcaColumn { kTxO = 0, kRxO, kSin, kCos, kFLat, kFZ, kPlane, kRcaWidth = 8 };
constexpr float kNoOrientation = 0.f;  // RCAOrientation.NoOrientation
constexpr float kRows = 1.f;           // RCAOrientation.Rows
constexpr float kColumns = 2.f;        // RCAOrientation.Columns

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kBlock = 128;
// das_forces_kernel: the most transmits per pass of its index table (chunk x
// kBlock floats of shared memory, at most 16 KB; the caller picks the pass),
// and the most transmits it takes (their per-transmit table, 12 bytes each,
// beside it in 48 KB of shared memory).
constexpr int kMaxTxChunk = 32;
constexpr int kMaxTransmits = 2048;
// das_hercules_kernel and das_rca_kernel: voxels a thread takes along a run
// of equal lateral coordinates.  Measured on an H100: HERCULES 96^3 ran
// fastest with 3 (2, 4, 6 and 8 slower: fewer voxels share less, more take
// registers and resident warps), the plane-wave RCA headline with 1 (2, 3,
// 4 and 8 slower, its shared part being a few operations of a pair), one
// and four frames a launch.
constexpr int kHerculesVoxels = 3;
constexpr int kRcaVoxels = 1;
// Their tiles of threads (thread_run), measured on an H100: HERCULES 96^3
// ran fastest with warps of 4 threads of each of 8 neighbouring columns
// (1, 2 and 32 slower), consecutive warps down the columns; the plane-wave
// RCA headline with warps of one voxel of each of 32 neighbouring lines of
// depths, consecutive warps across the lines (tiles of 2 to 32 down the
// lines slower).
constexpr int kHerculesLanes = 4;
constexpr bool kHerculesRunsFirst = false;
constexpr int kRcaLanes = 1;
constexpr bool kRcaRunsFirst = true;
// 2 pi split in three float32 parts for the exact phase reduction (Cody and
// Waite): hi is float32(2 pi), mid and lo the next bits.
// ops/das_cuda.py::TWO_PI_SPLIT holds the same values.
constexpr float kInvTwoPi = 0x1.45f306p-3f;
constexpr float kTwoPiHi = 0x1.921fb6p+2f;
constexpr float kTwoPiMid = -0x1.777a5cp-23f;
constexpr float kTwoPiLo = -0x1.ee59dap-48f;

enum Mode { kNearest = 0, kLinear = 1, kCubic = 2 };
enum Family { kForces = 0, kHercules = 1, kRca = 2 };  // ops/das_cuda.py::_FAMILY

template <bool IQ> struct Sample;
template <> struct Sample<false> {
  using type = float;
  __device__ static float zero() { return 0.f; }
};
template <> struct Sample<true> {
  using type = float2;
  __device__ static float2 zero() { return make_float2(0.f, 0.f); }
};

__device__ __forceinline__ float scale(float a, float x) { return a * x; }
__device__ __forceinline__ float2 scale(float a, float2 x) {
  return make_float2(a * x.x, a * x.y);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float magnitude(float v) { return fabsf(v); }
__device__ __forceinline__ float magnitude(float2 v) { return hypotf(v.x, v.y); }
__device__ __forceinline__ float rotate(float v, float, float) { return v; }
__device__ __forceinline__ float2 rotate(float2 v, float sn, float cs) {
  return make_float2(v.x * cs - v.y * sn, v.x * sn + v.y * cs);
}

// Interpolation taps at a fractional sample index: the first sample and the
// weights, shared by every frame of a batch.
struct Taps {
  int i;
  float c0, c1, c2, c3;
};

// The taps of `index`; false when outside the mode's validity window
// (das.glsl:64-122; JAX ops/das.py:_interpolate).
template <int MODE>
__device__ __forceinline__ bool make_taps(int S, float index, Taps& tp) {
  // The window is tested on the index itself, before anything else: for an
  // integer bound b, floor(index) >= b is index >= b and floor(index) < b is
  // index < b, so these tests are the floor-based ones of the twin.
  if (MODE == kNearest) {
    if (!(index >= 0.f)) return false;
    const float r = rintf(index);
    if (!(r < (float)S)) return false;
    tp.i = (int)r;
    return true;
  }
  if (MODE == kLinear) {
    if (!(index >= 0.f && index < (float)(S - 1))) return false;
    const float k = floorf(index);
    const float t = index - k;
    tp.i = (int)k;
    tp.c0 = 1.f - t;
    tp.c1 = t;
    return true;
  }
  if (!(index >= 1.f && index < (float)(S - 2))) return false;
  const float k = floorf(index);
  const float t = index - k;
  tp.i = (int)k;
  const float tt = t * t, ttt = tt * t;   // Catmull-Rom, C_SPLINE = 0.5
  tp.c0 = 2.f * ttt - 3.f * tt + 1.f;
  tp.c1 = -2.f * ttt + 3.f * tt;
  tp.c2 = ttt - 2.f * tt + t;
  tp.c3 = ttt - tt;
  return true;
}

// The sample of `line` at the taps.
template <int MODE, typename T>
__device__ __forceinline__ T gather(const T* __restrict__ line, const Taps& tp) {
  if (MODE == kNearest) return __ldg(line + tp.i);
  if (MODE == kLinear)
    return add(scale(tp.c0, __ldg(line + tp.i)), scale(tp.c1, __ldg(line + tp.i + 1)));
  const T p0 = __ldg(line + tp.i - 1), p1 = __ldg(line + tp.i);
  const T p2 = __ldg(line + tp.i + 1), p3 = __ldg(line + tp.i + 2);
  const T t1 = scale(0.5f, sub(p2, p0));
  const T t2 = scale(0.5f, sub(p3, p1));
  return add(add(scale(tp.c0, p1), scale(tp.c1, p2)),
             add(scale(tp.c2, t1), scale(tp.c3, t2)));
}

// Rows 0..2 of the 4x4 row-major matrix `m` applied to (x, y, z, 1), each
// row's terms added left to right (JAX ops/das.py:_apply_m4).
__device__ __forceinline__ void apply_m4(const float* m, float x, float y,
                                         float z, float w[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* r = m + 4 * i;
    w[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                               __fmul_rn(r[2], z)), r[3]);
  }
}

// Plane-wave or cylindrical transmit distance of the world point `w` for one
// row `t` of the RCA table (JAX ops/das.py:_rca_transmit_distance).
__device__ __forceinline__ float rca_tx_distance(const float* t, const float w[3]) {
  if (t[kTxO] == kNoOrientation) return 0.f;
  const float lat = t[kTxO] == kRows ? w[1] : w[0];
  if (t[kPlane] > 0.5f) return __fadd_rn(__fmul_rn(lat, t[kSin]), __fmul_rn(w[2], t[kCos]));
  const float d_lat = __fsub_rn(lat, t[kFLat]);
  const float d_z = __fsub_rn(w[2], t[kFZ]);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(d_lat, d_lat), __fmul_rn(d_z, d_z)));
}

// Arguments of one launch, as the C entry point receives them.
struct Args {
  const void* rf;          // (FB, channels, rf_rows, S) float or float2
  const float* sc;         // Scalar layout above
  const float* tab;        // RCA table (acquisitions, kRcaWidth); HERCULES reads row 0
  const float* tx_pos;     // (n_tx,) transmit lateral positions (FORCES, HERCULES)
  const float* tx_weight;  // (n_tx,) transmit weights
  const int* tx_row;       // (n_tx,) rf acquisition of each transmit
  void* out;               // (FB, nx, ny, nz) float or float2
  float* inco;             // (FB, nx, ny, nz) incoherent sums, or null
  int channels, channel_count, rf_rows, S;
  int n_tx;                // transmits (FORCES, HERCULES) or acquisitions (RCA)
  int tx_chunk;            // transmits per pass of the FORCES index table
  int nx, ny, nz, gnx, gny, gnz;
  int run;                 // HERCULES, RCA: consecutive voxels with equal
                           // XDC lateral coordinates (1: none shared)
  int tx_walk;             // HERCULES: 1 walks each channel's transmit
                           // interval, 0 the whole table
};

// World point of voxel `v` (C order over nx, ny, nz) of a slab starting at
// x offset sc[kX0] of the global grid (JAX ops/das.py:_world_points).
__device__ __forceinline__ void world_point(const Args& a, int v, float w[3]) {
  const int iz = v % a.nz, iy = (v / a.nz) % a.ny, ix = v / (a.nz * a.ny);
  const float* sc = a.sc;
  const float gx = __fdiv_rn(__fadd_rn((float)ix, sc[kX0]), fmaxf((float)a.gnx - 1.f, 1.f));
  const float gy = __fdiv_rn((float)iy, fmaxf((float)a.gny - 1.f, 1.f));
  const float gz = __fdiv_rn((float)iz, fmaxf((float)a.gnz - 1.f, 1.f));
  apply_m4(sc + kVT, gx, gy, gz, w);
}

// Per-frame sums of one thread: a channel's (or acquisition's) part, added
// into the frame's total when the channel ends, as the twin sums.
template <bool IQ, bool COH, int FB>
struct Sums {
  using T = typename Sample<IQ>::type;
  T v[FB];
  float inco[FB];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      v[f] = Sample<IQ>::zero();
      inco[f] = 0.f;
    }
  }
  // One pair: frame f's sample at the shared taps, rotated and weighted.
  template <int MODE>
  __device__ __forceinline__ void pair(const T* __restrict__ line, size_t frame,
                                       const Taps& tp, float sn, float cs, float weight) {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      T val = scale(weight, rotate(gather<MODE>(line + f * frame, tp), sn, cs));
      v[f] = add(v[f], val);
      if (COH) inco[f] += magnitude(val);
    }
  }
  __device__ __forceinline__ void flush_into(Sums& total) const {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      total.v[f] = add(total.v[f], v[f]);
      if (COH) total.inco[f] += inco[f];
    }
  }
  __device__ __forceinline__ void store(const Args& a, int v_index) const {
    const size_t voxels = (size_t)a.nx * a.ny * a.nz;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      static_cast<T*>(a.out)[f * voxels + v_index] = v[f];
      if (COH) a.inco[f * voxels + v_index] = inco[f];
    }
  }
};

// The IQ rotation exp(+j 2 pi f_d index / fs) of a pair, (sin, cos); the
// identity for real data.
template <bool IQ>
__device__ __forceinline__ void phase(float two_pi_fd, float index, float fs,
                                      float& sn, float& cs) {
  sn = 0.f;
  cs = 1.f;
  if constexpr (IQ) sincosf(__fmul_rn(two_pi_fd, __fdiv_rn(index, fs)), &sn, &cs);
}

// The HERCULES and RCA kernels' arithmetic after the index: every product
// and sum explicitly rounded (FMAs where written), so that the compiler
// contracts nothing and every instantiation -- one frame or four a launch --
// rounds a frame's samples alike.  The taps come as one weight per sample,
// computed once per pair, and the apodization rides on the IQ rotation, so
// that a frame costs its gathers, one weighted sum and one complex
// multiply-add.
struct TapWeights {
  int i;        // first sample
  float w[4];   // weight of samples i, i + 1, ...
};

// The taps of `index` as sample weights; false when outside the mode's
// validity window (the same tests as make_taps).  Catmull-Rom's weights of
// p[k-1], p[k], p[k+1], p[k+2] at t = index - k, by Horner's rule.
template <int MODE>
__device__ __forceinline__ bool tap_weights(int S, float index, TapWeights& tw) {
  if (MODE == kNearest) {
    if (!(index >= 0.f)) return false;
    const float r = rintf(index);
    if (!(r < (float)S)) return false;
    tw.i = (int)r;
    return true;
  }
  if (MODE == kLinear) {
    if (!(index >= 0.f && index < (float)(S - 1))) return false;
    const float k = floorf(index);
    const float t = __fsub_rn(index, k);
    tw.i = (int)k;
    tw.w[0] = __fsub_rn(1.f, t);
    tw.w[1] = t;
    return true;
  }
  if (!(index >= 1.f && index < (float)(S - 2))) return false;
  const float k = floorf(index);
  const float t = __fsub_rn(index, k);
  const float tt = __fmul_rn(t, t);
  tw.i = (int)k - 1;
  tw.w[0] = __fmul_rn(t, __fmaf_rn(t, __fmaf_rn(-0.5f, t, 1.f), -0.5f));
  tw.w[1] = __fmaf_rn(tt, __fmaf_rn(1.5f, t, -2.5f), 1.f);
  tw.w[2] = __fmul_rn(t, __fmaf_rn(t, __fmaf_rn(-1.5f, t, 2.f), 0.5f));
  tw.w[3] = __fmul_rn(tt, __fmaf_rn(0.5f, t, -0.5f));
  return true;
}

__device__ __forceinline__ float mul_rn(float a, float x) { return __fmul_rn(a, x); }
__device__ __forceinline__ float2 mul_rn(float a, float2 x) {
  return make_float2(__fmul_rn(a, x.x), __fmul_rn(a, x.y));
}
// a * x + acc
__device__ __forceinline__ float fma_rn(float a, float x, float acc) {
  return __fmaf_rn(a, x, acc);
}
__device__ __forceinline__ float2 fma_rn(float a, float2 x, float2 acc) {
  return make_float2(__fmaf_rn(a, x.x, acc.x), __fmaf_rn(a, x.y, acc.y));
}

// The sample of `line` at the taps: the weighted sum of its samples.
template <int MODE, typename T>
__device__ __forceinline__ T weighted_gather(const T* __restrict__ line,
                                             const TapWeights& tw) {
  if (MODE == kNearest) return __ldg(line + tw.i);
  const T p1 = mul_rn(tw.w[0], __ldg(line + tw.i));
  if (MODE == kLinear) return fma_rn(tw.w[1], __ldg(line + tw.i + 1), p1);
  return fma_rn(tw.w[3], __ldg(line + tw.i + 3),
                fma_rn(tw.w[2], __ldg(line + tw.i + 2),
                       fma_rn(tw.w[1], __ldg(line + tw.i + 1), p1)));
}

// (wr, wi) * x: a real sample takes the real weight, an IQ one the complex
// weight wr + j wi (the apodization times the rotation).
__device__ __forceinline__ float weigh(float x, float wr, float) { return __fmul_rn(wr, x); }
__device__ __forceinline__ float2 weigh(float2 x, float wr, float wi) {
  return make_float2(__fmaf_rn(x.x, wr, -__fmul_rn(x.y, wi)),
                     __fmaf_rn(x.x, wi, __fmul_rn(x.y, wr)));
}
// acc + (wr, wi) * x
__device__ __forceinline__ float weigh_add(float x, float wr, float, float acc) {
  return __fmaf_rn(wr, x, acc);
}
__device__ __forceinline__ float2 weigh_add(float2 x, float wr, float wi, float2 acc) {
  return make_float2(__fmaf_rn(x.x, wr, __fmaf_rn(-x.y, wi, acc.x)),
                     __fmaf_rn(x.x, wi, __fmaf_rn(x.y, wr, acc.y)));
}

// Per-frame sums of one voxel of the HERCULES and RCA kernels: each pair
// goes straight into the frame's total.
template <bool IQ, bool COH, int FB>
struct VoxelSums {
  using T = typename Sample<IQ>::type;
  T v[FB];
  float inco[FB];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      v[f] = Sample<IQ>::zero();
      inco[f] = 0.f;
    }
  }
  // One pair: frame f's sample at the shared taps times the pair's weight
  // (wr, wi).
  template <int MODE>
  __device__ __forceinline__ void pair(const T* __restrict__ line, size_t frame,
                                       const TapWeights& tw, float wr, float wi) {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      const T x = weighted_gather<MODE>(line + f * frame, tw);
      if constexpr (COH) {
        const T val = weigh(x, wr, wi);
        v[f] = add(v[f], val);
        inco[f] = __fadd_rn(inco[f], magnitude(val));
      } else {
        v[f] = weigh_add(x, wr, wi, v[f]);
      }
    }
  }
  __device__ __forceinline__ void store(const Args& a, int v_index) const {
    const size_t voxels = (size_t)a.nx * a.ny * a.nz;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      static_cast<T*>(a.out)[f * voxels + v_index] = v[f];
      if (COH) a.inco[f * voxels + v_index] = inco[f];
    }
  }
};

// The weight (wr, wi) of a HERCULES or RCA pair: its apodization `apod`,
// times, for IQ data, the rotation exp(+j 2 pi f_d index / fs).  The
// twin's phase argument 2 pi f_d (index / fs), rounded as the twin rounds
// it, is reduced exactly by k 2 pi (k = rint(p / 2 pi); 2 pi in three
// parts, each product exact inside its FMA) into [-pi, pi] -- give or take
// an ulp of p / 2 pi, 8e-4 rad at 1e4 rad -- and the hardware's sin and cos
// are taken there.
template <bool IQ>
__device__ __forceinline__ void pair_weight(float apod, float two_pi_fd, float index,
                                            float fs, float& wr, float& wi) {
  wr = apod;
  wi = 0.f;
  if constexpr (IQ) {
    const float p = __fmul_rn(two_pi_fd, __fdiv_rn(index, fs));
    const float k = rintf(__fmul_rn(p, kInvTwoPi));
    float r = __fmaf_rn(-k, kTwoPiHi, p);
    r = __fmaf_rn(-k, kTwoPiMid, r);
    r = __fmaf_rn(-k, kTwoPiLo, r);
    float sn, cs;
    __sincosf(r, &sn, &cs);
    wr = __fmul_rn(apod, cs);
    wi = __fmul_rn(apod, sn);
  }
}

// The hardware square root (MUFU), for weights: not correctly rounded.
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// A thread's voxels: the grid is nx ny nz / run runs of `run` consecutive
// voxels (C order); a run is split over per_run = ceil(run / VPT) threads,
// thread g of a run taking its voxels g, g + per_run, ...  A warp takes
// LANES consecutive threads g of each of 32 / LANES consecutive runs: a
// tile of neighbouring voxels along and across runs, whose masks and
// samples are alike; consecutive warps take the next threads of the same
// runs, or (RUNS_FIRST) the same threads of the next runs.  A warp's lanes
// past the end of a run or of the grid stay idle.
struct Run {
  int first;  // voxel of slot 0
  int step;   // voxels between slots
  int count;  // slots inside the run, 1..VPT
};

template <int VPT>
__host__ __device__ __forceinline__ int threads_per_run(int run) {
  return (run + VPT - 1) / VPT;
}

// Warps of thread_run's tiles: (groups of 32 / LANES runs, chunks of LANES
// threads of a run).
template <int VPT, int LANES>
__host__ __device__ __forceinline__ void tiles(int runs, int run, int& groups,
                                               int& chunks) {
  groups = (runs + 32 / LANES - 1) / (32 / LANES);
  chunks = (threads_per_run<VPT>(run) + LANES - 1) / LANES;
}

template <int VPT, int LANES, bool RUNS_FIRST>
__device__ __forceinline__ bool thread_run(const Args& a, Run& r) {
  const int per_run = threads_per_run<VPT>(a.run);
  const int runs = a.nx * a.ny * a.nz / a.run;
  int groups, chunks;
  tiles<VPT, LANES>(runs, a.run, groups, chunks);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int group = RUNS_FIRST ? warp % groups : warp / chunks;
  const int chunk = RUNS_FIRST ? warp / groups : warp % chunks;
  const int outer = group * (32 / LANES) + lane / LANES;
  const int g = chunk * LANES + lane % LANES;
  if (outer >= runs || g >= per_run) return false;
  r.first = outer * a.run + g;
  r.step = per_run;
  r.count = (a.run - g + per_run - 1) / per_run;
  return true;
}

// First of the ascending positions p[0..n) that is not below x.
__device__ __forceinline__ int lower_bound(const float* p, int n, float x) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (p[lo + half] < x) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The first of the ascending positions p[0..n) not below x, stepping from
// `at` (a neighbouring channel's bound: a few steps).
__device__ __forceinline__ int seek(const float* p, int n, int at, float x) {
  while (at > 0 && !(p[at - 1] < x)) --at;
  while (at < n && p[at] < x) ++at;
  return at;
}

// The transmits [j0, j1] of the ascending positions `pos` that may pass
// rx_d2 + (lat - pos_j)^2 < test: those within a radius of lat widened far
// past the rounding of the test (a relative 2^-16 of the test and of the
// radius, and 2^-20 of |lat| for the rounding of lat -/+ r), and one more on
// each side.  lo and hi carry the lower bounds of lat -/+ r from channel to
// channel (-1: none yet, found by binary search).  The caller keeps the
// exact test; tests/test_torch_das.py holds a numpy model of this walk to
// the full table's triples.
__device__ __forceinline__ void transmit_interval(const float* pos, int n, float lat,
                                                  float test, float rx_d2, int& lo,
                                                  int& hi, int& j0, int& j1) {
  const float room = __fadd_rn(fmaxf(__fsub_rn(test, rx_d2), 0.f), __fmul_rn(test, 0x1p-16f));
  const float r = __fadd_rn(__fmul_rn(__fsqrt_rn(room), 1.f + 0x1p-16f),
                            __fmul_rn(fabsf(lat), 0x1p-20f));
  const float x0 = __fsub_rn(lat, r), x1 = __fadd_rn(lat, r);
  if (lo < 0) {
    lo = lower_bound(pos, n, x0);
    hi = lower_bound(pos, n, x1);
  } else {
    lo = seek(pos, n, lo, x0);
    hi = seek(pos, n, hi, x1);
  }
  j0 = max(lo - 1, 0);
  j1 = min(hi, n - 1);
}

template <int MODE, bool IQ, bool COH, int FB>
__global__ void __launch_bounds__(kBlock) das_forces_kernel(const Args args) {
  using T = typename Sample<IQ>::type;
  const T* __restrict__ rf = static_cast<const T*>(args.rf);
  const float* __restrict__ sc = args.sc;
  const int channels = args.channels, rf_rows = args.rf_rows, S = args.S;
  const int n_tx = args.n_tx;
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = args.tx_chunk;
  float* s_index = reinterpret_cast<float*>(smem);     // chunk x kBlock
  float* s_pos = s_index + chunk * kBlock;
  float* s_w = s_pos + n_tx;
  int* s_off = reinterpret_cast<int*>(s_w + n_tx);
  // Per transmit: x position, weight and the offset of its rf row inside a
  // channel (rf_rows * S < 2^31, checked at launch), so that a tap's
  // address is one 32-bit sum and one widening multiply-add.
  for (int j = threadIdx.x; j < n_tx; j += blockDim.x) {
    s_pos[j] = args.tx_pos[j];
    s_w[j] = args.tx_weight[j];
    s_off[j] = args.tx_row[j] * S;
  }
  __syncthreads();

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= args.nx * args.ny * args.nz) return;
  const size_t frame = (size_t)channels * rf_rows * S;

  const float fs = sc[kFs], sos = sc[kSos], t0 = sc[kT0], fnum = sc[kFnum];
  const float px = sc[kPx], py = sc[kPy], fd = sc[kFd], ch0 = sc[kCh0];

  // World point, XDC space (JAX ops/das.py:_world_points/_apply_m4).
  float w[3];
  world_point(args, v, w);
  const float x = w[0], y = w[1], z = w[2];
  const float z2 = __fmul_rn(z, z);
  const float ty = __fsub_rn(y, __fmul_rn(py, 0.5f * (float)args.channel_count));
  const float t_yz2 = __fadd_rn(__fmul_rn(ty, ty), z2);
  const float fs_over_c = __fdiv_rn(fs, sos);
  const float two_pi_fd = __fmul_rn(kTwoPi, fd);
  // This thread's column of the index table: only it reads and writes it,
  // so the table needs no barrier.
  float* tx_index = s_index + threadIdx.x;

  Sums<IQ, COH, FB> acc, part;
  acc.clear();
  for (int j0 = 0; j0 < n_tx; j0 += chunk) {
    const int nj = min(chunk, n_tx - j0);
    // The transmit leg of each transmit of the chunk, once per voxel (the
    // twin's tx_index field, ops/das.py:_forces_block).
    for (int jj = 0; jj < nj; ++jj) {
      const float tx_dx = __fsub_rn(x, s_pos[j0 + jj]);
      tx_index[jj * kBlock] =
          __fmul_rn(__fsqrt_rn(__fadd_rn(t_yz2, __fmul_rn(tx_dx, tx_dx))), fs_over_c);
    }
    for (int c = 0; c < channels; ++c) {
      const float ch = __fadd_rn(ch0, (float)c);
      const float rx_dx = __fsub_rn(x, __fmul_rn(ch, px));
      const float a_arg = fabsf(__fdiv_rn(__fmul_rn(fnum, rx_dx), z));
      if (!(a_arg < 0.5f)) continue;                 // apodization mask
      const float ca = cosf(__fmul_rn(kPi, a_arg));
      const float apod = __fmul_rn(ca, ca);
      const float rx_index = __fmul_rn(
          __fadd_rn(__fdiv_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(rx_dx, rx_dx), z2)), sos), t0), fs);
      const T* rf_c = rf + (size_t)c * rf_rows * S;

      part.clear();
      for (int jj = 0; jj < nj; ++jj) {
        const float index = __fadd_rn(rx_index, tx_index[jj * kBlock]);
        Taps tp;
        if (!make_taps<MODE>(S, index, tp)) continue;
        float sn, cs;
        phase<IQ>(two_pi_fd, index, fs, sn, cs);
        const int j = j0 + jj;
        tp.i += s_off[j];
        part.template pair<MODE>(rf_c, frame, tp, sn, cs, __fmul_rn(apod, s_w[j]));
      }
      part.flush_into(acc);
    }
  }
  acc.store(args, v);
}

template <int MODE, bool IQ, bool COH, int FB>
__global__ void __launch_bounds__(kBlock) das_hercules_kernel(const Args args) {
  using T = typename Sample<IQ>::type;
  constexpr int VPT = kHerculesVoxels;
  const T* __restrict__ rf = static_cast<const T*>(args.rf);
  const float* __restrict__ sc = args.sc;
  const int channels = args.channels, rf_rows = args.rf_rows, S = args.S;
  const int n_tx = args.n_tx;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pos = reinterpret_cast<float*>(smem);
  float* s_w = s_pos + n_tx;
  int* s_off = reinterpret_cast<int*>(s_w + n_tx);
  // Per transmit, in ascending position: position, weight and the offset of
  // its rf row inside a channel (rf_rows * S < 2^31, checked at launch).
  for (int j = threadIdx.x; j < n_tx; j += blockDim.x) {
    s_pos[j] = args.tx_pos[j];
    s_w[j] = args.tx_weight[j];
    s_off[j] = args.tx_row[j] * S;
  }
  __syncthreads();

  Run run;
  if (!thread_run<VPT, kHerculesLanes, kHerculesRunsFirst>(args, run)) return;
  const size_t frame = (size_t)channels * rf_rows * S;

  const float fs = sc[kFs], sos = sc[kSos], t0 = sc[kT0], fnum = sc[kFnum];
  const float px = sc[kPx], py = sc[kPy], fd = sc[kFd], ch0 = sc[kCh0];
  float t[kRcaWidth];
#pragma unroll
  for (int i = 0; i < kRcaWidth; ++i) t[i] = __ldg(args.tab + i);
  const bool rx_cols = t[kRxO] == kColumns;
  const float rx_pitch = rx_cols ? px : py;
  const float fs_over_c = __fdiv_rn(fs, sos);
  const float two_pi_fd = __fmul_rn(kTwoPi, fd);

  // Per voxel (JAX ops/das.py:_hercules_block): acquisition 0's transmit
  // index, z^2, pi |f#/z| and the mask's bound z^2 / (4 f#^2); a slot past
  // the run's end keeps the bound -1, which no d2 passes.  The run's lateral
  // coordinates are its first voxel's.
  float tx_index[VPT], z2[VPT], apod_k[VPT], apod_test[VPT];
  float rx_lat = 0.f, tx_lat = 0.f, test_max = -1.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    tx_index[i] = 0.f;
    z2[i] = 0.f;
    apod_k[i] = 0.f;
    apod_test[i] = -1.f;
    if (i < run.count) {
      float w[3], xdc[3];
      world_point(args, run.first + i * run.step, w);
      apply_m4(sc + kXdc, w[0], w[1], w[2], xdc);
      tx_index[i] = __fmul_rn(__fadd_rn(__fdiv_rn(rca_tx_distance(t, w), sos), t0), fs);
      const float z = xdc[2];
      z2[i] = __fmul_rn(z, z);
      const float fnum_over_z = fabsf(__fdiv_rn(fnum, z));
      apod_test[i] = __fdiv_rn(0.25f, __fmul_rn(fnum_over_z, fnum_over_z));
      apod_k[i] = __fmul_rn(kPi, fnum_over_z);
      test_max = fmaxf(test_max, apod_test[i]);
      if (i == 0) {
        rx_lat = rx_cols ? xdc[0] : xdc[1];
        tx_lat = rx_cols ? xdc[1] : xdc[0];
      }
    }
  }

  VoxelSums<IQ, COH, FB> acc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc[i].clear();
  int lo = -1, hi = -1;                  // transmit_interval's bounds
  for (int c = 0; c < channels; ++c) {
    const float rx_dd = __fsub_rn(rx_lat, __fmul_rn(__fadd_rn(ch0, (float)c), rx_pitch));
    const float rx_d2 = __fmul_rn(rx_dd, rx_dd);
    if (!(rx_d2 < test_max)) continue;   // d2 >= rx_d2: no transmit passes
    int j0 = 0, j1 = n_tx - 1;
    if (args.tx_walk)
      transmit_interval(s_pos, n_tx, tx_lat, test_max, rx_d2, lo, hi, j0, j1);
    const T* rf_c = rf + (size_t)c * rf_rows * S;
    for (int j = j0; j <= j1; ++j) {
      // the run's shared part of the triple
      const float tx_dd = __fsub_rn(tx_lat, s_pos[j]);
      const float d2 = __fadd_rn(rx_d2, __fmul_rn(tx_dd, tx_dd));
      if (!(d2 < test_max)) continue;
      const float dist = sqrt_approx(d2);
      const float weight = s_w[j];
      const int off = s_off[j];
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        if (!(d2 < apod_test[i])) continue;         // 2D apodization mask
        const float index =
            __fadd_rn(tx_index[i], __fmul_rn(__fsqrt_rn(__fadd_rn(z2[i], d2)), fs_over_c));
        TapWeights tw;
        if (!tap_weights<MODE>(S, index, tw)) continue;
        const float ca = __cosf(__fmul_rn(apod_k[i], dist));
        float wr, wi;
        pair_weight<IQ>(__fmul_rn(weight, __fmul_rn(ca, ca)), two_pi_fd, index, fs, wr, wi);
        tw.i += off;
        acc[i].template pair<MODE>(rf_c, frame, tw, wr, wi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (i < run.count) acc[i].store(args, run.first + i * run.step);
}

template <int MODE, bool IQ, bool COH, int FB>
__global__ void __launch_bounds__(kBlock) das_rca_kernel(const Args args) {
  using T = typename Sample<IQ>::type;
  constexpr int VPT = kRcaVoxels;
  const T* __restrict__ rf = static_cast<const T*>(args.rf);
  const float* __restrict__ sc = args.sc;
  const int channels = args.channels, S = args.S, A = args.n_tx;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tab = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < A * kRcaWidth; i += blockDim.x) s_tab[i] = args.tab[i];
  __syncthreads();

  Run run;
  if (!thread_run<VPT, kRcaLanes, kRcaRunsFirst>(args, run)) return;
  const size_t frame = (size_t)channels * args.rf_rows * S;
  const size_t row = (size_t)args.rf_rows * S;

  const float fs = sc[kFs], sos = sc[kSos], t0 = sc[kT0], fnum = sc[kFnum];
  const float px = sc[kPx], py = sc[kPy], fd = sc[kFd], ch0 = sc[kCh0];
  const float two_pi_fd = __fmul_rn(kTwoPi, fd);

  // Per voxel: the world point (JAX ops/das.py:_world_points), z^2 and the
  // mask's factor |f#| / |z| (+inf past the run's end: no channel passes).
  // The run's lateral coordinates are its first voxel's.
  float w[VPT][3], z2[VPT], mask_k[VPT];
  float lat_x = 0.f, lat_y = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    w[i][0] = w[i][1] = w[i][2] = 0.f;
    z2[i] = 0.f;
    mask_k[i] = INFINITY;
    if (i < run.count) {
      float xdc[3];
      world_point(args, run.first + i * run.step, w[i]);
      apply_m4(sc + kXdc, w[i][0], w[i][1], w[i][2], xdc);
      const float z = xdc[2];
      z2[i] = __fmul_rn(z, z);
      mask_k[i] = __fdiv_rn(fabsf(fnum), fabsf(z));
      if (i == 0) {
        lat_x = xdc[0];
        lat_y = xdc[1];
      }
    }
  }

  VoxelSums<IQ, COH, FB> acc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc[i].clear();
  for (int a = 0; a < A; ++a) {
    const float* t = s_tab + a * kRcaWidth;
    float tx_dist[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) tx_dist[i] = rca_tx_distance(t, w[i]);
    const bool rx_rows = t[kRxO] == kRows;
    const float lat = rx_rows ? lat_y : lat_x;
    const float pitch = rx_rows ? py : px;
    const T* rf_a = rf + (size_t)a * S;

    for (int c = 0; c < channels; ++c) {
      // the run's shared part of the pair
      const float recv_lat = __fsub_rn(lat, __fmul_rn(__fadd_rn(ch0, (float)c), pitch));
      const float recv_lat2 = __fmul_rn(recv_lat, recv_lat);
      const float abs_lat = fabsf(recv_lat);
      const T* line = rf_a + c * row;
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const float a_arg = __fmul_rn(abs_lat, mask_k[i]);
        if (!(a_arg < 0.5f)) continue;             // apodization mask
        const float rlen = __fsqrt_rn(__fadd_rn(recv_lat2, z2[i]));
        const float index =
            __fmul_rn(__fadd_rn(__fdiv_rn(__fadd_rn(tx_dist[i], rlen), sos), t0), fs);
        TapWeights tw;
        if (!tap_weights<MODE>(S, index, tw)) continue;
        const float ca = __cosf(__fmul_rn(kPi, a_arg));
        float wr, wi;
        pair_weight<IQ>(__fmul_rn(ca, ca), two_pi_fd, index, fs, wr, wi);
        acc[i].template pair<MODE>(line, frame, tw, wr, wi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (i < run.count) acc[i].store(args, run.first + i * run.step);
}

// `threads` threads in blocks of kBlock, `smem` bytes of tables per block.
// With `occupancy` set, nothing is launched: it receives the blocks of
// `kernel` that fit on one SM (registers, shared memory and threads)
// instead.
template <typename Kernel>
int launch_threads(Kernel kernel, const Args& args, long long threads, size_t smem,
                   cudaStream_t stream, int* occupancy) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel, kBlock,
                                                             smem);
  const long long blocks = (threads + kBlock - 1) / kBlock;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<(int)blocks, kBlock, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

// Threads of a HERCULES or RCA launch: whole warps of thread_run's tiles.
template <int VPT, int LANES>
long long run_threads(const Args& args) {
  int groups, chunks;
  tiles<VPT, LANES>(args.nx * args.ny * args.nz / args.run, args.run, groups, chunks);
  return (long long)groups * chunks * 32;
}

bool valid_run(const Args& args) {
  const long long voxels = (long long)args.nx * args.ny * args.nz;
  return args.run >= 1 && voxels % args.run == 0;
}

template <int FAMILY, int MODE, bool IQ, bool COH, int FB>
int launch(const Args& args, cudaStream_t stream, int* occupancy) {
  const size_t tx_table = (size_t)args.n_tx * (2 * sizeof(float) + sizeof(int));
  const long long voxels = (long long)args.nx * args.ny * args.nz;
  if constexpr (FAMILY == kForces) {
    if (args.n_tx > kMaxTransmits || args.tx_chunk < 1 || args.tx_chunk > kMaxTxChunk ||
        (long long)args.rf_rows * args.S > INT_MAX)
      return (int)cudaErrorInvalidValue;
    return launch_threads(das_forces_kernel<MODE, IQ, COH, FB>, args, voxels,
                          args.tx_chunk * kBlock * sizeof(float) + tx_table, stream,
                          occupancy);
  } else if constexpr (FAMILY == kHercules) {
    if (occupancy == nullptr &&
        (!valid_run(args) || (long long)args.rf_rows * args.S > INT_MAX))
      return (int)cudaErrorInvalidValue;
    return launch_threads(das_hercules_kernel<MODE, IQ, COH, FB>, args,
                          occupancy ? 0 : run_threads<kHerculesVoxels, kHerculesLanes>(args),
                          tx_table,
                          stream, occupancy);
  } else {
    if (occupancy == nullptr && !valid_run(args)) return (int)cudaErrorInvalidValue;
    return launch_threads(das_rca_kernel<MODE, IQ, COH, FB>, args,
                          occupancy ? 0 : run_threads<kRcaVoxels, kRcaLanes>(args),
                          (size_t)args.n_tx * kRcaWidth * sizeof(float), stream, occupancy);
  }
}

template <int FAMILY, int MODE, bool IQ, bool COH>
int launch_fb(const Args& args, int fb, cudaStream_t s, int* occ) {
  switch (fb) {
    case 1: return launch<FAMILY, MODE, IQ, COH, 1>(args, s, occ);
    case 4: return launch<FAMILY, MODE, IQ, COH, 4>(args, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int FAMILY, int MODE>
int launch_mode(const Args& args, bool iq, bool coh, int fb, cudaStream_t s, int* occ) {
  if (iq)
    return coh ? launch_fb<FAMILY, MODE, true, true>(args, fb, s, occ)
               : launch_fb<FAMILY, MODE, true, false>(args, fb, s, occ);
  return coh ? launch_fb<FAMILY, MODE, false, true>(args, fb, s, occ)
             : launch_fb<FAMILY, MODE, false, false>(args, fb, s, occ);
}

template <int FAMILY>
int launch_family(const Args& args, int mode, bool iq, bool coh, int fb, cudaStream_t s,
                  int* occ) {
  switch (mode) {
    case kNearest: return launch_mode<FAMILY, kNearest>(args, iq, coh, fb, s, occ);
    case kLinear: return launch_mode<FAMILY, kLinear>(args, iq, coh, fb, s, occ);
    case kCubic: return launch_mode<FAMILY, kCubic>(args, iq, coh, fb, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int family, const Args& args, int mode, bool iq, bool coh, int fb,
             cudaStream_t s, int* occ) {
  switch (family) {
    case kForces: return launch_family<kForces>(args, mode, iq, coh, fb, s, occ);
    case kHercules: return launch_family<kHercules>(args, mode, iq, coh, fb, s, occ);
    case kRca: return launch_family<kRca>(args, mode, iq, coh, fb, s, occ);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One DAS launch of `fb` frames (1 or 4) of `family` (Family above);
// `tx_chunk` is the transmits per pass of the FORCES index table, `run` the
// HERCULES and RCA kernels' run of equal lateral coordinates and `tx_walk`
// the HERCULES kernel's walk (Args).
extern "C" int das_launch(int family, const void* rf, const void* sc,
                          const void* tab, const void* tx_pos,
                          const void* tx_weight, const void* tx_row, void* out,
                          void* inco, int channels, int channel_count,
                          int rf_rows, int S, int n_tx, int nx, int ny, int nz,
                          int gnx, int gny, int gnz, int mode, int iq, int coh,
                          int fb, int tx_chunk, int run, int tx_walk, void* stream) {
  const Args args{rf, static_cast<const float*>(sc),
                  static_cast<const float*>(tab),
                  static_cast<const float*>(tx_pos),
                  static_cast<const float*>(tx_weight),
                  static_cast<const int*>(tx_row), out,
                  static_cast<float*>(inco), channels, channel_count, rf_rows,
                  S, n_tx, tx_chunk, nx, ny, nz, gnx, gny, gnz, run, tx_walk};
  return dispatch(family, args, mode, iq, coh, fb, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// The blocks of one SM that the kernel of (family, mode, iq, coh, fb) holds
// at once with `n_tx` transmits (or acquisitions) and, for FORCES, passes of
// `tx_chunk` transmits, into *blocks.
extern "C" int das_occupancy(int family, int mode, int iq, int coh, int fb,
                             int n_tx, int tx_chunk, void* blocks) {
  Args args{};
  args.n_tx = n_tx;
  args.tx_chunk = tx_chunk;
  return dispatch(family, args, mode, iq, coh, fb, nullptr, static_cast<int*>(blocks));
}
