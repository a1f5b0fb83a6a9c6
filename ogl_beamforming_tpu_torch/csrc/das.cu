// FORCES-family delay-and-sum for Hopper (sm_90a).
//
// Replaces the `forces` branch of the TPU kernel
// ogl_beamforming_tpu/ops/das_pallas.py::_das_kernel (pallas_call in
// _das_call; delays from _forces_delay, taps from _interp_weights):
// FORCES, UFORCES (sparse transmits) and READI (grouped transmits with a
// Hadamard-row weight), every interpolation mode, real or IQ, optionally
// with the incoherent sum for coherency weighting.
//
//   out[v] = sum_c sum_j apod(v, c) * w_j * interp(rf[c, row_j], idx(v, c, j))
//   idx    = (|rx(v, c)| / c_0 + t_0) * fs  +  |tx(v, j)| * fs / c_0
//
// What bounds it on this card: each (voxel, channel, transmit) pair costs an
// IEEE square root for the transmit leg, one to four RF loads and about
// thirty flops; at the main path's size (128 x 128 pairs x 524,288 voxels,
// 8.6 G pairs) that is instruction issue and L1/L2 traffic, not device
// memory (the decoded frame is 256 MiB and each channel's 2 MiB of RF stays
// in L2 while every voxel block sweeps it).
//
// What the design does about it: one thread per voxel, voxels in the output's
// C order so that neighbouring threads read neighbouring samples; the
// receive terms (apodization, receive delay) are computed once per
// (voxel, channel) and channels whose apodization mask is off are skipped
// entirely; the per-transmit tables (x position, weight, rf row) sit in
// shared memory.  None of the TPU kernel's scheduling machinery (tile
// activity tables, chunk bounds, int16 line packing) is carried over.
//
// Numerics follow the JAX package's exact-f32 XLA path (ops/das.py), not the
// Pallas kernel's approximations: the world point and the sample index are
// evaluated with explicitly rounded operations (__fmul_rn and friends, which
// the compiler never contracts into FMAs) in the same order as the plain
// twin, so the fractional index -- thousands of samples, where one ulp moves
// the interpolation point -- matches it bit for bit; sqrt and division are
// IEEE; nearest rounds half to even (rintf); cosf/sincosf are the full-range
// library functions (no --use_fast_math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Scalar layout prepared by ops/das_cuda.py::prepare
enum Scalar {
  kVT = 0,        // voxel transform rows 0..2, 12 values row-major
  kFs = 12, kSos, kT0, kFnum, kPx, kPy, kFd, kCh0, kX0, kNumScalars
};

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kBlock = 128;

enum Mode { kNearest = 0, kLinear = 1, kCubic = 2 };

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

// Interpolate `line` at fractional `index`; false when outside the mode's
// validity window (das.glsl:64-122; JAX ops/das.py:_interpolate).
template <int MODE, typename T>
__device__ __forceinline__ bool interpolate(const T* __restrict__ line, int S,
                                            float index, T& val) {
  if (MODE == kNearest) {
    const float r = rintf(index);
    if (!(floorf(index) >= 0.f && r < (float)S)) return false;
    val = __ldg(line + (int)r);
    return true;
  }
  const float k = floorf(index);
  const float t = index - k;
  if (MODE == kLinear) {
    if (!(k >= 0.f && k < (float)(S - 1))) return false;
    const int i = (int)k;
    val = add(scale(1.f - t, __ldg(line + i)), scale(t, __ldg(line + i + 1)));
    return true;
  }
  if (!(k > 0.f && k < (float)(S - 2))) return false;
  const int i = (int)k;
  const T p0 = __ldg(line + i - 1), p1 = __ldg(line + i);
  const T p2 = __ldg(line + i + 1), p3 = __ldg(line + i + 2);
  const T t1 = scale(0.5f, sub(p2, p0));
  const T t2 = scale(0.5f, sub(p3, p1));
  const float tt = t * t, ttt = tt * t;
  val = add(add(scale(2.f * ttt - 3.f * tt + 1.f, p1), scale(-2.f * ttt + 3.f * tt, p2)),
            add(scale(ttt - 2.f * tt + t, t1), scale(ttt - tt, t2)));
  return true;
}

// Arguments of one launch, as the C entry point receives them.
struct Args {
  const void* rf;          // (channels, rf_rows, S) float or float2
  const float* sc;         // Scalar layout above
  const float* tx_pos;     // (n_tx,) transmit element x positions
  const float* tx_weight;  // (n_tx,) transmit weights
  const int* tx_row;       // (n_tx,) rf acquisition of each transmit
  void* out;               // (nx, ny, nz) float or float2
  float* inco;             // (nx, ny, nz) incoherent sum, or null
  int channels, channel_count, rf_rows, S, n_tx;
  int nx, ny, nz, gnx, gny, gnz;
};

template <int MODE, bool IQ, bool COH>
__global__ void __launch_bounds__(kBlock) das_forces_kernel(const Args args) {
  using T = typename Sample<IQ>::type;
  const T* __restrict__ rf = static_cast<const T*>(args.rf);
  const float* __restrict__ sc = args.sc;
  const int channels = args.channels, rf_rows = args.rf_rows, S = args.S;
  const int n_tx = args.n_tx, nx = args.nx, ny = args.ny, nz = args.nz;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_pos = reinterpret_cast<float*>(smem);
  float* s_w = s_pos + n_tx;
  int* s_row = reinterpret_cast<int*>(s_w + n_tx);
  for (int j = threadIdx.x; j < n_tx; j += blockDim.x) {
    s_pos[j] = args.tx_pos[j];
    s_w[j] = args.tx_weight[j];
    s_row[j] = args.tx_row[j];
  }
  __syncthreads();

  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= nx * ny * nz) return;
  const int iz = v % nz, iy = (v / nz) % ny, ix = v / (nz * ny);

  const float fs = sc[kFs], sos = sc[kSos], t0 = sc[kT0], fnum = sc[kFnum];
  const float px = sc[kPx], py = sc[kPy], fd = sc[kFd], ch0 = sc[kCh0];

  // World point, XDC space (JAX ops/das.py:_world_points/_apply_m4).
  const float gx = __fdiv_rn(__fadd_rn((float)ix, sc[kX0]), fmaxf((float)args.gnx - 1.f, 1.f));
  const float gy = __fdiv_rn((float)iy, fmaxf((float)args.gny - 1.f, 1.f));
  const float gz = __fdiv_rn((float)iz, fmaxf((float)args.gnz - 1.f, 1.f));
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sc + kVT + 4 * i;
    w[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)),
                               __fmul_rn(m[2], gz)), m[3]);
  }
  const float x = w[0], y = w[1], z = w[2];
  const float z2 = __fmul_rn(z, z);
  const float ty = __fsub_rn(y, __fmul_rn(py, 0.5f * (float)args.channel_count));
  const float t_yz2 = __fadd_rn(__fmul_rn(ty, ty), z2);
  const float fs_over_c = __fdiv_rn(fs, sos);
  const float two_pi_fd = __fmul_rn(kTwoPi, fd);

  T acc = Sample<IQ>::zero();
  float acc_inco = 0.f;
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

    T part = Sample<IQ>::zero();
    float part_inco = 0.f;
    for (int j = 0; j < n_tx; ++j) {
      const float tx_dx = __fsub_rn(x, s_pos[j]);
      const float tx_index =
          __fmul_rn(__fsqrt_rn(__fadd_rn(t_yz2, __fmul_rn(tx_dx, tx_dx))), fs_over_c);
      const float index = __fadd_rn(rx_index, tx_index);
      T val;
      if (!interpolate<MODE>(rf_c + (size_t)s_row[j] * S, S, index, val)) continue;
      if constexpr (IQ) {
        float sn, cs;
        sincosf(__fmul_rn(two_pi_fd, __fdiv_rn(index, fs)), &sn, &cs);
        val = make_float2(val.x * cs - val.y * sn, val.x * sn + val.y * cs);
      }
      val = scale(__fmul_rn(apod, s_w[j]), val);
      part = add(part, val);
      if (COH) part_inco += magnitude(val);
    }
    acc = add(acc, part);
    if (COH) acc_inco += part_inco;
  }
  static_cast<T*>(args.out)[v] = acc;
  if (COH) args.inco[v] = acc_inco;
}

template <int MODE, bool IQ, bool COH>
int launch(const Args& args, cudaStream_t stream) {
  auto kernel = das_forces_kernel<MODE, IQ, COH>;
  const size_t smem = (size_t)args.n_tx * (2 * sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int voxels = args.nx * args.ny * args.nz;
  kernel<<<(voxels + kBlock - 1) / kBlock, kBlock, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const Args& args, bool iq, bool coh, cudaStream_t stream) {
  if (iq)
    return coh ? launch<MODE, true, true>(args, stream)
               : launch<MODE, true, false>(args, stream);
  return coh ? launch<MODE, false, true>(args, stream)
             : launch<MODE, false, false>(args, stream);
}

}  // namespace

extern "C" int das_forces(const void* rf, const void* sc, const void* tx_pos,
                          const void* tx_weight, const void* tx_row, void* out,
                          void* inco, int channels, int channel_count,
                          int rf_rows, int S, int n_tx, int nx, int ny, int nz,
                          int gnx, int gny, int gnz, int mode, int iq, int coh,
                          void* stream) {
  const Args args{rf, static_cast<const float*>(sc),
                  static_cast<const float*>(tx_pos),
                  static_cast<const float*>(tx_weight),
                  static_cast<const int*>(tx_row), out,
                  static_cast<float*>(inco), channels, channel_count, rf_rows,
                  S, n_tx, nx, ny, nz, gnx, gny, gnz};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kNearest: return launch_mode<kNearest>(args, iq, coh, s);
    case kLinear: return launch_mode<kLinear>(args, iq, coh, s);
    case kCubic: return launch_mode<kCubic>(args, iq, coh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
