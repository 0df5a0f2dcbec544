// The windowed star stage's two passes, K1 (base) and K2 (overflow): one CUDA
// thread per ray each.
//
// They replace the TPU prototype's Pallas kernels _k1_kernel and _k2_kernel
// (scripts/proto_window_kernel.py:102 and :136, built by build_k1 :209 and
// build_k2 :245); their plain PyTorch twins are k1_reference and k2_reference
// in blackstar_tpu_torch/stars/window.py, which also holds the stage's glue.
//
// What is ported is what the TPU kernels compute, not their window copies. On
// the TPU, K1 copied a tile's DR x DC = 32 x 128-cell window of base rows into
// VMEM and selected each ray's row there; at K0 = 32 slots of 8 floats that
// window is 4 MB, far beyond an SM's 227 KB of shared memory. Here the window
// is only a frame of coordinates:
//   K1: a covered ray reads its own base row, cell
//       (r0 + widx / DC) * n_cols + c0 + widx % DC of its tile's start
//       (r0, c0), slot by slot as 16-byte loads; it sums the exact starLookup
//       slot math (StarMap.hs:93-114) into RGB and emits the row's overflow
//       pointer, (int) of slot 0's aux column. A ray that is not covered is
//       skipped and writes 0 (the stage masks it; the TPU kernel computed it
//       against its window's first row).
//   K2: a ray takes part when it is covered and its pointer p satisfies
//       p > 0 and s <= p < s + OVW for its tile's window start s; it scans
//       the ovf_octets[p] used octets of overflow row p. The TPU kernel
//       scanned every ray to the largest used-octet count of its window; the
//       slots past a row's own octets are sentinels (or zero padding) whose
//       terms are exact +0, so the sums are equal bit for bit. A ray that
//       does not take part writes 0.
//
// The slot math is the prototype's _star_math order: logb0 = a (950 - mag),
// c = 1 + sat H, the difference-first d^2, e = exp(logb0 - d^2 / (2 w^2)) inside
// the (3w)^2 cutoff, val = min(1, e) * intensity, acc = acc + val * c. A slot
// outside the cutoff adds exactly +0 in the plain version (exp(-inf) = 0), so
// skipping it changes no sum. This file builds with -fmad=false: no multiply-add
// is contracted and each float32 operation rounds as the plain version's
// (one PyTorch operation each) does; inv2w2 = 2e6 at the production PSF width
// amplifies any rounding difference in d^2.
//
// What bounds them on an H100: bytes. K1 reads one base row per covered ray
// (1 KB in float32 at K0 = 32) and spends 9 operations per slot; K2 one
// overflow row's used octets (256 bytes each in float32). The least bytes are
// the distinct rows the covered rays' cells need plus the ray planes in and
// out; the rays of a warp are neighbouring pixels that mostly share a cell, so
// their row loads coalesce into the same lines and hit in L1/L2, and the
// kernels are held by the latency of those loads, as the per-ray lookup B3
// (star_lookup.cu) is. The design does nothing more about it yet: staging a
// tile's rows in shared memory, or sorting the rays by cell, is later work.
//
// Templated on float (the stage) and double (the on-card gate).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRow = 8;  // floats per slot: x y z mag H_r H_g H_b aux
constexpr double kMaxBrightness = 950.0;

template <typename T>
struct StarParams {
  T intensity;   // starIntensity
  T saturation;  // starSaturation
  T a;           // ln 2 / 50
  T r2lim;       // (3w)^2
  T inv2w2;      // 1 / (2 w^2)
};

__device__ __forceinline__ void load_slot(const float* p, float (&s)[kRow]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
  s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
}

__device__ __forceinline__ void load_slot(const double* p, double (&s)[kRow]) {
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const double2 v = __ldg(q + j);
    s[2 * j] = v.x;
    s[2 * j + 1] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ row, int slots, T rx, T ry,
                                           T rz, const StarParams<T>& P, T& ar, T& ag,
                                           T& ab) {
  for (int k = 0; k < slots; ++k) {
    T s[kRow];
    load_slot(row + k * kRow, s);
    const T dx = s[0] - rx;
    const T dy = s[1] - ry;
    const T dz = s[2] - rz;
    const T d2 = dx * dx + dy * dy + dz * dz;
    if (d2 <= P.r2lim) {
      const T logb0 = P.a * (T(kMaxBrightness) - s[3]);
      const T e = exp(logb0 - d2 * P.inv2w2);
      const T val = fmin(T(1), e) * P.intensity;
      ar = ar + val * (T(1) + P.saturation * s[4]);
      ag = ag + val * (T(1) + P.saturation * s[5]);
      ab = ab + val * (T(1) + P.saturation * s[6]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const int32_t* __restrict__ starts,  // (n_tiles, 2): r0, c0
          const int32_t* __restrict__ widx, const bool* __restrict__ covered,
          const T* __restrict__ rx, const T* __restrict__ ry, const T* __restrict__ rz,
          int64_t n, int tile, int dc, const T* __restrict__ cell_data, int n_cols,
          int pad_k, StarParams<T> P, T* __restrict__ out,  // (3, n) planes
          int32_t* __restrict__ optr) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ar = T(0), ag = T(0), ab = T(0);
  int32_t p = 0;
  if (covered[i]) {
    const int64_t t = i / tile;
    const int w = widx[i];
    const int64_t r = starts[2 * t] + w / dc;
    const int64_t c = starts[2 * t + 1] + w % dc;
    const T* row = cell_data + (r * n_cols + c) * pad_k * kRow;
    accumulate(row, pad_k, rx[i], ry[i], rz[i], P, ar, ag, ab);
    p = (int32_t)row[7];
  }
  out[i] = ar;
  out[n + i] = ag;
  out[2 * n + i] = ab;
  optr[i] = p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
k2_kernel(const int32_t* __restrict__ s2,  // (n_tiles,) overflow-window starts
          const int32_t* __restrict__ optr, const bool* __restrict__ covered,
          const T* __restrict__ rx, const T* __restrict__ ry, const T* __restrict__ rz,
          int64_t n, int tile, int ovw, const T* __restrict__ ovf_data, int64_t ovf_width,
          const int32_t* __restrict__ ovf_octets, StarParams<T> P,
          T* __restrict__ out) {  // (3, n) planes
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ar = T(0), ag = T(0), ab = T(0);
  const int32_t p = optr[i];
  const int32_t s = s2[i / tile];
  if (covered[i] && p > 0 && p >= s && p < s + ovw) {
    accumulate(ovf_data + (int64_t)p * ovf_width, ovf_octets[p] * 8, rx[i], ry[i], rz[i], P,
               ar, ag, ab);
  }
  out[i] = ar;
  out[n + i] = ag;
  out[2 * n + i] = ab;
}

template <typename T>
StarParams<T> make_params(double intensity, double saturation, double a, double r2lim,
                          double inv2w2) {
  StarParams<T> P;
  P.intensity = T(intensity);
  P.saturation = T(saturation);
  P.a = T(a);
  P.r2lim = T(r2lim);
  P.inv2w2 = T(inv2w2);
  return P;
}

template <typename T>
int launch_k1(const void* starts, const void* widx, const void* covered, const void* rx,
              const void* ry, const void* rz, int64_t n, int tile, int dc,
              const void* cell_data, int n_cols, int pad_k, double intensity,
              double saturation, double a, double r2lim, double inv2w2, void* out,
              void* optr, void* stream) {
  const StarParams<T> P = make_params<T>(intensity, saturation, a, r2lim, inv2w2);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  k1_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)starts, (const int32_t*)widx, (const bool*)covered, (const T*)rx,
      (const T*)ry, (const T*)rz, n, tile, dc, (const T*)cell_data, n_cols, pad_k, P, (T*)out,
      (int32_t*)optr);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* s2, const void* optr, const void* covered, const void* rx,
              const void* ry, const void* rz, int64_t n, int tile, int ovw,
              const void* ovf_data, int64_t ovf_width, const void* ovf_octets,
              double intensity, double saturation, double a, double r2lim, double inv2w2,
              void* out, void* stream) {
  const StarParams<T> P = make_params<T>(intensity, saturation, a, r2lim, inv2w2);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  k2_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)s2, (const int32_t*)optr, (const bool*)covered, (const T*)rx,
      (const T*)ry, (const T*)rz, n, tile, ovw, (const T*)ovf_data, ovf_width,
      (const int32_t*)ovf_octets, P, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define BS_K1_ARGS                                                                        \
  const void *starts, const void *widx, const void *covered, const void *rx,             \
      const void *ry, const void *rz, int64_t n, int tile, int dc, const void *cell_data, \
      int n_cols, int pad_k, double intensity, double saturation, double a, double r2lim, \
      double inv2w2, void *out, void *optr, void *stream
#define BS_K1_PASS                                                                     \
  starts, widx, covered, rx, ry, rz, n, tile, dc, cell_data, n_cols, pad_k, intensity, \
      saturation, a, r2lim, inv2w2, out, optr, stream
#define BS_K2_ARGS                                                                        \
  const void *s2, const void *optr, const void *covered, const void *rx, const void *ry, \
      const void *rz, int64_t n, int tile, int ovw, const void *ovf_data,                 \
      int64_t ovf_width, const void *ovf_octets, double intensity, double saturation,     \
      double a, double r2lim, double inv2w2, void *out, void *stream
#define BS_K2_PASS                                                                         \
  s2, optr, covered, rx, ry, rz, n, tile, ovw, ovf_data, ovf_width, ovf_octets, intensity, \
      saturation, a, r2lim, inv2w2, out, stream

int bs_window_k1_f32(BS_K1_ARGS) { return launch_k1<float>(BS_K1_PASS); }
int bs_window_k1_f64(BS_K1_ARGS) { return launch_k1<double>(BS_K1_PASS); }
int bs_window_k2_f32(BS_K2_ARGS) { return launch_k2<float>(BS_K2_PASS); }
int bs_window_k2_f64(BS_K2_ARGS) { return launch_k2<double>(BS_K2_PASS); }

}  // extern "C"
