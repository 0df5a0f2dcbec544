// Per-ray star lookup (kernel B3): one CUDA thread per ray.
//
// Computes what blackstar_tpu_torch/stars/grid.py::StarGrid.lookup computes,
// with the semantics of the JAX package's StarGrid._lookup_block
// (blackstar_tpu/stars/grid.py:717-815, an XLA stage: the JAX package has no
// Pallas kernel for it; scripts/proto_window_kernel.py holds an unshipped TPU
// prototype of the same function). It is the exact `starLookup` of
// StarMap.hs:93-115. Per ray:
//   * normalise the direction by rsqrt;
//   * take the cell id by the same fast-or-exact rule as the plain version
//     (fast bounded-error asin/atan2 when the grid's build margin absorbs
//     their error, exact asin/atan2 otherwise), so the candidate set matches;
//   * read the cell's base row, slot by slot as two float4 loads per 8-float
//     slot (1 KB per row at K0 = 32 in float32);
//   * per slot: the difference-first d^2, the (3w)^2 cutoff,
//     min(1, exp(a (950 - mag) - d^2 / (2 w^2))) * intensity * (1 + sat H);
//   * follow the overflow pointer (int) row[7] of slot 0 and scan that
//     overflow row's used octets, ovf_octets[ptr] * 8 slots;
//   * clamp each channel at 1, and write 0 where the ray is not escaped.
//
// What bounds it on an H100: each ray reads one base row (1 KB in float32)
// and, in dense cells, an overflow row, and spends ~20 flops per slot. The
// rays of a warp are neighbouring pixels that mostly share a cell, so their
// row loads coalesce into the same lines and hit in L1/L2; the lookup is
// bound by the load latency of those rows and by the per-slot compare,
// not by device-memory bandwidth. Slots outside the cutoff skip the exp.
//
// Rounding: this file builds with -fmad=false, so no multiply-add is
// contracted and each float32 operation rounds as the plain PyTorch version
// (one kernel per operation) rounds. The f32 PSF exp(... - d^2 * 2e6)
// amplifies any rounding difference in d^2 (DESIGN.md section 3); the JAX
// package's own two float32 star paths differ by up to 3e-2 at isolated
// pixels. Without contraction the kernel and the plain version differ only
// in the order of the slot sums (the plain version reduces over slots with
// torch.sum) and, rarely, in the cell a ray falls in when the plain version
// rounds ra / 2pi differently; with the build margin both cells hold every
// star in reach. On an H100 at the 1080p default frame against the 470k
// grid that left max |diff| 6e-8 (mean 3e-12) in float32 and 1e-16 in
// float64; the gates are mean 1e-6 and max 3e-2 (f32), 1e-9 (f64).
//
// The same launch computes the unclamped sums when the caller asks (clamp
// 0): the forward of the differentiable star stage, whose clamp is applied
// outside, as ordinary autograd, as in blackstar_tpu/stars/diff.py:134-138.
//
// Star VJP (kernel B4), in the same file: the reverse of the unclamped sums,
// one CUDA thread per ray. It replaces the JAX package's hand-derived star
// VJP, StarGrid._slot_math's gradient mode (blackstar_tpu/stars/grid.py:377,
// driven by the custom VJP of blackstar_tpu/stars/diff.py:74), an XLA stage
// with no Pallas kernel; its plain PyTorch twin is StarGrid.lookup_vjp. Per
// escaped ray it takes B3's cell id and row walk (the base row, then the used
// octets of the overflow row behind the packed pointer) and, on each slot
// inside the cutoff, accumulates the five gradient channels of the slot math
// from the incoming cotangents (wr, wg, wb) of the unclamped sums:
//   gd2 = I (sum_c w_c (1 + sat H_c)) (du/de) e (-1 / (2 w^2)),
//   g_n -= 2 gd2 (star - n),  gI += u sum_c w_c (1 + sat H_c),
//   gS += u I sum_c w_c H_c,
// with du/de of u = min(1, e) equal to 1 below the cap, 0 above it and 0.5 at
// an exact tie (lax.min's derivative, which the JAX gradients carry). It then
// chains g_n through the normalisation n = v / |v| into d/d(vel) and writes
// per-block sums of gI and gS (a fixed-order block reduction, no atomics),
// which the wrapper sums. Rays that did not escape write zero gradients (their
// output is the constant 0). What bounds it: the same gathered rows as B3,
// with ~20 more operations per lit slot; the rows' load latency, as for B3
// (`nvcc -Xptxas -v` on the card: float 32 registers with a 4-byte spill,
// double 56 registers). Built with -fmad=false as B3 is.
//
// Templated on float (the training path) and double (the on-card gate).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRow = 8;  // floats per slot: x y z mag H_r H_g H_b aux
constexpr double kPi = 3.14159265358979323846;
constexpr double kMaxBrightness = 950.0;

template <typename T>
struct LookupParams {
  T intensity;   // starIntensity
  T saturation;  // starSaturation
  T a;           // ln 2 / 50
  T r2lim;       // (3w)^2
  T inv2w2;      // 1 / (2 w^2)
  T delta;       // pi / n_rings
  int n_rings;
  int n_cols;
  int k0;        // slots per base row
  int k1;        // slots per overflow row
  int fast_cells;
  int clamp;     // B3: clamp each channel at 1 (the render), or not (training)
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

// A&S 4.4.45 asin, |err| <= 6.8e-5 (blackstar_tpu/stars/grid.py::_fast_asin).
template <typename T>
__device__ __forceinline__ T fast_asin(T z) {
  const T az = fabs(z);
  const T p = T(1.5707288) + az * (T(-0.2121144) + az * (T(0.0742610) + az * T(-0.0187293)));
  const T r = T(kPi / 2) - sqrt(fmax(T(1) - az, T(0))) * p;
  return z < T(0) ? -r : r;
}

// atan2 folded into [0, 2 pi), octant reduction + odd minimax polynomial
// (blackstar_tpu/stars/grid.py::_fast_ra).
template <typename T>
__device__ __forceinline__ T fast_ra(T ny, T nx) {
  const T ax = fabs(nx), ay = fabs(ny);
  const T hi = fmax(ax, ay), lo = fmin(ax, ay);
  const T t = lo / fmax(hi, T(1e-30));
  const T u = t * t;
  T p = T(0.00782548);
  p = T(-0.03689863) + u * p;
  p = T(0.08374156) + u * p;
  p = T(-0.13480406) + u * p;
  p = T(0.19879872) + u * p;
  p = T(-0.33326375) + u * p;
  p = T(0.99999933) + u * p;
  T a = t * p;
  if (ay > ax) a = T(kPi / 2) - a;
  if (nx < T(0)) a = T(kPi) - a;
  if (ny < T(0)) a = T(2.0 * kPi) - a;
  return a;
}

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

template <typename T>
__device__ __forceinline__ int64_t cell_id(T nx, T ny, T nz, const LookupParams<T>& P) {
  const T zc = fmin(fmax(nz, T(-1)), T(1));
  T dec, ra;
  if (P.fast_cells) {
    dec = fast_asin(zc);
    ra = fast_ra(ny, nx);
  } else {
    dec = asin(zc);
    ra = atan2(ny, nx);
    if (ra < T(0)) ra = ra + T(2.0 * kPi);
  }
  int ring = (int)floor((dec + T(kPi / 2)) / P.delta);
  int col = (int)floor(ra / T(2.0 * kPi) * T(P.n_cols));
  ring = min(max(ring, 0), P.n_rings - 1);
  col = min(max(col, 0), P.n_cols - 1);
  return (int64_t)ring * P.n_cols + col;
}

template <typename T>
__device__ __forceinline__ void accumulate(const T* __restrict__ row, int slots,
                                           T nx, T ny, T nz,
                                           const LookupParams<T>& P,
                                           T& ar, T& ag, T& ab) {
  for (int k = 0; k < slots; ++k) {
    T s[kRow];
    load_slot(row + k * kRow, s);
    const T dx = s[0] - nx;
    const T dy = s[1] - ny;
    const T dz = s[2] - nz;
    const T d2 = dx * dx + dy * dy + dz * dz;
    // Outside the cutoff the plain version adds exactly 0 (and sentinel
    // slots always land here), so skipping the slot changes no sum.
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
star_lookup_kernel(const T* __restrict__ vx, const T* __restrict__ vy,
                   const T* __restrict__ vz, const bool* __restrict__ active,
                   int64_t n, const T* __restrict__ cell_data,
                   const T* __restrict__ ovf_data,
                   const int32_t* __restrict__ ovf_octets, LookupParams<T> P,
                   T* __restrict__ out) {  // (3, n) planes
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T ar = T(0), ag = T(0), ab = T(0);
  if (active[i]) {
    const T x = vx[i], y = vy[i], z = vz[i];
    const T inv = rsqrt_of(x * x + y * y + z * z);
    const T nx = x * inv, ny = y * inv, nz = z * inv;
    const T* row = cell_data + cell_id(nx, ny, nz, P) * P.k0 * kRow;
    accumulate(row, P.k0, nx, ny, nz, P, ar, ag, ab);
    const int ptr = (int)row[7];
    if (ptr > 0) {
      accumulate(ovf_data + (int64_t)ptr * P.k1 * kRow, ovf_octets[ptr] * 8,
                 nx, ny, nz, P, ar, ag, ab);
    }
    if (P.clamp) {
      ar = fmin(ar, T(1));
      ag = fmin(ag, T(1));
      ab = fmin(ab, T(1));
    }
  }
  out[i] = ar;
  out[n + i] = ag;
  out[2 * n + i] = ab;
}

// Gradient mode of accumulate(): the five channels (gx, gy, gz) w.r.t. the
// normalised direction, gi and gs, for the cotangents (wr, wg, wb).
template <typename T>
__device__ __forceinline__ void accumulate_vjp(const T* __restrict__ row, int slots,
                                               T nx, T ny, T nz, T wr, T wg, T wb,
                                               const LookupParams<T>& P, T& gx, T& gy,
                                               T& gz, T& gi, T& gs) {
  for (int k = 0; k < slots; ++k) {
    T s[kRow];
    load_slot(row + k * kRow, s);
    const T dx = s[0] - nx;
    const T dy = s[1] - ny;
    const T dz = s[2] - nz;
    const T d2 = dx * dx + dy * dy + dz * dz;
    // Outside the cutoff e = 0: every channel's term is exactly 0.
    if (d2 <= P.r2lim) {
      const T logb0 = P.a * (T(kMaxBrightness) - s[3]);
      const T e = exp(logb0 - d2 * P.inv2w2);
      const T u = fmin(T(1), e);
      const T cw = wr * (T(1) + P.saturation * s[4]) + wg * (T(1) + P.saturation * s[5]) +
                   wb * (T(1) + P.saturation * s[6]);
      const T hw = wr * s[4] + wg * s[5] + wb * s[6];
      const T due = e < T(1) ? T(1) : (e == T(1) ? T(0.5) : T(0));
      const T gd2 = (P.intensity * cw) * (due * e) * (-P.inv2w2);
      gx = gx - T(2) * gd2 * dx;
      gy = gy - T(2) * gd2 * dy;
      gz = gz - T(2) * gd2 * dz;
      gi = gi + u * cw;
      gs = gs + (u * P.intensity) * hw;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
star_vjp_kernel(const T* __restrict__ vx, const T* __restrict__ vy,
                const T* __restrict__ vz, const bool* __restrict__ active,
                const T* __restrict__ w,  // (3, n) cotangents of the unclamped sums
                int64_t n, const T* __restrict__ cell_data,
                const T* __restrict__ ovf_data,
                const int32_t* __restrict__ ovf_octets, LookupParams<T> P,
                T* __restrict__ gvel,       // (3, n) out
                T* __restrict__ partials) {  // (blocks, 2) out: gi, gs
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T gi = T(0), gs = T(0);
  if (i < n) {
    T ox = T(0), oy = T(0), oz = T(0);
    if (active[i]) {
      const T x = vx[i], y = vy[i], z = vz[i];
      const T inv = rsqrt_of(x * x + y * y + z * z);
      const T nx = x * inv, ny = y * inv, nz = z * inv;
      const T wr = w[i], wg = w[n + i], wb = w[2 * n + i];
      T gx = T(0), gy = T(0), gz = T(0);
      const T* row = cell_data + cell_id(nx, ny, nz, P) * P.k0 * kRow;
      accumulate_vjp(row, P.k0, nx, ny, nz, wr, wg, wb, P, gx, gy, gz, gi, gs);
      const int ptr = (int)row[7];
      if (ptr > 0) {
        accumulate_vjp(ovf_data + (int64_t)ptr * P.k1 * kRow, ovf_octets[ptr] * 8, nx, ny,
                       nz, wr, wg, wb, P, gx, gy, gz, gi, gs);
      }
      // Through n = v / |v|: dn_i/dv_j = (delta_ij - n_i n_j) / |v|.
      const T gdotn = gx * nx + gy * ny + gz * nz;
      ox = (gx - nx * gdotn) * inv;
      oy = (gy - ny * gdotn) * inv;
      oz = (gz - nz * gdotn) * inv;
    }
    gvel[i] = ox;
    gvel[n + i] = oy;
    gvel[2 * n + i] = oz;
  }

  // Block sums of gi and gs in a fixed order; every thread reaches this.
  __shared__ T warp_sum[kThreads / 32][2];
  T v[2] = {gi, gs};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T s = v[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    T s = warp_sum[0][threadIdx.x];
    for (int q = 1; q < kThreads / 32; ++q) s += warp_sum[q][threadIdx.x];
    partials[(int64_t)blockIdx.x * 2 + threadIdx.x] = s;
  }
}

template <typename T>
LookupParams<T> make_params(double intensity, double saturation, double a, double r2lim,
                            double inv2w2, double delta, int n_rings, int n_cols, int k0,
                            int k1, int fast_cells, int clamp) {
  LookupParams<T> P;
  P.intensity = T(intensity);
  P.saturation = T(saturation);
  P.a = T(a);
  P.r2lim = T(r2lim);
  P.inv2w2 = T(inv2w2);
  P.delta = T(delta);
  P.n_rings = n_rings;
  P.n_cols = n_cols;
  P.k0 = k0;
  P.k1 = k1;
  P.fast_cells = fast_cells;
  P.clamp = clamp;
  return P;
}

template <typename T>
int launch_vjp(const void* vx, const void* vy, const void* vz, const void* active,
               const void* w, int64_t n, const void* cell_data, const void* ovf_data,
               const void* ovf_octets, double intensity, double saturation, double a,
               double r2lim, double inv2w2, double delta, int n_rings, int n_cols, int k0,
               int k1, int fast_cells, void* gvel, void* partials, void* stream) {
  const LookupParams<T> P = make_params<T>(intensity, saturation, a, r2lim, inv2w2, delta,
                                           n_rings, n_cols, k0, k1, fast_cells, 0);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  star_vjp_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const bool*)active, (const T*)w, n,
      (const T*)cell_data, (const T*)ovf_data, (const int32_t*)ovf_octets, P, (T*)gvel,
      (T*)partials);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* vx, const void* vy, const void* vz, const void* active,
           int64_t n, const void* cell_data, const void* ovf_data,
           const void* ovf_octets, double intensity, double saturation,
           double a, double r2lim, double inv2w2, double delta, int n_rings,
           int n_cols, int k0, int k1, int fast_cells, int clamp, void* out,
           void* stream) {
  const LookupParams<T> P = make_params<T>(intensity, saturation, a, r2lim, inv2w2, delta,
                                           n_rings, n_cols, k0, k1, fast_cells, clamp);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  star_lookup_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const bool*)active, n,
      (const T*)cell_data, (const T*)ovf_data, (const int32_t*)ovf_octets, P,
      (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bs_star_lookup_f32(const void* vx, const void* vy, const void* vz,
                       const void* active, int64_t n, const void* cell_data,
                       const void* ovf_data, const void* ovf_octets,
                       double intensity, double saturation, double a,
                       double r2lim, double inv2w2, double delta, int n_rings,
                       int n_cols, int k0, int k1, int fast_cells, int clamp, void* out,
                       void* stream) {
  return launch<float>(vx, vy, vz, active, n, cell_data, ovf_data, ovf_octets,
                       intensity, saturation, a, r2lim, inv2w2, delta, n_rings,
                       n_cols, k0, k1, fast_cells, clamp, out, stream);
}

int bs_star_lookup_f64(const void* vx, const void* vy, const void* vz,
                       const void* active, int64_t n, const void* cell_data,
                       const void* ovf_data, const void* ovf_octets,
                       double intensity, double saturation, double a,
                       double r2lim, double inv2w2, double delta, int n_rings,
                       int n_cols, int k0, int k1, int fast_cells, int clamp, void* out,
                       void* stream) {
  return launch<double>(vx, vy, vz, active, n, cell_data, ovf_data, ovf_octets,
                        intensity, saturation, a, r2lim, inv2w2, delta, n_rings,
                        n_cols, k0, k1, fast_cells, clamp, out, stream);
}

int bs_star_vjp_f32(const void* vx, const void* vy, const void* vz, const void* active,
                    const void* w, int64_t n, const void* cell_data, const void* ovf_data,
                    const void* ovf_octets, double intensity, double saturation, double a,
                    double r2lim, double inv2w2, double delta, int n_rings, int n_cols,
                    int k0, int k1, int fast_cells, void* gvel, void* partials,
                    void* stream) {
  return launch_vjp<float>(vx, vy, vz, active, w, n, cell_data, ovf_data, ovf_octets,
                           intensity, saturation, a, r2lim, inv2w2, delta, n_rings, n_cols,
                           k0, k1, fast_cells, gvel, partials, stream);
}

int bs_star_vjp_f64(const void* vx, const void* vy, const void* vz, const void* active,
                    const void* w, int64_t n, const void* cell_data, const void* ovf_data,
                    const void* ovf_octets, double intensity, double saturation, double a,
                    double r2lim, double inv2w2, double delta, int n_rings, int n_cols,
                    int k0, int k1, int fast_cells, void* gvel, void* partials,
                    void* stream) {
  return launch_vjp<double>(vx, vy, vz, active, w, n, cell_data, ovf_data, ovf_octets,
                            intensity, saturation, a, r2lim, inv2w2, delta, n_rings, n_cols,
                            k0, k1, fast_cells, gvel, partials, stream);
}

}  // extern "C"
