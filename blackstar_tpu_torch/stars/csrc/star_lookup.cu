// Per-ray star lookup (kernel B3) and star VJP (kernel B4), on the row walk
// of star_walk.cuh.
//
// B3 computes what blackstar_tpu_torch/stars/grid.py::StarGrid.lookup
// computes, with the semantics of the JAX package's StarGrid._lookup_block
// (blackstar_tpu/stars/grid.py:717-815, an XLA stage: the JAX package has no
// Pallas kernel for it; scripts/proto_window_kernel.py holds an unshipped TPU
// prototype of the same function). It is the exact `starLookup` of
// StarMap.hs:93-115. Per ray: normalise the direction by rsqrt, take the cell
// id, sum the colours of the slots of the cell's base row and of the used
// octets of its overflow row (behind the pointer packed into (int) row[7] of
// slot 0), clamp each channel at 1 (unless the caller asks for the unclamped
// sums, the forward of the differentiable star stage, whose clamp is applied
// outside as ordinary autograd, as in blackstar_tpu/stars/diff.py:134-138),
// and write 0 where the ray is not escaped.
//
// B4 is the reverse of the unclamped sums. It replaces the JAX package's
// hand-derived star VJP, StarGrid._slot_math's gradient mode
// (blackstar_tpu/stars/grid.py:377, driven by the custom VJP of
// blackstar_tpu/stars/diff.py:74), an XLA stage with no Pallas kernel; its
// plain twin is StarGrid.lookup_vjp. It walks the same rows as B3 with the
// gradient mode of the slot math, chains the direction gradient through
// n = v / |v| into d/d(vel), and writes per-block sums of gI and gS (a fixed-
// order block reduction, no atomics), which the wrapper sums. Rays that did
// not escape write zero gradients (their output is the constant 0).
//
// What bounds them on an H100: each escaped ray reads its cell's base row
// (1 KB in float32 at K0 = 32) and, in dense cells, the used octets of an
// overflow row; the 1080p frame's ~2M escaped rays share ~230k distinct base
// rows. A lane-per-ray walk (the earlier design) had each warp load touch
// one 16-byte piece of each of up to 32 rows, so L1 served a wavefront per
// row for 16 useful bytes. Here a warp load reads 4 consecutive slots of
// each of 8 rays' rows (star_walk.cuh), and only the heads of the slots
// outside the cutoff. The intensity and saturation are read from the card,
// so the wrappers never wait for the device.
//
// Rounding: -fmad=false, so no multiply-add is contracted and each float32
// operation rounds as the plain PyTorch version (one kernel per operation)
// rounds. The f32 PSF exp(... - d^2 * 2e6) amplifies any rounding difference
// in d^2 (DESIGN.md section 3); the JAX package's own two float32 star paths
// differ by up to 3e-2 at isolated pixels. The kernels and the plain versions
// differ only in the order of the per-ray slot sums (and of B4's gI and gS
// sums) and, rarely, in the cell a ray falls in when the plain version rounds
// ra / 2pi differently; with the build margin both cells hold every star in
// reach. The gates are mean 1e-6 and max 3e-2 (f32), 1e-9 (f64).
//
// Templated on float (the render and training paths) and double (the
// on-card gates).

#include "star_walk.cuh"

namespace {

using namespace star;

template <typename T>
__global__ void __launch_bounds__(kThreads)
star_lookup_kernel(const T* __restrict__ vx, const T* __restrict__ vy,
                   const T* __restrict__ vz, const bool* __restrict__ active, Rays R,
                   Grid<T> G, int clamp, T* __restrict__ out) {  // (3, n) planes
  const Lane<T> me = lane_ray(vx, vy, vz, active, R, G);
  T o[3] = {T(0), T(0), T(0)};
  if (__any_sync(kFull, me.cell >= 0)) {
    const Shade<T> S = shade_of(G);
    for (int t = 0; t < kLanes; ++t) {
      const Walk<T> W = round_ray(me, t);
      T acc[3] = {T(0), T(0), T(0)};
      bool hit = false;
      walk_rows(W, me.gl, G, [&](const Quad<T>& h, const T* slot) {
        slot_colour(h, slot, W, S, acc, hit);
      });
      if (__any_sync(kFull, hit)) group_sum(acc);  // else every sum is 0
      if (me.gl == t) {
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c] = acc[c];
      }
    }
  }
  if (me.ray < 0) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c * R.n + me.ray] = clamp ? fmin(o[c], T(1)) : o[c];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
star_vjp_kernel(const T* __restrict__ vx, const T* __restrict__ vy,
                const T* __restrict__ vz, const bool* __restrict__ active,
                const T* __restrict__ w,  // (3, n) cotangents of the unclamped sums
                Rays R, Grid<T> G,
                T* __restrict__ gvel,        // (3, n) out
                T* __restrict__ partials) {  // (blocks, 2) out: gi, gs
  const Lane<T> me = lane_ray(vx, vy, vz, active, R, G);
  T gi = T(0), gs = T(0);
  T o[3] = {T(0), T(0), T(0)};
  if (__any_sync(kFull, me.cell >= 0)) {
    const Shade<T> S = shade_of(G);
    const bool live = me.cell >= 0;
    const T wr = live ? w[me.ray] : T(0);
    const T wg = live ? w[R.n + me.ray] : T(0);
    const T wb = live ? w[2 * R.n + me.ray] : T(0);
    for (int t = 0; t < kLanes; ++t) {
      const Walk<T> W = round_ray(me, t);
      const T wr_t = __shfl_sync(kFull, wr, t, kLanes);
      const T wg_t = __shfl_sync(kFull, wg, t, kLanes);
      const T wb_t = __shfl_sync(kFull, wb, t, kLanes);
      T g[3] = {T(0), T(0), T(0)};
      bool hit = false;
      walk_rows(W, me.gl, G, [&](const Quad<T>& h, const T* slot) {
        slot_grad(h, slot, W, wr_t, wg_t, wb_t, S, g, gi, gs, hit);
      });
      if (__any_sync(kFull, hit)) group_sum(g);  // else every sum is 0
      if (me.gl == t && live) {
        // Through n = v / |v|: dn_i/dv_j = (delta_ij - n_i n_j) / |v|.
        const T gdotn = g[0] * me.nx + g[1] * me.ny + g[2] * me.nz;
        o[0] = (g[0] - me.nx * gdotn) * me.inv;
        o[1] = (g[1] - me.ny * gdotn) * me.inv;
        o[2] = (g[2] - me.nz * gdotn) * me.inv;
      }
    }
  }
  if (me.ray >= 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gvel[c * R.n + me.ray] = o[c];
  }

  // Block sums of every lane's gi and gs in a fixed order; every thread
  // reaches this.
  __shared__ T warp_sum[kWarps][2];
  T v[2] = {gi, gs};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    T s = v[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    T s = warp_sum[0][threadIdx.x];
    for (int q = 1; q < kWarps; ++q) s += warp_sum[q][threadIdx.x];
    partials[(int64_t)blockIdx.x * 2 + threadIdx.x] = s;
  }
}

template <typename T>
Grid<T> make_grid(const void* cell_data, const void* ovf_data, const void* ovf_octets,
                  const void* intensity, const void* saturation, double a, double r2lim,
                  double inv2w2, double delta, int n_rings, int n_cols, int k0, int k1,
                  int fast_cells) {
  Grid<T> G;
  G.cell_data = (const T*)cell_data;
  G.ovf_data = (const T*)ovf_data;
  G.ovf_octets = (const int32_t*)ovf_octets;
  G.intensity = (const T*)intensity;
  G.saturation = (const T*)saturation;
  G.a = T(a);
  G.r2lim = T(r2lim);
  G.inv2w2 = T(inv2w2);
  G.delta = T(delta);
  G.n_rings = n_rings;
  G.n_cols = n_cols;
  G.k0 = k0;
  G.k1 = k1;
  G.fast_cells = fast_cells;
  return G;
}

// Warps of a launch: one per 32 consecutive rays, or per 8 x 4 tile of the
// width x (n / width) frame.
int64_t warps_of(int64_t n, int width) {
  if (width > 0) {
    return ((width + kTileW - 1) / kTileW) * ((n / width + kTileH - 1) / kTileH);
  }
  return (n + 31) / 32;
}

}  // namespace

#define STAR_GRID_ARGS                                                                       \
  const void *cell_data, const void *ovf_data, const void *ovf_octets, const void *intensity, \
      const void *saturation, double a, double r2lim, double inv2w2, double delta,           \
      int n_rings, int n_cols, int k0, int k1, int fast_cells
#define STAR_GRID(T)                                                                   \
  make_grid<T>(cell_data, ovf_data, ovf_octets, intensity, saturation, a, r2lim, inv2w2, \
               delta, n_rings, n_cols, k0, k1, fast_cells)

namespace {

template <typename T>
int launch(const void* vx, const void* vy, const void* vz, const void* active, int64_t n,
           int width, Grid<T> G, int clamp, void* out, void* stream) {
  const int64_t blocks = (warps_of(n, width) + kWarps - 1) / kWarps;
  star_lookup_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const bool*)active, Rays{n, width}, G, clamp,
      (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vjp(const void* vx, const void* vy, const void* vz, const void* active,
               const void* w, int64_t n, int width, Grid<T> G, void* gvel, void* partials,
               void* stream) {
  const int64_t blocks = (warps_of(n, width) + kWarps - 1) / kWarps;
  star_vjp_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const bool*)active, (const T*)w,
      Rays{n, width}, G, (T*)gvel, (T*)partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// `width` is the frame's width when the n rays are a row-major width x
// (n / width) frame, else 0; it decides only which thread takes which ray.
int bs_star_lookup_f32(const void* vx, const void* vy, const void* vz, const void* active,
                       int64_t n, int width, STAR_GRID_ARGS, int clamp, void* out,
                       void* stream) {
  return launch<float>(vx, vy, vz, active, n, width, STAR_GRID(float), clamp, out, stream);
}

int bs_star_lookup_f64(const void* vx, const void* vy, const void* vz, const void* active,
                       int64_t n, int width, STAR_GRID_ARGS, int clamp, void* out,
                       void* stream) {
  return launch<double>(vx, vy, vz, active, n, width, STAR_GRID(double), clamp, out, stream);
}

int bs_star_vjp_f32(const void* vx, const void* vy, const void* vz, const void* active,
                    const void* w, int64_t n, int width, STAR_GRID_ARGS, void* gvel,
                    void* partials, void* stream) {
  return launch_vjp<float>(vx, vy, vz, active, w, n, width, STAR_GRID(float), gvel, partials,
                           stream);
}

int bs_star_vjp_f64(const void* vx, const void* vy, const void* vz, const void* active,
                    const void* w, int64_t n, int width, STAR_GRID_ARGS, void* gvel,
                    void* partials, void* stream) {
  return launch_vjp<double>(vx, vy, vz, active, w, n, width, STAR_GRID(double), gvel,
                            partials, stream);
}

}  // extern "C"
