// The row walk that the star kernels B3 (star lookup) and B4 (star VJP)
// share: which ray each thread takes, the ray's cell id, the walk over its
// cell's base row and the used octets of its overflow row, and the per-slot
// math in both modes (the colour sums, and their gradient).
//
// Layout. A warp takes 32 rays, one a lane: 32 consecutive rays, or, when
// the caller gives the image width W of a row-major W x H frame, an 8 x 4
// pixel tile (tiles in row-major order; lanes of a tile that fall outside
// the image take no ray). The layout decides which thread takes which ray
// and never changes a result. Each lane computes its own ray's direction,
// cell id, overflow pointer and used octets. Then the warp walks its rays'
// rows in 4 rounds: in round t the 4-lane group g walks the rows of the ray
// of its lane t (lane j on slots j, j + 4, j + 8, ...), and the group's
// lanes add their partial sums in a fixed order (a butterfly over lanes 2
// and 1 apart), which lane t keeps. So one load of the warp reads 8 rays'
// rows, 4 consecutive slots (128 bytes in float32, one cache line) of each,
// where a lane-per-ray walk reads one slot of each of up to 32 rows; and the
// overflow row, whose used length is whole octets, is walked by the same
// loop with no lane left behind on another ray's longer row.
//
// Per slot only the head (x, y, z, mag) is read for the cutoff test; the
// colour basis (H_r, H_g, H_b) is read for the few slots inside it.
//
// The per-slot arithmetic is that of the plain versions
// (blackstar_tpu_torch/stars/grid.py: StarGrid._slot_sum and _slot_vjp):
// the difference-first d^2, the (3w)^2 cutoff,
// min(1, exp(a (950 - mag) - d^2 / (2 w^2))), and du/de 1 below the cap,
// 0 above it and 0.5 at an exact tie. Both kernels build with -fmad=false,
// so each float32 operation rounds as the plain version's does; only the
// order of the per-ray slot sums differs.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace star {

constexpr int kThreads = 128;  // threads per block: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 4;      // lanes that walk one ray's rows together
constexpr int kOctet = 8;      // slots in an octet, the overflow rows' unit of length
constexpr int kTileW = 8;      // pixels a warp takes with the width hint: kTileW x kTileH
constexpr int kTileH = 4;
constexpr int kRow = 8;        // floats per slot: x y z mag H_r H_g H_b aux
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;
constexpr double kMaxBrightness = 950.0;

template <typename T>
struct Grid {
  const T* cell_data;          // (C, k0 * 8)
  const T* ovf_data;           // (R, k1 * 8)
  const int32_t* ovf_octets;   // (R,)
  const T* intensity;          // 0-d, on the card: starIntensity
  const T* saturation;         // 0-d, on the card: starSaturation
  T a;                         // ln 2 / 50
  T r2lim;                     // (3w)^2
  T inv2w2;                    // 1 / (2 w^2)
  T delta;                     // pi / n_rings
  int n_rings;
  int n_cols;
  int k0;                      // slots per base row
  int k1;                      // slots per overflow row
  int fast_cells;
};

struct Rays {
  int64_t n;
  int width;                   // the frame's width, or 0: 32 consecutive rays a warp
};

// The ray that lane `lane` of warp `warp` takes, or -1.
__device__ __forceinline__ int64_t ray_of(int64_t warp, int lane, const Rays& R) {
  if (R.width > 0) {
    const int64_t tiles_x = (R.width + kTileW - 1) / kTileW;
    const int64_t x = (warp % tiles_x) * kTileW + lane % kTileW;
    const int64_t y = (warp / tiles_x) * kTileH + lane / kTileW;
    return (x < R.width && y < R.n / R.width) ? y * R.width + x : -1;
  }
  const int64_t i = warp * 32 + lane;
  return i < R.n ? i : -1;
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

// The cell id by the plain version's rule: the fast bounded-error asin and
// atan2 when the grid's build margin absorbs their error, else the exact
// ones, so the candidate set matches.
template <typename T>
__device__ __forceinline__ int cell_id(T nx, T ny, T nz, const Grid<T>& G) {
  const T zc = fmin(fmax(nz, T(-1)), T(1));
  T dec, ra;
  if (G.fast_cells) {
    dec = fast_asin(zc);
    ra = fast_ra(ny, nx);
  } else {
    dec = asin(zc);
    ra = atan2(ny, nx);
    if (ra < T(0)) ra = ra + T(2.0 * kPi);
  }
  int ring = (int)floor((dec + T(kPi / 2)) / G.delta);
  int col = (int)floor(ra / T(2.0 * kPi) * T(G.n_cols));
  ring = min(max(ring, 0), G.n_rings - 1);
  col = min(max(col, 0), G.n_cols - 1);
  return ring * G.n_cols + col;
}

// A slot's head (x, y, z, mag) and its colour basis (H_r, H_g, H_b, aux).
template <typename T> struct Quad { T x, y, z, w; };

__device__ __forceinline__ Quad<float> load_quad(const float* p) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Quad<double> load_quad(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

// What a lane knows of its own ray, and what it hands its group each round.
template <typename T>
struct Lane {
  int64_t ray;    // the ray this lane takes, or -1
  int gl;         // lane within its group of kLanes
  T nx, ny, nz;   // the normalised direction
  T inv;          // 1 / |v|
  int cell;       // base row, or -1: no walk (no ray, or not escaped)
  int ptr;        // overflow row, 0 for none
  int octets;     // used octets of the overflow row
};

template <typename T>
__device__ __forceinline__ Lane<T> lane_ray(const T* __restrict__ vx, const T* __restrict__ vy,
                                            const T* __restrict__ vz,
                                            const bool* __restrict__ active, const Rays& R,
                                            const Grid<T>& G) {
  Lane<T> L;
  const int lane = threadIdx.x & 31;
  L.ray = ray_of((int64_t)blockIdx.x * kWarps + threadIdx.x / 32, lane, R);
  L.gl = lane % kLanes;
  L.nx = L.ny = L.nz = L.inv = T(0);
  L.cell = -1;
  L.ptr = L.octets = 0;
  if (L.ray >= 0 && active[L.ray]) {
    const T x = vx[L.ray], y = vy[L.ray], z = vz[L.ray];
    L.inv = rsqrt_of(x * x + y * y + z * z);
    L.nx = x * L.inv;
    L.ny = y * L.inv;
    L.nz = z * L.inv;
    L.cell = cell_id(L.nx, L.ny, L.nz, G);
    L.ptr = (int)G.cell_data[(int64_t)L.cell * G.k0 * kRow + 7];
    L.octets = L.ptr > 0 ? G.ovf_octets[L.ptr] : 0;
  }
  return L;
}

// The ray of lane t of this lane's group: its direction and rows.
template <typename T>
struct Walk {
  T nx, ny, nz;
  int cell, ptr, octets;
};

template <typename T>
__device__ __forceinline__ Walk<T> round_ray(const Lane<T>& L, int t) {
  Walk<T> W;
  W.nx = __shfl_sync(kFull, L.nx, t, kLanes);
  W.ny = __shfl_sync(kFull, L.ny, t, kLanes);
  W.nz = __shfl_sync(kFull, L.nz, t, kLanes);
  W.cell = __shfl_sync(kFull, L.cell, t, kLanes);
  W.ptr = __shfl_sync(kFull, L.ptr, t, kLanes);
  W.octets = __shfl_sync(kFull, L.octets, t, kLanes);
  return W;
}

// Calls slot(head, slot pointer) on this lane's slots of the round's ray:
// slots gl, gl + kLanes, ... of its base row, then of the used octets of
// its overflow row; four heads are loaded before any is used.
template <typename T, typename Slot>
__device__ __forceinline__ void walk_rows(const Walk<T>& W, int gl, const Grid<T>& G,
                                          Slot&& slot) {
  if (W.cell < 0) return;
  const T* rows[2] = {G.cell_data + (int64_t)W.cell * G.k0 * kRow,
                      G.ovf_data + (int64_t)W.ptr * G.k1 * kRow};
  const int counts[2] = {G.k0, W.octets * kOctet};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const T* row = rows[r];
    for (int s0 = gl; s0 < counts[r]; s0 += 4 * kLanes) {
      Quad<T> head[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u * kLanes < counts[r]) head[u] = load_quad(row + (int64_t)(s0 + u * kLanes) * kRow);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u * kLanes < counts[r]) slot(head[u], row + (int64_t)(s0 + u * kLanes) * kRow);
      }
    }
  }
}

// Sums v over the lanes of each group, in a fixed order; every lane of the
// group gets the sum.
template <typename T, int K>
__device__ __forceinline__ void group_sum(T (&v)[K]) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = v[k] + __shfl_xor_sync(kFull, v[k], off, kLanes);
  }
}

// Shading constants of one launch.
template <typename T>
struct Shade {
  T a, r2lim, inv2w2, intensity, saturation;
};

template <typename T>
__device__ __forceinline__ Shade<T> shade_of(const Grid<T>& G) {
  return {G.a, G.r2lim, G.inv2w2, *G.intensity, *G.saturation};
}

// B3's slot: adds the star's colour to (ar, ag, ab) and sets hit when the
// slot is inside the cutoff. Outside it the plain version adds exactly 0
// (sentinel slots always land there), so skipping the slot changes no sum.
template <typename T>
__device__ __forceinline__ void slot_colour(const Quad<T>& h, const T* slot, const Walk<T>& W,
                                            const Shade<T>& S, T (&acc)[3], bool& hit) {
  const T dx = h.x - W.nx;
  const T dy = h.y - W.ny;
  const T dz = h.z - W.nz;
  const T d2 = dx * dx + dy * dy + dz * dz;
  if (d2 <= S.r2lim) {
    hit = true;
    const Quad<T> c = load_quad(slot + 4);
    const T logb0 = S.a * (T(kMaxBrightness) - h.w);
    const T e = exp(logb0 - d2 * S.inv2w2);
    const T val = fmin(T(1), e) * S.intensity;
    acc[0] = acc[0] + val * (T(1) + S.saturation * c.x);
    acc[1] = acc[1] + val * (T(1) + S.saturation * c.y);
    acc[2] = acc[2] + val * (T(1) + S.saturation * c.z);
  }
}

// B4's slot: the five gradient channels of the slot math for the
// cotangents (wr, wg, wb) of the unclamped sums:
//   gd2 = I (sum_c w_c (1 + sat H_c)) (du/de) e (-1 / (2 w^2)),
//   g_n -= 2 gd2 (star - n),  gI += u sum_c w_c (1 + sat H_c),
//   gS += u I sum_c w_c H_c.
// Outside the cutoff e = 0 and every term is exactly 0.
template <typename T>
__device__ __forceinline__ void slot_grad(const Quad<T>& h, const T* slot, const Walk<T>& W,
                                          T wr, T wg, T wb, const Shade<T>& S, T (&g)[3],
                                          T& gi, T& gs, bool& hit) {
  const T dx = h.x - W.nx;
  const T dy = h.y - W.ny;
  const T dz = h.z - W.nz;
  const T d2 = dx * dx + dy * dy + dz * dz;
  if (d2 <= S.r2lim) {
    hit = true;
    const Quad<T> c = load_quad(slot + 4);
    const T logb0 = S.a * (T(kMaxBrightness) - h.w);
    const T e = exp(logb0 - d2 * S.inv2w2);
    const T u = fmin(T(1), e);
    const T cw = wr * (T(1) + S.saturation * c.x) + wg * (T(1) + S.saturation * c.y) +
                 wb * (T(1) + S.saturation * c.z);
    const T hw = wr * c.x + wg * c.y + wb * c.z;
    const T due = e < T(1) ? T(1) : (e == T(1) ? T(0.5) : T(0));
    const T gd2 = (S.intensity * cw) * (due * e) * (-S.inv2w2);
    g[0] = g[0] - T(2) * gd2 * dx;
    g[1] = g[1] - T(2) * gd2 * dy;
    g[2] = g[2] - T(2) * gd2 * dz;
    gi = gi + u * cw;
    gs = gs + (u * S.intensity) * hw;
  }
}

}  // namespace star
