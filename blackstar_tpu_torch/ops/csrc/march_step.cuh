// One step of the geodesic march, shared by the forward kernel B1 (march.cu)
// and the adjoint kernel B2 (march_adjoint.cu).
//
// B2 replays each 16-step segment from the checkpoints B1 wrote and must
// pass through B1's states bit for bit: its status is its replayed final
// state's class. So the two kernels take every operation of a step from
// this one file: the ray's constant, the acceleration, the RK4 step (with
// the stage positions B2's VJP needs), the classification, the disk
// candidate test and the crossing. Both build with -fmad=false, so nothing
// is fused but what is written here as a fused multiply-add, and the two
// compilations round every operation alike.
//
// Arithmetic, as the TPU kernel takes it (blackstar_tpu/ops/march_pallas.py,
// accel_r2) with the card's FMA:
//   * r^-5 by rsqrt powers in the TPU kernel's order: inv = rsqrt(r^2),
//     inv2 = inv inv, s = coef inv inv2 inv2 (one MUFU instruction in float;
//     rsqrtf is within 2 ulp, rsqrt for double within 1 ulp);
//   * an explicit fma wherever the step multiplies and then adds: r^2, the
//     stage states (q2 = fma(h/2, v, p), ...) and the final combination;
//   * the rare disk crossing (a divide, a square root and sin(pi frac^2),
//     only on a candidate step) stays IEEE-rounded; sinpi takes the sine
//     without sin's slow argument reduction and its local-memory frame.
// The plain march (geodesic.py) rounds otherwise (a divide for r^-5, no
// fusion), so in float32 the kernels follow their own orbits: they are held
// to the float64 plain march no worse than the float32 plain march is
// (scripts/march_accuracy.py), and in float64 within 1e-7 of it.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kActive = 0;
constexpr int kEscaped = 1;
constexpr int kHorizon = 2;
constexpr int kSeg = 16;  // advancing steps per checkpoint segment (geodesic.SEG_LEN)

template <typename T>
struct V3 {
  T x, y, z;
};

// The RK4 stage positions of one step.
template <typename T>
struct Stages {
  V3<T> q2, q3, q4;
};

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }
__device__ __forceinline__ float fma_of(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float sinpi_of(float x) { return sinpif(x); }
__device__ __forceinline__ double sinpi_of(double x) { return sinpi(x); }

template <typename T>
__device__ __forceinline__ int sign_of(T x) {
  return (x > T(0)) - (x < T(0));
}

// |q|^2 = fma(z, z, fma(y, y, x x)).
template <typename T>
__device__ __forceinline__ T r2_of(const V3<T>& q) {
  return fma_of(q.z, q.z, fma_of(q.y, q.y, q.x * q.x));
}

// a + s b, component by component, each a fused multiply-add.
template <typename T>
__device__ __forceinline__ V3<T> fma3(T s, const V3<T>& b, const V3<T>& a) {
  return {fma_of(s, b.x, a.x), fma_of(s, b.y, a.y), fma_of(s, b.z, a.z)};
}

// The ray's constant coef = -1.5 rs h^2, with h^2 = |p0 x v0|^2 the conserved
// angular momentum (Raytracer.hs:73); c = p0 x v0 and h^2 for B2's chain.
template <typename T>
__device__ __forceinline__ T ray_coef(const V3<T>& p0, const V3<T>& v0, T mass, V3<T>& c,
                                      T& h2) {
  c = {p0.y * v0.z - p0.z * v0.y, p0.z * v0.x - p0.x * v0.z, p0.x * v0.y - p0.y * v0.x};
  h2 = c.x * c.x + c.y * c.y + c.z * c.z;
  return T(-1.5) * mass * h2;
}

// coef q / |q|^5 from r2 = |q|^2 (r2_of(q)).
template <typename T>
__device__ __forceinline__ V3<T> accel(T coef, const V3<T>& q, T r2) {
  const T inv = rsqrt_of(r2);
  const T inv2 = inv * inv;
  const T s = coef * inv * inv2 * inv2;
  return {s * q.x, s * q.y, s * q.z};
}

// The first three stages of the RK4 step from (p, v), r2 = r2_of(p): the
// stage positions, and the accelerations a1, a2 and velocities u2, u3 that
// the rest of the step takes. B2 recomputes the stages with this alone.
template <typename T>
__device__ __forceinline__ Stages<T> rk4_stages(T coef, T h, T hh, const V3<T>& p,
                                                const V3<T>& v, T r2, V3<T>& a1, V3<T>& a2,
                                                V3<T>& u2, V3<T>& u3) {
  Stages<T> st;
  a1 = accel(coef, p, r2);
  st.q2 = fma3(hh, v, p);
  u2 = fma3(hh, a1, v);
  a2 = accel(coef, st.q2, r2_of(st.q2));
  st.q3 = fma3(hh, u2, p);
  u3 = fma3(hh, a2, v);
  st.q4 = fma3(h, u3, p);
  return st;
}

// x + h6 (((y1 + 2 y2) + 2 y3) + y4): the tableau's order, each (a + 2 b)
// and the final scale-and-add one fused multiply-add.
template <typename T>
__device__ __forceinline__ T rk4_sum(T h6, T x, T y1, T y2, T y3, T y4) {
  return fma_of(h6, fma_of(T(2), y3, fma_of(T(2), y2, y1)) + y4, x);
}

// One classic RK4 step (Raytracer.hs:113-134) from (p, v), r2 = r2_of(p), to
// (np, nv); h, hh = h / 2 and h6 = h / 6 rounded on the host, as the plain
// march rounds them.
template <typename T>
__device__ __forceinline__ void rk4_step(T coef, T h, T hh, T h6, const V3<T>& p,
                                         const V3<T>& v, T r2, V3<T>& np, V3<T>& nv) {
  V3<T> a1, a2, u2, u3;
  const Stages<T> st = rk4_stages(coef, h, hh, p, v, r2, a1, a2, u2, u3);
  const V3<T> a3 = accel(coef, st.q3, r2_of(st.q3));
  const V3<T> u4 = fma3(h, a3, v);
  const V3<T> a4 = accel(coef, st.q4, r2_of(st.q4));
  np = {rk4_sum(h6, p.x, v.x, u2.x, u3.x, u4.x), rk4_sum(h6, p.y, v.y, u2.y, u3.y, u4.y),
        rk4_sum(h6, p.z, v.z, u2.z, u3.z, u4.z)};
  nv = {rk4_sum(h6, v.x, a1.x, a2.x, a3.x, a4.x), rk4_sum(h6, v.y, a1.y, a2.y, a3.y, a4.y),
        rk4_sum(h6, v.z, a1.z, a2.z, a3.z, a4.z)};
}

// The class of a ray at r2 = r2_of(p) before a step, as findColor takes it
// (Raytracer.hs:88-102): the horizon before escape.
template <typename T>
__device__ __forceinline__ int classify(T r2, T rs2, T safe) {
  return r2 < rs2 ? kHorizon : r2 > safe ? kEscaped : kActive;
}

// Whether the step from y (r2 = r2_of(p)) to ny (r2n) may cross the disk: the
// opacity is non-zero, y changes sign, and the end points are not both
// outside or both inside the annulus (the crossing radius^2 is a convex
// combination of r2 and r2n, so such a step can never hit).
template <typename T>
__device__ __forceinline__ bool disk_candidate(T opacity, T y, T ny, T r2, T r2n, T in2,
                                               T out2) {
  return opacity != T(0) && sign_of(y) != sign_of(ny) &&
         !((r2 > out2 && r2n > out2) || (r2 < in2 && r2n < in2));
}

// A candidate step's crossing: the radius^2 interpolated linearly in y, and
// where it lies inside the annulus, its radius, the profile's argument and
// the intensity sin(pi frac^2) (Raytracer.hs:96-111).
template <typename T>
struct Crossing {
  T r2ave, r, frac, intensity;
  bool hit;
};

template <typename T>
__device__ __forceinline__ Crossing<T> disk_crossing(T y, T ny, T r2, T r2n, T inner, T outer,
                                                     T in2, T out2) {
  Crossing<T> c{};
  c.r2ave = (ny * r2 - y * r2n) / (ny - y);
  c.hit = c.r2ave > in2 && c.r2ave < out2;
  if (c.hit) {
    c.r = sqrt(c.r2ave);
    c.frac = (outer - c.r) / (outer - inner);
    c.intensity = sinpi_of(c.frac * c.frac);
  }
  return c;
}

// Front-to-back "over" blend of one channel: acc + layer (1 - alpha), with
// alpha the running alpha before the crossing.
template <typename T>
__device__ __forceinline__ T blend_over(T acc, T layer, T alpha) {
  return acc + layer * (T(1) - alpha);
}

}  // namespace
