// March adjoint (kernel B2): reverse-mode gradients of the geodesic march,
// one CUDA thread per ray.
//
// Replaces the TPU Pallas kernel
// blackstar_tpu/ops/march_adjoint_pallas.py::_adjoint_kernel and computes what
// the plain adjoint blackstar_tpu_torch/ops/march_vjp.py::march_adjoint_reference
// computes: from the ray directions and the cotangents of the march's outputs
// (final velocity, RGBA) it returns d/d(vel0) per ray, the replayed status per
// ray, and per block the 10 scalar partials (mass, disk inner / outer /
// opacity, disk RGB, camera position xyz), which the wrapper sums.
//
// Design.
//   * Phase A replays the forward march of the thread's ray to its own
//     terminating step, checkpointing (pos, vel, alpha) before every 16th
//     step. The TPU kernel kept a tile's checkpoints in VMEM; here 39
//     checkpoints x 7 values per ray (at the default 601-step cap) fit neither
//     in registers nor in a block's shared memory at useful occupancy, so they
//     live in global memory, laid out [segment][value][ray] so that a warp's
//     stores and loads coalesce. The wrapper allocates them.
//   * Phase B walks the segments newest first: it replays the segment from its
//     checkpoint into a per-thread buffer of 17 states (local memory) and
//     applies the step VJP in reverse, with each step's post-state taken from
//     the buffer. The RK4 stage positions are recomputed inside the VJP
//     rather than stored (the JAX package's store_stages option is
//     bit-identical, tests/test_march_adjoint_pallas.py, and was TPU tuning).
//   * Only the steps that advanced the ray (cont true) are reversed. The
//     terminating step and every step after it are the identity for the
//     adjoint (no cotangent flows through a frozen state), so each thread
//     starts its reverse sweep at its own last active step; the TPU kernel's
//     whole-tile early exit becomes a per-thread exit. The disk-blend VJP runs
//     only on a step that hit the disk: on every other step all its terms are
//     exact zeros.
//   * The h^2 = |p0 x v0|^2 chain closes in the kernel. The block sums its
//     rays' 10 partials by warp shuffles and shared memory in a fixed order and
//     writes one row of a (blocks, 10) buffer: no float atomics, so a run
//     repeats bit for bit.
//
// Arithmetic. The replay uses the forward kernel B1's arithmetic and order
// (march.cu): r^-5 as coef / (r^2 r^2 sqrt(r^2)), the same RK4 tableau order,
// the step's half and sixth rounded on the host. The JAX package's adjoint
// took r^-5 by rsqrt powers; here the replayed statuses equal B1's in float32
// as in float64, so the gradient is that of the frame B1 rendered. The VJP
// formulas follow march_vjp.rk4_vjp / step_vjp as written, in the plain
// version's operation order. The file builds with -fmad=false and without fast
// math, as B1 does, so each operation rounds as the plain PyTorch version's
// one-operation kernels round.
//
// What bounds it on an H100: per ray it reads 10 planes (directions and
// cotangents) and writes 4 (gradients, status), ~56 bytes in float32, while
// every advancing step costs two RK4 replays (~135 operations each) and the
// VJP (two stage accelerations and four symmetric-Jacobian applications, ~230
// operations): ~500 operations per ray-step, compute-bound like B1. The
// checkpoints add ~56 bytes per ray per 16 steps of device-memory traffic
// (written once, read once), far below the compute. `nvcc -Xptxas -v` on the
// card: float 78 registers and a 504-byte stack frame (the replay buffer),
// double 148 registers and 992 bytes, no spill in either. At 1920x1080 f32
// the kernel took 12.7 ms against an operation bound of 2.1 ms (NVIDIA H100
// 80GB HBM3, 700 W; chip_smoke.py, PERF.md).
//
// Templated on float (the training path) and double (the on-card gate that
// separates semantics from rounding).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kActive = 0;
constexpr int kEscaped = 1;
constexpr int kHorizon = 2;
constexpr int kThreads = 128;
constexpr int kSeg = 16;      // steps per checkpoint segment
constexpr int kVals = 7;      // checkpointed values: px py pz vx vy vz alpha
constexpr int kPartials = 10;
constexpr double kPi = 3.14159265358979323846;

template <typename T>
struct AdjParams {
  T h, hh, h6;       // step, h / 2, h / 6 (rounded on the host)
  T hh6, h_hh, hh_hh;  // h h / 6, h (h / 2), (h / 2)^2 (rounded on the host)
  T mass;            // Schwarzschild radius rs
  T safe;            // squared escape radius
  T inner, outer, opacity;
  T disk_r, disk_g, disk_b;
  T p0x, p0y, p0z;
  int max_steps;
  int disk_on;
};

template <typename T>
struct V3 {
  T x, y, z;
};

template <typename T>
__device__ __forceinline__ T dot3(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// a + s b, component by component.
template <typename T>
__device__ __forceinline__ V3<T> axpy(const V3<T>& a, T s, const V3<T>& b) {
  return {a.x + s * b.x, a.y + s * b.y, a.z + s * b.z};
}

template <typename T>
__device__ __forceinline__ V3<T> add(const V3<T>& a, const V3<T>& b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

template <typename T>
__device__ __forceinline__ int sign_of(T x) {
  return (x > T(0)) - (x < T(0));
}

__device__ __forceinline__ float rsqrt_of(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_of(double x) { return rsqrt(x); }

// coef / |q|^5 * q, as B1 takes it.
template <typename T>
__device__ __forceinline__ V3<T> accel(T coef, const V3<T>& q) {
  const T r2 = dot3(q, q);
  const T s = coef / (r2 * r2 * sqrt(r2));
  return {s * q.x, s * q.y, s * q.z};
}

// One advancing march step on (p, v, alpha): RK4 in B1's order, then the disk
// crossing (B1's candidate filter and blend, alpha only).
template <typename T>
__device__ __forceinline__ void step_fwd(const AdjParams<T>& P, T coef, T in2, T out2,
                                         V3<T>& p, V3<T>& v, T& aa) {
  const T r2 = dot3(p, p);
  const V3<T> k1 = accel(coef, p);
  const V3<T> q2 = axpy(p, P.hh, v);
  const V3<T> u2 = axpy(v, P.hh, k1);
  const V3<T> k2 = accel(coef, q2);
  const V3<T> q3 = axpy(p, P.hh, u2);
  const V3<T> u3 = axpy(v, P.hh, k2);
  const V3<T> k3 = accel(coef, q3);
  const V3<T> q4 = axpy(p, P.h, u3);
  const V3<T> u4 = axpy(v, P.h, k3);
  const V3<T> k4 = accel(coef, q4);
  const V3<T> np = {p.x + P.h6 * (((v.x + T(2) * u2.x) + T(2) * u3.x) + u4.x),
                    p.y + P.h6 * (((v.y + T(2) * u2.y) + T(2) * u3.y) + u4.y),
                    p.z + P.h6 * (((v.z + T(2) * u2.z) + T(2) * u3.z) + u4.z)};
  const V3<T> nv = {v.x + P.h6 * (((k1.x + T(2) * k2.x) + T(2) * k3.x) + k4.x),
                    v.y + P.h6 * (((k1.y + T(2) * k2.y) + T(2) * k3.y) + k4.y),
                    v.z + P.h6 * (((k1.z + T(2) * k2.z) + T(2) * k3.z) + k4.z)};
  if (P.disk_on) {
    const T r2n = dot3(np, np);
    const bool candidate = P.opacity != T(0) && sign_of(p.y) != sign_of(np.y) &&
                           !((r2 > out2 && r2n > out2) || (r2 < in2 && r2n < in2));
    if (candidate) {
      const T r2ave = (np.y * r2 - p.y * r2n) / (np.y - p.y);
      if (r2ave > in2 && r2ave < out2) {
        const T r = sqrt(r2ave);
        const T frac = (P.outer - r) / (P.outer - P.inner);
        const T intensity = sin(T(kPi) * frac * frac);
        aa = aa + intensity * P.opacity * (T(1) - aa);
      }
    }
  }
  p = np;
  v = nv;
}

// q_bar = J(q)^T k_bar for J = a'(q) (symmetric); adds the stage's coef_bar.
template <typename T>
__device__ __forceinline__ V3<T> jtp(T coef, const V3<T>& q, const V3<T>& kb, T& cb) {
  const T r2 = dot3(q, q);
  const T inv = rsqrt_of(r2);
  const T inv2 = inv * inv;
  const T inv5 = inv * inv2 * inv2;
  const T pa = dot3(q, kb);
  const T s = coef * inv5;
  const T t = T(-5) * s * inv2 * pa;
  cb = pa * inv5;
  return {s * kb.x + t * q.x, s * kb.y + t * q.y, s * kb.z + t * q.z};
}

// Fused-stage RK4 VJP (march_vjp.rk4_vjp), stages recomputed from (p, v).
template <typename T>
__device__ __forceinline__ void rk4_vjp(const AdjParams<T>& P, T coef, const V3<T>& p,
                                        const V3<T>& v, const V3<T>& pbo, const V3<T>& vbo,
                                        V3<T>& pb, V3<T>& vb, T& cb) {
  const V3<T> k1 = accel(coef, p);
  const V3<T> q2 = axpy(p, P.hh, v);
  const V3<T> u2 = axpy(v, P.hh, k1);
  const V3<T> k2 = accel(coef, q2);
  const V3<T> q3 = axpy(p, P.hh, u2);
  const V3<T> u3 = axpy(v, P.hh, k2);
  const V3<T> q4 = axpy(p, P.h, u3);

  T cb1, cb2, cb3, cb4;
  const V3<T> k4b = {P.h6 * vbo.x, P.h6 * vbo.y, P.h6 * vbo.z};
  const V3<T> q4b = jtp(coef, q4, k4b, cb4);
  const T s2 = T(2) * P.h6;
  const V3<T> a = {P.hh6 * pbo.x + s2 * vbo.x, P.hh6 * pbo.y + s2 * vbo.y,
                   P.hh6 * pbo.z + s2 * vbo.z};
  const V3<T> q2b = jtp(coef, q2, axpy(a, P.h_hh, q4b), cb2);
  const V3<T> q3b = jtp(coef, q3, a, cb3);
  const V3<T> k1b = axpy(axpy(a, -P.h6, vbo), P.hh_hh, q3b);
  const V3<T> q1b = jtp(coef, p, k1b, cb1);

  pb = add(add(add(add(pbo, q1b), q2b), q3b), q4b);
  const V3<T> q23 = add(q2b, q3b);
  vb = {((vbo.x + P.h * pbo.x) + P.hh * q23.x) + P.h * q4b.x,
        ((vbo.y + P.h * pbo.y) + P.hh * q23.y) + P.h * q4b.y,
        ((vbo.z + P.h * pbo.z) + P.hh * q23.z) + P.h * q4b.z};
  cb = (cb1 + cb2) + (cb3 + cb4);
}

// Per-thread reverse-sweep state.
template <typename T>
struct Carry {
  V3<T> pbar, vbar;
  T arbar, agbar, abbar, aabar;
  T coef_bar, inner_bar, outer_bar, opacity_bar, rgb0_bar, rgb1_bar, rgb2_bar;
};

// Reverse of one advancing step (cont true) from its pre-state (p, v, aa) and
// its post-position np (march_vjp.step_vjp).
template <typename T>
__device__ __forceinline__ void step_vjp(const AdjParams<T>& P, T coef, T in2, T out2,
                                         const V3<T>& p, const V3<T>& v, T aa,
                                         const V3<T>& np, Carry<T>& c) {
  V3<T> np_bar = c.pbar;
  V3<T> pbar = {T(0), T(0), T(0)};
  const V3<T> nv_bar = c.vbar;
  if (P.disk_on && P.opacity != T(0) && sign_of(p.y) != sign_of(np.y)) {
    const T r2 = dot3(p, p);
    const T r2n = dot3(np, np);
    const T ds = np.y - p.y;
    const T r2ave = (np.y * r2 - p.y * r2n) / ds;
    if (r2ave > in2 && r2ave < out2) {
      const T r = sqrt(r2ave);
      const T frac = (P.outer - r) / (P.outer - P.inner);
      const T intensity = sin(T(kPi) * frac * frac);
      const T one_m = T(1) - aa;
      const T rgb_dot = c.arbar * P.disk_r + c.agbar * P.disk_g + c.abbar * P.disk_b;
      const T ibar = one_m * (rgb_dot + c.aabar * P.opacity);
      c.opacity_bar = c.opacity_bar + c.aabar * intensity * one_m;
      c.rgb0_bar = c.rgb0_bar + c.arbar * intensity * one_m;
      c.rgb1_bar = c.rgb1_bar + c.agbar * intensity * one_m;
      c.rgb2_bar = c.rgb2_bar + c.abbar * intensity * one_m;
      c.aabar = c.aabar * (T(1) - intensity * P.opacity) - intensity * rgb_dot;
      const T frac_bar = ibar * cos(T(kPi) * frac * frac) * (T(2.0 * kPi) * frac);
      const T denom = P.outer - P.inner;
      const T r_bar = -frac_bar / denom;
      c.outer_bar = c.outer_bar + frac_bar * (r - P.inner) / (denom * denom);
      c.inner_bar = c.inner_bar + frac_bar * frac / denom;
      const T r2ave_bar = r_bar * T(0.5) / r;
      const T y2_bar = r2ave_bar * (r2 - r2ave) / ds;
      const T y_bar = r2ave_bar * (r2ave - r2n) / ds;
      const T r2_bar = r2ave_bar * np.y / ds;
      const T r2n_bar = -r2ave_bar * p.y / ds;
      const T s = T(2) * r2n_bar;
      np_bar = {np_bar.x + s * np.x, (np_bar.y + s * np.y) + y2_bar, np_bar.z + s * np.z};
      pbar.y = pbar.y + y_bar;
      const T t = T(2) * r2_bar;
      pbar = {pbar.x + t * p.x, pbar.y + t * p.y, pbar.z + t * p.z};
    }
  }
  V3<T> pb, vb;
  T cb;
  rk4_vjp(P, coef, p, v, np_bar, nv_bar, pb, vb, cb);
  c.pbar = add(pbar, pb);
  c.vbar = vb;
  c.coef_bar = c.coef_bar + cb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
march_adjoint_kernel(const T* __restrict__ vx0, const T* __restrict__ vy0,
                     const T* __restrict__ vz0,
                     const T* __restrict__ cot,  // (7, n): vel xyz, RGBA
                     int64_t n, AdjParams<T> P,
                     T* __restrict__ ckpt,            // (n_seg, 7, n) scratch
                     T* __restrict__ gvel,            // (3, n) out
                     int32_t* __restrict__ status_out,  // (n,) out
                     T* __restrict__ partials) {        // (blocks, 10) out
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T part[kPartials];
#pragma unroll
  for (int k = 0; k < kPartials; ++k) part[k] = T(0);

  if (i < n) {
    const V3<T> p0 = {P.p0x, P.p0y, P.p0z};
    const V3<T> v0 = {vx0[i], vy0[i], vz0[i]};
    // Conserved angular momentum h^2 = |pos x vel|^2 (Raytracer.hs:73).
    const T cx = p0.y * v0.z - p0.z * v0.y;
    const T cy = p0.z * v0.x - p0.x * v0.z;
    const T cz = p0.x * v0.y - p0.y * v0.x;
    const T h2 = cx * cx + cy * cy + cz * cz;
    const T coef = T(-1.5) * P.mass * h2;
    const T rs2 = P.mass * P.mass;
    const T in2 = P.inner * P.inner;
    const T out2 = P.outer * P.outer;

    // ---- Phase A: replay to termination, checkpointing every kSeg steps.
    V3<T> p = p0, v = v0;
    T aa = T(0);
    int status = kActive;
    int nc = P.max_steps;  // advancing steps
    for (int k = 0; k < P.max_steps; ++k) {
      const T r2 = dot3(p, p);
      if (r2 < rs2) { status = kHorizon; nc = k; break; }
      if (r2 > P.safe) { status = kEscaped; nc = k; break; }
      if (k % kSeg == 0) {
        T* ck = ckpt + (int64_t)(k / kSeg) * kVals * n + i;
        ck[0] = p.x; ck[n] = p.y; ck[2 * n] = p.z;
        ck[3 * n] = v.x; ck[4 * n] = v.y; ck[5 * n] = v.z;
        ck[6 * n] = aa;
      }
      step_fwd(P, coef, in2, out2, p, v, aa);
    }
    status_out[i] = status;

    // ---- Phase B: segments newest first, replay then reverse.
    Carry<T> c;
    c.pbar = {T(0), T(0), T(0)};
    c.vbar = {cot[i], cot[n + i], cot[2 * n + i]};
    c.arbar = cot[3 * n + i];
    c.agbar = cot[4 * n + i];
    c.abbar = cot[5 * n + i];
    c.aabar = cot[6 * n + i];
    c.coef_bar = c.inner_bar = c.outer_bar = c.opacity_bar = T(0);
    c.rgb0_bar = c.rgb1_bar = c.rgb2_bar = T(0);

    T buf[kSeg + 1][kVals];
    for (int seg = (nc - 1) / kSeg; nc > 0 && seg >= 0; --seg) {
      const T* ck = ckpt + (int64_t)seg * kVals * n + i;
      V3<T> q = {ck[0], ck[n], ck[2 * n]};
      V3<T> w = {ck[3 * n], ck[4 * n], ck[5 * n]};
      T a = ck[6 * n];
      const int len = min(kSeg, nc - seg * kSeg);
      for (int j = 0; j <= len; ++j) {
        buf[j][0] = q.x; buf[j][1] = q.y; buf[j][2] = q.z;
        buf[j][3] = w.x; buf[j][4] = w.y; buf[j][5] = w.z;
        buf[j][6] = a;
        if (j < len) step_fwd(P, coef, in2, out2, q, w, a);
      }
      for (int j = len - 1; j >= 0; --j) {
        const V3<T> pp = {buf[j][0], buf[j][1], buf[j][2]};
        const V3<T> pv = {buf[j][3], buf[j][4], buf[j][5]};
        const V3<T> post = {buf[j + 1][0], buf[j + 1][1], buf[j + 1][2]};
        step_vjp(P, coef, in2, out2, pp, pv, buf[j][6], post, c);
      }
    }

    // ---- Close the h^2 chain: coef = -1.5 mass h^2; h^2 = |p0 x v0|^2.
    const T h2_bar = T(-1.5) * P.mass * c.coef_bar;
    const T t = T(2) * h2_bar;
    gvel[i] = c.vbar.x + t * (cy * p0.z - cz * p0.y);
    gvel[n + i] = c.vbar.y + t * (cz * p0.x - cx * p0.z);
    gvel[2 * n + i] = c.vbar.z + t * (cx * p0.y - cy * p0.x);
    part[0] = T(-1.5) * h2 * c.coef_bar;
    part[1] = c.inner_bar;
    part[2] = c.outer_bar;
    part[3] = c.opacity_bar;
    part[4] = c.rgb0_bar;
    part[5] = c.rgb1_bar;
    part[6] = c.rgb2_bar;
    part[7] = c.pbar.x + t * (v0.y * cz - v0.z * cy);
    part[8] = c.pbar.y + t * (v0.z * cx - v0.x * cz);
    part[9] = c.pbar.z + t * (v0.x * cy - v0.y * cx);
  }

  // Block sums of the partials in a fixed order (warp tree, then warps in
  // order); every thread of the block reaches this point.
  __shared__ T warp_sum[kThreads / 32][kPartials];
#pragma unroll
  for (int k = 0; k < kPartials; ++k) {
    T s = part[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kPartials) {
    T s = warp_sum[0][threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) s += warp_sum[w][threadIdx.x];
    partials[(int64_t)blockIdx.x * kPartials + threadIdx.x] = s;
  }
}

template <typename T>
int launch(const void* vx, const void* vy, const void* vz, const void* cot, int64_t n,
           double h, double hh, double h6, double hh6, double h_hh, double hh_hh,
           double mass, double safe, double inner, double outer, double opacity,
           double disk_r, double disk_g, double disk_b, double p0x, double p0y,
           double p0z, int max_steps, int disk_on, void* ckpt, void* gvel,
           void* status, void* partials, void* stream) {
  AdjParams<T> P;
  P.h = T(h); P.hh = T(hh); P.h6 = T(h6);
  P.hh6 = T(hh6); P.h_hh = T(h_hh); P.hh_hh = T(hh_hh);
  P.mass = T(mass); P.safe = T(safe);
  P.inner = T(inner); P.outer = T(outer); P.opacity = T(opacity);
  P.disk_r = T(disk_r); P.disk_g = T(disk_g); P.disk_b = T(disk_b);
  P.p0x = T(p0x); P.p0y = T(p0y); P.p0z = T(p0z);
  P.max_steps = max_steps;
  P.disk_on = disk_on;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  march_adjoint_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const T*)cot, n, P, (T*)ckpt,
      (T*)gvel, (int32_t*)status, (T*)partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define BS_ADJ_ARGS                                                                  \
  const void *vx, const void *vy, const void *vz, const void *cot, int64_t n,        \
      double h, double hh, double h6, double hh6, double h_hh, double hh_hh,         \
      double mass, double safe, double inner, double outer, double opacity,          \
      double disk_r, double disk_g, double disk_b, double p0x, double p0y,           \
      double p0z, int max_steps, int disk_on, void *ckpt, void *gvel, void *status,  \
      void *partials, void *stream
#define BS_ADJ_PASS                                                                  \
  vx, vy, vz, cot, n, h, hh, h6, hh6, h_hh, hh_hh, mass, safe, inner, outer,         \
      opacity, disk_r, disk_g, disk_b, p0x, p0y, p0z, max_steps, disk_on, ckpt,      \
      gvel, status, partials, stream

int bs_march_adjoint_f32(BS_ADJ_ARGS) { return launch<float>(BS_ADJ_PASS); }
int bs_march_adjoint_f64(BS_ADJ_ARGS) { return launch<double>(BS_ADJ_PASS); }

}  // extern "C"
