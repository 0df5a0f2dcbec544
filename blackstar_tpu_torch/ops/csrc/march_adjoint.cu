// March adjoint (kernel B2): reverse-mode gradients of the geodesic march,
// one CUDA thread per ray, starting from the checkpoints that the forward
// kernel B1 wrote in the same training step.
//
// Replaces the TPU Pallas kernel
// blackstar_tpu/ops/march_adjoint_pallas.py::_adjoint_kernel and computes what
// the plain adjoint blackstar_tpu_torch/ops/march_vjp.py::
// march_adjoint_from_checkpoints computes (and march_adjoint_reference from
// the march's inputs alone): from the ray directions, the cotangents of the
// march's outputs (final velocity, RGBA) and the forward's checkpoints it
// returns d/d(vel0) per ray, each ray's status as its replayed final state
// classifies it, and per block the 10 scalar partials (mass, disk inner /
// outer / opacity, disk RGB, camera position xyz), which the wrapper sums.
//
// Inputs from B1 (march.cu, its checkpointing variant, in the autograd
// forward): ray_steps, each ray's count nc of advancing steps, and an
// (n_seg, 7, n) tensor laid out [segment][value][ray] holding (px py pz vx vy
// vz alpha) before every advancing step k with k % 16 == 0. B1 and this
// kernel take their step from one source (march_step.cuh), so those are the
// states this kernel's replay passes through, bit for bit. So there is no
// forward replay here.
//
// Design.
//   * Segments newest first. A thread replays its segment from the
//     checkpoint (at most 16 steps), keeping each pre-step state in its own
//     column of a [kSeg][kVals][threads] array in dynamic shared memory, then
//     applies the step VJP in reverse over the segment's steps. A step's
//     post-position is the next step's pre-position, and the last one's is
//     still in registers after the replay, so 16 slots suffice. A warp's 32
//     accesses to one (slot, value) fall on 32 consecutive words: no bank
//     conflicts, and nothing goes to local memory.
//   * Stages: the VJP needs the RK4 stage positions q2, q3, q4, and
//     recomputes them from the pre-state (two accelerations per step).
//     Keeping them in the replay array instead (16 values a slot, the JAX
//     package's store_stages) gave the same bits and ~100 fewer SASS
//     instructions per step, but 1 KB of shared memory per thread leaves 7
//     warps per SM, and it ran slower (PERF.md).
//   * Only the steps that advanced the ray are reversed; the terminating step
//     and every step after it are the identity for the adjoint (no cotangent
//     flows through a frozen state). The disk-blend VJP runs only on a step
//     that hit the disk: on every other step all its terms are exact zeros.
//   * The status is the replayed final state's class: ACTIVE (truncated) if
//     nc reached the cap, else HORIZON or ESCAPED as B1 classified it. A
//     replay that left B1's path would show here.
//   * The h^2 = |p0 x v0|^2 chain closes in the kernel. The block sums its
//     rays' 10 partials by warp shuffles, then through the (by then free)
//     shared array in a fixed order, and writes one row of a (blocks, 10)
//     buffer: no float atomics, so a run repeats bit for bit.
//
// Arithmetic. The replay and the stage recomputation are march_step.cuh's
// (r^-5 by rsqrt powers, explicit fused multiply-adds, the step's half and
// sixth rounded on the host), so they equal B1's. The VJP formulas follow
// march_vjp.rk4_vjp / step_vjp as written; the disk-blend VJP takes the
// crossing and its hit test from march_step.cuh, as the forward decided
// them. The file builds with -fmad=false and without fast math, as B1 does.
// The plain adjoint replays with the plain march's arithmetic (a divide for
// r^-5), so in float32 its orbits part from this kernel's near the photon
// ring, and chip_smoke.py holds the float32 gradients to the float64 plain
// adjoint no worse than the float32 plain adjoint is.
//
// What bounds it on an H100: per ray it reads 10 planes (directions,
// cotangents), the step count and its checkpoints, and writes 4 (gradients,
// status): ~56 bytes plus 28 bytes per 16 steps in float32. Every advancing
// step costs a replayed RK4 step and the VJP (two recomputed stage
// accelerations, four symmetric-Jacobian applications), several hundred
// FP32 instructions per ray-step, so it is bound by FP32 issue, not by
// memory. Each ray is a scalar ODE: there is no matrix product for the
// tensor cores (wgmma) and no tile of bytes worth a TMA stream. What the
// card offers this kernel is its registers, up to 227 KB of shared memory
// per block for the replay, and its FP32 issue rate.
//
// Occupancy is set by the replay array: 233,472 bytes of shared memory per
// SM, less 1 KB the runtime takes per block, so about 512 bytes per thread
// buy 16 warps whatever the block size; the block size only has to divide
// the SM's share evenly. Float: 16 x 7 x 4 B x 128 threads = 57,344 B, 4
// blocks (16 warps) per SM, so __launch_bounds__ lets registers go up to
// 128; `nvcc -Xptxas -v` on the card: 79 registers, a 32-byte stack frame
// (the slow path of the disk-blend VJP's cos), no spills. Double (the gate):
// 114,688 B, 2 blocks (8 warps), 146 registers. Measured at 1920x1080
// float32: 7.5 ms a training step against an operation bound of 2.1 ms
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6 has the history).
//
// Templated on float (the training path) and double (the on-card gate that
// separates semantics from rounding).

#include <cuda_runtime.h>
#include <cstdint>

#include "march_step.cuh"

namespace {

constexpr int kVals = 7;        // px py pz vx vy vz alpha: a checkpoint, a replay slot
constexpr int kPartials = 10;
constexpr int kThreads = 128;  // THREADS in march_adjoint_cuda.py
constexpr int kMaxDevices = 64;
constexpr double kPi = 3.14159265358979323846;

// The replay array's bytes per block, and the blocks an SM holds by them
// (228 KB of shared memory per SM, 1 KB of it reserved per block).
template <typename T>
constexpr int kSmem = kSeg * kVals * kThreads * (int)sizeof(T);
template <typename T>
constexpr int kBlocksPerSm = 233472 / (kSmem<T> + 1024);
static_assert(kBlocksPerSm<double> >= 1 && kThreads % 32 == 0, "");

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

// One advancing march step on (p, v, alpha), as B1 takes it: RK4, then the
// disk crossing (alpha only).
template <typename T>
__device__ __forceinline__ void step_fwd(const AdjParams<T>& P, T coef, T in2, T out2,
                                         V3<T>& p, V3<T>& v, T& aa) {
  const T r2 = r2_of(p);
  V3<T> np, nv;
  rk4_step(coef, P.h, P.hh, P.h6, p, v, r2, np, nv);
  if (P.disk_on) {
    const T r2n = r2_of(np);
    if (disk_candidate(P.opacity, p.y, np.y, r2, r2n, in2, out2)) {
      const Crossing<T> c = disk_crossing(p.y, np.y, r2, r2n, P.inner, P.outer, in2, out2);
      if (c.hit) aa = blend_over(aa, c.intensity * P.opacity, aa);
    }
  }
  p = np;
  v = nv;
}

// The stage positions of the step from (p, v), as the replay computed them.
template <typename T>
__device__ __forceinline__ Stages<T> stages_of(const AdjParams<T>& P, T coef, const V3<T>& p,
                                               const V3<T>& v) {
  V3<T> a1, a2, u2, u3;
  return rk4_stages(coef, P.h, P.hh, p, v, r2_of(p), a1, a2, u2, u3);
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

// Fused-stage RK4 VJP (march_vjp.rk4_vjp) at pre-position p with the
// step's stage positions st.
template <typename T>
__device__ __forceinline__ void rk4_vjp(const AdjParams<T>& P, T coef, const V3<T>& p,
                                        const Stages<T>& st, const V3<T>& pbo,
                                        const V3<T>& vbo, V3<T>& pb, V3<T>& vb, T& cb) {
  T cb1, cb2, cb3, cb4;
  const V3<T> k4b = {P.h6 * vbo.x, P.h6 * vbo.y, P.h6 * vbo.z};
  const V3<T> q4b = jtp(coef, st.q4, k4b, cb4);
  const T s2 = T(2) * P.h6;
  const V3<T> a = {P.hh6 * pbo.x + s2 * vbo.x, P.hh6 * pbo.y + s2 * vbo.y,
                   P.hh6 * pbo.z + s2 * vbo.z};
  const V3<T> q2b = jtp(coef, st.q2, axpy(a, P.h_hh, q4b), cb2);
  const V3<T> q3b = jtp(coef, st.q3, a, cb3);
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

// Reverse of one advancing step (cont true) from its pre-position p, its
// pre-step alpha aa, its post-position np and its stage positions st
// (march_vjp.step_vjp).
template <typename T>
__device__ __forceinline__ void step_vjp(const AdjParams<T>& P, T coef, T in2, T out2,
                                         const V3<T>& p, T aa, const V3<T>& np,
                                         const Stages<T>& st, Carry<T>& c) {
  V3<T> np_bar = c.pbar;
  V3<T> pbar = {T(0), T(0), T(0)};
  const V3<T> nv_bar = c.vbar;
  if (P.disk_on) {
    // The crossing and its hit test as the forward decided them.
    const T r2 = r2_of(p);
    const T r2n = r2_of(np);
    const Crossing<T> cr =
        disk_candidate(P.opacity, p.y, np.y, r2, r2n, in2, out2)
            ? disk_crossing(p.y, np.y, r2, r2n, P.inner, P.outer, in2, out2)
            : Crossing<T>{};
    if (cr.hit) {
      const T ds = np.y - p.y;
      const T r2ave = cr.r2ave, r = cr.r, frac = cr.frac, intensity = cr.intensity;
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
  rk4_vjp(P, coef, p, st, np_bar, nv_bar, pb, vb, cb);
  c.pbar = add(pbar, pb);
  c.vbar = vb;
  c.coef_bar = c.coef_bar + cb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T>)
march_adjoint_kernel(const T* __restrict__ vx0, const T* __restrict__ vy0,
                     const T* __restrict__ vz0,
                     const T* __restrict__ cot,         // (7, n): vel xyz, RGBA
                     const T* __restrict__ ckpt,        // (n_seg, 7, n) from B1
                     const int32_t* __restrict__ ray_steps,  // (n,) from B1
                     int64_t n, AdjParams<T> P,
                     T* __restrict__ gvel,              // (3, n) out
                     int32_t* __restrict__ status_out,  // (n,) out
                     T* __restrict__ partials) {        // (blocks, 10) out
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // This thread's column of the [kSeg][kVals][kThreads] replay array.
  T* const col = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  auto slot = [col](int j, int k) -> T& { return col[(j * kVals + k) * kThreads]; };

  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  T part[kPartials];
#pragma unroll
  for (int k = 0; k < kPartials; ++k) part[k] = T(0);

  if (i < n) {
    const V3<T> p0 = {P.p0x, P.p0y, P.p0z};
    const V3<T> v0 = {vx0[i], vy0[i], vz0[i]};
    V3<T> cross;
    T h2;
    const T coef = ray_coef(p0, v0, P.mass, cross, h2);
    const T cx = cross.x, cy = cross.y, cz = cross.z;
    const T rs2 = P.mass * P.mass;
    const T in2 = P.inner * P.inner;
    const T out2 = P.outer * P.outer;
    const int nc = ray_steps[i];  // advancing steps

    Carry<T> c;
    c.pbar = {T(0), T(0), T(0)};
    c.vbar = {cot[i], cot[n + i], cot[2 * n + i]};
    c.arbar = cot[3 * n + i];
    c.agbar = cot[4 * n + i];
    c.abbar = cot[5 * n + i];
    c.aabar = cot[6 * n + i];
    c.coef_bar = c.inner_bar = c.outer_bar = c.opacity_bar = T(0);
    c.rgb0_bar = c.rgb1_bar = c.rgb2_bar = T(0);

    // Segments newest first: replay from the checkpoint into shared memory,
    // then reverse.
    V3<T> fin = p0;  // the state after the last advancing step
    for (int seg = (nc - 1) / kSeg; nc > 0 && seg >= 0; --seg) {
      const T* ck = ckpt + (int64_t)seg * kVals * n + i;
      V3<T> q = {ck[0], ck[n], ck[2 * n]};
      V3<T> w = {ck[3 * n], ck[4 * n], ck[5 * n]};
      T a = ck[6 * n];
      const int len = min(kSeg, nc - seg * kSeg);
      for (int j = 0; j < len; ++j) {
        slot(j, 0) = q.x; slot(j, 1) = q.y; slot(j, 2) = q.z;
        slot(j, 3) = w.x; slot(j, 4) = w.y; slot(j, 5) = w.z;
        slot(j, 6) = a;
        step_fwd(P, coef, in2, out2, q, w, a);
      }
      if (seg * kSeg + len == nc) fin = q;
      V3<T> post = q;
      for (int j = len - 1; j >= 0; --j) {
        const V3<T> pp = {slot(j, 0), slot(j, 1), slot(j, 2)};
        const Stages<T> st = stages_of(P, coef, pp, V3<T>{slot(j, 3), slot(j, 4), slot(j, 5)});
        step_vjp(P, coef, in2, out2, pp, slot(j, 6), post, st, c);
        post = pp;
      }
    }
    status_out[i] = nc == P.max_steps ? kActive : classify(r2_of(fin), rs2, P.safe);

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
  // order) through the replay array, once every thread of the block is done
  // with its column; every thread of the block reaches this point.
#pragma unroll
  for (int k = 0; k < kPartials; ++k) {
    for (int off = 16; off > 0; off >>= 1) part[k] += __shfl_down_sync(0xffffffffu, part[k], off);
  }
  T* const warp_sum = reinterpret_cast<T*>(smem_raw);  // [warp][kPartials]
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < kPartials; ++k) warp_sum[(threadIdx.x >> 5) * kPartials + k] = part[k];
  }
  __syncthreads();
  if (threadIdx.x < kPartials) {
    T s = warp_sum[threadIdx.x];
    for (int w = 1; w < kThreads / 32; ++w) s += warp_sum[w * kPartials + threadIdx.x];
    partials[(int64_t)blockIdx.x * kPartials + threadIdx.x] = s;
  }
}

template <typename T>
int launch(const void* vx, const void* vy, const void* vz, const void* cot, const void* ckpt,
           const void* ray_steps, int64_t n, double h, double hh, double h6, double hh6,
           double h_hh, double hh_hh, double mass, double safe, double inner, double outer,
           double opacity, double disk_r, double disk_g, double disk_b, double p0x,
           double p0y, double p0z, int max_steps, int disk_on, void* gvel, void* status,
           void* partials, void* stream) {
  AdjParams<T> P;
  P.h = T(h); P.hh = T(hh); P.h6 = T(h6);
  P.hh6 = T(hh6); P.h_hh = T(h_hh); P.hh_hh = T(hh_hh);
  P.mass = T(mass); P.safe = T(safe);
  P.inner = T(inner); P.outer = T(outer); P.opacity = T(opacity);
  P.disk_r = T(disk_r); P.disk_g = T(disk_g); P.disk_b = T(disk_b);
  P.p0x = T(p0x); P.p0y = T(p0y); P.p0z = T(p0z);
  P.max_steps = max_steps;
  P.disk_on = disk_on;
  // Above 48 KB a block's dynamic shared memory must be allowed explicitly;
  // the carveout gives the SM's L1 / shared split to shared memory. Set once
  // per device (a failure is returned on every launch).
  static cudaError_t attr_err[kMaxDevices];
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(march_adjoint_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem<T>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(march_adjoint_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    attr_err[dev] = err;
    attr_set[dev] = true;
  }
  if (attr_err[dev] != cudaSuccess) return (int)attr_err[dev];
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  march_adjoint_kernel<T><<<(unsigned)blocks, kThreads, kSmem<T>, (cudaStream_t)stream>>>(
      (const T*)vx, (const T*)vy, (const T*)vz, (const T*)cot, (const T*)ckpt,
      (const int32_t*)ray_steps, n, P, (T*)gvel, (int32_t*)status, (T*)partials);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define BS_ADJ_ARGS                                                                    \
  const void *vx, const void *vy, const void *vz, const void *cot, const void *ckpt,   \
      const void *ray_steps, int64_t n, double h, double hh, double h6, double hh6,    \
      double h_hh, double hh_hh, double mass, double safe, double inner, double outer, \
      double opacity, double disk_r, double disk_g, double disk_b, double p0x,         \
      double p0y, double p0z, int max_steps, int disk_on, void *gvel, void *status,    \
      void *partials, void *stream
#define BS_ADJ_PASS                                                                    \
  vx, vy, vz, cot, ckpt, ray_steps, n, h, hh, h6, hh6, h_hh, hh_hh, mass, safe, inner, \
      outer, opacity, disk_r, disk_g, disk_b, p0x, p0y, p0z, max_steps, disk_on, gvel,  \
      status, partials, stream

int bs_march_adjoint_f32(BS_ADJ_ARGS) { return launch<float>(BS_ADJ_PASS); }
int bs_march_adjoint_f64(BS_ADJ_ARGS) { return launch<double>(BS_ADJ_PASS); }

}  // extern "C"
