// Forward geodesic march (kernel B1): one CUDA thread per ray.
//
// Replaces the TPU Pallas kernel blackstar_tpu/ops/march_pallas.py::_march_kernel
// and computes what the plain march blackstar_tpu_torch/geodesic.py::march
// computes: a capped fixed-step RK4 march of the Schwarzschild null-geodesic
// ODE  d(vel)/dt = -1.5 rs h^2 pos/|pos|^5,  d(pos)/dt = vel  (Raytracer.hs:113-134),
// with
//   * classification on the PRE-step r^2, horizon (r^2 < rs^2) before escape
//     (r^2 > safe), as findColor does (Raytracer.hs:88-102);
//   * disk crossings on a sign flip of y, the crossing radius^2 interpolated
//     linearly in y, r2ave = (y' r^2 - y r'^2) / (y' - y), the radial profile
//     sin(pi frac^2), and front-to-back "over" blending (Raytracer.hs:96-111);
//   * velocity, r^2, RGBA and status frozen at termination: the thread leaves
//     its loop on the step that classifies it, so nothing past it is computed;
//   * no step past the cap: a ray still active after max_steps iterations
//     keeps status ACTIVE (truncated).
//
// What bounds it on an H100: each ray reads 12 bytes (its direction) and
// writes 32 (velocity, RGBA, status) in float32, but does ~100 flops per
// RK4 step (four accelerations, each a square root and a divide) over ~230
// steps on the default scene. So it is compute- and divergence-bound, not
// memory-bound. The design keeps the whole ray state in registers, walks
// the pixels in row-major order so the 32 rays of a warp are neighbours with
// similar step counts (less divergence), and lets each thread stop at its
// own ray's termination. The disk shading (a divide, a square root, a sine)
// runs inline, only behind the cheap candidate test: the step is active, y
// changed sign, the opacity is non-zero, and the step's end points are not
// both outside or both inside the annulus (the crossing radius^2 is a convex
// combination of r^2 and r'^2, so such a step can never hit).
//
// 1/r^5 is taken as a divide, coef / (r^2 r^2 sqrt(r^2)), exactly as the
// plain march writes it; the TPU kernel took rsqrt powers instead. The file
// builds without --use_fast_math (sqrt and the divide are IEEE-rounded) and
// with -fmad=false: every operation is written in the plain march's order and
// rounds on its own, as the plain march's one-operation-per-step PyTorch
// kernels do. With nvcc's default contraction a first build agreed with the
// plain march to 6e-12 in float64 but lost the float32 gate: near the photon
// ring the contracted and uncontracted float32 orbits part, and a few rays
// of the 480x270 frame crossed the disk at other radii (RGBA off by 3e-2).
// The step's half and sixth come in from the caller, rounded as the plain
// march rounds them (true division on the host).
//
// The executed step count is the maximum over rays of the loop iterations
// each ray ran (the iteration that classifies a ray counts; a truncated ray
// counts max_steps), reduced per block and combined with one atomicMax. It
// equals the plain march's `steps`. When the caller passes a ray_steps
// array, each ray also writes its count of advancing RK4 steps there (the
// classifying iteration does no RK4 step): the work the frame needed, for
// its operation count.
//
// Checkpointing variant (kCkpt, launched when the caller passes a checkpoint
// array; the training forward): what the adjoint kernel B2
// (march_adjoint.cu) starts from. Before every advancing step k with
// k % 16 == 0 (after both classification tests passed, before the RK4 step)
// the thread writes its state (px py pz vx vy vz alpha) into an
// (n_seg, 7, n) array laid out [segment][value][ray], so a warp's stores
// coalesce; with ray_steps (B2's nc) that is all B2 needs, and B2 replays a
// segment with this file's arithmetic, so its states equal these bit for
// bit. Entries past a ray's end are not written. The frame path launches
// kCkpt = false, whose code is the kernel without the variant. The stores
// cost 28 bytes per ray per 16 steps (2.2 GB at 1080p, float32), mostly
// hidden under the arithmetic: 3.50 against 3.41 ms for the frame variant
// at 1920x1080 float32 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Templated on float (the render path) and double (the on-card gate that
// separates semantics from rounding).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kActive = 0;
constexpr int kEscaped = 1;
constexpr int kHorizon = 2;
constexpr int kThreads = 128;
constexpr int kSeg = 16;       // steps per checkpoint segment (B2's kSeg)
constexpr int kCkptVals = 7;   // px py pz vx vy vz alpha
constexpr double kPi = 3.14159265358979323846;

template <typename T>
struct MarchParams {
  T h;         // step size
  T hh;        // h / 2, as the plain march rounds it
  T h6;        // h / 6, as the plain march rounds it
  T mass;      // Schwarzschild radius rs
  T safe;      // squared escape radius
  T inner;     // disk inner radius
  T outer;     // disk outer radius
  T opacity;   // disk opacity
  T disk_r, disk_g, disk_b;  // disk colour, linear RGB
  T p0x, p0y, p0z;           // camera position (shared by every ray)
  int max_steps;
  int disk_on;  // diskOpacity != 0 at config time
};

// coef / |q|^5 * q, from a precomputed r^2 = |q|^2.
template <typename T>
__device__ __forceinline__ void accel(T coef, T qx, T qy, T qz, T r2,
                                      T& ax, T& ay, T& az) {
  const T s = coef / (r2 * r2 * sqrt(r2));
  ax = s * qx;
  ay = s * qy;
  az = s * qz;
}

template <typename T>
__device__ __forceinline__ int sign_of(T x) {
  return (x > T(0)) - (x < T(0));
}

template <typename T, bool kCkpt>
__global__ void __launch_bounds__(kThreads)
march_kernel(const T* __restrict__ vx0, const T* __restrict__ vy0,
             const T* __restrict__ vz0, int64_t n, MarchParams<T> P,
             T* __restrict__ out,           // (7, n): vx vy vz r g b a
             int32_t* __restrict__ status_out,  // (n,)
             int32_t* __restrict__ steps_out,   // (1,), zeroed by the caller
             int32_t* __restrict__ ray_steps,   // (n,) or null
             T* __restrict__ ckpt) {            // (n_seg, 7, n) if kCkpt
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int executed = 0;
  if (i < n) {
    T px = P.p0x, py = P.p0y, pz = P.p0z;
    T vx = vx0[i], vy = vy0[i], vz = vz0[i];

    // Conserved angular momentum h^2 = |pos x vel|^2 (Raytracer.hs:73).
    const T cx = py * vz - pz * vy;
    const T cy = pz * vx - px * vz;
    const T cz = px * vy - py * vx;
    const T h2 = cx * cx + cy * cy + cz * cz;
    const T coef = T(-1.5) * P.mass * h2;

    const T h = P.h, hh = P.hh, h6 = P.h6;
    const T rs2 = P.mass * P.mass;
    const T inner2 = P.inner * P.inner;
    const T outer2 = P.outer * P.outer;

    T ar = T(0), ag = T(0), ab = T(0), aa = T(0);
    int status = kActive;
    T r2 = px * px + py * py + pz * pz;  // pre-step r^2, carried step to step
    int k = 0;
    for (; k < P.max_steps; ++k) {
      if (r2 < rs2) { status = kHorizon; break; }
      if (r2 > P.safe) { status = kEscaped; break; }
      if constexpr (kCkpt) {
        if (k % kSeg == 0) {
          T* ck = ckpt + (int64_t)(k / kSeg) * kCkptVals * n + i;
          ck[0] = px; ck[n] = py; ck[2 * n] = pz;
          ck[3 * n] = vx; ck[4 * n] = vy; ck[5 * n] = vz;
          ck[6 * n] = aa;
        }
      }

      // Classic RK4 tableau, in the plain march's operation order.
      T a1x, a1y, a1z;
      accel(coef, px, py, pz, r2, a1x, a1y, a1z);
      const T q2x = px + hh * vx, q2y = py + hh * vy, q2z = pz + hh * vz;
      const T u2x = vx + hh * a1x, u2y = vy + hh * a1y, u2z = vz + hh * a1z;
      T a2x, a2y, a2z;
      accel(coef, q2x, q2y, q2z, q2x * q2x + q2y * q2y + q2z * q2z, a2x, a2y, a2z);
      const T q3x = px + hh * u2x, q3y = py + hh * u2y, q3z = pz + hh * u2z;
      const T u3x = vx + hh * a2x, u3y = vy + hh * a2y, u3z = vz + hh * a2z;
      T a3x, a3y, a3z;
      accel(coef, q3x, q3y, q3z, q3x * q3x + q3y * q3y + q3z * q3z, a3x, a3y, a3z);
      const T q4x = px + h * u3x, q4y = py + h * u3y, q4z = pz + h * u3z;
      const T u4x = vx + h * a3x, u4y = vy + h * a3y, u4z = vz + h * a3z;
      T a4x, a4y, a4z;
      accel(coef, q4x, q4y, q4z, q4x * q4x + q4y * q4y + q4z * q4z, a4x, a4y, a4z);
      const T npx = px + h6 * (((vx + T(2) * u2x) + T(2) * u3x) + u4x);
      const T npy = py + h6 * (((vy + T(2) * u2y) + T(2) * u3y) + u4y);
      const T npz = pz + h6 * (((vz + T(2) * u2z) + T(2) * u3z) + u4z);
      const T nvx = vx + h6 * (((a1x + T(2) * a2x) + T(2) * a3x) + a4x);
      const T nvy = vy + h6 * (((a1y + T(2) * a2y) + T(2) * a3y) + a4y);
      const T nvz = vz + h6 * (((a1z + T(2) * a2z) + T(2) * a3z) + a4z);
      const T r2n = npx * npx + npy * npy + npz * npz;

      if (P.disk_on) {
        const bool candidate =
            P.opacity != T(0) && sign_of(py) != sign_of(npy) &&
            !((r2 > outer2 && r2n > outer2) || (r2 < inner2 && r2n < inner2));
        if (candidate) {
          const T r2ave = (npy * r2 - py * r2n) / (npy - py);
          if (r2ave > inner2 && r2ave < outer2) {
            const T r = sqrt(r2ave);
            const T frac = (P.outer - r) / (P.outer - P.inner);
            const T intensity = sin(T(kPi) * frac * frac);
            const T one_m = T(1) - aa;
            ar = ar + (P.disk_r * intensity) * one_m;
            ag = ag + (P.disk_g * intensity) * one_m;
            ab = ab + (P.disk_b * intensity) * one_m;
            aa = aa + (intensity * P.opacity) * one_m;
          }
        }
      }
      px = npx; py = npy; pz = npz;
      vx = nvx; vy = nvy; vz = nvz;
      r2 = r2n;
    }
    executed = status == kActive ? P.max_steps : k + 1;

    out[i] = vx;
    out[n + i] = vy;
    out[2 * n + i] = vz;
    out[3 * n + i] = ar;
    out[4 * n + i] = ag;
    out[5 * n + i] = ab;
    out[6 * n + i] = aa;
    status_out[i] = status;
    if (ray_steps != nullptr) ray_steps[i] = status == kActive ? P.max_steps : k;
  }

  // Block maximum of the executed counts, then one atomic per block. Every
  // thread of the block reaches this point (no early return above).
  __shared__ int warp_max[kThreads / 32];
  const int v = __reduce_max_sync(0xffffffffu, executed);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) m = max(m, warp_max[w]);
    if (m > 0) atomicMax(steps_out, m);
  }
}

template <typename T>
int launch(const void* vx, const void* vy, const void* vz, int64_t n,
           double h, double hh, double h6, double mass, double safe,
           double inner, double outer, double opacity, double disk_r, double disk_g, double disk_b,
           double p0x, double p0y, double p0z, int max_steps, int disk_on,
           void* out, void* status, void* steps, void* ray_steps, void* ckpt,
           void* stream) {
  MarchParams<T> P;
  P.h = T(h);
  P.hh = T(hh);
  P.h6 = T(h6);
  P.mass = T(mass);
  P.safe = T(safe);
  P.inner = T(inner);
  P.outer = T(outer);
  P.opacity = T(opacity);
  P.disk_r = T(disk_r);
  P.disk_g = T(disk_g);
  P.disk_b = T(disk_b);
  P.p0x = T(p0x);
  P.p0y = T(p0y);
  P.p0z = T(p0z);
  P.max_steps = max_steps;
  P.disk_on = disk_on;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (ckpt != nullptr) {
    march_kernel<T, true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)vx, (const T*)vy, (const T*)vz, n, P, (T*)out,
        (int32_t*)status, (int32_t*)steps, (int32_t*)ray_steps, (T*)ckpt);
  } else {
    march_kernel<T, false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)vx, (const T*)vy, (const T*)vz, n, P, (T*)out,
        (int32_t*)status, (int32_t*)steps, (int32_t*)ray_steps, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bs_march_f32(const void* vx, const void* vy, const void* vz, int64_t n,
                 double h, double hh, double h6, double mass, double safe,
                 double inner, double outer, double opacity, double disk_r, double disk_g, double disk_b,
                 double p0x, double p0y, double p0z, int max_steps, int disk_on,
                 void* out, void* status, void* steps, void* ray_steps, void* ckpt,
                 void* stream) {
  return launch<float>(vx, vy, vz, n, h, hh, h6, mass, safe, inner, outer, opacity,
                       disk_r, disk_g, disk_b, p0x, p0y, p0z, max_steps,
                       disk_on, out, status, steps, ray_steps, ckpt, stream);
}

int bs_march_f64(const void* vx, const void* vy, const void* vz, int64_t n,
                 double h, double hh, double h6, double mass, double safe,
                 double inner, double outer, double opacity, double disk_r, double disk_g, double disk_b,
                 double p0x, double p0y, double p0z, int max_steps, int disk_on,
                 void* out, void* status, void* steps, void* ray_steps, void* ckpt,
                 void* stream) {
  return launch<double>(vx, vy, vz, n, h, hh, h6, mass, safe, inner, outer, opacity,
                        disk_r, disk_g, disk_b, p0x, p0y, p0z, max_steps,
                        disk_on, out, status, steps, ray_steps, ckpt, stream);
}

}  // extern "C"
