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
// writes 32 (velocity, RGBA, status) in float32, but runs ~220 RK4 steps on
// the default scene, each four accelerations and the stage and final
// combinations: ~128 operations. So it is bound by FP32 instruction issue,
// not by memory. The design keeps the whole ray state in registers, walks
// the pixels in row-major order so the 32 rays of a warp are neighbours with
// similar step counts (less divergence), and lets each thread stop at its
// own ray's termination. The disk shading (a divide, a square root, a sine)
// runs inline, only behind the cheap candidate test (march_step.cuh).
//
// The step itself (acceleration, RK4, classification, disk candidate and
// crossing) comes from march_step.cuh, which the adjoint kernel B2 shares,
// so that B2's replay passes through this kernel's states bit for bit. Its
// arithmetic is the TPU kernel's: r^-5 by rsqrt powers (one MUFU instruction
// in float) and explicit fused multiply-adds; the file builds with
// -fmad=false so that nothing else is fused. It rounds otherwise than the
// plain march (a divide for r^-5, no fusion), so in float32 it follows its
// own orbit near the photon ring: chip_smoke.py holds it to the float64
// plain march no worse than the float32 plain march is
// (scripts/march_accuracy.py), and in float64 within 1e-7 of the plain march.
// The step's half and sixth come in from the caller, rounded as the plain
// march rounds them (true division on the host). On the card (`nvcc
// -Xptxas -v`, float): 40 registers, no stack frame; the step loop spans 230
// SASS instructions with 5 RSQ (four accelerations and the disk's square
// root), and its only divides and their slow paths are the disk branch's.
// Measured at 1920x1080 float32: 2.15 ms against a 0.88 ms bound (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md section 6 has the history).
//
// The executed step count is the maximum over rays of the loop iterations
// each ray ran (the iteration that classifies a ray counts; a truncated ray
// counts max_steps), reduced per block and combined with one atomicMax. It
// equals the plain march's `steps` when the two take the same orbits. When
// the caller passes a ray_steps array, each ray also writes its count of
// advancing RK4 steps there (the classifying iteration does no RK4 step):
// the work the frame needed, for its operation count.
//
// Checkpointing variant (kCkpt, launched when the caller passes a checkpoint
// array; the training forward): what the adjoint kernel B2
// (march_adjoint.cu) starts from. Before every advancing step k with
// k % 16 == 0 (after both classification tests passed, before the RK4 step)
// the thread writes its state (px py pz vx vy vz alpha) into an
// (n_seg, 7, n) array laid out [segment][value][ray], so a warp's stores
// coalesce; with ray_steps (B2's nc) that is all B2 needs. Entries past a
// ray's end are not written. The frame path launches kCkpt = false, whose
// code is the kernel without the variant. The stores cost 28 bytes per ray
// per 16 steps (2.2 GB at 1080p, float32), mostly hidden under the
// arithmetic (times in PERF.md).
//
// Templated on float (the render path) and double (the on-card gate that
// separates semantics from rounding).

#include <cuda_runtime.h>
#include <cstdint>

#include "march_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCkptVals = 7;   // px py pz vx vy vz alpha

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
    V3<T> p = {P.p0x, P.p0y, P.p0z};
    V3<T> v = {vx0[i], vy0[i], vz0[i]};
    V3<T> cross;
    T h2;
    const T coef = ray_coef(p, v, P.mass, cross, h2);
    const T rs2 = P.mass * P.mass;
    const T inner2 = P.inner * P.inner;
    const T outer2 = P.outer * P.outer;

    T ar = T(0), ag = T(0), ab = T(0), aa = T(0);
    int status = kActive;
    T r2 = r2_of(p);  // pre-step r^2, carried step to step
    int k = 0;
    for (; k < P.max_steps; ++k) {
      status = classify(r2, rs2, P.safe);
      if (status != kActive) break;
      if constexpr (kCkpt) {
        if (k % kSeg == 0) {
          T* ck = ckpt + (int64_t)(k / kSeg) * kCkptVals * n + i;
          ck[0] = p.x; ck[n] = p.y; ck[2 * n] = p.z;
          ck[3 * n] = v.x; ck[4 * n] = v.y; ck[5 * n] = v.z;
          ck[6 * n] = aa;
        }
      }
      V3<T> np, nv;
      rk4_step(coef, P.h, P.hh, P.h6, p, v, r2, np, nv);
      const T r2n = r2_of(np);
      if (P.disk_on && disk_candidate(P.opacity, p.y, np.y, r2, r2n, inner2, outer2)) {
        const Crossing<T> c =
            disk_crossing(p.y, np.y, r2, r2n, P.inner, P.outer, inner2, outer2);
        if (c.hit) {
          ar = blend_over(ar, P.disk_r * c.intensity, aa);
          ag = blend_over(ag, P.disk_g * c.intensity, aa);
          ab = blend_over(ab, P.disk_b * c.intensity, aa);
          aa = blend_over(aa, c.intensity * P.opacity, aa);
        }
      }
      p = np;
      v = nv;
      r2 = r2n;
    }
    executed = status == kActive ? P.max_steps : k + 1;

    out[i] = v.x;
    out[n + i] = v.y;
    out[2 * n + i] = v.z;
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
  const int m = __reduce_max_sync(0xffffffffu, executed);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int b = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) b = max(b, warp_max[w]);
    if (b > 0) atomicMax(steps_out, b);
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
