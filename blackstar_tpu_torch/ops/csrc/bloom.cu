// Bloom (kernel B5): out = img + strength * boxBlur(r, 3 passes)(img) for an
// (H, W, 3) row-major image, with the box filter of width 2r+1 zero-padded
// (pixels outside the image read as black) and normalised by 1 / (2r+1), as
// ImageFilters.hs:28-86 defines it; and, at one pass without the epilogue,
// out = boxBlur(r, 1 pass)(img), the fit's loss pyramid. Its plain twin is
// blackstar_tpu_torch/ops/filters.py (box_blur, and bloom on the CPU).
//
// It replaces no TPU kernel: the JAX package blooms with plain jnp.cumsum
// (blackstar_tpu/ops/filters.py:26-48) and has no Pallas kernel for it. It was
// added because the port's plain version, six cumsum passes each followed by
// gathers and a difference, took ~1.8 ms of device time in every bloomed
// 1080p frame at a few percent of the card's memory rate, on the critical
// path of the still and of the animation.
//
// What bounds it on an H100: bytes. One read of the image and one write of
// the result (2 x 24.9 MB at 1920x1080 float32, 0.015 ms at 3.35 TB/s); the
// arithmetic is ~20 operations an element. The intermediate (one more write
// and read of the image) stays mostly in the 50 MB L2.
//
// Design. The horizontal and the vertical zero-padded filters act on
// different axes, so they commute: (HV)^3 = H^3 V^3 in exact arithmetic
// (tests/test_torch_bloom.py checks the reordering in float64). So there are
// two launches of one kernel, each taking the three passes along one axis:
//   rows:    a block holds one row (W pixels x 3 channels) in shared memory,
//            runs the three horizontal passes there and writes the row once;
//   columns: a block holds a strip of WC adjacent floats of every row (H x
//            WC) in shared memory, runs the three vertical passes there and
//            writes img + strength * blur in its epilogue.
// Two buffers of the strip ping-pong between passes. In a pass, thread
// (s, k) takes column k of a segment of `seg` consecutive positions: it sums
// its first window outright, then slides it (add the entering value,
// subtract the leaving one) in a compensated (Kahan) sum. So no long prefix
// is differenced: the rounding of a window's sum does not grow with the
// image's width, only with the segment's length, and the compensation keeps
// even that near one rounding. `seg` is odd, so the 32 lanes of a warp fall
// in distinct shared-memory banks (for WC a power of two). In shared memory
// the strip, and in the epilogue the image's strip, arrive by asynchronous
// copies (cp.async), all of a thread's issued before it waits once.
//
// Measured at 1920x1080x3 float32, r = 76, on an H100 (both launches, by
// torch.profiler): 0.135 ms against 2.49 ms for the plain version. Sums in
// double (0.157 ms), loads batched in registers (0.180: 125 registers a
// thread halved the blocks an SM holds), loads one element at a time
// (0.142) and a first window built from per-segment sums (0.145) were
// slower. What bounds the rest, above the 0.015 ms of the bytes, is not
// measured: that needs a hardware profiler.
//
// Pass count. The number of passes is a template parameter of the kernel
// (kPasses): 3 for the bloom, 1 for the levels of the fit's loss pyramid
// (fit --pyramid K: radii 4, 8, 16, ..., one pass each), where the
// columns launch writes the blur alone (`img` null). Each count is its own
// instantiation, so neither path branches on the count at run time. The
// pyramid differentiates its levels, and the blur is its own transpose:
// along one axis the zero-padded filter A[x, y] = [|x - y| <= r] / (2r + 1)
// is symmetric, and the two axes' filters commute, so the vector-Jacobian
// product of the blur is the same blur of the gradient, one more call of
// this kernel (blackstar_tpu_torch/ops/bloom_cuda.py, box_blur_cuda).
// Measured at 1920x1080x3 on an H100 (both launches, graph clock): float32
// 0.0567, 0.0580 and 0.0581 ms at r = 4, 8 and 16 (rows 0.026 and columns
// 0.032 ms by torch.profiler), float64 0.098-0.101 ms; the plain one-pass
// blur's forward 0.82-0.83 ms. Its bound is 0.0297 ms (two launches, each
// one read and one write of the image), so about half its roofline.
//
// Second path. Where a strip's two buffers do not fit in a block's shared
// memory (float32 columns taller than ~3,600 rows at WC = 8 take WC 4, 2 or
// 1; past ~29,000 float32 or ~14,500 float64 positions even WC = 1 does
// not fit), the wrapper passes a scratch buffer in device memory, and the
// same kernel keeps its two buffers there (2 x the strip a block); the
// wrapper chooses (blackstar_tpu_torch/ops/bloom_cuda.py, plan()).
//
// The strength is read on the card from its 0-d tensor (a null pointer: the
// value passed), so the wrapper never waits for the device. Templated on
// float (the render path) and double (users' float64 scenes and the on-card
// gates).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // THREADS in bloom_cuda.py

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// The positions one launch blurs: n along the blurred axis, `step` elements
// apart in the image; `inner` elements across it, cut into strips of WC;
// consecutive outer indices (rows, for the horizontal launch) `outer_step`
// apart.
struct Axis {
  int64_t n, step, inner, outer_step;
  int seg;     // positions a thread takes in a pass
  int r;       // the radius, at most n (a wider window reads no more)
  double inv;  // 1 / (2r + 1) of the requested radius
};

// One pass of the zero-padded box filter along the strip's axis, from `in`
// to `out` (n rows of WC elements each): thread (s, k) writes column k < wc
// of rows [s * seg, (s + 1) * seg). No __restrict__ here: in scratch memory
// a read-only (non-coherent) load could miss the previous pass's writes.
template <typename T, int WC>
__device__ __forceinline__ void box_pass(const T* in, T* out, const Axis& A, int wc) {
  const int k = threadIdx.x % WC;
  const int64_t a0 = (int64_t)(threadIdx.x / WC) * A.seg;
  if (k >= wc || a0 >= A.n) return;
  const int64_t a1 = min64(a0 + A.seg, A.n);
  const int64_t lo = max64(a0 - A.r, 0), hi = min64(a0 + A.r, A.n - 1);
  // The first window, in four independent sums, taken afresh in every
  // segment: its rounding does not carry along the axis.
  const T* p = in + lo * WC + k;
  T s0 = T(0), s1 = T(0), s2 = T(0), s3 = T(0);
  int64_t left = hi - lo + 1;
  for (; left >= 4; left -= 4, p += 4 * WC) {
    s0 += p[0];
    s1 += p[WC];
    s2 += p[2 * WC];
    s3 += p[3 * WC];
  }
  for (; left > 0; --left, p += WC) s0 += p[0];
  // Slide: position a's window gains a + r + 1 and loses a - r. The sum is
  // compensated (Kahan): `comp` keeps what each addition rounds away.
  T sum = (s0 + s1) + (s2 + s3), comp = T(0);
  const T inv = (T)A.inv;
  const T* add = in + (a0 + A.r + 1) * WC + k;
  const T* sub = in + (a0 - A.r) * WC + k;
  T* o = out + a0 * WC + k;
  for (int64_t a = a0; a < a1; ++a, add += WC, sub += WC, o += WC) {
    *o = (sum - comp) * inv;
    T d = T(0);
    if (a + A.r + 1 < A.n) d = *add;
    if (a - A.r >= 0) d -= *sub;
    const T y = d - comp;
    const T t = sum + y;
    comp = (t - sum) - y;
    sum = t;
  }
}

// A block's strip through buffers b0 and b1 (n x WC each): load, kPasses
// passes (1 or 3), store to dst (as img + strength * blur where `img` is
// given). An odd count leaves the blur in b1, so b0 is free for the
// epilogue. In
// shared memory the strip, and the image's strip for the epilogue, arrive
// by asynchronous copies (cp.async): a thread issues all of its copies
// before it waits once, so a block waits for device memory once a phase and
// not once an element, and the copies take no registers.
template <typename T, int WC, int kPasses, bool kShared>
__device__ __forceinline__ void run_strip(const T* __restrict__ src, T* __restrict__ dst,
                                          const T* __restrict__ img,
                                          const T* __restrict__ strength_ptr, T strength,
                                          const Axis& A, int64_t base, int wc, T* b0, T* b1) {
  static_assert(kPasses == 1 || kPasses == 3, "the blur must end in b1");
  using I = typename std::conditional<kShared, int, int64_t>::type;
  const I span = (I)(A.n * WC);
  for (I e = threadIdx.x; e < span; e += kThreads) {
    const I a = e / WC;
    const int k = (int)(e - a * WC);
    if (k < wc) {
      const T* g = src + base + (int64_t)a * A.step + k;
      if constexpr (kShared) {
        __pipeline_memcpy_async(b0 + e, g, sizeof(T));
      } else {
        b0[e] = *g;
      }
    }
  }
  if constexpr (kShared) {
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  box_pass<T, WC>(b0, b1, A, wc);
  __syncthreads();
  if constexpr (kPasses == 3) {
    box_pass<T, WC>(b1, b0, A, wc);
    __syncthreads();
    box_pass<T, WC>(b0, b1, A, wc);
    __syncthreads();
  }

  // The epilogue: b0 is free. Each thread reads back only the elements it
  // copied itself, so its own wait suffices.
  if constexpr (kShared) {
    if (img) {
      for (I e = threadIdx.x; e < span; e += kThreads) {
        const I a = e / WC;
        const int k = (int)(e - a * WC);
        if (k < wc) __pipeline_memcpy_async(b0 + e, img + base + (int64_t)a * A.step + k, sizeof(T));
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
    }
  }
  const T s = strength_ptr ? *strength_ptr : strength;
  for (I e = threadIdx.x; e < span; e += kThreads) {
    const I a = e / WC;
    const int k = (int)(e - a * WC);
    if (k < wc) {
      const int64_t g = base + (int64_t)a * A.step + k;
      T v = b1[e];
      if (img) v = (kShared ? b0[e] : img[g]) + s * v;
      dst[g] = v;
    }
  }
}

// Block b takes strip b % strips of outer index b / strips. Its two buffers
// lie in shared memory, or, where the wrapper passes `scratch`, in its own
// slice of that (the branch is taken whole, so each copy of run_strip knows
// the memory it addresses).
template <typename T, int WC, int kPasses>
__global__ void __launch_bounds__(kThreads)
bloom_kernel(const T* __restrict__ src, T* __restrict__ dst, const T* __restrict__ img,
             const T* __restrict__ strength_ptr, T strength, Axis A, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t strips = (A.inner + WC - 1) / WC;
  const int64_t strip = blockIdx.x % strips;
  const int wc = (int)min64(WC, A.inner - strip * WC);
  const int64_t base = (blockIdx.x / strips) * A.outer_step + strip * WC;
  const int64_t span = A.n * WC;
  if (scratch) {
    T* b0 = scratch + 2 * span * blockIdx.x;
    run_strip<T, WC, kPasses, false>(src, dst, img, strength_ptr, strength, A, base, wc, b0,
                                     b0 + span);
  } else {
    T* b0 = reinterpret_cast<T*>(smem);
    run_strip<T, WC, kPasses, true>(src, dst, img, strength_ptr, strength, A, base, wc, b0,
                                    b0 + span);
  }
}

template <typename T, int WC, int kPasses>
int launch_wc(const T* src, T* dst, const T* img, const T* strength_ptr, T strength,
              const Axis& A, int64_t blocks, T* scratch, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : (size_t)(2 * A.n * WC) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bloom_kernel<T, WC, kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bloom_kernel<T, WC, kPasses><<<(unsigned)blocks, kThreads, smem, stream>>>(
      src, dst, img, strength_ptr, strength, A, scratch);
  return (int)cudaGetLastError();
}

template <typename T, int kPasses>
int launch_pass(int wc, const T* src, T* dst, const T* img, const T* strength_ptr, T strength,
                const Axis& A, int64_t blocks, T* scratch, cudaStream_t stream) {
  switch (wc) {
    case 1: return launch_wc<T, 1, kPasses>(src, dst, img, strength_ptr, strength, A, blocks, scratch, stream);
    case 2: return launch_wc<T, 2, kPasses>(src, dst, img, strength_ptr, strength, A, blocks, scratch, stream);
    case 3: return launch_wc<T, 3, kPasses>(src, dst, img, strength_ptr, strength, A, blocks, scratch, stream);
    case 4: return launch_wc<T, 4, kPasses>(src, dst, img, strength_ptr, strength, A, blocks, scratch, stream);
    case 8: return launch_wc<T, 8, kPasses>(src, dst, img, strength_ptr, strength, A, blocks, scratch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The rows launch writes the horizontal blur to `tmp`; the columns launch
// blurs `tmp` vertically and writes to `out` the blur, or, where `img` is
// given (the bloom), img + strength * blur. Each launch takes its strip
// width, segment length and scratch (null: shared memory) from the
// wrapper's plan.
template <typename T, int kPasses>
int blur(const void* src, void* tmp, void* out, int64_t h, int64_t w, int64_t r, const void* img,
         const void* strength_ptr, double strength, int row_wc, int row_seg, void* row_scratch,
         int col_wc, int col_seg, void* col_scratch, void* stream) {
  const double inv = 1.0 / (2.0 * (double)r + 1.0);
  const Axis rows{w, 3, 3, 3 * w, row_seg, (int)std::min(r, w), inv};
  const Axis cols{h, 3 * w, 3 * w, 0, col_seg, (int)std::min(r, h), inv};
  const cudaStream_t s = (cudaStream_t)stream;
  int e = launch_pass<T, kPasses>(row_wc, (const T*)src, (T*)tmp, nullptr, nullptr, T(0), rows,
                                  h * ((3 + row_wc - 1) / row_wc), (T*)row_scratch, s);
  if (e) return e;
  return launch_pass<T, kPasses>(col_wc, (const T*)tmp, (T*)out, (const T*)img,
                                 (const T*)strength_ptr, T(strength), cols,
                                 (3 * w + col_wc - 1) / col_wc, (T*)col_scratch, s);
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block of this device may take.
int bs_bloom_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

int bs_bloom_f32(const void* img, void* tmp, void* out, int64_t h, int64_t w, int64_t r,
                 const void* strength_ptr, double strength, int row_wc, int row_seg,
                 void* row_scratch, int col_wc, int col_seg, void* col_scratch, void* stream) {
  return blur<float, 3>(img, tmp, out, h, w, r, img, strength_ptr, strength, row_wc, row_seg,
                        row_scratch, col_wc, col_seg, col_scratch, stream);
}

int bs_bloom_f64(const void* img, void* tmp, void* out, int64_t h, int64_t w, int64_t r,
                 const void* strength_ptr, double strength, int row_wc, int row_seg,
                 void* row_scratch, int col_wc, int col_seg, void* col_scratch, void* stream) {
  return blur<double, 3>(img, tmp, out, h, w, r, img, strength_ptr, strength, row_wc, row_seg,
                         row_scratch, col_wc, col_seg, col_scratch, stream);
}

// One pass of the box blur alone (no epilogue): the levels of the fit's
// loss pyramid.
int bs_box_blur_f32(const void* img, void* tmp, void* out, int64_t h, int64_t w, int64_t r,
                    int row_wc, int row_seg, void* row_scratch, int col_wc, int col_seg,
                    void* col_scratch, void* stream) {
  return blur<float, 1>(img, tmp, out, h, w, r, nullptr, nullptr, 0.0, row_wc, row_seg,
                        row_scratch, col_wc, col_seg, col_scratch, stream);
}

int bs_box_blur_f64(const void* img, void* tmp, void* out, int64_t h, int64_t w, int64_t r,
                    int row_wc, int row_seg, void* row_scratch, int col_wc, int col_seg,
                    void* col_scratch, void* stream) {
  return blur<double, 1>(img, tmp, out, h, w, r, nullptr, nullptr, 0.0, row_wc, row_seg,
                         row_scratch, col_wc, col_seg, col_scratch, stream);
}

}  // extern "C"
