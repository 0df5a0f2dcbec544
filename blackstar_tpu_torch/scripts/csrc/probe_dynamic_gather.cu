// The dynamic-gather probe's three kernels: a row gather, a lane gather and a
// dynamic-start range copy, in float32.
//
// They replace the TPU capability probe's Pallas kernels in
// scripts/probe_dynamic_gather.py: row_gather_kernel (:42, called through
// _pallas_row_gather :59), lane_gather_kernel (:54, _pallas_lane_gather :72)
// and the range-DMA kernel of probe_range_dma.make (:157, pallas_call :173).
// Their plain PyTorch twins sit beside the wrappers in
// blackstar_tpu_torch/scripts/probe_dynamic_gather.py.
//
//   row gather  out[i, :] = tbl[idx[i], :]: one warp per output row, each lane
//               moving 16-byte float4s, so a warp reads one table row and
//               writes one output row in whole 512-byte runs.
//   lane gather out[i, j] = tbl[i, idx[i, j]]: one thread per element; the
//               index and output accesses coalesce, the table reads fall
//               within row i (at most 1 KB) and hit in L1.
//   range copy  out = tbl[start:start+rows, :L_out] with start read on the
//               device (the TPU's SMEM scalar): each block stages its share
//               of whole table rows (at most kCopyRows of L floats) in shared
//               memory with one 1-D bulk copy (cp.async.bulk, Hopper's
//               counterpart of the TPU's dynamic-start DMA), which completes
//               on an mbarrier with a byte count, then writes their first
//               L_out columns. The 1 MB case (1024 rows of 256 floats) spans
//               32 blocks.
//
// What bounds them on an H100: bytes, and at the probe's sizes (at most 2 MB)
// the launch itself: the least bytes are the gathered rows or elements read
// once plus the output written once (and the indices), a few microseconds at
// most at 3.35 TB/s, below a launch's own cost. The design does nothing more
// about it: each kernel is one pass with coalesced 16-byte (row gather, bulk
// copy) or 4-byte accesses.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCopyRows = 32;     // table rows staged per block by the range copy
constexpr int kCopyMaxCols = 256; // floats per staged row at most (32 KB a block)

__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ idx, int rows,
                  int cols, float* __restrict__ out) {
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float4* src = reinterpret_cast<const float4*>(tbl + (int64_t)idx[warp] * cols);
  float4* dst = reinterpret_cast<float4*>(out + warp * cols);
  for (int j = lane; j < cols / 4; j += 32) dst[j] = __ldg(src + j);
}

__global__ void __launch_bounds__(kThreads)
lane_gather_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ idx, int rows,
                   int cols, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)rows * cols) return;
  const int64_t i = e / cols;
  out[e] = __ldg(tbl + i * cols + idx[e]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(kThreads)
range_copy_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ start_ptr,
                  int rows, int cols, int out_cols, float* __restrict__ out) {
  __shared__ __align__(128) float buf[kCopyRows * kCopyMaxCols];
  __shared__ __align__(8) uint64_t bar;
  const int row0 = blockIdx.x * kCopyRows;
  const int n_rows = min(kCopyRows, rows - row0);
  const uint32_t bytes = (uint32_t)(n_rows * cols * sizeof(float));
  const uint32_t bar_s = smem_addr(&bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float* src = tbl + ((int64_t)*start_ptr + row0) * cols;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_s), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf)), "l"(src), "r"(bytes), "r"(bar_s) : "memory");
  }
  // Every thread waits for phase 0 of the barrier: the copy's bytes landed.
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar_s), "r"(0) : "memory");
  }
  for (int e = threadIdx.x; e < n_rows * out_cols; e += blockDim.x) {
    const int r = e / out_cols, c = e % out_cols;
    out[(int64_t)(row0 + r) * out_cols + c] = buf[r * cols + c];
  }
}

}  // namespace

extern "C" {

int bs_row_gather_f32(const void* tbl, const void* idx, int rows, int cols, void* out,
                      void* stream) {
  const int64_t blocks = ((int64_t)rows * 32 + kThreads - 1) / kThreads;
  row_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)idx, rows, cols, (float*)out);
  return (int)cudaGetLastError();
}

int bs_lane_gather_f32(const void* tbl, const void* idx, int rows, int cols, void* out,
                       void* stream) {
  const int64_t blocks = ((int64_t)rows * cols + kThreads - 1) / kThreads;
  lane_gather_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)idx, rows, cols, (float*)out);
  return (int)cudaGetLastError();
}

int bs_range_copy_f32(const void* tbl, const void* start, int rows, int cols, int out_cols,
                      void* out, void* stream) {
  const int blocks = (rows + kCopyRows - 1) / kCopyRows;
  range_copy_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)start, rows, cols, out_cols, (float*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
