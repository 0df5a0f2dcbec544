// The dynamic-gather probe's three kernels: a row gather, a lane gather and a
// dynamic-start range copy, in float32; and an empty kernel, launched with
// each one's grid, that prices the launch alone.
//
// They replace the TPU capability probe's Pallas kernels in
// scripts/probe_dynamic_gather.py: row_gather_kernel (:42, called through
// _pallas_row_gather :59), lane_gather_kernel (:54, _pallas_lane_gather :72)
// and the range-DMA kernel of probe_range_dma.make (:157, pallas_call :173).
// Their plain PyTorch twins sit beside the wrappers in
// blackstar_tpu_torch/scripts/probe_dynamic_gather.py.
//
//   row gather  out[i, :] = tbl[idx[i], :]: one warp per output row,
//               kRowWarps rows a block (512 blocks at 2048 rows). A lane
//               issues all its 16-byte float4 loads of the row (at most
//               kRowPerLane a pass) before its first store, so a warp waits
//               for one table round trip after its index, not one per load;
//               the warp reads one table row and writes one output row in
//               whole 512-byte runs. Measured in turns on one card and
//               slower: bulk copies (cp.async.bulk) of each row into shared
//               memory, all on one mbarrier, then one bulk store a block, at
//               4, 8 or 16 rows a block (or as many as fill the SMs once),
//               with a barrier and a store per row, or with an evict-first
//               store (6-45% slower than this kernel's first design at 2048
//               rows, no faster at fewer); 1, 16 or 32 warps a block, or 8
//               or 16 lanes a row. 2 or 8 warps a block measured the same;
//               no-allocate loads and evict-first stores changed nothing.
//   lane gather out[i, j] = tbl[i, idx[i, j]]: one warp per row, kLaneWarps
//               rows a block (256 blocks at 512 rows). The warp loads its
//               whole index row as int4s and its table row (at most
//               kLaneMaxCols floats) as float4s, all before the first use,
//               stages the table row in shared memory, and then each lane
//               does four shared-memory reads per int4 of indices and one
//               float4 store. No division: the row is the warp's.
//   range copy  out = tbl[start:start+rows, :L_out] with start read on the
//               device (the TPU's SMEM scalar): kCopyRows rows a one-warp
//               block (256 blocks at 1024 rows). Lane r issues one 1-D bulk
//               copy (cp.async.bulk, the Tensor Memory Accelerator's copy,
//               Hopper's counterpart of the TPU's dynamic-start DMA) for row
//               r, global to shared, carrying only the row's first L_out
//               floats; all complete on one mbarrier that lane 0 armed with
//               their summed byte count; then lane 0 stores the block's rows,
//               contiguous in the output, with one bulk copy from shared to
//               global. No register pass. Issuing the copies from one lane, or
//               taking 8 rows a block, measured slower at every probe size. A 2-D
//               tensor-map load of the block's [rows × L_out] box would move
//               the same bytes, but its tensor map holds the table's address
//               and must be encoded on the host (cuTensorMapEncodeTiled) for
//               every table a wrapper is given: the 1-D copies need nothing
//               but the pointer, and were taken.
//
// What bounds them on an H100: bytes, and at the probe's sizes (at most 2 MB)
// the launch itself: the least bytes are the gathered rows or elements read
// once plus the output written once (and the indices), a few microseconds at
// most at 3.35 TB/s, near a launch's own cost. The range copy reads only the
// L_out columns it keeps (the TPU kernel's copy, and this kernel's first
// design, read whole rows: twice the bytes at the probe's 128 of 256).
// empty_kernel, launched with a kernel's grid and block, is the floor no
// kernel of that shape goes below.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kRowWarps = 4;      // rows (one a warp) per row-gather block
constexpr int kRowPerLane = 4;    // float4 loads a lane issues before its stores
constexpr int kLaneWarps = 2;     // rows (one a warp) per lane-gather block
constexpr int kLaneMaxCols = 1024;  // floats a lane-gather row at most (4 KiB a warp)
constexpr int kLanePerLane = kLaneMaxCols / 128;  // int4s / float4s a lane at most
constexpr int kCopyRows = 4;      // rows a range-copy block, one a lane of its warp
constexpr int kCopyMaxCols = 256; // floats an output row at most (4 KiB a block)

enum Kernel { kRowGather = 0, kLaneGather = 1, kRangeCopy = 2 };

// The grid and block each kernel is launched with for `rows` rows.
void dims(int which, int rows, int* grid, int* block) {
  switch (which) {
    case kRowGather:
      *grid = (rows + kRowWarps - 1) / kRowWarps;
      *block = kRowWarps * 32;
      break;
    case kLaneGather:
      *grid = (rows + kLaneWarps - 1) / kLaneWarps;
      *block = kLaneWarps * 32;
      break;
    default:
      *grid = (rows + kCopyRows - 1) / kCopyRows;
      *block = 32;
  }
}

__global__ void __launch_bounds__(kRowWarps * 32)
row_gather_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ idx, int rows,
                  int cols, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= rows) return;  // a whole warp
  const int q = cols >> 2;  // float4s a row
  const float4* src = reinterpret_cast<const float4*>(tbl + (int64_t)__ldg(idx + i) * cols);
  float4* dst = reinterpret_cast<float4*>(out + i * cols);
  for (int base = lane; base < q; base += 32 * kRowPerLane) {
    float4 v[kRowPerLane];
#pragma unroll
    for (int t = 0; t < kRowPerLane; ++t) {
      const int j = base + 32 * t;
      if (j < q) v[t] = __ldg(src + j);
    }
#pragma unroll
    for (int t = 0; t < kRowPerLane; ++t) {
      const int j = base + 32 * t;
      if (j < q) dst[j] = v[t];
    }
  }
}

__global__ void __launch_bounds__(kLaneWarps * 32)
lane_gather_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ idx, int rows,
                   int cols, float* __restrict__ out) {
  __shared__ __align__(16) float row_buf[kLaneWarps][kLaneMaxCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kLaneWarps + warp;
  if (i >= rows) return;  // a whole warp: nothing below syncs the block
  const int q = cols >> 2;  // int4s and float4s a row
  const int4* ix = reinterpret_cast<const int4*>(idx + i * cols);
  const float4* src = reinterpret_cast<const float4*>(tbl + i * cols);
  float4* buf4 = reinterpret_cast<float4*>(row_buf[warp]);
  int4 k[kLanePerLane];
#pragma unroll
  for (int t = 0; t < kLanePerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < q) k[t] = __ldg(ix + j);
  }
#pragma unroll
  for (int t = 0; t < kLanePerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < q) buf4[j] = __ldg(src + j);
  }
  __syncwarp();
  const float* buf = row_buf[warp];
  float4* dst = reinterpret_cast<float4*>(out + i * cols);
#pragma unroll
  for (int t = 0; t < kLanePerLane; ++t) {
    const int j = lane + 32 * t;
    if (j < q) dst[j] = make_float4(buf[k[t].x], buf[k[t].y], buf[k[t].z], buf[k[t].w]);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __launch_bounds__(32)
range_copy_kernel(const float* __restrict__ tbl, const int32_t* __restrict__ start_ptr,
                  int rows, int cols, int out_cols, float* __restrict__ out) {
  __shared__ __align__(128) float buf[kCopyRows * kCopyMaxCols];
  __shared__ __align__(8) uint64_t bar;
  const int64_t start = __ldg(start_ptr);  // in flight while the barrier is set up
  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kCopyRows;
  const int n_rows = min(kCopyRows, rows - row0);
  const uint32_t row_bytes = (uint32_t)out_cols * sizeof(float);
  const uint32_t bar_s = smem_addr(&bar), buf_s = smem_addr(buf);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar_s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar_s), "r"(n_rows * row_bytes) : "memory");
  }
  __syncwarp();
  if (lane < n_rows) {  // lane r issues row r's copy
    const float* src = tbl + (start + row0 + lane) * cols;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(buf_s + lane * row_bytes), "l"(src), "r"(row_bytes), "r"(bar_s) : "memory");
  }
  if (lane != 0) return;
  // Phase 0 of the barrier completes when every row's bytes have landed.
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
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(out + (int64_t)row0 * out_cols), "r"(buf_s), "r"(n_rows * row_bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  // The shared source must stay until the store has read it.
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

int bs_probe_dims(int which, int rows, int* grid, int* block) {
  dims(which, rows, grid, block);
  return 0;
}

int bs_row_gather_f32(const void* tbl, const void* idx, int rows, int cols, void* out,
                      void* stream) {
  if (cols % 4) return (int)cudaErrorInvalidValue;
  int grid, block;
  dims(kRowGather, rows, &grid, &block);
  row_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)idx, rows, cols, (float*)out);
  return (int)cudaGetLastError();
}

int bs_lane_gather_f32(const void* tbl, const void* idx, int rows, int cols, void* out,
                       void* stream) {
  if (cols % 4 || cols > kLaneMaxCols) return (int)cudaErrorInvalidValue;
  int grid, block;
  dims(kLaneGather, rows, &grid, &block);
  lane_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)idx, rows, cols, (float*)out);
  return (int)cudaGetLastError();
}

int bs_range_copy_f32(const void* tbl, const void* start, int rows, int cols, int out_cols,
                      void* out, void* stream) {
  if (cols % 4 || out_cols % 4 || out_cols > kCopyMaxCols) return (int)cudaErrorInvalidValue;
  int grid, block;
  dims(kRangeCopy, rows, &grid, &block);
  range_copy_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)tbl, (const int32_t*)start, rows, cols, out_cols, (float*)out);
  return (int)cudaGetLastError();
}

int bs_empty(int grid, int block, void* stream) {
  empty_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
