// Page read (K5): the cache read of the KV-write microbench.
//
// Replaces the TPU Pallas kernel
//   K5  ppl/llm/serving_tpu/tools/microbench_scatter_7b.py:133 pallas_read
//       (body read_kernel, :126)
// which copies page 0 of layer 0 (rows [0, PS) of every KV head of the
// flat int8 cache [KVH, L*S, R]) from HBM into VMEM with one DMA and
// writes the first 8 of those rows as f32 [KVH, 8, R]. The microbench
// puts it before or after each KV write to see whether a kernel that
// reads the cache in place changes what the write costs.
//
// What bounds it on an H100: bytes, KVH*PS*R read and KVH*rows*R*4
// written (1 MB and 256 kB at the 7B geometry: 0.39 us at 3.35 TB/s),
// which is below what one launch costs at all (the launch floor that
// chip_smoke.py times beside it), so the kernel's own part is latency:
// how few round trips to device memory each CTA makes, and, when many
// rows convert, how many SMs share the conversion.
//
// Design: the page is cut into chunks of whole rows (plan_page_read in
// ops/kernels/cache_read.py: KVH x chunks CTAs up to 8 a SM, 32 chunks
// of 4 rows a head at the 7B geometry, 1,024 CTAs), one CTA a chunk.
// One elected thread arms an mbarrier with the chunk's bytes and
// issues ONE bulk asynchronous copy of the chunk into shared memory
// (cp.async.bulk, the counterpart of the Pallas kernel's
// make_async_copy(...).start()/.wait() on a DMA semaphore), so no thread
// spends registers or round trips on the copy. The CTAs whose chunk holds
// rows < rows wait on the barrier's phase and convert those rows with
// 16-byte shared-memory loads and float4 stores; the others wait with
// one thread only (the copy must land before the CTA's shared memory is
// given up) and end.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) page_read_kernel(
    const int8_t* __restrict__ cache, float* __restrict__ out,
    long long head_stride, int page_size, int r, int chunk_rows,
    int n_chunks, int rows) {
  extern __shared__ __align__(128) uint4 chunk[];   // [chunk_rows * r / 16]
  __shared__ __align__(8) uint64_t full;
  const int h = blockIdx.x / n_chunks;
  const int row0 = (blockIdx.x % n_chunks) * chunk_rows;
  const int n_rows = min(chunk_rows, page_size - row0);
  const int n_out = min(n_rows, rows - row0);   // rows this CTA converts
  const uint32_t bar = ppl_ptx::smem_u32(&full);
  if (threadIdx.x == 0) {
    ppl_ptx::mbar_init(bar, 1);
    ppl_ptx::mbar_expect_tx(bar, (uint32_t)(n_rows * r));
    ppl_ptx::bulk_copy_g2s(ppl_ptx::smem_u32(chunk),
                           cache + (size_t)h * head_stride
                               + (size_t)row0 * r,
                           (uint32_t)(n_rows * r), bar);
  }
  if (n_out <= 0) {
    if (threadIdx.x == 0) ppl_ptx::mbar_wait(bar, 0);
    return;
  }
  __syncthreads();   // the barrier's init before any other thread polls it
  ppl_ptx::mbar_wait(bar, 0);
  float4* o = reinterpret_cast<float4*>(
      out + ((size_t)h * rows + row0) * r);
  for (int i = threadIdx.x; i < n_out * r / 16; i += blockDim.x) {
    const uint4 v = chunk[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[4 * i + j] = make_float4(
          (float)(int8_t)(w[j] & 0xff), (float)(int8_t)((w[j] >> 8) & 0xff),
          (float)(int8_t)((w[j] >> 16) & 0xff), (float)(int8_t)(w[j] >> 24));
  }
}

}  // namespace

// Plain C interface (loaded with ctypes): cache int8 [kvh, ls_rows, r],
// out f32 [kvh, rows, r]; the page cut into chunks of chunk_rows rows
// (the last may be shorter), one CTA a chunk; returns the cudaError_t of
// the launch.
extern "C" int ppl_page_read(const void* cache, void* out, int kvh,
                             long long ls_rows, int page_size, int r,
                             int rows, int chunk_rows, void* stream) {
  const int n_chunks = (page_size + chunk_rows - 1) / chunk_rows;
  const int chunk_bytes = chunk_rows * r;
  const cudaError_t err = ppl_ptx::allow_smem<page_read_kernel>(chunk_bytes);
  if (err != cudaSuccess) return (int)err;
  page_read_kernel<<<kvh * n_chunks, kThreads, chunk_bytes,
                     (cudaStream_t)stream>>>(
      (const int8_t*)cache, (float*)out, ls_rows * r, page_size, r,
      chunk_rows, n_chunks, rows);
  return (int)cudaGetLastError();
}
