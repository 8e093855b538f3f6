// Page read (K5): the cache read of the KV-write microbench.
//
// Replaces the TPU Pallas kernel
//   K5  ppl/llm/serving_tpu/tools/microbench_scatter_7b.py:pallas_read
//       (body read_kernel)
// which copies page 0 of layer 0 (rows [0, PS) of every KV head of the
// flat int8 cache [KVH, L*S, R]) from HBM into VMEM with one DMA and
// writes the first 8 of those rows as f32 [KVH, 8, R]. The microbench
// puts it before or after each KV write to see whether a kernel that
// reads the cache in place changes what the write costs.
//
// Design: one CTA per KV head. It copies its head's PS*R bytes into
// shared memory with 16-byte vector loads (the DMA's counterpart, so
// the read moves the bytes the Pallas kernel moves), synchronises, and
// writes rows [0, rows) of the copy as f32. What bounds it on an H100:
// bytes, KVH*PS*R read and KVH*rows*R*4 written (1 MB and 256 kB at the
// 7B geometry, well under a microsecond at 3.35 TB/s), so a launch costs
// what launching costs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) page_read_kernel(
    const int8_t* __restrict__ cache, float* __restrict__ out,
    long long head_stride, int page_bytes, int r, int rows) {
  extern __shared__ uint4 page[];   // [page_bytes / 16]
  const int h = blockIdx.x;
  const uint4* src =
      reinterpret_cast<const uint4*>(cache + (size_t)h * head_stride);
  for (int i = threadIdx.x; i < page_bytes / 16; i += blockDim.x)
    page[i] = src[i];
  __syncthreads();
  const int8_t* p8 = reinterpret_cast<const int8_t*>(page);
  float* o = out + (size_t)h * rows * r;
  for (int i = threadIdx.x; i < rows * r; i += blockDim.x)
    o[i] = (float)p8[i];
}

}  // namespace

// Plain C interface (loaded with ctypes): cache int8 [kvh, ls_rows, r],
// out f32 [kvh, rows, r]; returns the cudaError_t of the launch.
extern "C" int ppl_page_read(const void* cache, void* out, int kvh,
                             long long ls_rows, int page_size, int r,
                             int rows, void* stream) {
  const int page_bytes = page_size * r;
  static int allowed = 48 * 1024;
  if (page_bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        page_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        page_bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = page_bytes;
  }
  page_read_kernel<<<kvh, kThreads, page_bytes, (cudaStream_t)stream>>>(
      (const int8_t*)cache, (float*)out, ls_rows * r, page_bytes, r, rows);
  return (int)cudaGetLastError();
}
