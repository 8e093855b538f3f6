// The mma.sync throughput ceiling of a card, for tools/mma_ceiling.py:
// IMMA m16n8k32 s8 and HMMA m16n8k16 bf16 issued back to back from
// registers (16 independent accumulators a warp, no memory traffic). The
// rate these reach bounds the kernels of this directory built on mma.sync
// (K3's two tiles, K2's bf16 body); the data sheet's tensor-core peaks
// are those of Hopper's wgmma.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

template <bool kInt8>
__global__ void mma_loop(int* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 5u, 7u};
  const uint32_t b0 = threadIdx.x ^ 0x55u, b1 = 0x1234u;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  Acc acc[16][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if constexpr (kInt8) ppl_ptx::mma_s8(acc[j], a, b0, b1);
      else ppl_ptx::mma_bf16(acc[j], a, b0, b1);
    }
  Acc s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) s += acc[j][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = (int)s;  // keeps the loop
}

}  // namespace

extern "C" {

// int8: 1 for IMMA, 0 for HMMA; out: blocks * threads ints
int ppl_mma_ceiling(int int8, int* out, int blocks, int threads, int iters,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (int8)
    mma_loop<true><<<blocks, threads, 0, s>>>(out, iters);
  else
    mma_loop<false><<<blocks, threads, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
