// Inline PTX shared by the kernels of this directory: cp.async copies into
// shared memory, Hopper's bulk asynchronous copy completing on an
// mbarrier, ldmatrix fragment loads, the int8 (k32 and k16) and bf16
// tensor-core mma.sync shapes, and the shared-memory limit raised once per
// size and device.
//
// mma.sync fragments (PTX ISA, "Matrix fragments for mma.m16n8k16/k32"):
// in units of 32-bit registers both shapes below are the same 16 x 8-word
// A, 8-word x 8 B and 16 x 8 C tiles. With g = lane / 4, tig = lane % 4:
//   A a0: row g,     word tig      a1: row g + 8, word tig
//     a2: row g,     word tig + 4  a3: row g + 8, word tig + 4
//   B b0: words tig (k) of column g, b1: word tig + 4 of column g
//   C c0, c1: row g, columns 2*tig, 2*tig + 1; c2, c3: row g + 8
// where a word holds 4 int8 or 2 bf16 consecutive in k, lowest k in the
// lowest byte.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppl_ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; copies src_bytes (0 or 16) and zero-fills the
// rest, so a masked copy writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared, likewise (0 or 4)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Hopper's bulk asynchronous copy (cp.async.bulk, the copy engine the TMA
// drives) and the shared-memory barrier it completes on (PTX ISA,
// "Data Movement and Conversion Instructions: cp.async.bulk" and
// "mbarrier"). One thread issues a copy of any multiple of 16 bytes; the
// barrier counts the bytes landed as transactions, so a wait on its phase
// returns once the arrivals and all the expected bytes are in. K5 is built
// on these, and K3's decode tile on their tensor form (a box of
// a tensor map, swizzled as it lands) with a ring of full and empty
// barriers.

// set up the barrier at `bar` for `count` arrivals a phase (one thread),
// then make it visible to the copy engine before any copy names it
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival on `bar` that also expects `bytes` more transaction bytes
// in the current phase (tx-count < 2^20 a phase)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) global ->
// shared by the bulk copy, counted on `bar` as they land
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// one plain arrival on `bar` (release at CTA scope: this thread's earlier
// reads of the slot are done before the producer may refill it)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// The tensor form of the bulk copy (the TMA proper): one box of the tensor
// map at `map` (a __grid_constant__ kernel parameter), its corner at the
// given coordinates (innermost first), lands at `dst` in the map's swizzle
// and counts its whole box on `bar`, elements outside the tensor as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// Programmatic dependent launch (PTX griddepcontrol): a kernel launched
// with the programmatic stream serialization attribute may start while the
// kernel ahead of it in the stream still runs, once every block of that
// kernel has called launch_dependents (or ended); grid_dependency_wait
// then blocks the calling thread until that kernel has ended and its
// memory operations are visible. Without the attribute both are no-ops.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8, and register i receives matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the same, each matrix transposed on its way into the registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8 s32] += a[16x32 s8] * b[32x8 s8]: exact integer sums
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[16x8 s32] += a[16x16 s8] * b[16x8 s8]: the k16 shape, A in two
// registers (a0: row g, a1: row g + 8, word tig), B in one (word tig)
__device__ __forceinline__ void mma_s8_k16(int* d, uint32_t a0, uint32_t a1,
                                           uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d[16x8 f32] += a[16x16 bf16] * b[16x8 bf16]
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Raise a kernel's dynamic shared-memory limit once per size it grows to
// on each device (the attribute belongs to the current device, and the
// data-parallel replicas of one process run on several), so a launch
// recorded into a CUDA graph (after an eager run of the same shapes on
// that device) makes no attribute call.
constexpr int kMaxDevices = 64;

template <auto Kern>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed[dev] = bytes;
  return err;
}

}  // namespace ppl_ptx
