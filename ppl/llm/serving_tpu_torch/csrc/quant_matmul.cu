// Dynamic per-token int8 activation x int8 (K3) or group-int4 (K4) weight
// matmuls.
//
// K3 replaces the TPU Pallas kernel
//   ppl/llm/serving_tpu/ops/pallas/quant_matmul.py:i8i8_matmul_pallas
//   (body _kernel)
// with the arithmetic of ops/quant.py (the XLA version the JAX package's
// CPU path runs): per-token absmax scale = absmax / 127 (a division, not
// the Pallas body's absmax * (1/127)), q = clip(rint(x * inv), -127, 127)
// with round-half-to-even, int8 x int8 -> int32, then out = float(acc) *
// (x_scale[t] * w_scale[n]) written in the output dtype. With these the
// quantized activations and the int32 sums equal the plain version's
// exactly.
//
// Contracts: plain x [T, D] x w [D, N] -> [T, N]; fused (gate|up)
// w [C, D, N], scale [C, N] -> [C, T, N] with gridDim.z = C. The wrapper
// guarantees D % 4 == 0 and N % 4 == 0 and nothing more.
//
// What bounds it on an H100: up to the served 64-row decode bucket bytes
// -- the int8 weight is read once, D*N bytes per call, against 2*T*D*N
// operations: at T = 64 about 128 operations a weight byte, a third of
// the ridge of the mma.sync ceiling (1,290 TOP/s) over 3.35 TB/s -- so the
// tile's job is to keep the weight streaming at the card's bandwidth into
// every SM; at prefill sizes (T ~ 1024 and up) operations, against the
// 1,979 TOP/s of the int8 tensor cores.
//
// Design (the quantize pass, then one of two GEMM tiles on the int8
// tensor cores, mma.sync.m16n8k32.s8 with exact s32 sums), routed by T
// alone (the wrapper's k3_tile):
// - Quantize: one block per row (absmax reduction, int8 row, f32 scale).
//   The int8 rows get a stride rounded up to 128 bytes, zero past D, so
//   every activation tile is whole and 16-byte aligned. For the decode
//   tile each 16-byte group is written in that tile's k order (k16).
// - The weight stays [D, N] with N contiguous (the JAX contract), but an
//   int8 MMA wants both operands k-contiguous, so each tile turns the
//   weight k-major on its way from shared memory to registers.
// - Decode (T <= 64, N % 16 == 0): the weight is the MMA's A (m16) side
//   and the tokens its n8 side (up to eight n8 tiles: T rounded up to 8
//   only). A CTA takes 256 weight columns and a piece of K:
//   * One producer warp keeps a 4-slot ring of 20 kB stages loading with
//     the TMA (cp.async.bulk.tensor, an mbarrier a slot): two boxes of 64
//     rows x 128 columns of the weight (a 3-D tensor map over [C, D, N],
//     128-byte swizzle, rows past D read as zeros) and one of 64 bytes x
//     NT*8 tokens of the activations (64-byte swizzle, tokens past T
//     zeros). Four consumer warps, 64 columns each, free a slot once read.
//     So each CTA keeps 80 kB in flight, and no thread spends registers
//     or instructions on addresses.
//   * The A fragments come from transposed ldmatrix loads of 8 rows x 16
//     bytes: a lane gets the byte pairs (k 2*tig, 2*tig + 1) x (columns
//     2g, 2g + 1) of a matrix, and one byte_perm of two matrices 8 rows
//     apart gives the k-word (2*tig, 2*tig + 1, 8 + 2*tig, 9 + 2*tig) of
//     one column. The MMA adds over k in any order as long as A and B
//     agree, and the quantize pass stores each 16-byte group in that
//     order, so the B fragments are plain ldmatrix loads. Under the
//     swizzles each phase's 8 rows fall in 32 banks.
//   * The activations are not re-read once per 128 columns: the column
//     tile is 256 wide, so a stage's 4 kB activation box serves 16 kB of
//     weight (a quarter more traffic from L2, not a half). A wider tile,
//     or a CTA keeping its activation piece over several column tiles,
//     would leave wo and down (20 column tiles of 256 at 13B) fewer CTAs
//     than SMs under the cluster's 8 pieces.
//   * Split-K: the host planner (plan_split_k) cuts K into pieces of
//     whole 64-row stages, as even as stages allow: the fewest that give
//     every SM a CTA (at 13B wo and down 7, wqkv 3, gate|up 2), at most 8.
//     The pieces of a column tile are one thread block cluster (1,
//     pieces, 1): each writes its int32 sums [NT*8 tokens][256 columns]
//     into its own shared memory (the ring, by then free), the cluster
//     syncs, and each CTA adds a slice of the tile's (token, 4-column)
//     groups over every piece's shared memory (distributed shared memory)
//     and applies the epilogue. Integer sums are exact, so every run,
//     eager or replayed in a CUDA graph, gives the same bits; nothing is
//     zeroed per call and no workspace or counter outlives a launch.
//   * Programmatic dependent launch: the tile may start while the
//     quantize pass ahead of it runs; its first stages' weight boxes go
//     out at once, its activation boxes and token scales wait for the
//     pass to end (griddepcontrol.wait).
// - Prefill (T > 64, or N % 16 > 0): a 128 x 128 CTA tile on 8 warps (64
//   x 32 each), two CTAs an SM (128 registers a thread), 128 bytes of k
//   per stage, a 3-stage cp.async ring in 96 KB of dynamic shared memory.
//   Activations are the A operand, read by plain 4-byte shared loads
//   (chunks swizzled by row % 8: conflict-free; unlike volatile ldmatrix
//   the compiler can move them ahead of earlier MMAs), the weight the B
//   operand: a weight tile lands in shared memory N-major by 16-byte
//   cp.async; a thread reads the 4-byte words of rows k..k+3 at columns
//   4j..4j+3 and turns them k-major with a 4x4 __byte_perm transpose,
//   which yields the k-words of columns 4j, 4j+1, 4j+2, 4j+3 at once. So
//   the tile's columns are permuted: n8 fragment i holds the columns
//   4j + i (j = 0..7) of a 32-column span, one transpose feeds four
//   fragments, and the epilogue puts each sum back at 4j + i. The 16-byte
//   chunks of a row are XOR-swizzled by (k / 4) % 4 so the 32 lanes'
//   words fall in 32 banks. CTAs take the (M, N) tiles in groups of 8 M
//   tiles, M fastest, so the CTAs in flight share weight tiles through L2
//   (in N-fastest order each weight byte came from DRAM once per 128
//   tokens). Masked edges: rows past T and weight rows past D or columns
//   past N are copied as zeros; output columns go out four at a time
//   (N % 4 == 0).
// - The epilogue is float(acc) * (x_scale[t] * w_scale[n]) in exactly
//   that order, so the f32 output equals the plain version bit for bit.
//
// K4 replaces the TPU Pallas kernel
//   ppl/llm/serving_tpu/ops/pallas/quant_matmul.py:w4a8_matmul_pallas
//   (body _w4_kernel)
// with the arithmetic of ops/quant.py's w4a8_matmul: the same quantize
// pass for the activation, then int4 weights in [-7, 7] with one f32
// scale per (group of GROUP contraction rows, column). Packed byte i of a
// column holds row i in its low nibble and row i + D/2 in its high one,
// so packed rows [g*GROUP, (g+1)*GROUP) carry group g in their low
// nibbles and group g + G/2 in their high ones. Inside a group the int32
// sums are exact; each is scaled by its group's scale and added to an f32
// running sum (one fused multiply-add), the groups in the order of the
// stages (g, g + 1, ... of the low nibbles, then of the high ones, stage
// by stage) rather than the plain version's 0, 1, ..., so the two agree
// to f32 rounding, not bit for bit; the sum is multiplied by the token
// scale and written in out_dtype.
//
// What bounds it on an H100: at decode sizes bytes, D*N/2 weight bytes
// plus (D/GROUP)*N*4 of scales (an eighth more at group 64), half of
// K3's for the same work; at prefill sizes int8 tensor-core operations.
//
// Design (the quantize pass, then one of two tiles on the int8 tensor
// cores, mma.sync m16n8k32 s8, m16n8k16 at group 16, from K3's N-major
// weight staging and 4x4 transpose):
// - A stage holds KSP = max(GROUP, 64) packed rows (whole groups) of 128
//   columns, the activation bytes of both column ranges they meet
//   (x[:, k0 + ...] and x[:, D/2 + k0 + ...], each 16-byte chunk whole,
//   masked past the piece's end) and the stage's group scales, all by
//   16-byte cp.async into one ring.
// - Unpack in registers after the transpose: a transposed packed k-word
//   gives the operand of group g as (w << 4) & 0xF0F0F0F0 and that of
//   group g + G/2 as w & 0xF0F0F0F0 -- int8 lanes holding exactly 16 * q,
//   two instructions at most. The int32 sum is then 16 * p (|16 p| < 2^21)
//   and the f32 running sum 16 times the true one, bit for bit (scaling
//   by 16 commutes with rounding); the end multiplies by 1/16 exactly.
// - Per group, on the CUDA cores: int32 -> f32 (exact, one I2FP), then
//   an FFMA with the scale; then the int32 sum restarts.
// - Prefill (T > 16): a 128 x 128 CTA tile on 16 warps of 32 x 32 (the
//   int32 group sum beside the f32 running sum: 64 accumulator registers
//   a thread), a 4-stage ring (3 at group 128), CTAs in M-fastest groups
//   sharing weight tiles through L2 as K3's prefill tile. Activations are
//   the A operand, the weight the B operand: once a stage has landed, the
//   CTA transposes and unpacks its packed tile once into k-major int8 rows
//   of both halves in shared memory, from which every warp reads its B
//   fragments with plain loads (four warps share each column span).
// - Decode (T <= 16): byte-bound, so the weight is the A (m16) side and
//   the tokens one or two n8 tiles; 4 warps of 32 columns, a 4-stage
//   ring. Split-K: the host planner cuts the packed rows into pieces of
//   whole stages so that every weight gives at least two CTAs per SM.
//   Group scales make the partial sums f32, so each piece writes its
//   partial to a workspace [S, C, T, N] and the last CTA of a column tile
//   to arrive (a counter) adds the S partials in piece order -- the same
//   bits on every run and in a CUDA graph replay -- and puts its counter
//   back to zero, so the counters need no memset per call.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ppl_ptx;
namespace cg = cooperative_groups;

constexpr int kQuantThreads = 512;

// four consecutive elements of a row (D % 4 == 0): 16 bytes of f32, 8 of bf16
template <typename T> struct Quad;
template <> struct Quad<float> {
  using V = float4;
  __device__ __forceinline__ static void get(const V& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Quad<__nv_bfloat16> {
  using V = uint2;
  __device__ __forceinline__ static void get(const V& v, float* o) {
    o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xffff0000u);
    o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// The byte of a 16-byte group that holds value k (0..15) of the group in
// the decode tile's order: word w (its B fragment word tig = w)
// holds values 2w, 2w + 1, 8 + 2w, 9 + 2w, the k order of the A words
// that tile's transposed ldmatrix loads give
__host__ __device__ constexpr int dc_k16_offset(int k) {
  return k < 8 ? 4 * (k >> 1) + (k & 1) : 4 * ((k - 8) >> 1) + 2 + (k & 1);
}

// quad i of a row (values 4i..4i+3) into the k16 order: two 16-bit halves
__device__ __forceinline__ void store_k16(int8_t* row, int i, uint32_t w) {
  const int k = 4 * (i & 3);
  int8_t* grp = row + 16 * (i >> 2);
  *reinterpret_cast<uint16_t*>(grp + dc_k16_offset(k)) = (uint16_t)(w & 0xffffu);
  *reinterpret_cast<uint16_t*>(grp + dc_k16_offset(k + 2)) = (uint16_t)(w >> 16);
}

// One block per row: absmax, scale = absmax / 127 (a division), then
// q = clip(rint(x * (1 / scale)), -127, 127), four elements a load. With
// `k16`, each 16-byte group of a row holds its 16 values in the order the
// decode tile's MMA fragments read them (see dc_k16_offset).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    int D, int ld, int k16) {
  using V = typename Quad<T>::V;
  __shared__ float red[kQuantThreads / 32];
  // K3's decode tile, launched behind this pass, may start streaming
  // its weight now: it waits for these rows before it reads them
  launch_dependents();
  const int t = blockIdx.x;
  const V* row = reinterpret_cast<const V*>(x + (size_t)t * D);
  const int nq = D / 4;
  float amax = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    float v[4];
    Quad<T>::get(row[i], v);
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) amax = fmaxf(amax, red[i]);
  const float scale = amax / 127.0f;
  const float inv = scale > 0.f ? 1.0f / fmaxf(scale, 1e-10f) : 0.f;
  uint32_t* qrow = reinterpret_cast<uint32_t*>(xq + (size_t)t * ld);
#pragma unroll 4
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    float v[4];
    Quad<T>::get(row[i], v);
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float q = fminf(fmaxf(rintf(v[j] * inv), -127.f), 127.f);
      w |= ((uint32_t)(int)q & 0xffu) << (8 * j);
    }
    if (k16)
      store_k16(xq + (size_t)t * ld, i, w);
    else
      qrow[i] = w;
  }
  for (int i = nq + threadIdx.x; i < ld / 4; i += blockDim.x) {
    if (k16)
      store_k16(xq + (size_t)t * ld, i, 0u);
    else
      qrow[i] = 0;
  }
  if (threadIdx.x == 0) xs[t] = scale;
}

// 4x4 int8 block transpose: w0..w3 are rows k..k+3 (4 columns each);
// returns in c[i] the 4 k-bytes of column i.
__device__ __forceinline__ void transpose4x4(int w0, int w1, int w2, int w3, int* c) {
  const int t0 = __byte_perm(w0, w1, 0x5140);
  const int t1 = __byte_perm(w2, w3, 0x5140);
  const int t2 = __byte_perm(w0, w1, 0x7362);
  const int t3 = __byte_perm(w2, w3, 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// ---------------------------------------------------------------- K3 tiles

constexpr int kTileN = 128;      // weight columns per box or CTA
// K3's tiles, as ppl_i8i8_gemm's `tile` names them
constexpr int kTilePrefill = 0, kTileDecode = 1;

// Byte offset of 16-byte chunk `chunk` of row `kr` in a weight tile
// (rows x kTileN bytes, N-major): the chunks of a row are XOR-
// swizzled by (kr / 4) % 4 so that load_kwords' 32 lanes (rows 4*tig + r,
// eight consecutive words) fall in 32 different banks.
__device__ __forceinline__ int wtile_offset(int kr, int chunk) {
  return kr * kTileN + ((chunk ^ (((kr >> 2) & 3) << 1)) << 4);
}

// Copy weight rows [k0, k0 + KS) x columns [n0, n0 + kTileN) of
// wc [D, N] into a stage tile; rows at or past k_end and columns at or
// past N land as zeros. VEC: bytes per copy, 16 when N % 16 == 0, else 4.
template <int VEC, int NTHREADS, int KS>
__device__ __forceinline__ void load_wtile(int8_t* tile, const int8_t* wc,
                                           int k0, int k_end, int n0, int N,
                                           int tid) {
  if constexpr (VEC == 16) {
    for (int e = tid; e < KS * (kTileN / 16); e += NTHREADS) {
      const int kr = e / (kTileN / 16), ch = e % (kTileN / 16);
      const int k = k0 + kr, n = n0 + ch * 16;
      const bool ok = k < k_end && n < N;
      cp_async16(smem_u32(tile + wtile_offset(kr, ch)),
                 ok ? wc + (size_t)k * N + n : wc, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < KS * (kTileN / 4); e += NTHREADS) {
      const int kr = e / (kTileN / 4), wd = e % (kTileN / 4);
      const int k = k0 + kr, n = n0 + wd * 4;
      const bool ok = k < k_end && n < N;
      cp_async4(smem_u32(tile + wtile_offset(kr, wd >> 2) + (wd & 3) * 4),
                ok ? wc + (size_t)k * N + n : wc, ok ? 4 : 0);
    }
  }
}

// The k-words of the four permuted fragments of a 32-column span: rows
// kb + 4*tig .. +3 of columns span*32 + 4*g .. +3, read as four words and
// transposed; out[i] holds the 4 k-bytes of column span*32 + 4*g + i.
// kb is a multiple of 16.
__device__ __forceinline__ void load_kwords(const int8_t* tile, int kb,
                                            int span, int g, int tig,
                                            uint32_t* out) {
  int w[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    w[r] = *reinterpret_cast<const int*>(
        tile + wtile_offset(kb + 4 * tig + r, 2 * span + (g >> 2)) + (g & 3) * 4);
  int col[4];
  transpose4x4(w[0], w[1], w[2], w[3], col);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (uint32_t)col[i];
}

// out = float(acc) * (x_scale * w_scale), rounded step by step as the
// plain version computes it
__device__ __forceinline__ float scale_sum(int acc, float sx, float sw) {
  return __fmul_rn(__int2float_rn(acc), __fmul_rn(sx, sw));
}

// four consecutive outputs (16 bytes of f32, 8 of bf16; N % 4 == 0 keeps
// them aligned)
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// --- prefill tile: 128 tokens x 128 columns, 8 warps of 64 x 32

constexpr int kPfThreads = 256;
constexpr int kPfBM = 128;                  // token rows per CTA
constexpr int kPfBK = 128;                  // contraction bytes per stage
constexpr int kPfStages = 3;
constexpr int kPfATile = kPfBM * kPfBK;     // bytes
constexpr int kPfWTile = kPfBK * kTileN;
constexpr int kPfSmem = kPfStages * (kPfATile + kPfWTile);  // 96 KB
// CTAs walk the (M, N) tiles in groups of kGroupM M tiles, M fastest, so
// the CTAs in flight share their weight tiles through L2 instead of each
// streaming its own from DRAM once per M tile
constexpr int kGroupM = 8;

// activation tile (kPfBM rows x kPfBK bytes, k-contiguous): chunks XOR-
// swizzled by row % 8, so a warp's fragment words (rows g, words tig of
// one chunk) fall in 32 different banks
__device__ __forceinline__ int atile_offset(int row, int chunk) {
  return row * kPfBK + ((chunk ^ (row & 7)) << 4);
}

template <int VEC, typename TO>
__global__ void __launch_bounds__(kPfThreads, 2) i8i8_prefill_kernel(
    const int8_t* __restrict__ xq, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D, int N) {
  extern __shared__ __align__(16) int8_t smem[];
  const int c = blockIdx.y;
  const int m_tiles = (T + kPfBM - 1) / kPfBM;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int group = kGroupM * n_tiles;                  // CTAs per group
  const int first_m = (int)blockIdx.x / group * kGroupM;
  const int group_m = min(m_tiles - first_m, kGroupM);
  const int in_group = (int)blockIdx.x % group;
  const int m0 = (first_m + in_group % group_m) * kPfBM;
  const int n0 = in_group / group_m * kTileN;
  const int8_t* wc = w + (size_t)c * D * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 64-row half, 32-column span
  const int g = lane >> 2, tig = lane & 3;
  const int ktiles = (D + kPfBK - 1) / kPfBK;

  auto load_stage = [&](int kt) {
    int8_t* a_t = smem + (kt % kPfStages) * (kPfATile + kPfWTile);
    const int k0 = kt * kPfBK;
    for (int e = tid; e < kPfBM * (kPfBK / 16); e += kPfThreads) {
      const int row = e / (kPfBK / 16), ch = e % (kPfBK / 16);
      const int t = m0 + row;
      cp_async16(smem_u32(a_t + atile_offset(row, ch)),
                 xq + (size_t)(t < T ? t : 0) * ldx + k0 + ch * 16,
                 t < T ? 16 : 0);
    }
    load_wtile<VEC, kPfThreads, kPfBK>(a_t + kPfATile, wc, k0, D, n0, N, tid);
  };

  int acc[4][4][4];  // [m16 tile][permuted n8 fragment][c0..c3]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][i][r] = 0;

#pragma unroll
  for (int s = 0; s < kPfStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kPfStages - 2>();
    __syncthreads();
    if (kt + kPfStages - 1 < ktiles) load_stage(kt + kPfStages - 1);
    cp_async_commit();
    const int8_t* a_t = smem + (kt % kPfStages) * (kPfATile + kPfWTile);
    const int8_t* w_t = a_t + kPfATile;
#pragma unroll
    for (int ks = 0; ks < kPfBK / 32; ++ks) {
      // A fragments by plain shared loads (the compiler may move them
      // ahead of earlier MMAs, unlike volatile ldmatrix): rows g and g + 8
      // of each m16 tile, words tig (k 0-15) and tig + 4 (k 16-31)
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = wm * 64 + mt * 16 + g + 8 * (q & 1);
          a[mt][q] = *reinterpret_cast<const uint32_t*>(
              a_t + atile_offset(row, 2 * ks + (q >> 1)) + 4 * tig);
        }
      uint32_t b0[4], b1[4];
      load_kwords(w_t, 32 * ks, wn, g, tig, b0);
      load_kwords(w_t, 32 * ks + 16, wn, g, tig, b1);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_s8(acc[mt][i], a[mt], b0[i], b1[i]);
    }
  }
  cp_async_wait<0>();

  // fragment i's column j is column 4j + i of the span: thread (g, tig)
  // holds columns 8*tig + 0..3 (c0/c2 of fragments 0..3) and 8*tig + 4..7
  // (c1/c3) of rows g and g + 8
  const float* wsc = ws + (size_t)c * N;
  TO* oc = out + (size_t)c * T * N;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m0 + wm * 64 + mt * 16 + half * 8 + g;
      if (t >= T) continue;
      const float sx = xs[t];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + wn * 32 + 8 * tig + 4 * q;
        if (n >= N) continue;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = scale_sum(acc[mt][i][2 * half + q], sx, wsc[n + i]);
        store4(oc + (size_t)t * N + n, v);
      }
    }
}

// --- decode tile: 256 weight columns x NT*8 tokens, a TMA ring
//     fed by one producer warp, split-K over a thread block cluster

constexpr int kDcCols = 2 * kTileN;        // weight columns per CTA
constexpr int kDcConsumers = 4;            // consumer warps, 64 columns each
constexpr int kDcThreads = 32 * (kDcConsumers + 1);
constexpr int kDcBK = 64;                  // contraction rows per stage
constexpr int kDcStages = 4;               // depth of the ring
constexpr int kDcBox = kDcBK * kTileN;     // one 128-column weight box, 8 KB
constexpr int kDcMaxPieces = 8;            // the portable cluster size
constexpr int kDcPitch = kDcCols * 4 + 16; // a token's partial sums, bytes
constexpr int kDcMaxT = 64;

template <int NT> __host__ __device__ constexpr int dc_xbox() {
  return NT * 8 * kDcBK;                   // a stage's activation box
}
template <int NT> __host__ __device__ constexpr int dc_stage() {
  return (2 * kDcBox + dc_xbox<NT>() + 1023) / 1024 * 1024;
}
template <int NT> __host__ __device__ constexpr int dc_smem() {
  return kDcStages * dc_stage<NT>() + 1024;   // + the 1 KB alignment
}

// w_map: the weight [C, D, N] int8 as a 3-D tensor map, boxes of 128
// columns x kDcBK rows in the 128-byte swizzle; x_map: the int8
// activations [T, ldx] as a 2-D one, boxes of kDcBK bytes x NT*8 tokens in
// the 64-byte swizzle. Launched as clusters of (1, gridDim.y, 1): the
// gridDim.y pieces of K (kchunk rows each, whole stages) of one column
// tile add their int32 sums in distributed shared memory.
template <typename TO, int NT>
__global__ void __launch_bounds__(kDcThreads, 2) i8i8_decode_kernel(
    const __grid_constant__ CUtensorMap w_map,
    const __grid_constant__ CUtensorMap x_map, const float* __restrict__ xs,
    const float* __restrict__ ws, TO* __restrict__ out, int T, int D, int N,
    int kchunk) {
  extern __shared__ __align__(16) int8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kDcStages], empty[kDcStages];
  constexpr int kStage = dc_stage<NT>();
  static_assert(NT * 8 * kDcPitch <= kDcStages * kStage,
                "the partial sums reuse the ring");
  // the 128-byte swizzle repeats every 1024 bytes: boxes start on 1 KB
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  int8_t* smem = smem_raw + (base - raw);
  const int c = blockIdx.z, n0 = blockIdx.x * kDcCols;
  const int kb = blockIdx.y * kchunk, ke = min(D, kb + kchunk);
  const int ktiles = (ke - kb + kDcBK - 1) / kDcBK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kDcStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 32 * kDcConsumers);
    }
  }
  __syncthreads();

  if (warp == kDcConsumers) {
    // the producer: one lane keeps every free slot of the ring loading.
    // The first slots' weight boxes go out before the quantize pass ahead
    // of this kernel has ended (programmatic dependent launch); their
    // activation boxes once it has.
    if (lane == 0) {
      const int first = min(ktiles, kDcStages);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kDcStages;
        if (kt >= kDcStages)
          mbar_wait(smem_u32(&empty[s]), ((kt / kDcStages) & 1) ^ 1);
        const uint32_t st = base + s * kStage, bar = smem_u32(&full[s]);
        const int k0 = kb + kt * kDcBK;
        mbar_expect_tx(bar, 2 * kDcBox + dc_xbox<NT>());
        tma_load_3d(st, &w_map, n0, k0, c, bar);
        tma_load_3d(st + kDcBox, &w_map, n0 + kTileN, k0, c, bar);
        if (kt + 1 == first) {
          grid_dependency_wait();
          for (int f = 0; f < first; ++f)
            tma_load_2d(base + f * kStage + 2 * kDcBox, &x_map,
                        kb + f * kDcBK, 0, smem_u32(&full[f]));
        } else if (kt >= first) {
          tma_load_2d(st + 2 * kDcBox, &x_map, k0, 0, bar);
        }
      }
    }
    __syncwarp();
  } else {
    // a consumer warp: columns [64*warp, 64*warp + 64) of the tile, the
    // 16-byte chunks 4*(warp % 2) + 0..3 of 128-column box warp / 2, and
    // every token. The weight's A fragments come from transposed
    // ldmatrix loads of 8 rows x 16 bytes (b16 elements: byte pairs of one
    // row): a lane gets bytes (k = 2*tig, 2*tig + 1) x (columns 2g, 2g + 1)
    // of a matrix, so two matrices 8 rows apart and one byte_perm give the
    // k-word (2*tig, 2*tig + 1, 8 + 2*tig, 9 + 2*tig) of column 2g or
    // 2g + 1; the activations are stored in that k order (k16, the
    // quantize pass), so the B fragments are plain ldmatrix loads. Under
    // the boxes' swizzles (16-byte chunk ^ row % 8 in the weight's, ^
    // (row / 2) % 4 in the activations') each phase's 8 rows fall in 32
    // banks.
    const int g = lane >> 2, tig = lane & 3, r = lane & 7, mi = lane >> 3;
    // A: matrix mi of a load: rows 8 * (mi % 2) + r of a k16 block, chunk
    // 4 * (warp % 2) + 2 * pair + mi / 2 of the box
    uint32_t aoff[2];
#pragma unroll
    for (int pair = 0; pair < 2; ++pair) {
      const int chunk = 4 * (warp & 1) + 2 * pair + (mi >> 1);
      aoff[pair] = (warp >> 1) * kDcBox + (8 * (mi & 1) + r) * kTileN +
                   ((chunk ^ r) << 4);
    }
    // B: matrix mi: token 8 * (j + mi / 2) + r, chunk 2 * ks + mi % 2 (of
    // four 16-byte chunks a 64-byte row); (token / 2) % 4 == r / 2 % 4;
    // xone: the same with tile j alone (an odd last tile)
    uint32_t xoff[2], xone[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int chunk = 2 * ks + (mi & 1);
      xone[ks] = 2 * kDcBox + r * kDcBK + ((chunk ^ ((r >> 1) & 3)) << 4);
      xoff[ks] = xone[ks] + (mi >> 1) * 8 * kDcBK;
    }

    int acc[4][NT][4];  // [fragment 2*pair + p][n8 token tile][c0..c3]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kDcStages;
      mbar_wait(smem_u32(&full[s]), (kt / kDcStages) & 1);
      const uint32_t st = base + s * kStage;
#pragma unroll
      for (int ks = 0; ks < kDcBK / 32; ++ks) {
        // fragment 2*pair + p: m-row g is column 16*c + 2g + p of chunk
        // c = 4*(warp % 2) + 2*pair (rows 0..7) and of chunk c + 1 (rows
        // 8..15); a0/a1 the k16 block 2*ks, a2/a3 block 2*ks + 1
        uint32_t a[4][4];
#pragma unroll
        for (int blk = 0; blk < 2; ++blk)
#pragma unroll
          for (int pair = 0; pair < 2; ++pair) {
            uint32_t m[4];   // (rows 0-7, chunk c), (8-15, c), (0-7, c+1), (8-15, c+1)
            ldmatrix_x4_trans(m, st + (32 * ks + 16 * blk) * kTileN + aoff[pair]);
            a[2 * pair][2 * blk] = __byte_perm(m[0], m[1], 0x6420);
            a[2 * pair + 1][2 * blk] = __byte_perm(m[0], m[1], 0x7531);
            a[2 * pair][2 * blk + 1] = __byte_perm(m[2], m[3], 0x6420);
            a[2 * pair + 1][2 * blk + 1] = __byte_perm(m[2], m[3], 0x7531);
          }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];   // b0, b1 of tile j, then of tile j + 1
          ldmatrix_x4(b, st + j * 8 * kDcBK + (j + 1 < NT ? xoff[ks] : xone[ks]));
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b[0], b[1]);
          if (j + 1 < NT) {
#pragma unroll
            for (int i = 0; i < 4; ++i) mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
          }
        }
      }
      mbar_arrive(smem_u32(&empty[s]));
    }

    // every consumer is done with the ring: it now holds this piece's
    // int32 sums [NT*8 tokens][256 columns] (rows padded by 16 bytes, so
    // a half-warp's 8-byte stores fall in 32 banks). Thread (g, tig)
    // holds, for tokens 8j + 2*tig + q, columns 2g and 2g + 1 (fragments
    // 2*pair and 2*pair + 1) of chunks 4*(warp % 2) + 2*pair + h of its box.
    asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kDcConsumers) : "memory");
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int pair = 0; pair < 2; ++pair)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int t = 8 * j + 2 * tig + q;
            const int col = 64 * warp + 32 * pair + 16 * h + 2 * g;
            *reinterpret_cast<int2*>(smem + t * kDcPitch + 4 * col) =
                make_int2(acc[2 * pair][j][2 * h + q],
                          acc[2 * pair + 1][j][2 * h + q]);
          }
  }

  // the cluster's pieces add their sums: CTA `rank` takes a slice of the
  // tile's (token, 4-column) groups and reads them from every piece in
  // piece order (integer sums: any order gives the same bits), then
  // applies the epilogue
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  grid_dependency_wait();   // the token scales, written by the quantize pass
  const int pieces = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  constexpr int kQuads = kDcCols / 4;
  constexpr int kGroups = NT * 8 * kQuads;
  const int per = (kGroups + pieces - 1) / pieces;
  const int lo = rank * per, hi = min(kGroups, lo + per);
  const float* wsc = ws + (size_t)c * N;
  TO* oc = out + (size_t)c * T * N;
  // two groups a thread a round, all their loads issued before any sum
  for (int e0 = lo + tid; e0 < hi; e0 += 2 * kDcThreads) {
    int4 v[2][kDcMaxPieces];
    float4 sw[2];
    float sx[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = min(e0 + u * kDcThreads, hi - 1);
      const int t = e / kQuads, q = e % kQuads;
      int8_t* at = smem + t * kDcPitch + 16 * q;
#pragma unroll
      for (int s = 0; s < kDcMaxPieces; ++s)
        if (s < pieces)
          v[u][s] = *reinterpret_cast<const int4*>(
              cluster.map_shared_rank(at, (unsigned)s));
      const int n = min(n0 + 4 * q, N - 4);
      sw[u] = *reinterpret_cast<const float4*>(wsc + n);
      sx[u] = xs[min(t, T - 1)];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * kDcThreads;
      const int t = e / kQuads, n = n0 + 4 * (e % kQuads);
      if (e >= hi || t >= T || n >= N) continue;
      int4 sum = v[u][0];
#pragma unroll
      for (int s = 1; s < kDcMaxPieces; ++s)
        if (s < pieces) {
          sum.x += v[u][s].x; sum.y += v[u][s].y;
          sum.z += v[u][s].z; sum.w += v[u][s].w;
        }
      const float o[4] = {scale_sum(sum.x, sx[u], sw[u].x),
                          scale_sum(sum.y, sx[u], sw[u].y),
                          scale_sum(sum.z, sx[u], sw[u].z),
                          scale_sum(sum.w, sx[u], sw[u].w)};
      store4(oc + (size_t)t * N + n, o);
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query (so the library links no libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// An int8 tensor of `rank` dims (innermost first), each stride a multiple
// of 16 bytes, read in boxes of `box` with the given swizzle
bool encode_int8_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank,
                const_cast<void*>(base), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO, int NT>
int launch_decode_tile(const int8_t* xq, int ldx, const float* xs,
                       const int8_t* w, const float* ws, void* out, int T,
                       int D, int N, int C, int splits, int kchunk,
                       cudaStream_t s) {
  constexpr int smem = dc_smem<NT>();
  const cudaError_t err = allow_smem<i8i8_decode_kernel<TO, NT>>(smem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap w_map, x_map;
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)D, (cuuint64_t)C};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N, (cuuint64_t)D * N};
  const cuuint32_t w_box[3] = {kTileN, kDcBK, 1};
  const cuuint64_t x_dims[2] = {(cuuint64_t)ldx, (cuuint64_t)T};
  const cuuint64_t x_strides[1] = {(cuuint64_t)ldx};
  const cuuint32_t x_box[2] = {kDcBK, NT * 8};
  if (!encode_int8_map(&w_map, w, 3, w_dims, w_strides, w_box,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_int8_map(&x_map, xq, 2, x_dims, x_strides, x_box,
                       CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kDcCols - 1) / kDcCols, splits, C);
  cfg.blockDim = dim3(kDcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, i8i8_decode_kernel<TO, NT>, w_map, x_map, xs, ws, (TO*)out, T, D,
      N, kchunk);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

template <int VEC, typename TO>
int launch_prefill_tile(const int8_t* xq, int ldx, const float* xs,
                        const int8_t* w, const float* ws, void* out, int T,
                        int D, int N, int C, cudaStream_t s) {
  const cudaError_t err = allow_smem<i8i8_prefill_kernel<VEC, TO>>(kPfSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((T + kPfBM - 1) / kPfBM) *
                          ((N + kTileN - 1) / kTileN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, C);
  i8i8_prefill_kernel<VEC, TO><<<grid, kPfThreads, kPfSmem, s>>>(
      xq, ldx, xs, w, ws, (TO*)out, T, D, N);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_i8i8(int tile, const int8_t* xq, int ldx, const float* xs,
                const int8_t* w, const float* ws, void* out, int T, int D,
                int N, int C, int splits, int kchunk, cudaStream_t s) {
  if (tile == kTilePrefill) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return N % 16 == 0
               ? launch_prefill_tile<16, TO>(xq, ldx, xs, w, ws, out, T, D, N, C, s)
               : launch_prefill_tile<4, TO>(xq, ldx, xs, w, ws, out, T, D, N, C, s);
  }
  // the decode tile: whole 16-byte weight rows for the tensor map, at most
  // kDcMaxT tokens, and pieces [i*kchunk, min(D, (i+1)*kchunk)) of whole
  // stages that cover K, none empty, one cluster
  if (tile != kTileDecode || T > kDcMaxT || N % 16 || C > 65535 ||
      splits < 1 || splits > kDcMaxPieces || kchunk <= 0 || kchunk % kDcBK ||
      (long long)(splits - 1) * kchunk >= D || (long long)splits * kchunk < D)
    return (int)cudaErrorInvalidValue;
#define PPL_DECODE_TILE(NTV)                                                 \
  case NTV:                                                                   \
    return launch_decode_tile<TO, NTV>(xq, ldx, xs, w, ws, out, T, D, N, C,   \
                                       splits, kchunk, s)
  switch ((T + 7) / 8) {
    PPL_DECODE_TILE(1); PPL_DECODE_TILE(2); PPL_DECODE_TILE(3);
    PPL_DECODE_TILE(4); PPL_DECODE_TILE(5); PPL_DECODE_TILE(6);
    PPL_DECODE_TILE(7); PPL_DECODE_TILE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PPL_DECODE_TILE
}

// ---------------------------------------------------------------- K4 tiles

constexpr int kW4Stage = 64;  // packed rows a stage at groups up to 64
constexpr int kW4DecodeMaxT = 16;  // the largest T of K4's decode tile

// K4's per-group constants: a stage holds KSP packed rows (whole groups,
// at least 64), so GPS groups of each nibble half
template <int GROUP> struct W4 {
  static constexpr int KSP = GROUP > kW4Stage ? GROUP : kW4Stage;
  static constexpr int GPS = KSP / GROUP;
  static constexpr int HC = KSP / 16;          // 16-byte chunks a half row
  static constexpr int WT = KSP * kTileN;      // packed weight tile, bytes
  static constexpr int ST = 2 * GPS * kTileN * 4;  // scales [2][GPS][128] f32
};

// The int8 operand of one nibble half of a packed k-word, times 16: the
// low nibbles (half 0) or the high ones (half 1) moved to the top of each
// byte, whose int8 value is then exactly 16 * q. The group's int32 sum is
// 16 * p, |16 p| <= 128 * 128 * 127 < 2^21.
__device__ __forceinline__ uint32_t nibbles_x16(uint32_t w, int half) {
  return (half ? w : w << 4) & 0xF0F0F0F0u;
}

// int32 -> f32, exact for |p| <= 2^24: one I2FP.F32.S32 on sm_90, an
// integer-pipe conversion (no multi-cycle I2F); cheaper in the hot loop
// than the integer add and float subtract of the 0x4B400000 trick
__device__ __forceinline__ float exact_float(int p) {
  return __int2float_rn(p);
}

// the x16 running sum times the token scale: (acc / 16) * sx, the
// division by 16 exact
__device__ __forceinline__ float w4_final(float acc, float sx) {
  return __fmul_rn(__fmul_rn(acc, 0.0625f), sx);
}

// Weight rows [k0, k0 + KS) x columns [n0, n0 + kTileN) as load_wtile,
// with the copy width chosen at run time (16 bytes when N % 16 == 0)
template <int NTHREADS, int KS>
__device__ __forceinline__ void load_wtile_any(int8_t* tile, const int8_t* wc,
                                               int k0, int k_end, int n0,
                                               int N, int tid) {
  if (N % 16 == 0)
    load_wtile<16, NTHREADS, KS>(tile, wc, k0, k_end, n0, N, tid);
  else
    load_wtile<4, NTHREADS, KS>(tile, wc, k0, k_end, n0, N, tid);
}

// A stage's group scales: rows g0 + i (low half) and GH + g0 + i (high
// half), i < GPS, columns [n0, n0 + kTileN), as [2][GPS][kTileN] f32;
// groups at or past g_end and columns past N land as zeros
template <int GPS, int NTHREADS>
__device__ __forceinline__ void load_scales(float* st, const float* wsc,
                                            int g0, int g_end, int GH,
                                            int n0, int N, int tid) {
  for (int e = tid; e < 2 * GPS * (kTileN / 4); e += NTHREADS) {
    const int r = e / (kTileN / 4), q = e % (kTileN / 4);
    const int gg = g0 + r % GPS, n = n0 + 4 * q;
    const bool ok = gg < g_end && n < N;
    cp_async16(smem_u32(st + r * kTileN + 4 * q),
               ok ? wsc + (size_t)((r / GPS) * GH + gg) * N + n : wsc,
               ok ? 16 : 0);
  }
}

// --- prefill tile: 128 tokens x 128 columns, 16 warps of 32 x 32

constexpr int kW4PfThreads = 512;

template <int GROUP> __host__ __device__ constexpr int w4_pf_stages() {
  return GROUP > kW4Stage ? 3 : 4;   // the ring's depth (227 KB in all)
}
template <int GROUP> __host__ __device__ constexpr int w4_pf_atile() {
  return kPfBM * 2 * W4<GROUP>::KSP;   // activation tile: low | high
}
template <int GROUP> __host__ __device__ constexpr int w4_pf_stage() {
  return w4_pf_atile<GROUP>() + W4<GROUP>::WT + W4<GROUP>::ST;
}
template <int GROUP> __host__ __device__ constexpr int w4_pf_smem() {
  // the ring, then the unpacked weight tile (kTileN rows of 2*KSP bytes)
  return w4_pf_stages<GROUP>() * w4_pf_stage<GROUP>() +
         kTileN * 2 * W4<GROUP>::KSP;
}

// activation tile row: the KSP bytes of x[t, k0 + ...] then those of
// x[t, D/2 + k0 + ...]; the unpacked weight tile's rows likewise (one
// column's 16 * q of both nibble halves, k-contiguous). Chunks XOR-
// swizzled by row % 8: conflict-free fragment loads, as atile_offset.
template <int KSP>
__device__ __forceinline__ int w4_atile_offset(int row, int chunk) {
  return row * 2 * KSP + ((chunk ^ (row & 7)) << 4);
}

// Unpack a stage's packed weight tile (N-major, as load_wtile lays it)
// into k-major int8 rows of both nibble halves, times 16, in ut: column
// span*32 + 4j + i lands in row span*32 + 8i + j, so a warp's fragment i
// reads rows 8i + g (g = lane / 4) of its span, conflict-free. Each
// thread transposes 4x4-byte blocks: lanes (r, j) = (lane / 8, lane % 8)
// of a warp read rows 4*rb + 0..3 of column quad span*8 + j (the
// swizzle puts the four rb in four bank groups) and write words rb % 4
// of 8 different rows (conflict-free).
template <int KSP, int NTHREADS>
__device__ __forceinline__ void w4_unpack_tile(int8_t* ut, const int8_t* wt,
                                               int tid) {
  constexpr int HC = KSP / 16;
  for (int e = tid; e < KSP * (kTileN / 4) / 4; e += NTHREADS) {
    const int lane = e & 31, wq = e >> 5;
    const int span = wq & 3, rb = (wq >> 2) * 4 + (lane >> 3), j = lane & 7;
    int w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      w[r] = *reinterpret_cast<const int*>(
          wt + wtile_offset(4 * rb + r, 2 * span + (j >> 2)) + (j & 3) * 4);
    int col[4];
    transpose4x4(w[0], w[1], w[2], w[3], col);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = span * 32 + 8 * i + j;
      *reinterpret_cast<uint32_t*>(
          ut + w4_atile_offset<KSP>(row, rb >> 2) + (rb & 3) * 4) =
          nibbles_x16((uint32_t)col[i], 0);
      *reinterpret_cast<uint32_t*>(
          ut + w4_atile_offset<KSP>(row, HC + (rb >> 2)) + (rb & 3) * 4) =
          nibbles_x16((uint32_t)col[i], 1);
    }
  }
}

template <int GROUP, typename TO>
__global__ void __launch_bounds__(kW4PfThreads, 1) w4a8_prefill_kernel(
    const int8_t* __restrict__ xq, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D2, int N) {
  using P = W4<GROUP>;
  constexpr int KSP = P::KSP, GPS = P::GPS, HC = P::HC;
  constexpr int kStages = w4_pf_stages<GROUP>();
  constexpr int kA = w4_pf_atile<GROUP>(), kStage = w4_pf_stage<GROUP>();
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* ut = smem + kStages * kStage;   // the unpacked weight tile
  const int c = blockIdx.y;
  const int m_tiles = (T + kPfBM - 1) / kPfBM;
  const int n_tiles = (N + kTileN - 1) / kTileN;
  const int group = kGroupM * n_tiles;
  const int first_m = (int)blockIdx.x / group * kGroupM;
  const int group_m = min(m_tiles - first_m, kGroupM);
  const int in_group = (int)blockIdx.x % group;
  const int m0 = (first_m + in_group % group_m) * kPfBM;
  const int n0 = in_group / group_m * kTileN;
  const int GH = D2 / GROUP;
  const int8_t* wc = w + (size_t)c * D2 * N;
  const float* wsc = ws + (size_t)c * 2 * GH * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 32-row slice, 32-column span
  const int g = lane >> 2, tig = lane & 3;
  const int ktiles = (D2 + KSP - 1) / KSP;

  auto load_stage = [&](int kt) {
    int8_t* a_t = smem + (kt % kStages) * kStage;
    const int k0 = kt * KSP;
    for (int e = tid; e < kPfBM * 2 * HC; e += kW4PfThreads) {
      const int row = e / (2 * HC), ch = e % (2 * HC);
      const int kc = k0 + (ch % HC) * 16, t = m0 + row;
      const bool ok = t < T && kc < D2;
      cp_async16(smem_u32(a_t + w4_atile_offset<KSP>(row, ch)),
                 ok ? xq + (size_t)t * ldx + (ch / HC) * D2 + kc : xq,
                 ok ? 16 : 0);
    }
    load_wtile_any<kW4PfThreads, KSP>(a_t + kA, wc, k0, D2, n0, N, tid);
    load_scales<GPS, kW4PfThreads>(
        reinterpret_cast<float*>(a_t + kA + P::WT), wsc, k0 / GROUP, GH, GH,
        n0, N, tid);
  };

  float f[2][4][4];  // x16 running sums [m16 tile][permuted n8 fragment][c]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) f[mt][i][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt landed; every warp is done with ut
    if (kt + kStages - 1 < ktiles) load_stage(kt + kStages - 1);
    cp_async_commit();
    const int8_t* a_t = smem + (kt % kStages) * kStage;
    const float* s_t = reinterpret_cast<const float*>(a_t + kA + P::WT);
    w4_unpack_tile<KSP, kW4PfThreads>(ut, a_t + kA, tid);
    __syncthreads();
    const int k0 = kt * KSP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int gi = 0; gi < GPS; ++gi) {
        if (k0 + gi * GROUP >= D2) break;
        int acc[2][4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][i][r] = 0;
#pragma unroll
        for (int q = 0; q < (GROUP + 31) / 32; ++q) {
          // k16 chunk(s) of this step: one at group 16, else two
          const int ch = h * HC + (gi * GROUP + 32 * q) / 16;
          uint32_t a[2][4], b[4][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < (GROUP == 16 ? 2 : 4); ++j) {
              const int row = wm * 32 + mt * 16 + g + 8 * (j & 1);
              a[mt][j] = *reinterpret_cast<const uint32_t*>(
                  a_t + w4_atile_offset<KSP>(row, ch + (j >> 1)) + 4 * tig);
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < (GROUP == 16 ? 1 : 2); ++j)
              b[i][j] = *reinterpret_cast<const uint32_t*>(
                  ut + w4_atile_offset<KSP>(wn * 32 + 8 * i + g, ch + j) +
                  4 * tig);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if constexpr (GROUP == 16)
                mma_s8_k16(acc[mt][i], a[mt][0], a[mt][1], b[i][0]);
              else
                mma_s8(acc[mt][i], a[mt], b[i][0], b[i][1]);
            }
        }
        // the group's scales of the thread's columns 8*tig + 0..7 of its span
        const float* sr = s_t + (h * GPS + gi) * kTileN + wn * 32 + 8 * tig;
        const float4 s0 = *reinterpret_cast<const float4*>(sr);
        const float4 s1 = *reinterpret_cast<const float4*>(sr + 4);
        const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              f[mt][i][r] = fmaf(exact_float(acc[mt][i][r]),
                                 sc[(r & 1) * 4 + i], f[mt][i][r]);
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, tig) holds columns 8*tig + 0..3 (c0/c2 of fragments 0..3)
  // and 8*tig + 4..7 (c1/c3) of rows g and g + 8, as K3's prefill tile
  TO* oc = out + (size_t)c * T * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m0 + wm * 32 + mt * 16 + half * 8 + g;
      if (t >= T) continue;
      const float sx = xs[t];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + wn * 32 + 8 * tig + 4 * q;
        if (n >= N) continue;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = w4_final(f[mt][i][2 * half + q], sx);
        store4(oc + (size_t)t * N + n, v);
      }
    }
}

// --- decode tile: 128 weight columns x NT*8 tokens, split-K in f32

constexpr int kW4DcThreads = 128;   // 4 warps of 32 columns
constexpr int kW4DcStages = 4;

template <int GROUP> __host__ __device__ constexpr int w4_dc_xstride() {
  return 2 * W4<GROUP>::KSP + 16;   // x row: low | high bytes + 16 of pad
}
template <int GROUP, int NT> __host__ __device__ constexpr int w4_dc_stage() {
  return W4<GROUP>::WT + NT * 8 * w4_dc_xstride<GROUP>() + W4<GROUP>::ST;
}

// part: f32 partial sums [S, C, T, N] and done: one arrival counter per
// (c, column tile), zero on entry and put back to zero by the last piece,
// when K is cut into gridDim.y > 1 pieces of kchunk packed rows; both null
// for one piece.
template <int GROUP, int NT, typename TO>
__global__ void __launch_bounds__(kW4DcThreads) w4a8_decode_kernel(
    const int8_t* __restrict__ xq, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D2, int N, int kchunk,
    float* __restrict__ part, int* __restrict__ done) {
  using P = W4<GROUP>;
  constexpr int KSP = P::KSP, GPS = P::GPS, HC = P::HC;
  constexpr int XS = w4_dc_xstride<GROUP>();
  constexpr int kStage = w4_dc_stage<GROUP, NT>();
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int last_piece;
  const int c = blockIdx.z, tile = blockIdx.x, C = gridDim.z;
  const int n0 = tile * kTileN;
  const int kb0 = blockIdx.y * kchunk, ke = min(D2, kb0 + kchunk);
  const int ktiles = (ke - kb0 + KSP - 1) / KSP;
  const int GH = D2 / GROUP;
  const int8_t* wc = w + (size_t)c * D2 * N;
  const float* wsc = ws + (size_t)c * 2 * GH * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  auto load_stage = [&](int kt) {
    int8_t* w_t = smem + (kt % kW4DcStages) * kStage;
    int8_t* x_t = w_t + P::WT;
    const int k0 = kb0 + kt * KSP;
    load_wtile_any<kW4DcThreads, KSP>(w_t, wc, k0, ke, n0, N, tid);
    for (int e = tid; e < NT * 8 * 2 * HC; e += kW4DcThreads) {
      const int t = e / (2 * HC), ch = e % (2 * HC);
      const int kc = k0 + (ch % HC) * 16;
      const bool ok = t < T && kc < ke;
      cp_async16(smem_u32(x_t + t * XS + ch * 16),
                 ok ? xq + (size_t)t * ldx + (ch / HC) * D2 + kc : xq,
                 ok ? 16 : 0);
    }
    load_scales<GPS, kW4DcThreads>(
        reinterpret_cast<float*>(x_t + NT * 8 * XS), wsc, k0 / GROUP,
        ke / GROUP, GH, n0, N, tid);
  };

  float f[2][NT][4];  // x16 running sums [m16 tile][n8 token tile][c]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) f[mt][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kW4DcStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kW4DcStages - 2>();
    __syncthreads();
    if (kt + kW4DcStages - 1 < ktiles) load_stage(kt + kW4DcStages - 1);
    cp_async_commit();
    const int8_t* w_t = smem + (kt % kW4DcStages) * kStage;
    const int8_t* x_t = w_t + P::WT;
    const float* s_t = reinterpret_cast<const float*>(x_t + NT * 8 * XS);
    const int k0 = kb0 + kt * KSP;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int gi = 0; gi < GPS; ++gi) {
        if (k0 + gi * GROUP >= ke) break;
        int acc[2][NT][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0;
        // A: m16 tile mt's row j (j < 8) is weight column 4j + 2*mt of
        // the warp's span, row 8 + j column 4j + 2*mt + 1
        if constexpr (GROUP == 16) {
          const int kb = gi * 16;
          uint32_t wv[4];
          load_kwords(w_t, kb, warp, g, tig, wv);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b = *reinterpret_cast<const uint32_t*>(
                x_t + (8 * j + g) * XS + h * KSP + kb + 4 * tig);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_s8_k16(acc[mt][j], nibbles_x16(wv[2 * mt], h),
                         nibbles_x16(wv[2 * mt + 1], h), b);
          }
        } else {
#pragma unroll
          for (int q = 0; q < GROUP / 32; ++q) {
            const int kb = gi * GROUP + 32 * q;
            uint32_t w0[4], w1[4], a[2][4];
            load_kwords(w_t, kb, warp, g, tig, w0);
            load_kwords(w_t, kb + 16, warp, g, tig, w1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              a[mt][0] = nibbles_x16(w0[2 * mt], h);
              a[mt][1] = nibbles_x16(w0[2 * mt + 1], h);
              a[mt][2] = nibbles_x16(w1[2 * mt], h);
              a[mt][3] = nibbles_x16(w1[2 * mt + 1], h);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              const int8_t* xr = x_t + (8 * j + g) * XS + h * KSP + kb + 4 * tig;
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][j], a[mt], b0, b1);
            }
          }
        }
        // the group's scales of the thread's columns 4g + 0..3 of its span
        const float4 s4 = *reinterpret_cast<const float4*>(
            s_t + (h * GPS + gi) * kTileN + 32 * warp + 4 * g);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              f[mt][j][r] = fmaf(exact_float(acc[mt][j][r]),
                                 sc[2 * mt + (r >> 1)], f[mt][j][r]);
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, tig) holds, for tokens 8j + 2*tig + p, columns 4g + 0..3:
  // column 4g + cc in f[cc / 2][j][2 * (cc % 2) + p]
  const int n = n0 + 32 * warp + 4 * g;
  TO* oc = out + (size_t)c * T * N;
  float* pc = part == nullptr ? nullptr
                              : part + ((size_t)blockIdx.y * C + c) * T * N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int t = 8 * j + 2 * tig + p;
      if (t >= T || n >= N) continue;
      float v[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) v[cc] = f[cc >> 1][j][2 * (cc & 1) + p];
      if (pc == nullptr) {
        const float sx = xs[t];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) v[cc] = w4_final(v[cc], sx);
        store4(oc + (size_t)t * N + n, v);
      } else {
        store4(pc + (size_t)t * N + n, v);
      }
    }
  if (pc == nullptr) return;

  // the last piece of this column tile to arrive adds the S partials in
  // piece order (the same bits whichever CTA arrives last), applies the
  // token scale and puts the counter back to zero for the next launch
  __threadfence();
  __syncthreads();
  int* counter = done + c * gridDim.x + tile;
  if (tid == 0) last_piece = atomicAdd(counter, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last_piece) return;
  __threadfence();
  const size_t piece = (size_t)C * T * N;
  const float* p0 = part + (size_t)c * T * N;
  for (int e = tid; e < T * (kTileN / 4); e += kW4DcThreads) {
    const int t = e / (kTileN / 4), nn = n0 + 4 * (e % (kTileN / 4));
    if (nn >= N) continue;
    const size_t at = (size_t)t * N + nn;
    float4 a = __ldcg(reinterpret_cast<const float4*>(p0 + at));
    for (int s = 1; s < (int)gridDim.y; ++s) {
      const float4 b = __ldcg(reinterpret_cast<const float4*>(p0 + s * piece + at));
      a.x = __fadd_rn(a.x, b.x); a.y = __fadd_rn(a.y, b.y);
      a.z = __fadd_rn(a.z, b.z); a.w = __fadd_rn(a.w, b.w);
    }
    const float sx = xs[t];
    const float v[4] = {w4_final(a.x, sx), w4_final(a.y, sx),
                        w4_final(a.z, sx), w4_final(a.w, sx)};
    store4(oc + at, v);
  }
  if (tid == 0) *counter = 0;
}

template <int GROUP, typename TO>
int launch_w4_prefill(const int8_t* xq, int ldx, const float* xs,
                      const int8_t* w, const float* ws, void* out, int T,
                      int D2, int N, int C, cudaStream_t s) {
  constexpr int smem = w4_pf_smem<GROUP>();
  const cudaError_t err = allow_smem<w4a8_prefill_kernel<GROUP, TO>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((T + kPfBM - 1) / kPfBM) *
                          ((N + kTileN - 1) / kTileN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, C);
  w4a8_prefill_kernel<GROUP, TO><<<grid, kW4PfThreads, smem, s>>>(
      xq, ldx, xs, w, ws, (TO*)out, T, D2, N);
  return (int)cudaGetLastError();
}

template <int GROUP, int NT, typename TO>
int launch_w4_decode(const int8_t* xq, int ldx, const float* xs,
                     const int8_t* w, const float* ws, void* out, int T,
                     int D2, int N, int C, int splits, int kchunk,
                     float* part, int* done, cudaStream_t s) {
  constexpr int smem = kW4DcStages * w4_dc_stage<GROUP, NT>();
  const cudaError_t err = allow_smem<w4a8_decode_kernel<GROUP, NT, TO>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kTileN - 1) / kTileN, splits, C);
  w4a8_decode_kernel<GROUP, NT, TO><<<grid, kW4DcThreads, smem, s>>>(
      xq, ldx, xs, w, ws, (TO*)out, T, D2, N, kchunk, part, done);
  return (int)cudaGetLastError();
}

template <int GROUP, typename TO>
int launch_w4a8(const int8_t* xq, int ldx, const float* xs, const int8_t* w,
                const float* ws, void* out, int T, int D2, int N, int C,
                int splits, int kchunk, float* part, int* done,
                cudaStream_t s) {
  if (T > kW4DecodeMaxT) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_w4_prefill<GROUP, TO>(xq, ldx, xs, w, ws, out, T, D2, N, C,
                                        s);
  }
  // the pieces [i*kchunk, min(D2, (i+1)*kchunk)) of whole stages must
  // cover the packed rows, none empty
  if (splits < 1 || kchunk <= 0 || kchunk % W4<GROUP>::KSP ||
      (long long)(splits - 1) * kchunk >= D2 ||
      (long long)splits * kchunk < D2 ||
      (splits > 1) != (part != nullptr) || (splits > 1) != (done != nullptr))
    return (int)cudaErrorInvalidValue;
  if (T <= 8)
    return launch_w4_decode<GROUP, 1, TO>(xq, ldx, xs, w, ws, out, T, D2, N,
                                          C, splits, kchunk, part, done, s);
  return launch_w4_decode<GROUP, 2, TO>(xq, ldx, xs, w, ws, out, T, D2, N, C,
                                        splits, kchunk, part, done, s);
}

template <typename TO>
int launch_w4a8_for(const int8_t* xq, int ldx, const float* xs,
                    const int8_t* w, const float* ws, void* out, int T,
                    int D2, int N, int C, int group, int splits, int kchunk,
                    float* part, int* done, cudaStream_t s) {
  if (D2 % group) return (int)cudaErrorInvalidValue;
#define PPL_W4(G)                                                           \
  launch_w4a8<G, TO>(xq, ldx, xs, w, ws, out, T, D2, N, C, splits, kchunk, \
                     part, done, s)
  switch (group) {
    case 16: return PPL_W4(16);
    case 32: return PPL_W4(32);
    case 64: return PPL_W4(64);
    case 128: return PPL_W4(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PPL_W4
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype codes: 0 = float32,
// 1 = bfloat16. Every function returns the cudaError_t of its launch.
extern "C" {

// x [T, D] -> int8 rows xq [T, ld] (zero in [D, ld)) and f32 scales xs
// [T]; D and ld multiples of 4, x 16-byte aligned, xq 4-byte aligned; k16
// != 0 puts each 16-byte group in the decode tile's order (ld a
// multiple of 16)
int ppl_i8i8_quantize_rows(int x_dtype, const void* x, int8_t* xq, float* xs,
                           int T, int D, int ld, int k16, void* stream) {
  if (T == 0) return 0;
  if (ld < D || D % 4 || ld % 4 || (k16 && ld % 16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    quantize_rows_kernel<float><<<T, kQuantThreads, 0, s>>>(
        (const float*)x, xq, xs, D, ld, k16);
  else
    quantize_rows_kernel<__nv_bfloat16><<<T, kQuantThreads, 0, s>>>(
        (const __nv_bfloat16*)x, xq, xs, D, ld, k16);
  return (int)cudaGetLastError();
}

// K3: xq [T, ldx] (ldx a multiple of 128, at least D, zero past D) and xs
// from ppl_i8i8_quantize_rows; w int8 [C, D, N]; ws f32 [C, N]; out
// [C, T, N]. `tile` 0 runs the prefill tile (splits 1); 1 the decode tile
// (T <= 64, N % 16 == 0, w 16-byte aligned, xq in the k16 order) over
// `splits` pieces of K, a cluster of at most 8, of `kchunk` rows each (a
// multiple of 64; the last piece ends at D).
int ppl_i8i8_gemm(int out_dtype, int tile, const int8_t* xq, int ldx,
                  const float* xs, const int8_t* w, const float* ws,
                  void* out, int T, int D, int N, int C, int splits,
                  int kchunk, void* stream) {
  if (T == 0) return 0;
  if (ldx % kPfBK || ldx < (D + kPfBK - 1) / kPfBK * kPfBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    return launch_i8i8<float>(tile, xq, ldx, xs, w, ws, out, T, D, N, C,
                              splits, kchunk, s);
  return launch_i8i8<__nv_bfloat16>(tile, xq, ldx, xs, w, ws, out, T, D, N,
                                    C, splits, kchunk, s);
}

// K4: xq [T, ldx] (ldx a multiple of 16, at least D, D = 2 * D2) and xs
// from ppl_i8i8_quantize_rows; w packed int4 [C, D2, N]; ws f32
// [C, D/group, N]; out [C, T, N]; group in {16, 32, 64, 128} dividing D2.
// T <= 16 runs the decode tile over `splits` pieces of `kchunk` packed
// rows each (a multiple of max(group, 64); the last piece ends at D2),
// and needs, when splits > 1, an f32 workspace `part` of splits*C*T*N
// partial sums and `done`, C*ceil(N/128) counters that are zero (each
// launch leaves them zero); both null when 1. T > 16 runs the prefill
// tile, splits 1.
int ppl_w4a8_gemm(int out_dtype, const int8_t* xq, int ldx, const float* xs,
                  const int8_t* w, const float* ws, void* out, int T, int D2,
                  int N, int C, int group, int splits, int kchunk,
                  float* part, int* done, void* stream) {
  if (T == 0) return 0;
  if (ldx % 16 || ldx < 2 * D2 || N % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    return launch_w4a8_for<float>(xq, ldx, xs, w, ws, out, T, D2, N, C,
                                  group, splits, kchunk, part, done, s);
  return launch_w4a8_for<__nv_bfloat16>(xq, ldx, xs, w, ws, out, T, D2, N, C,
                                        group, splits, kchunk, part, done, s);
}

}  // extern "C"
