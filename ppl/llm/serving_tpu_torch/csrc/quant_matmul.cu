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
// What bounds it on an H100: at decode sizes (T <= 16) bytes -- the int8
// weight is read once, D*N bytes per call, against 2*T*D*N operations;
// at prefill sizes (T ~ 1024 and up) operations, against the 1,979 TOP/s
// of the int8 tensor cores.
//
// Design (the quantize pass, then one of two GEMM tiles on the int8
// tensor cores, mma.sync.m16n8k32.s8 with exact s32 sums):
// - Quantize: one block per row (absmax reduction, int8 row, f32 scale).
//   The int8 rows get a stride rounded up to 128 bytes, zero past D, so
//   every activation tile is whole and 16-byte aligned.
// - The weight stays [D, N] with N contiguous (the JAX contract), but an
//   int8 MMA wants both operands k-contiguous. A weight tile lands in
//   shared memory N-major by 16-byte cp.async; a thread reads the 4-byte
//   words of rows k..k+3 at columns 4j..4j+3 and turns them k-major with
//   a 4x4 __byte_perm transpose, which yields the k-words of columns 4j,
//   4j+1, 4j+2, 4j+3 at once. So the tile's columns are permuted: n8
//   fragment i holds the columns 4j + i (j = 0..7) of a 32-column span,
//   one transpose feeds four fragments, and the epilogue puts each sum
//   back at 4j + i. The 16-byte chunks of a row are XOR-swizzled by
//   (k / 4) % 4 so the 32 lanes' words fall in 32 banks.
// - Prefill (T > 16): a 128 x 128 CTA tile on 8 warps (64 x 32 each),
//   two CTAs an SM (128 registers a thread), 128 bytes of k per stage, a
//   3-stage cp.async ring in 96 KB of dynamic shared memory. Activations
//   are the A operand, read by plain 4-byte shared loads (chunks swizzled
//   by row % 8: conflict-free; unlike volatile ldmatrix the compiler can
//   move them ahead of earlier MMAs), the weight the B operand. CTAs take
//   the (M, N) tiles in groups of 8 M tiles, M fastest, so the CTAs in flight
//   share weight tiles through L2 (in N-fastest order each weight byte
//   came from DRAM once per 128 tokens). Masked edges: rows past T and
//   weight rows past D or columns past N are copied as zeros; output
//   columns go out four at a time (N % 4 == 0).
// - Decode (T <= 16): byte-bound, so the operands swap: the weight is the
//   A (m16) side, through the same transpose, and the tokens the n8 side
//   (one or two n8 tiles, no padding to 16 or 32 rows). A CTA of 4 warps
//   streams 128 weight columns x 64 rows per stage (16-byte cp.async)
//   through a 4-stage ring; its warps split the columns in two and each
//   stage's k in two, and add their halves in shared memory at the end.
//   No tile shape tried (256 x 32 stages, an 8-deep ring, more pieces)
//   streamed faster. Split-K: the host
//   planner cuts K into pieces of whole 64-row stages so that every
//   weight gives at least two CTAs per SM. Pieces add int32 partial sums
//   with atomicAdd into a zeroed workspace -- integer addition is
//   order-free, so every run gives the same bits -- and the last CTA of
//   a column tile to finish (a counter in the same workspace) applies
//   the epilogue. One piece writes the output directly.
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
// nibbles and group g + G/2 in their high ones. Each CTA streams every
// weight byte once: per packed group chunk it stages the [GROUP, BN]
// bytes transposed (as K3), splits each 4-byte word into a low and a high
// word of sign-extended nibbles (__vsub4), and runs two dp4a chains, one
// against x[:, g*GROUP + k] and one against x[:, D/2 + g*GROUP + k].
// Inside a group the int32 sums are exact (|sum| <= 128*7*127); each is
// scaled by its group's scale in f32 and added to the f32 accumulator
// (rounded multiply, rounded add, as the plain version does; the groups
// are added in the order g, g + G/2, g + 1, ... rather than the plain
// version's 0, 1, ..., so the two agree to f32 rounding, not bit for
// bit). The epilogue multiplies by the token scale and writes out_dtype.
// Bound: bytes at decode sizes (D*N/2 weight bytes per call, a quarter
// of bf16's), int8 tensor-core operations at prefill sizes, like K3; the
// same SIMT dp4a design leaves it far from both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

using namespace ppl_ptx;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// One block per row: absmax, scale = absmax / 127 (a division), then
// q = clip(rint(x * (1 / scale)), -127, 127), four elements a load
template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    int D, int ld) {
  using V = typename Quad<T>::V;
  __shared__ float red[kQuantThreads / 32];
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
    qrow[i] = w;
  }
  for (int i = nq + threadIdx.x; i < ld / 4; i += blockDim.x) qrow[i] = 0;
  if (threadIdx.x == 0) xs[t] = scale;
}

constexpr int kGemmThreads = 256;   // K4's SIMT tile

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

constexpr int kTileN = 128;      // weight columns per CTA (both tiles)
constexpr int kDecodeMaxT = 16;  // T at or under this runs the decode tile

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

// --- decode tile: 128 weight columns x NT*8 tokens, split-K

constexpr int kDcThreads = 128;
constexpr int kDcBK = 64;               // contraction rows per stage
constexpr int kDcStages = 4;                // depth of the cp.async ring
constexpr int kDcWTile = kDcBK * kTileN;  // a stage's weight tile, bytes
constexpr int kDcXStride = kDcBK + 16;  // x tile row: 64 bytes + 16 of pad
constexpr int kDcXTile = 2 * 8 * kDcXStride;
constexpr int kDcSmem = kDcStages * (kDcWTile + kDcXTile);  // 37 KB

// part: int32 sums [C, T, N] and done: one arrival counter per (c, column
// tile), both zeroed by the caller, when K is cut into gridDim.y > 1
// pieces of kchunk rows; both null for one piece.
template <int NT, int VEC, typename TO>
__global__ void __launch_bounds__(kDcThreads) i8i8_decode_kernel(
    const int8_t* __restrict__ xq, int ldx, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D, int N, int kchunk,
    int* __restrict__ part, int* __restrict__ done) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ int last_piece;
  const int c = blockIdx.z, tile = blockIdx.x;
  const int n0 = tile * kTileN;
  const int kb = blockIdx.y * kchunk, ke = min(D, kb + kchunk);
  const int ktiles = (ke - kb + kDcBK - 1) / kDcBK;
  const int8_t* wc = w + (size_t)c * D * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wcol = warp & 1, wk = warp >> 1;  // 64-column half, 32-row half
  const int g = lane >> 2, tig = lane & 3;

  auto load_stage = [&](int kt) {
    int8_t* w_t = smem + (kt % kDcStages) * (kDcWTile + kDcXTile);
    int8_t* x_t = w_t + kDcWTile;
    const int k0 = kb + kt * kDcBK;
    load_wtile<VEC, kDcThreads, kDcBK>(w_t, wc, k0, ke, n0, N, tid);
    for (int e = tid; e < NT * 8 * (kDcBK / 16); e += kDcThreads) {
      const int t = e / (kDcBK / 16), ch = e % (kDcBK / 16);
      cp_async16(smem_u32(x_t + t * kDcXStride + ch * 16),
                 xq + (size_t)(t < T ? t : 0) * ldx + k0 + ch * 16,
                 t < T ? 16 : 0);
    }
  };

  int acc[4][NT][4];  // [permuted m16 fragment][n8 token tile][c0..c3]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < kDcStages - 1; ++s) {
    if (s < ktiles) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kDcStages - 2>();
    __syncthreads();
    if (kt + kDcStages - 1 < ktiles) load_stage(kt + kDcStages - 1);
    cp_async_commit();
    const int8_t* w_t = smem + (kt % kDcStages) * (kDcWTile + kDcXTile);
    const int8_t* x_t = w_t + kDcWTile;
    const int kr = 32 * wk;
    // A: fragment i's row j is weight column 4j + i of the warp's first
    // 32-column span (rows 0..7) or of its second (rows 8..15)
    uint32_t a[4][4], col[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // a0: (span 0, k 0-15), a1: (1, 0-15), a2, a3: k 16-31
      load_kwords(w_t, kr + 16 * (q >> 1), 2 * wcol + (q & 1), g, tig, col);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i][q] = col[i];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* xr = x_t + (8 * j + g) * kDcXStride + kr + 4 * tig;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) mma_s8(acc[i][j], a[i], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // add the two k halves: warps wk = 1 hand theirs over in shared memory
  int* red = reinterpret_cast<int*>(smem);  // [16*NT][2 halves][32 lanes]
  if (wk == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[((i * NT + j) * 4 + r) * 64 + wcol * 32 + lane] = acc[i][j][r];
  }
  __syncthreads();
  if (wk == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] += red[((i * NT + j) * 4 + r) * 64 + wcol * 32 + lane];
  }

  // thread (g, tig) of a wk = 0 warp holds, for tokens 8j + 2*tig + p,
  // columns 4g + 0..3 (c0/c1 of fragments 0..3) and 32 + 4g + 0..3 (c2/c3)
  // of its 64-column half
  const float* wsc = ws + (size_t)c * N;
  TO* oc = out + (size_t)c * T * N;
  int* pc = part == nullptr ? nullptr : part + (size_t)c * T * N;
  if (wk == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int t = 8 * j + 2 * tig + p;
          const int n = n0 + 64 * wcol + 32 * half + 4 * g;
          if (t >= T || n >= N) continue;
          if (pc == nullptr) {
            float v[4];
            const float sx = xs[t];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              v[i] = scale_sum(acc[i][j][2 * half + p], sx, wsc[n + i]);
            store4(oc + (size_t)t * N + n, v);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              atomicAdd(pc + (size_t)t * N + n + i, acc[i][j][2 * half + p]);
          }
        }
  }
  if (pc == nullptr) return;

  // the last piece of this column tile to arrive applies the epilogue
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_piece = atomicAdd(done + c * gridDim.x + tile, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last_piece) return;
  __threadfence();
  for (int e = tid; e < T * (kTileN / 4); e += kDcThreads) {
    const int t = e / (kTileN / 4), n = n0 + 4 * (e % (kTileN / 4));
    if (n >= N) continue;
    const int4 s = __ldcg(reinterpret_cast<const int4*>(pc + (size_t)t * N + n));
    const float sx = xs[t];
    const float v[4] = {scale_sum(s.x, sx, wsc[n]), scale_sum(s.y, sx, wsc[n + 1]),
                        scale_sum(s.z, sx, wsc[n + 2]), scale_sum(s.w, sx, wsc[n + 3])};
    store4(oc + (size_t)t * N + n, v);
  }
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

template <int NT, int VEC, typename TO>
int launch_decode_tile(const int8_t* xq, int ldx, const float* xs,
                       const int8_t* w, const float* ws, void* out, int T,
                       int D, int N, int C, int splits, int kchunk,
                       int* part, cudaStream_t s) {
  const cudaError_t err = allow_smem<i8i8_decode_kernel<NT, VEC, TO>>(kDcSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kTileN - 1) / kTileN;
  int* done = part == nullptr ? nullptr : part + (size_t)C * T * N;
  dim3 grid(tiles, splits, C);
  i8i8_decode_kernel<NT, VEC, TO><<<grid, kDcThreads, kDcSmem, s>>>(
      xq, ldx, xs, w, ws, (TO*)out, T, D, N, kchunk, part, done);
  return (int)cudaGetLastError();
}

template <typename TO>
int launch_i8i8(const int8_t* xq, int ldx, const float* xs, const int8_t* w,
                const float* ws, void* out, int T, int D, int N, int C,
                int splits, int kchunk, int* part, cudaStream_t s) {
  const bool v16 = N % 16 == 0;
  if (T > kDecodeMaxT) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return v16 ? launch_prefill_tile<16, TO>(xq, ldx, xs, w, ws, out, T, D, N, C, s)
               : launch_prefill_tile<4, TO>(xq, ldx, xs, w, ws, out, T, D, N, C, s);
  }
  // the pieces [i*kchunk, min(D, (i+1)*kchunk)) must cover K, none empty
  if (splits < 1 || kchunk <= 0 || kchunk % kDcBK ||
      (long long)(splits - 1) * kchunk >= D || (long long)splits * kchunk < D ||
      (splits > 1) != (part != nullptr))
    return (int)cudaErrorInvalidValue;
#define PPL_DECODE_TILE(NTV, VECV)                                             \
  launch_decode_tile<NTV, VECV, TO>(xq, ldx, xs, w, ws, out, T, D, N, C,       \
                                    splits, kchunk, part, s)
  if (T <= 8) return v16 ? PPL_DECODE_TILE(1, 16) : PPL_DECODE_TILE(1, 4);
  return v16 ? PPL_DECODE_TILE(2, 16) : PPL_DECODE_TILE(2, 4);
#undef PPL_DECODE_TILE
}

// Sign-extended nibbles of four packed bytes: the low nibbles and the high
// nibbles, each as four int8 lanes of a word (for __dp4a).
__device__ __forceinline__ int low_nibbles(unsigned int w) {
  return (int)__vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ int high_nibbles(unsigned int w) {
  return (int)__vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <int GROUP, int BM, int BN, int TM, int TN, typename TO>
__global__ void __launch_bounds__(kGemmThreads) w4a8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D, int N) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "thread tiling");
  constexpr int KW = GROUP / 4;  // int32 words per group row
  __shared__ int xlo_s[BM][KW + 1];
  __shared__ int xhi_s[BM][KW + 1];
  __shared__ int wlo_s[BN][KW + 1];
  __shared__ int whi_s[BN][KW + 1];
  const int c = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int D2 = D / 2;
  const int GH = D2 / GROUP;     // groups per half of the contraction
  const int8_t* wc = w + (size_t)c * D2 * N;
  const float* wsc = ws + (size_t)c * 2 * GH * N;
  const int tid = threadIdx.x;
  constexpr int kNT = BN / TN;
  const int tn = tid % kNT, tm = tid / kNT;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int g = 0; g < GH; ++g) {
    const int k0 = g * GROUP;
    for (int e = tid; e < BM * KW; e += kGemmThreads) {
      const int m = e / KW, kw = e - m * KW;
      int lo = 0, hi = 0;
      if (m0 + m < T) {
        const int8_t* xr = xq + (size_t)(m0 + m) * D + k0 + 4 * kw;
        lo = *reinterpret_cast<const int*>(xr);
        hi = *reinterpret_cast<const int*>(xr + D2);
      }
      xlo_s[m][kw] = lo;
      xhi_s[m][kw] = hi;
    }
    for (int e = tid; e < KW * (BN / 4); e += kGemmThreads) {
      const int kb = e / (BN / 4), nb = e - kb * (BN / 4);
      const int k = k0 + 4 * kb, n = n0 + 4 * nb;
      int r[4] = {0, 0, 0, 0};
      if (n < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const int*>(wc + (size_t)(k + i) * N + n);
      }
      int col[4];
      transpose4x4(r[0], r[1], r[2], r[3], col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wlo_s[4 * nb + i][kb] = low_nibbles((unsigned int)col[i]);
        whi_s[4 * nb + i][kb] = high_nibbles((unsigned int)col[i]);
      }
    }
    __syncthreads();
    int plo[TM][TN], phi[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) plo[i][j] = phi[i][j] = 0;
#pragma unroll 4
    for (int kw = 0; kw < KW; ++kw) {
      int alo[TM], ahi[TM], blo[TN], bhi[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        alo[i] = xlo_s[tm + i * (BM / TM)][kw];
        ahi[i] = xhi_s[tm + i * (BM / TM)][kw];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        blo[j] = wlo_s[tn + j * kNT][kw];
        bhi[j] = whi_s[tn + j * kNT][kw];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          plo[i][j] = __dp4a(alo[i], blo[j], plo[i][j]);
          phi[i][j] = __dp4a(ahi[i], bhi[j], phi[i][j]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * kNT;
      const float slo = n < N ? wsc[(size_t)g * N + n] : 0.f;
      const float shi = n < N ? wsc[(size_t)(g + GH) * N + n] : 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn((float)plo[i][j], slo));
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn((float)phi[i][j], shi));
      }
    }
  }

  TO* oc = out + (size_t)c * T * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * (BM / TM);
    if (m >= T) continue;
    const float sx = xs[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * kNT;
      if (n < N) oc[(size_t)m * N + n] = from_f<TO>(acc[i][j] * sx);
    }
  }
}

template <int GROUP, typename TO>
void launch_w4a8(const int8_t* xq, const float* xs, const int8_t* w,
                 const float* ws, void* out, int T, int D, int N, int C,
                 cudaStream_t s) {
  if (T <= 16) {
    dim3 grid((N + 31) / 32, (T + 15) / 16, C);
    w4a8_gemm_kernel<GROUP, 16, 32, 1, 2, TO><<<grid, kGemmThreads, 0, s>>>(
        xq, xs, w, ws, (TO*)out, T, D, N);
  } else {
    dim3 grid((N + 63) / 64, (T + 63) / 64, C);
    w4a8_gemm_kernel<GROUP, 64, 64, 4, 4, TO><<<grid, kGemmThreads, 0, s>>>(
        xq, xs, w, ws, (TO*)out, T, D, N);
  }
}

template <typename TO>
int launch_w4a8_for(const int8_t* xq, const float* xs, const int8_t* w,
                    const float* ws, void* out, int T, int D, int N, int C,
                    int group, cudaStream_t s) {
  switch (group) {
    case 16: launch_w4a8<16, TO>(xq, xs, w, ws, out, T, D, N, C, s); break;
    case 32: launch_w4a8<32, TO>(xq, xs, w, ws, out, T, D, N, C, s); break;
    case 64: launch_w4a8<64, TO>(xq, xs, w, ws, out, T, D, N, C, s); break;
    case 128: launch_w4a8<128, TO>(xq, xs, w, ws, out, T, D, N, C, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype codes: 0 = float32,
// 1 = bfloat16. Every function returns the cudaError_t of its launch.
extern "C" {

// x [T, D] -> int8 rows xq [T, ld] (zero in [D, ld)) and f32 scales xs
// [T]; D and ld multiples of 4, x 16-byte aligned, xq 4-byte aligned
int ppl_i8i8_quantize_rows(int x_dtype, const void* x, int8_t* xq, float* xs,
                           int T, int D, int ld, void* stream) {
  if (T == 0) return 0;
  if (ld < D || D % 4 || ld % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    quantize_rows_kernel<float><<<T, kQuantThreads, 0, s>>>((const float*)x, xq, xs, D, ld);
  else
    quantize_rows_kernel<__nv_bfloat16><<<T, kQuantThreads, 0, s>>>(
        (const __nv_bfloat16*)x, xq, xs, D, ld);
  return (int)cudaGetLastError();
}

// K3: xq [T, ldx] (ldx a multiple of 128, at least D, zero past D) and xs
// from ppl_i8i8_quantize_rows; w int8 [C, D, N]; ws f32 [C, N]; out
// [C, T, N]. T <= 16 runs the decode tile over `splits` pieces of K of
// `kchunk` rows each (a multiple of 64; the last piece ends at D), and
// needs a zeroed int32 workspace of C*T*N sums and C*ceil(N/128) counters
// when splits > 1 (null when 1); T > 16 runs the prefill tile, splits 1.
int ppl_i8i8_gemm(int out_dtype, const int8_t* xq, int ldx, const float* xs,
                  const int8_t* w, const float* ws, void* out, int T, int D,
                  int N, int C, int splits, int kchunk, int* workspace,
                  void* stream) {
  if (T == 0) return 0;
  if (ldx % kPfBK || ldx < (D + kPfBK - 1) / kPfBK * kPfBK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    return launch_i8i8<float>(xq, ldx, xs, w, ws, out, T, D, N, C, splits,
                              kchunk, workspace, s);
  return launch_i8i8<__nv_bfloat16>(xq, ldx, xs, w, ws, out, T, D, N, C,
                                    splits, kchunk, workspace, s);
}

// K4: xq/xs from ppl_i8i8_quantize_rows; w packed int4 [C, D/2, N];
// ws f32 [C, D/group, N]; out [C, T, N]; group in {16, 32, 64, 128}.
int ppl_w4a8_gemm(int out_dtype, const int8_t* xq, const float* xs,
                  const int8_t* w, const float* ws, void* out, int T, int D,
                  int N, int C, int group, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    return launch_w4a8_for<float>(xq, xs, w, ws, out, T, D, N, C, group, s);
  return launch_w4a8_for<__nv_bfloat16>(xq, xs, w, ws, out, T, D, N, C,
                                        group, s);
}

}  // extern "C"
