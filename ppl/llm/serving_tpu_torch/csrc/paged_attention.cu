// Paged attention over the packed k|v KV cache: decode (K1) and prefill (K2).
//
// Replaces the TPU Pallas kernels
//   K1  ppl/llm/serving_tpu/ops/pallas/paged_attention.py:paged_decode_attention
//       (body _decode_kernel)
//   K2  ppl/llm/serving_tpu/ops/pallas/paged_attention.py:paged_prefill_attention
//       (body _prefill_kernel)
// in their deferred-append form, over a bf16/f32 cache or an int8 cache
// with group-8 scales, with or without ALiBi; K1 also in block-tail mode.
//
// Cache layout (ops/kv_cache.py): [KVH, L*num_slots, 2*shd] packed rows,
// k in lanes [0, hd), v in lanes [shd, shd+hd); layer l's slot s is row
// l*num_slots + s; slot = page*page_size + offset. An int8 cache has bf16
// scale rows [L*num_slots, scale_lanes], one per slot, lane order (head,
// k|v, group): head h's k group scales start at lane h*2*(hd/8), its v
// group scales hd/8 lanes later. The Pallas kernels dequantize a page
// with a one-hot matmul in bf16; here each 16-byte load of 16 int8 lanes
// takes its two group scales with one 4-byte load and is dequantized on
// its way into shared memory: in f32 for the f32 bodies (int8 x bf16 is
// exact in f32), rounded once to bf16 for the tensor-core bodies (the
// Pallas body's bf16 product), so the rest of each kernel is the
// same for every cache type. An int8 page moves half the bytes of a bf16
// one, plus 1/4 of that again in scales.
//
// What bounds them on an H100: bytes. Decode attention reads every cached
// K/V byte of the batch once and does 4 flops per cached element per query
// head of the GQA group (8 for TinyLlama), far under the ~295 flop/byte
// ridge. Prefill does 4*hd flops per (query row, key) pair; a q block of
// 64 rows reads each key's 4*hd bytes of bf16 K|V once, 64 flops a byte,
// still under the ridge: byte-bound (PERF.md's bound counts each cached
// byte once), and in practice bound by re-reading K/V once per q block
// and by the latency of each chunk's loads.
//
// Designs:
// - K1: the cache holds n = ctx - 1 - tail_len tokens of a row; the current
//   token's fresh k/v joins last as the self-term, in f32 with q scaled by
//   hd^-0.5 (unrounded), as the Pallas kernel does. Rows with ctx == 0
//   write zeros. Block-tail mode (a multi-step decode block that writes
//   the cache once at its end): rows j < tail_len of the block's dense
//   side buffer [L, B, KVH, J, 2*shd] (int8 rows with their own scale
//   rows [L, B, J, scale_lanes]), J <= 64, join as one more chunk of keys
//   at positions n + j, before the self-term. Two bodies, chosen by q's
//   dtype:
//   * bf16 (every serving path): split-context (flash-decoding) attention
//     on the tensor cores. The grid is (B, KVH, S), S chosen by the host
//     from B*KVH, the page-table width and the SM count (a fixed S per
//     program key, so CUDA graphs capture it): about two CTAs a SM when
//     B*KVH is small, S = 1 when B*KVH fills the card. Split z covers
//     whole pages of the row's n cached tokens; a split past them writes
//     an empty partial (m = -1e30, l = 0). The A tile's 16 rows are the
//     G <= 16 query heads of the kv head (zero rows past G), q * hd^-0.5
//     rounded to bf16; keys are the N side of mma.sync.m16n8k16. Chunks of
//     64 keys come through K2's loader (rows looked up from the page table
//     before the copies, bf16 by cp.async into a second buffer while this
//     chunk computes, int8 raw with their scale pairs and dequantized per
//     thread to bf16); each of the 4 warps takes 16 keys of every chunk
//     with its own online softmax in registers (scores f32, ALiBi added
//     in f32, P rounded to bf16 for P.V, f32 sums), and the warps' states
//     merge in warp order. With S > 1 each CTA writes its partial (m, l,
//     acc) and the last of a row's CTAs to arrive (a counter in a zeroed
//     workspace) merges the S partials in split order, so the bits do not
//     depend on which CTA finishes first; the tail chunk is split S-1's
//     last chunk; the finishing CTA adds the self-term.
//   * f32 (the step checks in f32): the first SIMT design, one CTA per
//     (row, kv head) walking the pages in chunks of CH tokens read as f32
//     into shared memory, the G heads' scores in shared memory, an f32
//     online softmax per head and per-thread (head, dim) accumulators; the
//     tail is one more chunk through load_kv_chunk. TF32 tensor cores
//     would break its 2e-5 tolerance.
// - K2: one CTA per (prefill row, q block, kv head); a q block is
//   QB = 64 / G positions so the CTA holds 64 query rows (position,
//   head), row r = i*G + g. Keys walk up to the causal bound
//   min(ctx, q0 + QB) in chunks of 64; position p reads the fresh slab
//   when p >= start, the cache otherwise, so a chunk may straddle start.
//   The mask is k_pos <= row_pos & row_valid & k_pos < ctx. An inactive
//   q block writes zeros. Two bodies, chosen by q's dtype:
//   * bf16 (every serving path): flash attention on the tensor cores,
//     mma.sync.m16n8k16 bf16 with f32 sums. 4 warps of 16 rows; each
//     warp loads its q fragments once, q * hd^-0.5 rounded to bf16 as
//     the Pallas body does. A chunk's K and V rows sit in shared memory
//     as bf16. Before a chunk's copies, 64 threads look up its 64 keys'
//     rows (fresh slab or page table) into shared memory, once a key, so
//     the copies wait on no page-table load. bf16 pages come by 16-byte
//     cp.async into a second buffer while this chunk computes; int8 pages
//     by cp.async of the raw lanes and their scale pairs into a staging
//     area, each thread dequantizing its own vectors to bf16 (int8 x bf16
//     scale rounded once, the Pallas body's bf16 product) after this
//     chunk computes. S stays in registers (ldmatrix of K rows); ALiBi,
//     the mask and the online softmax run there, row max and sum over the
//     quad by shuffles; P, rounded to bf16 as the Pallas body rounds
//     p_exp, is the A fragment of P.V, whose V fragments come by
//     ldmatrix.trans. Key groups of 16 past the causal bound or the
//     warp's last position are skipped (a warp-uniform count dispatched
//     to unrolled code). An inactive q block writes its zeros 16 bytes a
//     store.
//   * f32 (the step checks in f32): the tensor cores take no f32 and TF32
//     would break the 2e-5 f32 tolerance, so this keeps the first SIMT
//     design: K/V rows in shared memory as f32, a 4x4 register tile of
//     scores per thread written to shared memory, the softmax and P.V
//     from there.
// - ALiBi (slopes f32 [Hq], or null for none): the Pallas kernels'
//   shift-invariant form, score += slope * k_pos after the 1/sqrt(hd)
//   scale and before the mask, q head h*G+g taking slopes[h*G+g]. K1's
//   positions: a page chunk's token t sits at c0 + t; the tail chunk,
//   loaded as a fresh slab from position 0, sits after the n cached
//   tokens, at n + t; the self-term at n + tail_len, tail_len unclamped
//   (the current token's position, ctx - 1, whenever ctx > tail_len).
//   K2's key at c0 + t. The bias is a separate f32 multiply and add
//   (__fmul_rn/__fadd_rn, never contracted into an fma), as the plain
//   version computes it.
// Neither uses TMA or wgmma yet: later PRs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

using namespace ppl_ptx;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// 16 bytes -> floats (4 for f32, 16 for int8)
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  // byte j of word i, sign-extended: shift the unsigned word so the byte
  // is on top, then shift the int arithmetically back down
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] = (float)((int32_t)(w[i] << (24 - 8 * j)) >> 24);
  }
};

constexpr int kKvGroup = 8;  // int8 KV: one scale per 8 lanes

// Scale rows of an int8 cache (or fresh slab): base pointer, row stride
// in lanes, and this head's lane offset. Unused for a bf16/f32 cache.
struct ScaleRows {
  const __nv_bfloat16* rows;
  int lanes;
  int head_off;
};

// score + slope * k_pos, rounded as the plain version rounds it
__device__ __forceinline__ float alibi_add(float s, float slope, int k_pos) {
  return __fadd_rn(s, __fmul_rn(slope, (float)k_pos));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load `cn` (<= ch) K|V rows of positions [c0, c0+cn) into kv_s[ch][2*hd+1]
// as f32 (k at [0, hd), v at [hd, 2*hd)); rows >= cn are zero-filled.
// Position p comes from the fresh slab (row p - start) when p >= fresh_from,
// from the paged cache otherwise. An int8 row (TC = int8_t) is scaled by
// the group scales of the same row in `cs` (cache) or `fs` (fresh slab).
template <typename TC>
__device__ __forceinline__ void load_kv_chunk(
    float* kv_s, int ch, int c0, int cn, int hd, int shd,
    const TC* __restrict__ cache_h, ScaleRows cs, const int* __restrict__ pt,
    int P, int ps, long long lbase, const TC* __restrict__ fresh,
    ScaleRows fs, int fresh_from) {
  constexpr int V = Vec16<TC>::N;
  const int lanes = 2 * shd;
  const int kvs = 2 * hd + 1;
  const int hvec = hd / V;  // 16-byte vectors per half row
  for (int e = threadIdx.x; e < ch * 2 * hvec; e += blockDim.x) {
    const int t = e / (2 * hvec);
    const int j = e - t * 2 * hvec;
    const int half = j / hvec;
    const int jj = j - half * hvec;
    float vals[V];
    if (t < cn) {
      const int pos = c0 + t;
      const TC* row;
      const __nv_bfloat16* srow = nullptr;
      if (fresh != nullptr && pos >= fresh_from) {
        row = fresh + (size_t)(pos - fresh_from) * lanes;
        if constexpr (std::is_same<TC, int8_t>::value)
          srow = fs.rows + (size_t)(pos - fresh_from) * fs.lanes + fs.head_off;
      } else {
        int pidx = pos / ps;
        pidx = pidx < P ? pidx : P - 1;
        const long long slot = lbase + (long long)pt[pidx] * ps + (pos - (pos / ps) * ps);
        row = cache_h + (size_t)slot * lanes;
        if constexpr (std::is_same<TC, int8_t>::value)
          srow = cs.rows + (size_t)slot * cs.lanes + cs.head_off;
      }
      const uint4 u = reinterpret_cast<const uint4*>(row + half * shd)[jj];
      Vec16<TC>::unpack(u, vals);
      if constexpr (std::is_same<TC, int8_t>::value) {
        // the vector's 16 lanes are groups 2*jj and 2*jj+1 of this half
        const uint32_t sw = *reinterpret_cast<const uint32_t*>(
            srow + half * (hd / kKvGroup) + 2 * jj);
        const float s0 = __uint_as_float(sw << 16);
        const float s1 = __uint_as_float(sw & 0xffff0000u);
#pragma unroll
        for (int i = 0; i < V; ++i) vals[i] *= i < kKvGroup ? s0 : s1;
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) vals[i] = 0.f;
    }
    float* dst = kv_s + t * kvs + half * hd + jj * V;
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = vals[i];
  }
}

// ------------------------------------------------------ K1 f32 body (SIMT)

constexpr int kDecMaxOut = 8;  // per-thread outputs: G*hd <= 8 * 256

template <typename T, typename TC>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const TC* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scale, int scale_lanes,
    const int* __restrict__ page_table, const int* __restrict__ ctx,
    const T* __restrict__ fk, const T* __restrict__ fv, T* __restrict__ out,
    int Hq, int KVH, int hd, int shd, int P, int ps, long long LS,
    long long lbase, int CH, float sm_scale, const TC* __restrict__ tkv,
    const __nv_bfloat16* __restrict__ tscale, const int* __restrict__ tlen,
    int J, int layer, const float* __restrict__ slopes) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int G = Hq / KVH;
  const int GH = G * hd;
  const int kvs = 2 * hd + 1;
  float* q_s = smem;              // [G][hd]
  float* kv_s = q_s + GH;         // [CH][kvs]
  float* s_s = kv_s + CH * kvs;   // [G][CH]
  float* m_s = s_s + G * CH;      // [G]
  float* l_s = m_s + G;           // [G]
  float* a_s = l_s + G;           // [G]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int ctx_t = ctx[b];
  T* o = out + ((size_t)b * Hq + (size_t)h * G) * hd;
  if (ctx_t <= 0) {
    for (int i = tid; i < GH; i += nt) o[i] = from_f<T>(0.f);
    return;
  }
  // tail rows of the block side buffer (0 outside block-tail mode)
  const int tl = tkv != nullptr ? max(0, min(tlen[0], J)) : 0;
  // cached tokens: the current one is the self-term, the tail rows precede it
  const int n = max(ctx_t - 1 - (tkv != nullptr ? tlen[0] : 0), 0);
  // this CTA's G slopes (ALiBi), or null
  const float* sl = slopes != nullptr ? slopes + (size_t)h * G : nullptr;
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * hd;
  for (int i = tid; i < GH; i += nt) q_s[i] = to_f(qb[i]) * sm_scale;
  for (int g = tid; g < G; g += nt) { m_s[g] = kNegInf; l_s[g] = 0.f; }
  float acc[kDecMaxOut];
#pragma unroll
  for (int j = 0; j < kDecMaxOut; ++j) acc[j] = 0.f;
  __syncthreads();

  const TC* cache_h = cache + (size_t)h * LS * (2 * shd);
  const ScaleRows cs{scale, scale_lanes, h * 2 * (hd / kKvGroup)};
  const int* pt = page_table + (size_t)b * P;
  // this (layer, row, head)'s tail rows and scale rows
  const TC* trow = tkv == nullptr ? nullptr
      : tkv + (((size_t)layer * gridDim.x + b) * KVH + h) * (size_t)J * (2 * shd);
  const ScaleRows ts{tscale + (tscale ? ((size_t)layer * gridDim.x + b) * J * scale_lanes : 0),
                     scale_lanes, cs.head_off};
  const int n_page_chunks = (n + CH - 1) / CH;
  for (int ci = 0; ci < n_page_chunks + (tl > 0); ++ci) {
    const bool tail = ci == n_page_chunks;
    const int c0 = tail ? 0 : ci * CH;
    const int cn = tail ? tl : min(CH, n - c0);
    const int kpos0 = tail ? n : c0;  // key position of the chunk's row 0
    load_kv_chunk<TC>(kv_s, CH, c0, cn, hd, shd, cache_h, cs, pt, P, ps,
                      lbase, tail ? trow : nullptr, ts, 0);
    __syncthreads();
    for (int e = tid; e < G * CH; e += nt) {
      const int g = e / CH, t = e - g * CH;
      float s = kNegInf;
      if (t < cn) {
        s = 0.f;
        const float* qr = q_s + g * hd;
        const float* kr = kv_s + t * kvs;
        for (int d = 0; d < hd; ++d) s = fmaf(qr[d], kr[d], s);
        if (sl != nullptr) s = alibi_add(s, sl[g], kpos0 + t);
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += nwarps) {
      float* sr = s_s + g * CH;
      float mx = kNegInf;
      for (int t = lane; t < cn; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < CH; t += 32) {
        const float p = t < cn ? expf(sr[t] - m_new) : 0.f;
        sr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kDecMaxOut; ++j) {
      const int i = tid + j * nt;
      if (i < GH) {
        const int g = i / hd, d = i - g * hd;
        const float* pr = s_s + g * CH;
        const float* vc = kv_s + hd + d;
        float a = acc[j] * a_s[g];
        for (int t = 0; t < cn; ++t) a = fmaf(pr[t], vc[t * kvs], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  // self-term: the current token's K/V (not yet in the cache)
  const T* fkr = fk + ((size_t)b * KVH + h) * hd;
  const T* fvr = fv + ((size_t)b * KVH + h) * hd;
  for (int g = warp; g < G; g += nwarps) {
    float s = 0.f;
    for (int d = lane; d < hd; d += 32) s = fmaf(q_s[g * hd + d], to_f(fkr[d]), s);
    s = warp_sum(s);
    if (sl != nullptr)
      s = alibi_add(s, sl[g], n + (tkv != nullptr ? tlen[0] : 0));
    if (lane == 0) {
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, s);
      const float alpha = expf(m_old - m_new);
      const float p = expf(s - m_new);
      l_s[g] = l_s[g] * alpha + p;
      a_s[g] = alpha;
      s_s[g] = p;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kDecMaxOut; ++j) {
    const int i = tid + j * nt;
    if (i < GH) {
      const int g = i / hd, d = i - g * hd;
      const float a = acc[j] * a_s[g] + s_s[g] * to_f(fvr[d]);
      o[i] = from_f<T>(a / fmaxf(l_s[g], 1e-30f));
    }
  }
}

// --------------------------------------------------------------- K2 prefill

constexpr int kRows = 64;   // query rows (position, head) per CTA
constexpr int kChunk = 64;  // keys per chunk

template <typename T, typename TC, int HD>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const T* __restrict__ q, const TC* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scale, int scale_lanes,
    const int* __restrict__ page_table, const int* __restrict__ start_p,
    const int* __restrict__ newlen_p, const TC* __restrict__ fresh_kv,
    const __nv_bfloat16* __restrict__ fresh_scale,
    T* __restrict__ out, int Qp, int Hq, int KVH, int shd, int P, int ps,
    long long LS, long long lbase, int QB, float sm_scale,
    const float* __restrict__ slopes) {
  extern __shared__ float smem[];
  constexpr int kvs = 2 * HD + 1;
  constexpr int sst = kChunk + 1;
  constexpr int kRowStep = kThreads / HD;   // rows between a thread's outputs
  constexpr int kOut = kRows / kRowStep;    // outputs per thread
  float* q_s = smem;                        // [kRows][HD]
  float* kv_s = q_s + kRows * HD;           // [kChunk][kvs]
  float* s_s = kv_s + kChunk * kvs;         // [kRows][sst]
  float* m_s = s_s + kRows * sst;           // [kRows]
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int b = blockIdx.x, qb = blockIdx.y, h = blockIdx.z;
  const int G = Hq / KVH;
  const int R = QB * G;                     // live rows of this CTA
  const int tid = threadIdx.x;
  const int start = start_p[b], new_len = newlen_p[b];
  const int ctx = start + new_len;
  const int qi0 = qb * QB;                  // first q index of the block
  const int q0 = start + qi0;               // its absolute position
  const bool active = qi0 < new_len;

  // row r = i*G + g holds position q0+i of q head h*G+g
  auto out_ptr = [&](int r) -> T* {
    const int i = r / G, g = r - (r / G) * G;
    return out + (((size_t)b * Qp + qi0 + i) * Hq + (size_t)h * G + g) * HD;
  };
  if (!active) {
    for (int e = tid; e < R * HD; e += kThreads) {
      const int r = e / HD;
      if (qi0 + r / G < Qp) out_ptr(r)[e - r * HD] = from_f<T>(0.f);
    }
    return;
  }
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    float v = 0.f;
    if (r < R && qi0 + r / G < Qp) {
      const int i = r / G, g = r - i * G;
      v = to_f(q[(((size_t)b * Qp + qi0 + i) * Hq + (size_t)h * G + g) * HD + d]) * sm_scale;
    }
    q_s[e] = v;
  }
  for (int r = tid; r < kRows; r += kThreads) { m_s[r] = kNegInf; l_s[r] = 0.f; }

  // per-thread output tile: dim d, rows rb + j*kRowStep
  const int od = tid % HD, orb = tid / HD;
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;
  // per-thread score tile: rows sr + 16*i, keys sk + 16*j
  const int sr = tid >> 4, sk = tid & 15;
  const int kv_hi = min(ctx, q0 + QB);
  const TC* cache_h = cache + (size_t)h * LS * (2 * shd);
  const TC* fresh_h = fresh_kv + ((size_t)b * KVH + h) * (size_t)Qp * (2 * shd);
  const int head_off = h * 2 * (HD / kKvGroup);
  const ScaleRows cs{scale, scale_lanes, head_off};
  const ScaleRows fs{fresh_scale + (fresh_scale ? (size_t)b * Qp * scale_lanes : 0),
                     scale_lanes, head_off};
  const int* pt = page_table + (size_t)b * P;
  __syncthreads();

  for (int c0 = 0; c0 < kv_hi; c0 += kChunk) {
    const int cn = min(kChunk, kv_hi - c0);
    load_kv_chunk<TC>(kv_s, kChunk, c0, cn, HD, shd, cache_h, cs, pt, P, ps,
                      lbase, fresh_h, fs, start);
    __syncthreads();
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = q_s[(sr + 16 * i) * HD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kv_s[(sk + 16 * j) * kvs + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
      if (slopes != nullptr) {
        // row r holds q head h*G + r%G; key sk+16j sits at c0 + sk + 16j
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float slope = slopes[h * G + (sr + 16 * i) % G];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = alibi_add(s[i][j], slope, c0 + sk + 16 * j);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s_s[(sr + 16 * i) * sst + sk + 16 * j] = s[i][j];
    }
    __syncthreads();
    {
      // four threads per row, each over 16 keys; the mask is recomputed
      const int r = tid >> 2, part = tid & 3;
      const int qi = qi0 + r / G;
      const int row_pos = start + qi;
      const bool row_valid = r < R && qi < new_len;
      float* srow = s_s + r * sst;
      float mx = kNegInf;
      for (int t = part; t < kChunk; t += 4) {
        const int kp = c0 + t;
        if (t < cn && row_valid && kp <= row_pos && kp < ctx) mx = fmaxf(mx, srow[t]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = part; t < kChunk; t += 4) {
        const int kp = c0 + t;
        const bool ok = t < cn && row_valid && kp <= row_pos && kp < ctx;
        const float p = ok ? expf(srow[t] - m_new) : 0.f;
        srow[t] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[j] *= a_s[orb + j * kRowStep];
    for (int t = 0; t < cn; ++t) {
      const float v = kv_s[t * kvs + HD + od];
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        acc[j] = fmaf(s_s[(orb + j * kRowStep) * sst + t], v, acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int r = orb + j * kRowStep;
    if (r < R && qi0 + r / G < Qp)
      out_ptr(r)[od] = from_f<T>(acc[j] / fmaxf(l_s[r], 1e-30f));
  }
}

// ------------------------------------------------- K2 tensor-core bf16 body

constexpr int kTcThreads = 128;  // 4 warps x 16 query rows = kRows

// Shared memory of the tensor-core body: K and V of a key chunk as bf16,
// each key row 2*HD bytes + 16 of pad so that the 8 rows of an ldmatrix
// phase fall in 8 different 16-byte bank groups; two chunks for a bf16
// cache (the next one lands by cp.async while this one computes), one
// for an int8 cache, whose next chunk lands raw in a staging area (16
// lanes and their two group scales a vector); and two chunks' key-row
// pointers (row, int8 scale row).
template <typename TC, int HD>
struct TcTile {
  static constexpr bool kInt8 = std::is_same<TC, int8_t>::value;
  static constexpr int kStride = 2 * HD + 16;          // bytes per key row
  static constexpr int kBuf = kChunk * kStride;        // one K or V buffer
  static constexpr int kKvBufs = kInt8 ? 1 : 2;        // chunks of K|V held
  static constexpr int kVecs = kChunk * 2 * HD / 16;   // int8 vectors a chunk
  static constexpr int kStage = kInt8 ? kVecs * (16 + 4) : 0;
  static constexpr int kPlan = 2 * kChunk * 2 * (int)sizeof(void*);
  static constexpr int kSmem = 2 * kKvBufs * kBuf + kStage + kPlan;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The key-chunk loader of both tensor-core bodies (K1 and K2), over the
// TcTile layout at `base`. A chunk's 64 key rows (and int8 scale rows)
// are looked up first, one key a thread (`set`, into one of two plan
// slots), so the copies wait on no page-table load; `issue` then copies
// the chunk's 16-byte vectors by cp.async, keys without a row as zeros:
// bf16 rows straight into K|V buffer `buf`, int8 rows (16 lanes) and
// their two group scales into this thread's own staging slots, which
// `dequant` turns into bf16 in K|V buffer 0 (int8 x bf16 scale rounded
// once, as the Pallas body's bf16 product) once they have landed.
template <typename TC, int HD>
struct TcChunk {
  using Tile = TcTile<TC, HD>;
  uint8_t* base;
  int shd;
  const void* dummy;  // a valid address for the zero-byte copies

  __device__ uint8_t* kv(int buf, int half) const {
    return base + (2 * buf + half) * Tile::kBuf;
  }
  __device__ uint8_t* st_raw() const { return base + 2 * Tile::kKvBufs * Tile::kBuf; }
  __device__ uint32_t* st_scale() const {
    return reinterpret_cast<uint32_t*>(st_raw() + Tile::kVecs * 16);
  }
  __device__ const TC** rows() const {
    return reinterpret_cast<const TC**>(st_raw() + Tile::kStage);
  }
  __device__ const __nv_bfloat16** srows() const {
    return reinterpret_cast<const __nv_bfloat16**>(rows() + 2 * kChunk);
  }
  __device__ void set(int slot, int t, const TC* row, const __nv_bfloat16* srow) const {
    rows()[slot * kChunk + t] = row;
    if constexpr (Tile::kInt8) srows()[slot * kChunk + t] = srow;
  }
  __device__ void issue(int slot, int buf) const {
    const int tid = threadIdx.x;
    if constexpr (!Tile::kInt8) {
      constexpr int kVec = HD / 8;          // vectors per half row
#pragma unroll
      for (int j = 0; j < kChunk * 2 * kVec / kTcThreads; ++j) {
        const int e = tid + j * kTcThreads;
        const int t = e / (2 * kVec), v = e % (2 * kVec);
        const int half = v / kVec, jj = v % kVec;
        const TC* row = rows()[slot * kChunk + t];
        cp_async16(smem_u32(kv(buf, half) + t * Tile::kStride + jj * 16),
                   row != nullptr ? (const void*)(row + half * shd + jj * 8) : dummy,
                   row != nullptr ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < Tile::kVecs / kTcThreads; ++j) {
        const int e = tid + j * kTcThreads;
        const int t = e / (HD / 8), v = e % (HD / 8);
        const int half = v / (HD / 16), jj = v % (HD / 16);
        const TC* row = rows()[slot * kChunk + t];
        const __nv_bfloat16* srow = srows()[slot * kChunk + t];
        const bool ok = row != nullptr;
        cp_async16(smem_u32(st_raw() + e * 16),
                   ok ? (const void*)(row + half * shd + jj * 16) : dummy, ok ? 16 : 0);
        cp_async4(smem_u32(st_scale() + e),
                  ok ? (const void*)(srow + half * (HD / kKvGroup) + 2 * jj) : dummy,
                  ok ? 4 : 0);
      }
    }
  }
  __device__ void dequant() const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int j = 0; j < Tile::kVecs / kTcThreads; ++j) {
      const int e = tid + j * kTcThreads;
      const int t = e / (HD / 8), v = e % (HD / 8);
      const int half = v / (HD / 16), jj = v % (HD / 16);
      float x[16];
      Vec16<int8_t>::unpack(*reinterpret_cast<const uint4*>(st_raw() + e * 16), x);
      const uint32_t sw = st_scale()[e];
      const float s0 = __uint_as_float(sw << 16);
      const float s1 = __uint_as_float(sw & 0xffff0000u);
      uint32_t pk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sc = i < 4 ? s0 : s1;
        pk[i] = pack_bf16(x[2 * i] * sc, x[2 * i + 1] * sc);
      }
      uint4* dst = reinterpret_cast<uint4*>(kv(0, half) + t * Tile::kStride + jj * 32);
      dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
  }
};

template <typename TC, int HD>
__global__ void __launch_bounds__(kTcThreads) paged_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scale, int scale_lanes,
    const int* __restrict__ page_table, const int* __restrict__ start_p,
    const int* __restrict__ newlen_p, const TC* __restrict__ fresh_kv,
    const __nv_bfloat16* __restrict__ fresh_scale,
    __nv_bfloat16* __restrict__ out, int Qp, int Hq, int KVH, int shd, int P,
    int ps, long long LS, long long lbase, int QB, float sm_scale,
    const float* __restrict__ slopes) {
  using Tile = TcTile<TC, HD>;
  constexpr bool kInt8 = Tile::kInt8;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  const int b = blockIdx.x, qb = blockIdx.y, h = blockIdx.z;
  const int G = Hq / KVH;
  const int R = QB * G;                     // live rows of this CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int start = start_p[b], new_len = newlen_p[b];
  const int ctx = start + new_len;
  const int qi0 = qb * QB;                  // first q index of the block
  const int q0 = start + qi0;               // its absolute position

  if (qi0 >= new_len) {      // an inactive q block: zeros, 16 bytes a store
    constexpr int kV = HD / 8;
    for (int e = tid; e < R * kV; e += kTcThreads) {
      const int r = e / kV, i = r / G;
      if (qi0 + i < Qp)
        reinterpret_cast<uint4*>(
            out + (((size_t)b * Qp + qi0 + i) * Hq + (size_t)h * G + r - i * G) * HD)[e % kV] =
            make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // this thread's rows 16*warp + g and 16*warp + g + 8; row r = i*G + g'
  // holds position q0 + i of q head h*G + g'
  bool inq[2], valid[2];
  int rpos[2];
  float slope[2];
  size_t orow[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 16 * warp + g + 8 * j;
    const int i = r / G, gg = r - i * G;
    inq[j] = r < R && qi0 + i < Qp;
    valid[j] = r < R && qi0 + i < new_len;
    rpos[j] = q0 + i;
    slope[j] = slopes != nullptr ? slopes[h * G + gg] : 0.f;
    orow[j] = (((size_t)b * Qp + qi0 + i) * Hq + (size_t)h * G + gg) * HD;
  }
  // the warp's last position: key groups past it are masked for all rows
  const int wpos_hi = q0 + (16 * warp + 15) / G;

  // A fragments of q, loaded once: q * hd^-0.5 rounded to bf16, as the
  // Pallas body scales and rounds q before its dot
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = j & 1;
      uint32_t v = 0;
      if (inq[row]) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            q + orow[row] + kk * 16 + (j >> 1) * 8 + 2 * tig);
        v = pack_bf16(__fmul_rn(__low2float(x), sm_scale),
                      __fmul_rn(__high2float(x), sm_scale));
      }
      qa[kk][j] = v;
    }

  const int lanes = 2 * shd;
  const TC* cache_h = cache + (size_t)h * LS * lanes;
  const TC* fresh_h = fresh_kv + ((size_t)b * KVH + h) * (size_t)Qp * lanes;
  const int head_off = h * 2 * (HD / kKvGroup);
  const ScaleRows cs{scale, scale_lanes, head_off};
  const ScaleRows fs{fresh_scale + (fresh_scale ? (size_t)b * Qp * scale_lanes : 0),
                     scale_lanes, head_off};
  const int* pt = page_table + (size_t)b * P;
  const int kv_hi = min(ctx, q0 + QB);      // causal bound of the block
  const int nch = (kv_hi + kChunk - 1) / kChunk;
  const TcChunk<TC, HD> ld{tc_smem, shd, cache};

  // The k|v row (and int8 scale row) of each key of the chunk at c0 into
  // plan slot `slot`: the fresh slab's row pos - start when pos >= start,
  // else the cache row of its slot; null past kv_hi
  auto plan = [&](int slot, int c0) {
    if (tid < kChunk) {
      const int pos = c0 + tid;
      const TC* row = nullptr;
      const __nv_bfloat16* srow = nullptr;
      if (pos < kv_hi) {
        if (pos >= start) {
          row = fresh_h + (size_t)(pos - start) * lanes;
          srow = fs.rows + (size_t)(pos - start) * fs.lanes + fs.head_off;
        } else {
          const int pidx = min(pos / ps, P - 1);
          const long long slot_id = lbase + (long long)pt[pidx] * ps + pos % ps;
          row = cache_h + (size_t)slot_id * lanes;
          srow = cs.rows + (size_t)slot_id * cs.lanes + cs.head_off;
        }
      }
      ld.set(slot, tid, row, srow);
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dt][r] = 0.f;

  plan(0, 0);
  __syncthreads();
  ld.issue(0, 0);
  cp_async_commit();
  if constexpr (kInt8) {
    cp_async_wait<0>();
    ld.dequant();
  }
  if (nch > 1) plan(1, kChunk);
  for (int ci = 0; ci < nch; ++ci) {
    const int c0 = ci * kChunk;
    const int buf = kInt8 ? 0 : ci & 1;
    const bool next = ci + 1 < nch;
    __syncthreads();                        // chunk ci and the next plan in place
    if (next) ld.issue((ci + 1) & 1, buf ^ 1);
    cp_async_commit();
    if constexpr (!kInt8) {
      cp_async_wait<1>();
      __syncthreads();
    }
    const uint8_t* ks = ld.kv(buf, 0);
    const uint8_t* vs = ld.kv(buf, 1);
    // live 16-key groups for this warp: below kv_hi and at or before its
    // rows' last position (warp-uniform); the rest of the chunk is masked
    const int kg_end = min(kv_hi - 1, wpos_hi) - c0;
    const int groups = kg_end < 0 ? 0 : min(4, (kg_end >> 4) + 1);

    // S = q k^T, f32 in registers: s[nt] is keys c0 + 8*nt .. +7
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
    auto qk = [&](auto ng) {
      constexpr int NG = decltype(ng)::value;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int nb = 0; nb < NG; ++nb) {
          uint32_t kf[4];
          const int key = 16 * nb + (lane >> 4) * 8 + (lane & 7);
          const int dim = 16 * kk + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(kf, smem_u32(ks + key * Tile::kStride + dim * 2));
          mma_bf16(s[2 * nb], qa[kk], kf[0], kf[1]);
          mma_bf16(s[2 * nb + 1], qa[kk], kf[2], kf[3]);
        }
    };
    switch (groups) {
      case 1: qk(std::integral_constant<int, 1>()); break;
      case 2: qk(std::integral_constant<int, 2>()); break;
      case 3: qk(std::integral_constant<int, 3>()); break;
      case 4: qk(std::integral_constant<int, 4>()); break;
      default: break;
    }
    // ALiBi (a separate f32 multiply and add), the mask, the online softmax
    uint32_t live = 0u;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = j >> 1;
        const int kp = c0 + 8 * nt + 2 * tig + (j & 1);
        float v = s[nt][j];
        if (slopes != nullptr) v = alibi_add(v, slope[row], kp);
        const bool ok = valid[row] && kp <= rpos[row] && kp < ctx;
        live |= (ok ? 1u : 0u) << (4 * nt + j);
        s[nt][j] = ok ? v : kNegInf;
        mx[row] = fmaxf(mx[row], s[nt][j]);
      }
    float alpha[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m[row], mx[row]);
      alpha[row] = expf(m[row] - m_new);
      m[row] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (live >> (4 * nt + j)) & 1u ? expf(s[nt][j] - m[j >> 1]) : 0.f;
        s[nt][j] = p;
        rs[j >> 1] += p;
      }
    // l holds this thread's share of the row sums (its quad adds them up
    // at the end); acc and l rescale by alpha
#pragma unroll
    for (int row = 0; row < 2; ++row) l[row] = l[row] * alpha[row] + rs[row];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
    // O += P V: P rounded to bf16 as the A fragment (the S accumulator's
    // layout is the A layout), V through ldmatrix.trans
    auto pv = [&](auto ng) {
      constexpr int NG = decltype(ng)::value;
#pragma unroll
      for (int kk = 0; kk < NG; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t vf[4];
          const int key = 16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7);
          const int dim = 16 * dp + (lane >> 4) * 8;
          ldmatrix_x4_trans(vf, smem_u32(vs + key * Tile::kStride + dim * 2));
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    };
    switch (groups) {
      case 1: pv(std::integral_constant<int, 1>()); break;
      case 2: pv(std::integral_constant<int, 2>()); break;
      case 3: pv(std::integral_constant<int, 3>()); break;
      case 4: pv(std::integral_constant<int, 4>()); break;
      default: break;
    }
    if (ci + 2 < nch) plan(ci & 1, c0 + 2 * kChunk);
    if constexpr (kInt8) {
      if (next) {
        __syncthreads();                    // every warp is done with chunk ci
        cp_async_wait<0>();
        ld.dequant();
      }
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
  }
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (!inq[row]) continue;
    const float den = fmaxf(l[row], 1e-30f);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + orow[row] + 8 * dt + 2 * tig) =
          __floats2bfloat162_rn(o[dt][2 * row] / den, o[dt][2 * row + 1] / den);
  }
}

// ------------------------------------------------- K1 tensor-core bf16 body

// Shared memory of K1's tensor-core body: the TcTile chunk buffers, then
// the A tile of q (16 rows of HD bf16, padded as the key rows are). After
// the key loop the chunk buffers hold the four warps' softmax states (m,
// l, acc for 16 rows) and the CTA's merged state.
template <typename TC, int HD>
struct DecTile {
  static constexpr int kWarps = kTcThreads / 32;
  static constexpr int kQ = TcTile<TC, HD>::kSmem;        // q tile offset
  static constexpr int kStates = (kWarps + 1) * 16 * (HD + 2) * (int)sizeof(float);
  static constexpr int kLoop = kQ + 16 * TcTile<TC, HD>::kStride;
  static constexpr int kSmem = kLoop > kStates ? kLoop : kStates;
};

// One CTA per (row b, kv head h, split z); the A tile's rows are the G
// query heads of h (rows >= G are zero and masked). Split z covers whole
// pages of the row's n cached tokens (pages [z*pps, (z+1)*pps), pps =
// ceil(ceil(n/ps) / S)); the tail rows join split S-1 as its last chunk.
// Warp w takes keys [16w, 16w+16) of every 64-key chunk and keeps its own
// online softmax; the warps' states merge in warp order. With S == 1 the
// CTA finishes the row; otherwise it writes its partial (acc [G][HD], m
// [G], l [G]) to `part` and the last of the row's S CTAs to arrive (a
// counter in `done`, zeroed by the caller) merges the S partials in split
// order. The finishing CTA adds the self-term and writes the row. Three
// CTAs fit a SM at every head dim (registers and shared memory), so the
// 7B and 13B grids at B = 8 (256 and 320 CTAs) run in one wave.
template <typename TC, int HD>
__global__ void __launch_bounds__(kTcThreads, 3) paged_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const TC* __restrict__ cache,
    const __nv_bfloat16* __restrict__ scale, int scale_lanes,
    const int* __restrict__ page_table, const int* __restrict__ ctx,
    const __nv_bfloat16* __restrict__ fk, const __nv_bfloat16* __restrict__ fv,
    __nv_bfloat16* __restrict__ out, int Hq, int KVH, int shd, int P, int ps,
    long long LS, long long lbase, float sm_scale, const TC* __restrict__ tkv,
    const __nv_bfloat16* __restrict__ tscale, const int* __restrict__ tlen,
    int J, int layer, const float* __restrict__ slopes, float* __restrict__ part,
    int* __restrict__ done) {
  using Tile = TcTile<TC, HD>;
  constexpr bool kInt8 = Tile::kInt8;
  constexpr int kWarps = DecTile<TC, HD>::kWarps;
  extern __shared__ __align__(16) uint8_t tc_smem[];
  __shared__ int last_split;
  const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;
  const int B = gridDim.x, S = gridDim.z;
  const int G = Hq / KVH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int ctx_t = ctx[b];
  __nv_bfloat16* orow = out + ((size_t)b * Hq + (size_t)h * G) * HD;
  if (ctx_t <= 0) {                         // a padding row: zeros, once
    if (z == 0)
      for (int e = tid; e < G * HD / 8; e += kTcThreads)
        reinterpret_cast<uint4*>(orow)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  // the tail rows of the block side buffer (0 outside block-tail mode);
  // the cache holds the n tokens before them, the current one is the
  // self-term
  const int tlen_raw = tkv != nullptr ? tlen[0] : 0;
  const int tl = tkv != nullptr ? max(0, min(tlen_raw, J)) : 0;
  const int n = max(ctx_t - 1 - tlen_raw, 0);
  const int npages = (n + ps - 1) / ps;
  const int pps = (npages + S - 1) / S;
  const int k0 = min(z * pps, npages) * ps;
  const int k1 = min(n, (z + 1) * pps * ps);
  const int n_page_ch = k1 > k0 ? (k1 - k0 + kChunk - 1) / kChunk : 0;
  const int nch = n_page_ch + (z == S - 1 && tl > 0 ? 1 : 0);

  const float* sl = slopes != nullptr ? slopes + (size_t)h * G : nullptr;
  bool inq[2];
  float slope[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = g + 8 * j;
    inq[j] = r < G;
    slope[j] = sl != nullptr && r < G ? sl[r] : 0.f;
  }
  // the A tile: q * hd^-0.5 rounded to bf16, as the Pallas body scales and
  // rounds q before its dot; rows past G zero. Its fragments come by
  // ldmatrix for every chunk, which keeps registers for three CTAs a SM.
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + (size_t)h * G) * HD;
  uint8_t* qs = tc_smem + DecTile<TC, HD>::kQ;
  for (int e = tid; e < 16 * HD / 2; e += kTcThreads) {
    const int r = e / (HD / 2), c = 2 * (e - r * (HD / 2));
    uint32_t v = 0;
    if (r < G) {
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(qh + r * HD + c);
      v = pack_bf16(__fmul_rn(__low2float(x), sm_scale), __fmul_rn(__high2float(x), sm_scale));
    }
    *reinterpret_cast<uint32_t*>(qs + r * Tile::kStride + c * 2) = v;
  }

  const int lanes = 2 * shd;
  const TC* cache_h = cache + (size_t)h * LS * lanes;
  const int head_off = h * 2 * (HD / kKvGroup);
  const int* pt = page_table + (size_t)b * P;
  // this (layer, row, head)'s tail rows and their scale rows
  const TC* trow = tkv == nullptr ? nullptr
      : tkv + (((size_t)layer * B + b) * KVH + h) * (size_t)J * lanes;
  const __nv_bfloat16* tsrow = tscale == nullptr ? nullptr
      : tscale + ((size_t)layer * B + b) * J * scale_lanes + head_off;
  const TcChunk<TC, HD> ld{tc_smem, shd, cache};

  // chunk ci's first key position and its key count
  auto chunk_at = [&](int ci, int& kpos0, int& cn) {
    if (ci < n_page_ch) {
      kpos0 = k0 + ci * kChunk;
      cn = min(kChunk, k1 - kpos0);
    } else {                                // the tail rows, after the n cached
      kpos0 = n;
      cn = tl;
    }
  };
  // the page-table entry of this thread's key of page chunk ci (0 when it
  // has none): loaded a chunk ahead of `plan`, which waits on it
  auto page_of = [&](int ci) {
    if (tid >= kChunk || ci >= n_page_ch) return 0;
    const int pos = k0 + ci * kChunk + tid;
    return pos < k1 ? pt[min(pos / ps, P - 1)] : 0;
  };
  auto plan = [&](int slot, int ci, int page) {
    if (tid < kChunk) {
      int kpos0, cn;
      chunk_at(ci, kpos0, cn);
      const TC* row = nullptr;
      const __nv_bfloat16* srow = nullptr;
      if (tid < cn) {
        if (ci < n_page_ch) {
          const int pos = kpos0 + tid;
          const long long slot_id = lbase + (long long)page * ps + pos % ps;
          row = cache_h + (size_t)slot_id * lanes;
          if constexpr (kInt8) srow = scale + (size_t)slot_id * scale_lanes + head_off;
        } else {
          row = trow + (size_t)tid * lanes;
          if constexpr (kInt8) srow = tsrow + (size_t)tid * scale_lanes;
        }
      }
      ld.set(slot, tid, row, srow);
    }
  };

  // this warp's online softmax over its keys: rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[dt][r] = 0.f;

  if (nch > 0) {
    const int page1 = page_of(1);
    plan(0, 0, page_of(0));
    __syncthreads();
    ld.issue(0, 0);
    cp_async_commit();
    if (nch > 1) plan(1, 1, page1);
    if constexpr (kInt8) {
      cp_async_wait<0>();
      ld.dequant();
    }
  }
  const int kw = 16 * warp;                 // this warp's first key of a chunk
  for (int ci = 0; ci < nch; ++ci) {
    const int buf = kInt8 ? 0 : ci & 1;
    const bool next = ci + 1 < nch;
    __syncthreads();                        // chunk ci and the next plan in place
    if (next) ld.issue((ci + 1) & 1, buf ^ 1);
    cp_async_commit();
    const int page2 = page_of(ci + 2);
    if constexpr (!kInt8) {
      cp_async_wait<1>();
      __syncthreads();
    }
    int kpos0, cn;
    chunk_at(ci, kpos0, cn);
    if (kw < cn) {                          // warp-uniform
      const uint8_t* ks = ld.kv(buf, 0);
      const uint8_t* vs = ld.kv(buf, 1);
      // S = q k^T over the warp's 16 keys: s[nt] holds keys kw + 8*nt ..
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t qa[4], kf[4];
        ldmatrix_x4(qa, smem_u32(qs + (lane & 15) * Tile::kStride +
                                 (16 * kk + (lane >> 4) * 8) * 2));
        const int key = kw + (lane >> 4) * 8 + (lane & 7);
        const int dim = 16 * kk + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(kf, smem_u32(ks + key * Tile::kStride + dim * 2));
        mma_bf16(s[0], qa, kf[0], kf[1]);
        mma_bf16(s[1], qa, kf[2], kf[3]);
      }
      // ALiBi (a separate f32 multiply and add), the mask, the online softmax
      uint32_t live = 0u;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = j >> 1;
          const int t = kw + 8 * nt + 2 * tig + (j & 1);
          float v = s[nt][j];
          if (sl != nullptr) v = alibi_add(v, slope[row], kpos0 + t);
          const bool ok = inq[row] && t < cn;
          live |= (ok ? 1u : 0u) << (4 * nt + j);
          s[nt][j] = ok ? v : kNegInf;
          mx[row] = fmaxf(mx[row], s[nt][j]);
        }
      float alpha[2];
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
        mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
        const float m_new = fmaxf(m[row], mx[row]);
        alpha[row] = expf(m[row] - m_new);
        m[row] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = (live >> (4 * nt + j)) & 1u ? expf(s[nt][j] - m[j >> 1]) : 0.f;
          s[nt][j] = p;
          rs[j >> 1] += p;
        }
#pragma unroll
      for (int row = 0; row < 2; ++row) l[row] = l[row] * alpha[row] + rs[row];
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }
      // O += P V: P rounded to bf16 (the Pallas body's p_exp.astype) as
      // the A fragment, V through ldmatrix.trans
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vf[4];
        const int key = kw + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int dim = 16 * dp + (lane >> 4) * 8;
        ldmatrix_x4_trans(vf, smem_u32(vs + key * Tile::kStride + dim * 2));
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    if (ci + 2 < nch) plan(ci & 1, ci + 2, page2);
    if constexpr (kInt8) {
      if (next) {
        __syncthreads();                    // every warp is done with chunk ci
        cp_async_wait<0>();
        ld.dequant();
      }
    }
  }

  // the warps' states, then their merge in warp order, over the chunk
  // buffers (every warp is past its last chunk, every copy has landed)
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 1);
    l[row] += __shfl_xor_sync(0xffffffffu, l[row], 2);
  }
  float* w_m = reinterpret_cast<float*>(tc_smem);   // [kWarps][16]
  float* w_l = w_m + kWarps * 16;                   // [kWarps][16]
  float* w_acc = w_l + kWarps * 16;                 // [kWarps][16][HD]
  float* st_m = w_acc + kWarps * 16 * HD;           // [16]: the CTA's state
  float* st_l = st_m + 16;
  float* st_acc = st_l + 16;                        // [16][HD]
  __syncthreads();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = warp * 16 + g + 8 * row;
    if (tig == 0) {
      w_m[r] = m[row];
      w_l[r] = l[row];
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      w_acc[r * HD + 8 * dt + 2 * tig] = o[dt][2 * row];
      w_acc[r * HD + 8 * dt + 2 * tig + 1] = o[dt][2 * row + 1];
    }
  }
  __syncthreads();
  // merge `ns` states (m at sm + i*sstride, l at sl_ + i*sstride, acc at
  // sa + i*astride), in order, into st_*; rows < G
  auto merge = [&](int ns, const float* sm, const float* sl_, const float* sa,
                   int sstride, int astride, bool global) {
    auto rd = [&](const float* p) { return global ? __ldcg(p) : *p; };
    for (int e = tid; e < G * HD; e += kTcThreads) {
      const int r = e / HD, d = e - r * HD;
      float mm = kNegInf;
      for (int i = 0; i < ns; ++i) mm = fmaxf(mm, rd(sm + i * sstride + r));
      float a = 0.f, ll = 0.f;
      for (int i = 0; i < ns; ++i) {
        const float w = expf(rd(sm + i * sstride + r) - mm);
        a = fmaf(rd(sa + (size_t)i * astride + e), w, a);
        ll = fmaf(rd(sl_ + i * sstride + r), w, ll);
      }
      st_acc[e] = a;
      if (d == 0) {
        st_m[r] = mm;
        st_l[r] = ll;
      }
    }
  };
  merge(kWarps, w_m, w_l, w_acc, 16, 16 * HD, false);
  __syncthreads();

  if (S > 1) {
    // this split's partial, then the last of the row's splits merges them
    const int pstride = G * (HD + 2);
    float* prow = part + ((size_t)b * KVH + h) * S * pstride;
    float* pz = prow + (size_t)z * pstride;
    for (int e = tid; e < G * HD; e += kTcThreads) pz[e] = st_acc[e];
    for (int r = tid; r < G; r += kTcThreads) {
      pz[G * HD + r] = st_m[r];
      pz[G * HD + G + r] = st_l[r];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_split = atomicAdd(done + (size_t)b * KVH + h, 1) == S - 1;
    __syncthreads();
    if (!last_split) return;
    __threadfence();
    merge(S, prow + G * HD, prow + G * HD + G, prow, pstride, pstride, true);
    __syncthreads();
  }

  // the self-term (the current token's k/v, not yet in the cache) in f32
  // with the unrounded q * hd^-0.5, at position n + tail_len
  const __nv_bfloat16* fkr = fk + ((size_t)b * KVH + h) * HD;
  const __nv_bfloat16* fvr = fv + ((size_t)b * KVH + h) * HD;
  for (int r = warp; r < G; r += kWarps) {
    float s = 0.f;
    for (int d = lane; d < HD; d += 32)
      s = fmaf(__bfloat162float(qh[r * HD + d]) * sm_scale, __bfloat162float(fkr[d]), s);
    s = warp_sum(s);
    if (sl != nullptr) s = alibi_add(s, sl[r], n + tlen_raw);
    const float m_old = st_m[r];
    const float m_new = fmaxf(m_old, s);
    const float alpha = expf(m_old - m_new);
    const float p = expf(s - m_new);
    const float den = fmaxf(st_l[r] * alpha + p, 1e-30f);
    for (int d = lane; d < HD; d += 32)
      orow[r * HD + d] = __float2bfloat16(
          (st_acc[r * HD + d] * alpha + p * __bfloat162float(fvr[d])) / den);
  }
}

// Everything a launch needs besides the kernel's own shapes.
struct Args {
  const void* q;
  const void* cache;
  const __nv_bfloat16* scale;
  int scale_lanes;
  const int* pt;
  void* out;
  int Hq, KVH, hd, shd, P, ps;
  long long LS, lbase;
  float sm_scale;
  const float* slopes;  // ALiBi slopes f32 [Hq], or null
  cudaStream_t stream;
};

template <typename T, typename TC>
int launch_decode(const Args& a, const int* ctx, const void* fk,
                  const void* fv, int B, int CH, const void* tkv,
                  const __nv_bfloat16* tscale, const int* tlen, int J,
                  int layer) {
  const int G = a.Hq / a.KVH;
  const size_t smem = sizeof(float) *
      ((size_t)G * a.hd + (size_t)CH * (2 * a.hd + 1) + (size_t)G * CH + 3 * G);
  cudaError_t err = allow_smem<paged_decode_kernel<T, TC>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, a.KVH);
  paged_decode_kernel<T, TC><<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const TC*)a.cache, a.scale, a.scale_lanes, a.pt, ctx,
      (const T*)fk, (const T*)fv, (T*)a.out, a.Hq, a.KVH, a.hd, a.shd, a.P,
      a.ps, a.LS, a.lbase, CH, a.sm_scale, (const TC*)tkv, tscale, tlen, J,
      layer, a.slopes);
  return (int)cudaGetLastError();
}

// K1's tensor-core body (bf16 q) on a (B, KVH, splits) grid
template <typename TC, int HD>
int launch_decode_tc(const Args& a, const int* ctx, const void* fk,
                     const void* fv, int B, const void* tkv,
                     const __nv_bfloat16* tscale, const int* tlen, int J,
                     int layer, int splits, float* part, int* done) {
  constexpr size_t smem = DecTile<TC, HD>::kSmem;
  const cudaError_t err = allow_smem<paged_decode_tc_kernel<TC, HD>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, a.KVH, splits);
  paged_decode_tc_kernel<TC, HD><<<grid, kTcThreads, smem, a.stream>>>(
      (const __nv_bfloat16*)a.q, (const TC*)a.cache, a.scale, a.scale_lanes,
      a.pt, ctx, (const __nv_bfloat16*)fk, (const __nv_bfloat16*)fv,
      (__nv_bfloat16*)a.out, a.Hq, a.KVH, a.shd, a.P, a.ps, a.LS, a.lbase,
      a.sm_scale, (const TC*)tkv, tscale, tlen, J, layer, a.slopes, part,
      done);
  return (int)cudaGetLastError();
}

template <typename TC>
int launch_decode_tc_by_hd(const Args& a, const int* ctx, const void* fk,
                           const void* fv, int B, const void* tkv,
                           const __nv_bfloat16* tscale, const int* tlen,
                           int J, int layer, int splits, float* part,
                           int* done) {
#define PPL_DECODE_CASE(HDV)                                                  \
  case HDV:                                                                   \
    return launch_decode_tc<TC, HDV>(a, ctx, fk, fv, B, tkv, tscale, tlen, J, \
                                     layer, splits, part, done);
  switch (a.hd) {
    PPL_DECODE_CASE(16)
    PPL_DECODE_CASE(32)
    PPL_DECODE_CASE(64)
    PPL_DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PPL_DECODE_CASE
}

template <typename T, typename TC, int HD>
int launch_prefill_hd(const Args& a, const int* start, const int* new_len,
                      const void* fresh, const __nv_bfloat16* fresh_scale,
                      int Bp, int Qp) {
  const int G = a.Hq / a.KVH;
  const int QB = kRows / G;
  const size_t smem = sizeof(float) *
      ((size_t)kRows * HD + (size_t)kChunk * (2 * HD + 1) +
       (size_t)kRows * (kChunk + 1) + 3 * kRows);
  cudaError_t err = allow_smem<paged_prefill_kernel<T, TC, HD>>(smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Bp, (Qp + QB - 1) / QB, a.KVH);
  paged_prefill_kernel<T, TC, HD><<<grid, kThreads, smem, a.stream>>>(
      (const T*)a.q, (const TC*)a.cache, a.scale, a.scale_lanes, a.pt, start,
      new_len, (const TC*)fresh, fresh_scale, (T*)a.out, Qp, a.Hq, a.KVH,
      a.shd, a.P, a.ps, a.LS, a.lbase, QB, a.sm_scale, a.slopes);
  return (int)cudaGetLastError();
}

// the SIMT body for f32 q, or (TC = bf16 / int8 cache, bf16 q) the
// tensor-core body, at the head dim of the call
template <template <typename, int> class Launch, typename TC>
int launch_prefill_by_hd(const Args& a, const int* start, const int* new_len,
                         const void* fresh, const __nv_bfloat16* fresh_scale,
                         int Bp, int Qp) {
#define PPL_PREFILL_CASE(HDV)                                                   \
  case HDV:                                                                     \
    return Launch<TC, HDV>::run(a, start, new_len, fresh, fresh_scale, Bp, Qp);
  switch (a.hd) {
    PPL_PREFILL_CASE(16)
    PPL_PREFILL_CASE(32)
    PPL_PREFILL_CASE(64)
    PPL_PREFILL_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PPL_PREFILL_CASE
}

template <typename TC, int HD>
struct LaunchSimtF32 {
  static int run(const Args& a, const int* start, const int* new_len,
                 const void* fresh, const __nv_bfloat16* fresh_scale, int Bp,
                 int Qp) {
    return launch_prefill_hd<float, TC, HD>(a, start, new_len, fresh,
                                            fresh_scale, Bp, Qp);
  }
};

template <typename TC, int HD>
struct LaunchTc {
  static int run(const Args& a, const int* start, const int* new_len,
                 const void* fresh, const __nv_bfloat16* fresh_scale, int Bp,
                 int Qp) {
    const int QB = kRows / (a.Hq / a.KVH);
    constexpr size_t smem = TcTile<TC, HD>::kSmem;
    const cudaError_t err = allow_smem<paged_prefill_tc_kernel<TC, HD>>(smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(Bp, (Qp + QB - 1) / QB, a.KVH);
    paged_prefill_tc_kernel<TC, HD><<<grid, kTcThreads, smem, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const TC*)a.cache, a.scale, a.scale_lanes,
        a.pt, start, new_len, (const TC*)fresh, fresh_scale,
        (__nv_bfloat16*)a.out, Qp, a.Hq, a.KVH, a.shd, a.P, a.ps, a.LS,
        a.lbase, QB, a.sm_scale, a.slopes);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Plain C interface (loaded with ctypes). dtype (of q, the output and the
// decode self-term): 0 = float32, 1 = bfloat16. quant: 0 = the cache has
// q's dtype, 1 = int8 cache with bf16 scale rows. Every function returns
// the cudaError_t of its launch (0 = success). Decode in block-tail mode
// takes the side buffer tail_kv (and its scale rows tail_scale when int8),
// J rows per (layer, row, head), and the device count tail_len; tail_kv
// null is the plain deferred mode. slopes: ALiBi slopes f32 [Hq] on the
// device, or null for none. Decode with bf16 q splits each row's context
// over `splits` CTAs; with splits > 1 it needs `part`, f32 [B*KVH*splits*
// G*(hd+2)], and `done`, int32 [B*KVH] zeroed (f32 q ignores all three).
extern "C" {

int ppl_paged_decode_attention(int dtype, int quant, const void* q,
                               const void* cache, const void* scale,
                               int scale_lanes, const int* page_table,
                               const int* ctx, const void* fresh_k,
                               const void* fresh_v, void* out, int B, int Hq,
                               int KVH, int hd, int shd, int P, int page_size,
                               long long ls_rows, int layer,
                               long long num_slots, int chunk, float sm_scale,
                               const void* tail_kv, const void* tail_scale,
                               const int* tail_len, int J,
                               const float* slopes, int splits, void* part,
                               void* done, void* stream) {
  const Args a{q, cache, (const __nv_bfloat16*)scale, scale_lanes, page_table,
               out, Hq, KVH, hd, shd, P, page_size, ls_rows,
               (long long)layer * num_slots, sm_scale, slopes,
               (cudaStream_t)stream};
  const __nv_bfloat16* ts = (const __nv_bfloat16*)tail_scale;
  if (dtype == 0)
    return quant ? launch_decode<float, int8_t>(a, ctx, fresh_k, fresh_v, B, chunk,
                                                tail_kv, ts, tail_len, J, layer)
                 : launch_decode<float, float>(a, ctx, fresh_k, fresh_v, B, chunk,
                                               tail_kv, ts, tail_len, J, layer);
  if (splits < 1 || (splits > 1 && (part == nullptr || done == nullptr)))
    return (int)cudaErrorInvalidValue;
  return quant
      ? launch_decode_tc_by_hd<int8_t>(a, ctx, fresh_k, fresh_v, B, tail_kv, ts,
                                       tail_len, J, layer, splits, (float*)part,
                                       (int*)done)
      : launch_decode_tc_by_hd<__nv_bfloat16>(a, ctx, fresh_k, fresh_v, B, tail_kv,
                                              ts, tail_len, J, layer, splits,
                                              (float*)part, (int*)done);
}

int ppl_paged_prefill_attention(int dtype, int quant, const void* q,
                                const void* cache, const void* scale,
                                int scale_lanes, const int* page_table,
                                const int* start, const int* new_len,
                                const void* fresh_kv, const void* fresh_scale,
                                void* out, int Bp, int Qp, int Hq, int KVH,
                                int hd, int shd, int P, int page_size,
                                long long ls_rows, int layer,
                                long long num_slots, float sm_scale,
                                const float* slopes, void* stream) {
  const Args a{q, cache, (const __nv_bfloat16*)scale, scale_lanes, page_table,
               out, Hq, KVH, hd, shd, P, page_size, ls_rows,
               (long long)layer * num_slots, sm_scale, slopes,
               (cudaStream_t)stream};
  const __nv_bfloat16* fs = (const __nv_bfloat16*)fresh_scale;
  // f32 q runs the SIMT body (the tensor cores take no f32, and TF32 would
  // break the f32 tolerance); bf16 q runs the tensor-core body
  if (dtype == 0)
    return quant
        ? launch_prefill_by_hd<LaunchSimtF32, int8_t>(a, start, new_len, fresh_kv, fs, Bp, Qp)
        : launch_prefill_by_hd<LaunchSimtF32, float>(a, start, new_len, fresh_kv, fs, Bp, Qp);
  return quant
      ? launch_prefill_by_hd<LaunchTc, int8_t>(a, start, new_len, fresh_kv, fs, Bp, Qp)
      : launch_prefill_by_hd<LaunchTc, __nv_bfloat16>(a, start, new_len, fresh_kv, fs, Bp, Qp);
}

}  // extern "C"
