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
// w [C, D, N], scale [C, N] -> [C, T, N] with gridDim.z = C.
//
// What bounds it on an H100: at decode sizes (T <= 64) bytes -- the int8
// weight is read once, D*N bytes per call, against 2*T*D*N operations;
// at prefill sizes (T ~ 1024) operations, against the 1,979 TOP/s of the
// int8 tensor cores.
//
// First design (simple and correct, not yet fast): a quantize pass (one
// block per row: absmax reduction, int8 row, f32 scale), then a SIMT
// GEMM on __dp4a. Each CTA stages a [BM, 64] int8 x tile and a [64, BN]
// weight tile in shared memory; the weight tile is transposed on the way
// in (4x4 byte blocks through __byte_perm) so each dp4a reads four
// consecutive k of one output column. Each thread accumulates a TM x TN
// int32 tile. No tensor cores (mma.sync/wgmma s8), no cp.async/TMA
// pipelining and no split-K yet: at decode sizes the grid has only N/BN
// CTAs per weight, too few to stream the weight at full rate, and at
// prefill sizes dp4a runs far below the tensor-core rate. Both are work
// for later PRs.
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

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

constexpr int kQuantThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kQuantThreads) quantize_rows_kernel(
    const T* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ xs,
    int D) {
  __shared__ float red[kQuantThreads / 32];
  const int t = blockIdx.x;
  const T* row = x + (size_t)t * D;
  float amax = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) amax = fmaxf(amax, fabsf(to_f(row[d])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) amax = fmaxf(amax, red[i]);
  const float scale = amax / 127.0f;
  const float inv = scale > 0.f ? 1.0f / fmaxf(scale, 1e-10f) : 0.f;
  int8_t* qrow = xq + (size_t)t * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = rintf(to_f(row[d]) * inv);
    qrow[d] = (int8_t)fminf(fmaxf(v, -127.f), 127.f);
  }
  if (threadIdx.x == 0) xs[t] = scale;
}

constexpr int kGemmThreads = 256;
constexpr int kBK = 64;        // contraction bytes per stage
constexpr int kKW = kBK / 4;   // int32 words per stage row

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

template <int BM, int BN, int TM, int TN, typename TO>
__global__ void __launch_bounds__(kGemmThreads) i8i8_gemm_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ w, const float* __restrict__ ws,
    TO* __restrict__ out, int T, int D, int N) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "thread tiling");
  __shared__ int x_s[BM][kKW + 1];
  __shared__ int w_s[BN][kKW + 1];
  const int c = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int8_t* wc = w + (size_t)c * D * N;
  const int tid = threadIdx.x;
  constexpr int kNT = BN / TN;
  const int tn = tid % kNT, tm = tid / kNT;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    for (int e = tid; e < BM * kKW; e += kGemmThreads) {
      const int m = e / kKW, kw = e - m * kKW;
      const int k = k0 + 4 * kw;
      int v = 0;
      if (m0 + m < T && k < D)
        v = *reinterpret_cast<const int*>(xq + (size_t)(m0 + m) * D + k);
      x_s[m][kw] = v;
    }
    for (int e = tid; e < kKW * (BN / 4); e += kGemmThreads) {
      const int kb = e / (BN / 4), nb = e - kb * (BN / 4);
      const int k = k0 + 4 * kb, n = n0 + 4 * nb;
      int r[4] = {0, 0, 0, 0};
      if (n < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + i < D)
            r[i] = *reinterpret_cast<const int*>(wc + (size_t)(k + i) * N + n);
      }
      int col[4];
      transpose4x4(r[0], r[1], r[2], r[3], col);
#pragma unroll
      for (int i = 0; i < 4; ++i) w_s[4 * nb + i][kb] = col[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kKW; ++kw) {
      int a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = x_s[tm + i * (BM / TM)][kw];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = w_s[tn + j * kNT][kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  TO* oc = out + (size_t)c * T * N;
  const float* wsc = ws + (size_t)c * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i * (BM / TM);
    if (m >= T) continue;
    const float sx = xs[m];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn + j * kNT;
      if (n < N) oc[(size_t)m * N + n] = from_f<TO>((float)acc[i][j] * (sx * wsc[n]));
    }
  }
}

template <int BM, int BN, int TM, int TN, typename TO>
void launch_gemm(const int8_t* xq, const float* xs, const int8_t* w,
                 const float* ws, void* out, int T, int D, int N, int C,
                 cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (T + BM - 1) / BM, C);
  i8i8_gemm_kernel<BM, BN, TM, TN, TO><<<grid, kGemmThreads, 0, s>>>(
      xq, xs, w, ws, (TO*)out, T, D, N);
}

template <typename TO>
void launch_gemm_for(const int8_t* xq, const float* xs, const int8_t* w,
                     const float* ws, void* out, int T, int D, int N, int C,
                     cudaStream_t s) {
  if (T <= 16)
    launch_gemm<16, 32, 1, 2, TO>(xq, xs, w, ws, out, T, D, N, C, s);
  else
    launch_gemm<64, 64, 4, 4, TO>(xq, xs, w, ws, out, T, D, N, C, s);
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

int ppl_i8i8_quantize_rows(int x_dtype, const void* x, int8_t* xq, float* xs,
                           int T, int D, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    quantize_rows_kernel<float><<<T, kQuantThreads, 0, s>>>((const float*)x, xq, xs, D);
  else
    quantize_rows_kernel<__nv_bfloat16><<<T, kQuantThreads, 0, s>>>(
        (const __nv_bfloat16*)x, xq, xs, D);
  return (int)cudaGetLastError();
}

int ppl_i8i8_gemm(int out_dtype, const int8_t* xq, const float* xs,
                  const int8_t* w, const float* ws, void* out, int T, int D,
                  int N, int C, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0)
    launch_gemm_for<float>(xq, xs, w, ws, out, T, D, N, C, s);
  else
    launch_gemm_for<__nv_bfloat16>(xq, xs, w, ws, out, T, D, N, C, s);
  return (int)cudaGetLastError();
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
