// The ConvNeXt MLP-tail kernels (see convnext_mlp.cu for what they
// compute, what they replace and their design): the templates, shared by
// the two translation units that instantiate them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kHC = 64;  // hidden units per chunk
constexpr float kRsqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Operand policy: the type operands are kept in, and one K-step of a 16x16
// product (acc += A[16 x KS] . B[KS x 16]) with B in layout LB.
template <bool BF16>
struct Op;

template <>
struct Op<true> {
  typedef bf16 T;
  static constexpr int KS = 16;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
  __device__ static T cvt(float v) { return __float2bfloat16(v); }
  template <class LB>
  __device__ static void mma(Acc& c, const T* a, int lda, const T* b,
                             int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
};

template <>
struct Op<false> {
  typedef float T;
  static constexpr int KS = 8;
  typedef wmma::fragment<wmma::accumulator, 16, 16, 8, float> Acc;
  __device__ static T cvt(float v) { return v; }
  template <class F>
  __device__ static void split(F& hi, F& lo) {
#pragma unroll
    for (int i = 0; i < hi.num_elements; ++i) {
      const float v = hi.x[i];
      const float h = wmma::__float_to_tf32(v);
      hi.x[i] = h;
      lo.x[i] = wmma::__float_to_tf32(v - h);
    }
  }
  template <class LB>
  __device__ static void mma(Acc& c, const T* a, int lda, const T* b,
                             int ldb) {
    wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32,
                   wmma::row_major>
        ah, al;
    wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, LB> bh,
        bl;
    wmma::load_matrix_sync(ah, a, lda);
    wmma::load_matrix_sync(bh, b, ldb);
    split(ah, al);
    split(bh, bl);
    wmma::mma_sync(c, al, bh, c);  // small terms first
    wmma::mma_sync(c, ah, bl, c);
    wmma::mma_sync(c, ah, bh, c);
  }
};

// Token tiles: 64 rows, 32 in the backward at C >= 256 so its shared
// memory (u, gamma*dy, xhat, three hidden chunks) fits the 227 KB.
template <int C, bool BWD>
struct Tile {
  static constexpr int TM = (BWD && C >= 256) ? 32 : 64;
  static constexpr int NT = C / 16;                   // 16-wide column tiles
  static constexpr int NQ = (TM / 16) * NT / kWarps;  // accumulators / warp
  static constexpr int NT1 = (TM / 16) * (kHC / 16) / kWarps;  // chunk tiles
  static_assert(C % 32 == 0, "C must be a multiple of 32");
  static_assert((TM / 16) * NT % kWarps == 0, "tiles must split over warps");
  static_assert((TM / 16) * (kHC / 16) % kWarps == 0, "chunk tiles too");
};

// acc += A[16 x K] . B[K x 16], A row-major in shared memory, B in layout
// LB. Each 64-long slice of K accumulates in a fresh fragment that is then
// added to acc in f32 with round-to-nearest: the tensor cores' f32
// accumulation does not round to nearest, and over a long K its error
// would pile up past the float32 bounds.
template <bool BF16, class LB, int K>
__device__ __forceinline__ void gemm_k(typename Op<BF16>::Acc& acc,
                                       const typename Op<BF16>::T* a,
                                       int lda,
                                       const typename Op<BF16>::T* b,
                                       int ldb) {
  typedef Op<BF16> O;
  constexpr int KS = O::KS;
  const int64_t bstep =
      std::is_same<LB, wmma::col_major>::value ? KS : (int64_t)KS * ldb;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 64) {
    typename O::Acc t;
    wmma::fill_fragment(t, 0.0f);
#pragma unroll
    for (int k = k0; k < k0 + 64 && k < K; k += KS)
      O::template mma<LB>(t, a + k, lda, b + (k / KS) * bstep, ldb);
#pragma unroll
    for (int i = 0; i < t.num_elements; ++i) acc.x[i] += t.x[i];
  }
}

template <int C, bool BF16>
constexpr size_t fwd_smem() {
  // [TM][C] operand u (aliased by the [TM][C] f32 output stage), [TM][kHC]
  // f32 h, [TM][kHC] operand gelu(h)
  return (size_t)Tile<C, false>::TM *
         (C * 4 + kHC * 4 + kHC * sizeof(typename Op<BF16>::T));
}

template <int C, bool BF16>
constexpr size_t bwd_smem() {
  // [TM][C] operands u and gamma*dy (aliased by the f32 du stage), [TM][C]
  // f32 xhat, [TM] 1/sigma, [TM][kHC] f32 h and da, [TM][kHC] operand dh
  typedef typename Op<BF16>::T T;
  return (size_t)Tile<C, true>::TM *
         (2 * C * sizeof(T) + C * 4 + 4 + 2 * kHC * 4 + kHC * sizeof(T));
}

// LayerNorm of token row `row` of x (one warp): u = xhat * ls + lb as the
// operand type; optionally xhat and 1/sigma.
template <int C, bool BF16>
__device__ __forceinline__ void ln_row(const float* __restrict__ x,
                                       const float* __restrict__ ls,
                                       const float* __restrict__ lb,
                                       int64_t row, int64_t n,
                                       typename Op<BF16>::T* ur, float* xh,
                                       float* inv_out) {
  typedef Op<BF16> O;
  const int lane = threadIdx.x % 32;
  constexpr int V = C / 32;
  if (row >= n) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ur[lane + 32 * i] = O::cvt(0.0f);
      if (xh) xh[lane + 32 * i] = 0.0f;
    }
    if (inv_out && lane == 0) *inv_out = 0.0f;
    return;
  }
  const float* xr = x + row * C;
  float v[V];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = xr[lane + 32 * i];
    s += v[i];
  }
  const float mean = warp_sum(s) / C;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] -= mean;
    q += v[i] * v[i];
  }
  const float inv = rsqrtf(warp_sum(q) / C + 1e-6f);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    const float xhat = v[i] * inv;
    ur[c] = O::cvt(xhat * ls[c] + lb[c]);
    if (xh) xh[c] = xhat;
  }
  if (inv_out && lane == 0) *inv_out = inv;
}

// Forward: out = gamma * (gelu(u.W1^T + b1).W2^T + b2), u = LN(x).
// w1: (4C, C) (torch Linear layout), w2: (C, 4C), in the operand type.
template <int C, bool BF16, bool SAVE_H>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tail_fwd_kernel(const float* __restrict__ x, const float* __restrict__ ls,
                    const float* __restrict__ lb,
                    const typename Op<BF16>::T* __restrict__ w1,
                    const float* __restrict__ b1,
                    const typename Op<BF16>::T* __restrict__ w2,
                    const float* __restrict__ b2,
                    const float* __restrict__ gamma, float* __restrict__ out,
                    float* __restrict__ h_out, int64_t n) {
  typedef Op<BF16> O;
  typedef typename O::T T;
  typedef Tile<C, false> TL;
  constexpr int TM = TL::TM, HID = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);                       // [TM][C]
  float* stage = reinterpret_cast<float*>(smem);            // [TM][C]
  float* hs = reinterpret_cast<float*>(smem + (size_t)TM * C * 4);
  T* gs = reinterpret_cast<T*>(hs + TM * kHC);              // [TM][kHC]
  const int warp = threadIdx.x / 32;
  const int64_t r0 = (int64_t)blockIdx.x * TM;

  for (int r = warp; r < TM; r += kWarps)
    ln_row<C, BF16>(x, ls, lb, r0 + r, n, us + r * C, nullptr, nullptr);
  typename O::Acc acc[TL::NQ];
#pragma unroll
  for (int q = 0; q < TL::NQ; ++q) wmma::fill_fragment(acc[q], 0.0f);
  __syncthreads();

  for (int j0 = 0; j0 < HID; j0 += kHC) {
    // h chunk = u . W1[j0:j0+HC]^T
#pragma unroll
    for (int tt = 0; tt < TL::NT1; ++tt) {
      const int tile = warp + tt * kWarps;
      const int mt = tile / (kHC / 16), nt = tile % (kHC / 16);
      typename O::Acc hc;
      wmma::fill_fragment(hc, 0.0f);
      gemm_k<BF16, wmma::col_major, C>(hc, us + mt * 16 * C, C,
                                       w1 + (int64_t)(j0 + nt * 16) * C, C);
      wmma::store_matrix_sync(hs + mt * 16 * kHC + nt * 16, hc, kHC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TM * kHC; i += kThreads) {
      const float hv = hs[i] + b1[j0 + i % kHC];
      if (SAVE_H) {
        const int64_t row = r0 + i / kHC;
        if (row < n) h_out[row * HID + j0 + i % kHC] = hv;
      }
      gs[i] = O::cvt(0.5f * hv * (1.0f + erff(hv * kRsqrt2)));
    }
    __syncthreads();
    // acc += gelu(h) . W2[:, j0:j0+HC]^T
#pragma unroll
    for (int q = 0; q < TL::NQ; ++q) {
      const int p = warp + q * kWarps;
      const int mt = p / TL::NT, nt = p % TL::NT;
      gemm_k<BF16, wmma::col_major, kHC>(
          acc[q], gs + mt * 16 * kHC, kHC,
          w2 + (int64_t)(nt * 16) * HID + j0, HID);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < TL::NQ; ++q) {
    const int p = warp + q * kWarps;
    const int mt = p / TL::NT, nt = p % TL::NT;
    wmma::store_matrix_sync(stage + mt * 16 * C + nt * 16, acc[q], C,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TM * C; i += kThreads) {
    const int64_t row = r0 + i / C;
    if (row >= n) break;
    const int c = i % C;
    out[row * C + c] = gamma[c] * (stage[i] + b2[c]);
  }
}

// Backward: dx = LNbwd((gamma dy) -> W2 -> GELU' -> W1 chain).
//   per chunk: h = u.W1^T + b1 (or read), da = (gamma dy).W2[:, chunk],
//              dh = da * (Phi(h) + h phi(h)), du += dh.W1[chunk]
//   dxhat = du * ls; dx = inv * (dxhat - mean(dxhat)
//                                - xhat * mean(dxhat * xhat))
template <int C, bool BF16, bool READ_H>
__global__ void __launch_bounds__(kThreads, 1)
mlp_tail_bwd_kernel(const float* __restrict__ x,
                    const float* __restrict__ h_in,
                    const float* __restrict__ gout,
                    const float* __restrict__ ls, const float* __restrict__ lb,
                    const typename Op<BF16>::T* __restrict__ w1,
                    const float* __restrict__ b1,
                    const typename Op<BF16>::T* __restrict__ w2,
                    const float* __restrict__ gamma, float* __restrict__ dx,
                    int64_t n) {
  typedef Op<BF16> O;
  typedef typename O::T T;
  typedef Tile<C, true> TL;
  constexpr int TM = TL::TM, HID = 4 * C;
  extern __shared__ __align__(128) unsigned char smem[];
  T* us = reinterpret_cast<T*>(smem);                    // [TM][C]
  T* gms = us + TM * C;                                  // [TM][C]
  float* stage = reinterpret_cast<float*>(smem);         // [TM][C] (alias)
  float* xh = reinterpret_cast<float*>(gms + TM * C);    // [TM][C]
  float* invs = xh + TM * C;                             // [TM]
  float* hs = invs + TM;                                 // [TM][kHC]
  float* das = hs + TM * kHC;                            // [TM][kHC]
  T* dhs = reinterpret_cast<T*>(das + TM * kHC);         // [TM][kHC]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t r0 = (int64_t)blockIdx.x * TM;

  for (int r = warp; r < TM; r += kWarps)
    ln_row<C, BF16>(x, ls, lb, r0 + r, n, us + r * C, xh + r * C,
                    invs + r);
  for (int i = threadIdx.x; i < TM * C; i += kThreads) {
    const int64_t row = r0 + i / C;
    const int c = i % C;
    gms[i] = O::cvt(row < n ? gout[row * C + c] * gamma[c] : 0.0f);
  }
  typename O::Acc acc[TL::NQ];
#pragma unroll
  for (int q = 0; q < TL::NQ; ++q) wmma::fill_fragment(acc[q], 0.0f);
  __syncthreads();

  for (int j0 = 0; j0 < HID; j0 += kHC) {
#pragma unroll
    for (int tt = 0; tt < TL::NT1; ++tt) {
      const int tile = warp + tt * kWarps;
      const int mt = tile / (kHC / 16), nt = tile % (kHC / 16);
      if (!READ_H) {
        typename O::Acc hc;
        wmma::fill_fragment(hc, 0.0f);
        gemm_k<BF16, wmma::col_major, C>(hc, us + mt * 16 * C, C,
                                         w1 + (int64_t)(j0 + nt * 16) * C,
                                         C);
        wmma::store_matrix_sync(hs + mt * 16 * kHC + nt * 16, hc, kHC,
                                wmma::mem_row_major);
      }
      typename O::Acc dc;
      wmma::fill_fragment(dc, 0.0f);
      gemm_k<BF16, wmma::row_major, C>(dc, gms + mt * 16 * C, C,
                                       w2 + j0 + nt * 16, HID);
      wmma::store_matrix_sync(das + mt * 16 * kHC + nt * 16, dc, kHC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TM * kHC; i += kThreads) {
      float hv;
      if (READ_H) {
        const int64_t row = r0 + i / kHC;
        hv = row < n ? h_in[row * HID + j0 + i % kHC] : 0.0f;
      } else {
        hv = hs[i] + b1[j0 + i % kHC];
      }
      const float cdf = 0.5f * (1.0f + erff(hv * kRsqrt2));
      const float pdf = kInvSqrt2Pi * expf(-0.5f * hv * hv);
      dhs[i] = O::cvt(das[i] * (cdf + hv * pdf));
    }
    __syncthreads();
    // du += dh . W1[j0:j0+HC, :]
#pragma unroll
    for (int q = 0; q < TL::NQ; ++q) {
      const int p = warp + q * kWarps;
      const int mt = p / TL::NT, nt = p % TL::NT;
      gemm_k<BF16, wmma::row_major, kHC>(
          acc[q], dhs + mt * 16 * kHC, kHC, w1 + (int64_t)j0 * C + nt * 16,
          C);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < TL::NQ; ++q) {
    const int p = warp + q * kWarps;
    const int mt = p / TL::NT, nt = p % TL::NT;
    wmma::store_matrix_sync(stage + mt * 16 * C + nt * 16, acc[q], C,
                            wmma::mem_row_major);
  }
  __syncthreads();
  // LayerNorm backward, one warp per token
  for (int r = warp; r < TM; r += kWarps) {
    const int64_t row = r0 + r;
    if (row >= n) break;
    const float* du = stage + r * C;
    const float* xr = xh + r * C;
    float s1 = 0.0f, s2 = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = du[c] * ls[c];
      s1 += d;
      s2 += d * xr[c];
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    const float iv = invs[r];
    for (int c = lane; c < C; c += 32)
      dx[row * C + c] = iv * (du[c] * ls[c] - s1 - xr[c] * s2);
  }
}

template <int C, bool BF16, bool SAVE_H>
int launch_fwd(const float* x, const float* ls, const float* lb,
               const void* w1, const float* b1, const void* w2,
               const float* b2, const float* gamma, float* out, float* h,
               int64_t n, cudaStream_t stream) {
  typedef typename Op<BF16>::T T;
  auto kernel = mlp_tail_fwd_kernel<C, BF16, SAVE_H>;
  const size_t smem = fwd_smem<C, BF16>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int TM = Tile<C, false>::TM;
  kernel<<<(unsigned)((n + TM - 1) / TM), kThreads, smem, stream>>>(
      x, ls, lb, (const T*)w1, b1, (const T*)w2, b2, gamma, out, h, n);
  return (int)cudaGetLastError();
}

template <int C, bool BF16, bool READ_H>
int launch_bwd(const float* x, const float* h, const float* gout,
               const float* ls, const float* lb, const void* w1,
               const float* b1, const void* w2, const float* gamma,
               float* dx, int64_t n, cudaStream_t stream) {
  typedef typename Op<BF16>::T T;
  auto kernel = mlp_tail_bwd_kernel<C, BF16, READ_H>;
  const size_t smem = bwd_smem<C, BF16>();
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int TM = Tile<C, true>::TM;
  kernel<<<(unsigned)((n + TM - 1) / TM), kThreads, smem, stream>>>(
      x, h, gout, ls, lb, (const T*)w1, b1, (const T*)w2, gamma, dx, n);
  return (int)cudaGetLastError();
}

#define ROBSEG_MLP_WIDTHS(X) X(96) X(128) X(192) X(256) X(384)


// Width dispatch for one operand type (h: save it in the forward, read it
// in the backward, when not null).
template <bool BF16>
int dispatch_fwd(const float* x, const float* ls, const float* lb,
                 const void* w1, const float* b1, const void* w2,
                 const float* b2, const float* gamma, float* out, float* h,
                 int64_t n, int C, cudaStream_t s) {
  switch (C) {
#define X(W)                                                              \
  case W:                                                                 \
    return h ? launch_fwd<W, BF16, true>(x, ls, lb, w1, b1, w2, b2, gamma, \
                                         out, h, n, s)                    \
             : launch_fwd<W, BF16, false>(x, ls, lb, w1, b1, w2, b2,      \
                                          gamma, out, h, n, s);
    ROBSEG_MLP_WIDTHS(X)
#undef X
    default:
      return -1;
  }
}

template <bool BF16>
int dispatch_dx(const float* x, const float* h, const float* gout,
                const float* ls, const float* lb, const void* w1,
                const float* b1, const void* w2, const float* gamma,
                float* dx, int64_t n, int C, cudaStream_t s) {
  switch (C) {
#define X(W)                                                               \
  case W:                                                                  \
    return h ? launch_bwd<W, BF16, true>(x, h, gout, ls, lb, w1, b1, w2,   \
                                         gamma, dx, n, s)                  \
             : launch_bwd<W, BF16, false>(x, h, gout, ls, lb, w1, b1, w2,  \
                                          gamma, dx, n, s);
    ROBSEG_MLP_WIDTHS(X)
#undef X
    default:
      return -1;
  }
}

}  // namespace

// One translation unit per operand type, so that nvcc compiles them in
// parallel: convnext_mlp.cu (bf16) and convnext_mlp_f32.cu (float32).
#define ROBSEG_MLP_DECLARE(SUFFIX)                                          \
  int robseg_mlp_fwd_##SUFFIX(const float* x, const float* ls,              \
                              const float* lb, const void* w1,              \
                              const float* b1, const void* w2,              \
                              const float* b2, const float* gamma,          \
                              float* out, float* h, int64_t n, int C,       \
                              cudaStream_t s);                              \
  int robseg_mlp_dx_##SUFFIX(const float* x, const float* h,                \
                             const float* gout, const float* ls,            \
                             const float* lb, const void* w1,               \
                             const float* b1, const void* w2,               \
                             const float* gamma, float* dx, int64_t n,      \
                             int C, cudaStream_t s);
ROBSEG_MLP_DECLARE(f32)
ROBSEG_MLP_DECLARE(bf16)
#undef ROBSEG_MLP_DECLARE

// Defines the two functions above for one operand type.
#define ROBSEG_MLP_DEFINE(SUFFIX, BF16)                                     \
  int robseg_mlp_fwd_##SUFFIX(const float* x, const float* ls,              \
                              const float* lb, const void* w1,              \
                              const float* b1, const void* w2,              \
                              const float* b2, const float* gamma,          \
                              float* out, float* h, int64_t n, int C,       \
                              cudaStream_t s) {                             \
    return dispatch_fwd<BF16>(x, ls, lb, w1, b1, w2, b2, gamma, out, h, n,  \
                              C, s);                                        \
  }                                                                         \
  int robseg_mlp_dx_##SUFFIX(const float* x, const float* h,                \
                             const float* gout, const float* ls,            \
                             const float* lb, const void* w1,               \
                             const float* b1, const void* w2,               \
                             const float* gamma, float* dx, int64_t n,      \
                             int C, cudaStream_t s) {                       \
    return dispatch_dx<BF16>(x, h, gout, ls, lb, w1, b1, w2, gamma, dx, n,  \
                             C, s);                                         \
  }
