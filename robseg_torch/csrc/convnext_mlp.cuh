// The ConvNeXt MLP on Hopper, shared by the block kernels
// (convnext_block.cu) and the MLP-tail kernels (convnext_mlp.cu,
// convnext_mlp_f32.cu): the per-call weight packing, the LayerNorm passes,
// and the two bf16 forms of the MLP - the fused kernel (C <= 192, the
// hidden layer on chip) and the persistent GEMM with fused epilogues (C >=
// 256, the hidden layer through device memory as bf16). convnext_block.cu
// says what they compute and why they are built so. Every helper has
// internal linkage: each translation unit that includes this header gets
// its own copy of what it instantiates.
//
// What the MLP tail adds to the block's use (all off for the block):
// - the forward without the residual (x null: out = gamma (acc + b2));
// - SAVE_H, the forward also writing the pre-GELU h + b1 in float32
//   (mlp_fused_kernel<C, false, true>; GemmParams::h in the kGelu
//   epilogue);
// - READ_H, the backward reading that h instead of recomputing it
//   (mlp_fused_kernel<C, true, true>, whose ring then skips the W1 panel;
//   the kDgeluH epilogue of the GEMM, one accumulator instead of two);
// - ln_rows_kernel, the LayerNorm-only prologue (the block's is
//   dwconv_ln_kernel), with bf16 or float32 outputs;
// - the TF32 split of the weights in the packing (kSplitTf32,
//   kTransposeSplitTf32).
// What the block's bf16 I/O form adds (off for the tail): the forward's
// residual x read and out written as bf16 (mlp_fused_kernel<C, false,
// false, bf16>, the kResidBf16 epilogue), and packing jobs that read bf16
// parameters (PackJob::src_bf16, kCastF32 for the parameter vectors).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kFusedMaxC = 192;  // widest C of the fused form
constexpr int kTM = 128;         // tokens per tile: two warpgroups of 64
constexpr int kHC = 64;          // hidden chunk, and every K-step
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kSmemBudget = 220 * 1024;
constexpr uint32_t kRows64 = 64 * 128;  // 64 rows of 128 bytes
constexpr float kRsqrt2 = 0.7071067811865476f;
constexpr float kInvSqrt2Pi = 0.3989422804014327f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * kRsqrt2));
}
// d gelu(v) / dv = Phi(v) + v phi(v)
__device__ __forceinline__ float gelu_grad(float v) {
  const float cdf = 0.5f * (1.0f + erff(v * kRsqrt2));
  const float pdf = kInvSqrt2Pi * expf(-0.5f * v * v);
  return cdf + v * pdf;
}

// two f32 as a bf16 pair, the lower column in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The 3xTF32 split of a float32 operand: hi = v rounded to nearest at
// TF32's 10 mantissa bits (ties away from zero), lo = v - hi (exact), of
// which the tensor core reads the top 19 bits. a.b ~ a_lo.b_hi + a_hi.b_lo
// + a_hi.b_hi keeps ~21 significant bits of each operand.
__device__ __forceinline__ float tf32_hi(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The packing, one launch per call: up to ten jobs, each a transpose
// dst (cols, rows) = src (rows, cols)^T through 32 x 32 shared-memory
// tiles (the depthwise taps (C, 49) -> (49, C) in f32; W2^T and W1^T in
// bf16 or split TF32) or an elementwise pass over rows * cols elements
// (W1, W2: cast to bf16, or split; bf16 parameter vectors: cast to f32).
// A split job writes hi and then lo, each rows * cols floats. The source
// is float32, or bf16 where src_bf16 (the block's bf16 parameters). The
// blocks are dealt to the jobs in order; block (32, 8).
struct PackJob {
  const void* src;
  void* dst;
  int rows, cols;
  int kind;    // one of the enum below
  int blocks;  // 32 x 32 tiles, or 2048-element runs of an elementwise job
  int src_bf16;
};
enum {
  kTransposeF32 = 0,
  kTransposeBf16 = 1,
  kCastBf16 = 2,
  kSplitTf32 = 3,
  kTransposeSplitTf32 = 4,
  kCastF32 = 5,
};
struct PackParams {
  PackJob job[10];
  int jobs;
};

__device__ __forceinline__ float pack_ld(const PackJob& q, int64_t i) {
  return q.src_bf16 ? ld1(static_cast<const bf16*>(q.src) + i)
                    : static_cast<const float*>(q.src)[i];
}

__global__ void __launch_bounds__(256)
    pack_kernel(const __grid_constant__ PackParams p) {
  __shared__ float tile[32][33];
  int b = blockIdx.x, j = 0;
  while (j + 1 < p.jobs && b >= p.job[j].blocks) b -= p.job[j++].blocks;
  const PackJob& q = p.job[j];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int64_t n = (int64_t)q.rows * q.cols;
  if (q.kind == kCastBf16 || q.kind == kSplitTf32 || q.kind == kCastF32) {
    // 2048 elements a block, 8 a thread
    for (int k = 0; k < 2; ++k) {
      const int64_t i = (int64_t)b * 512 + k * 256 + tid;  // float4 index
      if (4 * i >= n) break;
      const float4 v =
          q.src_bf16 ? make_float4(pack_ld(q, 4 * i), pack_ld(q, 4 * i + 1),
                                   pack_ld(q, 4 * i + 2), pack_ld(q, 4 * i + 3))
                     : reinterpret_cast<const float4*>(q.src)[i];
      if (q.kind == kCastF32) {
        static_cast<float4*>(q.dst)[i] = v;
      } else if (q.kind == kCastBf16) {
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(q.dst) + 2 * i;
        o[0] = __floats2bfloat162_rn(v.x, v.y);
        o[1] = __floats2bfloat162_rn(v.z, v.w);
      } else {
        const float4 hi = make_float4(tf32_hi(v.x), tf32_hi(v.y),
                                      tf32_hi(v.z), tf32_hi(v.w));
        float4* o = static_cast<float4*>(q.dst);
        o[i] = hi;
        o[n / 4 + i] =
            make_float4(v.x - hi.x, v.y - hi.y, v.z - hi.z, v.w - hi.w);
      }
    }
    return;
  }
  const int tx = (q.cols + 31) / 32;
  const int c0 = (b % tx) * 32, r0 = (b / tx) * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < q.rows && c < q.cols)
      tile[i][threadIdx.x] = pack_ld(q, (int64_t)r * q.cols + c);
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < q.rows && c < q.cols) {
      const int64_t o = (int64_t)c * q.rows + r;
      const float v = tile[threadIdx.x][i];
      if (q.kind == kTransposeF32) {
        static_cast<float*>(q.dst)[o] = v;
      } else if (q.kind == kTransposeBf16) {
        static_cast<bf16*>(q.dst)[o] = __float2bfloat16(v);
      } else {
        const float hi = tf32_hi(v);
        static_cast<float*>(q.dst)[o] = hi;
        static_cast<float*>(q.dst)[n + o] = v - hi;
      }
    }
  }
}

// The MLP tail's LayerNorm prologue, one warp per token (8 a block): from
// y (n, C) f32, u = LN(y) * ls + lb, and for the backward xhat, inv =
// 1/sqrt(var + eps) per token and gms = gamma * dy. u and gms are written
// as T: bf16 (the rounding of the bf16 modes) or float (the 3xTF32 GEMMs
// split them on chip). Each output is skipped where its pointer is null.
template <int C, class T>
__global__ void __launch_bounds__(256, 1)
ln_rows_kernel(const float* __restrict__ y, const float* __restrict__ ls,
               const float* __restrict__ lb, T* __restrict__ u,
               float* __restrict__ xhat, float* __restrict__ inv_out,
               const float* __restrict__ dy, const float* __restrict__ gamma,
               T* __restrict__ gms, int64_t n) {
  constexpr int V = C / 32;
  const int lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x * (int64_t)(blockDim.x / 32) +
                      threadIdx.x / 32;
  if (row >= n) return;
  const float* yr = y + row * C;
  float v[V];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    v[i] = yr[lane + 32 * i];
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
    const int64_t o = row * C + c;
    const float xh = v[i] * inv;
    if (u) u[o] = T(xh * ls[c] + lb[c]);
    if (xhat) xhat[o] = xh;
    if (gms) gms[o] = T(gamma[c] * dy[o]);
  }
  if (inv_out && lane == 0) inv_out[row] = inv;
}

// LayerNorm backward in place, one warp per token (C a multiple of 128):
//   dxhat = du * ls; du <- inv * (dxhat - mean(dxhat) - xhat *
//   mean(dxhat * xhat))
__global__ void __launch_bounds__(256)
ln_bwd_kernel(float* __restrict__ du, const float* __restrict__ xhat,
              const float* __restrict__ inv, const float* __restrict__ ls,
              int64_t n, int C) {
  const int lane = threadIdx.x % 32;
  const int64_t row = blockIdx.x * (int64_t)(blockDim.x / 32) +
                      threadIdx.x / 32;
  if (row >= n) return;
  float4* d = reinterpret_cast<float4*>(du + row * C);
  const float4* xh = reinterpret_cast<const float4*>(xhat + row * C);
  const float4* l = reinterpret_cast<const float4*>(ls);
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = lane; i < C / 4; i += 32) {
    const float4 a = d[i], b = xh[i], g = l[i];
    const float e0 = a.x * g.x, e1 = a.y * g.y, e2 = a.z * g.z,
                e3 = a.w * g.w;
    s1 += e0 + e1 + e2 + e3;
    s2 += e0 * b.x + e1 * b.y + e2 * b.z + e3 * b.w;
  }
  s1 = warp_sum(s1) / C;
  s2 = warp_sum(s2) / C;
  const float iv = inv[row];
  for (int i = lane; i < C / 4; i += 32) {
    const float4 a = d[i], b = xh[i], g = l[i];
    d[i] = make_float4(iv * (a.x * g.x - s1 - b.x * s2),
                       iv * (a.y * g.y - s1 - b.y * s2),
                       iv * (a.z * g.z - s1 - b.z * s2),
                       iv * (a.w * g.w - s1 - b.w * s2));
  }
}

// ---------------------------------------------------------------------
// The fused MLP (C <= 192)

struct FusedParams {
  CUtensorMap tok[2];    // u, gms: bf16 (n, C), box {64, 128}
  CUtensorMap panel[2];  // (64 hidden x C) chunks of W1, W2^T: bf16
                         // (4C, C), box {64, 64}
  CUtensorMap cols;      // (C x 64 hidden) chunks of W2 (forward) or W1^T
                         // (backward): bf16 (C, 4C), box {64, C}
  const float* b1;
  const void* x;         // forward epilogue: out = x + gamma (acc + b2), or
                         // gamma (acc + b2) with x null; x and out are the
                         // kernel's IO type (f32, or bf16 for the block)
  const float* b2;
  const float* gamma;
  void* out;
  float* h;              // (n, 4C) f32 pre-GELU h + b1: written by the
                         // forward, read by the backward (WITH_H)
  const float* xhat;     // backward epilogue: the LayerNorm backward
  const float* inv;
  const float* ls;
  float* dyconv;
  int64_t n;
  int tiles;
};

// The fused kernel's shared-memory plan. A token tile is KC slabs of 128
// rows x 64 channels (16 KB each; the C = 96 tail zero-filled); a ring slot
// holds one chunk operand: a W1 or W2^T chunk, KC slabs of 64 rows (8 KB
// each), or a W2 or W1^T chunk, C rows of 64 hidden units. WITH_H: the
// forward also writes h, the backward reads it and so needs neither u nor
// the W1 chunks.
template <int C, bool BWD, bool WITH_H>
struct Fused {
  static constexpr int KC = (C + 63) / 64;
  static constexpr uint32_t kSlab = kTM * 128;
  static constexpr uint32_t kTok = (BWD ? 2 : 1) * KC * kSlab;
  static constexpr bool kReadH = BWD && WITH_H;
  static constexpr int kTok0 = kReadH ? 1 : 0;  // first token tile loaded
  static constexpr uint32_t kPanel = KC * kRows64;
  static constexpr uint32_t kCols = C * 128;
  static constexpr uint32_t kSlot = kPanel > kCols ? kPanel : kCols;
  // ring slots per chunk: [W1,] [W2^T,] W2 / W1^T columns
  static constexpr int kPer = BWD ? (kReadH ? 2 : 3) : 2;
  static constexpr int kFit = (kSmemBudget - (int)kTok - 2048) / (int)kSlot;
  static constexpr int kSlots = kFit < 8 ? kFit : 8;
  static constexpr int kChunks = 4 * C / kHC;
  static constexpr size_t kSmem =
      1024 + kTok + (size_t)kSlots * kSlot + 8 * (2 * kSlots + 2);
  static_assert(C % 32 == 0 && C <= kFusedMaxC, "fused widths");
  static_assert(kSlots >= 3, "the ring needs three slots");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int C, bool BWD, bool WITH_H>
__device__ __forceinline__ void fused_producer(const FusedParams& p,
                                               uint32_t tok, uint32_t ring,
                                               uint32_t bars) {
  typedef Fused<C, BWD, WITH_H> F;
  constexpr int S = F::kSlots;
  for (int t = F::kTok0; t < (BWD ? 2 : 1); ++t) {
    prefetch_map(&p.tok[t]);
    prefetch_map(&p.panel[t]);
  }
  prefetch_map(&p.cols);
  const uint32_t tok_full = bars + 16 * S, tok_empty = tok_full + 8;
  int it = 0;  // ring slots filled by this block, over all its tiles
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    mbar_wait(tok_empty, (ti & 1) ^ 1);
    mbar_expect_tx(tok_full, F::kTok - F::kTok0 * F::KC * F::kSlab);
    for (int t = F::kTok0; t < (BWD ? 2 : 1); ++t)
      for (int s = 0; s < F::KC; ++s)
        tma_load_2d(tok + (t * F::KC + s) * F::kSlab, &p.tok[t], tok_full,
                    s * 64, tile * kTM);
    for (int j = 0; j < F::kChunks; ++j) {
      for (int q = 0; q < F::kPer; ++q, ++it) {
        const int st = it % S;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
        const uint32_t dst = ring + st * F::kSlot;
        if (q == F::kPer - 1) {  // W2 (forward) / W1^T (backward) columns
          mbar_expect_tx(full, F::kCols);
          tma_load_2d(dst, &p.cols, full, j * kHC, 0);
        } else {                 // W1 / W2^T rows
          mbar_expect_tx(full, F::kPanel);
          for (int s = 0; s < F::KC; ++s)
            tma_load_2d(dst + s * kRows64, &p.panel[q + F::kTok0], full,
                        s * 64, j * kHC);
        }
      }
    }
  }
}

template <int C, bool BWD, bool WITH_H, class IO>
__device__ __forceinline__ void fused_consumer(const FusedParams& p,
                                               uint32_t tok, uint32_t ring,
                                               uint32_t bars, int wg) {
  typedef Fused<C, BWD, WITH_H> F;
  constexpr int S = F::kSlots;
  constexpr int HID = 4 * C;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t tok_full = bars + 16 * S, tok_empty = tok_full + 8;
  float acc[C / 2];   // the 64 x C output of this warpgroup
  float h[F::kReadH ? 1 : 32];  // one 64 x 64 hidden chunk (not when read)
  float da[BWD ? 32 : 1];
  uint32_t fa[4][4];  // bf16 gelu(h) / dh as wgmma A fragments, 4 K-steps
  int it = 0;
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    mbar_wait(tok_full, ti & 1);
    const uint32_t ua = tok + wg * kRows64;  // this warpgroup's 64 rows
    const uint32_t ga = ua + F::KC * F::kSlab;
    // this thread's accumulator rows r0 and r0 + 8
    const int64_t r0 =
        (int64_t)tile * kTM + wg * 64 + warp * 16 + lane / 4;
    for (int j = 0; j < F::kChunks; ++j, it += F::kPer) {
      // h = u . W1c^T (or h read), and da = gms . W2^T_c
      if constexpr (!F::kReadH) {
        mbar_wait(bars + 8 * (it % S), (it / S) & 1);
        const uint32_t w1 = ring + (it % S) * F::kSlot;
        fence_acc(h);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < F::KC; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64>(h, smem_desc(ua + s * F::kSlab) + 2 * kk,
                         smem_desc(w1 + s * kRows64) + 2 * kk,
                         (s | kk) != 0);
      } else {
        wgmma_fence();
      }
      if constexpr (BWD) {
        const int i1 = F::kReadH ? it : it + 1;
        mbar_wait(bars + 8 * (i1 % S), (i1 / S) & 1);
        const uint32_t w2 = ring + (i1 % S) * F::kSlot;
        fence_acc(da);
#pragma unroll
        for (int s = 0; s < F::KC; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<64>(da, smem_desc(ga + s * F::kSlab) + 2 * kk,
                         smem_desc(w2 + s * kRows64) + 2 * kk,
                         (s | kk) != 0);
      }
      wgmma_commit();
      fence_acc(h);
      fence_acc(da);
      wgmma_wait<0>();  // also the previous chunk's second product
      fence_acc(h);
      fence_acc(da);
      fence_acc(acc);
      if (lane == 0) {  // this chunk's row panels, the last chunk's columns
        for (int q = 0; q < F::kPer - 1; ++q)
          mbar_arrive(bars + 8 * (S + (it + q) % S));
        if (j > 0) mbar_arrive(bars + 8 * (S + (it - 1) % S));
        if (j == F::kChunks - 1) mbar_arrive(tok_empty);
      }
      // bias, GELU (or GELU' times da) and bf16 in registers: element
      // (row, 16 kk + 8 m + 2 (lane % 4) + e) of the chunk is
      // h[4 (2 kk + m) + 2 hh + e], which is the A fragment's register
      // fa[kk][2 m + hh], half e
      if constexpr (F::kReadH) {
        // h + b1 as the forward saved it, read in that layout (now that
        // the last chunk's A fragments are free); rows past n read row
        // n - 1: their da is 0 (zero-filled gms)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* hr = p.h + min(r0 + 8 * hh, p.n - 1) * HID + j * kHC +
                            2 * (lane % 4);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 v =
                __ldg(reinterpret_cast<const float2*>(hr + 8 * jj));
            const int i = 4 * jj + 2 * hh;
            fa[jj / 2][2 * (jj % 2) + hh] = pack_bf16(
                da[i] * gelu_grad(v.x), da[i + 1] * gelu_grad(v.y));
          }
        }
      } else {
        const float* bias = p.b1 + j * kHC + 2 * (lane % 4);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(bias + 8 * jj));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * jj + 2 * hh;
            const float v0 = h[i] + bb.x, v1 = h[i + 1] + bb.y;
            float g0, g1;
            if constexpr (BWD) {
              g0 = da[i] * gelu_grad(v0);
              g1 = da[i + 1] * gelu_grad(v1);
            } else {
              g0 = gelu(v0);
              g1 = gelu(v1);
              const int64_t row = r0 + 8 * hh;
              if (WITH_H && row < p.n)  // the forward saves h
                *reinterpret_cast<float2*>(p.h + row * HID + j * kHC +
                                           8 * jj + 2 * (lane % 4)) =
                    make_float2(v0, v1);
            }
            fa[jj / 2][2 * (jj % 2) + hh] = pack_bf16(g0, g1);
          }
        }
      }
      // acc += fa . (W2 / W1^T columns of the chunk)^T
      const int i2 = it + F::kPer - 1;
      mbar_wait(bars + 8 * (i2 % S), (i2 / S) & 1);
      const uint64_t db = smem_desc(ring + (i2 % S) * F::kSlot);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_frag(fa[kk]);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<C>(acc, fa[kk], db + 2 * kk, (j | kk) != 0);
      wgmma_commit();
      fence_acc(acc);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (S + (it - 1) % S));

    // epilogue: rows r0 and r0 + 8, columns 8 jj + 2 (lane % 4) + {0, 1}
    const int c0 = 2 * (lane % 4);
    if constexpr (!BWD) {
      // with or without the residual x, chosen once a tile: a branch in
      // the loop would serialise the x loads
      auto store = [&](auto resid) {
#pragma unroll
        for (int jj = 0; jj < C / 8; ++jj) {
          const int col = c0 + 8 * jj;
          const float2 g =
              __ldg(reinterpret_cast<const float2*>(p.gamma + col));
          const float2 b = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int64_t row = r0 + 8 * hh;
            if (row < p.n) {
              const int64_t o = row * C + col;
              float2 xv = make_float2(0.0f, 0.0f);
              if constexpr (decltype(resid)::value)
                xv = ld2(static_cast<const IO*>(p.x) + o);
              st2(static_cast<IO*>(p.out) + o,
                  make_float2(xv.x + g.x * (acc[4 * jj + 2 * hh] + b.x),
                              xv.y + g.y * (acc[4 * jj + 2 * hh + 1] + b.y)));
            }
          }
        }
      };
      if (p.x)
        store(std::true_type());
      else
        store(std::false_type());
    } else {
      // the LayerNorm backward; a row's C columns sit in the four threads
      // of one quad
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = r0 + 8 * hh;
        const bool ok = row < p.n;
        const float* xr = p.xhat + (ok ? row : 0) * C;
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int jj = 0; jj < C / 8; ++jj) {
          const int col = c0 + 8 * jj;
          const float2 l = __ldg(reinterpret_cast<const float2*>(p.ls + col));
          const float2 xh = __ldg(reinterpret_cast<const float2*>(xr + col));
          const float d0 = acc[4 * jj + 2 * hh] * l.x;
          const float d1 = acc[4 * jj + 2 * hh + 1] * l.y;
          s1 += d0 + d1;
          s2 += d0 * xh.x + d1 * xh.y;
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        s1 /= C;
        s2 /= C;
        if (ok) {
          const float iv = p.inv[row];
#pragma unroll
          for (int jj = 0; jj < C / 8; ++jj) {
            const int col = c0 + 8 * jj;
            const float2 l =
                __ldg(reinterpret_cast<const float2*>(p.ls + col));
            const float2 xh =
                __ldg(reinterpret_cast<const float2*>(xr + col));
            *reinterpret_cast<float2*>(p.dyconv + row * C + col) =
                make_float2(
                    iv * (acc[4 * jj + 2 * hh] * l.x - s1 - xh.x * s2),
                    iv * (acc[4 * jj + 2 * hh + 1] * l.y - s1 - xh.y * s2));
          }
        }
      }
    }
  }
}

template <int C, bool BWD, bool WITH_H, class IO>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fused_kernel(const __grid_constant__ FusedParams p) {
  typedef Fused<C, BWD, WITH_H> F;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tok = (raw + 1023) & ~1023u;
  const uint32_t ring = tok + F::kTok;
  // full[st] = bars + 8 st, empty[st] = bars + 8 (S + st), then the token
  // tile's full and empty
  const uint32_t bars = ring + F::kSlots * F::kSlot;
  if (threadIdx.x == 0) {
    for (int st = 0; st < F::kSlots; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (F::kSlots + st), kConsumers * 4);
    }
    mbar_init(bars + 16 * F::kSlots, 1);
    mbar_init(bars + 16 * F::kSlots + 8, kConsumers * 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  // one branch per role for the whole kernel: setmaxnreg needs paths that
  // never meet again
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0)
      fused_producer<C, BWD, WITH_H>(p, tok, ring, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    fused_consumer<C, BWD, WITH_H, IO>(p, tok, ring, bars, wg);
  }
}

// ---------------------------------------------------------------------
// The two-GEMM form (C >= 256): out (m x n) = A (m x k) . B (n x k)^T with
// a fused epilogue

enum Epi {
  kGelu = 0,    // out bf16 = gelu(acc + bias); h f32 = acc + bias if h
  kResid = 1,   // out f32 = x + gamma * (acc + bias), x = 0 if null
  kDgelu = 2,   // out bf16 = acc2 * gelu'(acc + bias); acc2 = A2 . B2^T
  kStore = 3,   // out f32 = acc
  kDgeluH = 4,  // out bf16 = acc * gelu'(h), h read (m, n) f32
  kResidBf16 = 5,  // kResid with x and out bf16 (the block's bf16 I/O)
};

struct GemmParams {
  CUtensorMap a[2];  // bf16 (m, k), box {64, 128}
  CUtensorMap b[2];  // bf16 (n, k), box {64, 128}
  const float* bias;
  const void* x;     // kResid: f32, kResidBf16: bf16, like out
  const float* gamma;
  float* h;          // kGelu: written when not null; kDgeluH: read
  void* out;         // (m, n)
  int64_t m;
  int n, kc, tiles_n, tiles;
};

template <int EPI>
struct Gemm {
  static constexpr int kOps = EPI == kDgelu ? 2 : 1;
  static constexpr uint32_t kTile = 128 * 128;  // 128 rows x 64 (16 KB)
  static constexpr uint32_t kStage = 2 * kOps * kTile;  // [A, B] per op
  static constexpr int kFit = (kSmemBudget - 2048) / (int)kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kStage +
                                  16 * kStages;
  static_assert(kStages >= 2, "the ring needs two stages");
};

template <int EPI>
__device__ __forceinline__ void gemm_producer(const GemmParams& p,
                                              uint32_t base, uint32_t bars) {
  typedef Gemm<EPI> G;
  constexpr int S = G::kStages;
  for (int o = 0; o < G::kOps; ++o) {
    prefetch_map(&p.a[o]);
    prefetch_map(&p.b[o]);
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * 128, n0 = (tile % p.tiles_n) * 128;
    for (int k = 0; k < p.kc; ++k, ++it) {
      const int st = it % S;
      const uint32_t full = bars + 8 * st;
      mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
      mbar_expect_tx(full, G::kStage);
      const uint32_t s = base + st * G::kStage;
      for (int o = 0; o < G::kOps; ++o) {
        tma_load_2d(s + 2 * o * G::kTile, &p.a[o], full, k * 64, m0);
        tma_load_2d(s + (2 * o + 1) * G::kTile, &p.b[o], full, k * 64, n0);
      }
    }
  }
}

template <int EPI>
__device__ __forceinline__ void gemm_consumer(const GemmParams& p,
                                              uint32_t base, uint32_t bars,
                                              int wg) {
  typedef Gemm<EPI> G;
  constexpr int S = G::kStages;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float d[64];
  float d2[G::kOps == 2 ? 64 : 1];
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int64_t m0 = (int64_t)(tile / p.tiles_n) * 128;
    const int n0 = (tile % p.tiles_n) * 128;
    for (int k = 0; k < p.kc; ++k, ++it) {
      const int st = it % S;
      mbar_wait(bars + 8 * st, (it / S) & 1);
      const uint32_t s = base + st * G::kStage;
      fence_acc(d);
      fence_acc(d2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<128>(d, smem_desc(s + wg * kRows64) + 2 * kk,
                      smem_desc(s + G::kTile) + 2 * kk, (k | kk) != 0);
      if constexpr (G::kOps == 2) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<128>(d2, smem_desc(s + 2 * G::kTile + wg * kRows64) +
                                2 * kk,
                        smem_desc(s + 3 * G::kTile) + 2 * kk, (k | kk) != 0);
      }
      wgmma_commit();
      fence_acc(d);
      fence_acc(d2);
      wgmma_wait<1>();  // the previous K-step's products are done ...
      fence_acc(d);
      fence_acc(d2);
      if (k > 0 && lane == 0)  // ... so its stage goes back to the producer
        mbar_arrive(bars + 8 * (S + (it - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc(d);
    fence_acc(d2);
    if (lane == 0) mbar_arrive(bars + 8 * (S + (it - 1) % S));

    // epilogue: rows r0 and r0 + 8, columns n0 + 8 j + 2 (lane % 4) + {0, 1};
    // the residual x (kResid) and the h store (kGelu) chosen once a tile:
    // a branch in the loop would serialise the loads
    const int64_t r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    auto store = [&](auto opt) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
        float2 bb = make_float2(0.0f, 0.0f), g = make_float2(0.0f, 0.0f);
        if constexpr (EPI != kStore && EPI != kDgeluH)
          bb = __ldg(reinterpret_cast<const float2*>(p.bias + col));
        if constexpr (EPI == kResid || EPI == kResidBf16)
          g = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t row = r0 + 8 * hh;
          if (row >= p.m) continue;
          const int64_t o = row * p.n + col;
          const int i = 4 * j + 2 * hh;
          if constexpr (EPI == kGelu) {
            const float v0 = d[i] + bb.x, v1 = d[i + 1] + bb.y;
            reinterpret_cast<uint32_t*>(p.out)[o / 2] =
                pack_bf16(gelu(v0), gelu(v1));
            if constexpr (decltype(opt)::value)
              *reinterpret_cast<float2*>(p.h + o) = make_float2(v0, v1);
          } else if constexpr (EPI == kDgeluH) {
            const float2 hv = __ldg(reinterpret_cast<const float2*>(p.h + o));
            reinterpret_cast<uint32_t*>(p.out)[o / 2] = pack_bf16(
                d[i] * gelu_grad(hv.x), d[i + 1] * gelu_grad(hv.y));
          } else if constexpr (EPI == kDgelu) {
            reinterpret_cast<uint32_t*>(p.out)[o / 2] =
                pack_bf16(d2[i] * gelu_grad(d[i] + bb.x),
                          d2[i + 1] * gelu_grad(d[i + 1] + bb.y));
          } else if constexpr (EPI == kResid || EPI == kResidBf16) {
            typedef std::conditional_t<EPI == kResid, float, bf16> IO;
            float2 xv = make_float2(0.0f, 0.0f);
            if constexpr (decltype(opt)::value)
              xv = ld2(static_cast<const IO*>(p.x) + o);
            st2(static_cast<IO*>(p.out) + o,
                make_float2(xv.x + g.x * (d[i] + bb.x),
                            xv.y + g.y * (d[i + 1] + bb.y)));
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
                make_float2(d[i], d[i + 1]);
          }
        }
      }
    };
    if (((EPI == kResid || EPI == kResidBf16) && p.x) ||
        (EPI == kGelu && p.h))
      store(std::true_type());
    else
      store(std::false_type());
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_gemm_kernel(const __grid_constant__ GemmParams p) {
  typedef Gemm<EPI> G;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + G::kStages * G::kStage;
  if (threadIdx.x == 0) {
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (G::kStages + st), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) gemm_producer<EPI>(p, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    gemm_consumer<EPI>(p, base, bars, wg);
  }
}

// ---------------------------------------------------------------------
// Host side

// A row-major bf16 (rows, cols) matrix as a tensor map with a {64, box}
// box: 64 columns (128 bytes, the swizzle span) by `box` rows; float32,
// a {32, box} box of the same 128-byte rows.
int map2d(CUtensorMap* m, const void* ptr, int64_t rows, int cols,
          int box, bool f32 = false) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint32_t b[2] = {f32 ? 32u : 64u, (cuuint32_t)box};
  return encode(m, ptr, 2, dims, b,
                f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

int grid_for(int tiles, int sms) { return tiles < sms ? tiles : sms; }

// the card's SM count: the persistent grids' size (MLP-tail entry points,
// which take no such argument; the block's wrapper passes it in). 0 if
// the query failed, and then the launch fails.
int sm_count() {
  static int sms = 0;
  int dev = 0;
  if (sms == 0 && cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The fused MLP; with h (WITH_H) the backward reads neither u nor panel0
// (W1), which may be null. IO: the forward's x and out (the backward
// writes f32 dyconv whatever the block's I/O).
template <int C, bool BWD, bool WITH_H = false, class IO = float>
int launch_fused(FusedParams& p, const void* u, const void* gms,
                 const void* panel0, const void* panel1, const void* cols,
                 int sms, cudaStream_t stream) {
  typedef Fused<C, BWD, WITH_H> F;
  int e = 0;
  if (!F::kReadH) e = map2d(&p.tok[0], u, p.n, C, kTM);
  if (!e && BWD) e = map2d(&p.tok[1], gms, p.n, C, kTM);
  if (!e && !F::kReadH) e = map2d(&p.panel[0], panel0, 4 * C, C, kHC);
  if (!e && BWD) e = map2d(&p.panel[1], panel1, 4 * C, C, kHC);
  if (!e) e = map2d(&p.cols, cols, C, 4 * C, C);
  if (e) return e;
  p.tiles = (int)((p.n + kTM - 1) / kTM);
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_fused_kernel<C, BWD, WITH_H, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_fused_kernel<C, BWD, WITH_H, IO><<<grid_for(p.tiles, sms), kThreads,
                                         F::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// out (m, n) from A (m, k) [and A2] and B (n, k) [and B2], all bf16
template <int EPI>
int launch_gemm(GemmParams& p, const void* a, const void* b, const void* a2,
                const void* b2, int k, int sms, cudaStream_t stream) {
  typedef Gemm<EPI> G;
  int e = map2d(&p.a[0], a, p.m, k, 128);
  if (!e) e = map2d(&p.b[0], b, p.n, k, 128);
  if (!e && G::kOps == 2) e = map2d(&p.a[1], a2, p.m, k, 128);
  if (!e && G::kOps == 2) e = map2d(&p.b[1], b2, p.n, k, 128);
  if (e) return e;
  if (p.n % 128 || k % 64) return (int)cudaErrorInvalidValue;
  p.kc = k / 64;
  p.tiles_n = p.n / 128;
  const int64_t tiles = (p.m + 127) / 128 * p.tiles_n;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_gemm_kernel<EPI><<<grid_for(p.tiles, sms), kThreads, G::kSmem,
                         stream>>>(p);
  return (int)cudaGetLastError();
}

void add_job(PackParams& p, const void* src, void* dst, int rows, int cols,
             int kind, bool src_bf16 = false) {
  PackJob& q = p.job[p.jobs++];
  q = PackJob{src, dst, rows, cols, kind, 0, src_bf16 ? 1 : 0};
  q.blocks = (kind == kCastBf16 || kind == kSplitTf32 || kind == kCastF32)
                 ? (int)(((int64_t)rows * cols + 2047) / 2048)
                 : ((cols + 31) / 32) * ((rows + 31) / 32);
}

int pack(const PackParams& p, cudaStream_t stream) {
  int blocks = 0;
  for (int j = 0; j < p.jobs; ++j) blocks += p.job[j].blocks;
  pack_kernel<<<blocks, dim3(32, 8), 0, stream>>>(p);
  return (int)cudaGetLastError();
}

int ln_bwd(float* du, const float* xhat, const float* inv, const float* ls,
           int64_t n, int C, cudaStream_t stream) {
  ln_bwd_kernel<<<(unsigned)((n + 7) / 8), 256, 0, stream>>>(du, xhat, inv,
                                                             ls, n, C);
  return (int)cudaGetLastError();
}

#define ROBSEG_MLP_WIDTHS(X) X(96) X(128) X(192) X(256) X(384)

// the MLP tail's LayerNorm prologue at width C (ln_rows_kernel)
template <class T>
int ln_rows(const float* y, const float* ls, const float* lb, T* u,
            float* xhat, float* inv, const float* dy, const float* gamma,
            T* gms, int64_t n, int C, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + 7) / 8);
  switch (C) {
#define X(W)                                                           \
  case W:                                                              \
    ln_rows_kernel<W, T><<<blocks, 256, 0, stream>>>(                  \
        y, ls, lb, u, xhat, inv, dy, gamma, gms, n);                   \
    return (int)cudaGetLastError();
    ROBSEG_MLP_WIDTHS(X)
#undef X
    default: return -1;
  }
}

}  // namespace

// One translation unit per operand type, so that nvcc compiles them in
// parallel: convnext_mlp.cu (bf16 and the C entry points) and
// convnext_mlp_f32.cu (3xTF32). Each carves its own scratch: with base
// null, carve only counts the bytes.
#define ROBSEG_MLP_DECLARE(SUFFIX)                                          \
  int64_t robseg_mlp_scratch_##SUFFIX(int64_t n, int C, bool with_h,        \
                                      bool bwd);                            \
  int robseg_mlp_fwd_##SUFFIX(const float* x, const float* ls,              \
                              const float* lb, const float* w1,             \
                              const float* b1, const float* w2,             \
                              const float* b2, const float* gamma,          \
                              void* scratch, float* out, float* h,          \
                              int64_t n, int C, cudaStream_t s);            \
  int robseg_mlp_dx_##SUFFIX(const float* x, const float* h,                \
                             const float* gout, const float* ls,            \
                             const float* lb, const float* w1,              \
                             const float* b1, const float* w2,              \
                             const float* gamma, void* scratch, float* dx,  \
                             int64_t n, int C, cudaStream_t s);
ROBSEG_MLP_DECLARE(f32)
ROBSEG_MLP_DECLARE(bf16)
#undef ROBSEG_MLP_DECLARE
