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
constexpr int kBoxRows = 16;     // a TMA store box: a warp's 16 rows x 64
                                 // bf16 columns (128 bytes)
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kSmemBudget = 220 * 1024;
constexpr int kSmemMax = 232448;  // a block's shared memory, at most
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
  CUtensorMap xo[2];     // the bf16 forward's x and out: bf16 (n, C), box
                         // {64, 16} (a warp's 16 rows of one slab)
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

// out = x + gamma (acc + b) in f32 (acc + b rounded, then one fused
// multiply-add): the same expression in every epilogue, so that the bf16
// forms compute what the float32 forms compute
__device__ __forceinline__ float resid(float x, float g, float acc, float b) {
  return fmaf(g, acc + b, x);
}

// h = u . W1c^T for one 64-wide hidden chunk: m64n64k16 from shared
// memory over the C channels, KC slabs of 64 (the C = 96 tail: two k16
// steps of its second slab, the two zero-filled ones not issued)
template <int C>
__device__ __forceinline__ void fused_h(float (&h)[32], uint32_t ua,
                                        uint32_t w1) {
  constexpr uint32_t kSlab = kTM * 128;
  fence_acc(h);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < C / 16; ++k)
    wgmma_ss<64>(h, smem_desc(ua + (k / 4) * kSlab) + 2 * (k % 4),
                 smem_desc(w1 + (k / 4) * kRows64) + 2 * (k % 4), k != 0);
}

// The fused forward's shared-memory plan: two token tiles of u (KC slabs
// of 128 rows x 64 channels, 16 KB each; the C = 96 tail zero-filled), so
// that the next tile's u lands while this one computes; a ring of slots,
// each one chunk operand (a chunk's W1 rows, KC slabs of 64 x 64, or its
// W2 columns, C rows of 64 hidden units); then the mbarriers: full and
// empty a slot, full and empty a token tile, one a consumer warp for its
// x boxes (bf16). The bf16 form stages x and out in the warp's own rows of
// the token tile it has finished with.
template <int C>
struct FusedFwd {
  static constexpr int KC = (C + 63) / 64;
  static constexpr uint32_t kSlab = kTM * 128;
  static constexpr uint32_t kTok = KC * kSlab;
  static constexpr uint32_t kPanel = KC * kRows64;
  static constexpr uint32_t kCols = C * 128;
  static constexpr uint32_t kSlot = kPanel > kCols ? kPanel : kCols;
  static constexpr int kChunks = 4 * C / kHC;
  static constexpr int kBars = 2 * 8 + 4 + kConsumers * 4;  // at most
  static constexpr int kFit =
      (kSmemMax - 1024 - 2 * (int)kTok - 8 * kBars) / (int)kSlot;
  static constexpr int kSlots = kFit < 8 ? kFit : 8;
  static constexpr size_t kSmem = 1024 + 2 * kTok + (size_t)kSlots * kSlot +
                                  8 * (2 * kSlots + 4 + kConsumers * 4);
  static_assert(C % 32 == 0 && C <= kFusedMaxC, "fused widths");
  static_assert(kChunks % 2 == 0, "the h buffers alternate by chunk");
  // at chunk g the consumers hold g - 1's W2 columns and g's W1 rows and
  // W2 columns while g + 1's W1 rows land
  static_assert(kSlots >= 4, "the ring needs four slots");
  static_assert(kSmem <= (size_t)kSmemMax, "shared memory");
};

// The forward's producers: thread 0 of the producer warpgroup streams the
// chunks' weights through the ring (chunk g: W1 rows at ring position 2g,
// W2 columns at 2g + 1, over all the block's tiles), thread 32 the token
// tiles into the two buffers (tile i into buffer i % 2).
template <int C>
__device__ __forceinline__ void fused_fwd_weights(const FusedParams& p,
                                                  uint32_t ring,
                                                  uint32_t bars) {
  typedef FusedFwd<C> F;
  constexpr int S = F::kSlots;
  prefetch_map(&p.panel[0]);
  prefetch_map(&p.cols);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x)
    for (int j = 0; j < F::kChunks; ++j)
      for (int q = 0; q < 2; ++q, ++it) {
        const int st = it % S;
        const uint32_t full = bars + 8 * st, dst = ring + st * F::kSlot;
        mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
        if (q == 0) {
          mbar_expect_tx(full, F::kPanel);
          for (int s = 0; s < F::KC; ++s)
            tma_load_2d(dst + s * kRows64, &p.panel[0], full, s * 64,
                        j * kHC);
        } else {
          mbar_expect_tx(full, F::kCols);
          tma_load_2d(dst, &p.cols, full, j * kHC, 0);
        }
      }
}

template <int C>
__device__ __forceinline__ void fused_fwd_tokens(const FusedParams& p,
                                                 uint32_t tok,
                                                 uint32_t tbar) {
  typedef FusedFwd<C> F;
  prefetch_map(&p.tok[0]);
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    const int b = ti & 1;
    mbar_wait(tbar + 16 + 8 * b, ((ti >> 1) & 1) ^ 1);
    mbar_expect_tx(tbar + 8 * b, F::kTok);
    for (int s = 0; s < F::KC; ++s)
      tma_load_2d(tok + b * F::kTok + s * F::kSlab, &p.tok[0], tbar + 8 * b,
                  s * 64, tile * kTM);
  }
}

// The forward's consumer warpgroup: 64 tokens of each tile. Software
// pipelined over the hidden chunks, with two h register sets: at chunk g
// it issues chunk g + 1's h = u . W1^T (the next tile's first chunk after
// a tile's last), waits for chunk g's h and chunk g - 1's second product,
// runs bias, GELU and the bf16 rounding with chunk g + 1's h in flight,
// then issues acc += gelu(h) . W2c^T with the A operand from registers.
// The epilogue runs with the next tile's first h in flight. (On the H100
// the GELU still adds about its own issue time, ~30 float32 instructions
// an element: it overlaps the products little; see PERF.md.) bf16 out
// (the block's bf16 form): each warp's x rows come by TMA into its rows of
// the finished token tile, out is written over them and leaves by TMA
// stores; float32 out is stored from the accumulator registers.
template <int C, bool WITH_H, class IO>
__device__ __forceinline__ void fused_fwd_consumer(const FusedParams& p,
                                                   uint32_t tok,
                                                   uint32_t ring,
                                                   uint32_t bars, int wg) {
  typedef FusedFwd<C> F;
  constexpr int S = F::kSlots, J = F::kChunks, HID = 4 * C;
  constexpr bool kTmaOut = sizeof(IO) == 2;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t tbar = bars + 16 * S;  // token full[b] + 8 b, empty + 16
  const uint32_t xbar = tbar + 32 + 8 * (wg * 4 + warp);
  const uint32_t rows = wg * kRows64;   // this warpgroup's rows of a slab
  float acc[C / 2];  // the 64 x C output of this warpgroup
  float h0[32], h1[32];  // two 64 x 64 hidden chunks
  uint32_t fa[4][4];     // bf16 gelu(h) as wgmma A fragments, 4 K-steps
  if ((int)blockIdx.x >= p.tiles) return;
  mbar_wait(tbar, 0);
  mbar_wait(bars, 0);
  fused_h<C>(h0, tok + rows, ring);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(h0);
  int g = 0;             // chunks of the block's walk begun
  bool pending = false;  // bf16: the last tile's stores read a token tile
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    const int b = ti & 1;
    const bool more = tile + (int)gridDim.x < p.tiles;
    const uint32_t ua = tok + b * F::kTok + rows;
    // this thread's accumulator rows r0 and r0 + 8
    const int64_t r0 =
        (int64_t)tile * kTM + wg * 64 + warp * 16 + lane / 4;
    auto step = [&](float (&hc)[32], float (&hn)[32], int j) {
      const bool last = j == J - 1, next_tile = last && more;
      // the next chunk's h, the next tile's first after a tile's last; the
      // block's last chunk issues its own h again into hn (unused), so
      // that every step issues its products on the same path: ptxas
      // serializes wgmma issued under a branch
      const int pn = 2 * (g + (last && !more ? 0 : 1));  // its W1 rows
      if (next_tile) mbar_wait(tbar + 8 * (b ^ 1), ((ti + 1) >> 1) & 1);
      mbar_wait(bars + 8 * (pn % S), (pn / S) & 1);
      fused_h<C>(hn, next_tile ? tok + (b ^ 1) * F::kTok + rows : ua,
                 ring + (pn % S) * F::kSlot);
      wgmma_commit();
      fence_acc(hn);
      // this chunk's h and the last chunk's second product are done (its
      // A fragments free), the h just issued in flight. (Two fragment
      // sets, chunk g's GELU under chunk g - 1's product, make ptxas
      // serialize the products: registers a wgmma reads are written while
      // one is in flight.)
      wgmma_wait<1>();
      fence_acc(hc);
      fence_acc(acc);
      if (lane == 0) {  // this chunk's W1 rows, the last chunk's columns
        mbar_arrive(bars + 8 * (S + (2 * g) % S));
        if (g > 0) mbar_arrive(bars + 8 * (S + (2 * g - 1) % S));
      }
      if (j == 0 && pending) {
        // the last tile's stores have read the other token tile: it may
        // take the next tile's u
        if (lane == 0) {
          bulk_wait_read<0>();
          mbar_arrive(tbar + 16 + 8 * (b ^ 1));
        }
        pending = false;
      }
      if (last) {  // no product of this warpgroup reads its u rows now
        if constexpr (kTmaOut) {
          warpgroup_sync(1 + wg);
          if (lane == 0) {
            mbar_expect_tx(xbar, F::KC * kBoxRows * 128);
            for (int s = 0; s < F::KC; ++s)
              tma_load_2d(ua + s * F::kSlab + warp * kBoxRows * 128, &p.xo[0],
                          xbar, s * 64, tile * kTM + wg * 64 + warp * kBoxRows);
          }
        } else if (lane == 0) {
          mbar_arrive(tbar + 16 + 8 * b);
        }
      }
      // bias, GELU and bf16 in registers: element (row, 16 kk + 8 m + 2
      // (lane % 4) + e) of the chunk is hc[4 (2 kk + m) + 2 hh + e], which
      // is the A fragment's register fa[kk][2 m + hh], half e
      const float* bias = p.b1 + j * kHC + 2 * (lane % 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(bias + 8 * jj));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * jj + 2 * hh;
          const float v0 = hc[i] + bb.x, v1 = hc[i + 1] + bb.y;
          if constexpr (WITH_H) {  // the tail's forward saves h
            const int64_t row = r0 + 8 * hh;
            if (row < p.n)
              *reinterpret_cast<float2*>(p.h + row * HID + j * kHC +
                                         8 * jj + 2 * (lane % 4)) =
                  make_float2(v0, v1);
          }
          fa[jj / 2][2 * (jj % 2) + hh] = pack_bf16(gelu(v0), gelu(v1));
        }
      }
      // acc += fa . (W2 columns of the chunk)^T
      const int p2 = 2 * g + 1;
      mbar_wait(bars + 8 * (p2 % S), (p2 / S) & 1);
      const uint64_t db = smem_desc(ring + (p2 % S) * F::kSlot);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_frag(fa[kk]);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<C>(acc, fa[kk], db + 2 * kk, (j | kk) != 0);
      wgmma_commit();
      fence_acc(acc);
      ++g;
    };
    for (int j = 0; j < J; j += 2) {
      step(h0, h1, j);
      step(h1, h0, j + 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(h0);

    // epilogue: rows r0 and r0 + 8, columns 8 jj + 2 (lane % 4) + {0, 1}
    const int c0 = 2 * (lane % 4);
    if constexpr (kTmaOut) {
      // x from this warp's 16 rows of the token tile (a slab each 64
      // columns, the layout TMA gives a {64, 16} box under the 128-byte
      // swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)), out
      // written over it
      mbar_wait(xbar, ti & 1);
      const uint32_t wrows = ua + warp * kBoxRows * 128;
#pragma unroll
      for (int jj = 0; jj < C / 8; ++jj) {
        const int col = c0 + 8 * jj;
        const float2 gm = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
        const float2 bb = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = lane / 4 + 8 * hh;
          const uint32_t a = wrows + (jj / 8) * F::kSlab + r * 128 +
                             (((jj % 8) ^ (r & 7)) << 4) + 4 * (lane % 4);
          const uint32_t xw = ld_shared_b32(a);
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xw));
          st_shared_b32(a, pack_bf16(
              resid(xv.x, gm.x, acc[4 * jj + 2 * hh], bb.x),
              resid(xv.y, gm.y, acc[4 * jj + 2 * hh + 1], bb.y)));
        }
      }
      fence_async_shared();
      __syncwarp();
      if (lane == 0) {  // TMA leaves out what lies past the last token
        for (int s = 0; s < F::KC; ++s)
          tma_store_2d(&p.xo[1], wrows + s * F::kSlab, s * 64,
                       tile * kTM + wg * 64 + warp * kBoxRows);
        bulk_commit();
      }
      pending = true;
    } else {
      // with or without the residual x, chosen once a tile: a branch in
      // the loop would serialise the x loads. Each row from its own start
      // (a row past n from row 0's, and nothing stored), so that a column
      // is a constant offset.
      auto store = [&](auto with_x) {
        bool ok[2];
        int64_t rb[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          ok[hh] = r0 + 8 * hh < p.n;
          rb[hh] = (ok[hh] ? r0 + 8 * hh : 0) * C + c0;
        }
#pragma unroll
        for (int jj = 0; jj < C / 8; ++jj) {
          const float2 gm =
              __ldg(reinterpret_cast<const float2*>(p.gamma + c0) + 4 * jj);
          const float2 bb =
              __ldg(reinterpret_cast<const float2*>(p.b2 + c0) + 4 * jj);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            if (!ok[hh]) continue;
            float2 xv = make_float2(0.0f, 0.0f);
            if constexpr (decltype(with_x)::value)
              xv = ld2(static_cast<const IO*>(p.x) + rb[hh] + 8 * jj);
            st2(static_cast<IO*>(p.out) + rb[hh] + 8 * jj,
                make_float2(resid(xv.x, gm.x, acc[4 * jj + 2 * hh], bb.x),
                            resid(xv.y, gm.y, acc[4 * jj + 2 * hh + 1],
                                  bb.y)));
          }
        }
      };
      if (p.x)
        store(std::true_type());
      else
        store(std::false_type());
    }
  }
  // the token tiles must outlive the stores that read them
  if (kTmaOut && lane == 0) bulk_wait<0>();
}

// The backward's shared-memory plan. A token tile is KC slabs of 128 rows
// x 64 channels (16 KB each; the C = 96 tail zero-filled) of u and of
// gms; a ring slot holds one chunk operand: a W1 or W2^T chunk, KC slabs
// of 64 rows (8 KB each), or a W1^T chunk, C rows of 64 hidden units.
// READ_H (the MLP tail's): h is read, so neither u nor the W1 chunks.
template <int C, bool READ_H>
struct FusedBwd {
  static constexpr int KC = (C + 63) / 64;
  static constexpr uint32_t kSlab = kTM * 128;
  static constexpr int kTok0 = READ_H ? 1 : 0;  // first token tile loaded
  static constexpr uint32_t kTok = 2 * KC * kSlab;
  static constexpr uint32_t kPanel = KC * kRows64;
  static constexpr uint32_t kCols = C * 128;
  static constexpr uint32_t kSlot = kPanel > kCols ? kPanel : kCols;
  // ring slots per chunk: [W1,] W2^T, W1^T columns
  static constexpr int kPer = READ_H ? 2 : 3;
  static constexpr int kFit = (kSmemBudget - (int)kTok - 2048) / (int)kSlot;
  static constexpr int kSlots = kFit < 8 ? kFit : 8;
  static constexpr int kChunks = 4 * C / kHC;
  static constexpr size_t kSmem =
      1024 + kTok + (size_t)kSlots * kSlot + 8 * (2 * kSlots + 2);
  static_assert(C % 32 == 0 && C <= kFusedMaxC, "fused widths");
  static_assert(kSlots >= 3, "the ring needs three slots");
  static_assert(kSmem <= (size_t)kSmemMax, "shared memory");
};

template <int C, bool READ_H>
__device__ __forceinline__ void fused_bwd_producer(const FusedParams& p,
                                                   uint32_t tok,
                                                   uint32_t ring,
                                                   uint32_t bars) {
  typedef FusedBwd<C, READ_H> F;
  constexpr int S = F::kSlots;
  for (int t = F::kTok0; t < 2; ++t) {
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
    for (int t = F::kTok0; t < 2; ++t)
      for (int s = 0; s < F::KC; ++s)
        tma_load_2d(tok + (t * F::KC + s) * F::kSlab, &p.tok[t], tok_full,
                    s * 64, tile * kTM);
    for (int j = 0; j < F::kChunks; ++j) {
      for (int q = 0; q < F::kPer; ++q, ++it) {
        const int st = it % S;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
        const uint32_t dst = ring + st * F::kSlot;
        if (q == F::kPer - 1) {  // W1^T columns
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

// The backward's consumer warpgroup, 64 tokens of each tile; per chunk:
// h = u . W1c^T (or h read) and da = gms . W2^T_c, dh = bf16(da
// GELU'(h + b1)) in registers, du += dh . W1c; the LayerNorm backward in
// the epilogue.
template <int C, bool READ_H>
__device__ __forceinline__ void fused_bwd_consumer(const FusedParams& p,
                                                   uint32_t tok,
                                                   uint32_t ring,
                                                   uint32_t bars, int wg) {
  typedef FusedBwd<C, READ_H> F;
  constexpr int S = F::kSlots;
  constexpr int HID = 4 * C;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t tok_full = bars + 16 * S, tok_empty = tok_full + 8;
  float acc[C / 2];   // the 64 x C output of this warpgroup
  float h[READ_H ? 1 : 32];  // one 64 x 64 hidden chunk (not when read)
  float da[32];
  uint32_t fa[4][4];  // bf16 dh as wgmma A fragments, 4 K-steps
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
      if constexpr (!READ_H) {
        mbar_wait(bars + 8 * (it % S), (it / S) & 1);
        fused_h<C>(h, ua, ring + (it % S) * F::kSlot);
      } else {
        wgmma_fence();
      }
      const int i1 = READ_H ? it : it + 1;
      mbar_wait(bars + 8 * (i1 % S), (i1 / S) & 1);
      fused_h<C>(da, ga, ring + (i1 % S) * F::kSlot);
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
      // GELU'(h + b1) times da, bf16, in registers (the layout of the
      // forward's GELU)
      if constexpr (READ_H) {
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
            fa[jj / 2][2 * (jj % 2) + hh] =
                pack_bf16(da[i] * gelu_grad(h[i] + bb.x),
                          da[i + 1] * gelu_grad(h[i + 1] + bb.y));
          }
        }
      }
      // acc += fa . (W1^T columns of the chunk)^T
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

    // epilogue, the LayerNorm backward: rows r0 and r0 + 8, columns 8 jj +
    // 2 (lane % 4) + {0, 1}; a row's C columns sit in the four threads of
    // one quad
    const int c0 = 2 * (lane % 4);
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

// One kernel for both directions (BWD), so the block's and the tail's
// callers name one template. One branch per role for the whole kernel:
// setmaxnreg needs paths that never meet again.
template <int C, bool BWD, bool WITH_H, class IO>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fused_kernel(const __grid_constant__ FusedParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t tok = (raw + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  if constexpr (BWD) {
    typedef FusedBwd<C, WITH_H> F;
    const uint32_t ring = tok + F::kTok;
    // full[st] = bars + 8 st, empty[st] = bars + 8 (S + st), then the
    // token tile's full and empty
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
    if (wg == kConsumers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
      if (threadIdx.x % 128 == 0)
        fused_bwd_producer<C, WITH_H>(p, tok, ring, bars);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
      fused_bwd_consumer<C, WITH_H>(p, tok, ring, bars, wg);
    }
  } else {
    typedef FusedFwd<C> F;
    const uint32_t ring = tok + 2 * F::kTok;
    // full[st] = bars + 8 st, empty[st] = bars + 8 (S + st); then the
    // token tiles' full[b] and empty[b]; then the consumer warps' x
    // barriers
    const uint32_t bars = ring + F::kSlots * F::kSlot;
    const uint32_t tbar = bars + 16 * F::kSlots;
    if (threadIdx.x == 0) {
      for (int st = 0; st < F::kSlots; ++st) {
        mbar_init(bars + 8 * st, 1);
        mbar_init(bars + 8 * (F::kSlots + st), kConsumers * 4);
      }
      for (int b = 0; b < 2; ++b) {
        mbar_init(tbar + 8 * b, 1);
        mbar_init(tbar + 16 + 8 * b, kConsumers * 4);
      }
      for (int w = 0; w < kConsumers * 4; ++w) mbar_init(tbar + 32 + 8 * w, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (wg == kConsumers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
      if (threadIdx.x % 128 == 0)
        fused_fwd_weights<C>(p, ring, bars);
      else if (threadIdx.x % 128 == 32)
        fused_fwd_tokens<C>(p, tok, tbar);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
      fused_fwd_consumer<C, WITH_H, IO>(p, tok, ring, bars, wg);
    }
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
  CUtensorMap b[2];  // bf16 (n, k), box {64, BN}
  CUtensorMap o;     // kGelu, kResidBf16: out bf16 (m, n), box {64, 16}
  const float* bias;
  const void* x;     // kResid: f32, kResidBf16: bf16, like out
  const float* gamma;
  float* h;          // kGelu: written when not null; kDgeluH: read
  void* out;         // (m, n)
  int64_t m;
  int n, kc, tiles_n, tiles;
};

// The second forward GEMM's tile widths (BN: a 128 x BN output tile of
// out = x + gamma (h . W2^T + b2), each consumer warpgroup 64 x BN,
// m64nBNk16), widest first; gemm_bn picks one by the shape. Its n x C
// output has few tiles at the late stages (16^2 at batch 16: 192 of 128
// columns, a second wave for 60 of 132 SMs; 128 of 192, one wave). Every
// other GEMM takes 128 columns: the first forward GEMM's epilogue (a GELU
// on each element) is the longer part of its tiles, and a 128-column tile
// leaves room for six stages, which hold the next tile's K-steps while it
// runs (256 columns: 128 accumulator registers, which spill beside the
// GELU).
#define ROBSEG_GEMM_BN(X) X(192) X(128)

template <int EPI>
constexpr bool gemm_planned() {
  return EPI == kResid || EPI == kResidBf16;
}

// The GEMM's shared-memory plan: a ring of stages, each the K-step's A
// (128 rows x 64) and B (BN rows x 64) tiles (two of each for kDgelu);
// for bf16 outputs two 16-row x 64-column staging boxes a consumer warp
// (2 KB each, the layout of a TMA load of the box under the 128-byte
// swizzle); the mbarriers.
template <int EPI, int BN>
struct Gemm {
  static constexpr int kOps = EPI == kDgelu ? 2 : 1;
  static constexpr bool kTmaOut = EPI == kGelu || EPI == kResidBf16;
  static constexpr uint32_t kA = 128 * 128;
  static constexpr uint32_t kB = BN * 128;
  static constexpr uint32_t kStage = kOps * (kA + kB);
  static constexpr uint32_t kBox = kBoxRows * 128;
  static constexpr uint32_t kStaging = kTmaOut ? kConsumers * 4 * 2 * kBox : 0;
  static constexpr int kFit =
      (kSmemMax - 1024 - (int)kStaging - 16 * 6) / (int)kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStage + kStaging + 16 * kStages;
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(BN % 64 == 0 && BN <= 256, "tile widths");
  static_assert(gemm_planned<EPI>() || BN == 128, "tile widths by GEMM");
};

template <int EPI, int BN>
__device__ __forceinline__ void gemm_producer(const GemmParams& p,
                                              uint32_t base, uint32_t bars) {
  typedef Gemm<EPI, BN> G;
  constexpr int S = G::kStages;
  for (int o = 0; o < G::kOps; ++o) {
    prefetch_map(&p.a[o]);
    prefetch_map(&p.b[o]);
  }
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * 128, n0 = (tile % p.tiles_n) * BN;
    for (int k = 0; k < p.kc; ++k, ++it) {
      const int st = it % S;
      const uint32_t full = bars + 8 * st;
      mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
      mbar_expect_tx(full, G::kStage);
      const uint32_t s = base + st * G::kStage;
      for (int o = 0; o < G::kOps; ++o) {
        tma_load_2d(s + o * (G::kA + G::kB), &p.a[o], full, k * 64, m0);
        tma_load_2d(s + o * (G::kA + G::kB) + G::kA, &p.b[o], full, k * 64,
                    n0);
      }
    }
  }
}

// bf16 epilogue (kGelu, kResidBf16): the warp's 16 rows of the
// accumulator out through TMA stores, one 64-column box at a time into
// staging buffer (boxes & 1) of the warp's two; `boxes` counts the boxes
// the warp has issued. kGelu also writes h (f32, the tail's) from the
// registers; kResidBf16 reads x (bf16) there.
template <int EPI, int BN, class Opt>
__device__ __forceinline__ void gemm_store_tma(const GemmParams& p,
                                               const float (&d)[BN / 2],
                                               int64_t m0, int n0,
                                               uint32_t staging, int wg,
                                               int& boxes, Opt) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int64_t rw = m0 + wg * 64 + warp * kBoxRows;  // the warp's first row
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
    const uint32_t buf = staging + (boxes & 1) * Gemm<EPI, BN>::kBox;
    // the store issued two boxes ago read this buffer
    if (lane == 0) bulk_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * q + jj;
      const int col = n0 + 64 * q + 8 * jj + 2 * (lane % 4);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      float2 gm = make_float2(0.0f, 0.0f);
      if constexpr (EPI == kResidBf16)
        gm = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = lane / 4 + 8 * hh;
        const int64_t row = rw + r;
        const float v0 = d[4 * j + 2 * hh], v1 = d[4 * j + 2 * hh + 1];
        uint32_t w;
        if constexpr (EPI == kGelu) {
          const float a0 = v0 + bb.x, a1 = v1 + bb.y;
          if (Opt::value && row < p.m)
            *reinterpret_cast<float2*>(p.h + row * p.n + col) =
                make_float2(a0, a1);
          w = pack_bf16(gelu(a0), gelu(a1));
        } else {
          float2 xv = make_float2(0.0f, 0.0f);
          if (row < p.m)
            xv = ld2(static_cast<const bf16*>(p.x) + row * p.n + col);
          w = pack_bf16(resid(xv.x, gm.x, v0, bb.x),
                        resid(xv.y, gm.y, v1, bb.y));
        }
        // 16-byte chunk jj of row r sits at chunk jj ^ (r % 8)
        st_shared_b32(buf + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * (lane % 4),
                      w);
      }
    }
    fence_async_shared();
    __syncwarp();
    if (lane == 0) {  // TMA leaves out what lies past the last row
      tma_store_2d(&p.o, buf, n0 + 64 * q, (int)rw);
      bulk_commit();
    }
    ++boxes;
  }
}

// float32 and backward epilogues, from the registers: rows r0 and r0 + 8,
// columns n0 + 8 j + 2 (lane % 4) + {0, 1}, each row reached from its own
// start (a row past m from row 0's, and nothing stored), so that a column
// is a constant offset
template <int EPI, int BN, class Opt>
__device__ __forceinline__ void gemm_store_regs(const GemmParams& p,
                                                const float (&d)[BN / 2],
                                                const float* d2, int64_t m0,
                                                int n0, int wg, Opt) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int64_t r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const int c0 = n0 + 2 * (lane % 4);
  bool ok[2];
  int64_t rb[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ok[hh] = r0 + 8 * hh < p.m;
    rb[hh] = (ok[hh] ? r0 + 8 * hh : 0) * p.n + c0;
  }
  const float* bias = p.bias + c0;
  const float* gamma = p.gamma + c0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float2 bb = make_float2(0.0f, 0.0f), g = make_float2(0.0f, 0.0f);
    if constexpr (EPI == kResid || EPI == kDgelu)
      bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * j));
    if constexpr (EPI == kResid)
      g = __ldg(reinterpret_cast<const float2*>(gamma + 8 * j));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!ok[hh]) continue;
      const int i = 4 * j + 2 * hh;
      if constexpr (EPI == kDgeluH) {
        const float2 hv =
            __ldg(reinterpret_cast<const float2*>(p.h + rb[hh]) + 4 * j);
        reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + rb[hh])[4 * j] =
            pack_bf16(d[i] * gelu_grad(hv.x), d[i + 1] * gelu_grad(hv.y));
      } else if constexpr (EPI == kDgelu) {
        reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.out) + rb[hh])[4 * j] =
            pack_bf16(d2[i] * gelu_grad(d[i] + bb.x),
                      d2[i + 1] * gelu_grad(d[i + 1] + bb.y));
      } else if constexpr (EPI == kResid) {
        float2 xv = make_float2(0.0f, 0.0f);
        if constexpr (Opt::value)
          xv = __ldg(reinterpret_cast<const float2*>(
                         static_cast<const float*>(p.x) + rb[hh]) + 4 * j);
        reinterpret_cast<float2*>(static_cast<float*>(p.out) + rb[hh])[4 * j] =
            make_float2(resid(xv.x, g.x, d[i], bb.x),
                        resid(xv.y, g.y, d[i + 1], bb.y));
      } else {
        reinterpret_cast<float2*>(static_cast<float*>(p.out) + rb[hh])[4 * j] =
            make_float2(d[i], d[i + 1]);
      }
    }
    // loads move no further than 64 columns ahead (all of them hoisted
    // spill at BN = 192)
    if (j % 8 == 7) asm volatile("" ::: "memory");
  }
}

template <int EPI, int BN>
__device__ __forceinline__ void gemm_consumer(const GemmParams& p,
                                              uint32_t base, uint32_t bars,
                                              int wg) {
  typedef Gemm<EPI, BN> G;
  constexpr int S = G::kStages;
  const int lane = threadIdx.x % 32;
  const uint32_t staging =
      base + S * G::kStage + (threadIdx.x / 32) * 2 * G::kBox;
  float d[BN / 2];
  float d2[G::kOps == 2 ? BN / 2 : 1];
  int boxes = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int64_t m0 = (int64_t)(tile / p.tiles_n) * 128;
    const int n0 = (tile % p.tiles_n) * BN;
    for (int k = 0; k < p.kc; ++k, ++it) {
      const int st = it % S;
      mbar_wait(bars + 8 * st, (it / S) & 1);
      const uint32_t s = base + st * G::kStage;
      fence_acc(d);
      fence_acc(d2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<BN>(d, smem_desc(s + wg * kRows64) + 2 * kk,
                     smem_desc(s + G::kA) + 2 * kk, (k | kk) != 0);
      if constexpr (G::kOps == 2) {
        const uint32_t s2 = s + G::kA + G::kB;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BN>(d2, smem_desc(s2 + wg * kRows64) + 2 * kk,
                       smem_desc(s2 + G::kA) + 2 * kk, (k | kk) != 0);
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

    // the residual x (kResid) and the h store (kGelu) chosen once a tile:
    // a branch in the loop would serialise the loads
    const bool opt = (EPI == kResid && p.x) || (EPI == kGelu && p.h);
    if constexpr (G::kTmaOut) {
      if (opt)
        gemm_store_tma<EPI, BN>(p, d, m0, n0, staging, wg, boxes,
                                std::true_type());
      else
        gemm_store_tma<EPI, BN>(p, d, m0, n0, staging, wg, boxes,
                                std::false_type());
    } else if (opt) {
      gemm_store_regs<EPI, BN>(p, d, d2, m0, n0, wg, std::true_type());
    } else {
      gemm_store_regs<EPI, BN>(p, d, d2, m0, n0, wg, std::false_type());
    }
  }
  // the staging buffers must outlive the stores that read them
  if (G::kTmaOut && lane == 0) bulk_wait<0>();
}

template <int EPI, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_gemm_kernel(const __grid_constant__ GemmParams p) {
  typedef Gemm<EPI, BN> G;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + G::kStages * G::kStage + G::kStaging;
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
    if (threadIdx.x % 128 == 0) gemm_producer<EPI, BN>(p, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    gemm_consumer<EPI, BN>(p, base, bars, wg);
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

// The fused MLP; with h (WITH_H) the backward reads neither u nor panel0
// (W1), which may be null. IO: the forward's x and out (the backward
// writes f32 dyconv whatever the block's I/O); the bf16 forward needs x.
template <int C, bool BWD, bool WITH_H = false, class IO = float>
int launch_fused(FusedParams& p, const void* u, const void* gms,
                 const void* panel0, const void* panel1, const void* cols,
                 int sms, cudaStream_t stream) {
  constexpr bool kReadH = BWD && WITH_H;
  constexpr size_t kSmem =
      BWD ? FusedBwd<C, WITH_H>::kSmem : FusedFwd<C>::kSmem;
  int e = 0;
  if (!kReadH) e = map2d(&p.tok[0], u, p.n, C, kTM);
  if (!e && BWD) e = map2d(&p.tok[1], gms, p.n, C, kTM);
  if (!e && !kReadH) e = map2d(&p.panel[0], panel0, 4 * C, C, kHC);
  if (!e && BWD) e = map2d(&p.panel[1], panel1, 4 * C, C, kHC);
  if (!e) e = map2d(&p.cols, cols, C, 4 * C, C);
  if (!BWD && sizeof(IO) == 2) {  // x and out through TMA, a warp's rows
    if (!p.x) return (int)cudaErrorInvalidValue;
    if (!e) e = map2d(&p.xo[0], p.x, p.n, C, kBoxRows);
    if (!e) e = map2d(&p.xo[1], p.out, p.n, C, kBoxRows);
  }
  if (e) return e;
  p.tiles = (int)((p.n + kTM - 1) / kTM);
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_fused_kernel<C, BWD, WITH_H, IO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_fused_kernel<C, BWD, WITH_H, IO><<<grid_for(p.tiles, sms), kThreads,
                                         kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The second GEMM's tile width: of the widths of ROBSEG_GEMM_BN that divide
// n, the one whose 128 x BN tiles take the fewest columns of waves over
// the SMs (ceil(tiles / sms) BN), the widest on a tie (fewer bytes through
// L2 per product). 0 if none divides n.
int gemm_bn(int64_t m, int n, int sms) {
  const int64_t mt = (m + 127) / 128;
  int best = 0;
  int64_t cost = 0;
  const int widths[] = {
#define X(BN) BN,
      ROBSEG_GEMM_BN(X)
#undef X
  };
  for (int bn : widths) {
    if (n % bn || sms < 1) continue;
    const int64_t c = (mt * (n / bn) + sms - 1) / sms * bn;
    if (best == 0 || c < cost) {
      best = bn;
      cost = c;
    }
  }
  return best;
}

// out (m, n) from A (m, k) [and A2] and B (n, k) [and B2], all bf16, in
// 128 x BN tiles
template <int EPI, int BN>
int launch_gemm_bn(GemmParams& p, const void* a, const void* b,
                   const void* a2, const void* b2, int k, int sms,
                   cudaStream_t stream) {
  typedef Gemm<EPI, BN> G;
  if (p.n % BN || k % 64) return (int)cudaErrorInvalidValue;
  if (EPI == kResidBf16 && !p.x) return (int)cudaErrorInvalidValue;
  int e = map2d(&p.a[0], a, p.m, k, 128);
  if (!e) e = map2d(&p.b[0], b, p.n, k, BN);
  if (!e && G::kOps == 2) e = map2d(&p.a[1], a2, p.m, k, 128);
  if (!e && G::kOps == 2) e = map2d(&p.b[1], b2, p.n, k, BN);
  if (!e && G::kTmaOut) e = map2d(&p.o, p.out, p.m, p.n, 16);
  if (e) return e;
  p.kc = k / 64;
  p.tiles_n = p.n / BN;
  const int64_t tiles = (p.m + 127) / 128 * p.tiles_n;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_gemm_kernel<EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_gemm_kernel<EPI, BN><<<grid_for(p.tiles, sms), kThreads, G::kSmem,
                             stream>>>(p);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_gemm(GemmParams& p, const void* a, const void* b, const void* a2,
                const void* b2, int k, int sms, cudaStream_t stream) {
  if constexpr (gemm_planned<EPI>()) {
    switch (gemm_bn(p.m, p.n, sms)) {
#define X(BN)                                                          \
  case BN:                                                             \
    return launch_gemm_bn<EPI, BN>(p, a, b, a2, b2, k, sms, stream);
      ROBSEG_GEMM_BN(X)
#undef X
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return launch_gemm_bn<EPI, 128>(p, a, b, a2, b2, k, sms, stream);
  }
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
                              int64_t n, int C, int sms, cudaStream_t s);   \
  int robseg_mlp_dx_##SUFFIX(const float* x, const float* h,                \
                             const float* gout, const float* ls,            \
                             const float* lb, const float* w1,              \
                             const float* b1, const float* w2,              \
                             const float* gamma, void* scratch, float* dx,  \
                             int64_t n, int C, int sms, cudaStream_t s);
ROBSEG_MLP_DECLARE(f32)
ROBSEG_MLP_DECLARE(bf16)
#undef ROBSEG_MLP_DECLARE
