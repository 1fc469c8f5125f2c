// The whole ConvNeXt block, forward and input gradient, for Hopper.
//
//   out = x + gamma * (W2 . GELU(W1 . LN(dwconv7x7(x) + b_dw) + b1) + b2)
//
// Replaces: robseg_tpu/kernels/convnext_block.py, both entry points:
//   convnext_block_fused        (_fwd_kernel, _bwd_kernel; stages 0-1)
//   convnext_block_fused_whole  (_fwd_kernel_whole, _bwd_kernel_whole;
//                                stages 2-3)
// One implementation covers every width C in {96 .. 1024} and any H, W.
//
// Numerics follow the TPU kernel (convnext_block.py:85,133-137): matmul
// operands are rounded to bf16 (u = LN(.) * ls + lb, W1, W2 and gelu(h) in
// the forward; gamma * dy and dh in the backward), products accumulate in
// f32; the dwconv, LayerNorm (eps 1e-6), GELU (the exact erff) and every
// sum run in f32. The backward recomputes dwconv and LN from x and saves
// nothing from the forward, as the TPU kernel does.
//
// Bound on the H100: 16 C^2 bf16 operations per token forward (two
// matmuls), 24 C^2 backward (three), against 8 (forward) or 12 (backward)
// bytes per token and channel of f32 activations: at C = 96 the bytes
// bound (16 C / 8 = 192 operations a byte, under the card's ~295), above
// it the operations.
//
// Launches:
//   forward  = pack (the parameters into the kernels' layouts) + dwconv_ln
//              (u = LN(dwconv(x)) * ls + lb as bf16, the first matmul's
//              operand) + the MLP (writes out);
//   backward = pack + dwconv_ln again (also xhat, 1/sigma and gms =
//              bf16(gamma * dy)) + the MLP backward with the LayerNorm
//              backward (writes dyconv) + dwcorr (dx = dy + the 7x7
//              correlation of dyconv with the flipped depthwise taps).
//
// The MLP runs on the tensor cores through wgmma, its operands brought into
// shared memory by TMA (zero fill covers the channel tail of C = 96, and the
// ragged last token tile), in one of two forms chosen by width:
//
// - C <= 192: one fused kernel, mlp_fused_kernel; the 4C hidden layer never
//   leaves the chip. A persistent block (one per SM) walks 128-token
//   tiles. One producer thread streams, per 64-wide hidden chunk, the W1
//   rows of the chunk (64 x C) and the W2 columns (C x 64) into a ring of
//   shared-memory slots with full/empty mbarriers, and the token tile (u;
//   in the backward also gms) into its own buffer. Two consumer
//   warpgroups own 64 tokens each. Per chunk: h = u . W1c^T with wgmma
//   from shared memory (m64n64k16); bias, erf-GELU and bf16 rounding in
//   registers; then acc += gelu(h) . W2c^T with the A operand straight
//   from those registers (wgmma with A in registers, m64nCk16: the
//   accumulator layout of h is the A-fragment layout), so gelu(h) touches
//   shared memory nowhere. The next chunk's weights land while this one
//   computes, and one warpgroup's epilogue overlaps the other's products.
//   The backward takes three slots per chunk: h = u . W1c^T and da = gms .
//   W2^T_c (two m64n64k16 products sharing the token tile), dh = bf16(da *
//   GELU'(h + b1)) in registers, du += dh . W1c (A in registers); the
//   LayerNorm backward runs in the epilogue, where each row's C columns sit
//   in the four threads of one quad.
//   Registers per consumer thread (setmaxnreg 232): the 64 x C f32 output
//   accumulator C / 2 (48 / 64 / 96 at C = 96 / 128 / 192), h 32, da 32
//   (backward), the bf16 A fragments 16: at most 176 plus addressing.
// - C >= 256: the accumulator would take 128 (C = 256), 192 (384) or 384
//   (768) registers a thread; with h, da and the fragments beside it 256
//   and 384 leave no room, and splitting 384's columns over two
//   warpgroups needs both chunks' W1 and W2 panels (96 KB each) in flight
//   beside the token tile, more than 227 KB holds with two stages. So the
//   hidden layer goes to device memory as bf16, which is the rounding the
//   kernel applies to it anyway (results unchanged), through two GEMMs
//   (mlp_gemm_kernel, persistent, 128 x 128 tiles, K-steps of 64 through a
//   TMA ring, two consumer warpgroups with m64n128k16) with fused
//   epilogues: forward h = bf16(gelu(u . W1^T + b1)), then out = x + gamma
//   * (h . W2^T + b2); backward dh = bf16((gms . W2) * GELU'(u . W1^T +
//   b1)) (two accumulators), then du = dh . W1, whose LayerNorm backward is
//   a row pass (ln_bwd_kernel) before dwcorr. Each moves 2 bytes of
//   hidden layer per C products of it, C / 2 >= 128 operations a byte of
//   hidden traffic: at C = 384, 100 MB more than the fused form at batch
//   16 (0.03 ms at 3.35 TB/s) against 0.04 ms of products.
//
// The weight panels are packed once per call on the host side (bf16, and
// for the backward W2^T (4C, C) and W1^T (C, 4C), each K-major), the
// tensor maps encoded by the entry points (hopper.cuh::encode).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kDwThreads = 256;  // dwconv_ln_kernel: 8 warps
constexpr int kDwTokens = 8;     // dwcorr_kernel: tokens of one row
constexpr int kDwRowThreads = 128;
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

// The depthwise pass of dwconv_ln_kernel. A block takes a
// TH x TW tile of one image and every channel, 32 channels at a time: it
// stages the chunk's (TH + 6) x (TW + 6) halo in shared memory (16-byte
// loads, zeros outside the image: the padding), so each input element
// leaves L2 (TH + 6)(TW + 6) / (TH TW) times instead of once per output row
// (12.25 times in 8-token row segments). Lane l of each warp takes channel
// l of the chunk (conflict-free shared reads), keeps its 49 taps in
// registers and computes an RH x RW patch of the tile, sliding a
// (RW + 6)-wide window down the patch's RH + 6 input rows: input row r adds
// its values to the output rows r - ky it reaches. Each output sums its
// taps ky-major, kx-minor, as a direct loop would. The forward pass keeps
// y = dwconv + bias for the whole tile and every channel in shared memory
// and then normalises it, one warp per token. TH x TW shrinks as C grows
// (tile_for), so y stays within 48 KB.
template <int TH_, int TW_, int RH_, int RW_>
struct DwTile {
  static constexpr int TH = TH_, TW = TW_, RH = RH_, RW = RW_;
  static constexpr int HH = TH + 6, HW = TW + 6;  // halo rows, columns
  static constexpr int WC = TW / RW;              // warps across the tile
  static_assert((TH / RH) * WC == kDwThreads / 32, "one patch a warp");
  static constexpr int kHalo = HH * HW * 32;      // floats of one chunk
  static size_t smem(int C, bool ln) {
    return sizeof(float) * (kHalo + (ln ? (size_t)TH * TW * C : 0));
  }
};

// out[o][t] = sum_{ky,kx} halo[ry + o + ky][rx + t + kx] * tap[ky][kx]
// for this lane's channel; tap already flipped for the correlation
template <class T>
__device__ __forceinline__ void dw_patch(const float* halo, const float (&tap)[49],
                                        int ry, int rx, int lane,
                                        float (&acc)[T::RH][T::RW]) {
#pragma unroll
  for (int o = 0; o < T::RH; ++o)
#pragma unroll
    for (int t = 0; t < T::RW; ++t) acc[o][t] = 0.0f;
#pragma unroll
  for (int r = 0; r < T::RH + 6; ++r) {
    float v[T::RW + 6];
#pragma unroll
    for (int j = 0; j < T::RW + 6; ++j)
      v[j] = halo[((ry + r) * T::HW + rx + j) * 32 + lane];
#pragma unroll
    for (int ky = 0; ky < 7; ++ky) {
      const int o = r - ky;
      if (o < 0 || o >= T::RH) continue;
#pragma unroll
      for (int t = 0; t < T::RW; ++t)
#pragma unroll
        for (int kx = 0; kx < 7; ++kx)
          acc[o][t] = fmaf(v[t + kx], tap[ky * 7 + kx], acc[o][t]);
    }
  }
}

// stage channels [c0, c0 + 32) of the tile's halo, zero outside the image
template <class T>
__device__ __forceinline__ void dw_stage(float* halo,
                                         const float* __restrict__ src,
                                         int64_t b, int y0, int x0, int H,
                                         int W, int C, int c0) {
  for (int i = threadIdx.x; i < T::HH * T::HW * 8; i += kDwThreads) {
    const int px = i / 8, q = i % 8;
    const int hy = y0 - 3 + px / T::HW, hx = x0 - 3 + px % T::HW;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (hy >= 0 && hy < H && hx >= 0 && hx < W)
      v = __ldg(reinterpret_cast<const float4*>(
                    src + ((b * H + hy) * (int64_t)W + hx) * C + c0) +
                q);
    reinterpret_cast<float4*>(halo)[i] = v;
  }
}

// u = LN(dwconv(x) + dwb) * ls + lb as bf16; for the backward also xhat
// (f32), inv = 1/sqrt(var + eps) per token and gms = bf16(gamma * dy).
// Grid (ceil(W / TW), ceil(H / TH), B).
template <class T>
__global__ void __launch_bounds__(kDwThreads)
dwconv_ln_kernel(const float* __restrict__ x, const float* __restrict__ dwt,
                 const float* __restrict__ dwb, const float* __restrict__ ls,
                 const float* __restrict__ lb, bf16* __restrict__ u,
                 float* __restrict__ xhat, float* __restrict__ inv_out,
                 const float* __restrict__ dy,
                 const float* __restrict__ gamma, bf16* __restrict__ gms,
                 int H, int W, int C) {
  extern __shared__ float4 dw_smem[];
  float* halo = reinterpret_cast<float*>(dw_smem);
  float* ys = halo + T::kHalo;  // [TH * TW][C]
  const int x0 = blockIdx.x * T::TW, y0 = blockIdx.y * T::TH;
  const int64_t b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = (warp / T::WC) * T::RH, rx = (warp % T::WC) * T::RW;
  for (int c0 = 0; c0 < C; c0 += 32) {
    __syncthreads();  // the last chunk's halo is read
    dw_stage<T>(halo, x, b, y0, x0, H, W, C, c0);
    __syncthreads();
    const int c = c0 + lane;
    float tap[49];
#pragma unroll
    for (int i = 0; i < 49; ++i) tap[i] = __ldg(dwt + i * C + c);
    float acc[T::RH][T::RW];
    dw_patch<T>(halo, tap, ry, rx, lane, acc);
    const float bias = __ldg(dwb + c);
#pragma unroll
    for (int o = 0; o < T::RH; ++o)
#pragma unroll
      for (int t = 0; t < T::RW; ++t)
        ys[((ry + o) * T::TW + rx + t) * C + c] = acc[o][t] + bias;
  }
  __syncthreads();
  for (int t = warp; t < T::TH * T::TW; t += kDwThreads / 32) {
    const int hh = y0 + t / T::TW, ww = x0 + t % T::TW;
    if (hh >= H || ww >= W) continue;
    const float* yr = ys + t * C;
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += yr[c];
    const float mean = warp_sum(s) / C;
    float q = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = yr[c] - mean;
      q += d * d;
    }
    const float inv = rsqrtf(warp_sum(q) / C + 1e-6f);
    const int64_t tok = (b * H + hh) * (int64_t)W + ww;
    for (int c = lane; c < C; c += 32) {
      const float xh = (yr[c] - mean) * inv;
      u[tok * C + c] = __float2bfloat16(xh * ls[c] + lb[c]);
      if (xhat) xhat[tok * C + c] = xh;
      if (gms) gms[tok * C + c] = __float2bfloat16(gamma[c] * dy[tok * C + c]);
    }
    if (inv_out && lane == 0) inv_out[tok] = inv;
  }
}

// dx = dy + corr7x7(dyconv, flipped taps), in row segments: a block takes
// kDwTokens tokens of one row and every channel, a thread one channel
// with its window of kDwTokens + 6 inputs per row in registers. With no
// LayerNorm to hold a tile together, small blocks keep more loads in
// flight: the staged tile form of dwconv_ln_kernel measured slower for
// this pass at every stage on the H100. Grid (ceil(W / kDwTokens), H, B).
__global__ void __launch_bounds__(kDwRowThreads)
dwcorr_kernel(const float* __restrict__ dyconv, const float* __restrict__ dwt,
              const float* __restrict__ dy, float* __restrict__ dx, int H,
              int W, int C) {
  const int w0 = blockIdx.x * kDwTokens;
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int ntok = min(kDwTokens, W - w0);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[kDwTokens];
#pragma unroll
    for (int t = 0; t < kDwTokens; ++t) acc[t] = 0.0f;
    for (int ky = 0; ky < 7; ++ky) {
      const int hh = h + ky - 3;
      if (hh < 0 || hh >= H) continue;
      const float* row = dyconv + ((b * H + hh) * (int64_t)W) * C + c;
      float v[kDwTokens + 6];
#pragma unroll
      for (int j = 0; j < kDwTokens + 6; ++j) {
        const int ww = w0 + j - 3;
        v[j] = (ww >= 0 && ww < W) ? row[(int64_t)ww * C] : 0.0f;
      }
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        const float wt = dwt[((6 - ky) * 7 + (6 - kx)) * C + c];
#pragma unroll
        for (int t = 0; t < kDwTokens; ++t)
          acc[t] = fmaf(v[t + kx], wt, acc[t]);
      }
    }
    const int64_t tok0 = (b * H + h) * (int64_t)W + w0;
#pragma unroll
    for (int t = 0; t < kDwTokens; ++t) {
      if (t < ntok) {
        const int64_t i = (tok0 + t) * C + c;
        dx[i] = dy[i] + acc[t];
      }
    }
  }
}

// The packing, one launch per call: up to four jobs, each a transpose
// dst (cols, rows) = src (rows, cols)^T through 32 x 32 shared-memory
// tiles (the depthwise taps (C, 49) -> (49, C) in f32; W2^T and W1^T in
// bf16) or a cast of rows * cols floats to bf16 (W1, W2). The blocks are
// dealt to the jobs in order; block (32, 8).
struct PackJob {
  const float* src;
  void* dst;
  int rows, cols;
  int kind;    // kTransposeF32, kTransposeBf16 or kCastBf16
  int blocks;  // 32 x 32 tiles, or 2048-element runs of the cast
};
enum { kTransposeF32 = 0, kTransposeBf16 = 1, kCastBf16 = 2 };
struct PackParams {
  PackJob job[4];
  int jobs;
};

__global__ void __launch_bounds__(256)
    pack_kernel(const __grid_constant__ PackParams p) {
  __shared__ float tile[32][33];
  int b = blockIdx.x, j = 0;
  while (j + 1 < p.jobs && b >= p.job[j].blocks) b -= p.job[j++].blocks;
  const PackJob& q = p.job[j];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (q.kind == kCastBf16) {  // 2048 elements a block, 8 a thread
    const int64_t n = (int64_t)q.rows * q.cols;
    for (int k = 0; k < 2; ++k) {
      const int64_t i = (int64_t)b * 512 + k * 256 + tid;  // float4 index
      if (4 * i >= n) break;
      const float4 v = reinterpret_cast<const float4*>(q.src)[i];
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(q.dst) + 2 * i;
      o[0] = __floats2bfloat162_rn(v.x, v.y);
      o[1] = __floats2bfloat162_rn(v.z, v.w);
    }
    return;
  }
  const int tx = (q.cols + 31) / 32;
  const int c0 = (b % tx) * 32, r0 = (b / tx) * 32;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + threadIdx.x;
    if (r < q.rows && c < q.cols)
      tile[i][threadIdx.x] = q.src[(int64_t)r * q.cols + c];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + threadIdx.x;
    if (r < q.rows && c < q.cols) {
      const int64_t o = (int64_t)c * q.rows + r;
      if (q.kind == kTransposeF32)
        static_cast<float*>(q.dst)[o] = tile[threadIdx.x][i];
      else
        static_cast<bf16*>(q.dst)[o] = __float2bfloat16(tile[threadIdx.x][i]);
    }
  }
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
  const float* x;        // forward epilogue: out = x + gamma (acc + b2)
  const float* b2;
  const float* gamma;
  float* out;
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
// each), or a W2 or W1^T chunk, C rows of 64 hidden units.
template <int C, bool BWD>
struct Fused {
  static constexpr int KC = (C + 63) / 64;
  static constexpr uint32_t kSlab = kTM * 128;
  static constexpr uint32_t kTok = (BWD ? 2 : 1) * KC * kSlab;
  static constexpr uint32_t kPanel = KC * kRows64;
  static constexpr uint32_t kCols = C * 128;
  static constexpr uint32_t kSlot = kPanel > kCols ? kPanel : kCols;
  static constexpr int kPer = BWD ? 3 : 2;  // ring slots per chunk
  static constexpr int kFit = (kSmemBudget - (int)kTok - 2048) / (int)kSlot;
  static constexpr int kSlots = kFit < 8 ? kFit : 8;
  static constexpr int kChunks = 4 * C / kHC;
  static constexpr size_t kSmem =
      1024 + kTok + (size_t)kSlots * kSlot + 8 * (2 * kSlots + 2);
  static_assert(C % 32 == 0 && C <= kFusedMaxC, "fused widths");
  static_assert(kSlots >= 3, "the ring needs three slots");
  static_assert(kSmem <= 232448, "shared memory");
};

template <int C, bool BWD>
__device__ __forceinline__ void fused_producer(const FusedParams& p,
                                               uint32_t tok, uint32_t ring,
                                               uint32_t bars) {
  typedef Fused<C, BWD> F;
  constexpr int S = F::kSlots;
  prefetch_map(&p.tok[0]);
  prefetch_map(&p.panel[0]);
  prefetch_map(&p.cols);
  if (BWD) {
    prefetch_map(&p.tok[1]);
    prefetch_map(&p.panel[1]);
  }
  const uint32_t tok_full = bars + 16 * S, tok_empty = tok_full + 8;
  int it = 0;  // ring slots filled by this block, over all its tiles
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    mbar_wait(tok_empty, (ti & 1) ^ 1);
    mbar_expect_tx(tok_full, F::kTok);
    for (int t = 0; t < (BWD ? 2 : 1); ++t)
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
            tma_load_2d(dst + s * kRows64, &p.panel[q], full, s * 64,
                        j * kHC);
        }
      }
    }
  }
}

template <int C, bool BWD>
__device__ __forceinline__ void fused_consumer(const FusedParams& p,
                                               uint32_t tok, uint32_t ring,
                                               uint32_t bars, int wg) {
  typedef Fused<C, BWD> F;
  constexpr int S = F::kSlots;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t tok_full = bars + 16 * S, tok_empty = tok_full + 8;
  float acc[C / 2];   // the 64 x C output of this warpgroup
  float h[32];        // one 64 x 64 hidden chunk
  float da[BWD ? 32 : 1];
  uint32_t fa[4][4];  // bf16 gelu(h) / dh as wgmma A fragments, 4 K-steps
  int it = 0;
  int ti = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x, ++ti) {
    mbar_wait(tok_full, ti & 1);
    const uint32_t ua = tok + wg * kRows64;  // this warpgroup's 64 rows
    const uint32_t ga = ua + F::KC * F::kSlab;
    for (int j = 0; j < F::kChunks; ++j, it += F::kPer) {
      // h = u . W1c^T (and da = gms . W2^T_c)
      mbar_wait(bars + 8 * (it % S), (it / S) & 1);
      const uint32_t w1 = ring + (it % S) * F::kSlot;
      fence_acc(h);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < F::KC; ++s)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64>(h, smem_desc(ua + s * F::kSlab) + 2 * kk,
                       smem_desc(w1 + s * kRows64) + 2 * kk, (s | kk) != 0);
      if constexpr (BWD) {
        const int i1 = it + 1;
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
      const float* bias = p.b1 + j * kHC + 2 * (lane % 4);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * jj));
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
          }
          fa[jj / 2][2 * (jj % 2) + hh] = pack_bf16(g0, g1);
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
    const int64_t r0 =
        (int64_t)tile * kTM + wg * 64 + warp * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    if constexpr (!BWD) {
#pragma unroll
      for (int jj = 0; jj < C / 8; ++jj) {
        const int col = c0 + 8 * jj;
        const float2 g = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
        const float2 b = __ldg(reinterpret_cast<const float2*>(p.b2 + col));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t row = r0 + 8 * hh;
          if (row < p.n) {
            const int64_t o = row * C + col;
            const float2 xv = __ldg(reinterpret_cast<const float2*>(p.x + o));
            *reinterpret_cast<float2*>(p.out + o) = make_float2(
                xv.x + g.x * (acc[4 * jj + 2 * hh] + b.x),
                xv.y + g.y * (acc[4 * jj + 2 * hh + 1] + b.y));
          }
        }
      }
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

template <int C, bool BWD>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_fused_kernel(const __grid_constant__ FusedParams p) {
  typedef Fused<C, BWD> F;
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
    if (threadIdx.x % 128 == 0) fused_producer<C, BWD>(p, tok, ring, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    fused_consumer<C, BWD>(p, tok, ring, bars, wg);
  }
}

// ---------------------------------------------------------------------
// The two-GEMM form (C >= 256): out (m x n) = A (m x k) . B (n x k)^T with
// a fused epilogue

enum Epi {
  kGelu = 0,   // out bf16 = gelu(acc + bias)
  kResid = 1,  // out f32 = x + gamma * (acc + bias)
  kDgelu = 2,  // out bf16 = acc2 * gelu'(acc + bias); acc2 = A2 . B2^T
  kStore = 3,  // out f32 = acc
};

struct GemmParams {
  CUtensorMap a[2];  // bf16 (m, k), box {64, 128}
  CUtensorMap b[2];  // bf16 (n, k), box {64, 128}
  const float* bias;
  const float* x;
  const float* gamma;
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

    // epilogue: rows r0 and r0 + 8, columns n0 + 8 j + 2 (lane % 4) + {0, 1}
    const int64_t r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j;
      float2 bb = make_float2(0.0f, 0.0f), g = make_float2(0.0f, 0.0f);
      if constexpr (EPI != kStore)
        bb = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      if constexpr (EPI == kResid)
        g = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = r0 + 8 * hh;
        if (row >= p.m) continue;
        const int64_t o = row * p.n + col;
        const int i = 4 * j + 2 * hh;
        if constexpr (EPI == kGelu) {
          reinterpret_cast<uint32_t*>(p.out)[o / 2] =
              pack_bf16(gelu(d[i] + bb.x), gelu(d[i + 1] + bb.y));
        } else if constexpr (EPI == kDgelu) {
          reinterpret_cast<uint32_t*>(p.out)[o / 2] =
              pack_bf16(d2[i] * gelu_grad(d[i] + bb.x),
                        d2[i + 1] * gelu_grad(d[i + 1] + bb.y));
        } else if constexpr (EPI == kResid) {
          const float2 xv = __ldg(reinterpret_cast<const float2*>(p.x + o));
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(xv.x + g.x * (d[i] + bb.x),
                          xv.y + g.y * (d[i + 1] + bb.y));
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) =
              make_float2(d[i], d[i + 1]);
        }
      }
    }
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
// box: 64 columns (128 bytes, the swizzle span) by `box` rows.
int map2d(CUtensorMap* m, const void* ptr, int64_t rows, int cols,
          int box) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint32_t b[2] = {64, (cuuint32_t)box};
  return encode(m, ptr, 2, dims, b);
}

int grid_for(int tiles, int sms) { return tiles < sms ? tiles : sms; }

template <int C, bool BWD>
int launch_fused(FusedParams& p, const void* u, const void* gms,
                 const void* panel0, const void* panel1, const void* cols,
                 int sms, cudaStream_t stream) {
  typedef Fused<C, BWD> F;
  int e = map2d(&p.tok[0], u, p.n, C, kTM);
  if (!e && BWD) e = map2d(&p.tok[1], gms, p.n, C, kTM);
  if (!e) e = map2d(&p.panel[0], panel0, 4 * C, C, kHC);
  if (!e && BWD) e = map2d(&p.panel[1], panel1, 4 * C, C, kHC);
  if (!e) e = map2d(&p.cols, cols, C, 4 * C, C);
  if (e) return e;
  p.tiles = (int)((p.n + kTM - 1) / kTM);
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_fused_kernel<C, BWD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)F::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_fused_kernel<C, BWD><<<grid_for(p.tiles, sms), kThreads, F::kSmem,
                             stream>>>(p);
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

#define ROBSEG_FOR_EACH_WIDTH(X) \
  X(96) X(128) X(192) X(256) X(384) X(512) X(768) X(1024)
#define ROBSEG_FOR_EACH_FUSED_WIDTH(X) X(96) X(128) X(192)

// the depthwise tile for each width: TH x TW tokens (TH TW C <= 12288
// floats of y), RH x RW outputs a thread
#define ROBSEG_DW_TILES(X)                                      \
  X(96, 8, 16, 8, 2) X(128, 8, 8, 8, 1) X(192, 8, 8, 4, 2)      \
  X(256, 8, 4, 4, 1) X(384, 8, 4, 4, 1) X(512, 4, 4, 2, 1)      \
  X(768, 4, 4, 2, 1) X(1024, 4, 2, 1, 1)

template <class T, class K, class... A>
int dw_launch(K kernel, bool ln, int B, int H, int W, int C,
              cudaStream_t stream, A... args) {
  const size_t smem = T::smem(C, ln);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + T::TW - 1) / T::TW, (H + T::TH - 1) / T::TH, B);
  kernel<<<grid, kDwThreads, smem, stream>>>(args..., H, W, C);
  return (int)cudaGetLastError();
}

int dwconv_ln(const float* x, const float* dwt, const float* dwb,
              const float* ls, const float* lb, bf16* u, float* xhat,
              float* inv, const float* dy, const float* gamma, bf16* gms,
              int B, int H, int W, int C, cudaStream_t stream) {
  switch (C) {
#define X(WD, TH, TW, RH, RW)                                               \
  case WD:                                                                  \
    return dw_launch<DwTile<TH, TW, RH, RW>>(                               \
        dwconv_ln_kernel<DwTile<TH, TW, RH, RW>>, true, B, H, W, C, stream, \
        x, dwt, dwb, ls, lb, u, xhat, inv, dy, gamma, gms);
    ROBSEG_DW_TILES(X)
#undef X
    default: return -1;
  }
}

int dwcorr(const float* dyconv, const float* dwt, const float* dy, float* dx,
           int B, int H, int W, int C, cudaStream_t stream) {
  dim3 grid((W + kDwTokens - 1) / kDwTokens, H, B);
  dwcorr_kernel<<<grid, kDwRowThreads, 0, stream>>>(dyconv, dwt, dy, dx, H,
                                                    W, C);
  return (int)cudaGetLastError();
}

void add_job(PackParams& p, const float* src, void* dst, int rows, int cols,
             int kind) {
  PackJob& q = p.job[p.jobs++];
  q = PackJob{src, dst, rows, cols, kind, 0};
  q.blocks = kind == kCastBf16
                 ? (int)(((int64_t)rows * cols + 2047) / 2048)
                 : ((cols + 31) / 32) * ((rows + 31) / 32);
}

int pack(const PackParams& p, cudaStream_t stream) {
  int blocks = 0;
  for (int j = 0; j < p.jobs; ++j) blocks += p.job[j].blocks;
  pack_kernel<<<blocks, dim3(32, 8), 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The one scratch buffer of a call, carved into 256-byte aligned parts:
// the packed parameters (taps (49, C) f32; W1 (4C, C), W2 (C, 4C) or W2^T
// (4C, C), W1^T (C, 4C) bf16), u (n, C) bf16, the hidden layer (n, 4C)
// bf16 of the two-GEMM form, and for the backward gms (n, C) bf16, xhat
// (n, C) f32, inv (n) f32, dyconv (n, C) f32. With base null it only
// counts the bytes.
struct Scratch {
  float* dwt;
  bf16 *w1, *w2, *w1t, *u, *hid, *gms;
  float *xhat, *inv, *dyconv;
  size_t bytes;
};

Scratch carve(char* base, int64_t n, int C, bool bwd) {
  Scratch s = {};
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t c = C;
  s.dwt = (float*)take(49 * c * 4);
  s.w1 = (bf16*)take(4 * c * c * 2);
  s.w2 = (bf16*)take(4 * c * c * 2);
  if (bwd) s.w1t = (bf16*)take(4 * c * c * 2);
  s.u = (bf16*)take(n * c * 2);
  if (C > kFusedMaxC) s.hid = (bf16*)take(n * 4 * c * 2);
  if (bwd) {
    s.gms = (bf16*)take(n * c * 2);
    s.xhat = (float*)take(n * c * 4);
    s.inv = (float*)take(n * 4);
    s.dyconv = (float*)take(n * c * 4);
  }
  s.bytes = off;
  return s;
}

}  // namespace

// Bytes of scratch a call needs (backward: the input gradient's).
extern "C" int64_t robseg_convnext_block_scratch(int B, int H, int W, int C,
                                                 int backward) {
  return (int64_t)carve(nullptr, (int64_t)B * H * W, C, backward != 0).bytes;
}

extern "C" int robseg_convnext_block_supported(int C) {
  switch (C) {
#define X(W) case W: return 1;
    ROBSEG_FOR_EACH_WIDTH(X)
#undef X
    default: return 0;
  }
}

// Forward. Parameters in the layout of the reference state_dict, f32: dw
// (C, 1, 7, 7), w1 (4C, C), w2 (C, 4C), vectors (C) or (4C); scratch:
// robseg_convnext_block_scratch(B, H, W, C, 0) bytes; out: (B, H, W, C)
// f32; sms: the persistent grid. Returns 0, a CUDA error, or -(CUresult)
// if a tensor map was refused.
extern "C" int robseg_convnext_block_fwd(
    const float* x, const float* dw, const float* dwb, const float* ls,
    const float* lb, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* gamma, void* scratch, float* out, int B,
    int H, int W, int C, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const Scratch sc = carve((char*)scratch, n, C, false);
  PackParams pk = {};
  add_job(pk, dw, sc.dwt, C, 49, kTransposeF32);
  add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kCastBf16);
  int e = pack(pk, s);
  if (!e)
    e = dwconv_ln(x, sc.dwt, dwb, ls, lb, sc.u, nullptr, nullptr, nullptr,
                  nullptr, nullptr, B, H, W, C, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = b1;
    p.x = x;
    p.b2 = b2;
    p.gamma = gamma;
    p.out = out;
    p.n = n;
    switch (C) {
#define X(WD)                                                                \
  case WD:                                                                   \
    return launch_fused<WD, false>(p, sc.u, nullptr, sc.w1, nullptr, sc.w2, \
                                   sms, s);
      ROBSEG_FOR_EACH_FUSED_WIDTH(X)
#undef X
      default: return -1;
    }
  }
  GemmParams p = {};
  p.bias = b1;
  p.out = sc.hid;
  p.m = n;
  p.n = 4 * C;
  e = launch_gemm<kGelu>(p, sc.u, sc.w1, nullptr, nullptr, C, sms, s);
  if (e) return e;
  p = GemmParams{};
  p.bias = b2;
  p.x = x;
  p.gamma = gamma;
  p.out = out;
  p.m = n;
  p.n = C;
  return launch_gemm<kResid>(p, sc.hid, sc.w2, nullptr, nullptr, 4 * C, sms,
                             s);
}

// Input gradient. Parameters as the forward's (b2 is not needed); dy, dx:
// (B, H, W, C) f32; scratch: robseg_convnext_block_scratch(B, H, W, C, 1)
// bytes.
extern "C" int robseg_convnext_block_dx(
    const float* x, const float* dy, const float* dw, const float* dwb,
    const float* ls, const float* lb, const float* w1, const float* b1,
    const float* w2, const float* gamma, void* scratch, float* dx, int B,
    int H, int W, int C, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const Scratch sc = carve((char*)scratch, n, C, true);
  // taps; W1 (4C, C); W2^T (4C, C) for da = gms . W2; W1^T (C, 4C) for
  // du = dh . W1
  PackParams pk = {};
  add_job(pk, dw, sc.dwt, C, 49, kTransposeF32);
  add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kTransposeBf16);
  add_job(pk, w1, sc.w1t, 4 * C, C, kTransposeBf16);
  int e = pack(pk, s);
  if (!e)
    e = dwconv_ln(x, sc.dwt, dwb, ls, lb, sc.u, sc.xhat, sc.inv, dy, gamma,
                  sc.gms, B, H, W, C, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = b1;
    p.xhat = sc.xhat;
    p.inv = sc.inv;
    p.ls = ls;
    p.dyconv = sc.dyconv;
    p.n = n;
    switch (C) {
#define X(WD)                                                               \
  case WD:                                                                  \
    e = launch_fused<WD, true>(p, sc.u, sc.gms, sc.w1, sc.w2, sc.w1t, sms,  \
                               s);                                          \
    break;
      ROBSEG_FOR_EACH_FUSED_WIDTH(X)
#undef X
      default: return -1;
    }
    if (e) return e;
  } else {
    GemmParams p = {};
    p.bias = b1;
    p.out = sc.hid;
    p.m = n;
    p.n = 4 * C;
    e = launch_gemm<kDgelu>(p, sc.u, sc.w1, sc.gms, sc.w2, C, sms, s);
    if (e) return e;
    p = GemmParams{};
    p.out = sc.dyconv;
    p.m = n;
    p.n = C;
    e = launch_gemm<kStore>(p, sc.hid, sc.w1t, nullptr, nullptr, 4 * C, sms,
                            s);
    if (e) return e;
    ln_bwd_kernel<<<(unsigned)((n + 7) / 8), 256, 0, s>>>(
        sc.dyconv, sc.xhat, sc.inv, ls, n, C);
    e = (int)cudaGetLastError();
    if (e) return e;
  }
  return dwcorr(sc.dyconv, sc.dwt, dy, dx, B, H, W, C, s);
}
