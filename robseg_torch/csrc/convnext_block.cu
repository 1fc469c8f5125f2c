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
//
// The MLP kernels, the packing and the LayerNorm-backward pass live in
// convnext_mlp.cuh, which the MLP-tail kernels share; this file keeps the
// depthwise passes and the block's entry points.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "convnext_mlp.cuh"

namespace {

constexpr int kDwThreads = 256;  // dwconv_ln_kernel: 8 warps
constexpr int kDwTokens = 8;     // dwcorr_kernel: tokens of one row
constexpr int kDwRowThreads = 128;

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
    e = ln_bwd(sc.dyconv, sc.xhat, sc.inv, ls, n, C, s);
    if (e) return e;
  }
  return dwcorr(sc.dyconv, sc.dwt, dy, dx, B, H, W, C, s);
}
