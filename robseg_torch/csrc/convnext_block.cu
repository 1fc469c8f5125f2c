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
// I/O types, as the TPU kernel's (convnext_block.py:101, out_shape x.dtype
// at :325, :354, :437, :463): x, dy, out and dx are float32 or bf16 (the
// --precision bf16 model), out and dx in x's type; the parameters are
// float32 or bf16, independently. Inside, everything is as above: a bf16
// value converts to f32 exactly where it is read, the packing upcasts bf16
// parameter vectors into the scratch, and out / dx round to bf16 once, at
// the store. So the bf16 form computes bit for bit what the float32 form
// computes on the upcast inputs, rounded once at the output. The I/O type
// is a template parameter of the depthwise passes and the forward's
// epilogues (mlp_fused_kernel<.., IO>, mlp_gemm_kernel<kResidBf16, ..>):
// the two forms share every product and every float32 operation.
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
//   shared-memory slots with full/empty mbarriers; a second streams the
//   token tiles of u into two buffers, a tile ahead. Two consumer
//   warpgroups own 64 tokens each. Per chunk: h = u . W1c^T with wgmma
//   from shared memory (m64n64k16, C / 16 steps: the C = 96 tail's
//   zero-filled steps are not issued); bias, erf-GELU and bf16 rounding in
//   registers; then acc += gelu(h) . W2c^T with the A operand straight
//   from those registers (wgmma with A in registers, m64nCk16: the
//   accumulator layout of h is the A-fragment layout), so gelu(h) touches
//   shared memory nowhere. The forward is software pipelined: each
//   warpgroup issues chunk g + 1's h product (two h register sets) before
//   it runs chunk g's GELU, which the CUDA cores run while the tensor
//   cores multiply. A tile's last chunk
//   issues the next tile's first h, so the epilogue runs under it. The
//   GELU (n 4C erff on the CUDA cores, ~0.075 ms at stage 0 of batch 16)
//   is the longer of the two at C <= 192, the products ~0.039 ms a stage.
//   bf16 out: each warp brings its 16 rows of x by TMA into its rows of
//   the token tile it has finished with, writes out over them and stores
//   them by TMA; float32 out goes from the accumulator registers (an L2
//   prefetch of x by TMA a tile ahead cost 10%).
//   The backward takes three slots per chunk: h = u . W1c^T and da = gms .
//   W2^T_c (two m64n64k16 products sharing the token tile), dh = bf16(da *
//   GELU'(h + b1)) in registers, du += dh . W1c (A in registers); the
//   LayerNorm backward runs in the epilogue, where each row's C columns sit
//   in the four threads of one quad.
//   Registers per consumer thread (setmaxnreg 232): the 64 x C f32 output
//   accumulator C / 2 (48 / 64 / 96 at C = 96 / 128 / 192), h 2 x 32 in
//   the forward (32 and da 32 in the backward), the bf16 A fragments 16:
//   at most 176 plus addressing.
// - C >= 256: the accumulator would take 128 (C = 256), 192 (384) or 384
//   (768) registers a thread; with h, da and the fragments beside it 256
//   and 384 leave no room, and splitting 384's columns over two
//   warpgroups needs both chunks' W1 and W2 panels (96 KB each) in flight
//   beside the token tile, more than 227 KB holds with two stages. So the
//   hidden layer goes to device memory as bf16, which is the rounding the
//   kernel applies to it anyway (results unchanged), through two GEMMs
//   (mlp_gemm_kernel, persistent, 128-row tiles, K-steps of 64 through a
//   TMA ring, two consumer warpgroups with m64nBNk16) with fused
//   epilogues: forward h = bf16(gelu(u . W1^T + b1)) in 128 x 128 tiles,
//   then out = x + gamma * (h . W2^T + b2) in 128 x BN tiles, BN 192 or 128
//   by the tile count (gemm_bn: 192 at 32^2 and 16^2, where 128 left 60 of
//   132 SMs a second wave at 16^2); the bf16 outputs (h, and out in the
//   bf16 form) leave through TMA stores staged a warp's 16 x 64 box at a
//   time, so the next tile's main loop starts while they drain. Backward
//   dh = bf16((gms . W2) * GELU'(u . W1^T + b1)) (two accumulators), then
//   du = dh . W1, whose LayerNorm backward is a row pass (ln_bwd_kernel)
//   before dwcorr. Each moves 2 bytes of hidden layer per C products of
//   it, C / 2 >= 128 operations a byte of hidden traffic: at C = 384, 100
//   MB more than the fused form at batch 16 (0.03 ms at 3.35 TB/s) against
//   0.04 ms of products.
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

// The depthwise passes, dwconv_ln_kernel and dwcorr_kernel, are one tiled
// engine. A tile is TH x TW tokens of one image and every channel, taken a
// chunk of 32 channels at a time; each of the block's 8 warps computes an
// RH x RW patch of the tile, lane l channel l of the chunk, its 49 taps in
// registers, sliding a (RW + 6)-wide window down the patch's RH + 6 input
// rows (input row r adds its values to the output rows r - ky it reaches;
// each output sums its taps ky-major, kx-minor, as a direct loop would).
// The blocks are persistent (two an SM, at most) and walk the tiles
// strided by the grid, and each block walks the chunks of its tiles
// through one ring of p.stages stages (2-4, as many as two blocks' shared
// memory an SM leaves room for) with a full mbarrier each: a stage holds
// one chunk's (TH + 6) x (TW + 6) halo of the conv's input, brought by TMA
// (a 4-D map {C, W, H, B}, box {32, TW + 6, TH + 6, 1} starting 3 rows and
// columns before the tile; the zero fill outside the tensor is the 3-pixel
// padding and the ragged edge), with the chunk's 49 taps ({32, 49} boxes
// of the packed (49, C) taps: read through L1, which a deep ring leaves
// small, each chunk began with a wait on L2). Thread 0 issues chunk n +
// stages of the block's walk into a stage as soon as the block has read it
// (the __syncthreads that ends chunk n), the next tile's first chunks too,
// so loads stay in flight across the LayerNorm and the tile boundaries. Halos
// stay in the type they have in memory (bf16 x in the bf16 form) and
// convert where they are read. What needs dy (gms in the backward's
// dwconv_ln, dx = dy + corr) takes the chunk's TH x TW box of dy from the
// same stage, and every output leaves 4 or 8 consecutive channels a thread.
// - dwconv_ln_kernel keeps y = dwconv + bias for the tile's tokens and
//   every channel in shared memory (f32, [T][C]) and then normalises it, L
//   lanes a token, lane q holding channels 4 (q + L i) ..: u (bf16, 8-byte
//   stores) and in the backward xhat (16-byte stores) and 1/sigma; gms
//   (bf16, 16-byte stores) per chunk from dy's box.
// - dwcorr_kernel writes the chunk's correlation into a [T][32] f32 tile,
//   then dx = dy + corr, 8 channels a thread (16 or 32-byte stores).
// Bound on the H100: bytes. The backward's dwconv_ln moves 16 bytes per
// element in float32 (x, dy, u, xhat, gms; 12 in bf16), dwcorr 12 (dyconv,
// dy, dx; 8 in bf16), against 49 FMAs each: 25 M elements at stage 0 of
// batch 16 take 0.12 / 0.09 ms at 3.35 TB/s and 0.04 ms of FMAs. The tile
// shrinks as C grows (ROBSEG_DW_TILES), so that y and two stages fit twice
// an SM in the backward's float32 form at every width.
constexpr int kDwThreads = 256;     // 8 warps, one RH x RW patch each
constexpr int kDwChunk = 32;        // channels a chunk: lane l channel l
constexpr int kDwMaxStages = 4;     // TMA ring depth, in chunks, at most
constexpr int kDwBlocksPerSm = 2;   // the registers' limit (128 a thread)
constexpr int kDwSmemBudget = 113 * 1024;  // a block's, two an SM

template <int TH_, int TW_, int RH_, int RW_>
struct DwTile {
  static constexpr int TH = TH_, TW = TW_, RH = RH_, RW = RW_;
  static constexpr int HH = TH + 6, HW = TW + 6;  // halo rows, columns
  static constexpr int T = TH * TW;               // tokens of a tile
  static constexpr int WC = TW / RW;              // warps across the tile
  static_assert(TH % RH == 0 && TW % RW == 0 &&
                    (TH / RH) * WC == kDwThreads / 32,
                "one patch a warp");
  // the LayerNorm pass: L lanes a token, kDwThreads / L tokens a round
  static constexpr int L = T >= 32 ? 8 : kDwThreads / T;
  static_assert(T % (kDwThreads / L) == 0, "whole rounds");
};

// One ring stage: the chunk's halo of the conv's input (Src), its 49 taps
// ([49][32] f32) and, with DY, its box of dy (IO), each as TMA lays the box
// down ([rows][columns][32 channels]), 128-byte aligned.
template <class T, class Src, class IO, bool DY>
struct DwStage {
  static constexpr uint32_t kHaloTx = T::HH * T::HW * kDwChunk * sizeof(Src);
  static constexpr uint32_t kTapsTx = 49 * kDwChunk * 4;
  static constexpr uint32_t kDyTx = DY ? T::T * kDwChunk * sizeof(IO) : 0;
  static constexpr uint32_t kHalo = (kHaloTx + 127) & ~127u;
  static constexpr uint32_t kDy = kHalo + kTapsTx;  // kTapsTx: 49 x 128
  static constexpr uint32_t kBytes = kDy + ((kDyTx + 127) & ~127u);
};

struct DwParams {
  CUtensorMap src;  // the conv's input {C, W, H, B}: x (IO) or dyconv (f32)
  CUtensorMap dy;   // dy {C, W, H, B} (IO), box {32, TW, TH, 1}
  CUtensorMap taps; // the packed taps {C, 49} (f32), box {32, 49}
  const float *dwt, *dwb, *ls, *lb, *gamma;  // taps (49, C); vectors (C)
  bf16 *u, *gms;
  float *xhat, *inv;
  void* dx;  // dwcorr_kernel's output (IO)
  int H, W, C;
  int tiles_x, tiles_y, tiles;  // tiles walk x fastest, then y, then image
  int stages;                   // ring depth, 2..kDwMaxStages
};

// the block's walk: n = i * chunks + k is chunk k of the block's i-th tile
struct DwWalk {
  int chunks;
  __device__ int tile(int n) const {
    return blockIdx.x + (n / chunks) * gridDim.x;
  }
};

__device__ __forceinline__ void dw_origin(const DwParams& p, int tile,
                                          int& x0, int& y0, int& b,
                                          int tw, int th) {
  x0 = (tile % p.tiles_x) * tw;
  tile /= p.tiles_x;
  y0 = (tile % p.tiles_y) * th;
  b = tile / p.tiles_y;
}

// issue chunk n of the block's walk into its ring stage, if its tile exists
template <class T, class St>
__device__ __forceinline__ void dw_issue(const DwParams& p, DwWalk w,
                                         uint32_t stages, uint32_t bars,
                                         int n) {
  const int tile = w.tile(n);
  if (tile >= p.tiles) return;
  int x0, y0, b;
  dw_origin(p, tile, x0, y0, b, T::TW, T::TH);
  const int st = n % p.stages, c0 = (n % w.chunks) * kDwChunk;
  const uint32_t full = bars + 8 * st, dst = stages + st * St::kBytes;
  mbar_expect_tx(full, St::kHaloTx + St::kTapsTx + St::kDyTx);
  tma_load_4d(dst, &p.src, full, c0, x0 - 3, y0 - 3, b);
  tma_load_2d(dst + St::kHalo, &p.taps, full, c0, 0);
  if (St::kDyTx)
    tma_load_4d(dst + St::kDy, &p.dy, full, c0, x0, y0, b);
}

// the ring's barriers, then the walk's first stages in flight
template <class T, class St>
__device__ __forceinline__ void dw_start(const DwParams& p, DwWalk w,
                                         uint32_t stages, uint32_t bars) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < p.stages; ++st) mbar_init(bars + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&p.src);
    prefetch_map(&p.taps);
    if (St::kDyTx) prefetch_map(&p.dy);
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int n = 0; n < p.stages; ++n) dw_issue<T, St>(p, w, stages, bars, n);
}

// the block's shared memory: the ring, then `tail` bytes (y or the
// correlation tile), then the barriers; `stages` its 128-byte aligned
// shared-memory address, `sm` the same as a pointer
struct DwSmem {
  uint32_t stages;
  unsigned char* sm;
};
__device__ __forceinline__ DwSmem dw_smem() {
  extern __shared__ unsigned char dw_smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(dw_smem_raw));
  const uint32_t stages = (raw + 127) & ~127u;
  return DwSmem{stages, dw_smem_raw + (stages - raw)};
}

// out[o][t] = sum_{ky,kx} halo[ry + o + ky][rx + t + kx] * tap[ky][kx]
// for this lane's channel; tap already flipped for the correlation
template <class T, class Src>
__device__ __forceinline__ void dw_patch(const Src* halo,
                                         const float (&tap)[49], int ry,
                                         int rx, int lane,
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
      v[j] = ld1(halo + ((ry + r) * T::HW + rx + j) * kDwChunk + lane);
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

// the tile's tokens inside the image, 8 channels (c0 + g ..) a thread:
// f(token index in the tile, token index in the tensor, g)
template <class T, class F>
__device__ __forceinline__ void dw_each8(const DwParams& p, int x0, int y0,
                                         int b, F f) {
  for (int i = threadIdx.x; i < T::T * (kDwChunk / 8); i += kDwThreads) {
    const int t = i / (kDwChunk / 8), g = 8 * (i % (kDwChunk / 8));
    const int hh = y0 + t / T::TW, ww = x0 + t % T::TW;
    if (hh < p.H && ww < p.W)
      f(t, ((int64_t)b * p.H + hh) * p.W + ww, g);
  }
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// u = LN(dwconv(x) + dwb) * ls + lb as bf16; for the backward (BWD) also
// xhat (f32), inv = 1/sqrt(var + eps) per token and gms = bf16(gamma *
// dy). x and dy are IO (f32 or bf16). Grid: min(tiles, the SMs' blocks).
template <class T, class IO, bool BWD>
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
    dwconv_ln_kernel(const __grid_constant__ DwParams p) {
  using St = DwStage<T, IO, IO, BWD>;
  const DwSmem s = dw_smem();
  const int C = p.C;
  const DwWalk w{C / kDwChunk};
  float* ys = reinterpret_cast<float*>(s.sm + p.stages * St::kBytes);
  const uint32_t bars = s.stages + p.stages * St::kBytes + T::T * C * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = (warp / T::WC) * T::RH, rx = (warp % T::WC) * T::RW;
  dw_start<T, St>(p, w, s.stages, bars);
  int n = 0;  // chunks of the walk done
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int x0, y0, b;
    dw_origin(p, tile, x0, y0, b, T::TW, T::TH);
    for (int k = 0; k < w.chunks; ++k, ++n) {
      const int st = n % p.stages, c0 = k * kDwChunk, c = c0 + lane;
      mbar_wait(bars + 8 * st, (n / p.stages) & 1);
      const unsigned char* stage = s.sm + st * St::kBytes;
      if constexpr (BWD) {
        const IO* dyt = reinterpret_cast<const IO*>(stage + St::kDy);
        dw_each8<T>(p, x0, y0, b, [&](int t, int64_t tok, int g) {
          float d[8], gm[8];
          ld8(dyt + t * kDwChunk + g, d);
          ld8(p.gamma + c0 + g, gm);
#pragma unroll
          for (int i = 0; i < 8; ++i) d[i] = gm[i] * d[i];
          st8(p.gms + tok * C + c0 + g, d);
        });
      }
      const float* taps = reinterpret_cast<const float*>(stage + St::kHalo);
      float tap[49];
#pragma unroll
      for (int i = 0; i < 49; ++i) tap[i] = taps[i * kDwChunk + lane];
      float acc[T::RH][T::RW];
      dw_patch<T>(reinterpret_cast<const IO*>(stage), tap, ry, rx, lane,
                  acc);
      const float bias = __ldg(p.dwb + c);
#pragma unroll
      for (int o = 0; o < T::RH; ++o)
#pragma unroll
        for (int t = 0; t < T::RW; ++t)
          ys[((ry + o) * T::TW + rx + t) * C + c] = acc[o][t] + bias;
      __syncthreads();  // stage st is read; after the last chunk, y is whole
      if (threadIdx.x == 0)
        dw_issue<T, St>(p, w, s.stages, bars, n + p.stages);
    }
    // the LayerNorm: L lanes a token, each all lanes of a warp together
    constexpr int L = T::L;
    const int q = threadIdx.x % L, nv = C / (4 * L);
    for (int t = threadIdx.x / L; t < T::T; t += kDwThreads / L) {
      const float4* yr = reinterpret_cast<const float4*>(ys + t * C);
      float sum = 0.0f;
      for (int i = 0; i < nv; ++i) {
        const float4 v = yr[q + L * i];
        sum += (v.x + v.y) + (v.z + v.w);
      }
      const float mean = group_sum<L>(sum) / C;
      float sq = 0.0f;
      for (int i = 0; i < nv; ++i) {
        const float4 v = yr[q + L * i];
        const float a = v.x - mean, bb = v.y - mean, cc = v.z - mean,
                    dd = v.w - mean;
        sq += (a * a + bb * bb) + (cc * cc + dd * dd);
      }
      const float inv = rsqrtf(group_sum<L>(sq) / C + 1e-6f);
      const int hh = y0 + t / T::TW, ww = x0 + t % T::TW;
      if (hh >= p.H || ww >= p.W) continue;
      const int64_t tok = ((int64_t)b * p.H + hh) * p.W + ww;
      for (int i = 0; i < nv; ++i) {
        const int c = 4 * (q + L * i);
        const float4 v = yr[q + L * i];
        const float4 xh =
            make_float4((v.x - mean) * inv, (v.y - mean) * inv,
                        (v.z - mean) * inv, (v.w - mean) * inv);
        const float4 g = __ldg(reinterpret_cast<const float4*>(p.ls + c));
        const float4 h = __ldg(reinterpret_cast<const float4*>(p.lb + c));
        st4(p.u + tok * C + c,
            make_float4(xh.x * g.x + h.x, xh.y * g.y + h.y,
                        xh.z * g.z + h.z, xh.w * g.w + h.w));
        if constexpr (BWD) st4(p.xhat + tok * C + c, xh);
      }
      if (BWD && q == 0) p.inv[tok] = inv;
    }
    __syncthreads();  // y is read: the next tile may write it
  }
}

// dx = dy + corr7x7(dyconv, flipped taps). dyconv is f32; dy and dx are
// IO. Grid: min(tiles, the SMs' blocks).
template <class T, class IO>
__global__ void __launch_bounds__(kDwThreads, kDwBlocksPerSm)
    dwcorr_kernel(const __grid_constant__ DwParams p) {
  using St = DwStage<T, float, IO, true>;
  const DwSmem s = dw_smem();
  const int C = p.C;
  const DwWalk w{C / kDwChunk};
  float* cs = reinterpret_cast<float*>(s.sm + p.stages * St::kBytes);
  const uint32_t bars =
      s.stages + p.stages * St::kBytes + T::T * kDwChunk * 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ry = (warp / T::WC) * T::RH, rx = (warp % T::WC) * T::RW;
  dw_start<T, St>(p, w, s.stages, bars);
  int n = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    int x0, y0, b;
    dw_origin(p, tile, x0, y0, b, T::TW, T::TH);
    for (int k = 0; k < w.chunks; ++k, ++n) {
      const int st = n % p.stages, c0 = k * kDwChunk;
      mbar_wait(bars + 8 * st, (n / p.stages) & 1);
      const unsigned char* stage = s.sm + st * St::kBytes;
      const float* taps = reinterpret_cast<const float*>(stage + St::kHalo);
      float tap[49];
#pragma unroll
      for (int i = 0; i < 49; ++i) tap[i] = taps[(48 - i) * kDwChunk + lane];
      float acc[T::RH][T::RW];
      dw_patch<T>(reinterpret_cast<const float*>(stage), tap, ry, rx, lane,
                  acc);
#pragma unroll
      for (int o = 0; o < T::RH; ++o)
#pragma unroll
        for (int t = 0; t < T::RW; ++t)
          cs[((ry + o) * T::TW + rx + t) * kDwChunk + lane] = acc[o][t];
      __syncthreads();
      const IO* dyt = reinterpret_cast<const IO*>(stage + St::kDy);
      dw_each8<T>(p, x0, y0, b, [&](int t, int64_t tok, int g) {
        float d[8], v[8];
        ld8(dyt + t * kDwChunk + g, d);
        ld8(cs + t * kDwChunk + g, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = d[i] + v[i];
        st8(static_cast<IO*>(p.dx) + tok * C + c0 + g, d);
      });
      __syncthreads();  // stage st and the correlation tile are read
      if (threadIdx.x == 0)
        dw_issue<T, St>(p, w, s.stages, bars, n + p.stages);
    }
  }
}


#define ROBSEG_FOR_EACH_WIDTH(X) \
  X(96) X(128) X(192) X(256) X(384) X(512) X(768) X(1024)
#define ROBSEG_FOR_EACH_FUSED_WIDTH(X) X(96) X(128) X(192)

// the depthwise tile for each width: TH x TW tokens (TH TW C <= 12288
// floats of y), RH x RW outputs a thread
#define ROBSEG_DW_TILES(X)                                      \
  X(96, 8, 8, 4, 2) X(128, 8, 8, 4, 2) X(192, 4, 8, 2, 2)       \
  X(256, 8, 4, 4, 1) X(384, 8, 4, 4, 1) X(512, 4, 4, 2, 1)      \
  X(768, 4, 4, 2, 1) X(1024, 4, 2, 1, 1)

template <class V>
CUtensorMapDataType map_type() {
  return sizeof(V) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// the maps of a depthwise launch (no swizzle: the boxes land dense): the
// conv's input, boxes of the halo; the taps, a chunk's 49 a box; and (dy
// non-null) dy, boxes of the tile
template <class T, class Src, class IO>
int dw_maps(DwParams& p, const Src* src, const IO* dy, int B) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.C, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)B};
  const cuuint32_t halo[4] = {kDwChunk, T::HW, T::HH, 1};
  int e = encode(&p.src, src, 4, dims, halo, map_type<Src>(),
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  const cuuint64_t tdims[2] = {(cuuint64_t)p.C, 49};
  const cuuint32_t tbox[2] = {kDwChunk, 49};
  if (!e)
    e = encode(&p.taps, p.dwt, 2, tdims, tbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!e && dy) {
    const cuuint32_t box[4] = {kDwChunk, T::TW, T::TH, 1};
    e = encode(&p.dy, dy, 4, dims, box, map_type<IO>(),
               CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  return e;
}

// the ring's depth (2..kDwMaxStages) that two blocks' shared memory an SM
// leave room for beside `tail` bytes, and the block's bytes with it
template <class St>
int dw_stages(size_t tail) {
  const long room = kDwSmemBudget - 128 - (long)tail;
  const long s = room / (long)(St::kBytes + 8);
  return (int)(s < kDwMaxStages ? s : kDwMaxStages);
}
template <class St>
size_t dw_smem_bytes(int stages, size_t tail) {
  return 128 + stages * St::kBytes + tail + 8 * stages;
}

template <class T, class St, class K>
int dw_launch(K kernel, DwParams& p, size_t tail, int B, int sms,
              cudaStream_t stream) {
  p.stages = dw_stages<St>(tail);
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  p.tiles_x = (p.W + T::TW - 1) / T::TW;
  p.tiles_y = (p.H + T::TH - 1) / T::TH;
  const int64_t tiles = (int64_t)p.tiles_x * p.tiles_y * B;
  if (tiles > INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const size_t smem = dw_smem_bytes<St>(p.stages, tail);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = kDwBlocksPerSm * sms;
  kernel<<<p.tiles < blocks ? p.tiles : blocks, kDwThreads, smem, stream>>>(
      p);
  return (int)cudaGetLastError();
}

template <class T, class IO>
int dwconv_ln_tile(DwParams& p, const IO* x, const IO* dy, int B, int sms,
                   cudaStream_t stream) {
  const int e = dw_maps<T>(p, x, dy, B);
  if (e) return e;
  const size_t ys = (size_t)T::T * p.C * 4;
  if (dy)
    return dw_launch<T, DwStage<T, IO, IO, true>>(
        dwconv_ln_kernel<T, IO, true>, p, ys, B, sms, stream);
  return dw_launch<T, DwStage<T, IO, IO, false>>(
      dwconv_ln_kernel<T, IO, false>, p, ys, B, sms, stream);
}

template <class T, class IO>
int dwcorr_tile(DwParams& p, const float* dyconv, const IO* dy, int B,
                int sms, cudaStream_t stream) {
  const int e = dw_maps<T>(p, dyconv, dy, B);
  if (e) return e;
  return dw_launch<T, DwStage<T, float, IO, true>>(
      dwcorr_kernel<T, IO>, p, T::T * kDwChunk * 4, B, sms, stream);
}

// the forward's pass (dy null: u only) or the backward's (xhat, inv, gms
// too)
template <class IO>
int dwconv_ln(const IO* x, const float* dwt, const float* dwb,
              const float* ls, const float* lb, bf16* u, float* xhat,
              float* inv, const IO* dy, const float* gamma, bf16* gms,
              int B, int H, int W, int C, int sms, cudaStream_t stream) {
  DwParams p = {};
  p.dwt = dwt;
  p.dwb = dwb;
  p.ls = ls;
  p.lb = lb;
  p.gamma = gamma;
  p.u = u;
  p.gms = gms;
  p.xhat = xhat;
  p.inv = inv;
  p.H = H;
  p.W = W;
  p.C = C;
  switch (C) {
#define X(WD, TH, TW, RH, RW) \
  case WD:                    \
    return dwconv_ln_tile<DwTile<TH, TW, RH, RW>, IO>(p, x, dy, B, sms, \
                                                      stream);
    ROBSEG_DW_TILES(X)
#undef X
    default: return -1;
  }
}

template <class IO>
int dwcorr(const float* dyconv, const float* dwt, const IO* dy, IO* dx,
           int B, int H, int W, int C, int sms, cudaStream_t stream) {
  DwParams p = {};
  p.dwt = dwt;
  p.dx = dx;
  p.H = H;
  p.W = W;
  p.C = C;
  switch (C) {
#define X(WD, TH, TW, RH, RW) \
  case WD:                    \
    return dwcorr_tile<DwTile<TH, TW, RH, RW>, IO>(p, dyconv, dy, B, sms, \
                                                   stream);
    ROBSEG_DW_TILES(X)
#undef X
    default: return -1;
  }
}


// The one scratch buffer of a call, carved into 256-byte aligned parts:
// the packed parameters (taps (49, C) f32; W1 (4C, C), W2 (C, 4C) or W2^T
// (4C, C), W1^T (C, 4C) bf16; the vectors dwb, ls, lb, b1 (4C), b2, gamma
// in f32, filled only from bf16 parameters), u (n, C) bf16, the hidden
// layer (n, 4C) bf16 of the two-GEMM form, and for the backward gms (n,
// C) bf16, xhat (n, C) f32, inv (n) f32, dyconv (n, C) f32. With base
// null it only counts the bytes.
struct Scratch {
  float* dwt;
  bf16 *w1, *w2, *w1t, *u, *hid, *gms;
  float *dwb, *ls, *lb, *b1, *b2, *gamma;
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
  s.dwb = (float*)take(c * 4);
  s.ls = (float*)take(c * 4);
  s.lb = (float*)take(c * 4);
  s.b1 = (float*)take(4 * c * 4);
  s.b2 = (float*)take(c * 4);
  s.gamma = (float*)take(c * 4);
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

// The parameter vectors the kernels read, f32: the caller's, or (bf16
// parameters) upcast by the packing launch into the scratch.
struct Vecs {
  const float *dwb, *ls, *lb, *b1, *b2, *gamma;
};

Vecs vectors(PackParams& pk, const Scratch& sc, const void* dwb,
             const void* ls, const void* lb, const void* b1, const void* b2,
             const void* gamma, int C, bool p_bf16) {
  if (!p_bf16)
    return Vecs{(const float*)dwb, (const float*)ls, (const float*)lb,
                (const float*)b1,  (const float*)b2, (const float*)gamma};
  add_job(pk, dwb, sc.dwb, 1, C, kCastF32, true);
  add_job(pk, ls, sc.ls, 1, C, kCastF32, true);
  add_job(pk, lb, sc.lb, 1, C, kCastF32, true);
  add_job(pk, b1, sc.b1, 1, 4 * C, kCastF32, true);
  if (b2) add_job(pk, b2, sc.b2, 1, C, kCastF32, true);
  add_job(pk, gamma, sc.gamma, 1, C, kCastF32, true);
  return Vecs{sc.dwb, sc.ls, sc.lb, sc.b1, sc.b2, sc.gamma};
}

template <class IO>
int block_fwd(const IO* x, const void* dw, const void* dwb, const void* ls,
              const void* lb, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* gamma, bool p_bf16, void* scratch,
              IO* out, int B, int H, int W, int C, int sms, cudaStream_t s) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const Scratch sc = carve((char*)scratch, n, C, false);
  PackParams pk = {};
  add_job(pk, dw, sc.dwt, C, 49, kTransposeF32, p_bf16);
  add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16, p_bf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kCastBf16, p_bf16);
  const Vecs v = vectors(pk, sc, dwb, ls, lb, b1, b2, gamma, C, p_bf16);
  int e = pack(pk, s);
  if (!e)
    e = dwconv_ln<IO>(x, sc.dwt, v.dwb, v.ls, v.lb, sc.u, nullptr, nullptr,
                      nullptr, nullptr, nullptr, B, H, W, C, sms, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = v.b1;
    p.x = x;
    p.b2 = v.b2;
    p.gamma = v.gamma;
    p.out = out;
    p.n = n;
    switch (C) {
#define X(WD)                                                            \
  case WD:                                                               \
    return launch_fused<WD, false, false, IO>(p, sc.u, nullptr, sc.w1,   \
                                              nullptr, sc.w2, sms, s);
      ROBSEG_FOR_EACH_FUSED_WIDTH(X)
#undef X
      default: return -1;
    }
  }
  GemmParams p = {};
  p.bias = v.b1;
  p.out = sc.hid;
  p.m = n;
  p.n = 4 * C;
  e = launch_gemm<kGelu>(p, sc.u, sc.w1, nullptr, nullptr, C, sms, s);
  if (e) return e;
  p = GemmParams{};
  p.bias = v.b2;
  p.x = x;
  p.gamma = v.gamma;
  p.out = out;
  p.m = n;
  p.n = C;
  constexpr int kEpi = std::is_same<IO, bf16>::value ? kResidBf16 : kResid;
  return launch_gemm<kEpi>(p, sc.hid, sc.w2, nullptr, nullptr, 4 * C, sms,
                           s);
}

template <class IO>
int block_dx(const IO* x, const IO* dy, const void* dw, const void* dwb,
             const void* ls, const void* lb, const void* w1, const void* b1,
             const void* w2, const void* gamma, bool p_bf16, void* scratch,
             IO* dx, int B, int H, int W, int C, int sms, cudaStream_t s) {
  const int64_t n = (int64_t)B * H * W;
  if (n == 0) return 0;
  const Scratch sc = carve((char*)scratch, n, C, true);
  // taps; W1 (4C, C); W2^T (4C, C) for da = gms . W2; W1^T (C, 4C) for
  // du = dh . W1
  PackParams pk = {};
  add_job(pk, dw, sc.dwt, C, 49, kTransposeF32, p_bf16);
  add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16, p_bf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kTransposeBf16, p_bf16);
  add_job(pk, w1, sc.w1t, 4 * C, C, kTransposeBf16, p_bf16);
  const Vecs v = vectors(pk, sc, dwb, ls, lb, b1, nullptr, gamma, C, p_bf16);
  int e = pack(pk, s);
  if (!e)
    e = dwconv_ln<IO>(x, sc.dwt, v.dwb, v.ls, v.lb, sc.u, sc.xhat, sc.inv,
                      dy, v.gamma, sc.gms, B, H, W, C, sms, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = v.b1;
    p.xhat = sc.xhat;
    p.inv = sc.inv;
    p.ls = v.ls;
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
    p.bias = v.b1;
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
    e = ln_bwd(sc.dyconv, sc.xhat, sc.inv, v.ls, n, C, s);
    if (e) return e;
  }
  return dwcorr<IO>(sc.dyconv, sc.dwt, dy, dx, B, H, W, C, sms, s);
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

// Forward. Parameters in the layout of the reference state_dict, f32 or
// (p_bf16) bf16: dw (C, 1, 7, 7), w1 (4C, C), w2 (C, 4C), vectors (C) or
// (4C); x and out: (B, H, W, C) f32 or (io_bf16) bf16; scratch:
// robseg_convnext_block_scratch(B, H, W, C, 0) bytes; sms: the persistent
// grid. Returns 0, a CUDA error, or -(CUresult) if a tensor map was
// refused.
extern "C" int robseg_convnext_block_fwd(
    const void* x, const void* dw, const void* dwb, const void* ls,
    const void* lb, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* gamma, void* scratch, void* out, int B,
    int H, int W, int C, int io_bf16, int p_bf16, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (io_bf16)
    return block_fwd((const bf16*)x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma,
                     p_bf16 != 0, scratch, (bf16*)out, B, H, W, C, sms, s);
  return block_fwd((const float*)x, dw, dwb, ls, lb, w1, b1, w2, b2, gamma,
                   p_bf16 != 0, scratch, (float*)out, B, H, W, C, sms, s);
}

// Input gradient. Parameters as the forward's (b2 is not needed); dy, dx:
// (B, H, W, C) in x's type; scratch: robseg_convnext_block_scratch(B, H,
// W, C, 1) bytes.
extern "C" int robseg_convnext_block_dx(
    const void* x, const void* dy, const void* dw, const void* dwb,
    const void* ls, const void* lb, const void* w1, const void* b1,
    const void* w2, const void* gamma, void* scratch, void* dx, int B,
    int H, int W, int C, int io_bf16, int p_bf16, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (io_bf16)
    return block_dx((const bf16*)x, (const bf16*)dy, dw, dwb, ls, lb, w1, b1,
                    w2, gamma, p_bf16 != 0, scratch, (bf16*)dx, B, H, W, C,
                    sms, s);
  return block_dx((const float*)x, (const float*)dy, dw, dwb, ls, lb, w1, b1,
                  w2, gamma, p_bf16 != 0, scratch, (float*)dx, B, H, W, C,
                  sms, s);
}
