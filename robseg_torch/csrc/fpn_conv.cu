// UperNet's fpn_bottleneck without the channel concat, forward and input
// gradient, for Hopper.
//
//   out = relu((sum_i conv3x3(bf16(x_i), bf16(w_i))) * s + t)
//
// Replaces: robseg_tpu/kernels/fpn_conv.py, fpn_concat_conv:
//   _fpn_fwd_call (pallas_call :152, _fwd_kernel)
//   _fpn_bwd_call (pallas_call :178, _bwd_kernel)
// x_i are the n <= 4 upsampled FPN maps, channels-last (B, H, W, C) f32
// or bf16 (the --precision bf16 model); w_i the (3, 3, C, Co) slices of
// the bottleneck weight; s, t the folded eval BatchNorm, f32. out and the
// input gradients are written in the maps' type, as JAX's out_dtype and
// in_dtypes (fpn_conv.py:138, :165). The backward gives the input
// gradients of all sources in one launch:
//   g    = bf16(bf16(dy) * bf16(s)) where out > 0, else 0
//   dx_i = sum_{ky,kx} g[r - ky + 1, c - kx + 1] . w_i[ky, kx]^T
// Rounding sits where the TPU kernel puts it (fpn_conv.py:54-60, 93-98,
// 135): matmul operands bf16, products accumulated in f32.
//
// Bound on the H100: at batch 16, 512^2 (M = 16*128*128 pixels, C = Co =
// 512, four sources) each direction is 2*M*Co*(4*9*C) = 4.95 TFLOP of
// bf16 products, 5.0 ms at the 989 TFLOP/s dense bf16 peak, against
// ~2.7 GB (forward) and ~3.2 GB (backward) of f32 activations, ~0.8-1.0
// ms at 3.35 TB/s: compute bound.
//
// Design: one implicit GEMM for both directions, M = pixels, N = output
// channels, K = (source, tap, 64-channel slice). The GEMM reads bf16 maps:
// f32 maps go through a pre-pass that writes each once as bf16, bf16 maps
// are read where they lie (one tensor map per source), and the backward's
// pre-pass writes g (the ReLU mask and the BatchNorm scale folded in).
// The bf16 form computes bit for bit what the f32 form computes on the
// upcast maps, rounded once at the store. The GEMM is a persistent,
// warp-specialised kernel (one block per SM):
// - Products: `wgmma.mma_async` m64n256k16 (bf16 in, f32 accumulators in
//   registers). A block computes a 128-pixel x 256-channel tile; two
//   consumer warpgroups take 64 rows each and read both operands from
//   shared memory through 128-byte-swizzled descriptors (no fragment
//   loads, no bank conflicts).
// - Loads: one producer thread issues TMA (`cp.async.bulk.tensor`) into a
//   4-stage ring of 16 KB of activations + 32 KB of weights per stage,
//   with full/empty mbarriers; `setmaxnreg` moves the producer
//   warpgroup's registers to the consumers. The activation box is 64
//   channels by a 128-pixel spatial patch of one image (box_w x box_h,
//   chosen at launch from W); tap (ky, kx) moves its origin by
//   sign * (kx - 1, ky - 1). TMA zero-fills what lies outside the tensor:
//   that fill is the conv's padding, the ragged image edge, the channel
//   tail (C not a multiple of 64) and the output-channel tail, so no
//   thread computes an address or a bound in the main loop. Tiled mode
//   (not im2col): a 4-D map {C, W, H, B} over each source's bf16 map and
//   a 3-D map {K, N, 9 * sources} over the weight panels, each (source,
//   tap) panel an (N, K) matrix with K contiguous.
// - K-step: 64 channels, four k16 instructions per warpgroup for each
//   barrier wait, with no block-wide __syncthreads() in the main loop.
// - Schedule: tiles walk (output slot, image, patch row, patch column,
//   N tile) with N innermost, statically strided over the blocks, so the
//   blocks that run together read the same activation box from L2; the
//   producer loads the next tile's stages while the consumers write this
//   tile's outputs straight from their accumulator registers (float2 or
//   bf16x2 stores, 32 or 16 contiguous bytes per row and warp; pixels
//   outside the image and channels >= n masked). The output type is the
//   kernel's template parameter.
// The descriptors are built on the host in robseg_fpn_fwd / robseg_fpn_dx
// (cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the link needs no -lcuda) and passed as a __grid_constant__
// parameter. The barrier, TMA, descriptor and wgmma helpers and the map
// encoding live in hopper.cuh, shared with convnext_block.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBM = 128;         // pixels per tile (one spatial box)
constexpr int kBN = 256;         // output channels per tile
constexpr int kBK = 64;          // K-step: 64 channels (128 bytes)
constexpr int kStages = 4;       // TMA ring depth
constexpr int kConsumers = 2;    // consumer warpgroups, 64 tile rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr uint32_t kABytes = kBM * kBK * 2;
constexpr uint32_t kBBytes = kBN * kBK * 2;
constexpr uint32_t kStageBytes = kABytes + kBBytes;
// stages (1024-byte aligned for the 128-byte swizzle) and 2 x kStages
// mbarriers
constexpr size_t kSmem = 1024 + kStages * kStageBytes + 16 * kStages;

struct Params {
  CUtensorMap a[4]; // bf16 map {ca, W, H, B} per K-source, 128-byte swizzle
  CUtensorMap b;    // bf16 panels {ca, n, 9 * panels}, 128-byte swizzle
  void* out[4];     // (B, H, W, n) per output slot, f32 or bf16
  const float* s;   // forward epilogue relu(acc * s + t); null: acc as is
  const float* t;
  int batch, h, w, n;
  int k_src;        // sources summed over K (forward n, backward 1)
  int sign;         // +1: a[r + ky - 1, c + kx - 1] (the conv);
                    // -1: a[r - ky + 1, c - kx + 1] (its transpose)
  int box_w_log2;   // the spatial box is box_w x (kBM / box_w) pixels
  int tiles_x, tiles_y, tiles_n, tiles;
  int kc;           // K-steps per (source, tap): ceil(ca / kBK)
};

struct Tile {
  int slot, b, y0, x0, n0;
};

__device__ __forceinline__ Tile decode(const Params& p, int t) {
  Tile r;
  r.n0 = (t % p.tiles_n) * kBN;
  t /= p.tiles_n;
  r.x0 = (t % p.tiles_x) << p.box_w_log2;
  t /= p.tiles_x;
  r.y0 = (t % p.tiles_y) * (kBM >> p.box_w_log2);
  t /= p.tiles_y;
  r.b = t % p.batch;
  r.slot = t / p.batch;
  return r;
}

__device__ __forceinline__ void producer(const Params& p, uint32_t base,
                                         uint32_t bars) {
  for (int src = 0; src < p.k_src; ++src) prefetch_map(&p.a[src]);
  prefetch_map(&p.b);
  int it = 0;  // K-steps issued by this block, over all its tiles
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = decode(p, tile);
    for (int src = 0; src < p.k_src; ++src) {
      for (int tap = 0; tap < 9; ++tap) {
        const int x = tl.x0 + p.sign * (tap % 3 - 1);
        const int y = tl.y0 + p.sign * (tap / 3 - 1);
        const int panel = (tl.slot + src) * 9 + tap;
        for (int c = 0; c < p.kc; ++c, ++it) {
          const int st = it % kStages;
          const uint32_t full = bars + 8 * st;
          mbar_wait(bars + 8 * (kStages + st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(full, kStageBytes);
          const uint32_t a = base + st * kStageBytes;
          tma_load_4d(a, &p.a[src], full, c * kBK, x, y, tl.b);
          tma_load_3d(a + kABytes, &p.b, full, c * kBK, tl.n0, panel);
        }
      }
    }
  }
}

template <class Out>
__device__ __forceinline__ void consumer(const Params& p, uint32_t base,
                                         uint32_t bars, int wg) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int ksteps = p.k_src * 9 * p.kc;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const Tile tl = decode(p, tile);
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int st = it % kStages;
      mbar_wait(bars + 8 * st, (it / kStages) & 1);
      const uint32_t a = base + st * kStageBytes;
      const uint64_t da = smem_desc(a + wg * (kABytes / kConsumers));
      const uint64_t db = smem_desc(a + kABytes);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss<256>(d, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the previous K-step's products are done ...
      fence_acc(d);
      if (k > 0 && lane == 0)  // ... so its stage goes back to the producer
        mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(bars + 8 * (kStages + (it - 1) % kStages));

    // epilogue: this thread holds rows r and r + 8 of the warpgroup's 64,
    // columns 8j + 2 (lane % 4) + {0, 1} for j < 32
    Out* out = static_cast<Out*>(p.out[tl.slot]);
    int64_t off[2];
    bool ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wg * 64 + warp * 16 + lane / 4 + 8 * hh;
      const int x = tl.x0 + (r & ((1 << p.box_w_log2) - 1));
      const int y = tl.y0 + (r >> p.box_w_log2);
      ok[hh] = x < p.w && y < p.h;
      off[hh] = (((int64_t)tl.b * p.h + y) * p.w + x) * p.n;
    }
    const int col0 = tl.n0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j;
      if (col < p.n) {  // n is even: col + 1 < n too
        float2 sc = make_float2(1.0f, 1.0f), sh = make_float2(0.0f, 0.0f);
        if (p.s) {
          sc = __ldg(reinterpret_cast<const float2*>(p.s + col));
          sh = __ldg(reinterpret_cast<const float2*>(p.t + col));
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2 v = make_float2(d[4 * j + 2 * hh], d[4 * j + 2 * hh + 1]);
          if (p.s) {
            v.x = fmaxf(v.x * sc.x + sh.x, 0.0f);
            v.y = fmaxf(v.y * sc.y + sh.y, 0.0f);
          }
          if (ok[hh]) st2(out + off[hh] + col, v);
        }
      }
    }
  }
}

template <class Out>
__global__ void __launch_bounds__(kThreads, 1)
    fpn_gemm_kernel(const __grid_constant__ Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  // full[st] = bars + 8 st (the producer's arrival + the TMA bytes);
  // empty[st] = bars + 8 (kStages + st) (one arrival per consumer warp)
  const uint32_t bars = base + kStages * kStageBytes;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (kStages + st), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  // one branch per role for the whole kernel: setmaxnreg needs paths that
  // never meet again
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) producer(p, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    consumer<Out>(p, base, bars, wg);
  }
}

// y = bf16(x), four elements per step (n4 = elements / 4)
__global__ void to_bf16_kernel(const float* __restrict__ x,
                               bf16* __restrict__ y, int64_t n4) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(y) + 2 * i;
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// g = bf16(bf16(dy) * bf16(s)) where out > 0, else 0. The product of two
// bf16 values is exact in f32, so rounding it once is the bf16 multiply.
// dy and out are IO (f32, or bf16: then bf16(dy) is dy, and out > 0 has
// the sign of the f32 output it rounds).
template <class IO>
__global__ void relu_grad_kernel(const IO* __restrict__ dy,
                                 const IO* __restrict__ out,
                                 const float* __restrict__ s,
                                 bf16* __restrict__ g, int64_t n, int co) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float d = __bfloat162float(__float2bfloat16(ld1(dy + i)));
    const float sc = __bfloat162float(__float2bfloat16(s[i % co]));
    g[i] = __float2bfloat16(ld1(out + i) > 0.0f ? d * sc : 0.0f);
  }
}

unsigned elementwise_blocks(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

// The GEMM over act[i] (B, H, W, ca) bf16 for each of the k_src
// K-sources and panels (9 * (k_src + slots - 1), n, ca) bf16, into `slots`
// outputs (B, H, W, n) of type Out. box_w (8..128, a power of two) and
// blocks come from the caller's plan
// (robseg_torch/kernels/fpn_conv.py::plan).
template <class Out>
int launch_gemm(Params& p, const void* const* act, const void* panels,
                int ca, int slots, int box_w, int blocks,
                cudaStream_t stream) {
  if (box_w < 8 || box_w > kBM || (box_w & (box_w - 1)) || blocks < 1 ||
      p.n % 2)
    return (int)cudaErrorInvalidValue;
  const int box_h = kBM / box_w;
  const cuuint64_t adims[4] = {(cuuint64_t)ca, (cuuint64_t)p.w,
                               (cuuint64_t)p.h, (cuuint64_t)p.batch};
  const cuuint32_t abox[4] = {kBK, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  int err = 0;
  for (int i = 0; i < p.k_src && !err; ++i)
    err = encode(&p.a[i], act[i], 4, adims, abox);
  if (err) return err;
  const cuuint64_t bdims[3] = {(cuuint64_t)ca, (cuuint64_t)p.n,
                               (cuuint64_t)(9 * (p.k_src + slots - 1))};
  const cuuint32_t bbox[3] = {kBK, kBN, 1};
  err = encode(&p.b, panels, 3, bdims, bbox);
  if (err) return err;
  p.box_w_log2 = 0;
  while ((1 << p.box_w_log2) < box_w) ++p.box_w_log2;
  p.tiles_x = (p.w + box_w - 1) / box_w;
  p.tiles_y = (p.h + box_h - 1) / box_h;
  p.tiles_n = (p.n + kBN - 1) / kBN;
  const int64_t tiles =
      (int64_t)slots * p.batch * p.tiles_y * p.tiles_x * p.tiles_n;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  p.kc = (ca + kBK - 1) / kBK;
  cudaError_t e = cudaFuncSetAttribute(
      fpn_gemm_kernel<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  fpn_gemm_kernel<Out><<<blocks < p.tiles ? blocks : p.tiles, kThreads, kSmem,
                         stream>>>(p);
  return (int)cudaGetLastError();
}

template <class IO>
int fpn_dx(const IO* dy, const IO* out, const void* wt, const float* s,
           void* g, void* const* dxs, int n_src, int B, int H, int W, int C,
           int Co, int box_w, int blocks, cudaStream_t st) {
  const int64_t m = (int64_t)B * H * W;
  relu_grad_kernel<IO><<<elementwise_blocks(m * Co), 256, 0, st>>>(
      dy, out, s, (bf16*)g, m * Co, Co);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Params p = {};
  for (int i = 0; i < 4; ++i) p.out[i] = dxs[i];
  p.s = nullptr;
  p.t = nullptr;
  p.batch = B;
  p.h = H;
  p.w = W;
  p.n = C;
  p.k_src = 1;
  p.sign = -1;
  const void* act[1] = {g};
  return launch_gemm<IO>(p, act, wt, Co, n_src, box_w, blocks, st);
}

}  // namespace

// Forward. x0..x3: the n_src (1..4) sources (B, H, W, C), f32 or
// (io_bf16) bf16 (unused ones null); w: the panels (n_src, 3, 3, Co, C)
// bf16; xb: (n_src, B*H*W, C) bf16 scratch for f32 sources (null for bf16
// ones, which the GEMM reads where they lie); out: (B, H, W, Co) in the
// sources' type. C and Co must be multiples of 32 (TMA strides: multiples
// of 16 bytes). box_w, blocks: the launch plan. Returns 0, a CUDA error,
// or -(CUresult) if a tensor map was refused.
extern "C" int robseg_fpn_fwd(const void* x0, const void* x1,
                              const void* x2, const void* x3, int n_src,
                              const void* w, const float* s, const float* t,
                              void* xb, void* out, int B, int H, int W,
                              int C, int Co, int io_bf16, int box_w,
                              int blocks, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t m = (int64_t)B * H * W;
  if (m == 0) return 0;
  const void* xs[4] = {x0, x1, x2, x3};
  const void* act[4] = {x0, x1, x2, x3};
  if (!io_bf16) {
    for (int i = 0; i < n_src; ++i) {
      act[i] = (bf16*)xb + i * m * C;
      to_bf16_kernel<<<elementwise_blocks(m * C / 4), 256, 0, st>>>(
          (const float*)xs[i], (bf16*)act[i], m * C / 4);
    }
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  Params p = {};
  p.out[0] = out;
  p.s = s;
  p.t = t;
  p.batch = B;
  p.h = H;
  p.w = W;
  p.n = Co;
  p.k_src = n_src;
  p.sign = 1;
  return io_bf16 ? launch_gemm<bf16>(p, act, w, C, 1, box_w, blocks, st)
                 : launch_gemm<float>(p, act, w, C, 1, box_w, blocks, st);
}

// Input gradients. dy, out: (B, H, W, Co), f32 or (io_bf16) bf16; wt: the
// panels (n_src, 3, 3, C, Co) bf16, the weight as stored; g: (B*H*W, Co)
// bf16 scratch; dx0..dx3: (B, H, W, C) per source, in dy's type.
extern "C" int robseg_fpn_dx(const void* dy, const void* out,
                             const void* wt, const float* s, void* g,
                             void* dx0, void* dx1, void* dx2, void* dx3,
                             int n_src, int B, int H, int W, int C, int Co,
                             int io_bf16, int box_w, int blocks,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((int64_t)B * H * W == 0) return 0;
  void* const dxs[4] = {dx0, dx1, dx2, dx3};
  if (io_bf16)
    return fpn_dx((const bf16*)dy, (const bf16*)out, wt, s, g, dxs, n_src,
                  B, H, W, C, Co, box_w, blocks, st);
  return fpn_dx((const float*)dy, (const float*)out, wt, s, g, dxs, n_src,
                B, H, W, C, Co, box_w, blocks, st);
}
