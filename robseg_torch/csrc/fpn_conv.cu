// UperNet's fpn_bottleneck without the channel concat, forward and input
// gradient, for Hopper.
//
//   out = relu((sum_i conv3x3(bf16(x_i), bf16(w_i))) * s + t)
//
// Replaces: robseg_tpu/kernels/fpn_conv.py, fpn_concat_conv:
//   _fpn_fwd_call (pallas_call :152, _fwd_kernel)
//   _fpn_bwd_call (pallas_call :178, _bwd_kernel)
// x_i are the n <= 4 upsampled FPN maps, channels-last (B, H, W, C) f32;
// w_i the (3, 3, C, Co) slices of the bottleneck weight; s, t the folded
// eval BatchNorm. The backward gives the input gradients of all sources in
// one launch:
//   g    = bf16(bf16(dy) * bf16(s)) where out > 0, else 0
//   dx_i = sum_{ky,kx} g[r - ky + 1, c - kx + 1] . w_i[ky, kx]^T
// Rounding sits where the TPU kernel puts it (fpn_conv.py:54-60, 93-98,
// 135): matmul operands bf16, products accumulated in f32.
//
// Bound on the H100: at batch 16, 512^2 (M = 16*128*128 pixels, C = Co =
// 512, four sources) each direction is 2*M*Co*(4*9*C) = 4.95 TFLOP of
// bf16 products, ~5.0 ms at the 989 TFLOP/s dense bf16 peak, against
// ~2.7 GB (forward) and ~3.2 GB (backward) of f32 activations, ~0.8-1.0
// ms at 3.35 TB/s: compute bound.
//
// Design: an implicit GEMM, M = pixels, N = output channels, K = (source,
// tap, channel). A pre-pass writes each operand map once as bf16 (forward:
// the four x_i; backward: g, the ReLU mask and the BatchNorm scale folded
// in), which halves the bytes every K-slice reads. The GEMM block computes
// a 128 x 128 output tile over K-slices of 32 channels of one (source,
// tap); cp.async streams the activation slice (zero-filled outside the
// image: that is the conv's padding) and the pre-packed bf16 weight slice
// into a 3-stage shared-memory ring, so loads overlap the tensor-core work
// (mma.sync through nvcuda::wmma, 16x16x16 bf16, f32 accumulators). The
// weights are staged in shared memory like the activations: fragments
// read straight from device memory held the block MLP to ~25 TFLOP/s.
// The blocks that share one 128-pixel row of tiles run next to each other
// (grid.x = output-channel tiles), so the activation slice is read from
// L2. No 2048-channel concat exists in memory, forward or backward.
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kBM = 128;       // pixels per block
constexpr int kBN = 128;       // output channels per block
constexpr int kBK = 32;        // K-slice: 32 channels of one (source, tap)
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kThreads = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kLDA = kBK + 8;  // padded shared rows (bf16 elements)
constexpr int kLDB = kBN + 8;
constexpr int kAStage = kBM * kLDA;
constexpr int kBStage = kBK * kLDB;
constexpr size_t kSmem =
    (size_t)kStages * (kAStage + kBStage) * sizeof(bf16) +
    (size_t)(kThreads / 32) * 256 * sizeof(float);  // + per-warp epilogue

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Gemm {
  const bf16* a[4];      // activation maps (B, H, W, ca) bf16, per K-source
  const bf16* w;         // weight panel (K, n) bf16 of output slot 0
  int64_t w_slot;        // elements between the panels of output slots
  float* out[4];         // (B, H, W, n) f32 per output slot (grid.z)
  const float* s;        // forward epilogue relu(acc * s + t); null: none
  const float* t;
  int64_t m;             // pixels, B * H * W
  int h, w_, ca, n;      // image size, channels per K-source, outputs
  int k_src;             // sources summed over K (forward n, backward 1)
  int sign;              // +1: a[r + ky - 1, c + kx - 1] (the conv);
                         // -1: a[r - ky + 1, c - kx + 1] (its transpose)
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__global__ void __launch_bounds__(kThreads)
fpn_gemm_kernel(const Gemm p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kAStage;
  float* stg = reinterpret_cast<float*>(Bs + kStages * kBStage);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const bf16* wz = p.w + blockIdx.z * p.w_slot;
  float* outz = p.out[blockIdx.z];
  const int per = p.ca / kBK;  // K-slices per (source, tap)
  const int kt_n = p.k_src * 9 * per;

  // this thread's share of a slice: 16 bytes of two A rows, two B rows
  const int aseg = tid % 4;
  int ab[2], ar[2], ac[2];
  bool aok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + tid / 4 + 64 * i;
    aok[i] = m < p.m;
    const int64_t mm = aok[i] ? m : 0;
    ac[i] = (int)(mm % p.w_);
    ar[i] = (int)((mm / p.w_) % p.h);
    ab[i] = (int)(mm / ((int64_t)p.w_ * p.h));
  }
  const int bseg = tid % 16;
  const int bcol = n0 + bseg * 8;
  const bool bok = bcol < p.n;

  auto load = [&](int kt, int st) {
    const int src = kt / (9 * per);
    const int rem = kt - src * 9 * per;
    const int tap = rem / per;
    const int c0 = (rem - tap * per) * kBK;
    const int oy = p.sign * (tap / 3 - 1), ox = p.sign * (tap % 3 - 1);
    const bf16* a = p.a[src];
    bf16* as = As + st * kAStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rr = ar[i] + oy, cc = ac[i] + ox;
      const bool ok = aok[i] && rr >= 0 && rr < p.h && cc >= 0 && cc < p.w_;
      const bf16* g =
          ok ? a + (((int64_t)ab[i] * p.h + rr) * p.w_ + cc) * p.ca + c0 +
                   aseg * 8
             : a;
      cp_async16(as + (tid / 4 + 64 * i) * kLDA + aseg * 8, g, ok);
    }
    bf16* bs = Bs + st * kBStage;
    const int64_t k0 = (int64_t)kt * kBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = tid / 16 + 16 * i;
      const bf16* g = bok ? wz + (k0 + row) * p.n + bcol : wz;
      cp_async16(bs + row * kLDB + bseg * 8, g, bok);
    }
  };

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed
    __syncthreads();               // ... and slice kt-1 is no longer read
    const int nk = kt + kStages - 1;
    if (nk < kt_n) load(nk, nk % kStages);
    cp_async_commit();
    const bf16* as = As + (kt % kStages) * kAStage;
    const bf16* bs = Bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[4];
      FragB fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 64 + i * 16) * kLDA + kk,
                               kLDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * kLDB + wn * 32 + j * 16,
                               kLDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each warp stages one 16x16 tile at a time, each lane writes
  // 8 consecutive channels of one pixel
  float* my = stg + warp * 256;
  const int r = lane / 2, c8 = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(my, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int64_t m = m0 + wm * 64 + i * 16 + r;
      const int nn = n0 + wn * 32 + j * 16 + c8;
      if (m < p.m && nn < p.n) {
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = my[r * 16 + c8 + e];
        if (p.s) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = fmaxf(v[e] * p.s[nn + e] + p.t[nn + e], 0.0f);
        }
        float4* o = reinterpret_cast<float4*>(outz + m * p.n + nn);
        o[0] = make_float4(v[0], v[1], v[2], v[3]);
        o[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncwarp();
    }
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
__global__ void relu_grad_kernel(const float* __restrict__ dy,
                                 const float* __restrict__ out,
                                 const float* __restrict__ s,
                                 bf16* __restrict__ g, int64_t n, int co) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float d = __bfloat162float(__float2bfloat16(dy[i]));
    const float sc = __bfloat162float(__float2bfloat16(s[i % co]));
    g[i] = __float2bfloat16(out[i] > 0.0f ? d * sc : 0.0f);
  }
}

unsigned elementwise_blocks(int64_t n) {
  const int64_t b = (n + 255) / 256;
  return (unsigned)(b < 132 * 16 ? b : 132 * 16);
}

int launch_gemm(const Gemm& p, int slots, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fpn_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.n + kBN - 1) / kBN, (unsigned)((p.m + kBM - 1) / kBM), slots);
  fpn_gemm_kernel<<<grid, kThreads, kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Forward. x0..x3: the n_src (1..4) sources (B, H, W, C) f32 (unused ones
// null); w: (n_src*9*C, Co) bf16, rows ordered (source, ky, kx, channel);
// xb: (n_src, B*H*W, C) bf16 scratch; out: (B, H, W, Co) f32.
// C and Co must be multiples of 32.
extern "C" int robseg_fpn_fwd(const float* x0, const float* x1,
                              const float* x2, const float* x3, int n_src,
                              const void* w, const float* s, const float* t,
                              void* xb, float* out, int B, int H, int W,
                              int C, int Co, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t m = (int64_t)B * H * W;
  if (m == 0) return 0;
  const float* xs[4] = {x0, x1, x2, x3};
  Gemm p = {};
  for (int i = 0; i < n_src; ++i) {
    bf16* dst = (bf16*)xb + i * m * C;
    to_bf16_kernel<<<elementwise_blocks(m * C / 4), 256, 0, st>>>(
        xs[i], dst, m * C / 4);
    p.a[i] = dst;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  p.w = (const bf16*)w;
  p.w_slot = 0;
  p.out[0] = out;
  p.s = s;
  p.t = t;
  p.m = m;
  p.h = H;
  p.w_ = W;
  p.ca = C;
  p.n = Co;
  p.k_src = n_src;
  p.sign = 1;
  return launch_gemm(p, 1, st);
}

// Input gradients. dy, out: (B, H, W, Co) f32; wt: (n_src, 9*Co, C) bf16,
// rows ordered (ky, kx, output channel) per source; g: (B*H*W, Co) bf16
// scratch; dx0..dx3: (B, H, W, C) f32 per source.
extern "C" int robseg_fpn_dx(const float* dy, const float* out,
                             const void* wt, const float* s, void* g,
                             float* dx0, float* dx1, float* dx2, float* dx3,
                             int n_src, int B, int H, int W, int C, int Co,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t m = (int64_t)B * H * W;
  if (m == 0) return 0;
  relu_grad_kernel<<<elementwise_blocks(m * Co), 256, 0, st>>>(
      dy, out, s, (bf16*)g, m * Co, Co);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  Gemm p = {};
  p.a[0] = (const bf16*)g;
  p.w = (const bf16*)wt;
  p.w_slot = (int64_t)9 * Co * C;
  float* dxs[4] = {dx0, dx1, dx2, dx3};
  for (int i = 0; i < 4; ++i) p.out[i] = dxs[i];
  p.s = nullptr;
  p.t = nullptr;
  p.m = m;
  p.h = H;
  p.w_ = W;
  p.ca = Co;
  p.n = C;
  p.k_src = 1;
  p.sign = -1;
  return launch_gemm(p, n_src, st);
}
