// The ConvNeXt block's MLP tail, forward and input gradient, for Hopper.
//
//   m = gamma * (GELU(LN(y) . W1^T + b1) . W2^T + b2)
//
// (no residual: the caller adds it; y is the depthwise-conv output).
// Replaces: robseg_tpu/kernels/convnext_mlp.py, all four entry points:
//   convnext_mlp_fused, _bf16       (_call :165: _fwd_kernel, _bwd_kernel)
//   convnext_mlp_fused_rs, _rs_bf16 (_call_save :271: _fwd_save_kernel;
//                                    _call_resid_bwd :309: _bwd_resid_kernel)
// Four modes: bf16 or float32 matmul operands; SAVE_H (the forward also
// writes the pre-GELU h + b1, (n, 4C) f32) with READ_H (the backward reads
// it back: two products, not three), or h recomputed. Widths C in {96,
// 128, 192, 256, 384}: the JAX model runs this tail for dim <= 384 only.
//
// Numerics. LayerNorm (eps 1e-6), GELU (the exact erff) and the LayerNorm
// backward run in f32. bf16 operands are rounded where the TPU kernel
// rounds them (u and W1, gelu(h) and W2; gamma dy and W2, dh and W1), one
// bf16 tensor-core pass each, f32 accumulation. Float32 operands go
// through a split-precision product, 3xTF32: a = a_hi + a_lo, a_hi =
// tf32(a) rounded to nearest, a_lo = a - a_hi, a.b ~ a_lo.b_hi + a_hi.b_lo
// + a_hi.b_hi, each K-step of 32 summed in its own accumulator and folded
// into the tile's sum in f32 (the tensor core's accumulation does not
// round to nearest, and over K = 4C = 1536 its error piles up past the
// float32 bounds).
//
// Bound on the H100: the forward does 16 n C^2 products, the backward 24
// n C^2 (16 with h read), against 8 n C bytes (y in, m out; 12 n C in the
// backward) plus 16 n C with h saved or read. In bf16 (989 TFLOP/s) the
// bytes bound at C <= 192, in 3xTF32 (three passes at 495 TFLOP/s) the
// products: ~0.23 ms a stage of the 512^2 model at batch 16 each way.
//
// Design. Operands reach shared memory through TMA (128-byte swizzle,
// zero fill for ragged token tiles), products run on wgmma, and a
// producer warp feeds two consumer warpgroups through a ring of full/empty
// mbarriers, as in the block kernels (convnext_block.cu), in two forms:
//
// - bf16 (this file): the block's MLP kernels themselves, from
//   convnext_mlp.cuh, behind an LN-only prologue (ln_rows_kernel: u, and
//   for the backward xhat, 1/sigma, gms = bf16(gamma dy)). C <= 192: the
//   fused kernel (the hidden layer on chip), with SAVE_H storing h from
//   the registers that hold it and READ_H loading h there instead of
//   multiplying (the W1 panel then stays out of the ring); the backward's
//   epilogue is the LayerNorm backward and writes dx. C >= 256: the
//   128-row-tile GEMMs with the tail's epilogues (h saved beside the bf16
//   hidden layer; gamma (acc + b2) without x; dh = bf16(da GELU'(h)) from
//   the read h), then the LayerNorm-backward row pass.
// - float32 (convnext_mlp_f32.cu): two 3xTF32 GEMMs through an f32 h in
//   device memory at every width. The fused on-chip form does not carry
//   over: at C = 384 a 128-token tile of u_hi and u_lo alone is 384 KB.
//   Every A operand is one f32 tile whose consumers read their wgmma A
//   fragments from shared memory, transform them and split them hi/lo in
//   registers (wgmma with A in registers; the weights come split by the
//   packing). Forward h = u . W1^T + b1, then gamma (gelu(h) . W2^T + b2),
//   GELU applied in that transform. Backward dh = (gms . W2) GELU'(h) with
//   h read (or recomputed by the first forward GEMM), du = dh . W1, then
//   the LayerNorm-backward row pass. `residual` writes h anyway, so its
//   forward pays one more read of h (~0.2 ms over the three stages at
//   batch 16).
//
// Each call is one host function: a packing launch (the weights as bf16,
// or split hi/lo f32, K-major, W2^T and W1^T for the backward) into the
// one scratch buffer the caller allocates (robseg_convnext_mlp_scratch),
// the prologue, the products, [the LayerNorm backward].

#include "convnext_mlp.cuh"

namespace {

#define ROBSEG_TAIL_FUSED_WIDTHS(X) X(96) X(128) X(192)

// The scratch of a bf16 call, carved into 256-byte aligned parts: W1 (4C,
// C) [forward, or backward with h recomputed], W2 (C, 4C) (forward) or
// W2^T (4C, C) and W1^T (C, 4C) (backward), u (n, C) [not when h is read],
// the hidden layer (n, 4C) at C > kFusedMaxC, and for the backward gms (n,
// C) bf16, xhat (n, C) and inv (n) f32.
struct TailBf16 {
  bf16 *w1, *w2, *w1t, *u, *hid, *gms;
  float *xhat, *inv;
  size_t bytes;
};

TailBf16 carve_bf16(char* base, int64_t n, int C, bool with_h, bool bwd) {
  TailBf16 s = {};
  size_t off = 0;
  auto take = [&](size_t bytes) -> void* {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return p;
  };
  const size_t c = C, w = 4 * c * c * 2;
  const bool recompute = !(bwd && with_h);  // u and W1 are needed
  if (recompute) s.w1 = (bf16*)take(w);
  s.w2 = (bf16*)take(w);
  if (bwd) s.w1t = (bf16*)take(w);
  if (recompute) s.u = (bf16*)take(n * c * 2);
  if (C > kFusedMaxC) s.hid = (bf16*)take(n * 4 * c * 2);
  if (bwd) {
    s.gms = (bf16*)take(n * c * 2);
    s.xhat = (float*)take(n * c * 4);
    s.inv = (float*)take(n * 4);
  }
  s.bytes = off;
  return s;
}

}  // namespace

int64_t robseg_mlp_scratch_bf16(int64_t n, int C, bool with_h, bool bwd) {
  return (int64_t)carve_bf16(nullptr, n, C, with_h, bwd).bytes;
}

int robseg_mlp_fwd_bf16(const float* x, const float* ls, const float* lb,
                        const float* w1, const float* b1, const float* w2,
                        const float* b2, const float* gamma, void* scratch,
                        float* out, float* h, int64_t n, int C, int sms,
                        cudaStream_t s) {
  const TailBf16 sc = carve_bf16((char*)scratch, n, C, h != nullptr, false);
  PackParams pk = {};
  add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kCastBf16);
  int e = pack(pk, s);
  if (!e)
    e = ln_rows<bf16>(x, ls, lb, sc.u, nullptr, nullptr, nullptr, nullptr,
                       nullptr, n, C, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = b1;
    p.b2 = b2;
    p.gamma = gamma;
    p.out = out;
    p.h = h;
    p.n = n;
    switch (C) {
#define X(W)                                                               \
  case W:                                                                  \
    return h ? launch_fused<W, false, true>(p, sc.u, nullptr, sc.w1,       \
                                            nullptr, sc.w2, sms, s)        \
             : launch_fused<W, false, false>(p, sc.u, nullptr, sc.w1,      \
                                             nullptr, sc.w2, sms, s);
      ROBSEG_TAIL_FUSED_WIDTHS(X)
#undef X
      default: return -1;
    }
  }
  GemmParams p = {};
  p.bias = b1;
  p.h = h;
  p.out = sc.hid;
  p.m = n;
  p.n = 4 * C;
  e = launch_gemm<kGelu>(p, sc.u, sc.w1, nullptr, nullptr, C, sms, s);
  if (e) return e;
  p = GemmParams{};
  p.bias = b2;
  p.gamma = gamma;
  p.out = out;
  p.m = n;
  p.n = C;
  return launch_gemm<kResid>(p, sc.hid, sc.w2, nullptr, nullptr, 4 * C, sms,
                             s);
}

int robseg_mlp_dx_bf16(const float* x, const float* h, const float* gout,
                       const float* ls, const float* lb, const float* w1,
                       const float* b1, const float* w2, const float* gamma,
                       void* scratch, float* dx, int64_t n, int C, int sms,
                       cudaStream_t s) {
  const bool read_h = h != nullptr;
  const TailBf16 sc = carve_bf16((char*)scratch, n, C, read_h, true);
  // [W1 (4C, C)]; W2^T (4C, C) for da = gms . W2; W1^T (C, 4C) for
  // du = dh . W1
  PackParams pk = {};
  if (!read_h) add_job(pk, w1, sc.w1, 4 * C, C, kCastBf16);
  add_job(pk, w2, sc.w2, C, 4 * C, kTransposeBf16);
  add_job(pk, w1, sc.w1t, 4 * C, C, kTransposeBf16);
  int e = pack(pk, s);
  if (!e)
    e = ln_rows<bf16>(x, ls, lb, sc.u, sc.xhat, sc.inv, gout, gamma,
                       sc.gms, n, C, s);
  if (e) return e;
  if (C <= kFusedMaxC) {
    FusedParams p = {};
    p.b1 = b1;
    p.h = const_cast<float*>(h);
    p.xhat = sc.xhat;
    p.inv = sc.inv;
    p.ls = ls;
    p.dyconv = dx;  // the LayerNorm backward in the epilogue gives dx
    p.n = n;
    switch (C) {
#define X(W)                                                                \
  case W:                                                                   \
    return read_h ? launch_fused<W, true, true>(p, nullptr, sc.gms, nullptr, \
                                                sc.w2, sc.w1t, sms, s)      \
                  : launch_fused<W, true, false>(p, sc.u, sc.gms, sc.w1,    \
                                                 sc.w2, sc.w1t, sms, s);
      ROBSEG_TAIL_FUSED_WIDTHS(X)
#undef X
      default: return -1;
    }
  }
  GemmParams p = {};
  p.bias = b1;
  p.h = const_cast<float*>(h);
  p.out = sc.hid;
  p.m = n;
  p.n = 4 * C;
  e = read_h ? launch_gemm<kDgeluH>(p, sc.gms, sc.w2, nullptr, nullptr, C,
                                    sms, s)
             : launch_gemm<kDgelu>(p, sc.u, sc.w1, sc.gms, sc.w2, C, sms, s);
  if (e) return e;
  p = GemmParams{};
  p.out = dx;
  p.m = n;
  p.n = C;
  e = launch_gemm<kStore>(p, sc.hid, sc.w1t, nullptr, nullptr, 4 * C, sms, s);
  if (e) return e;
  return ln_bwd(dx, sc.xhat, sc.inv, ls, n, C, s);
}

extern "C" int robseg_convnext_mlp_supported(int C) {
  switch (C) {
#define X(W) \
  case W:    \
    return 1;
    ROBSEG_MLP_WIDTHS(X)
#undef X
    default:
      return 0;
  }
}

// Bytes of scratch a call needs: with_h (forward: h is saved; backward: h
// is read), bf16 operands or float32, forward or backward.
extern "C" int64_t robseg_convnext_mlp_scratch(int64_t n, int C, int with_h,
                                               int bf16_operands,
                                               int backward) {
  return bf16_operands
             ? robseg_mlp_scratch_bf16(n, C, with_h != 0, backward != 0)
             : robseg_mlp_scratch_f32(n, C, with_h != 0, backward != 0);
}

// Forward. x, out: (n, C) f32; w1: (4C, C), w2: (C, 4C), vectors (C) or
// (4C), all f32 (the call packs them); h: (n, 4C) f32 written when not
// null; scratch: robseg_convnext_mlp_scratch(n, C, h != null,
// bf16_operands, 0) bytes; sms: the SM count of the card the call
// launches on (the current device), the persistent grids' size, from the
// caller as for the block's entry points. Returns 0, a CUDA error, -1 for
// an unsupported width, or -(CUresult) if a tensor map was refused.
extern "C" int robseg_convnext_mlp_fwd(const float* x, const float* ls,
                                       const float* lb, const float* w1,
                                       const float* b1, const float* w2,
                                       const float* b2, const float* gamma,
                                       void* scratch, float* out, float* h,
                                       int64_t n, int C, int bf16_operands,
                                       int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (sms < 1) return (int)cudaErrorInvalidValue;
  return bf16_operands
             ? robseg_mlp_fwd_bf16(x, ls, lb, w1, b1, w2, b2, gamma, scratch,
                                   out, h, n, C, sms, s)
             : robseg_mlp_fwd_f32(x, ls, lb, w1, b1, w2, b2, gamma, scratch,
                                  out, h, n, C, sms, s);
}

// Input gradient. x, gout, dx: (n, C) f32; h: the forward's saved (n, 4C)
// f32 hidden, or null to recompute it; parameters as for the forward;
// scratch: robseg_convnext_mlp_scratch(n, C, h != null, bf16_operands, 1)
// bytes; sms as for the forward.
extern "C" int robseg_convnext_mlp_dx(const float* x, const float* h,
                                      const float* gout, const float* ls,
                                      const float* lb, const float* w1,
                                      const float* b1, const float* w2,
                                      const float* gamma, void* scratch,
                                      float* dx, int64_t n, int C,
                                      int bf16_operands, int sms,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  if (sms < 1) return (int)cudaErrorInvalidValue;
  return bf16_operands
             ? robseg_mlp_dx_bf16(x, h, gout, ls, lb, w1, b1, w2, gamma,
                                  scratch, dx, n, C, sms, s)
             : robseg_mlp_dx_f32(x, h, gout, ls, lb, w1, b1, w2, gamma,
                                 scratch, dx, n, C, sms, s);
}
