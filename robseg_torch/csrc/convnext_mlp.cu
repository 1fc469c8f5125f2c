// The ConvNeXt block's MLP tail, forward and input gradient, for Hopper.
//
//   m = gamma * (GELU(LN(y) . W1^T + b1) . W2^T + b2)
//
// (no residual: the caller adds it; y is the depthwise-conv output).
// Replaces: robseg_tpu/kernels/convnext_mlp.py, all four entry points:
//   convnext_mlp_fused, _bf16       (_call :165: _fwd_kernel, _bwd_kernel)
//   convnext_mlp_fused_rs, _rs_bf16 (_call_save :271: _fwd_save_kernel;
//                                    _call_resid_bwd :309: _bwd_resid_kernel)
// One forward and one backward kernel template cover them: BF16 picks the
// matmul operands (bf16, as mxu_bf16=True, or float32), SAVE_H makes the
// forward also write the pre-GELU hidden h (N, 4C) f32 once, READ_H makes
// the backward read it back instead of recomputing it (2 matmuls, not 3).
// Widths C in {96, 128, 192, 256, 384}: the JAX model runs this tail for
// blocks with dim <= 384 only.
//
// Numerics. LayerNorm (eps 1e-6), GELU (the exact erff: the polynomial
// _erf exists only because Mosaic lacks erf) and the LayerNorm backward
// run in f32. BF16: operands rounded to bf16 where the TPU kernel rounds
// them (u and W1, gelu(h) and W2; gamma*dy and W2, dh and W1), one bf16
// tensor-core pass each, f32 accumulation. Float32: a split-precision
// product, 3xTF32 - each operand a = a_hi + a_lo with a_hi = tf32(a) and
// a_lo = tf32(a - a_hi), a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi - which
// keeps ~22 significant bits of each operand and so float32 accuracy; a
// single TF32 pass (10 bits) would not meet the float32 bounds.
//
// Bound on the H100: the forward does 16*N*C^2 flops and moves 8*N*C
// bytes (x in, m out; +16*N*C with h saved), the backward 24*N*C^2 (16 with
// h read) against 12*N*C (+16*N*C). At stage 0 of the 512^2 model (N =
// 16*128*128, C = 96) the bf16 forward is bound by bytes (~0.06 ms, ~0.18
// ms with h saved), the float32 forward by the FP32 rate (~0.58 ms at 67
// TFLOP/s). What the design does about it: like the TPU kernel, each
// block keeps a tile of TM tokens on chip; the hidden layer goes through
// shared memory 64 units at a time (h, GELU, operand rounding) and folds
// at once into an f32 accumulator held in wmma fragments, so with h neither
// saved nor read the 4C-wide hidden layer never reaches device memory.
// Weights are read as fragments through L1/L2, where all blocks share
// them; shared-memory weight panels, wgmma and TMA are later work.

#include "convnext_mlp.cuh"

// the bf16-operand instantiations (the float32 ones: convnext_mlp_f32.cu)
ROBSEG_MLP_DEFINE(bf16, true)

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

// Forward. x, out: (n, C) f32; w1: (4C, C), w2: (C, 4C), bf16 when
// bf16_operands else f32; h: (n, 4C) f32 written when not null.
extern "C" int robseg_convnext_mlp_fwd(const float* x, const float* ls,
                                       const float* lb, const void* w1,
                                       const float* b1, const void* w2,
                                       const float* b2, const float* gamma,
                                       float* out, float* h, int64_t n, int C,
                                       int bf16_operands, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  return bf16_operands
             ? robseg_mlp_fwd_bf16(x, ls, lb, w1, b1, w2, b2, gamma, out, h,
                                   n, C, s)
             : robseg_mlp_fwd_f32(x, ls, lb, w1, b1, w2, b2, gamma, out, h,
                                  n, C, s);
}

// Input gradient. x, gout, dx: (n, C) f32; h: the forward's saved (n, 4C)
// f32 hidden, or null to recompute it; weights as for the forward.
extern "C" int robseg_convnext_mlp_dx(const float* x, const float* h,
                                      const float* gout, const float* ls,
                                      const float* lb, const void* w1,
                                      const float* b1, const void* w2,
                                      const float* gamma, float* dx,
                                      int64_t n, int C, int bf16_operands,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return 0;
  return bf16_operands
             ? robseg_mlp_dx_bf16(x, h, gout, ls, lb, w1, b1, w2, gamma, dx,
                                  n, C, s)
             : robseg_mlp_dx_f32(x, h, gout, ls, lb, w1, b1, w2, gamma, dx,
                                 n, C, s);
}
