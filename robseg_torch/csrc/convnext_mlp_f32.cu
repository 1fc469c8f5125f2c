// The float32-operand (3xTF32) MLP-tail kernels; what they compute and
// replace, and why two GEMMs: convnext_mlp.cu. A translation unit of its
// own so that nvcc compiles it beside the bf16 one.
//
// mlp_tf32_kernel<BN, AM, EPI>: out (m x n) = A (m x k) . B (n x k)^T with
// a fused epilogue, persistent (one block per SM walks 128 x BN output
// tiles), warp-specialised: one producer thread keeps a ring of K-steps in
// flight through TMA (each step 32 floats deep: 128-byte rows under the
// 128-byte swizzle, the C = 96 tail and ragged token tiles zero-filled),
// two consumer warpgroups own 64 rows each.
//
// A is one f32 tile (u, gelu's input h, gms or dh): each consumer thread
// reads its wgmma A fragments from shared memory (the layout in
// hopper.cuh), transforms them (AM: kAGelu applies the GELU, kAPlain
// nothing), splits them into hi and lo and feeds them from registers; B is
// the packed weight's hi and lo halves. Reading A once and splitting it on
// chip halves A's bytes against a hi/lo pair in memory, at two ALU
// operations an element. The fragments are double-buffered: a K-step's
// transform runs while the previous step's products are in flight. Each
// K-step runs three wgmma passes a k8 slice (a_lo.b_hi, a_hi.b_lo,
// a_hi.b_hi, the small terms first) into a step accumulator, which is then
// added to the tile's sum in f32.
//
// Registers per consumer thread (setmaxnreg 232): the tile's sum BN / 2
// and the step accumulator BN / 2 (64 + 64 at BN = 128), two buffers of
// A fragments 2 x 32 (hi and lo of four k8 slices), plus addressing.
// BN = 128 for the 4C-wide products; 96 for the C-wide ones at C = 96 and
// 192 (no store mask), 128 at C = 128, 256 and 384. Shared memory: a stage
// is A (16 KB) and B's pair (2 x BN x 128 bytes), 4 stages at BN = 128, 5
// at 96.

#include "convnext_mlp.cuh"

namespace {

enum Tf32A { kAGelu = 0, kAPlain = 1 };
enum Tf32Epi {
  kHBias = 0,     // out = acc + bias
  kOutGamma = 1,  // out = gamma (acc + bias)
  kDhGeluH = 2,   // out = acc * gelu'(h), h read (m, n)
  kOutStore = 3,  // out = acc
};

struct Tf32Params {
  CUtensorMap a;     // A: f32 (m, k), box {32, 128}
  CUtensorMap b[2];  // B hi, lo: f32 (n, k), box {32, BN}
  const float* bias;
  const float* gamma;
  const float* h;
  float* out;        // (m, n) f32
  int64_t m;
  int n, kc, tiles_n, tiles;
};

template <int BN>
struct Tf32 {
  static constexpr uint32_t kA = 128 * 128;  // 128 rows of 32 floats
  static constexpr uint32_t kB = BN * 128;
  static constexpr uint32_t kStage = kA + 2 * kB;
  static constexpr int kFit = (kSmemBudget - 2048) / (int)kStage;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kStage + 16 * kStages;
  static_assert(kB % 1024 == 0, "swizzle atoms");
  static_assert(kStages >= 2, "the ring needs two stages");
};

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

template <int BN>
__device__ __forceinline__ void tf32_producer(const Tf32Params& p,
                                              uint32_t base, uint32_t bars) {
  typedef Tf32<BN> G;
  constexpr int S = G::kStages;
  prefetch_map(&p.a);
  prefetch_map(&p.b[0]);
  prefetch_map(&p.b[1]);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.tiles_n) * 128, n0 = (tile % p.tiles_n) * BN;
    for (int k = 0; k < p.kc; ++k, ++it) {
      const int st = it % S;
      const uint32_t full = bars + 8 * st;
      mbar_wait(bars + 8 * (S + st), ((it / S) & 1) ^ 1);
      mbar_expect_tx(full, G::kStage);
      const uint32_t s = base + st * G::kStage;
      tma_load_2d(s, &p.a, full, k * 32, m0);
      tma_load_2d(s + G::kA, &p.b[0], full, k * 32, n0);
      tma_load_2d(s + G::kA + G::kB, &p.b[1], full, k * 32, n0);
    }
  }
}

// The A fragments of one K-step: for k8 slice kk, rows 16 warp + lane / 4
// + {0, 8} and columns 8 kk + lane % 4 + {0, 4} of this warpgroup's 64
// rows, read through the swizzle (16-byte chunk c / 4 of row r sits at
// chunk (c / 4) ^ (r % 8)), transformed and split.
template <int AM>
__device__ __forceinline__ void tf32_frags(uint32_t a, int warp, int lane,
                                           uint32_t (&fh)[4][4],
                                           uint32_t (&fl)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = warp * 16 + lane / 4 + 8 * (v & 1);
      const int c = 8 * kk + lane % 4 + 4 * (v >> 1);
      float x =
          ld_shared(a + r * 128 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4);
      if constexpr (AM == kAGelu) x = gelu(x);
      const float hi = tf32_hi(x);
      fh[kk][v] = __float_as_uint(hi);
      fl[kk][v] = __float_as_uint(x - hi);
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_frag(fh[kk]);
    fence_frag(fl[kk]);
  }
}

template <int BN, int AM, int EPI>
__device__ __forceinline__ void tf32_consumer(const Tf32Params& p,
                                              uint32_t base, uint32_t bars,
                                              int wg) {
  typedef Tf32<BN> G;
  constexpr int S = G::kStages;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float d[BN / 2];  // the tile's sum
  float t[BN / 2];  // one K-step's; h in the kDhGeluH epilogue
  uint32_t fh[2][4][4], fl[2][4][4];  // two K-steps' A fragments
  int it = 0;       // K-steps consumed by this block, over all its tiles
  const uint32_t wrow = wg * kRows64;  // this warpgroup's 64 rows
  auto stage = [&](int i) { return base + (i % S) * G::kStage; };
  // K-step k of the tile from fragments f, the next step's fragments into
  // g while the products run; then the step's sum into d
  auto step = [&](int k, uint32_t(&fh_)[4][4], uint32_t(&fl_)[4][4],
                  uint32_t(&gh)[4][4], uint32_t(&gl)[4][4]) {
    const uint32_t s = stage(it);
    const uint64_t bh = smem_desc(s + G::kA), bl = smem_desc(s + G::kA + G::kB);
    fence_acc(t);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_tf32<BN>(t, fl_[kk], bh + 2 * kk, kk != 0);
      wgmma_rs_tf32<BN>(t, fh_[kk], bl + 2 * kk, 1);
      wgmma_rs_tf32<BN>(t, fh_[kk], bh + 2 * kk, 1);
    }
    wgmma_commit();
    fence_acc(t);
    if (k + 1 < p.kc) {
      mbar_wait(bars + 8 * ((it + 1) % S), ((it + 1) / S) & 1);
      tf32_frags<AM>(stage(it + 1) + wrow, warp, lane, gh, gl);
    }
    wgmma_wait<0>();
    fence_acc(t);
    if (lane == 0) mbar_arrive(bars + 8 * (S + it % S));  // stage read
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = k ? d[i] + t[i] : t[i];
    ++it;
  };
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int64_t m0 = (int64_t)(tile / p.tiles_n) * 128;
    const int n0 = (tile % p.tiles_n) * BN;
    mbar_wait(bars + 8 * (it % S), (it / S) & 1);
    tf32_frags<AM>(stage(it) + wrow, warp, lane, fh[0], fl[0]);
    for (int k = 0; k < p.kc; k += 2) {
      step(k, fh[0], fl[0], fh[1], fl[1]);
      if (k + 1 < p.kc) step(k + 1, fh[1], fl[1], fh[0], fl[0]);
    }

    // epilogue: rows r0 and r0 + 8, columns n0 + 8 j + 2 (lane % 4) + {0, 1}
    const int64_t r0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int c0 = n0 + 2 * (lane % 4);
    if constexpr (EPI == kDhGeluH) {
      // all of the tile's h first (rows past m read row m - 1), so the
      // loads are in flight together
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int64_t row = min(r0 + 8 * hh, p.m - 1);
          const float2 hv = __ldg(
              reinterpret_cast<const float2*>(p.h + row * p.n + c0 + 8 * j));
          t[4 * j + 2 * hh] = hv.x;
          t[4 * j + 2 * hh + 1] = hv.y;
        }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = c0 + 8 * j;
      float2 bb = make_float2(0.0f, 0.0f), g = make_float2(0.0f, 0.0f);
      if constexpr (EPI == kHBias || EPI == kOutGamma)
        bb = __ldg(reinterpret_cast<const float2*>(p.bias + col));
      if constexpr (EPI == kOutGamma)
        g = __ldg(reinterpret_cast<const float2*>(p.gamma + col));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t row = r0 + 8 * hh;
        if (row >= p.m) continue;
        const int64_t o = row * p.n + col;
        const int i = 4 * j + 2 * hh;
        float2 v;
        if constexpr (EPI == kHBias) {
          v = make_float2(d[i] + bb.x, d[i + 1] + bb.y);
        } else if constexpr (EPI == kOutGamma) {
          v = make_float2(g.x * (d[i] + bb.x), g.y * (d[i + 1] + bb.y));
        } else if constexpr (EPI == kDhGeluH) {
          v = make_float2(d[i] * gelu_grad(t[i]),
                          d[i + 1] * gelu_grad(t[i + 1]));
        } else {
          v = make_float2(d[i], d[i + 1]);
        }
        *reinterpret_cast<float2*>(p.out + o) = v;
      }
    }
  }
}

template <int BN, int AM, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tf32_kernel(const __grid_constant__ Tf32Params p) {
  typedef Tf32<BN> G;
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
    if (threadIdx.x % 128 == 0) tf32_producer<BN>(p, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    tf32_consumer<BN, AM, EPI>(p, base, bars, wg);
  }
}

// out (m, n) from A (m, k) f32 and B (n, k): hi at b, lo at b + n k
template <int BN, int AM, int EPI>
int launch_tf32(Tf32Params& p, const float* a, const float* b, int k,
                int sms, cudaStream_t stream) {
  typedef Tf32<BN> G;
  if (p.n % BN || k % 32) return (int)cudaErrorInvalidValue;
  int e = map2d(&p.a, a, p.m, k, 128, true);
  if (!e) e = map2d(&p.b[0], b, p.n, k, BN, true);
  if (!e) e = map2d(&p.b[1], b + (int64_t)p.n * k, p.n, k, BN, true);
  if (e) return e;
  p.kc = k / 32;
  p.tiles_n = p.n / BN;
  const int64_t tiles = (p.m + 127) / 128 * p.tiles_n;
  if (tiles > INT32_MAX) return (int)cudaErrorInvalidValue;
  p.tiles = (int)tiles;
  const cudaError_t ce = cudaFuncSetAttribute(
      mlp_tf32_kernel<BN, AM, EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  mlp_tf32_kernel<BN, AM, EPI><<<grid_for(p.tiles, sms), kThreads, G::kSmem,
                                 stream>>>(p);
  return (int)cudaGetLastError();
}

// the C-wide products: 96-wide tiles at C = 96 and 192, 128 otherwise
template <int AM, int EPI>
int launch_narrow(Tf32Params& p, const float* a, const float* b, int k,
                  int sms, cudaStream_t stream) {
  return p.n % 128 ? launch_tf32<96, AM, EPI>(p, a, b, k, sms, stream)
                   : launch_tf32<128, AM, EPI>(p, a, b, k, sms, stream);
}

// The scratch of a float32 call, carved into 256-byte aligned parts, each
// weight as its hi/lo pair (hi, then lo): forward W1 (4C, C) and W2 (C,
// 4C), u (n, C), h (n, 4C) unless the caller saves it; backward W2^T (4C,
// C) and W1^T (C, 4C), [with h recomputed: W1, u and h], gms (n, C), xhat
// (n, C), inv (n) and dh (n, 4C).
struct TailF32 {
  float *w1, *w2, *w2t, *w1t, *u, *h, *gms, *xhat, *inv, *dh;
  size_t bytes;
};

TailF32 carve_f32(char* base, int64_t n, int C, bool with_h, bool bwd) {
  TailF32 s = {};
  size_t off = 0;
  auto take = [&](size_t bytes) -> float* {
    void* p = base ? base + off : nullptr;
    off += (bytes + 255) & ~(size_t)255;
    return static_cast<float*>(p);
  };
  const size_t c = C, w = 2 * 4 * c * c * 4;
  if (bwd) {
    s.w2t = take(w);
    s.w1t = take(w);
  }
  if (!bwd) s.w2 = take(w);
  if (!(bwd && with_h)) {
    s.w1 = take(w);
    s.u = take(n * c * 4);
  }
  if (!with_h) s.h = take(n * 4 * c * 4);
  if (bwd) {
    s.gms = take(n * c * 4);
    s.xhat = take(n * c * 4);
    s.inv = take(n * 4);
    s.dh = take(n * 4 * c * 4);
  }
  s.bytes = off;
  return s;
}

}  // namespace

int64_t robseg_mlp_scratch_f32(int64_t n, int C, bool with_h, bool bwd) {
  return (int64_t)carve_f32(nullptr, n, C, with_h, bwd).bytes;
}

int robseg_mlp_fwd_f32(const float* x, const float* ls, const float* lb,
                       const float* w1, const float* b1, const float* w2,
                       const float* b2, const float* gamma, void* scratch,
                       float* out, float* h, int64_t n, int C, int sms,
                       cudaStream_t s) {
  const TailF32 sc = carve_f32((char*)scratch, n, C, h != nullptr, false);
  PackParams pk = {};
  add_job(pk, w1, sc.w1, 4 * C, C, kSplitTf32);
  add_job(pk, w2, sc.w2, C, 4 * C, kSplitTf32);
  int e = pack(pk, s);
  if (!e)
    e = ln_rows<float>(x, ls, lb, sc.u, nullptr, nullptr, nullptr, nullptr,
                       nullptr, n, C, s);
  if (e) return e;
  float* hid = h ? h : sc.h;
  Tf32Params p = {};
  p.bias = b1;
  p.out = hid;
  p.m = n;
  p.n = 4 * C;
  e = launch_tf32<128, kAPlain, kHBias>(p, sc.u, sc.w1, C, sms, s);
  if (e) return e;
  p = Tf32Params{};
  p.bias = b2;
  p.gamma = gamma;
  p.out = out;
  p.m = n;
  p.n = C;
  return launch_narrow<kAGelu, kOutGamma>(p, hid, sc.w2, 4 * C, sms, s);
}

int robseg_mlp_dx_f32(const float* x, const float* h, const float* gout,
                      const float* ls, const float* lb, const float* w1,
                      const float* b1, const float* w2, const float* gamma,
                      void* scratch, float* dx, int64_t n, int C, int sms,
                      cudaStream_t s) {
  const bool read_h = h != nullptr;
  const TailF32 sc = carve_f32((char*)scratch, n, C, read_h, true);
  PackParams pk = {};
  add_job(pk, w2, sc.w2t, C, 4 * C, kTransposeSplitTf32);
  add_job(pk, w1, sc.w1t, 4 * C, C, kTransposeSplitTf32);
  if (!read_h) add_job(pk, w1, sc.w1, 4 * C, C, kSplitTf32);
  int e = pack(pk, s);
  if (!e)
    e = ln_rows<float>(x, ls, lb, sc.u, sc.xhat, sc.inv, gout, gamma, sc.gms,
                       n, C, s);
  if (e) return e;
  Tf32Params p = {};
  if (!read_h) {  // h = u . W1^T + b1 again
    p.bias = b1;
    p.out = sc.h;
    p.m = n;
    p.n = 4 * C;
    e = launch_tf32<128, kAPlain, kHBias>(p, sc.u, sc.w1, C, sms, s);
    if (e) return e;
    h = sc.h;
  }
  // dh = (gms . W2) GELU'(h)
  p = Tf32Params{};
  p.h = h;
  p.out = sc.dh;
  p.m = n;
  p.n = 4 * C;
  e = launch_tf32<128, kAPlain, kDhGeluH>(p, sc.gms, sc.w2t, C, sms, s);
  if (e) return e;
  // du = dh . W1, then the LayerNorm backward in place
  p = Tf32Params{};
  p.out = dx;
  p.m = n;
  p.n = C;
  e = launch_narrow<kAPlain, kOutStore>(p, sc.dh, sc.w1t, 4 * C, sms, s);
  if (e) return e;
  return ln_bwd(dx, sc.xhat, sc.inv, ls, n, C, s);
}
