// Confusion-matrix histogram, per image or summed over the batch.
//
// Replaces: robseg_tpu/kernels/confusion.py::confusion_matrix_pallas
// (_conf_kernel), which accumulates hist[t, p] with one-hot matmuls in
// VMEM over a sequential grid. Like the JAX package's confusion_matrix it
// takes any number of classes K.
//
// Bound on the H100: memory. Each pixel is two int64 loads (16 bytes) and
// at most one increment. The TPU builds one-hots because its matrix unit
// is the fast path; here the fast path is an integer atomic. Integer
// atomics commute, so the result is exact and independent of order.
//
// Two forms share one pixel loop; the caller picks the form and its launch
// parameters (robseg_torch/kernels/confusion.py::plan):
//  - confusion_kernel, the shared form, K <= 238: the whole K x K int32
//    histogram lives in shared memory (at K = 238 one 226,576-byte copy).
//  - confusion_global_kernel, the global form, K >= 239: the histogram
//    lives in the output in global memory, where the atomics resolve in
//    the L2 (at K = 847 2.9 MB summed, 46 MB per image at batch 16). Where
//    the images' outputs pass 5/8 of the L2, plan's grid covers half the
//    images at once, so that the outputs being counted stay in it (at
//    K = 847 per image on an NVIDIA H100 80GB HBM3 at 700 W the kernel
//    took 0.100 ms with all 16 images at once, 0.074 with 8). Most counted
//    pixels of a segmentation map sit on the diagonal t == p, the
//    addresses L2 atomics would serialise on, so the diagonal is counted
//    in shared memory (K ints a copy, per warp where they fit) and only
//    its non-zero entries are flushed. Bin offsets are 64-bit, so K has
//    no limit but the output's memory.
//
// The pixel loop:
//  - Each thread takes 8 consecutive pixels at a time through four 16-byte
//    loads of each array (longlong2), all issued before any is used.
//  - Within those 8 pixels it merges runs of one (target, pred) bin into a
//    single atomic: label maps are piecewise constant, so on real data a
//    thread's 8 pixels are mostly one run, and the same-address atomics of
//    a one-atomic-a-pixel design mostly disappear.
//  - The shared histogram is replicated per warp where K^2 allows (K = 21:
//    16 copies, 28 KB), so warps never contend on one bin; at K = 151 one
//    91 KB copy a block.
//  - 512-thread blocks (64 registers a thread: the 8 pixels' loads alone
//    take 32), two a SM where the shared memory allows, and a grid of the
//    card's resident blocks (split over the images when per image): few
//    blocks, so few histogram flushes (only non-zero bins reach global
//    memory).
//  - The output is float32 when every count stays below 2^24 (exact, also
//    through float atomics, and no conversion pass afterwards), else int32.
//
// A pixel counts when t != ignore, 0 <= t < K and 0 <= p < K: a p out of
// range adds nothing, as the JAX one-hot gives it a zero row.
//
// confusion_v1_kernel is the shared form's first design (one shared
// atomic a pixel, scalar loads, 256-thread blocks, one histogram copy),
// kept as the yardstick chip_smoke.py times the redesign against; the
// package does not call it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                   // pixels a thread takes at once
constexpr int kSmemTwoBlocks = 113 * 1024;  // two blocks fit on an SM
constexpr int kSmemMax = 227 * 1024;
constexpr int kShared = 0;                // the forms, as plan() names them
constexpr int kGlobal = 1;

__device__ __forceinline__ int bin_of(int64_t t, int64_t p, int k,
                                      int64_t ignore) {
  return (t != ignore && t >= 0 && t < k && p >= 0 && p < k)
             ? (int)(t * k + p)
             : -1;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    confusion_kernel(const int64_t* __restrict__ pred,
                     const int64_t* __restrict__ target,
                     OutT* __restrict__ hist, int64_t n, int k,
                     int64_t ignore, int copies) {
  extern __shared__ int sh[];
  const int kk = k * k;
  for (int i = threadIdx.x; i < kk * copies; i += kThreads) sh[i] = 0;
  __syncthreads();
  int* h = sh + (threadIdx.x / 32 % copies) * kk;
  const int64_t b = blockIdx.y;
  const int64_t* p = pred + b * n;
  const int64_t* t = target + b * n;
  // the row starts 16-byte aligned (the base pointers are) unless b * n is
  // odd; then its first pixel comes before the first vector
  const int64_t head = (b * n) & 1;
  const int64_t groups = (n - head) / kRun;
  const int64_t g0 = groups * blockIdx.x / gridDim.x;
  const int64_t g1 = groups * (blockIdx.x + 1) / gridDim.x;
  for (int64_t g = g0 + threadIdx.x; g < g1; g += kThreads) {
    const int64_t base = head + g * kRun;
    const longlong2* t2 = reinterpret_cast<const longlong2*>(t + base);
    const longlong2* p2 = reinterpret_cast<const longlong2*>(p + base);
    longlong2 tv[kRun / 2], pv[kRun / 2];
#pragma unroll
    for (int q = 0; q < kRun / 2; ++q) {
      tv[q] = __ldg(t2 + q);
      pv[q] = __ldg(p2 + q);
    }
    int run = -1, count = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int64_t tj = (j & 1) ? tv[j / 2].y : tv[j / 2].x;
      const int64_t pj = (j & 1) ? pv[j / 2].y : pv[j / 2].x;
      const int bj = bin_of(tj, pj, k, ignore);
      if (bj != run) {
        if (run >= 0) atomicAdd(&h[run], count);
        run = bj;
        count = 0;
      }
      ++count;
    }
    if (run >= 0) atomicAdd(&h[run], count);
  }
  // the unaligned first pixel and the ragged last (< 8) of the row
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + groups * kRun;
    const int64_t i = threadIdx.x == 0 ? 0 : tail0 + threadIdx.x - 1;
    if ((threadIdx.x == 0 && head) || (threadIdx.x > 0 && i < n)) {
      const int bj = bin_of(t[i], p[i], k, ignore);
      if (bj >= 0) atomicAdd(&h[bj], 1);
    }
  }
  __syncthreads();
  OutT* out = hist + b * kk;
  for (int i = threadIdx.x; i < kk; i += kThreads) {
    int v = 0;
    for (int c = 0; c < copies; ++c) v += sh[c * kk + i];
    if (v) atomicAdd(&out[i], (OutT)v);
  }
}

// One run of `count` pixels of bin (t, p) (t < 0: not counted): the
// diagonal's first `dn` classes into this warp's shared copy, every other
// bin straight into the output.
template <typename OutT>
__device__ __forceinline__ void add_run(int t, int p, int count, int* diag,
                                        int dn, OutT* out, int k) {
  if (t < 0) return;
  if (t == p && t < dn)
    atomicAdd(&diag[t], count);
  else
    atomicAdd(&out[(int64_t)t * k + p], (OutT)count);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    confusion_global_kernel(const int64_t* __restrict__ pred,
                            const int64_t* __restrict__ target,
                            OutT* __restrict__ hist, int64_t n, int k,
                            int64_t ignore, int copies, int dn) {
  extern __shared__ int sh[];
  for (int i = threadIdx.x; i < dn * copies; i += kThreads) sh[i] = 0;
  __syncthreads();
  int* diag = sh + (threadIdx.x / 32 % copies) * dn;
  const int64_t b = blockIdx.y;
  const int64_t* p = pred + b * n;
  const int64_t* t = target + b * n;
  OutT* out = hist + b * ((int64_t)k * k);
  // the pixel loop of confusion_kernel, with the run kept as (t, p)
  const int64_t head = (b * n) & 1;
  const int64_t groups = (n - head) / kRun;
  const int64_t g0 = groups * blockIdx.x / gridDim.x;
  const int64_t g1 = groups * (blockIdx.x + 1) / gridDim.x;
  for (int64_t g = g0 + threadIdx.x; g < g1; g += kThreads) {
    const int64_t base = head + g * kRun;
    const longlong2* t2 = reinterpret_cast<const longlong2*>(t + base);
    const longlong2* p2 = reinterpret_cast<const longlong2*>(p + base);
    longlong2 tv[kRun / 2], pv[kRun / 2];
#pragma unroll
    for (int q = 0; q < kRun / 2; ++q) {
      tv[q] = __ldg(t2 + q);
      pv[q] = __ldg(p2 + q);
    }
    int rt = -1, rp = -1, count = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int64_t tj = (j & 1) ? tv[j / 2].y : tv[j / 2].x;
      const int64_t pj = (j & 1) ? pv[j / 2].y : pv[j / 2].x;
      const bool ok =
          tj != ignore && tj >= 0 && tj < k && pj >= 0 && pj < k;
      const int ct = ok ? (int)tj : -1;
      const int cp = ok ? (int)pj : -1;
      if (ct != rt || cp != rp) {
        add_run(rt, rp, count, diag, dn, out, k);
        rt = ct;
        rp = cp;
        count = 0;
      }
      ++count;
    }
    add_run(rt, rp, count, diag, dn, out, k);
  }
  // the unaligned first pixel and the ragged last (< 8) of the row
  if (blockIdx.x == 0) {
    const int64_t tail0 = head + groups * kRun;
    const int64_t i = threadIdx.x == 0 ? 0 : tail0 + threadIdx.x - 1;
    if ((threadIdx.x == 0 && head) || (threadIdx.x > 0 && i < n)) {
      const int64_t ti = t[i], pi = p[i];
      if (ti != ignore && ti >= 0 && ti < k && pi >= 0 && pi < k)
        add_run((int)ti, (int)pi, 1, diag, dn, out, k);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < dn; i += kThreads) {
    int v = 0;
    for (int c = 0; c < copies; ++c) v += sh[c * dn + i];
    if (v) atomicAdd(&out[(int64_t)i * k + i], (OutT)v);
  }
}

__global__ void confusion_v1_kernel(const int64_t* __restrict__ pred,
                                    const int64_t* __restrict__ target,
                                    int* __restrict__ hist,
                                    int64_t per_image, int k, int64_t ignore,
                                    int sum_batch) {
  extern __shared__ int sh[];
  const int kk = k * k;
  for (int i = threadIdx.x; i < kk; i += blockDim.x) sh[i] = 0;
  __syncthreads();
  const int64_t b = blockIdx.y;
  const int64_t* p = pred + b * per_image;
  const int64_t* t = target + b * per_image;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < per_image; i += stride) {
    const int64_t tv = t[i];
    const int64_t pv = p[i];
    if (tv != ignore && tv >= 0 && tv < k && pv >= 0 && pv < k)
      atomicAdd(&sh[tv * k + pv], 1);
  }
  __syncthreads();
  int* out = hist + (sum_batch ? 0 : b * kk);
  for (int i = threadIdx.x; i < kk; i += blockDim.x) {
    const int v = sh[i];
    if (v) atomicAdd(&out[i], v);
  }
}

template <typename OutT>
int launch(int form, const int64_t* pred, const int64_t* target, OutT* hist,
           int64_t batch, int64_t n, int k, int64_t ignore, int copies,
           int width, int64_t gx, cudaStream_t stream) {
  const size_t smem = (size_t)copies * width * sizeof(int);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // host work once a process, card and form (function attributes are a
  // card's): allow the largest dynamic shared memory
  constexpr int kCards = 64;
  static bool smem_set[kCards][2] = {};
  int card = 0;
  cudaError_t got = cudaGetDevice(&card);
  if (got != cudaSuccess) return (int)got;
  bool unused = false;
  bool& set = card < kCards ? smem_set[card][form] : unused;
  if (!set) {
    cudaError_t e =
        form == kShared
            ? cudaFuncSetAttribute(confusion_kernel<OutT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemMax)
            : cudaFuncSetAttribute(confusion_global_kernel<OutT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    set = true;
  }
  cudaError_t e = cudaMemsetAsync(
      hist, 0, (size_t)batch * ((size_t)k * k) * sizeof(OutT), stream);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)gx, (unsigned)batch);
  if (form == kShared)
    confusion_kernel<OutT><<<grid, kThreads, smem, stream>>>(
        pred, target, hist, n, k, ignore, copies);
  else
    confusion_global_kernel<OutT><<<grid, kThreads, smem, stream>>>(
        pred, target, hist, n, k, ignore, copies, width);
  return (int)cudaGetLastError();
}

}  // namespace

// hist: (batch, k, k), or (k, k) when sum_batch is non-zero, zeroed here;
// float32 when out_f32 is non-zero (every count below 2^24: the caller
// checks batch * per_image), else int32. pred and target must be 16-byte
// aligned. The launch comes from plan(): form 0 (shared, width = k * k
// ints a copy) or 1 (global, width <= k diagonal ints a copy), `copies`
// copies in shared memory, grid (grid_x, rows).
extern "C" int robseg_confusion(const int64_t* pred, const int64_t* target,
                                void* hist, int64_t batch, int64_t per_image,
                                int k, int64_t ignore, int sum_batch,
                                int out_f32, int form, int copies, int width,
                                int64_t grid_x, void* stream) {
  if ((((uintptr_t)pred) | ((uintptr_t)target)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const bool shape_ok =
      form == kShared ? (int64_t)width == (int64_t)k * k
                      : form == kGlobal && width >= 1 && width <= k;
  if (k < 1 || copies < 1 || grid_x < 1 || grid_x > INT32_MAX || !shape_ok)
    return (int)cudaErrorInvalidValue;
  if (sum_batch) {  // one row of batch * per_image pixels
    per_image *= batch;
    batch = 1;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    return launch(form, pred, target, (float*)hist, batch, per_image, k,
                  ignore, copies, width, grid_x, s);
  return launch(form, pred, target, (int*)hist, batch, per_image, k, ignore,
                copies, width, grid_x, s);
}

// The first design (int32 hist, zeroed by the caller), for chip_smoke.py's
// comparison only.
extern "C" int robseg_confusion_v1(const int64_t* pred,
                                   const int64_t* target, int* hist,
                                   int64_t batch, int64_t per_image, int k,
                                   int64_t ignore, int sum_batch,
                                   void* stream) {
  const int threads = 256;
  const size_t smem = (size_t)k * k * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        confusion_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t per_block = (int64_t)threads * 8;
  int64_t bx = (per_image + per_block - 1) / per_block;
  const int64_t want = (132 * 8 + batch - 1) / batch;
  if (bx > want) bx = want;
  if (bx < 1) bx = 1;
  dim3 grid((unsigned)bx, (unsigned)batch);
  confusion_v1_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      pred, target, hist, per_image, k, ignore, sum_batch);
  return (int)cudaGetLastError();
}
