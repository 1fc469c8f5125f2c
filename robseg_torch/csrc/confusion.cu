// Confusion-matrix histogram, per image or summed over the batch.
//
// Replaces: robseg_tpu/kernels/confusion.py::confusion_matrix_pallas
// (_conf_kernel), which accumulates hist[t, p] with one-hot matmuls in
// VMEM over a sequential grid.
//
// Bound on the H100: memory. Each pixel is two int64 loads (16 bytes) and
// at most one increment. The TPU builds one-hots because its matrix unit
// is the fast path; here the fast path is an integer atomic in shared
// memory. Integer atomics commute, so the result is exact and independent
// of order.
//
// Design (confusion_kernel):
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
//    take 32), two a SM, and a grid of twice the SM count (split over the
//    images when per image): few blocks, so few histogram flushes (only
//    non-zero bins reach global memory).
//  - The output is float32 when every count stays below 2^24 (exact, and
//    no conversion pass afterwards), else int32.
//
// A pixel counts when t != ignore, 0 <= t < K and 0 <= p < K: a p out of
// range adds nothing, as the JAX one-hot gives it a zero row.
//
// confusion_v1_kernel is this kernel's first design (one shared atomic a
// pixel, scalar loads, 256-thread blocks, one histogram copy), kept as the
// yardstick chip_smoke.py times the redesign against; the package does
// not call it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                   // pixels a thread takes at once
constexpr int kSmemTwoBlocks = 113 * 1024;  // two blocks fit on an SM
constexpr int kSmemMax = 227 * 1024;

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
int launch(const int64_t* pred, const int64_t* target, OutT* hist,
           int64_t batch, int64_t n, int k, int64_t ignore,
           cudaStream_t stream) {
  const int kk = k * k;
  int copies = kSmemTwoBlocks / (kk * (int)sizeof(int));
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  const size_t smem = (size_t)copies * kk * sizeof(int);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  // host work once a process: the largest dynamic shared memory asked for
  // so far, and the SM count (one card)
  static size_t smem_set = 0;
  static int sms = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        confusion_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    smem_set = kSmemMax;
  }
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  cudaError_t e = cudaMemsetAsync(hist, 0, (size_t)batch * kk * sizeof(OutT),
                                  stream);
  if (e != cudaSuccess) return (int)e;
  const int per_sm = smem <= (size_t)kSmemTwoBlocks ? 2 : 1;
  // the card's resident blocks, split over the rows, and no block with
  // less than one group a thread
  int64_t gx = (int64_t)sms * per_sm / batch;
  const int64_t need = (n / kRun + kThreads - 1) / kThreads;
  if (gx > need) gx = need;
  if (gx < 1) gx = 1;
  dim3 grid((unsigned)gx, (unsigned)batch);
  confusion_kernel<OutT><<<grid, kThreads, smem, stream>>>(
      pred, target, hist, n, k, ignore, copies);
  return (int)cudaGetLastError();
}

}  // namespace

// hist: (batch, k, k), or (k, k) when sum_batch is non-zero, zeroed here;
// float32 when out_f32 is non-zero (every count below 2^24: the caller
// checks batch * per_image), else int32. pred and target must be 16-byte
// aligned.
extern "C" int robseg_confusion(const int64_t* pred, const int64_t* target,
                                void* hist, int64_t batch, int64_t per_image,
                                int k, int64_t ignore, int sum_batch,
                                int out_f32, void* stream) {
  if ((((uintptr_t)pred) | ((uintptr_t)target)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (sum_batch) {  // one row of batch * per_image pixels
    per_image *= batch;
    batch = 1;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (out_f32)
    return launch(pred, target, (float*)hist, batch, per_image, k, ignore,
                  s);
  return launch(pred, target, (int*)hist, batch, per_image, k, ignore, s);
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
