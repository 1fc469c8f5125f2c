// Hopper building blocks shared by the TMA + wgmma kernels (fpn_conv.cu,
// convnext_block.cu): loads and stores of float32 or bf16 activations,
// mbarriers, TMA loads, shared-memory matrix descriptors, warpgroup matrix
// multiplies, and the host-side encoding of TMA tensor maps. Every helper has internal linkage, so each translation
// unit that includes this header gets its own copy.
//
// Conventions, as the kernels use them:
// - A shared-memory tile is rows of 64 bf16 (128 bytes) under the 128-byte
//   swizzle, K-major, 8-row groups 1024 bytes apart, its base 1024-byte
//   aligned; TMA writes exactly this layout for a {64, rows} box of a map
//   encoded with CU_TENSOR_MAP_SWIZZLE_128B.
// - wgmma_ss<N> (N = 64, 128, 256) is d (+)= A (64 x 16, shared) . B
//   (N x 16, shared)^T; wgmma_rs<N> (N = 96, 128, 192) the same with A in
//   registers, four bf16 pairs a thread in the layout of a wgmma
//   accumulator's k16 slice (see fused_consumer in convnext_mlp.cuh).
// - The TF32 kind: a tile is rows of 32 floats (128 bytes) under the same
//   swizzle, so a k8 step is 32 bytes as a bf16 k16 step is and smem_desc
//   serves both. wgmma_rs_tf32<N> (N = 96, 128) is d (+)= A (64 x 8) . B
//   (N x 8)^T with A from registers, four tf32 a thread: warp w, lane l
//   holds rows 16 w + l / 4 + {0, 8} and columns l % 4 + {0, 4}, a[0..3]
//   = (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4). The tensor core
//   reads the top 19 bits of each operand and ignores the other 13.
// - Accumulator layout (m64nN, f32): thread t of the warpgroup, warp w =
//   t / 32, lane l, holds rows 16 w + l / 4 + 8 hh (hh = 0, 1) and columns
//   8 j + 2 (l % 4) + {0, 1} (j < N / 8) in d[4 j + 2 hh + {0, 1}].

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Loads and stores of activations that are float32 or bf16 in memory and
// float32 in registers (the kernels' I/O type): a bf16 value converts
// exactly; a store rounds to nearest even, as torch's .to(torch.bfloat16)
// does.
__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(v[0]), b = __bfloat1622float2(v[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits for the completion of the phase with this parity. A wait that
// never ends (a broken pipeline) traps after ~2^26 polls, so it becomes a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// wgmma descriptor of a K-major tile in shared memory under the 128-byte
// swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart.
// Advancing K by 16 elements adds 32 bytes (2 in the address field).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A (64 x 16, K-major, shared) . B (N x 16, K-major, shared)^T;
// scale_d = 0 overwrites d
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);
// the same with A (64 x 16) in registers: four bf16 pairs a thread
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80), D8(88), D8(96), D8(104), D8(112), D8(120)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %53, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %101, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72), D8(80), D8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (+)= A (64 x 8 tf32, registers: four a thread) . B (N x 8 tf32,
// K-major, shared)^T
template <int N>
__device__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                              uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs_tf32<96>(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %53, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs_tf32<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n\t}"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

#undef D8

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// A dense bf16 (or float32) tensor (dims innermost first) under the
// 128-byte swizzle, zero fill outside it. Returns 0, or -(CUresult)
// (-1000: no entry point).
int encode(CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, const cuuint32_t* box,
           CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1000;
  cuuint64_t strides[4];
  cuuint64_t st =
      dims[0] * (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2);
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = st;
    st *= dims[i];
  }
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, type, (cuuint32_t)rank, const_cast<void*>(ptr),
                        dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

}  // namespace
