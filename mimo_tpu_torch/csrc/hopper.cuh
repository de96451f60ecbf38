// Hopper (sm_90a) helpers shared by the kernels on mbarrier rings
// (gemm.cu, flash_body.cuh, temporal_attention.cu): shared-memory
// addresses, mbarriers, TMA tensor and bulk copies, wgmma descriptors,
// fences and products, and cuTensorMapEncodeTiled fetched through the
// runtime.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of parity `parity`; a wait
// of 2^35 cycles (~17 s) is a lost arrival, not a slow load: trap, so the
// launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA: the (c0 = column, c1 = row) box of `map` into shared memory at dst;
// completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// the same for a 4-D map, coordinates from the innermost dimension out
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// TMA bulk copy (no tensor map): `bytes` contiguous bytes, a multiple of
// 16, from global src to shared dst, both 16-byte aligned; completion is
// counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// TMA (async-proxy) accesses to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 bytes in 8-row atoms of 1024 bytes (SBO), the
// leading offset unused by this layout, start address in 16-byte units.
// Adding 2 moves the start 32 bytes (16 bf16) along K inside the atom.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// The same swizzle read MN-major (N contiguous, for the transpose bit): a
// row of 128 bytes is 64 N values of one K, 8 K rows make a 1024-byte atom
// (SBO, the step between 8-deep K groups), and the next 64 N values sit
// `lbo` bytes further on (LBO).
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p, uint32_t lbo) {
  return ((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) | (uint64_t(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int D>
__device__ __forceinline__ void fence_acc(float (&d)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Operands of an m64nN wgmma's fp32 accumulator d[0 .. N/2): MIMO_WG_R<N>
// names them ("%0, ..., %(N/2 - 1)"), MIMO_WG_D<N> binds them (read and
// written). For the register-A form, MIMO_WG_A<N> names the four A
// registers and the B descriptor that follow, MIMO_WG_S<N> the scale-d flag.
#define MIMO_WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MIMO_WG_R8 "%0, %1, %2, %3"
#define MIMO_WG_D8 MIMO_WG_F4(0)
#define MIMO_WG_R16 MIMO_WG_R8 ", %4, %5, %6, %7"
#define MIMO_WG_D16 MIMO_WG_D8, MIMO_WG_F4(4)
#define MIMO_WG_R24 MIMO_WG_R16 ", %8, %9, %10, %11"
#define MIMO_WG_D24 MIMO_WG_D16, MIMO_WG_F4(8)
#define MIMO_WG_R32 MIMO_WG_R24 ", %12, %13, %14, %15"
#define MIMO_WG_D32 MIMO_WG_D24, MIMO_WG_F4(12)
#define MIMO_WG_R40 MIMO_WG_R32 ", %16, %17, %18, %19"
#define MIMO_WG_D40 MIMO_WG_D32, MIMO_WG_F4(16)
#define MIMO_WG_R48 MIMO_WG_R40 ", %20, %21, %22, %23"
#define MIMO_WG_D48 MIMO_WG_D40, MIMO_WG_F4(20)
#define MIMO_WG_R56 MIMO_WG_R48 ", %24, %25, %26, %27"
#define MIMO_WG_D56 MIMO_WG_D48, MIMO_WG_F4(24)
#define MIMO_WG_R64 MIMO_WG_R56 ", %28, %29, %30, %31"
#define MIMO_WG_D64 MIMO_WG_D56, MIMO_WG_F4(28)
#define MIMO_WG_R72 MIMO_WG_R64 ", %32, %33, %34, %35"
#define MIMO_WG_D72 MIMO_WG_D64, MIMO_WG_F4(32)
#define MIMO_WG_R80 MIMO_WG_R72 ", %36, %37, %38, %39"
#define MIMO_WG_D80 MIMO_WG_D72, MIMO_WG_F4(36)
#define MIMO_WG_R88 MIMO_WG_R80 ", %40, %41, %42, %43"
#define MIMO_WG_D88 MIMO_WG_D80, MIMO_WG_F4(40)
#define MIMO_WG_R96 MIMO_WG_R88 ", %44, %45, %46, %47"
#define MIMO_WG_D96 MIMO_WG_D88, MIMO_WG_F4(44)
#define MIMO_WG_R104 MIMO_WG_R96 ", %48, %49, %50, %51"
#define MIMO_WG_D104 MIMO_WG_D96, MIMO_WG_F4(48)
#define MIMO_WG_R112 MIMO_WG_R104 ", %52, %53, %54, %55"
#define MIMO_WG_D112 MIMO_WG_D104, MIMO_WG_F4(52)
#define MIMO_WG_R120 MIMO_WG_R112 ", %56, %57, %58, %59"
#define MIMO_WG_D120 MIMO_WG_D112, MIMO_WG_F4(56)
#define MIMO_WG_R128 MIMO_WG_R120 ", %60, %61, %62, %63"
#define MIMO_WG_D128 MIMO_WG_D120, MIMO_WG_F4(60)
#define MIMO_WG_R136 MIMO_WG_R128 ", %64, %65, %66, %67"
#define MIMO_WG_D136 MIMO_WG_D128, MIMO_WG_F4(64)
#define MIMO_WG_R144 MIMO_WG_R136 ", %68, %69, %70, %71"
#define MIMO_WG_D144 MIMO_WG_D136, MIMO_WG_F4(68)
#define MIMO_WG_R152 MIMO_WG_R144 ", %72, %73, %74, %75"
#define MIMO_WG_D152 MIMO_WG_D144, MIMO_WG_F4(72)
#define MIMO_WG_R160 MIMO_WG_R152 ", %76, %77, %78, %79"
#define MIMO_WG_D160 MIMO_WG_D152, MIMO_WG_F4(76)
#define MIMO_WG_A8 "{%4, %5, %6, %7}, %8"
#define MIMO_WG_S8 "%9"
#define MIMO_WG_A16 "{%8, %9, %10, %11}, %12"
#define MIMO_WG_S16 "%13"
#define MIMO_WG_A24 "{%12, %13, %14, %15}, %16"
#define MIMO_WG_S24 "%17"
#define MIMO_WG_A32 "{%16, %17, %18, %19}, %20"
#define MIMO_WG_S32 "%21"
#define MIMO_WG_A40 "{%20, %21, %22, %23}, %24"
#define MIMO_WG_S40 "%25"
#define MIMO_WG_A48 "{%24, %25, %26, %27}, %28"
#define MIMO_WG_S48 "%29"
#define MIMO_WG_A56 "{%28, %29, %30, %31}, %32"
#define MIMO_WG_S56 "%33"
#define MIMO_WG_A64 "{%32, %33, %34, %35}, %36"
#define MIMO_WG_S64 "%37"
#define MIMO_WG_A72 "{%36, %37, %38, %39}, %40"
#define MIMO_WG_S72 "%41"
#define MIMO_WG_A80 "{%40, %41, %42, %43}, %44"
#define MIMO_WG_S80 "%45"
#define MIMO_WG_A88 "{%44, %45, %46, %47}, %48"
#define MIMO_WG_S88 "%49"
#define MIMO_WG_A96 "{%48, %49, %50, %51}, %52"
#define MIMO_WG_S96 "%53"
#define MIMO_WG_A104 "{%52, %53, %54, %55}, %56"
#define MIMO_WG_S104 "%57"
#define MIMO_WG_A112 "{%56, %57, %58, %59}, %60"
#define MIMO_WG_S112 "%61"
#define MIMO_WG_A120 "{%60, %61, %62, %63}, %64"
#define MIMO_WG_S120 "%65"
#define MIMO_WG_A128 "{%64, %65, %66, %67}, %68"
#define MIMO_WG_S128 "%69"
#define MIMO_WG_A136 "{%68, %69, %70, %71}, %72"
#define MIMO_WG_S136 "%73"
#define MIMO_WG_A144 "{%72, %73, %74, %75}, %76"
#define MIMO_WG_S144 "%77"
#define MIMO_WG_A152 "{%76, %77, %78, %79}, %80"
#define MIMO_WG_S152 "%81"
#define MIMO_WG_A160 "{%80, %81, %82, %83}, %84"
#define MIMO_WG_S160 "%85"

// D (64 x N, fp32) (+)= A (64 x 16) . B (16 x N), both from shared memory,
// K-major (descriptors da, db); scale_d == 0 overwrites D. DESCS and SCALE
// name the operands that follow the accumulators.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);

#define MIMO_WGMMA_SS(N, DESCS, SCALE)                                      \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<N>(                              \
      float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 MIMO_WG_R##N "}, " DESCS ", p, 1, 1, 0, 0;\n}\n"          \
                 : MIMO_WG_D##N : "l"(da), "l"(db), "r"(scale_d));          \
  }
MIMO_WGMMA_SS(32, "%16, %17", "%18")
MIMO_WGMMA_SS(64, "%32, %33", "%34")
MIMO_WGMMA_SS(128, "%64, %65", "%66")
MIMO_WGMMA_SS(160, "%80, %81", "%82")
#undef MIMO_WGMMA_SS

// The same with both operands MN-major (the transpose bits): A (64 x 16) as
// 16 K rows of 64 M values, B (16 x N) as 16 K rows of N values
// (descriptors from smem_desc_mn).
template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d);

#define MIMO_WGMMA_SS_T(N, DESCS, SCALE)                                    \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss_t<N>(                            \
      float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {           \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SCALE ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 MIMO_WG_R##N "}, " DESCS ", p, 1, 1, 1, 1;\n}\n"          \
                 : MIMO_WG_D##N : "l"(da), "l"(db), "r"(scale_d));          \
  }
MIMO_WGMMA_SS_T(32, "%16, %17", "%18")
MIMO_WGMMA_SS_T(64, "%32, %33", "%34")
MIMO_WGMMA_SS_T(128, "%64, %65", "%66")
#undef MIMO_WGMMA_SS_T

// D (64 x N, fp32) += A (64 x 16, bf16 from registers: each warp's 16 rows
// in the m16n8k16 A-fragment layout) . B (16 x N) from shared memory,
// MN-major (the transpose bit; descriptor db)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

#define MIMO_WGMMA_RS(N)                                                    \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs<N>(                              \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " MIMO_WG_S##N ", 0;\n"  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 MIMO_WG_R##N "}, " MIMO_WG_A##N ", p, 1, 1, 1;\n}\n"       \
                 : MIMO_WG_D##N                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                   "r"(1));                                                 \
  }
MIMO_WGMMA_RS(8) MIMO_WGMMA_RS(16) MIMO_WGMMA_RS(24) MIMO_WGMMA_RS(32)
MIMO_WGMMA_RS(40) MIMO_WGMMA_RS(48) MIMO_WGMMA_RS(56) MIMO_WGMMA_RS(64)
MIMO_WGMMA_RS(72) MIMO_WGMMA_RS(80) MIMO_WGMMA_RS(88) MIMO_WGMMA_RS(96)
MIMO_WGMMA_RS(104) MIMO_WGMMA_RS(112) MIMO_WGMMA_RS(120) MIMO_WGMMA_RS(128)
MIMO_WGMMA_RS(136) MIMO_WGMMA_RS(144) MIMO_WGMMA_RS(152) MIMO_WGMMA_RS(160)
// the widest products (flash_wide.cu's P.V over 192 or 256 columns of O
// at once): the accumulators of m64n168 ... m64n256, then the A
// registers, B descriptor and scale-d flag after them
#define MIMO_WG_R168 MIMO_WG_R160 ", %80, %81, %82, %83"
#define MIMO_WG_D168 MIMO_WG_D160, MIMO_WG_F4(80)
#define MIMO_WG_R176 MIMO_WG_R168 ", %84, %85, %86, %87"
#define MIMO_WG_D176 MIMO_WG_D168, MIMO_WG_F4(84)
#define MIMO_WG_R184 MIMO_WG_R176 ", %88, %89, %90, %91"
#define MIMO_WG_D184 MIMO_WG_D176, MIMO_WG_F4(88)
#define MIMO_WG_R192 MIMO_WG_R184 ", %92, %93, %94, %95"
#define MIMO_WG_D192 MIMO_WG_D184, MIMO_WG_F4(92)
#define MIMO_WG_R200 MIMO_WG_R192 ", %96, %97, %98, %99"
#define MIMO_WG_D200 MIMO_WG_D192, MIMO_WG_F4(96)
#define MIMO_WG_R208 MIMO_WG_R200 ", %100, %101, %102, %103"
#define MIMO_WG_D208 MIMO_WG_D200, MIMO_WG_F4(100)
#define MIMO_WG_R216 MIMO_WG_R208 ", %104, %105, %106, %107"
#define MIMO_WG_D216 MIMO_WG_D208, MIMO_WG_F4(104)
#define MIMO_WG_R224 MIMO_WG_R216 ", %108, %109, %110, %111"
#define MIMO_WG_D224 MIMO_WG_D216, MIMO_WG_F4(108)
#define MIMO_WG_R232 MIMO_WG_R224 ", %112, %113, %114, %115"
#define MIMO_WG_D232 MIMO_WG_D224, MIMO_WG_F4(112)
#define MIMO_WG_R240 MIMO_WG_R232 ", %116, %117, %118, %119"
#define MIMO_WG_D240 MIMO_WG_D232, MIMO_WG_F4(116)
#define MIMO_WG_R248 MIMO_WG_R240 ", %120, %121, %122, %123"
#define MIMO_WG_D248 MIMO_WG_D240, MIMO_WG_F4(120)
#define MIMO_WG_R256 MIMO_WG_R248 ", %124, %125, %126, %127"
#define MIMO_WG_D256 MIMO_WG_D248, MIMO_WG_F4(124)
#define MIMO_WG_A192 "{%96, %97, %98, %99}, %100"
#define MIMO_WG_S192 "%101"
#define MIMO_WG_A256 "{%128, %129, %130, %131}, %132"
#define MIMO_WG_S256 "%133"
MIMO_WGMMA_RS(192) MIMO_WGMMA_RS(256)
#undef MIMO_WGMMA_RS

// The same with B K-major (no transpose bit): N rows of 16 K values
// (descriptor from smem_desc)
template <int N>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t db);

#define MIMO_WGMMA_RS_K(N)                                                  \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs_k<N>(                            \
      float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {             \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " MIMO_WG_S##N ", 0;\n"  \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" \
                 MIMO_WG_R##N "}, " MIMO_WG_A##N ", p, 1, 1, 0;\n}\n"       \
                 : MIMO_WG_D##N                                             \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),     \
                   "r"(1));                                                 \
  }
MIMO_WGMMA_RS_K(40) MIMO_WGMMA_RS_K(80)
#undef MIMO_WGMMA_RS_K

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda entry point, fetched through the
// runtime so the library needs no link against libcuda (inline: a source
// that includes this header without TMA maps does not reference it)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace
