// Hopper (sm_90a) primitives by inline PTX: mbarriers, TMA tensor and bulk
// copies, wgmma shared-memory matrix descriptors, the bf16 m64n128k16,
// m64n64k16, m64n32k16 and m64n16k16 wgmma with both operands in shared
// memory (and m64n128k16, m64n64k16, m64n32k16 with A in registers), its
// fence / commit / wait, the async-proxy fence, named barriers and
// setmaxnreg; and on the host the tensor-map encoder, reached through the
// runtime's driver entry point (so the library needs no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects `bytes` of transactions (TMA copies)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Returns once the barrier's phase `parity` has completed.  A phase that
// never completes (a fault: the waits here last microseconds) traps, so
// the launch ends with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 22)) __trap();
}

// ------------------------------------------------------------------ TMA
// A box of the 4-D tensor map at coordinates (c0 innermost .. c3) into
// shared memory at dst; completes `bar`'s transactions.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// `bytes` (a multiple of 16) contiguous bytes global -> shared, both
// 16-byte aligned; completes `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// --------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor of an operand laid out as TMA's 128-byte
// swizzle writes it: rows of 128 bytes, 8-row groups 1024 bytes apart,
// base 1024-byte aligned.  Both byte offsets are set to the group stride:
// the one the layout does not use (LBO for K-major, the stride between
// 64-column atoms for MN-major where the operand has one atom) is
// ignored; an MN-major operand of two atoms (B3 forward's V at N = 128)
// takes their stride as LBO, desc_lo(addr, lbo).  The high word (SBO, the swizzle mode) is the same for every
// operand; the low word of the operand at shared address addr + off is
// desc_lo(addr) + off / 16 (addresses below 256 KB).
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);
// The high word of an operand in TMA's 64-byte swizzle instead (rows of
// 64 bytes: 32 bf16 columns, 8-row groups 512 bytes apart, base 512-byte
// aligned); the low words are built as above.
constexpr uint32_t kDescHi64 = (512 >> 4) | (2u << 30);
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr) {
  return (addr >> 4) | ((1024 >> 4) << 16);
}
// The same with the leading byte offset set to `lbo`: an MN-major operand
// wider than one 64-column atom (N = 128) whose atoms lie lbo bytes apart.
__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return (addr >> 4) | ((lbo >> 4) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the wgmma's issue or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define HOPPER_D16                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_D32                                                           \
  HOPPER_D16, "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),            \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
      "+f"(d[30]), "+f"(d[31])
#define HOPPER_D64                                                           \
  HOPPER_D32, "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),            \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define HOPPER_D32_LIST                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define HOPPER_D64_LIST                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N fp32, N = 2 x d's length, the wgmma accumulator layout:
// d[4 j + 2 i + e] is row 16 warp + lane / 4 + 8 i, column 8 j +
// 2 (lane % 4) + e) (+)= A B, A (64 x 16) and B (16 x N) bf16 in shared
// memory, given by their descriptors' low words; d is overwritten when
// accumulate == 0.  TB: B is MN-major (1) or K-major (0); A is K-major.
// H (N = 64): both operands' high word, kDescHi64 for operands in the
// 64-byte swizzle.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint32_t a,
                                         uint32_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "mov.b64 da, {%64, %66};\n"
      "mov.b64 db, {%65, %66};\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", da, db, p, 1, 1, 0, %68;\n"
      "}\n"
      : HOPPER_D64
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate), "n"(TB));
}
template <int TB, uint32_t H = kDescHi>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint32_t a,
                                         uint32_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "mov.b64 da, {%32, %34};\n"
      "mov.b64 db, {%33, %34};\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", da, db, p, 1, 1, 0, %36;\n"
      "}\n"
      : HOPPER_D32
      : "r"(a), "r"(b), "r"(H), "r"(accumulate), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint32_t a,
                                         uint32_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "mov.b64 da, {%16, %18};\n"
      "mov.b64 db, {%17, %18};\n"
      "setp.ne.b32 p, %19, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, da, db, p, 1, 1, 0, %20;\n"
      "}\n"
      : HOPPER_D16
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint32_t a,
                                         uint32_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 da, db;\n"
      "mov.b64 da, {%8, %10};\n"
      "mov.b64 db, {%9, %10};\n"
      "setp.ne.b32 p, %11, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, da, db, p, 1, 1, 0, %12;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a), "r"(b), "r"(kDescHi), "r"(accumulate), "n"(TB));
}

// The same with A (64 x 16 bf16) in registers: a[4] is the thread's
// fragment (rows 16 warp + lane / 4 and + 8, columns 2 (lane % 4) + {0, 1}
// and + 8, bf16 pairs), the layout of an accumulator's columns 16 k ..
// 16 k + 15 rounded and packed (pack_a); B in shared memory (H its high
// word at N = 32).
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint32_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "mov.b64 db, {%68, %69};\n"
      "setp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_LIST
      ", {%64, %65, %66, %67}, db, p, 1, 1, %71;\n"
      "}\n"
      : HOPPER_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(accumulate), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint32_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "mov.b64 db, {%36, %37};\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_LIST
      ", {%32, %33, %34, %35}, db, p, 1, 1, %39;\n"
      "}\n"
      : HOPPER_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(kDescHi),
        "r"(accumulate), "n"(TB));
}

template <int TB, uint32_t H = kDescHi>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint32_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b64 db;\n"
      "mov.b64 db, {%20, %21};\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, db, p, 1, 1, %23;\n"
      "}\n"
      : HOPPER_D16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(H),
        "r"(accumulate), "n"(TB));
}

#undef HOPPER_D16
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_D32_LIST
#undef HOPPER_D64_LIST

// Makes the calling thread's shared-memory stores visible to the async
// proxy (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Named barrier `id` (1-15; 0 is __syncthreads') over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Moves registers between warpgroups: the producer gives, consumers take.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- host
// cuTensorMapEncodeTiled, looked up once through the runtime (null if
// the driver has none)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The tensor map of a bf16 tensor (B, H, S, D) read by element strides
// st = (B, H, S) with D contiguous, as 4-D (D, S, H, B): boxes of 64
// columns x `rows` positions of one (b, h), 128-byte swizzled, zeros
// outside the tensor (columns past D included); with cols == 32, boxes of
// 32 columns in the 64-byte swizzle.  False if the driver refuses it (a
// base or stride off 16 bytes).
inline bool bf16_map(CUtensorMap* map, const void* base, int B, int H, int S,
                     int D, const long long* st, int rows, int cols = 64) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                           static_cast<cuuint64_t>(st[1]) * 2,
                           static_cast<cuuint64_t>(st[0]) * 2};
  for (int i = 0; i < 3; ++i)   // an axis of extent 1 is never stepped
    if (dims[i + 1] == 1) strides[i] = static_cast<cuuint64_t>(D) * 2;
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
