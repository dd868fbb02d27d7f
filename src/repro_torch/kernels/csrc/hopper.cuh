// Inline-PTX helpers for Hopper (sm_90a) kernels: cp.async with zero-fill,
// the async-proxy fence, the 128-byte shared-memory swizzle, wgmma
// descriptors, the wgmma fence / commit / wait, the wgmma instructions the
// kernels use (bf16 operands, or f16 in the forms the flash kernels and
// block_topk_spmm_wgmma.cu use; float32 accumulators), a fast exp2, and
// mbarriers with bulk copies.
// Used by flash_wgmma.cuh (the flash attention kernels), bsr_spmm_wgmma.cu,
// block_topk_spmm_wgmma.cu, hash_accum.cu and topk_spmm_smem.cu.
//
// Shared-memory tiles use the 128-byte swizzle (SW128): a tile is stored
// as panels of 64 bf16 columns, each row of a panel 128 bytes, rows
// contiguous, and the 16-byte chunk c of row r at chunk position
// c ^ (r % 8).  Panels start on 1024-byte boundaries, so the swizzle is a
// function of the address bits, as wgmma's SW128 mode reads it.  Such a
// panel is the canonical SW128 layout both for a K-major operand (rows =
// M or N, the 64 columns = K; stride between 8-row groups 1024 bytes) and
// for an MN-major one (rows = K, the 64 columns = N), which wgmma reads
// with its transpose bit set.
//
// The wgmma wrappers list their accumulator registers one by one: PTX takes
// them as literal operand lists.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// 4 bytes from global to shared memory, asynchronously (cached in L1);
// src_bytes 0 writes 4 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t dst, uint16_t x) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(dst), "h"(x) : "memory");
}

// Make this thread's shared-memory writes (stores and completed cp.async)
// visible to the async proxy, which wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in an SW128
// panel.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return static_cast<uint32_t>(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// wgmma matrix descriptor of an SW128 operand starting at shared address
// `addr`: lbo and sbo in bytes (the leading and stride byte offsets).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;  // swizzle mode: 128 bytes
}

// Order register accesses before the next wgmma (wgmma.fence).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of wgmma accumulators across the
// asynchronous region.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error about
// 2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// The operand lists of the wgmma wrappers: N accumulator registers.
#define HOPPER_ACC16(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_ACC32(d)                                                      \
  HOPPER_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
      "+f"(d[30]), "+f"(d[31])
#define HOPPER_REGS16                                                        \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS32                                                        \
  HOPPER_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
                "%27, %28, %29, %30, %31"

// The 16-bit operand types of the flash kernels' wgmma forms: bf16
// (__nv_bfloat16) and f16 (__half); f16 x f16 products, as bf16 x bf16
// ones, are exact in float32.
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T: A and B K-major in shared
// memory (descriptors), T operands (bf16 by default, or f16), float32
// accumulators; accumulate 0 overwrites D.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
#define HOPPER_SS64(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               HOPPER_REGS32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"             \
               : HOPPER_ACC32(d)                                            \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  if constexpr (is_f16<T>) HOPPER_SS64("f16"); else HOPPER_SS64("bf16");
#undef HOPPER_SS64
}

// D[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T: A and B K-major in shared
// memory (descriptors), T operands, float32 accumulators; accumulate 0
// overwrites D.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
#define HOPPER_SS32(TY)                                                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
               HOPPER_REGS16 "}, %16, %17, p, 1, 1, 0, 0;\n}\n"             \
               : HOPPER_ACC16(d)                                            \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  if constexpr (is_f16<T>) HOPPER_SS32("f16"); else HOPPER_SS32("bf16");
#undef HOPPER_SS32
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]: A K-major and B MN-major
// (transpose bit set) in shared memory (descriptors; B's two 64-column
// panels lbo bytes apart), T operands (bf16 by default, or f16), float32
// accumulators; accumulate 0 overwrites D.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_m64n128k16_tb(float (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
#define HOPPER_SS128(TY)                                                     \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "         \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "         \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "         \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "         \
      "%60, %61, %62, %63"                                                   \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                    \
      : HOPPER_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),              \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))
  if constexpr (is_f16<T>) HOPPER_SS128("f16"); else HOPPER_SS128("bf16");
#undef HOPPER_SS128
}

// D[64 x 64] += A[64 x 16] . B[16 x 64]: A in registers (the m64k16
// fragment, 4 x 2 T values packed a register a thread), B MN-major in
// shared memory (transpose bit set), T operands (bf16 by default, or f16),
// float32 accumulators in d[0..31].
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
#define HOPPER_RS64(TY)                                                      \
  asm volatile("wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
               HOPPER_REGS32 "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"  \
               : HOPPER_ACC32(d)                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
  if constexpr (is_f16<T>) HOPPER_RS64("f16"); else HOPPER_RS64("bf16");
#undef HOPPER_RS64
}

// D[64 x 32] += A[64 x 16] . B[16 x 32]: A in registers (the m64k16
// fragment), B MN-major in shared memory (transpose bit set), T operands,
// float32 accumulators in d[0..15].
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
#define HOPPER_RS32(TY)                                                      \
  asm volatile("wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
               HOPPER_REGS16 "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"  \
               : HOPPER_ACC16(d)                                            \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b))
  if constexpr (is_f16<T>) HOPPER_RS32("f16"); else HOPPER_RS32("bf16");
#undef HOPPER_RS32
}

// --- mbarriers and bulk copies --------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Make mbarrier.init visible to the async proxy (the only form of the fence
// is cluster-scoped; a block launched alone is a cluster of one).
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive (release, block scope) on this block's barrier.
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Arrive on this block's barrier and add `bytes` to the transactions the
// current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of this block's barrier has
// completed (acquire, block scope: the block's own arrivals and bulk copies
// completed on the barrier).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile("{\n.reg .pred done;\n"
               "WAIT:\n"
               "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
               "@!done bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, 16-byte aligned at both ends) from global to
// this block's shared memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

}  // namespace hopper
