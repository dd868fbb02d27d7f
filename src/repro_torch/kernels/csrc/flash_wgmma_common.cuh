// Device code that K7's tensor-core kernels share: the forward
// (flash_wgmma.cuh) and the backward (flash_bwd_wgmma.cuh), each built for
// bf16 and f16 operands in translation units of their own
// (flash_attention_wgmma*.cu, flash_attention_bwd_wgmma*.cu), so that no
// one nvcc process compiles every instantiation.
//
// A block is two warpgroups (kWG) of 128 threads, owning kRows = 128 rows
// (queries, or the backward's keys), 64 a warpgroup.  Tiles are SW128
// panels of 64 16-bit columns (hopper.cuh): a DP-wide tile is ceil(DP / 64)
// panels, the last one panel_cols<DP> wide.  The 16-bit element type T is
// __nv_bfloat16 or __half; the kernels read and write it, compute in
// float32, and pass operands to the tensor cores as T.  A float32 value x
// goes to a register A operand as NT terms of T, t1 = T(x), t2 = T(x - t1),
// ...: NT bf16 terms keep 8 NT bits of x, NT f16 terms 11 NT bits, as long
// as x lies in f16's range (P is scaled by kF16PScale first; see
// flash_wgmma.cuh and flash_bwd_wgmma.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "hopper.cuh"

// Internal linkage (the unnamed namespace): each translation unit keeps
// its own instantiations.
namespace k7wg {
namespace {

using hopper::sw128;
using hopper::sw128_desc;

constexpr int kWG = 2;          // warpgroups per block
constexpr int kThreads = 256;   // 128 * kWG
constexpr int kRows = 128;      // rows a block owns, 64 a warpgroup
static_assert(kThreads == 128 * kWG && kRows == 64 * kWG, "warpgroups");
// f16's P scale: p <= 1 is carried as p * 2^15 <= 32768 < 65504, so that
// its terms stay normal f16 numbers down to p = 2^-29 (and its bf16
// rounding under p_dtype is exact in f16 down to 2^-32); the sums are
// scaled back by the same power of two, exactly
constexpr int kF16PScaleLog2 = 15;
constexpr float kF16PScale = (float)(1 << kF16PScaleLog2);
// f16's dS scale: dS is carried as dS * 2^e, one power of two a bh, with e
// such that its bound 2 max_i |dO_i| max_j |V_j| (|dP_ij| <= |dO_i| |V_j|
// and |Delta_i| <= |dO_i| max_j |V_j|, P <= 1) times 2^e lies below
// 2^kF16DsLog2 < 65,504: no term overflows, and a dS down to 2^-28 of the
// bound keeps normal f16 terms; dK and dQ are scaled back with the score
// scale, exactly (flash_bwd_wgmma.cuh)
constexpr int kF16DsLog2 = 14;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;

// Columns of panel p of a DP-wide tile.
template <int DP>
__device__ constexpr int panel_cols(int p) {
  return (p + 1) * 64 <= DP ? 64 : DP - 64 * p;
}

// Keep the compiler from moving accesses of the accumulator values a
// DP-wide tile uses across a wgmma region.
template <int DP, int NP>
__device__ __forceinline__ void fence_acc(float (&acc)[NP][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < panel_cols<DP>(p) / 2)
        asm volatile("" : "+f"(acc[p][i]) :: "memory");
}

// Rows [r0, r0 + rows) of an (s_len x width) matrix of 16-bit values whose
// rows are `ld` elements apart, into the DP-wide SW128 tile at shared
// address `tile` (panels `rows` x 128 bytes apart): zeros past s_len and
// past width.  vec: whole 16-byte chunks by cp.async (width and ld
// multiples of 8, 16-byte aligned rows); else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t tile, const void* src,
                                          int r0, int rows, int s_len,
                                          int width, int ld, bool vec) {
  const uint32_t panel = rows * 128;
  const uint16_t* bits = static_cast<const uint16_t*>(src);
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const int row = r0 + r;
      const bool ok = row < s_len && ch * 8 < width;
      hopper::cp_async_16(tile + (ch >> 3) * panel + sw128(r, ch & 7),
                          ok ? bits + (long long)row * ld + ch * 8 : bits,
                          ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const int row = r0 + r;
      hopper::st_shared_u16(
          tile + (c >> 6) * panel + sw128(r, (c >> 3) & 7) + (c & 7) * 2,
          row < s_len && c < width ? bits[(long long)row * ld + c] : 0);
    }
  }
}

// p_dtype's V in the f16 kernels: each value rounded to bf16, as the
// reference rounds it, and halved, f16(bf16(v) / 2), so that a value that
// rounds up to 2^16 stays in f16's range (an f16 number for |v| >= 2^-13,
// within 2^-25 below); the kernels double their sums back.  In place in a
// DP-wide tile of `rows` rows that load_tile filled: each thread rounds the
// elements it copied, once its copies have landed (before the fence that
// hands the tile to the async proxy).
__device__ __forceinline__ uint32_t bf16_half2(uint32_t bits) {
  float2 f = __half22float2(*reinterpret_cast<const __half2*>(&bits));
  const __half2 r = __floats2half2_rn(dtypes::round_bf16(f.x) * 0.5f,
                                      dtypes::round_bf16(f.y) * 0.5f);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int DP>
__device__ __forceinline__ void round_tile_bf16_half(uint32_t tile, int rows,
                                                     bool vec) {
  const uint32_t panel = rows * 128;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const uint32_t a = tile + (ch >> 3) * panel + sw128(r, ch & 7);
      uint32_t x0, x1, x2, x3;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x0), "=r"(x1), "=r"(x2), "=r"(x3) : "r"(a)
                   : "memory");
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(a), "r"(bf16_half2(x0)), "r"(bf16_half2(x1)),
                      "r"(bf16_half2(x2)), "r"(bf16_half2(x3))
                   : "memory");
    }
  } else {
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const uint32_t a =
          tile + (c >> 6) * panel + sw128(r, (c >> 3) & 7) + (c & 7) * 2;
      uint16_t x;
      asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(x) : "r"(a)
                   : "memory");
      const __half h = __float2half_rn(
          dtypes::round_bf16(__half2float(__ushort_as_half(x))) * 0.5f);
      hopper::st_shared_u16(a, __half_as_ushort(h));
    }
  }
}

// Two float32 values as a packed pair of T (round to nearest even) and
// the pair's values back in float32.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float a, float b,
                                          float2& back) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);
  back = __bfloat1622float2(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}
__device__ __forceinline__ uint32_t pack2(__half, float a, float b,
                                          float2& back) {
  const __half2 t = __floats2half2_rn(a, b);
  back = __half22float2(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// Values u and w (rows r and r + 8 of an A fragment's register r) as NT
// terms of T into a[0 .. NT)[r]: each term the rounding of what the terms
// before it left (exact: a term is within half a step of what it rounds).
template <typename T, int NT>
__device__ __forceinline__ void split_pair(float u, float w,
                                           uint32_t (&a)[NT][4], int r) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float2 back;
    a[t][r] = pack2(T(), u, w, back);
    u -= back.x;
    w -= back.y;
  }
}

// Delta[r] = sum_c do[r][c] * o[r][c] in float32, one warp a row (lanes
// over the columns, then a butterfly sum: one order on every run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32)
    s = fmaf(dtypes::to_f(dout[row * dv + c]), dtypes::to_f(o[row * dv + c]),
             s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// f16's dS scale's inputs (kF16DsLog2): the largest squared norm of a row
// of dout (bh, sq, dv) and of v (bh, sk, dv) in each bh, into stats[2 bh]
// and stats[2 bh + 1] (zeroed beforehand).  Block x = bh * kStatBlocks +
// part of grid (.., 1, 2), z choosing dout or v: its warps take every
// (kStatBlocks * 8)-th row from part * 8 + warp, and one atomicMax a block
// on the maximum's bits (non-negative floats order as their bits; a
// maximum is the same in any order).
constexpr int kStatBlocks = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
ds_stats_kernel(const T* __restrict__ dout, const T* __restrict__ v,
                float* __restrict__ stats, int sq, int sk, int dv) {
  __shared__ float warp_max[kThreads / 32];
  const int which = blockIdx.z;  // 0: dout's rows, 1: v's
  const long long bh = blockIdx.x / kStatBlocks;
  const int part = (int)(blockIdx.x % kStatBlocks);
  const int rows = which ? sk : sq;
  const T* base = (which ? v : dout) + bh * (long long)rows * dv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float m = 0.0f;
  for (int r = part * (kThreads / 32) + warp; r < rows;
       r += kStatBlocks * (kThreads / 32)) {
    float ss = 0.0f;
    for (int c = lane; c < dv; c += 32) {
      const float x = dtypes::to_f(base[(long long)r * dv + c]);
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    m = fmaxf(m, ss);
  }
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) b = fmaxf(b, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(stats + 2 * bh + which),
              __float_as_int(b));
  }
}

// The 16-bit type a dtype code names (ops.DTYPE_CODES: 1 bfloat16, 2
// float16), for the entry points' switches.
constexpr int kCodeBF16 = 1;
constexpr int kCodeF16 = 2;

}  // namespace
}  // namespace k7wg
