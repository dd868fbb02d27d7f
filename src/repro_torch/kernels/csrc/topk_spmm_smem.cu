// The per-token form of the paper's Eq. (1) down-projection with W2 held in
// shared memory: the "smem" route of ops.topk_spmm (W2 of at most kMaxSmem
// bytes' worth of rows; other calls take topk_spmm.cu, the "l2" route).
//   y[i, :] = sum over t < k of vals[i, t] * W2[clip(idx[i, t]), :]
// in float32, float32 or bfloat16 inputs.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_spmm.py:40 (topk_spmm;
// body _token_kernel: grid (tokens, k), each step DMAs the W2 row named by
// the prefetched id and adds vals[i, t] * row into the token's output row).
// Each product is rounded on its own (__fmul_rn) and added (__fadd_rn) in t
// order from 0.0f, as the reference's steps do, so every output is the same
// sum in the same order and rounding as topk_spmm_plain's and the "l2"
// kernel's: the three agree bit for bit.  (No FMA: a bf16 product is exact
// in float32 only where it does not underflow.)
//
// What bounds it on an H100: bytes, 0.026 ms at the FFN path's shape (the
// pairs, the W2 rows they name once, y in float32).  The "l2" kernel gives
// each token a block and reads the token's W2 rows through L2, 12.9 GB at
// that shape, though every W2 row is named by ~256 tokens.  Here the same
// 12.9 GB are read from shared memory instead.
//
// Design: a block owns one column slice of W2, kSliceBytes wide (8 bf16 or
// 4 float32 columns), for all d_ff rows: 128 KB at d_ff 8,192, staged once
// by cp.async, so W2 leaves L2 once (384 slices x 128 KB = 50 MB).  The
// block then walks the tokens kThreads at a time, one consumer thread a
// token: for each of its (id, value) pairs in t order it loads the slice's
// row id (one 16-byte shared load) and adds value * w into its 8 (or 4)
// float32 accumulators.
//   * The pairs reach the blocks as one stream: pack_pairs_kernel (launched
//     first) writes (clip(id), value) t-major within groups of kThreads
//     tokens, pairs[group][t][token], 4 bytes for bf16 (id | bits << 16;
//     the route's d_ff fits 16 bits) and 8 for float32, padded with zero
//     pairs to whole groups (never stored).  A warp's 32 tokens then read
//     32 consecutive pairs: no bank conflict.
//   * A producer warp streams chunks of kStageBytes (kChunkT steps of t for
//     the group's tokens, fewer at the end of k) into kStages buffers with
//     bulk copies completed on mbarriers.  Each consumer warp releases a
//     buffer on its own with a local arrive (no block-wide barrier, so the
//     warps drift apart and one warp's shared loads overlap another's
//     arithmetic: with a barrier a chunk the kernel took 2.4 ms at the FFN
//     shape); the producer refills the buffer once all have.
//   * Every block reads the whole pair stream (8.4 MB a block, 3.2 GB from
//     L2 at the FFN shape).  Multicasting each chunk to the blocks of a
//     thread-block cluster cuts those reads, but on an H100 it was slower:
//     each chunk then waits for the cluster's slowest block (PERF.md).
//   * What binds it: shared-memory bandwidth.  The rows a warp names fall
//     on the same banks at random, so a warp's 16-byte row loads take ~7.5
//     wavefronts in place of 4; with the pair loads and the bulk copies'
//     writes that is ~9.5 a warp-step.  Rows chosen conflict-free, the
//     kernel takes 1.03 ms against 1.24; without its arithmetic, no less
//     than with it (tools/k5_variants.py).
//   * Tails: the last slice's columns past d are zero-filled and not stored
//     (rows of W2 that are not whole 16-byte slices are staged element by
//     element); a chunk past k's end is shorter; tokens past n are zero
//     pairs whose sums are not stored.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;       // consumer threads a block: one token each
constexpr int kSliceBytes = 16;     // the W2 columns a block owns, in bytes
constexpr int kStages = 4;          // pair-chunk buffers
constexpr int kStageBytes = 16384;  // bytes of one buffer
constexpr int kBarrierBytes = 128;  // the buffers' mbarriers
constexpr int kMaxSmem = 232448;    // shared memory a block may use
constexpr int kPackTile = 32;       // the pre-pass's tile: tokens x t

// The packed (id, value) pair of a W2 element type: bf16 bits (uint16_t)
// pack into one word, float32 bits (uint32_t) into two.
template <typename Raw> struct PairOf;
template <> struct PairOf<uint16_t> { using type = uint32_t; };
template <> struct PairOf<uint32_t> { using type = uint2; };

__device__ __forceinline__ uint32_t pack_pair(uint16_t v, int id) {
  return (static_cast<uint32_t>(v) << 16) | static_cast<uint32_t>(id);
}
__device__ __forceinline__ uint2 pack_pair(uint32_t v, int id) {
  return make_uint2(static_cast<uint32_t>(id), v);
}

__device__ __forceinline__ uint32_t pair_id(uint32_t p) { return p & 0xFFFFu; }
__device__ __forceinline__ uint32_t pair_id(uint2 p) { return p.x; }

// acc[c] += value * w[c] for the pair's row w of the slice, each product
// rounded, then added.
__device__ __forceinline__ void accumulate(float (&acc)[8], uint32_t p,
                                           uint4 w) {
  const float v = __uint_as_float(p & 0xFFFF0000u);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(ws[j] << 16);
    const float hi = __uint_as_float(ws[j] & 0xFFFF0000u);
    acc[2 * j] = __fadd_rn(acc[2 * j], __fmul_rn(v, lo));
    acc[2 * j + 1] = __fadd_rn(acc[2 * j + 1], __fmul_rn(v, hi));
  }
}

__device__ __forceinline__ void accumulate(float (&acc)[4], uint2 p, uint4 w) {
  const float v = __uint_as_float(p.y);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    acc[j] = __fadd_rn(acc[j], __fmul_rn(v, __uint_as_float(ws[j])));
}

// pairs[g][t][j] = (clip(idx[i, t]), vals[i, t]) for token i = g * kThreads
// + j, zero pairs for i >= n; a block transposes tiles of kPackTile tokens
// x kPackTile steps through shared memory.  grid: (ceil(k / kPackTile), at
// most 65,535 token tiles, striding over the rest); block: (kPackTile, 8).
template <typename Raw>
__global__ void __launch_bounds__(kPackTile * 8)
pack_pairs_kernel(const Raw* __restrict__ vals, const int* __restrict__ idx,
                  typename PairOf<Raw>::type* __restrict__ pairs, int n, int k,
                  int d_ff, int n_tiles) {
  using Pair = typename PairOf<Raw>::type;
  __shared__ Pair tile[kPackTile][kPackTile + 1];
  const int t0 = blockIdx.x * kPackTile;
  for (int ti = blockIdx.y; ti < n_tiles; ti += gridDim.y) {
    const int i0 = ti * kPackTile;
    __syncthreads();  // the previous tile is stored
    for (int r = threadIdx.y; r < kPackTile; r += 8) {
      const int i = i0 + r, t = t0 + threadIdx.x;
      Pair p{};  // a zero pair
      if (i < n && t < k) {
        const long long e = (long long)i * k + t;
        const int id = idx[e];
        p = pack_pair(vals[e], id < 0 ? 0 : (id >= d_ff ? d_ff - 1 : id));
      }
      tile[r][threadIdx.x] = p;
    }
    __syncthreads();
    const int g = i0 / kThreads, j = i0 - g * kThreads + threadIdx.x;
    for (int r = threadIdx.y; r < kPackTile; r += 8) {
      const int t = t0 + r;
      if (t < k)
        pairs[((long long)g * k + t) * kThreads + j] = tile[threadIdx.x][r];
    }
  }
}

template <typename Raw>
__global__ void __launch_bounds__(kThreads + 32, 1)
topk_smem_kernel(const Raw* __restrict__ w2,
                 const typename PairOf<Raw>::type* __restrict__ pairs,
                 float* __restrict__ out, int n, int k, long long d, int d_ff,
                 int aligned) {
  using Pair = typename PairOf<Raw>::type;
  constexpr int kCols = kSliceBytes / (int)sizeof(Raw);
  constexpr int kChunkT = kStageBytes / (kThreads * (int)sizeof(Pair));
  constexpr int kWarps = kThreads / 32;  // consumer warps
  static_assert(kChunkT >= 1, "a stage must hold one step of t");
  static_assert(2 * 8 * kStages <= kBarrierBytes, "the barriers must fit");
  extern __shared__ __align__(128) unsigned char smem[];
  // kStages mbarriers each: full (the chunk's bytes landed) and consumed
  // (every consumer warp is done with the buffer)
  const uint32_t full0 = hopper::smem_addr(smem);
  const uint32_t consumed0 = full0 + 8 * kStages;
  const uint32_t buf0 = full0 + kBarrierBytes;
  const Pair* bufs = reinterpret_cast<const Pair*>(smem + kBarrierBytes);
  unsigned char* slice = smem + kBarrierBytes + kStages * kStageBytes;

  const long long col0 = (long long)blockIdx.x * kCols;
  const int n_groups = (n + kThreads - 1) / kThreads;
  const int n_chunks = (k + kChunkT - 1) / kChunkT;
  const long long total = (long long)n_groups * n_chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);
      hopper::mbar_init(consumed0 + 8 * s, kWarps);
    }
    hopper::fence_mbarrier_init();
  }
  __syncthreads();  // the barriers before any use

  if (threadIdx.x >= kThreads) {  // the producer warp
    if (threadIdx.x == kThreads) {
      long long q = 0;
      for (int g = 0; g < n_groups; ++g) {
        for (int c = 0; c < n_chunks; ++c, ++q) {
          const int s = (int)(q % kStages);
          if (q >= kStages)  // buffer s held chunk q - kStages
            hopper::mbar_wait(consumed0 + 8 * s,
                              (uint32_t)((q / kStages - 1) & 1));
          const int cnt = k - c * kChunkT < kChunkT ? k - c * kChunkT : kChunkT;
          const uint32_t bytes = (uint32_t)(cnt * kThreads * sizeof(Pair));
          hopper::mbar_arrive_expect_tx(full0 + 8 * s, bytes);
          hopper::bulk_copy(
              buf0 + s * kStageBytes,
              pairs + ((long long)g * k + (long long)c * kChunkT) * kThreads,
              bytes, full0 + 8 * s);
        }
      }
    }
    __syncwarp();
  } else {
    // Stage the slice: row r's kSliceBytes at r * kSliceBytes.
    const uint32_t slice_addr = hopper::smem_addr(slice);
    if (aligned) {
      for (int r = threadIdx.x; r < d_ff; r += kThreads)
        hopper::cp_async_16(slice_addr + r * kSliceBytes,
                            w2 + (long long)r * d + col0, 16);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
    } else {
      for (int r = threadIdx.x; r < d_ff; r += kThreads) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (col0 + c < d)
            w[c * sizeof(Raw) / 4] |=
                static_cast<uint32_t>(w2[(long long)r * d + col0 + c])
                << (8 * (c * sizeof(Raw) % 4));
        *reinterpret_cast<uint4*>(slice + r * kSliceBytes) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" :: "r"(kThreads) : "memory");
    const uint4* rows = reinterpret_cast<const uint4*>(slice);

    long long q = 0;
    for (int g = 0; g < n_groups; ++g) {
      float acc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
      for (int c = 0; c < n_chunks; ++c, ++q) {
        const int s = (int)(q % kStages);
        const int cnt = k - c * kChunkT < kChunkT ? k - c * kChunkT : kChunkT;
        hopper::mbar_wait(full0 + 8 * s, (uint32_t)((q / kStages) & 1));
        const Pair* buf = bufs + s * (kStageBytes / (int)sizeof(Pair))
                          + threadIdx.x;
        if (cnt == kChunkT) {
#pragma unroll
          for (int t = 0; t < kChunkT; ++t) {
            const Pair p = buf[t * kThreads];
            accumulate(acc, p, rows[pair_id(p)]);
          }
        } else {
          for (int t = 0; t < cnt; ++t) {
            const Pair p = buf[t * kThreads];
            accumulate(acc, p, rows[pair_id(p)]);
          }
        }
        if (q + kStages < total) {  // buffer s is refilled: this warp is done
          __syncwarp();
          if (threadIdx.x % 32 == 0) hopper::mbar_arrive(consumed0 + 8 * s);
        }
      }
      const long long i = (long long)g * kThreads + threadIdx.x;
      if (i < n) {
        float* o = out + i * d + col0;
        if (d % 4 == 0 && col0 + kCols <= d) {
#pragma unroll
          for (int j = 0; j < kCols; j += 4)
            *reinterpret_cast<float4*>(o + j) =
                make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (col0 + j < d) o[j] = acc[j];
        }
      }
    }
  }
}

template <typename Raw>
int launch(const void* vals, const void* idx, const void* w2, void* pairs,
           void* out, int n, int k, long long d, int d_ff, int smem,
           cudaStream_t s) {
  using Pair = typename PairOf<Raw>::type;
  constexpr int kCols = kSliceBytes / (int)sizeof(Raw);
  const int n_groups = (n + kThreads - 1) / kThreads;
  const int n_tiles = n_groups * (kThreads / kPackTile);
  const dim3 pack_grid((unsigned)((k + kPackTile - 1) / kPackTile),
                       (unsigned)(n_tiles < 65535 ? n_tiles : 65535));
  pack_pairs_kernel<Raw><<<pack_grid, dim3(kPackTile, 8), 0, s>>>(
      static_cast<const Raw*>(vals), static_cast<const int*>(idx),
      static_cast<Pair*>(pairs), n, k, d_ff, n_tiles);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  auto kernel = topk_smem_kernel<Raw>;
  rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                            smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long n_slices = (d + kCols - 1) / kCols;
  const int aligned = (d * (long long)sizeof(Raw)) % kSliceBytes == 0
                      && reinterpret_cast<uintptr_t>(w2) % kSliceBytes == 0;
  kernel<<<(unsigned)n_slices, kThreads + 32, smem, s>>>(
      static_cast<const Raw*>(w2), static_cast<const Pair*>(pairs),
      static_cast<float*>(out), n, k, d, d_ff, aligned);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals: (n, k) float32 (bf16 = 0) or bfloat16 (bf16 = 1); idx: (n, k)
// int32; w2: (d_ff, d) of vals' type; pairs: scratch of ceil(n / kThreads)
// * kThreads * k pairs (4 bytes each for bfloat16, 8 for float32); out:
// (n, d) float32, written in full.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape the route does not take
// (W2's slice and the pair buffers past kMaxSmem, an empty operand, sizes
// past 32 bits).
extern "C" int repro_topk_spmm_smem(const void* vals, const void* idx,
                                    const void* w2, void* pairs, void* out,
                                    long long n, long long k, long long d,
                                    long long d_ff, int bf16, void* stream) {
  const long long smem = kSliceBytes * d_ff + (long long)kStages * kStageBytes
                         + kBarrierBytes;
  if (n <= 0 || k <= 0 || d <= 0 || d_ff <= 0 || smem > kMaxSmem
      || n > INT_MAX - kThreads || k > INT_MAX || d > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<uint16_t>(vals, idx, w2, pairs, out, (int)n, (int)k, d,
                            (int)d_ff, (int)smem, s);
  return launch<uint32_t>(vals, idx, w2, pairs, out, (int)n, (int)k, d,
                          (int)d_ff, (int)smem, s);
}
