// The per-tile block form of the paper's Eq. (1) down-projection on the
// tensor cores of a Hopper GPU (sm_90a): the bf16 and float16 route of
// ops.block_topk_spmm.  float32 inputs go to topk_spmm.cu.
//   y[tile] = sum over t < kb of
//             h_kept[tile, t] (tile x block) @ W2[bidx[tile, t]*block : +block, :]
// in float32; ids outside W2 are clipped to its first or last block.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_spmm.py:74
// (block_topk_spmm; body _tile_kernel: grid (tiles, kb), the W2 block named
// by the scalar-prefetched bidx DMA'd for each step and multiplied on the
// MXU into the tile's output block).  Products of bf16 or f16 values are
// exact in float32, so y differs from the plain version only in the order
// of its sums, and that order is fixed: a repeat gives the same bits.
//
// What bounds it on an H100: bytes.  At the FFN path's shape (256 tiles of
// 8 tokens, 8 of 64 blocks of 128 lanes a tile, W2 8,192 x 3,072) it must
// read h_kept (4 MB), the W2 blocks the ids name (64 blocks, 50 MB) and
// write y in float32 (25 MB): 0.024 ms at 3.35 TB/s, against 12.9 GFLOP,
// 0.013 ms at the 989 TFLOP/s bf16 tensor-core rate.  Tile by tile, as the
// TPU grid runs, each of the 2,048 (tile, t) pairs reads its 786 KB block
// again: 1.6 GB, though each block is picked by about 32 tiles.
//
// Design (what it does about that bound): block-major, so that each W2
// block is read from memory once; each product written once to a slot of
// its own and the slots added in a fixed order, so that no sum depends on
// the order in which blocks run.
//   * invert_kernel (one block of 1,024 threads) groups the n_tiles * kb
//     pairs by their clipped block id: a stable counting sort gives
//     pair_ptr (n_blocks + 1) and the pair ids p = tile * kb + t ordered by
//     (block, p).  Its counters live in shared memory up to
//     kMaxInvertBlocks blocks (128 KB), past that in global memory after
//     pair_ptr.  Its grid is sized from the shapes alone, so the host never
//     waits for the selection.
//   * block_topk_wgmma_kernel runs one block per (W2 block b, 128 columns
//     of d, depth panel): a block's lanes are taken in panels of at most
//     kPanelLanes (256), so that B and four A slots fit one block's shared
//     memory at any depth.  It stages W2[b*block + lane0 : +lanes,
//     n0 : n0 + 128] once in shared memory, MN-major as two SW128 panels of
//     64 columns (wgmma reads it with the transpose bit, as bsr_spmm_wgmma.cu
//     reads its B).  A is the stack of the tile rows of b's pairs, 64 rows
//     at a time: each row a contiguous run of the panel's lanes, so A is
//     K-major, in panels of 64 lanes.  Each of the block's two warpgroups
//     takes every other 64-row chunk, loading its next chunk by cp.async
//     while it multiplies this one (m64n128k16 wgmmas over the depth,
//     float32 accumulators).
//   * Epilogue: accumulator row r of a chunk is the partial product of its
//     pair p and depth panel dp for tile row r % tile; it is stored (float2
//     pairs) to its own workspace row (p * n_panels + dp) * tile + r % tile,
//     all 128 columns of the slice (zeros past d), rows n_slices * 128
//     floats apart.  No atomics, and y is not zeroed.
//   * reduce_kernel writes y once: each float32 is the sum over t < kb and
//     then the depth panels of its tile's slots, in that order, from 0.
//     The workspace is kb * n_panels times y (201 MB at the FFN shape,
//     written once and read once: 0.12 ms of traffic at 3.35 TB/s).
//   * Staging paths: rows of h (block lanes) and of W2 (d columns) whose
//     byte stride is a multiple of 16 at a 16-byte aligned base are copied
//     in 16-byte cp.async chunks, zero-filled past the stack's rows, past
//     the panel's lanes and past d; otherwise element by element, zeros
//     likewise.  Zero depth adds exact zeros.
//   The panel's depth is padded to whole SW128 panels of 64 lanes.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::sw128;
using hopper::sw128_desc;

constexpr int kThreads = 256;     // two warpgroups
constexpr int kTM = 64;           // stacked rows a warpgroup multiplies
constexpr int kTN = 128;          // columns of d a block owns (two panels)
constexpr int kPanelLanes = 256;  // the deepest panel: B + 4 A slots fit
constexpr int kInvThreads = 1024;
constexpr int kMaxInvertBlocks = 32768;  // counters in shared memory (128 KB)
constexpr int kReduceThreads = 256;
constexpr int kReduceBlocks = 2048;
constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of block_topk_wgmma_kernel at panel depth kp (the
// deepest panel's lanes rounded up to 64): B (kp rows x 2 panels of 128
// bytes), four A slots (64 rows x kp lanes) and 1024 bytes to align them.
__host__ __device__ constexpr int smem_bytes(int kp) {
  return 1024 + kp * 2 * 128 + 4 * kp * 128;
}

__device__ __forceinline__ int clip(int b, int n_blocks) {
  return b < 0 ? 0 : (b >= n_blocks ? n_blocks - 1 : b);
}

// Synchronise the 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// The stable counting sort of the pairs by clipped block: counters (then
// cursors) in shared memory, or at `cur_global` where it is not NULL.
__global__ void __launch_bounds__(kInvThreads)
invert_kernel(const int* __restrict__ bidx, long long n_pairs, int n_blocks,
              int* __restrict__ pair_ptr, int* __restrict__ pairs,
              int* cur_global) {
  extern __shared__ int cur_smem[];  // n_blocks counts, then cursors
  int* cur = cur_global != nullptr ? cur_global : cur_smem;
  __shared__ int warp_sum[kInvThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = threadIdx.x; b < n_blocks; b += kInvThreads) cur[b] = 0;
  __syncthreads();
  for (long long p = threadIdx.x; p < n_pairs; p += kInvThreads)
    atomicAdd(&cur[clip(bidx[p], n_blocks)], 1);
  __syncthreads();
  // exclusive scan of the counts, 1,024 at a time, with a running carry
  int carry = 0;
  for (int b0 = 0; b0 < n_blocks; b0 += kInvThreads) {
    const int b = b0 + threadIdx.x;
    const int c = b < n_blocks ? cur[b] : 0;
    int x = c;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    if (b < n_blocks) {
      const int excl = carry + (warp ? warp_sum[warp - 1] : 0) + x - c;
      cur[b] = excl;
      pair_ptr[b] = excl;
    }
    carry += warp_sum[kInvThreads / 32 - 1];
    __syncthreads();  // warp_sum is reused
  }
  if (threadIdx.x == 0) pair_ptr[n_blocks] = (int)n_pairs;
  // stable fill: 1,024 pairs at a time, the warps in turn, each lane after
  // the lower lanes of its warp that name the same block
  for (long long p0 = 0; p0 < n_pairs; p0 += kInvThreads) {
    const long long p = p0 + threadIdx.x;
    const int b = p < n_pairs ? clip(bidx[p], n_blocks) : -1;
    const unsigned same = __match_any_sync(kFull, b);
    const unsigned lower = same & ((1u << lane) - 1);
    for (int w = 0; w < kInvThreads / 32; ++w) {
      __syncthreads();  // the previous warp's cursors are written
      if (warp == w) {
        int base = 0;
        if (b >= 0 && lower == 0) {
          base = cur[b];
          cur[b] = base + __popc(same);
        }
        base = __shfl_sync(kFull, base, __ffs(same) - 1);
        if (b >= 0) pairs[base + __popc(lower)] = (int)p;
      }
    }
    __syncthreads();
  }
}

// Stage W2 rows k < lanes of block b's panel (w2b: its first row),
// columns n0 .. n0 + 127, at shared address bt (two MN-major panels of kp
// rows, `panel` bytes apart).
template <typename T>
__device__ __forceinline__ void stage_b(uint32_t bt, uint32_t panel,
                                        const T* w2b, long long n0,
                                        int lanes, int kp, long long d,
                                        bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < kp * (kTN / 8); e += kThreads) {
      const int kr = e >> 4, ch = e & 15;
      const bool ok = kr < lanes && n0 + ch * 8 < d;
      hopper::cp_async_16(bt + (ch >> 3) * panel + sw128(kr, ch & 7),
                          ok ? w2b + (long long)kr * d + n0 + ch * 8 : w2b,
                          ok ? 16 : 0);
    }
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(w2b);
    for (int e = threadIdx.x; e < kp * kTN; e += kThreads) {
      const int kr = e >> 7, c = e & 127;
      hopper::st_shared_u16(
          bt + (c >> 6) * panel + sw128(kr, (c >> 3) & 7) + (c & 7) * 2,
          kr < lanes && n0 + c < d ? bits[(long long)kr * d + n0 + c] : 0);
    }
  }
}

// The first element of stacked row R of the block's pairs in h: row
// R % tile of pair pairs[first + R / tile].
__device__ __forceinline__ long long h_row(const int* __restrict__ pairs,
                                           int first, int R, int tile,
                                           int block) {
  const int q = R / tile;
  return ((long long)pairs[first + q] * tile + (R - q * tile)) * block;
}

// Stage stacked rows c*64 .. c*64 + 63 of W2 block b's pairs, lanes
// lane0 .. lane0 + lanes - 1, into the A slot at shared address at
// (kp / 64 K-major panels of 64 rows), by the 128 threads of one warpgroup
// (t = their index).
template <typename T>
__device__ __forceinline__ void stage_a(uint32_t at, const T* h,
                                        const int* __restrict__ pairs,
                                        int first, int rows, int c, int tile,
                                        int block, int lane0, int lanes,
                                        int kp, bool vec, int t) {
  if (vec) {
    const int per_row = kp / 8;  // 16-byte chunks of a row
    for (int e = t; e < kTM * per_row; e += 128) {
      const int r = e / per_row, ch = e - r * per_row;
      const int R = c * kTM + r;
      const bool ok = R < rows && ch * 8 < lanes;
      hopper::cp_async_16(
          at + (ch >> 3) * (kTM * 128) + sw128(r, ch & 7),
          ok ? h + h_row(pairs, first, R, tile, block) + lane0 + ch * 8 : h,
          ok ? 16 : 0);
    }
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(h);
    for (int e = t; e < kTM * kp; e += 128) {
      const int r = e / kp, k = e - r * kp;
      const int R = c * kTM + r;
      uint16_t x = 0;
      if (R < rows && k < lanes)
        x = bits[h_row(pairs, first, R, tile, block) + lane0 + k];
      hopper::st_shared_u16(
          at + (k >> 6) * (kTM * 128) + sw128(r, (k >> 3) & 7) + (k & 7) * 2,
          x);
    }
  }
}

// T: __nv_bfloat16 or __half.  Block x = b * n_slices + slice; y = the
// depth panel.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
block_topk_wgmma_kernel(const T* __restrict__ h, const T* __restrict__ w2,
                        const int* __restrict__ pair_ptr,
                        const int* __restrict__ pairs,
                        float* __restrict__ ws, int tile, int block,
                        long long d, int n_slices, int n_panels, int vec_a,
                        int vec_b) {
  const int b = (int)(blockIdx.x / n_slices);
  const int first = pair_ptr[b];
  const int rows = (pair_ptr[b + 1] - first) * tile;  // < 2^31: see the host
  if (rows == 0) return;  // no tile picked this block
  const long long n0 = (long long)(blockIdx.x - b * n_slices) * kTN;
  const int dp = blockIdx.y;
  const int lane0 = dp * kPanelLanes;
  const int lanes = min(kPanelLanes, block - lane0);
  const int kp = (lanes + 63) / 64 * 64;  // whole SW128 panels
  const long long wd = (long long)n_slices * kTN;  // a workspace row
  extern __shared__ unsigned char smem_raw[];
  // panels start on 1024-byte boundaries (the SW128 pattern's period); the
  // A slots sit after B's two panels of the deepest panel's size
  const uint32_t bt = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const int kp_max = (min(block, kPanelLanes) + 63) / 64 * 64;
  const uint32_t panel = kp * 128;  // 64 columns of B: kp rows
  const uint32_t slot_bytes = kp * 128;  // one A slot: 64 rows x kp lanes
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const uint32_t a_wg = bt + 2 * kp_max * 128 + 2 * wg * slot_bytes;
  const int n_chunks = (rows + kTM - 1) / kTM;

  stage_b(bt, panel, w2 + ((long long)b * block + lane0) * d, n0, lanes, kp,
          d, vec_b);
  if (wg < n_chunks)
    stage_a(a_wg, h, pairs, first, rows, wg, tile, block, lane0, lanes, kp,
            vec_a, t);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();  // B, staged by both warpgroups, and the first A chunks

  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  int s = 0;
  for (int c = wg; c < n_chunks; c += 2, s ^= 1) {
    if (c + 2 < n_chunks)  // the next chunk loads while this one multiplies
      stage_a(a_wg + (s ^ 1) * slot_bytes, h, pairs, first, rows, c + 2,
              tile, block, lane0, lanes, kp, vec_a, t);
    hopper::cp_async_commit();
    const uint32_t at = a_wg + s * slot_bytes;
    float acc[64];  // the first wgmma overwrites it
    hopper::wgmma_fence();
    // four k16 steps a panel; unrolled in full, the loop spills at two
    // blocks an SM, and not unrolled at all, the kernel ran 1.6x slower
#pragma unroll 4
    for (int kk = 0; kk < kp / 16; ++kk)  // 16 deep: 32 bytes of a row
      hopper::wgmma_ss_m64n128k16_tb<T>(
          acc, sw128_desc(at + (kk >> 2) * (kTM * 128) + (kk & 3) * 32, 16,
                          1024),
          sw128_desc(bt + kk * 2048, panel, 1024), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    // value i of the m64n128 accumulator: row 16 * warp + lane / 4 +
    // 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2; each
    // row to its pair's workspace row
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int R = c * kTM + 16 * warp + (lane >> 2) + 8 * hh;
      if (R >= rows) continue;
      const int q = R / tile;
      float* row = ws + (((long long)pairs[first + q] * n_panels + dp) * tile
                         + (R - q * tile)) * wd + n0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(row + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    wg_barrier(wg);  // the next chunk is in; this slot is free
  }
}

// y row (i * tile + r), four columns a thread: the sum over t < kb, then
// the depth panels, of the slots (((i * kb + t) * n_panels + dp) * tile +
// r), from 0, in that order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
              long long n_rows, int tile, int kb, int n_panels, long long d,
              long long wd) {
  const long long groups = (d + 3) / 4;
  const long long n = n_rows * groups;
  const bool quads = (d & 3) == 0;
  for (long long e = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
       e < n; e += (long long)gridDim.x * kReduceThreads) {
    const long long row = e / groups;
    const long long c = (e - row * groups) * 4;
    const long long i = row / tile;
    const long long r = row - i * tile;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* slot = ws + (i * kb * n_panels * tile + r) * wd + c;
    for (int u = 0; u < kb * n_panels; ++u) {
      const float4 x = *reinterpret_cast<const float4*>(slot);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
      slot += tile * wd;
    }
    float* o = out + row * d + c;
    if (quads) {
      *reinterpret_cast<float4*>(o) = s;
    } else {
      o[0] = s.x;
      if (c + 1 < d) o[1] = s.y;
      if (c + 2 < d) o[2] = s.z;
      if (c + 3 < d) o[3] = s.w;
    }
  }
}

template <typename T>
int launch(const void* h, const void* w2, const int* pair_ptr,
           const int* pairs, float* ws, float* out, long long n_tiles,
           long long kb, long long tile, long long block, long long d,
           long long n_blocks, cudaStream_t s) {
  const long long n_slices = (d + kTN - 1) / kTN;
  const int n_panels = (int)((block + kPanelLanes - 1) / kPanelLanes);
  const int kp_max = (int)((block < kPanelLanes ? block : kPanelLanes) + 63)
                     / 64 * 64;
  const int smem = smem_bytes(kp_max);
  cudaError_t err = cudaFuncSetAttribute(
      block_topk_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_a = block % 8 == 0
      && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const int vec_b = d % 8 == 0 && (reinterpret_cast<uintptr_t>(w2) & 15) == 0;
  const dim3 grid((unsigned)(n_slices * n_blocks), (unsigned)n_panels);
  block_topk_wgmma_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w2), pair_ptr, pairs,
      ws, (int)tile, (int)block, d, (int)n_slices, n_panels, vec_a, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long work = n_tiles * tile * ((d + 3) / 4);
  const long long blocks = (work + kReduceThreads - 1) / kReduceThreads;
  reduce_kernel<<<(unsigned)(blocks < kReduceBlocks ? blocks : kReduceBlocks),
                  kReduceThreads, 0, s>>>(ws, out, n_tiles * tile, (int)tile,
                                          (int)kb, n_panels, d,
                                          n_slices * kTN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 elements of the workspace repro_block_topk_spmm_wgmma takes
// (topk_spmm.wgmma_workspace computes the same): a slot of tile rows a
// (pair, depth panel), rows of d rounded up to kTN columns.
//
// h: (n_tiles, kb, tile, block) bfloat16 (dtype 1) or float16 (dtype 2);
// bidx: (n_tiles, kb) int32; w2: (n_blocks * block, d) of h's type;
// pair_ptr: (2 * n_blocks + 1,) and pairs: (n_tiles * kb,) int32 scratch;
// ws: float32 scratch of ws_elems >= n_tiles * kb * ceil(block / 256) *
// tile * ceil(d / 128) * 128 elements, 16-byte aligned; out:
// (n_tiles * tile, d) float32, 16-byte aligned, written in full.  Any
// block and any number of blocks whose shapes fit the grid.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape or type it does not take.
extern "C" int repro_block_topk_spmm_wgmma(
    const void* h, const void* bidx, const void* w2, void* pair_ptr,
    void* pairs, void* ws, long long ws_elems, void* out, long long n_tiles,
    long long kb, long long tile, long long block, long long d,
    long long n_blocks, int dtype, void* stream) {
  if (n_tiles <= 0 || kb <= 0 || tile <= 0 || d <= 0) return 0;
  const long long n_pairs = n_tiles * kb;
  const long long n_slices = (d + kTN - 1) / kTN;
  const long long n_panels = (block + kPanelLanes - 1) / kPanelLanes;
  if (block < 1 || n_blocks < 1 || block > INT_MAX || n_pairs > INT_MAX
      || n_pairs * tile > INT_MAX || n_blocks > INT_MAX / 2
      || n_slices * n_blocks > INT_MAX || n_panels > 65535
      || ws_elems < n_pairs * n_panels * tile * n_slices * kTN
      || ((reinterpret_cast<uintptr_t>(ws)
           | reinterpret_cast<uintptr_t>(out)) & 15) != 0
      || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool in_smem = n_blocks <= kMaxInvertBlocks;
  const int inv_smem = in_smem ? (int)n_blocks * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      invert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, inv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* ptr = static_cast<int*>(pair_ptr);
  invert_kernel<<<1, kInvThreads, inv_smem, s>>>(
      static_cast<const int*>(bidx), n_pairs, (int)n_blocks, ptr,
      static_cast<int*>(pairs), in_smem ? nullptr : ptr + n_blocks + 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int* pr = static_cast<const int*>(pairs);
  float* wsf = static_cast<float*>(ws);
  float* y = static_cast<float*>(out);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w2, ptr, pr, wsf, y, n_tiles, kb, tile,
                                 block, d, n_blocks, s);
  return launch<__half>(h, w2, ptr, pr, wsf, y, n_tiles, kb, tile, block, d,
                        n_blocks, s);
}
