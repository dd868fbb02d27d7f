// Block-row Gustavson product of a bf16 BSR matrix with a bf16 dense one on
// the tensor cores of a Hopper GPU (sm_90a): the bf16 route of
// ops.bsr_spmm.  float32 inputs go to bsr_spmm.cu.
//   C[i*bs:(i+1)*bs, :] = sum over j < min(max_blocks_per_row, row length)
//                         of A_blocks[rowptr[i] + j] @ B[colidx[.]*bs : +bs, :]
// in float32, C written in full.
//
// Replaces the Pallas TPU kernel repro/kernels/spgemm_bsr.py:46 (bsr_spmm;
// body _accum_kernel: grid (block-rows, max_blocks_per_row), rowptr and
// colidx scalar-prefetched, the B row-block DMA'd through colidx).  As
// there, the blocks of a row past max_blocks_per_row are dropped, a slot
// past the last stored block reads the last block, and an empty row gives
// zeros; block-column ids are clipped to B's block rows.  Products of bf16
// values are exact in float32, so C differs from the plain version only in
// the order of its sums.
//
// What bounds it on an H100: bytes.  At the FFN path's shape (8,192 x 3,072
// BSR, 128 x 128 blocks, 3 kept a block-row, times b 3,072 x 2,048) it must
// read A's 192 kept blocks (6.3 MB) and the B row-blocks they name
// (12.6 MB) and write C in float32 (67.1 MB): 86 MB, 0.0257 ms at
// 3.35 TB/s, against 12.9 GFLOP, 0.013 ms at the 989 TFLOP/s bf16
// tensor-core rate.  The float32 store of C is 78% of the bytes.
//
// Design (what it does about that bound):
//   * An output tile is 128 rows of one block-row's output x 128 columns
//     (rows m0.. of the block, columns n0..), 64 rows to each of a block's
//     two warpgroups.  The tiles are numbered block-row by block-row,
//     column tiles fastest, so the tiles in flight share their block-rows'
//     A blocks; all operands fit the 50 MB L2.
//   * The kernel is persistent: as many blocks as the card holds at once
//     (two an SM), block k taking tiles k, k + gridDim.x, ...  For each
//     tile it walks the row's blocks and, inside each, the depth in stages
//     of 64: a stage holds the A-block slice, 128 rows x 64 K-major (16 KB,
//     one SW128 panel), and the B slice, 64 rows x 128 columns (two SW128
//     panels of 64 columns, 16 KB), which wgmma reads MN-major through the
//     transpose bit.  Each stage is four wgmma m64n128k16 a warpgroup into
//     64 float32 accumulators a thread.
//   * Stages go through a ring of three (97 KB of shared memory a block)
//     filled by cp.async, by a load cursor that runs two steps ahead of the
//     products through the block's tiles in the same order: the copies of
//     step t + 2 are in flight while the tensor cores run step t, the
//     wgmmas of step t run while the block waits for step t + 1, and the
//     next tile's first two steps load while this tile's epilogue stores.
//     (One launch block a tile was slower at the FFN shape, and so were
//     tiles of 128 x 256 with one block an SM, though they halve the
//     A slices read from L2.)
//   * Staging paths.  A's rows are bs elements, B's rows d elements: a
//     row whose byte stride is a multiple of 16 (bs % 8 == 0 for A,
//     d % 8 == 0 for B) with a 16-byte aligned base is copied in 16-byte
//     cp.async chunks, zero-filled past bs rows, past bs depth and past d
//     columns; otherwise (odd d, bs % 8 != 0, unaligned tensors) that
//     operand is stored element by element, zeros likewise.  Zero depth
//     adds exact zeros; rows past bs and columns past d are not stored.
//   * Epilogue: the accumulators go straight to global memory as float2
//     (scalars for odd d) with streaming stores.  The four threads of a
//     quad hold eight consecutive columns, so every store instruction
//     fills whole 32-byte sectors; a pass through shared memory for 16-byte
//     stores would add a barrier and 64 KB of shared traffic for no fewer
//     sectors, and the ring it would use is loading the next tile.
//     Streaming (evict-first) keeps the 67 MB of C from pushing A's and
//     B's 19 MB out of L2.
//   Offsets are 64-bit; any bs >= 1 and d >= 1 are taken.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::sw128;
using hopper::sw128_desc;

constexpr int kWG = 2;                  // warpgroups per block
constexpr int kThreads = 128 * kWG;
constexpr int kTM = 64 * kWG;           // output rows per block
constexpr int kTN = 128;                // output columns per block
constexpr int kTK = 64;                 // depth per stage (one SW128 panel)
constexpr int kStages = 3;
constexpr uint32_t kATile = kTM * 128;  // A slice: kTM rows of 128 bytes
constexpr uint32_t kBPanel = kTK * 128; // 64 B columns: kTK rows of 128 bytes
constexpr uint32_t kStage = kATile + 2 * kBPanel;
// Dynamic shared memory of a launch: the ring and 1024 bytes to align it.
constexpr int kSmemBytes = 99328;
static_assert(kSmemBytes == 1024 + kStages * (int)kStage,
              "kSmemBytes is the ring of kStages stages and 1024 bytes");

// Stage one (block, depth) step into the ring slot at shared address `st`:
// A rows m0.. x depth k0.. of the block at `a` (bs x bs), then B rows k0..
// x columns n0.. of the row-block at `bb` (bs x d).
__device__ __forceinline__ void load_stage(uint32_t st,
                                           const __nv_bfloat16* a,
                                           const __nv_bfloat16* bb, int m0,
                                           int k0, long long n0, int bs,
                                           long long d, bool vec_a,
                                           bool vec_b) {
  if (vec_a) {
    for (int e = threadIdx.x; e < kTM * 8; e += kThreads) {
      const int r = e >> 3, ch = e & 7;
      const bool ok = m0 + r < bs && k0 + ch * 8 < bs;
      hopper::cp_async_16(st + sw128(r, ch),
                          ok ? a + (long long)(m0 + r) * bs + k0 + ch * 8 : a,
                          ok ? 16 : 0);
    }
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(a);
    for (int e = threadIdx.x; e < kTM * kTK; e += kThreads) {
      const int r = e >> 6, c = e & 63;
      hopper::st_shared_u16(
          st + sw128(r, c >> 3) + (c & 7) * 2,
          m0 + r < bs && k0 + c < bs
              ? bits[(long long)(m0 + r) * bs + k0 + c] : 0);
    }
  }
  const uint32_t bt = st + kATile;
  if (vec_b) {
    for (int e = threadIdx.x; e < kTK * (kTN / 8); e += kThreads) {
      const int kr = e >> 4, ch = e & 15;
      const bool ok = k0 + kr < bs && n0 + ch * 8 < d;
      hopper::cp_async_16(bt + (ch >> 3) * kBPanel + sw128(kr, ch & 7),
                          ok ? bb + (long long)(k0 + kr) * d + n0 + ch * 8
                             : bb,
                          ok ? 16 : 0);
    }
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(bb);
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int kr = e >> 7, c = e & 127;
      hopper::st_shared_u16(
          bt + (c >> 6) * kBPanel + sw128(kr, (c >> 3) & 7) + (c & 7) * 2,
          k0 + kr < bs && n0 + c < d
              ? bits[(long long)(k0 + kr) * d + n0 + c] : 0);
    }
  }
}

// One output tile's work: its block-row, first row and column, the row's
// first block slot and its (block, depth) steps.
struct Tile {
  long long brow, n0, start, n_steps;
  int m0;
};

__device__ __forceinline__ Tile tile_at(long long tile,
                                        const int* __restrict__ rowptr,
                                        int n_tiles, int m_tiles, int k_steps,
                                        int max_bpr) {
  Tile w;
  const long long rest = tile / n_tiles;
  w.n0 = (tile - rest * n_tiles) * kTN;
  w.m0 = (int)(rest % m_tiles) * kTM;
  w.brow = rest / m_tiles;
  w.start = rowptr[w.brow];
  long long len = rowptr[w.brow + 1] - w.start;
  len = len < 0 ? 0 : (len > max_bpr ? max_bpr : len);
  w.n_steps = len * k_steps;
  return w;
}

__global__ void __launch_bounds__(kThreads, 2)
bsr_spmm_wgmma_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ colidx,
                      const __nv_bfloat16* __restrict__ a_blocks,
                      const __nv_bfloat16* __restrict__ b,
                      float* __restrict__ out, int n_bcols, int bs,
                      long long d, int max_bpr, long long bcap, int m_tiles,
                      int n_tiles, int k_steps, long long n_work, int vec_a,
                      int vec_b) {
  extern __shared__ unsigned char smem_raw[];
  // stages start on 1024-byte boundaries (the SW128 pattern's period)
  const uint32_t ring = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;

  // The load cursor runs kStages - 1 steps ahead of the products, through
  // this block's tiles in the same order: step ls of tile lt, staged into
  // ring slot `staged` % kStages.
  long long lt = blockIdx.x, ls = 0, staged = 0;
  Tile lw = tile_at(lt, rowptr, n_tiles, m_tiles, k_steps, max_bpr);
  auto stage_next = [&]() {
    while (lt < n_work && ls >= lw.n_steps) {
      lt += gridDim.x;
      ls = 0;
      if (lt < n_work)
        lw = tile_at(lt, rowptr, n_tiles, m_tiles, k_steps, max_bpr);
    }
    if (lt < n_work) {
      const long long j = ls / k_steps;
      const int k0 = (int)(ls - j * k_steps) * kTK;
      long long p = lw.start + j;
      p = p < 0 ? 0 : (p >= bcap ? bcap - 1 : p);
      int c = colidx[p];
      c = c < 0 ? 0 : (c >= n_bcols ? n_bcols - 1 : c);
      load_stage(ring + (uint32_t)(staged % kStages) * kStage,
                 a_blocks + p * bs * bs, b + (long long)c * bs * d, lw.m0,
                 k0, lw.n0, bs, d, vec_a, vec_b);
      ++ls;
      ++staged;
    }
    hopper::cp_async_commit();  // one group a call, empty or not
  };

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int col0 = 2 * (lane & 3);
  const bool pairs = (d & 1) == 0;
  for (int s = 0; s < kStages - 1; ++s) stage_next();
  long long done = 0;  // steps multiplied; the next is in slot done % kStages
  for (long long tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    const Tile w = tile_at(tile, rowptr, n_tiles, m_tiles, k_steps, max_bpr);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (long long t = 0; t < w.n_steps; ++t, ++done) {
      hopper::cp_async_wait<kStages - 2>();  // step `done` has landed
      hopper::fence_proxy_async();
      __syncthreads();
      const uint32_t st = ring + (uint32_t)(done % kStages) * kStage;
      const uint32_t a_wg = st + wg * 64 * 128;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)  // 16 deep: 32 bytes of a row
        hopper::wgmma_ss_m64n128k16_tb(
            acc, sw128_desc(a_wg + kk * 32, 16, 1024),
            sw128_desc(st + kATile + kk * 2048, kBPanel, 1024), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // step done - 1's wgmmas are done
      __syncthreads();          // in both warpgroups: its slot is free
      stage_next();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // value i of the m64n128 accumulator: row 16 * warp + lane / 4 +
    // 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.  The
    // next tile's first steps load meanwhile.
    const int row0 =
        w.m0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row0 + 8 * h;
      if (m >= bs) continue;
      float* row = out + (w.brow * bs + m) * d + w.n0;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + col0;
        const float x = acc[4 * j + 2 * h];
        const float y = acc[4 * j + 2 * h + 1];
        if (pairs) {
          if (w.n0 + c < d)
            __stcs(reinterpret_cast<float2*>(row + c), make_float2(x, y));
        } else {
          if (w.n0 + c < d) __stcs(row + c, x);
          if (w.n0 + c + 1 < d) __stcs(row + c + 1, y);
        }
      }
    }
  }
}

}  // namespace

// rowptr: (n_brows + 1,) int32; colidx: (bcap,) int32; a_blocks:
// (bcap, bs, bs) bfloat16; b: (n_bcols * bs, d) bfloat16; out:
// (n_brows * bs, d) float32, written in full.  bcap > 0, n_bcols > 0.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the grid cannot hold.
extern "C" int repro_bsr_spmm_wgmma(const void* rowptr, const void* colidx,
                                    const void* a_blocks, const void* b,
                                    void* out, long long n_brows,
                                    long long n_bcols, long long bs,
                                    long long d, long long max_bpr,
                                    long long bcap, void* stream) {
  if (n_brows <= 0 || bs <= 0 || d <= 0) return 0;
  if (bcap <= 0 || n_bcols <= 0 || bs > INT_MAX || n_bcols > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m_tiles = (bs + kTM - 1) / kTM;
  const long long n_tiles = (d + kTN - 1) / kTN;
  const long long k_steps = (bs + kTK - 1) / kTK;
  if (n_tiles > INT_MAX || n_brows * m_tiles > INT_MAX / n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_bpr > INT_MAX) max_bpr = INT_MAX;
  cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_a = bs % 8 == 0
      && (reinterpret_cast<uintptr_t>(a_blocks) & 15) == 0;
  const int vec_b = d % 8 == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
  // persistent: as many blocks as the card holds at once, each walking
  // tiles blockIdx.x, + gridDim.x, ...
  const long long n_work = n_brows * m_tiles * n_tiles;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess
      || (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess
      || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, bsr_spmm_wgmma_kernel, kThreads, kSmemBytes))
             != cudaSuccess)
    return static_cast<int>(err);
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long grid = n_work < fit ? n_work : fit;
  bsr_spmm_wgmma_kernel<<<(unsigned)grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rowptr), static_cast<const int*>(colidx),
      static_cast<const __nv_bfloat16*>(a_blocks),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(out),
      (int)n_bcols, (int)bs, d, (int)max_bpr, bcap, (int)m_tiles,
      (int)n_tiles, (int)k_steps, n_work, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
