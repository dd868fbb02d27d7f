// The paper's Eq. (1) down-projection y = TopK(h) @ W2, in two forms:
//
// * topk_spmm (per token): y[i] = sum_t vals[i, t] * W2[idx[i, t], :].
//   Replaces the Pallas TPU kernel repro/kernels/topk_spmm.py:topk_spmm
//   (_token_kernel: grid (tokens, k), each step DMAs the W2 row named by the
//   prefetched id and adds vals[i, t] * row into the output block).
// * block_topk_spmm (per token tile): y[tile] = sum_{t < kb}
//   h_kept[tile, t] (tile x block) @ W2[bidx[tile, t]*block : +block, :].
//   Replaces topk_spmm.py:block_topk_spmm (_tile_kernel: grid (tiles, kb),
//   each step a (tile x block) @ (block x d) MXU product on a DMA'd W2 block).
//
// topk_spmm takes float32, bfloat16 or float16 inputs; block_topk_spmm
// the same (its bfloat16 calls within the tensor-core kernel's limits go to
// block_topk_spmm_wgmma.cu: a block up to 256 lanes, up to 32,768
// blocks); both accumulate in float32.  Ids outside W2 are clipped to its first or last row (block), so
// no id reads outside W2.
//
// What bounds them on an H100: the bytes each input needs once (the
// activations and ids, the W2 rows or blocks the ids name, y in float32)
// over 3.35 TB/s; the operations (2 per kept entry per output column) at the
// bf16 tensor-core rate come to about half that.  These first kernels do the
// arithmetic on the CUDA cores and read each selected W2 row once per token
// (per tile for the block form) through L2, so they run well above it.
//
// Design, per token: a block owns one token and 1,024 columns of d (256
// threads, 4 columns each, strided so a warp's loads of a W2 row coalesce).
// It stages 256 (value, id) pairs at a time in shared memory and walks t in
// order, forming each product with __fmul_rn and adding it with __fadd_rn
// from 0.0f: the sum of every output is taken in the reference's order and
// rounding, so a repeated id accumulates, and the kernel, its plain version
// and the Pallas kernel agree bit for bit.
//
// Design, per tile: a block owns 8 rows of one tile and 512 columns of d
// (128 threads, 4 columns each, strided).  For each t it stages the 8 rows
// of h_kept[tile, t] in shared memory as float32, in panels of kPanel
// lanes (48 KB) for a wider block, then streams the selected W2 block's
// rows of each panel, each thread adding h[m][k] * w into 8 x 4 float32
// accumulators with fmaf in k order, so only the order of the sums differs
// from the reference's per-step dot.
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

using dtypes::to_f;

constexpr int kTokThreads = 256;
constexpr int kTokCols = 4;  // columns per thread
constexpr int kTokChunk = kTokThreads;

template <typename T>
__global__ void __launch_bounds__(kTokThreads)
topk_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                 const T* __restrict__ w2, float* __restrict__ out, int k,
                 long long d, int d_ff) {
  __shared__ float sv[kTokChunk];
  __shared__ int si[kTokChunk];
  const long long row = blockIdx.x;
  const long long n0 = (long long)blockIdx.y * (kTokThreads * kTokCols)
                       + threadIdx.x;
  float acc[kTokCols];
#pragma unroll
  for (int c = 0; c < kTokCols; ++c) acc[c] = 0.0f;
  for (int t0 = 0; t0 < k; t0 += kTokChunk) {
    const int cnt = k - t0 < kTokChunk ? k - t0 : kTokChunk;
    __syncthreads();  // the previous chunk is consumed
    if (threadIdx.x < cnt) {
      const long long e = row * k + t0 + threadIdx.x;
      const int id = idx[e];
      si[threadIdx.x] = id < 0 ? 0 : (id >= d_ff ? d_ff - 1 : id);
      sv[threadIdx.x] = to_f(vals[e]);
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const float v = sv[t];
      const T* w = w2 + (long long)si[t] * d;
#pragma unroll
      for (int c = 0; c < kTokCols; ++c) {
        const long long n = n0 + (long long)c * kTokThreads;
        if (n < d) acc[c] = __fadd_rn(acc[c], __fmul_rn(v, to_f(w[n])));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kTokCols; ++c) {
    const long long n = n0 + (long long)c * kTokThreads;
    if (n < d) out[row * d + n] = acc[c];
  }
}

constexpr int kTileThreads = 128;
constexpr int kTileCols = 4;  // columns per thread
constexpr int kTileRows = 8;  // tile rows per block
constexpr int kPanel = 1536;  // lanes of a block staged at once (48 KB)

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
block_topk_spmm_kernel(const T* __restrict__ h, const int* __restrict__ bidx,
                       const T* __restrict__ w2, float* __restrict__ out,
                       int kb, int tile, int block, long long d, int n_blocks) {
  extern __shared__ float hs[];  // kTileRows x min(block, kPanel)
  const long long tile_id = blockIdx.x;
  const int r0 = blockIdx.z * kTileRows;
  const int rows = tile - r0 < kTileRows ? tile - r0 : kTileRows;
  const long long n0 = (long long)blockIdx.y * (kTileThreads * kTileCols)
                       + threadIdx.x;
  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int m = 0; m < kTileRows; ++m)
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[m][c] = 0.0f;

  const int pw = block < kPanel ? block : kPanel;  // a panel's lanes
  for (int t = 0; t < kb; ++t) {
    int blk = bidx[tile_id * kb + t];
    blk = blk < 0 ? 0 : (blk >= n_blocks ? n_blocks - 1 : blk);
    const T* src = h + ((tile_id * kb + t) * tile + r0) * (long long)block;
    const T* w = w2 + (long long)blk * block * d;
    for (int p0 = 0; p0 < block; p0 += pw) {
      const int lanes = block - p0 < pw ? block - p0 : pw;
      __syncthreads();  // the previous panel's rows are consumed
      for (int e = threadIdx.x; e < kTileRows * lanes; e += kTileThreads) {
        const int m = e / lanes;
        hs[e] = m < rows ? to_f(src[(long long)m * block + p0 + (e - m * lanes)])
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < lanes; ++kk) {
        float wv[kTileCols];
#pragma unroll
        for (int c = 0; c < kTileCols; ++c) {
          const long long n = n0 + (long long)c * kTileThreads;
          wv[c] = n < d ? to_f(w[(long long)(p0 + kk) * d + n]) : 0.0f;
        }
#pragma unroll
        for (int m = 0; m < kTileRows; ++m) {
          const float hv = hs[m * lanes + kk];
#pragma unroll
          for (int c = 0; c < kTileCols; ++c)
            acc[m][c] = fmaf(hv, wv[c], acc[m][c]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kTileRows; ++m) {
    if (m >= rows) break;
    float* o = out + (tile_id * tile + r0 + m) * d;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const long long n = n0 + (long long)c * kTileThreads;
      if (n < d) o[n] = acc[m][c];
    }
  }
}

}  // namespace

// vals: (n, k) of the type `dtype` names (0 float32, 1 bfloat16, 2
// float16); idx: (n, k) int32; w2: (d_ff, d) of vals' type; out: (n, d)
// float32, written in full.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a type or a shape the grid cannot hold.
extern "C" int repro_topk_spmm(const void* vals, const void* idx,
                               const void* w2, void* out, long long n,
                               long long k, long long d, long long d_ff,
                               int dtype, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const long long gy = (d + kTokThreads * kTokCols - 1)
                       / (kTokThreads * kTokCols);
  if (n > 2147483647LL || gy > 65535 || k > 2147483647LL || d_ff <= 0
      || d_ff > 2147483647LL || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)n, (unsigned)gy);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TOPK(T)                                                       \
  topk_spmm_kernel<T><<<grid, kTokThreads, 0, s>>>(                         \
      static_cast<const T*>(vals), static_cast<const int*>(idx),            \
      static_cast<const T*>(w2), static_cast<float*>(out), (int)k, d,       \
      (int)d_ff);
  switch (dtype) {
    case 1: REPRO_TOPK(__nv_bfloat16) break;
    case 2: REPRO_TOPK(__half) break;
    default: REPRO_TOPK(float) break;
  }
#undef REPRO_TOPK
  return static_cast<int>(cudaGetLastError());
}

// h: (n_tiles, kb, tile, block) of the type `dtype` names (0 float32, 1
// bfloat16, 2 float16); bidx: (n_tiles, kb) int32; w2: (n_blocks * block,
// d) of h's type; out: (n_tiles * tile, d) float32, written in full.  Any
// block: 8 rows of up to kPanel lanes are staged at once, 48 KB.
extern "C" int repro_block_topk_spmm(const void* h, const void* bidx,
                                     const void* w2, void* out,
                                     long long n_tiles, long long kb,
                                     long long tile, long long block,
                                     long long d, long long n_blocks,
                                     int dtype, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || d <= 0) return 0;
  const long long gy = (d + kTileThreads * kTileCols - 1)
                       / (kTileThreads * kTileCols);
  const long long gz = (tile + kTileRows - 1) / kTileRows;
  const long long smem =
      (long long)kTileRows * (block < kPanel ? block : kPanel) * sizeof(float);
  if (n_tiles > 2147483647LL || gy > 65535 || gz > 65535 || block <= 0
      || block > 2147483647LL || kb > 2147483647LL || n_blocks <= 0
      || n_blocks > 2147483647LL || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)n_tiles, (unsigned)gy, (unsigned)gz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_BLOCK(T)                                                      \
  block_topk_spmm_kernel<T><<<grid, kTileThreads, smem, s>>>(               \
      static_cast<const T*>(h), static_cast<const int*>(bidx),              \
      static_cast<const T*>(w2), static_cast<float*>(out), (int)kb,         \
      (int)tile, (int)block, d, (int)n_blocks);
  switch (dtype) {
    case 1: REPRO_BLOCK(__nv_bfloat16) break;
    case 2: REPRO_BLOCK(__half) break;
    default: REPRO_BLOCK(float) break;
  }
#undef REPRO_BLOCK
  return static_cast<int>(cudaGetLastError());
}
