// AIA indirect row gather: out[i, :] = x[clip(idx[i], 0, n_x_rows - 1), :].
//
// Replaces the Pallas TPU kernel repro/kernels/aia_gather.py:gather_rows
// (scalar-prefetched row ids drive one DMA descriptor per row) together with
// its wrapper gather_rows_any (clip, pad to 8 rows, trim).  A second entry
// point, repro_aia_ranged_gather, replaces aia_gather.py:aia_ranged_gather
// (the Fig. 2 ranged form, one BlockSpec DMA of R rows per id): a range of
// R rows of x is one row of the (n_blocks, R * row_words) view.
//
// What bounds both on an H100: bytes.  Each output row is written once;
// each distinct source row needs reading once, and each id once: at most
// 2 * n_idx * row_bytes + 4 * n_idx bytes at 3.35 TB/s.  There is no
// arithmetic to speak of.
//
// The row gather (and the ranged gather's "words" route): a block copies a
// tile of whole rows, as many as fit in about 1024 words (one row when a
// row is longer), and its threads take the tile's words in order, so a
// warp's stores are contiguous and its loads are contiguous within each
// source row.  A thread moves one 4-byte word: B's ELL rows (14 and 591
// words on the Table II matrices) are not multiples of 16 bytes, so the
// source and destination rows do not share an alignment that a vector copy
// could use.  Offsets into x and out are 64-bit, so one code path serves
// every size; only the word within a tile is 32-bit.
//
// The ranged gather's "v16" route, for ranges that are whole 16-byte
// chunks at 16-byte aligned x and out (W2's ranges on the FFN path are
// 128 rows x 3,072 bf16, 786,432 bytes): each block copies one chunk of
// up to kChunkVec 16-byte vectors (16 KB) inside one range, reading its id
// once.  Chunks are numbered chunk-major: the blocks in flight copy the
// same chunk of many ids, so each distinct source chunk is read from device
// memory about once and from L2 by every other id that names it (the
// FFN path's 2,048 ids name 64 ranges, 50 MB, as large as L2; numbered
// id-major, the copy was no faster than the word copy).  A thread issues
// kUnroll independent 16-byte loads (ld.global.nc) before their stores; the
// stores are streaming (st.global.cs), so the output, far larger than L2,
// does not evict the source chunks from it.  The inner loop has no divide;
// a range's last chunk, shorter than the others, takes a strided loop.
//
// Ids are clipped in the kernels and the stream may have any length, so
// the caller pads nothing and trims nothing.  The result is a copy,
// bit-exact.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 1024;
constexpr int kUnroll = 4;                      // 16-byte loads in flight
constexpr int kChunkVec = kThreads * kUnroll;   // vectors a block copies
constexpr long long kMaxBlocks = 132LL * 512;   // grid-stride beyond this

__global__ void gather_rows_kernel(const int* __restrict__ x,
                                   const int* __restrict__ idx,
                                   int* __restrict__ out, long long n_x_rows,
                                   int row_words, long long n_idx,
                                   int tile_rows) {
  for (long long row0 = (long long)blockIdx.x * tile_rows; row0 < n_idx;
       row0 += (long long)gridDim.x * tile_rows) {
    const int rows = n_idx - row0 < tile_rows ? (int)(n_idx - row0) : tile_rows;
    const int words = rows * row_words;
    for (int t = threadIdx.x; t < words; t += kThreads) {
      const int i = t / row_words;
      const int w = t - i * row_words;
      const int id = __ldg(idx + row0 + i);
      const long long r = id < 0 ? 0 : (id >= n_x_rows ? n_x_rows - 1 : id);
      out[(row0 + i) * row_words + w] = __ldg(x + r * row_words + w);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ranged_gather_v16_kernel(const uint4* __restrict__ x,
                         const int* __restrict__ idx, uint4* __restrict__ out,
                         long long n_blocks, long long range_vec,
                         long long n_idx, long long n_chunks) {
  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long c = chunk / n_idx;  // chunk-major: chunk c of id i
    const long long i = chunk - c * n_idx;
    const long long v0 = c * kChunkVec;
    const int id = __ldg(idx + i);
    const long long r = id < 0 ? 0 : (id >= n_blocks ? n_blocks - 1 : id);
    const uint4* src = x + r * range_vec + v0;
    uint4* dst = out + i * range_vec + v0;
    if (range_vec - v0 >= kChunkVec) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldg(src + threadIdx.x + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        __stcs(dst + threadIdx.x + u * kThreads, v[u]);
    } else {
      const int n = (int)(range_vec - v0);
      for (int e = threadIdx.x; e < n; e += kThreads)
        __stcs(dst + e, __ldg(src + e));
    }
  }
}

}  // namespace

// x: (n_x_rows, row_words) 4-byte words; idx: (n_idx,) int32;
// out: (n_idx, row_words).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a row too long to index with an int tile.
extern "C" int repro_gather_rows(const void* x, const void* idx, void* out,
                                 long long n_x_rows, long long row_words,
                                 long long n_idx, void* stream) {
  if (row_words > INT_MAX - kTileWords)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx > 0 && row_words > 0) {
    const int words = static_cast<int>(row_words);
    const int tile_rows = words >= kTileWords ? 1 : kTileWords / words;
    long long blocks = (n_idx + tile_rows - 1) / tile_rows;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond this
    gather_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<const int*>(idx),
        static_cast<int*>(out), n_x_rows, words, n_idx, tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ranged AIA gather: out[i*R:(i+1)*R, :] = x[clip(idx[i])*R : +R, :],
// with x viewed as (n_blocks, range_words) 4-byte words and one range per
// id.  v16 = 1 takes the 16-byte streaming copy (range_words % 4 == 0, x and
// out 16-byte aligned), v16 = 0 the row gather's word copy.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a range
// or pointers the route cannot take.
extern "C" int repro_aia_ranged_gather(const void* x, const void* idx,
                                       void* out, long long n_blocks,
                                       long long range_words, long long n_idx,
                                       int v16, void* stream) {
  if (!v16)
    return repro_gather_rows(x, idx, out, n_blocks, range_words, n_idx,
                             stream);
  if (range_words % 4
      || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
          & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx > 0 && range_words > 0) {
    const long long range_vec = range_words / 4;
    const long long per_range = (range_vec + kChunkVec - 1) / kChunkVec;
    const long long n_chunks = n_idx * per_range;
    const long long blocks = n_chunks < kMaxBlocks ? n_chunks : kMaxBlocks;
    ranged_gather_v16_kernel<<<(unsigned)blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(x), static_cast<const int*>(idx),
        static_cast<uint4*>(out), n_blocks, range_vec, n_idx, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
