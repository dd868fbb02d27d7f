// AIA indirect row gather: out[i, :] = x[clip(idx[i], 0, n_x_rows - 1), :].
//
// Replaces the Pallas TPU kernel repro/kernels/aia_gather.py:gather_rows
// (scalar-prefetched row ids drive one DMA descriptor per row) together with
// its wrapper gather_rows_any (clip, pad to 8 rows, trim).  A second entry
// point, repro_aia_ranged_gather, replaces aia_gather.py:aia_ranged_gather
// (the Fig. 2 ranged form, one BlockSpec DMA of R rows per id): a range of
// R rows of x is one row of the (n_blocks, R * row_words) view, so the same
// kernel copies it.
//
// What bounds it on an H100: bytes.  Each output row is written once; each
// distinct source row needs reading once, and each id once: at most
// 2 * n_idx * row_bytes + 4 * n_idx bytes at 3.35 TB/s.  There is no
// arithmetic to speak of.
//
// Design: a block copies a tile of whole rows, as many as fit in about 1024
// words (one row when a row is longer), and its threads take the tile's
// words in order, so a warp's stores are contiguous and its loads are
// contiguous within each source row.  A thread moves one 4-byte word: B's
// ELL rows (14 and 591 words on the Table II matrices) are not multiples of
// 16 bytes, so the source and destination rows do not share an alignment
// that a vector copy could use.  Offsets into x and out are 64-bit, so one
// code path serves every size; only the word within a tile is 32-bit.  Ids
// are clipped in the kernel and the stream may have any length, so the
// caller pads nothing and trims nothing.  The result is a copy, bit-exact.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 1024;

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
// id.  Bound by bytes like the row gather: each distinct range read once,
// every output range written once.
extern "C" int repro_aia_ranged_gather(const void* x, const void* idx,
                                       void* out, long long n_blocks,
                                       long long range_words, long long n_idx,
                                       void* stream) {
  return repro_gather_rows(x, idx, out, n_blocks, range_words, n_idx, stream);
}
