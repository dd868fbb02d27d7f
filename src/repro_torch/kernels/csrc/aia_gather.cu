// AIA indirect row gather: out[i, :] = x[clip(idx[i], 0, n_x_rows - 1), :],
// for up to two planes of equal row count through one id stream.
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
// The row gather (repro_gather_planes; the SpGEMM executor gathers B's ELL
// index and value planes with one launch a chunk): a block takes a tile of
// rows, as many as fit in about kTileUnits copy units of the wider plane
// (one row when a row is longer), reads and clips the tile's ids once into
// shared memory, and copies the tile's rows of each plane.  Its threads
// take a plane's units in order, kUnroll loads in flight before their
// stores, so a warp's stores are contiguous and its loads contiguous
// within each source row.  The copy unit is the widest of 16, 8, 4, 2 and
// 1 bytes that divides every plane's row bytes and the address of every x
// and out (the wrapper picks it): B's ELL rows on the Table II matrices
// are 56 bytes (RoadTX: 8-byte units) and 2,364 bytes (p2p-Gnutella04:
// 4-byte units), not multiples of 16, and an odd-width bf16 plane takes
// 2-byte units.  Offsets into x and out are 64-bit, so one code path
// serves every size; only the unit within a tile is 32-bit.  The grid is
// capped and strides beyond the cap.  The single-plane 4-byte entry,
// repro_gather_rows, is the one-plane case of the same kernel.
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
constexpr int kTileUnits = 1024;                // copy units a tile's plane
constexpr int kUnroll = 4;                      // loads in flight a thread
constexpr int kChunkVec = kThreads * kUnroll;   // vectors a block copies
constexpr long long kMaxBlocks = 132LL * 512;   // grid-stride beyond this
constexpr long long kMaxRowBlocks = 132LL * 16;  // the same, row gather

// Copy a tile's rows of one plane: out[t] = x[rows_s[t / units] * units +
// t % units] for t < rows * units, in units of U.
template <typename U>
__device__ __forceinline__ void copy_rows(const U* __restrict__ x,
                                          U* __restrict__ out,
                                          const int* rows_s, int rows,
                                          int units) {
  const int n = rows * units;
  for (int t0 = threadIdx.x; t0 < n; t0 += kThreads * kUnroll) {
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t < n) {
        const int i = t / units;
        v[u] = __ldg(x + (long long)rows_s[i] * units + (t - i * units));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t < n) out[t] = v[u];
    }
  }
}

// units1 == 0: one plane.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_planes_kernel(const int* __restrict__ idx, long long n_idx,
                     long long n_x_rows, int tile_rows,
                     const U* __restrict__ x0, U* __restrict__ out0,
                     int units0, const U* __restrict__ x1,
                     U* __restrict__ out1, int units1) {
  __shared__ int rows_s[kTileUnits];
  for (long long row0 = (long long)blockIdx.x * tile_rows; row0 < n_idx;
       row0 += (long long)gridDim.x * tile_rows) {
    const int rows = n_idx - row0 < tile_rows ? (int)(n_idx - row0) : tile_rows;
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const int id = __ldg(idx + row0 + i);
      rows_s[i] = id < 0 ? 0 : (id >= n_x_rows ? (int)(n_x_rows - 1) : id);
    }
    __syncthreads();
    copy_rows(x0, out0 + row0 * units0, rows_s, rows, units0);
    if (units1) copy_rows(x1, out1 + row0 * units1, rows_s, rows, units1);
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

template <typename U>
int launch_planes(const void* idx, long long n_idx, long long n_x_rows,
                  const void* x0, void* out0, long long units0,
                  const void* x1, void* out1, long long units1,
                  cudaStream_t stream) {
  const long long units = units0 > units1 ? units0 : units1;
  const int tile_rows = units >= kTileUnits ? 1 : (int)(kTileUnits / units);
  long long blocks = (n_idx + tile_rows - 1) / tile_rows;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  gather_planes_kernel<U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(idx), n_idx, n_x_rows, tile_rows,
      static_cast<const U*>(x0), static_cast<U*>(out0), (int)units0,
      static_cast<const U*>(x1), static_cast<U*>(out1), (int)units1);
  return static_cast<int>(cudaGetLastError());
}

// One id stream, up to two planes: out_p[i, :] = x_p[clip(idx[i]), :] for
// x_p (n_x_rows, row_bytes_p bytes), out_p (n_idx, row_bytes_p bytes);
// x1 = out1 = NULL and row_bytes1 = 0 for one plane.  unit (16, 8, 4, 2 or
// 1) must divide every row's bytes and every plane's addresses.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a unit,
// a row or an address the kernel cannot take.
extern "C" int repro_gather_planes(const void* idx, long long n_idx,
                                   long long n_x_rows, const void* x0,
                                   void* out0, long long row_bytes0,
                                   const void* x1, void* out1,
                                   long long row_bytes1, int unit,
                                   void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x0)
                         | reinterpret_cast<uintptr_t>(out0)
                         | reinterpret_cast<uintptr_t>(x1)
                         | reinterpret_cast<uintptr_t>(out1);
  if ((unit != 16 && unit != 8 && unit != 4 && unit != 2 && unit != 1)
      || row_bytes0 <= 0 || row_bytes1 < 0
      || (row_bytes1 > 0) != (x1 != nullptr)
      || row_bytes0 % unit || row_bytes1 % unit || addr % unit
      || row_bytes0 / unit > INT_MAX - kTileUnits
      || row_bytes1 / unit > INT_MAX - kTileUnits || n_x_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx <= 0) return static_cast<int>(cudaGetLastError());
  const long long u0 = row_bytes0 / unit, u1 = row_bytes1 / unit;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16:
      return launch_planes<uint4>(idx, n_idx, n_x_rows, x0, out0, u0, x1,
                                  out1, u1, s);
    case 8:
      return launch_planes<uint2>(idx, n_idx, n_x_rows, x0, out0, u0, x1,
                                  out1, u1, s);
    case 4:
      return launch_planes<unsigned int>(idx, n_idx, n_x_rows, x0, out0, u0,
                                         x1, out1, u1, s);
    case 2:
      return launch_planes<unsigned short>(idx, n_idx, n_x_rows, x0, out0,
                                           u0, x1, out1, u1, s);
    default:
      return launch_planes<unsigned char>(idx, n_idx, n_x_rows, x0, out0, u0,
                                          x1, out1, u1, s);
  }
}

// One plane of 4-byte words: x (n_x_rows, row_words), idx (n_idx,) int32,
// out (n_idx, row_words).  The ranged gather's word copy.
extern "C" int repro_gather_rows(const void* x, const void* idx, void* out,
                                 long long n_x_rows, long long row_words,
                                 long long n_idx, void* stream) {
  if (n_idx <= 0 || row_words <= 0)
    return static_cast<int>(cudaGetLastError());
  return repro_gather_planes(idx, n_idx, n_x_rows, x, out, row_words * 4,
                             nullptr, nullptr, 0, 4, stream);
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
