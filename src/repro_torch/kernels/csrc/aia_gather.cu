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
// 2-byte units.  Each plane's rows may lie a pitch apart (a column slice
// of a wider matrix: csr_spmm's X), so a view with unit inner stride is
// gathered without a copy; the unit divides the pitch too.  Offsets into x
// and out are 64-bit, so one code path serves every size; only the unit
// within a tile is 32-bit.  The grid is capped and strides beyond the cap.
//
// The ranged gather's other routes run the same kernel with each id naming
// an R-row range: output row i * R + t is source row clip(idx[i]) * R + t,
// so a strided x, a range of odd bytes and an unaligned x copy in the
// widest unit that divides a row's bytes, its pitch and both addresses
// (4 bytes: "words"; 2: "u16"; 1: "bytes"; 8 and 16 where they divide but
// "v16" does not apply).
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

// Copy a tile's rows of one plane: out[t] = x[rows_s[t / units] * pitch +
// t % units] for t < rows * units, in units of U (pitch: x's row stride in
// units, >= units).
template <typename U>
__device__ __forceinline__ void copy_rows(const U* __restrict__ x,
                                          U* __restrict__ out,
                                          const long long* rows_s, int rows,
                                          int units, long long pitch) {
  const int n = rows * units;
  for (int t0 = threadIdx.x; t0 < n; t0 += kThreads * kUnroll) {
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t < n) {
        const int i = t / units;
        v[u] = __ldg(x + rows_s[i] * pitch + (t - i * units));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kThreads;
      if (t < n) out[t] = v[u];
    }
  }
}

// Output row o (of n_idx * r) is source row clip(idx[o / r]) * r + o % r:
// r = 1 is the row gather, r > 1 a ranged gather of r-row ranges.
// units1 == 0: one plane.
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_planes_kernel(const int* __restrict__ idx, long long n_out,
                     long long n_ranges, long long r, int tile_rows,
                     const U* __restrict__ x0, U* __restrict__ out0,
                     int units0, long long pitch0, const U* __restrict__ x1,
                     U* __restrict__ out1, int units1, long long pitch1) {
  __shared__ long long rows_s[kTileUnits];
  for (long long row0 = (long long)blockIdx.x * tile_rows; row0 < n_out;
       row0 += (long long)gridDim.x * tile_rows) {
    const int rows = n_out - row0 < tile_rows ? (int)(n_out - row0) : tile_rows;
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const long long o = row0 + i;
      const long long j = r == 1 ? o : o / r;
      const int id = __ldg(idx + j);
      const long long c = id < 0 ? 0 : (id >= n_ranges ? n_ranges - 1 : id);
      rows_s[i] = c * r + (o - j * r);
    }
    __syncthreads();
    copy_rows(x0, out0 + row0 * units0, rows_s, rows, units0, pitch0);
    if (units1)
      copy_rows(x1, out1 + row0 * units1, rows_s, rows, units1, pitch1);
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

template <typename U>
int launch_planes(const void* idx, long long n_out, long long n_ranges,
                  long long r, const void* x0, void* out0, long long units0,
                  long long pitch0, const void* x1, void* out1,
                  long long units1, long long pitch1, cudaStream_t stream) {
  const long long units = units0 > units1 ? units0 : units1;
  const int tile_rows = units >= kTileUnits ? 1 : (int)(kTileUnits / units);
  long long blocks = (n_out + tile_rows - 1) / tile_rows;
  if (blocks > kMaxRowBlocks) blocks = kMaxRowBlocks;
  gather_planes_kernel<U><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(idx), n_out, n_ranges, r, tile_rows,
      static_cast<const U*>(x0), static_cast<U*>(out0), (int)units0, pitch0,
      static_cast<const U*>(x1), static_cast<U*>(out1), (int)units1, pitch1);
  return static_cast<int>(cudaGetLastError());
}

// n_idx ids, each naming a range of r rows of up to two planes: out_p row
// i * r + t = x_p row clip(idx[i], 0, n_ranges - 1) * r + t, for x_p of
// n_ranges * r rows of row_bytes_p bytes, pitch_p bytes apart (pitch_p >=
// row_bytes_p: a view with unit inner stride), out_p (n_idx * r rows,
// row_bytes_p bytes, contiguous); x1 = out1 = NULL and row_bytes1 = 0 for
// one plane.  unit (16, 8, 4, 2 or 1) must divide every row's bytes and
// pitch and every plane's addresses.
int gather(const void* idx, long long n_idx, long long n_ranges, long long r,
           const void* x0, void* out0, long long row_bytes0,
           long long pitch0, const void* x1, void* out1,
           long long row_bytes1, long long pitch1, int unit,
           cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x0)
                         | reinterpret_cast<uintptr_t>(out0)
                         | reinterpret_cast<uintptr_t>(x1)
                         | reinterpret_cast<uintptr_t>(out1);
  if ((unit != 16 && unit != 8 && unit != 4 && unit != 2 && unit != 1)
      || row_bytes0 <= 0 || row_bytes1 < 0 || r < 1
      || (row_bytes1 > 0) != (x1 != nullptr)
      || pitch0 < row_bytes0 || (row_bytes1 > 0 && pitch1 < row_bytes1)
      || row_bytes0 % unit || row_bytes1 % unit || pitch0 % unit
      || (row_bytes1 > 0 && pitch1 % unit) || addr % unit
      || row_bytes0 / unit > INT_MAX - kTileUnits
      || row_bytes1 / unit > INT_MAX - kTileUnits || n_ranges <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx <= 0) return static_cast<int>(cudaGetLastError());
  const long long u0 = row_bytes0 / unit, u1 = row_bytes1 / unit;
  const long long p0 = pitch0 / unit, p1 = row_bytes1 > 0 ? pitch1 / unit : 0;
  const long long n_out = n_idx * r;
  switch (unit) {
    case 16:
      return launch_planes<uint4>(idx, n_out, n_ranges, r, x0, out0, u0, p0,
                                  x1, out1, u1, p1, s);
    case 8:
      return launch_planes<uint2>(idx, n_out, n_ranges, r, x0, out0, u0, p0,
                                  x1, out1, u1, p1, s);
    case 4:
      return launch_planes<unsigned int>(idx, n_out, n_ranges, r, x0, out0,
                                         u0, p0, x1, out1, u1, p1, s);
    case 2:
      return launch_planes<unsigned short>(idx, n_out, n_ranges, r, x0, out0,
                                           u0, p0, x1, out1, u1, p1, s);
    default:
      return launch_planes<unsigned char>(idx, n_out, n_ranges, r, x0, out0,
                                          u0, p0, x1, out1, u1, p1, s);
  }
}

}  // namespace

// One id stream, up to two planes: out_p[i, :] = x_p[clip(idx[i]), :] for
// x_p (n_x_rows rows of row_bytes_p bytes, pitch_p bytes apart), out_p
// (n_idx, row_bytes_p bytes); x1 = out1 = NULL and row_bytes1 = 0 for one
// plane.  unit (16, 8, 4, 2 or 1) must divide every row's bytes and pitch
// and every plane's addresses.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a unit, a row, a pitch or an address
// the kernel cannot take.
extern "C" int repro_gather_planes(const void* idx, long long n_idx,
                                   long long n_x_rows, const void* x0,
                                   void* out0, long long row_bytes0,
                                   long long pitch0, const void* x1,
                                   void* out1, long long row_bytes1,
                                   long long pitch1, int unit, void* stream) {
  return gather(idx, n_idx, n_x_rows, 1, x0, out0, row_bytes0, pitch0, x1,
                out1, row_bytes1, pitch1, unit,
                static_cast<cudaStream_t>(stream));
}

// The ranged AIA gather: out[i*R:(i+1)*R, :] = x[clip(idx[i])*R : +R, :]
// for x of n_blocks * R rows of row_bytes bytes, pitch bytes apart.  v16 = 1
// takes the 16-byte streaming copy of whole ranges (a contiguous x, pitch
// == row_bytes, R * row_bytes a multiple of 16, x and out 16-byte
// aligned); v16 = 0 the row gather's copy in `unit`-byte units (16, 8, 4,
// 2 or 1, dividing row_bytes, pitch and both addresses), one R-row range
// an id.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a range, pitch or pointers the route cannot
// take.
extern "C" int repro_aia_ranged_gather(const void* x, const void* idx,
                                       void* out, long long n_blocks,
                                       long long r, long long row_bytes,
                                       long long pitch, long long n_idx,
                                       int unit, int v16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!v16) {
    if (n_idx <= 0 || row_bytes <= 0)
      return static_cast<int>(cudaGetLastError());
    return gather(idx, n_idx, n_blocks, r, x, out, row_bytes, pitch, nullptr,
                  nullptr, 0, 0, unit, s);
  }
  const long long range_bytes = r * row_bytes;
  if (pitch != row_bytes || range_bytes % 16
      || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out))
          & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_idx > 0 && range_bytes > 0) {
    const long long range_vec = range_bytes / 16;
    const long long per_range = (range_vec + kChunkVec - 1) / kChunkVec;
    const long long n_chunks = n_idx * per_range;
    const long long blocks = n_chunks < kMaxBlocks ? n_chunks : kMaxBlocks;
    ranged_gather_v16_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<const int*>(idx),
        static_cast<uint4*>(out), n_blocks, range_vec, n_idx, n_chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
