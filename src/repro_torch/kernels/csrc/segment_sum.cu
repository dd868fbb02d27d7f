// Sorted segment sum in the reference's order of adds:
//   out[b, s, w] = ((0 + v[b, j0, w]) + v[b, j1, w]) + ...
// over the entries i0 < i1 < ... with ids[i] == s, where j = order[i] when a
// permutation `order` is given, else j = i; a segment with no entry is 0.
// With skip > 0, every segment s with s % skip == skip - 1 is 0 and is not
// summed: the sort engine's rows of skip segments end in an overflow
// segment (padding and truncated slots) that the caller drops.
//
// Replaces no TPU kernel.  The reference's floating-point segment sums are
// XLA's `.at[ids].add` (src/repro/core/phases.py:356, the sort engine;
// src/repro/sparse/ops.py:45, :83, :103, :133, the CSR primitives), which
// add each output's updates one at a time in update order.  CUDA's
// `index_add_` and `scatter_add_` add with atomics, in an order that
// changes from run to run; this kernel adds in the reference's order, so
// the sort engine, the CSR primitives and MCL give the reference's bits on
// the card, and the same bits on every run.
//
// What bounds it on an H100: bytes.  Every id (8 B) is read once, the
// order entry (8 B, where one is given) and the value of every summed entry
// once, and every output written once; there is one add a summed value.
//
// Design: no atomics and no cross-thread sum, so nothing can reorder an add.
// Each column of each segment is one thread's chain of adds, left to right.
//   * W == 1 (the sort engine, the column sums, MCL): a thread an entry.
//     The thread at a run's first entry (ids[i] != ids[i - 1]) finds the
//     run's end by galloping and sums the run; the output is zeroed first.
//     The work follows the entries, not the segments: most of the sort
//     engine's segments are empty (a row's out_cap is its chunk's largest
//     unique count), so a binary search a segment made MCL's default lane
//     on Economics many times slower than the atomics it replaces.
//     The sort engine's overflow segments are its longest runs (~130 K
//     slots on p2p's group 2, millions on MCL's second expansion); `skip`
//     leaves them out.
//   * W > 1 (csr_spmm's rows of X and its gradient, the MoE gathers'
//     backward; every row a segment), three launches after a memset:
//       1. mark_runs, a thread an entry: the first entry of a run writes
//          the run's start lo[s], the last its end hi[s] (a segment
//          without entries keeps the memset's lo = hi = 0), and the last
//          entry of a run longer than kLongRun (ids[i - kLongRun] == s)
//          appends s to a list of long runs.  No thread searches.
//       2. segment_sum_rows: `lanes` lanes a segment (the fewest powers of
//          two that cover the row's vectors, at most 32; so 2 segments a
//          warp at 64 float32 columns, 4 at 64 bf16 ones), each lane
//          holding one 16-byte vector of VEC columns (VEC = 1 where the
//          row is not a whole number of aligned 16-byte vectors) and
//          loading up to kVecBatch (kBatch) rows of its run before it adds
//          them, so a short run's loads are in flight together.  A long
//          run is left to launch 3.
//       3. segment_sum_long, a fixed grid of blocks walking the list, a
//          block a long run (R-MAT rows of 10 K entries in csr_spmm): all
//          its threads stage tiles of the run's rows into a kStages-deep
//          shared-memory ring with cp.async 16-byte copies, while one
//          thread a column (a pair of 16-bit columns) adds each tile's
//          rows from shared memory in order.  A long run's chain then
//          waits on shared memory, not on a memory latency every batch of
//          rows.
//     The list's order varies from run to run (an atomic counter appends
//     to it), but which block sums a run changes no add: every run is
//     summed by one thread a column, in entry order, on either route.
//   * Every add is __fadd_rn / __dadd_rn: the compiler cannot contract it
//     into an FMA or reassociate it.  The kernel forms no product.
//   * bf16 and float16 values are summed in float32, each add rounded to
//     the value's type (dtypes::round_to), as the CPU's index_add_ and
//     XLA's scatter-add add them: the sum is the one a chain of adds in
//     that type gives, bit for bit.  The W > 1 kernels add them with the
//     type's native add instead, which gives the same bits (Chains).
//   * A batch of value sets (B, N, W) over one ids runs on grid.y, in
//     slices of at most 65,535 sets a launch; the runs are marked once.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 16;     // W == 1 and VEC == 1: entries in flight
constexpr int kVecBatch = 8;   // 16-byte vectors in flight a lane
constexpr int kLongRun = 256;  // runs longer than this take the block route
constexpr int kStages = 3;     // the block route's ring of row tiles
constexpr int kStageBytes = 16384;  //   each tile's bytes
constexpr int kMaxBatch = 65535;  // grid.y of one launch

// How a value of type T is summed: in A (float, or double for double),
// every add rounded to T.
template <typename T>
struct Sum {
  using A = float;
  static __device__ __forceinline__ A add(A a, T b) {
    return dtypes::round_to<T>(__fadd_rn(a, dtypes::to_f(b)));
  }
};
template <>
struct Sum<float> {
  using A = float;
  static __device__ __forceinline__ A add(A a, float b) {
    return __fadd_rn(a, b);
  }
};
template <>
struct Sum<double> {
  using A = double;
  static __device__ __forceinline__ A add(A a, double b) {
    return __dadd_rn(a, b);
  }
};
template <typename T>
__device__ __forceinline__ T store(typename Sum<T>::A a) {
  return dtypes::from_f<T>(a);
}
template <>
__device__ __forceinline__ double store<double>(double a) { return a; }

// The end of the run of id s that starts at entry i: the first j > i with
// ids[j] != s, or n.  Galloping from i, then a binary search, so a run of
// length L costs about 2 log2(L) loads (one for a run of one).
__device__ __forceinline__ long long run_end(const long long* ids, long long n,
                                             long long i, long long s) {
  long long lo = i + 1, hi = n, step = 1;  // ids[lo - 1] == s
  while (true) {
    const long long probe = i + step;
    if (probe >= n || __ldg(ids + probe) != s) {
      hi = probe < n ? probe : n;
      break;
    }
    lo = probe + 1;
    step <<= 1;
  }
  while (lo < hi) {  // ids[lo - 1] == s, and hi == n or ids[hi] != s
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) == s) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The run [lo, hi) of value set v (through order where given), added left
// to right from +0.0.  The loads of kBatch entries are issued before their
// adds: an add waits on its load, so one load at a time would cost a
// memory latency an entry on a long run.
template <typename T>
__device__ __forceinline__ typename Sum<T>::A sum_run(
    const T* __restrict__ v, const long long* __restrict__ order,
    long long lo, long long hi) {
  typename Sum<T>::A acc = 0;
  long long i = lo;
  for (; i + kBatch <= hi; i += kBatch) {
    T x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      x[u] = __ldg(v + (order != nullptr ? __ldg(order + i + u) : i + u));
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = Sum<T>::add(acc, x[u]);
  }
  for (; i < hi; ++i)
    acc = Sum<T>::add(acc,
                      __ldg(v + (order != nullptr ? __ldg(order + i) : i)));
  return acc;
}

// W == 1: entry i = blockIdx.x * kThreads + threadIdx.x of value set b; the
// first entry of a run writes the run's sum (the rest stay as zeroed).
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_narrow(const long long* __restrict__ ids,
                   const T* __restrict__ vals,
                   const long long* __restrict__ order, T* __restrict__ out,
                   long long n, long long n_out, long long skip) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  const long long s = __ldg(ids + i);
  if ((i > 0 && __ldg(ids + i - 1) == s) || s < 0 || s >= n_out
      || (skip > 0 && s % skip == skip - 1))
    return;
  out[static_cast<long long>(blockIdx.y) * n_out + s] = store<T>(
      sum_run(vals + static_cast<long long>(blockIdx.y) * n, order, i,
              run_end(ids, n, i, s)));
}

// ---------------------------------------------------------------------------
// W > 1
// ---------------------------------------------------------------------------

// VEC consecutive values of T, loaded and stored as one access of their
// bytes (16, 8, 4 or 2).
template <typename T, int VEC>
struct Vec {
  T v[VEC];
};

template <int B> struct Raw;
template <> struct Raw<16> { using U = uint4; };
template <> struct Raw<8> { using U = uint2; };
template <> struct Raw<4> { using U = uint32_t; };
template <> struct Raw<2> { using U = uint16_t; };

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  using U = typename Raw<VEC * sizeof(T)>::U;
  const U r = __ldg(reinterpret_cast<const U*>(p));
  Vec<T, VEC> x;
  memcpy(&x, &r, sizeof(U));
  return x;
}

// The same from shared memory.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_shared(const unsigned char* p) {
  using U = typename Raw<VEC * sizeof(T)>::U;
  const U r = *reinterpret_cast<const U*>(p);
  Vec<T, VEC> x;
  memcpy(&x, &r, sizeof(U));
  return x;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, VEC>& x) {
  using U = typename Raw<VEC * sizeof(T)>::U;
  U r;
  memcpy(&r, &x, sizeof(U));
  *reinterpret_cast<U*>(p) = r;
}

// The packed pair of a 16-bit type, and its add: add.rn.bf16x2 /
// add.rn.f16x2, each lane the exact sum rounded once.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using P = __nv_bfloat162;
  static __device__ __forceinline__ P zero() {
    return __float2bfloat162_rn(0.0f);
  }
};
template <> struct Pair<__half> {
  using P = __half2;
  static __device__ __forceinline__ P zero() { return __float2half2_rn(0.0f); }
};

// The chains of adds of VEC consecutive columns, one a column, from +0.0.
// float and double: Sum's adds.  bf16 and float16: each chain kept in its
// own type and added by the type's native add, two columns an instruction
// (one for VEC = 1).  That is Sum's result bit for bit: the float32 sum of
// two values of a 16-bit type (p significant bits, 8 or 11) is exact unless
// their exponents differ by more than 23 - p, and then the smaller is below
// 2^-(p+1) of the larger, so neither the exact sum nor the float32 one
// reaches the larger's rounding midpoint (their distance to it exceeds
// float32's rounding error): both round to the same 16-bit value.  The
// chain's latency is one native add, not a float32 add, a rounding and a
// conversion back.
template <typename T, int VEC, bool HALF = sizeof(T) == 2>
struct Chains {
  typename Sum<T>::A a[VEC];
  __device__ __forceinline__ Chains() {
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = 0;
  }
  __device__ __forceinline__ void add(const Vec<T, VEC>& x) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) a[e] = Sum<T>::add(a[e], x.v[e]);
  }
  __device__ __forceinline__ Vec<T, VEC> result() const {
    Vec<T, VEC> y;
#pragma unroll
    for (int e = 0; e < VEC; ++e) y.v[e] = store<T>(a[e]);
    return y;
  }
};

template <typename T, int VEC>
struct Chains<T, VEC, true> {
  using P = typename Pair<T>::P;
  static constexpr int kP = VEC / 2;  // packed pairs (VEC even)
  P a[kP > 0 ? kP : 1];
  T one;  // VEC == 1
  __device__ __forceinline__ Chains() : one(dtypes::from_f<T>(0.0f)) {
#pragma unroll
    for (int e = 0; e < (kP > 0 ? kP : 1); ++e) a[e] = Pair<T>::zero();
  }
  __device__ __forceinline__ void add(const Vec<T, VEC>& x) {
    if constexpr (VEC == 1) {
      one = __hadd(one, x.v[0]);
    } else {
      P y[kP];
      memcpy(y, &x, sizeof(y));
#pragma unroll
      for (int e = 0; e < kP; ++e) a[e] = __hadd2(a[e], y[e]);
    }
  }
  __device__ __forceinline__ Vec<T, VEC> result() const {
    Vec<T, VEC> y;
    if constexpr (VEC == 1) {
      y.v[0] = one;
    } else {
      memcpy(&y, a, sizeof(a));
    }
    return y;
  }
};

// 1. Entry i of ids: the first entry of a run writes lo[s] = i, the last
// hi[s] = i + 1; the last entry of a run longer than long_run (long_run >
// 0) appends s to list (list[0] counts, the runs follow).  Ids outside [0,
// n_out) and skipped segments mark nothing.
__global__ void __launch_bounds__(kThreads)
mark_runs(const long long* __restrict__ ids, long long n, long long n_out,
          long long skip, long long long_run, long long* __restrict__ lo,
          long long* __restrict__ hi, unsigned long long* __restrict__ list) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  const long long s = __ldg(ids + i);
  if (s < 0 || s >= n_out || (skip > 0 && s % skip == skip - 1)) return;
  if (i == 0 || __ldg(ids + i - 1) != s) lo[s] = i;
  if (i == n - 1 || __ldg(ids + i + 1) != s) {
    hi[s] = i + 1;
    if (long_run > 0 && i >= long_run && __ldg(ids + i - long_run) == s)
      list[1 + atomicAdd(list, 1ULL)] = static_cast<unsigned long long>(s);
  }
}

// 2. Segment s = (global warp) * (32 / lanes) + lane / lanes of value set
// blockIdx.y: its lane sub = lane % lanes adds vector columns sub, sub +
// lanes, ... of nvec = width / VEC, kVecBatch rows' loads in flight (kBatch
// for VEC == 1).  A run longer than long_run (> 0) is left to
// segment_sum_long; a skipped or empty segment gets zeros.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const long long* __restrict__ lo_of,
                 const long long* __restrict__ hi_of,
                 const T* __restrict__ vals,
                 const long long* __restrict__ order, T* __restrict__ out,
                 long long n, long long n_out, long long width,
                 long long skip, long long long_run, int lanes) {
  constexpr int kB = VEC == 1 ? kBatch : kVecBatch;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x) >> 5;
  const long long s = warp * (32 / lanes) + lane / lanes;
  const int sub = lane % lanes;
  if (s >= n_out) return;
  long long lo = lo_of[s], hi = hi_of[s];
  if (skip > 0 && s % skip == skip - 1) hi = lo;
  if (long_run > 0 && hi - lo > long_run) return;
  const T* v = vals + static_cast<long long>(blockIdx.y) * n * width;
  T* o = out + (static_cast<long long>(blockIdx.y) * n_out + s) * width;
  const long long nvec = width / VEC;
  for (long long c = sub; c < nvec; c += lanes) {
    const T* col = v + c * VEC;
    Chains<T, VEC> acc;
    for (long long i = lo; i < hi; i += kB) {
      const long long m = hi - i;
      Vec<T, VEC> x[kB];
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (u < m)
          x[u] = load_vec<T, VEC>(
              col + (order != nullptr ? __ldg(order + i + u) : i + u)
                        * width);
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (u < m) acc.add(x[u]);
    }
    store_vec<T, VEC>(o + c * VEC, acc.result());
  }
}

// 3. The long runs of list (list[0] of them), run li = blockIdx.x,
// blockIdx.x + gridDim.x, ..., of value set blockIdx.y.  For each slab of
// up to kThreads * kCols columns: tiles of kStageBytes / (the slab's row
// bytes) rows, copied by every thread in 16-byte pieces into a
// kStages-deep ring, the next kStages - 1 tiles in flight while thread t <
// slab / kCols adds columns kCols t .. kCols t + kCols - 1 of this tile's
// rows in order (kCols = 2 for a 16-bit type: one packed add a row).
// width * sizeof(T) is a multiple of 16.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_long(const long long* __restrict__ lo_of,
                 const long long* __restrict__ hi_of,
                 const unsigned long long* __restrict__ list,
                 const T* __restrict__ vals,
                 const long long* __restrict__ order, T* __restrict__ out,
                 long long n, long long n_out, long long width) {
  constexpr int kCols = sizeof(T) == 2 ? 2 : 1;  // columns a thread adds
  __shared__ __align__(16) unsigned char ring[kStages * kStageBytes];
  const int tid = threadIdx.x;
  const long long count = static_cast<long long>(list[0]);
  const T* v = vals + static_cast<long long>(blockIdx.y) * n * width;
  const uint32_t base = hopper::smem_addr(ring);
  for (long long li = blockIdx.x; li < count; li += gridDim.x) {
    const long long s = static_cast<long long>(list[1 + li]);
    const long long lo = lo_of[s], hi = hi_of[s];
    T* o = out + (static_cast<long long>(blockIdx.y) * n_out + s) * width;
    for (long long c0 = 0; c0 < width; c0 += kThreads * kCols) {
      const int slab = static_cast<int>(
          width - c0 < kThreads * kCols ? width - c0 : kThreads * kCols);
      const int row_bytes = slab * static_cast<int>(sizeof(T));
      const int pieces = row_bytes / 16;  // 16-byte copies a row
      const int tr = kStageBytes / row_bytes;
      const long long tiles = (hi - lo + tr - 1) / tr;
      auto load_tile = [&](long long t) {
        const uint32_t dst = base + static_cast<uint32_t>(t % kStages)
                                        * kStageBytes;
        const long long r0 = lo + t * tr;
        const int rows = static_cast<int>(hi - r0 < tr ? hi - r0 : tr);
        for (int c = tid; c < rows * pieces; c += kThreads) {
          const int r = c / pieces, pc = c - r * pieces;
          const long long i = r0 + r;
          const long long row = order != nullptr ? __ldg(order + i) : i;
          hopper::cp_async_16(dst + 16u * static_cast<uint32_t>(c),
                              v + row * width + c0 + pc * (16 / sizeof(T)),
                              16);
        }
      };
#pragma unroll
      for (int t = 0; t < kStages - 1; ++t) {
        if (t < tiles) load_tile(t);
        hopper::cp_async_commit();
      }
      Chains<T, kCols> acc;
      for (long long t = 0; t < tiles; ++t) {
        hopper::cp_async_wait<kStages - 2>();
        __syncthreads();  // tile t landed; tile t - 1's stage is consumed
        if (t + kStages - 1 < tiles) load_tile(t + kStages - 1);
        hopper::cp_async_commit();
        if (tid * kCols < slab) {
          const unsigned char* tile =
              ring + (t % kStages) * kStageBytes + tid * kCols * sizeof(T);
          const long long r0 = lo + t * tr;
          const int rows = static_cast<int>(hi - r0 < tr ? hi - r0 : tr);
#pragma unroll 8
          for (int r = 0; r < rows; ++r)
            acc.add(load_shared<T, kCols>(tile + r * row_bytes));
        }
      }
      hopper::cp_async_wait<0>();
      __syncthreads();  // the ring is free for the next slab or run
      if (tid * kCols < slab)
        store_vec<T, kCols>(o + c0 + tid * kCols, acc.result());
    }
  }
}

// The fixed grid of segment_sum_long: two blocks an SM.
int long_grid() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      return 0;
    blocks = 2 * sms;
  }
  return blocks;
}

// W > 1 on value sets [0, batch): the marking once, then both routes a
// slice of at most kMaxBatch sets.  VEC > 1 where every row is whole
// 16-byte vectors at 16-byte aligned addresses; the block route only then.
template <typename T, int VEC>
int launch_wide(const long long* ids, const void* vals,
                const long long* order, void* out, long long* work,
                long long n, long long n_out, long long width, long long skip,
                long long batch, cudaStream_t stream) {
  // the longest run the warp route sums; 0: no block route
  const long long long_run = VEC == 1 || n <= kLongRun ? 0 : kLongRun;
  long long* lo = work;
  long long* hi = work + n_out;
  unsigned long long* list =
      reinterpret_cast<unsigned long long*>(work + 2 * n_out);
  cudaError_t err = cudaMemsetAsync(
      work, 0, sizeof(long long) * (2 * n_out + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0)
    mark_runs<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                kThreads, 0, stream>>>(ids, n, n_out, skip, long_run, lo, hi,
                                       list);
  const long long nvec = width / VEC;
  int lanes = 1;
  while (lanes < 32 && lanes < nvec) lanes <<= 1;
  const long long per_block = (kThreads / 32) * (32 / lanes);
  const unsigned blocks =
      static_cast<unsigned>((n_out + per_block - 1) / per_block);
  const int long_blocks = long_run > 0 ? long_grid() : 0;
  if (long_run > 0 && long_blocks == 0)
    return static_cast<int>(cudaGetLastError());
  for (long long b0 = 0; b0 < batch; b0 += kMaxBatch) {
    const T* v = static_cast<const T*>(vals) + b0 * n * width;
    T* o = static_cast<T*>(out) + b0 * n_out * width;
    const unsigned sets = static_cast<unsigned>(
        batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch);
    segment_sum_rows<T, VEC><<<dim3(blocks, sets), kThreads, 0, stream>>>(
        lo, hi, v, order, o, n, n_out, width, skip, long_run, lanes);
    if (long_run > 0)
      segment_sum_long<T><<<dim3(static_cast<unsigned>(long_blocks), sets),
                             kThreads, 0, stream>>>(lo, hi, list, v, order, o,
                                                    n, n_out, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The value sets [0, batch) in slices of at most kMaxBatch, one launch a
// slice (grid.y is a slice's sets).
template <typename T>
int launch(const long long* ids, const void* vals, const long long* order,
           void* out, long long* work, long long n, long long n_out,
           long long width, long long skip, long long batch,
           cudaStream_t stream) {
  if (width > 1) {
    constexpr int kVec = 16 / sizeof(T);
    const bool whole = (width * sizeof(T)) % 16 == 0
                       && reinterpret_cast<uintptr_t>(vals) % 16 == 0
                       && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    return whole ? launch_wide<T, kVec>(ids, vals, order, out, work, n, n_out,
                                        width, skip, batch, stream)
                 : launch_wide<T, 1>(ids, vals, order, out, work, n, n_out,
                                     width, skip, batch, stream);
  }
  const cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(T) * batch * n_out, stream);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  for (long long b0 = 0; b0 < batch; b0 += kMaxBatch) {
    const T* v = static_cast<const T*>(vals) + b0 * n;
    T* o = static_cast<T*>(out) + b0 * n_out;
    const unsigned sets = static_cast<unsigned>(
        batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch);
    const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                    sets);
    segment_sum_narrow<T><<<grid, kThreads, 0, stream>>>(ids, v, order, o,
                                                         n, n_out, skip);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids (n,) int64 non-decreasing; vals (batch, n, width) of the type `dtype`
// names (0 float32, 1 bfloat16, 2 float16, 3 float64); order (n,) int64 or
// NULL; skip >= 0 (0: every segment summed); out (batch, n_out, width) of
// vals' type, every element written (W == 1: zeroed by a memset on the
// stream, then each run's sum).  work: W > 1, 2 n_out + 2 + n / (kLongRun
// + 1) int64 of scratch (each segment's run bounds, the long runs' count
// and their list); NULL for W == 1.  Returns cudaGetLastError()
// after the launches (nothing is launched when n_out is 0), or
// cudaErrorInvalidValue for a type or sizes the grid cannot take.
extern "C" int repro_segment_sum(const void* ids, const void* vals,
                                 const void* order, void* out, void* work,
                                 long long n, long long n_out,
                                 long long width, long long skip,
                                 long long batch, int dtype, void* stream) {
  if (n < 0 || n_out < 0 || width < 1 || skip < 0 || batch < 1
      || dtype < 0 || dtype > 3
      || (width > 1 && work == nullptr)
      || (n + kThreads - 1) / kThreads > 0x7fffffffLL
      || n_out / (kThreads / 32) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const long long* i = static_cast<const long long*>(ids);
  const long long* p = static_cast<const long long*>(order);
  long long* w = static_cast<long long*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(i, vals, p, out, w, n, n_out, width, skip,
                                   batch, s);
    case 2:
      return launch<__half>(i, vals, p, out, w, n, n_out, width, skip, batch,
                            s);
    case 3:
      return launch<double>(i, vals, p, out, w, n, n_out, width, skip, batch,
                            s);
    default:
      return launch<float>(i, vals, p, out, w, n, n_out, width, skip, batch,
                           s);
  }
}
