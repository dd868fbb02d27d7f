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
//   * Each segment's run of entries [lo, hi) is added left to right by one
//     thread (64-bit offsets: the sort engine's flattened ids pass 2^31 on
//     MCL's chunks).
//   * W == 1 (the sort engine, the column sums, MCL): a thread an entry.
//     The thread at a run's first entry (ids[i] != ids[i - 1]) finds the
//     run's end by galloping and sums the run; the output is zeroed first.
//     The work follows the entries, not the segments: most of the sort
//     engine's segments are empty (a row's out_cap is its chunk's largest
//     unique count), so a binary search a segment made MCL's default lane
//     on Economics many times slower than the atomics it replaces.
//   * W > 1 (csr_spmm's 256-byte rows of X and its gradient; every row a
//     segment): a warp a segment, its run found by two binary searches,
//     lane l holding columns l + 32 k (k < KC, the fewest of 1-4 that
//     cover the row, a template argument) of each 32 * KC-column slab, so
//     each entry's row is read coalesced.
//   * A run is one thread's chain of adds, so the longest run bounds a
//     launch.  The sort engine's overflow segments are the longest runs
//     (a row's padding: ~130 K slots on p2p's group 2, millions on MCL's
//     second expansion), and nobody reads them: `skip` leaves them out.
//     Other long runs (R-MAT rows of 10 K entries in csr_spmm) issue the
//     loads of 16 entries before their adds, so the chain waits on a
//     memory latency every 16 entries, not every entry.
//   * Every add is __fadd_rn / __dadd_rn: the compiler cannot contract it
//     into an FMA or reassociate it.  The kernel forms no product.
//   * bf16 and float16 values are summed in float32, each add rounded to
//     the value's type (dtypes::round_to), as the CPU's index_add_ and
//     XLA's scatter-add add them: the sum is the one a chain of adds in
//     that type gives, bit for bit.
//   * A batch of value sets (B, N, W) over one ids runs on grid.y, in
//     slices of at most 65,535 sets a launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 4;   // columns a lane holds at once (W > 1)
constexpr int kBatch = 16;    // entries whose loads are in flight at once
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

// The first i in [0, n) with ids[i] >= s, or n.
__device__ __forceinline__ long long lower_bound(const long long* ids,
                                                 long long n, long long s) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < s) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

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

// W > 1: segment s = blockIdx.x * kWarps + warp of value set b, a warp's
// lanes across the row: lane l adds columns w0 + l + 32 k, k < KC, of each
// 32 * KC-column slab, kBatch rows' loads in flight.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
segment_sum_wide(const long long* __restrict__ ids, const T* __restrict__ vals,
                 const long long* __restrict__ order, T* __restrict__ out,
                 long long n, long long n_out, long long width,
                 long long skip) {
  const long long s = static_cast<long long>(blockIdx.x) * kWarps
                      + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= n_out) return;
  const long long lo = lower_bound(ids, n, s);
  const long long hi = skip > 0 && s % skip == skip - 1
                           ? lo : lower_bound(ids, n, s + 1);
  const T* v = vals + static_cast<long long>(blockIdx.y) * n * width;
  T* o = out + (static_cast<long long>(blockIdx.y) * n_out + s) * width;
  for (long long w0 = 0; w0 < width; w0 += 32 * KC) {
    bool on[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) on[k] = w0 + lane + 32 * k < width;
    const T* col = v + w0 + lane;
    typename Sum<T>::A acc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = 0;
    long long i = lo;
    for (; i + kBatch <= hi; i += kBatch) {
      T x[kBatch][KC];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const T* row =
            col + (order != nullptr ? __ldg(order + i + u) : i + u) * width;
#pragma unroll
        for (int k = 0; k < KC; ++k)
          x[u][k] = on[k] ? __ldg(row + 32 * k) : T();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int k = 0; k < KC; ++k)
          if (on[k]) acc[k] = Sum<T>::add(acc[k], x[u][k]);
    }
    for (; i < hi; ++i) {
      const T* row = col + (order != nullptr ? __ldg(order + i) : i) * width;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (on[k]) acc[k] = Sum<T>::add(acc[k], __ldg(row + 32 * k));
    }
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (on[k]) o[w0 + lane + 32 * k] = store<T>(acc[k]);
  }
}

// The value sets [0, batch) in slices of at most kMaxBatch, one launch a
// slice (grid.y is a slice's sets).
template <typename T>
int launch(const long long* ids, const void* vals, const long long* order,
           void* out, long long n, long long n_out, long long width,
           long long skip, long long batch, cudaStream_t stream) {
  if (width == 1) {
    const cudaError_t err =
        cudaMemsetAsync(out, 0, sizeof(T) * batch * n_out, stream);
    if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  }
  for (long long b0 = 0; b0 < batch; b0 += kMaxBatch) {
    const T* v = static_cast<const T*>(vals) + b0 * n * width;
    T* o = static_cast<T*>(out) + b0 * n_out * width;
    const unsigned sets = static_cast<unsigned>(
        batch - b0 < kMaxBatch ? batch - b0 : kMaxBatch);
    if (width == 1) {
      const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                      sets);
      segment_sum_narrow<T><<<grid, kThreads, 0, stream>>>(ids, v, order, o,
                                                           n, n_out, skip);
    } else {
      const dim3 grid(static_cast<unsigned>((n_out + kWarps - 1) / kWarps),
                      sets);
      // columns a lane holds: as many as the row needs, at most kMaxCols
      switch (width <= 32 ? 1 : width <= 64 ? 2 : width <= 96 ? 3 : 4) {
        case 1:
          segment_sum_wide<T, 1><<<grid, kThreads, 0, stream>>>(
              ids, v, order, o, n, n_out, width, skip);
          break;
        case 2:
          segment_sum_wide<T, 2><<<grid, kThreads, 0, stream>>>(
              ids, v, order, o, n, n_out, width, skip);
          break;
        case 3:
          segment_sum_wide<T, 3><<<grid, kThreads, 0, stream>>>(
              ids, v, order, o, n, n_out, width, skip);
          break;
        default:
          segment_sum_wide<T, kMaxCols><<<grid, kThreads, 0, stream>>>(
              ids, v, order, o, n, n_out, width, skip);
      }
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids (n,) int64 non-decreasing; vals (batch, n, width) of the type `dtype`
// names (0 float32, 1 bfloat16, 2 float16, 3 float64); order (n,) int64 or
// NULL; skip >= 0 (0: every segment summed); out (batch, n_out, width) of
// vals' type, every element written (W == 1: zeroed by a memset on the
// stream, then each run's sum).  Returns cudaGetLastError() after the
// launches (nothing is launched when n_out is 0), or
// cudaErrorInvalidValue for a type or sizes the grid cannot take.
extern "C" int repro_segment_sum(const void* ids, const void* vals,
                                 const void* order, void* out, long long n,
                                 long long n_out, long long width,
                                 long long skip, long long batch, int dtype,
                                 void* stream) {
  if (n < 0 || n_out < 0 || width < 1 || skip < 0 || batch < 1
      || dtype < 0 || dtype > 3
      || (width == 1 ? (n + kThreads - 1) / kThreads
                     : (n_out + kWarps - 1) / kWarps) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const long long* i = static_cast<const long long*>(ids);
  const long long* p = static_cast<const long long*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(i, vals, p, out, n, n_out, width, skip,
                                   batch, s);
    case 2:
      return launch<__half>(i, vals, p, out, n, n_out, width, skip, batch, s);
    case 3:
      return launch<double>(i, vals, p, out, n, n_out, width, skip, batch, s);
    default:
      return launch<float>(i, vals, p, out, n, n_out, width, skip, batch, s);
  }
}
