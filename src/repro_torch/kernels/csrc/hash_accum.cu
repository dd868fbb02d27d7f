// Algorithm 4 (InsertIntoTable / AddInTable): one linear-probing table per
// output row, filled from the row's intermediate-product stream in order.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_accum.py:hash_accumulate
// (_hash_kernel: one grid step per row, the table in VMEM scratch, the
// stream consumed by the scalar core).
//
// What bounds it on an H100: latency, not bytes or operations.  The bytes
// the function must move are the keys and values read once (8 B per stream
// slot) and the table written once (8 B per table slot), which at 3.35 TB/s
// is microseconds; but each insert is a chain of dependent loads (key,
// probed slot, value) that one thread must finish before the next insert,
// because the sum of a key is taken in stream order.
//
// Design: one thread per row consumes the row's stream in stream order,
// with the row's table kept in the output buffers in global memory.  One
// code path serves every Table-I capacity, from group 0's 64 slots to group
// 3's next_pow2(max IP).  A block of 32 rows first resets its rows' tables
// together (coalesced stores), then each thread inserts its own row.  Every
// key's sum is taken in the same order as in the reference's scan engine
// and Pallas kernel, starting from 0.0f, with __fadd_rn (no contraction),
// so the table is bit-identical: the same slots, sums and count.
// Shared-memory tables for groups 0-2 and warp-parallel inserts are later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = -1;
constexpr int kRowsPerBlock = 32;
constexpr unsigned kMultiplier = 2654435761u;

__global__ void hash_accumulate_kernel(const int* __restrict__ keys,
                                       const float* __restrict__ vals,
                                       int* __restrict__ cols,
                                       float* __restrict__ out,
                                       int* __restrict__ cnt, long long rows,
                                       long long ip_cap, long long table_cap) {
  const long long row0 = (long long)blockIdx.x * kRowsPerBlock;
  const long long block_rows =
      rows - row0 < kRowsPerBlock ? rows - row0 : kRowsPerBlock;
  // Reset this block's tables: EMPTY keys, zero sums.
  const long long cells = block_rows * table_cap;
  int* block_cols = cols + row0 * table_cap;
  float* block_out = out + row0 * table_cap;
  for (long long t = threadIdx.x; t < cells; t += blockDim.x) {
    block_cols[t] = kEmpty;
    block_out[t] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x >= block_rows) return;

  const long long row = row0 + threadIdx.x;
  const int* k = keys + row * ip_cap;
  const float* v = vals + row * ip_cap;
  int* tk = cols + row * table_cap;
  float* tv = out + row * table_cap;
  const unsigned cap = static_cast<unsigned>(table_cap);
  int count = 0;
  for (long long i = 0; i < ip_cap; ++i) {
    const int key = k[i];
    if (key < 0) continue;  // padding
    const float val = v[i];
    unsigned pos = (static_cast<unsigned>(key) * kMultiplier) % cap;
    for (unsigned probe = 0; probe < cap; ++probe) {
      const int slot = tk[pos];
      if (slot == key || slot == kEmpty) {
        if (slot == kEmpty) {
          tk[pos] = key;
          ++count;
        }
        tv[pos] = __fadd_rn(tv[pos], val);
        break;
      }
      pos = pos + 1 == cap ? 0 : pos + 1;
    }
  }
  cnt[row] = count;
}

}  // namespace

// keys, vals: (rows, ip_cap) int32 / float32; cols, out: (rows, table_cap)
// int32 / float32 (written in full); cnt: (rows,) int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_hash_accumulate(const void* keys, const void* vals,
                                     void* cols, void* out, void* cnt,
                                     long long rows, long long ip_cap,
                                     long long table_cap, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
    hash_accumulate_kernel<<<(unsigned)blocks, kRowsPerBlock, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(keys), static_cast<const float*>(vals),
        static_cast<int*>(cols), static_cast<float*>(out),
        static_cast<int*>(cnt), rows, ip_cap, table_cap);
  }
  return static_cast<int>(cudaGetLastError());
}
