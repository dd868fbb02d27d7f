// Algorithm 4 (InsertIntoTable / AddInTable): one linear-probing table per
// output row, filled from the row's intermediate-product stream in order.
//
// Replaces the Pallas TPU kernel repro/kernels/hash_accum.py:hash_accumulate
// (_hash_kernel: one grid step per row, the table in VMEM scratch, the
// stream consumed by the scalar core).
//
// What bounds it on an H100: bytes, and the latency of the inserts.  The
// bytes the function must move are every key of the padded stream (4 B a
// slot), the value of each real product, and the table written once (8 B a
// slot).  On wide Table-I groups the stream is almost all padding (p2p's
// group 2: 976 rows x 131,793 slots, under 1% products), so the keys are
// the bytes; on narrow ones each row's inserts are a chain that the row's
// sum order fixes.
//
// Design: find the windows of 32 slots that hold a product in parallel,
// then insert them with one warp per row.
//   * window_mask_kernel: a warp reads 32 windows (1,024 slots) of a row,
//     a window a coalesced load, and sets bit q of the row's mask word
//     where window q holds a product (one __ballot_sync a window).  Every
//     key is read once, by as many warps as the card holds: the scan of
//     the padding runs at the memory's rate, not at one warp's.  A stream
//     of at most 1,024 slots skips this launch: the insert kernel's warp
//     finds its row's one word itself.
//   * hash_insert_kernel: a warp owns a row.  It reads the row's mask
//     words 32 at a time (a word a lane, the next 32 in flight) and copies
//     the keys and values of the windows they name into a ring of 16
//     windows in shared memory (cp.async, 4 bytes a lane), 15 windows
//     ahead of the one it inserts.  A 2-byte value (bf16, float16) is not
//     a cp.async unit: its lane loads it when the window is inserted.
//   * Insert, a window at a time, lane j holding slot j:
//     1. every lane looks its key up in the table in parallel, read-only:
//        a key already in the table cannot move, so what the window
//        inserts cannot change where it is found;
//     2. the keys not found are placed in lane order: lanes with one key
//        are grouped by __match_any_sync and the lowest lane of a group
//        places it.  Each placing lane takes the first empty slot from its
//        home; a lane whose slot equals a lower lane's waits for the next
//        round, and so do the lanes above it, so every key takes the slot
//        a one-at-a-time insert in stream order gives it.  A key that
//        finds no empty slot in table_cap probes (a full table) is dropped
//        and not counted, as in the reference;
//     3. the lowest lane of each group adds the group's values to its
//        slot's sum in lane order with __fadd_rn (no contraction), starting
//        from the table's value: a new key starts from the table's +0.0,
//        so -0.0 sums to +0.0 as in the reference.  bf16 and float16
//        values are added in float32 and each sum rounded to their type
//        (dtypes::round_to), as the reference's adds in that type round,
//        and the table keeps them in that type.
//     Every key therefore takes the same slot, and every sum the same
//     terms in the same order, as in the reference's scan engine and
//     Pallas kernel: the table is bit-identical.
//   * Table: up to kSmemTableBytes (8,192 slots: Table-I groups 0-2) the
//     table lives in shared memory, several rows a block where they fit,
//     and is written out once, coalesced ("smem" route).  A larger table
//     (group 3, next_pow2(max IP) slots) lives in the output buffers in
//     global memory, with the same warp algorithm ("global" route).  A
//     block takes at most kBlockBytes of shared memory, so that three fit
//     an SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "hopper.cuh"

namespace {

constexpr int kEmpty = -1;
constexpr unsigned kMultiplier = 2654435761u;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWordSlots = 1024;       // stream slots a mask word covers
constexpr int kAhead = 15;             // windows in flight
constexpr int kRingWindows = kAhead + 1;  // window n in ring slot n % 16
constexpr int kRingBytes = kRingWindows * 32 * 8;  // keys and values
constexpr int kSmemTableBytes = 65536;   // the largest table in shared memory
constexpr int kBlockBytes = 73728;     // shared memory of a block at most
constexpr int kMaskWarps = 8;          // warps of a window_mask_kernel block
constexpr int kMaxWarps = 8;

// The mask word of slots s0 - lane .. + kWordSlots - 1 of a row's stream
// `k`: bit q set where window q holds a product (lane j loads slot j of
// each window: a coalesced load a window).
__device__ __forceinline__ unsigned mask_word(const int* k, long long s0,
                                              long long ip_cap) {
  int key[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const long long s = s0 + 32 * q;
    key[q] = s < ip_cap ? __ldg(k + s) : kEmpty;
  }
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (__ballot_sync(kFull, key[q] >= 0)) m |= 1u << q;
  return m;
}

__global__ void __launch_bounds__(kMaskWarps * 32)
window_mask_kernel(const int* __restrict__ keys, unsigned* __restrict__ masks,
                   long long rows, long long ip_cap, long long n_words) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= rows * n_words) return;
  const int lane = threadIdx.x & 31;
  const long long r = w / n_words;
  const unsigned m = mask_word(keys + r * ip_cap,
                               (w - r * n_words) * kWordSlots + lane, ip_cap);
  if (lane == 0) masks[w] = m;
}

// Insert one window: lane `lane` holds `key` (a product where `valid`) and
// `val`.  `count` (the same in every lane) counts the keys placed.  The
// table's sums are of type V, each add rounded to it.
template <typename V>
__device__ __forceinline__ void insert_window(int* tk, V* tv,
                                              unsigned cap, int key,
                                              float val, bool valid,
                                              int lane, int& count) {
  const unsigned below = (1u << lane) - 1;
  // 1. look up, read-only: stop at the key (and read its sum) or at the
  // first empty slot, whose sum is still the reset's +0.0
  int slot = -1;
  unsigned pos = 0, dist = 0;  // the first empty slot, its probe distance
  float base = 0.0f;
  if (valid) {
    pos = (static_cast<unsigned>(key) * kMultiplier) % cap;
    for (; dist < cap; ++dist) {
      const int s = tk[pos];
      const float t = dtypes::to_f(tv[pos]);  // read with the key
      if (s == key) {
        slot = (int)pos;
        base = t;
        break;
      }
      if (s == kEmpty) break;
      pos = pos + 1 == cap ? 0 : pos + 1;
    }
  }
  const unsigned group = __match_any_sync(kFull, valid ? key : -1);
  const int leader = __ffs(group) - 1;
  const bool lead = valid && leader == lane;

  // 2. place the keys not found, in lane order
  unsigned pending = __ballot_sync(kFull, lead && slot < 0);
  for (bool first = true; pending; first = false) {
    const bool mine = (pending >> lane) & 1;
    bool full = false;
    // the lookup's empty slot, unless a lower lane has taken it since
    if (mine && (dist >= cap || !first)) {
      while (dist >= cap || tk[pos] != kEmpty) {
        if (++dist >= cap) {
          full = true;
          break;
        }
        pos = pos + 1 == cap ? 0 : pos + 1;
      }
    }
    if (__any_sync(kFull, full)) break;  // no empty slot: all are dropped
    const unsigned same = __match_any_sync(kFull, mine ? (int)pos : -2 - lane);
    const unsigned clash = __ballot_sync(kFull, mine && (same & below));
    const unsigned accept = clash ? pending & ((clash & (0u - clash)) - 1)
                                  : pending;
    if ((accept >> lane) & 1) {
      tk[pos] = key;
      slot = (int)pos;
    }
    count += __popc(accept);
    pending &= ~accept;
    __syncwarp();
  }

  // 3. add the values, per slot in lane order
  slot = __shfl_sync(kFull, slot, leader);
  if (__all_sync(kFull, !valid || group == (1u << lane))) {
    if (valid && slot >= 0) tv[slot] = dtypes::from_f<V>(__fadd_rn(base, val));
  } else {
    // kept by the leader only, rounded to V after each add
    float sum = dtypes::round_to<V>(__fadd_rn(base, val));
    unsigned rest = lead ? group & (group - 1) : 0;  // the others, in order
    while (__any_sync(kFull, rest != 0)) {
      const float v = __shfl_sync(kFull, val, rest ? __ffs(rest) - 1 : lane);
      if (rest) {
        sum = dtypes::round_to<V>(__fadd_rn(sum, v));
        rest &= rest - 1;
      }
    }
    if (lead && slot >= 0) tv[slot] = dtypes::from_f<V>(sum);
  }
  __syncwarp();
}

// The windows of a row that hold a product, in order, from its mask words:
// lane l holds word base + l of the current 32 and word base + 32 + l of
// the next.  A row of one word (no mask buffer) finds its word itself.
struct Windows {
  const unsigned* words;
  long long n_words, base;
  unsigned cur, ahead, bits;
  int at;  // the word of the current 32 that `bits` is left of
  __device__ __forceinline__ Windows(const unsigned* w, long long n,
                                     const int* k, long long ip_cap, int lane)
      : words(w), n_words(n), base(0), at(0) {
    if (w == nullptr) {  // n <= 1: lane 0 holds word 0
      const unsigned m = n > 0 ? mask_word(k, lane, ip_cap) : 0u;
      cur = lane == 0 ? m : 0u;
      ahead = 0;
    } else {
      cur = lane < n ? w[lane] : 0u;
      ahead = 32 + lane < n ? w[32 + lane] : 0u;
    }
    bits = __shfl_sync(kFull, cur, 0);
  }
  // The next window with a product, or -1 (and -1 from then on).
  __device__ __forceinline__ long long next(int lane) {
    while (bits == 0) {
      if (base >= n_words) return -1;
      if (++at == 32) {
        base += 32;
        at = 0;
        cur = ahead;
        ahead = base + 32 + lane < n_words ? words[base + 32 + lane] : 0u;
      }
      bits = __shfl_sync(kFull, cur, at);
    }
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    return (base + at) * 32 + b;
  }
};

// kShared: the table in shared memory (the "smem" route); otherwise in
// cols and out (the "global" route).  V: the values' type.
template <bool kShared, typename V>
__global__ void hash_insert_kernel(const int* __restrict__ keys,
                                   const V* __restrict__ vals,
                                   const unsigned* __restrict__ masks,
                                   int* __restrict__ cols,
                                   V* __restrict__ out,
                                   int* __restrict__ cnt, long long rows,
                                   long long ip_cap, long long n_words,
                                   unsigned cap, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * (blockDim.x >> 5)
                      + (threadIdx.x >> 5);
  if (r >= rows) return;
  unsigned char* mine = smem + (threadIdx.x >> 5) * warp_bytes;
  int* ring_k = reinterpret_cast<int*>(mine);        // [kRingWindows][32]
  float* ring_v = reinterpret_cast<float*>(ring_k + kRingWindows * 32);
  long long* ring_w = reinterpret_cast<long long*>(mine + kRingBytes);
  int* tk;
  V* tv;
  if (kShared) {
    tk = reinterpret_cast<int*>(mine + kRingBytes + kRingWindows * 8);
    tv = reinterpret_cast<V*>(tk + cap);
  } else {
    tk = cols + r * cap;
    tv = out + r * cap;
  }
  for (unsigned s = lane; s < cap; s += 32) {
    tk[s] = kEmpty;
    tv[s] = dtypes::from_f<V>(0.0f);
  }
  const int* k = keys + r * ip_cap;
  const V* v = vals + r * ip_cap;
  constexpr bool kRingVals = sizeof(V) == 4;  // values by cp.async
  Windows ws(masks ? masks + r * n_words : nullptr, n_words, k, ip_cap,
             lane);
  // Copy window w (-1: none) into ring slot `slot`: its keys and values,
  // by cp.async, one group a window.
  auto fetch = [&](long long w, int slot) {
    const long long s = w * 32 + lane;
    const bool in = w >= 0 && s < ip_cap;
    const uint32_t at = hopper::smem_addr(ring_k + slot * 32 + lane);
    hopper::cp_async_4(at, in ? k + s : k, in ? 4 : 0);
    if (kRingVals)
      hopper::cp_async_4(at + kRingWindows * 32 * 4, in ? v + s : v,
                         in ? 4 : 0);
    if (lane == 0) ring_w[slot] = w;
    hopper::cp_async_commit();
  };
  for (int n = 0; n < kAhead; ++n) fetch(ws.next(lane), n);
  int count = 0;
  for (long long n = 0;; ++n) {
    hopper::cp_async_wait<kAhead - 1>();  // window n is in
    __syncwarp();  // ... for the whole warp; window n - 1's slot is free
    const int slot = (int)(n % kRingWindows);
    const long long w = ring_w[slot];
    if (w < 0) break;
    const int key = ring_k[slot * 32 + lane];
    const long long at = w * 32 + lane;
    const float val = kRingVals ? ring_v[slot * 32 + lane]
                      : (at < ip_cap && key >= 0 ? dtypes::to_f(v[at])
                                                 : 0.0f);
    fetch(ws.next(lane), (int)((n + kAhead) % kRingWindows));
    insert_window<V>(tk, tv, cap, key, val, at < ip_cap && key >= 0, lane,
                     count);
  }
  hopper::cp_async_wait<0>();
  __syncwarp();
  if (kShared) {
    for (unsigned s = lane; s < cap; s += 32) {
      cols[r * cap + s] = tk[s];
      out[r * cap + s] = tv[s];
    }
  }
  if (lane == 0) cnt[r] = count;
}

// The insert launch's arguments.
struct Insert {
  const void *keys, *vals, *masks;
  void *cols, *out, *cnt;
  long long rows, ip_cap, n_words;
  unsigned cap;
  int warp_bytes;
  unsigned blocks, threads;
  int smem;
  cudaStream_t stream;
};

template <typename V>
int insert(const Insert& a, bool shared) {
  auto kernel = shared ? hash_insert_kernel<true, V>
                       : hash_insert_kernel<false, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<a.blocks, a.threads, (size_t)a.smem, a.stream>>>(
      static_cast<const int*>(a.keys), static_cast<const V*>(a.vals),
      static_cast<const unsigned*>(a.masks), static_cast<int*>(a.cols),
      static_cast<V*>(a.out), static_cast<int*>(a.cnt), a.rows, a.ip_cap,
      a.n_words, a.cap, a.warp_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// keys, vals: (rows, ip_cap) int32 / the type `dtype` names (0 float32,
// 1 bfloat16, 2 float16); masks: (rows, ceil(ip_cap / kWordSlots)) int32
// scratch; cols, out: (rows, table_cap) int32 / vals' type (written in
// full); cnt: (rows,) int32.  The table lives in shared memory when
// table_cap * 8 <= kSmemTableBytes, else in cols and out.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// type or a shape the grid cannot hold.
extern "C" int repro_hash_accumulate(const void* keys, const void* vals,
                                     void* masks, void* cols, void* out,
                                     void* cnt, long long rows,
                                     long long ip_cap, long long table_cap,
                                     int dtype, void* stream) {
  if (rows <= 0) return 0;
  if (table_cap <= 0 || table_cap >= (1LL << 31) || ip_cap < 0 || dtype < 0
      || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = table_cap * 8 <= kSmemTableBytes;
  const long long n_words = (ip_cap + kWordSlots - 1) / kWordSlots;
  // a warp's shared memory: its ring, the ring's window ids, then (smem
  // route) its table
  const long long warp_bytes = kRingBytes + kRingWindows * 8
                               + (shared ? table_cap * 8 : 0);
  long long warps = kBlockBytes / warp_bytes;
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const long long blocks = (rows + warps - 1) / warps;
  const long long mask_blocks = (rows * n_words + kMaskWarps - 1) / kMaskWarps;
  if (blocks > 2147483647LL || mask_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a row of one mask word finds it in the insert kernel: one launch
  if (n_words > 1)
    window_mask_kernel<<<(unsigned)mask_blocks, kMaskWarps * 32, 0, s>>>(
        static_cast<const int*>(keys), static_cast<unsigned*>(masks), rows,
        ip_cap, n_words);
  else
    masks = nullptr;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Insert a{keys, vals, masks, cols, out, cnt, rows, ip_cap, n_words,
                 (unsigned)table_cap, (int)warp_bytes, (unsigned)blocks,
                 (unsigned)(warps * 32), (int)(warps * warp_bytes), s};
  switch (dtype) {
    case 1: return insert<__nv_bfloat16>(a, shared);
    case 2: return insert<__half>(a, shared);
    default: return insert<float>(a, shared);
  }
}
