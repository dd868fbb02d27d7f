// Fused online-softmax attention (flash attention) on q of (BH, Sq, D), k
// of (BH, Sk, D) and v of (BH, Sk, Dv), float32, bfloat16 or float16, any
// D and Dv, on the CUDA cores: the float32 route of
// ops.flash_attention_fused and ops.flash_attention_masked past 256
// columns and under p_dtype (flash_attention_wgmma_f32.cu takes float32 up
// to 256 on the tensor cores), and the 16-bit route of qk widths past the
// tensor-core kernel's (flash_wgmma.cuh takes bf16 and float16 up to 384);
// any type when the wrapper is asked for it.
// The output is (BH, Sq, Dv) in the inputs' type.
// A second kernel writes the rows of the queries that have no valid key.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fused (_flash_kernel: grid (BH, nq, nk) with the kv axis
// innermost and sequential on a TPU core, the running max m, denominator l
// and accumulator acc carried in VMEM scratch across kv steps; causal calls
// skip kv blocks wholly above the diagonal and mask the diagonal block with
// -1e30; the output is acc / max(l, 1e-30) in the operands' dtype), and the
// masks of the model's chunked attention (repro/models/attention.py:25-29,
// :92-95): key j is valid for query i iff j < kv_len, j <= i + q_offset when
// causal, and j > i + q_offset - window when window > 0.  K and V come
// already expanded to the query head count.  With p_bf16 the probabilities
// and V are rounded to bf16 before P.V, and l sums the unrounded
// probabilities: the reference's p_dtype (repro/models/attention.py:96-104).
//
// What bounds it on an H100: operations.  At Phi-3-mini's prefill shape in
// float32 (BH 64, S 4,096, D 96, causal) the blocks on and below the
// diagonal need about 2.1e11 FLOP (Q.K^T and P.V), ~3 ms at the CUDA
// cores' 67 TFLOP/s float32 rate, against about 403 MB of q, k, v and o,
// 0.12 ms at 3.35 TB/s.  The S x S scores never reach device memory: that
// is the point of the kernel, as on the TPU.
//
// Design: the arithmetic is float32 on the CUDA cores, as the reference's
// float32 products are (wgmma in TF32 would keep 10 mantissa bits); bf16
// and float16 inputs are widened to float32 as they are staged.  One
// thread block of 256 threads owns one (bh, 64-query tile) and
// runs the kv loop itself, in ascending order: the loop takes the place of
// the TPU's sequential grid axis, since blocks on a GPU run in no order and
// carry nothing between them.  Per 64-key tile:
//   1. K and V are staged in shared memory as float32 (Q once, before the
//      loop), rows padded so that each thread's float4 reads of its four
//      key rows fall in distinct banks; rows at or past kv_len are zeros;
//   2. each thread forms a 4 x 4 patch of S = Q.K^T (rows 4*ty+i, keys
//      tx+16*j), scales it by 1/sqrt(D), and masks the invalid keys with
//      -1e30, as the reference does;
//   3. row max and row sum go across the 16 threads of a row group with
//      warp shuffles; m, l and the rescale corr = exp(m_prev - m_new) stay
//      in registers, expf (not __expf) throughout;
//   4. P goes to shared memory transposed, and each thread adds P.V into
//      its 4 rows x ceil(Dv/16) columns of the float32 accumulator.
// The kv loop runs from the tile of the first key any query of the block
// may see (past the window of its first query) to the tile of the last
// (kv_len, and the causal limit of its last query); the heaviest query
// tiles are scheduled first.
//
// Widths past kMaxD (192) take flash_slab_kernel: the same loop with D
// and Dv in slabs of 64 columns.  S is summed over Q and K slabs staged in
// turn, and each block owns one 64-column slab of the output: it
// recomputes S for its slab (n_slabs times the Q.K^T work) and keeps a
// 4 x 4 accumulator, so any width runs in the same registers and 68 KB of
// shared memory.  Every block of a query tile computes the same m and l.
//
// The masked-row trap: a row whose first processed tile is wholly masked
// (under a window, the block's later queries see none of its first tiles)
// gets m = -1e30 and p = exp(0) = 1 on every masked key, so l and acc pick
// up terms that are not its own.  They are wiped exactly once a real score
// arrives: corr = exp(-1e30 - m_new) is 0 in float32, and l * 0 and acc * 0
// are 0.  From then on a masked key's p = exp(-1e30 - m) is exactly 0.  The
// reference's chunked loop does the same.  A row with no valid key at all
// keeps those terms: in the reference it is sum_{j < Sk} v_j / den over
// every key of every chunk it visits, den = ceil(Sk / kc) * kc for its key
// chunk kc (padded keys count, with v = 0).  keyless_kernel writes those
// rows (a prefix and a suffix of the queries, found by the wrapper) after
// the attention kernel, and their lse as +1e30, so that the backward's P
// is 0 on them; its backward form sums their dV for the backward kernels
// to add.
//
// Internal tiles (64 x 64) are the kernel's choice: masking is elementwise
// and the function does not depend on them.  The kernel and the Python
// version differ only in the order of float32 sums.  At D = Dv = 192, Q and
// K tiles of 64 x 196 floats and V's and P's take 166,912 bytes of shared
// memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 192;     // widths the one-block-a-tile kernel holds
constexpr int kSlab = 64;      // columns of a slab (flash_slab_kernel)
constexpr int kLdS = kSlab + 4;  // row stride of a staged slab
constexpr int kLdP = kBQ + 4;  // row stride of P^T in shared memory
constexpr float kNegInf = -1e30f;
constexpr float kKeylessLse = 1e30f;  // lse of a row without keys

using dtypes::from_f;
using dtypes::round_bf16;
using dtypes::to_f;

// rows x dp floats of columns [c0, c0 + dp) of src (a row-major matrix of
// `width` columns, from row r0) into dst with row stride ld: zero at or
// past column `width` and at or past row s_len; rounded to bf16 with rnd.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int rows, int s_len, int width,
                                      int c0, int dp, int ld,
                                      bool rnd = false) {
  for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e - r * dp;
    const int row = r0 + r;
    float x = (row < s_len && c0 + c < width)
                  ? to_f(src[(long long)row * width + c0 + c]) : 0.0f;
    dst[r * ld + c] = rnd ? round_bf16(x) : x;
  }
}

// acc[i][j] += A[4*ty + i] . B[tx + 16*j] over dp columns (row stride ld,
// float4s).
__device__ __forceinline__ void patch(float (&acc)[4][4], const float* a_s,
                                      const float* b_s, int ty, int tx,
                                      int dp, int ld) {
  for (int c = 0; c < dp; c += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&a_s[(4 * ty + i) * ld + c]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&b_s[(tx + 16 * j) * ld + c]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, b[j].x, t);
        t = fmaf(a[i].y, b[j].y, t);
        t = fmaf(a[i].z, b[j].z, t);
        t = fmaf(a[i].w, b[j].w, t);
        acc[i][j] = t;
      }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The masks of one launch: key j is valid for query i iff j < kv_len,
// j <= i + q_offset when causal, and j > i + q_offset - window when
// window > 0.
struct Mask {
  int causal, q_offset, window, kv_len;
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    const int p = qi + q_offset;
    return kj < kv_len && (!causal || kj <= p)
           && (window <= 0 || kj > p - window);
  }
};

// The kv tiles [t_lo, t_hi) holding the keys some query of the kBQ-query
// tile at q0 may see.
__device__ __forceinline__ void kv_tiles(const Mask& mk, int q0, int sq,
                                         int& t_lo, int& t_hi) {
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int hi = mk.causal ? min(mk.kv_len, last_q + mk.q_offset + 1)
                           : mk.kv_len;
  const int lo = mk.window > 0 ? max(0, q0 + mk.q_offset - mk.window + 1)
                               : 0;
  t_lo = lo / kBK;
  t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;
}

// One kv tile's softmax step on this thread's 4 x 4 scores s (rows
// q0 + 4*ty + i, keys k0 + tx + 16*j): scale and mask them, update m and l,
// rescale acc, and leave p = exp(s - m) in s.
template <int NC>
__device__ __forceinline__ void softmax_step(float (&s)[4][4], float (&m)[4],
                                             float (&l)[4],
                                             float (&acc)[4][NC], int q0,
                                             int k0, int ty, int tx,
                                             const Mask& mk, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = mk.ok(qi, k0 + tx + 16 * j) ? s[i][j] * scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
    const float m_new = fmaxf(m[i], half_warp_max(mx));
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m_new);  // now p
      rs += s[i][j];
    }
    const float corr = expf(m[i] - m_new);
    l[i] = l[i] * corr + half_warp_sum(rs);
    m[i] = m_new;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) acc[i][kk] *= corr;
  }
}

// P (this thread's 4 x 4, rounded to bf16 with rnd) into pt, transposed.
__device__ __forceinline__ void store_pt(float* pt, const float (&s)[4][4],
                                         int ty, int tx, bool rnd) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float4 p = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    if (rnd)
      p = make_float4(round_bf16(p.x), round_bf16(p.y), round_bf16(p.z),
                      round_bf16(p.w));
    *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * kLdP + 4 * ty]) = p;
  }
}

// acc += P.V over the tile's keys: pt (keys x queries) times vs (keys x
// 16 * NC columns, row stride ldv).
template <int NC>
__device__ __forceinline__ void pv(float (&acc)[4][NC], const float* pt,
                                   const float* vs, int ty, int tx,
                                   int ldv) {
#pragma unroll 4
  for (int c = 0; c < kBK; ++c) {
    const float4 p = *reinterpret_cast<const float4*>(&pt[c * kLdP + 4 * ty]);
    const float* vr = vs + c * ldv + tx;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const float vv = vr[16 * kk];
      acc[0][kk] = fmaf(p.x, vv, acc[0][kk]);
      acc[1][kk] = fmaf(p.y, vv, acc[1][kk]);
      acc[2][kk] = fmaf(p.z, vv, acc[2][kk]);
      acc[3][kk] = fmaf(p.w, vv, acc[3][kk]);
    }
  }
}

// The rows' outputs acc / max(l, 1e-30) in columns c0 + tx + 16 kk < dv,
// and (lse_out) their lse.
template <typename T, int NC>
__device__ __forceinline__ void store_rows(T* o, float* lse,
                                           const float (&acc)[4][NC],
                                           const float (&m)[4],
                                           const float (&l)[4], long long bh,
                                           int q0, int sq, int dv, int c0,
                                           int ty, int tx, bool lse_out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse_out && lse != nullptr && tx == 0)
      lse[bh * sq + row] = m[i] + logf(l[i]);
    T* orow = o + (bh * sq + row) * (long long)dv;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const int n = c0 + tx + 16 * kk;
      if (n < dv) orow[n] = from_f<T>(acc[i][kk] / denom);
    }
  }
}

// NC = ceil(Dv / 16): output columns per thread (tx + 16 * kk); D, Dv <=
// kMaxD.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int bh_count, int sq, int sk, int d,
             int dv, Mask mk, float scale, int p_bf16) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int dp = (d + 3) & ~3;  // D padded to whole float4s
  const int ld = dp + 4;        // row stride of Q and K
  constexpr int kLdV = 16 * NC;
  float* qs = smem;             // kBQ x ld
  float* ks = qs + kBQ * ld;    // kBK x ld
  float* vs = ks + kBK * ld;    // kBK x kLdV
  float* pt = vs + kBK * kLdV;  // kBK x kLdP, P transposed

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nq = (sq + kBQ - 1) / kBQ;
  // heaviest causal tiles (the last query tiles) first
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kBQ;
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;

  stage(qs, qb, q0, kBQ, sq, d, 0, dp, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) acc[i][kk] = 0.0f;
  }

  int t_lo, t_hi;
  kv_tiles(mk, q0, sq, t_lo, t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage(ks, kb, k0, kBK, mk.kv_len, d, 0, dp, ld);
    stage(vs, vb, k0, kBK, mk.kv_len, dv, 0, kLdV, kLdV, p_bf16 != 0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    patch(s, qs, ks, ty, tx, dp, ld);
    softmax_step<NC>(s, m, l, acc, q0, k0, ty, tx, mk, scale);
    store_pt(pt, s, ty, tx, p_bf16 != 0);
    __syncthreads();
    pv<NC>(acc, pt, vs, ty, tx, kLdV);
  }
  store_rows<T, NC>(o, lse, acc, m, l, bh, q0, sq, dv, 0, ty, tx, true);
}

// Any D and Dv: block (slab, query tile, bh) computes output columns
// [64 slab, 64 slab + 64) of its query tile; S is summed over 64-column
// slabs of Q and K staged in turn.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, int bh_count, int sq, int sk,
                  int d, int dv, Mask mk, float scale, int p_bf16,
                  int n_slabs) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdS
  float* ks = qs + kBQ * kLdS;                   // kBK x kLdS
  float* vs = ks + kBK * kLdS;                   // kBK x kSlab
  float* pt = vs + kBK * kSlab;                  // kBK x kLdP

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int slab = (int)(blockIdx.x % n_slabs);
  const long long rest = blockIdx.x / n_slabs;
  const int qt = nq - 1 - (int)(rest / bh_count);  // heaviest first
  const long long bh = rest % bh_count;
  const int q0 = qt * kBQ;
  const int c0 = slab * kSlab;
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc[i][kk] = 0.0f;
  }

  int t_lo, t_hi;
  kv_tiles(mk, q0, sq, t_lo, t_hi);
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d0 = 0; d0 < d; d0 += kSlab) {
      __syncthreads();  // the previous slab (and tile's P, V) consumed
      stage(qs, qb, q0, kBQ, sq, d, d0, kSlab, kLdS);
      stage(ks, kb, k0, kBK, mk.kv_len, d, d0, kSlab, kLdS);
      __syncthreads();
      patch(s, qs, ks, ty, tx, kSlab, kLdS);
    }
    softmax_step<4>(s, m, l, acc, q0, k0, ty, tx, mk, scale);
    // vs and pt are read after the next barrier only
    stage(vs, vb, k0, kBK, mk.kv_len, dv, c0, kSlab, kSlab, p_bf16 != 0);
    store_pt(pt, s, ty, tx, p_bf16 != 0);
    __syncthreads();
    pv<4>(acc, pt, vs, ty, tx, kSlab);
  }
  store_rows<T, 4>(o, lse, acc, m, l, bh, q0, sq, dv, c0, ty, tx,
                   slab == 0);
}

// The rows of the queries with no valid key, [0, a) and [b, sq), and their
// gradient: column sums over the rows of one (bh), spread over a cluster.
// FWD: o[bh, i, c] = sum_{j < sk} v[bh, j, c] / den for every keyless
// query i (v rounded to bf16 first with p_bf16), and lse +1e30.  Backward:
// g[bh, c] = sum_i dout[bh, i, c] / den over the keyless queries i, the dV
// every key j < sk gets from them, which the backward kernels add to their
// float32 dV before they round it.
//
// A cluster of kKeylessCluster blocks a (bh, slab of kKeylessCols
// columns): the cluster's kKeylessCluster * kKeylessWarps warps each sum a
// contiguous chunk of the rows (warp w of block r the chunk r *
// kKeylessWarps + w), lane l columns l + 32 k of the slab, kKeylessRows
// rows' loads in flight, in float32.  Then, in a fixed order: each block
// adds its warps' partial sums in warp order (shared memory), and every
// block adds the cluster's block sums in rank order (distributed shared
// memory, read after a cluster barrier), so every block holds the same
// column sums, the same bits on every run; no atomics.  FWD: block r writes
// its share of the keyless rows, a row's columns coalesced; the backward's
// rank 0 writes g.
constexpr int kKeylessCluster = 8;  // blocks of a cluster (the portable most)
constexpr int kKeylessWarps = kThreads / 32;
constexpr int kKeylessCols = 128;   // columns a cluster: 4 a lane
constexpr int kKeylessRows = 4;     // rows whose loads are in flight a lane

template <typename T, bool FWD>
__global__ void __cluster_dims__(kKeylessCluster, 1, 1)
    __launch_bounds__(kThreads)
keyless_kernel(const T* __restrict__ src, T* __restrict__ o,
               float* __restrict__ g, float* __restrict__ lse, int sq,
               int sk, int dv, int a, int b, int n_slabs, float den,
               int p_bf16) {
  constexpr int kC = kKeylessCols / 32;
  __shared__ float part[kKeylessWarps][kKeylessCols];
  __shared__ float block_sum[kKeylessCols];
  __shared__ float total[kKeylessCols];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long unit = blockIdx.x / kKeylessCluster;  // (bh, slab)
  const long long bh = unit / n_slabs;
  const int c0 = (int)(unit - bh * n_slabs) * kKeylessCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the rows summed: v's keys [0, sk), or dout's keyless queries, [0, a)
  // then [b, sq)
  const int rows = FWD ? sk : a + sq - b;
  const T* base = src + bh * (long long)(FWD ? sk : sq) * dv;
  constexpr int kChunks = kKeylessCluster * kKeylessWarps;
  const int len = (rows + kChunks - 1) / kChunks;
  const int r0 = (rank * kKeylessWarps + warp) * len;
  const int r1 = min(rows, r0 + len);
  bool on[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) on[k] = c0 + lane + 32 * k < dv;
  float acc[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k) acc[k] = 0.0f;
  for (int r = r0; r < r1; r += kKeylessRows) {
    float x[kKeylessRows][kC];
#pragma unroll
    for (int u = 0; u < kKeylessRows; ++u) {
      const int t = r + u;
      const int row = FWD || t < a ? t : b + (t - a);
#pragma unroll
      for (int k = 0; k < kC; ++k)
        x[u][k] = t < r1 && on[k]
                      ? to_f(base[(long long)row * dv + c0 + lane + 32 * k])
                      : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kKeylessRows; ++u)
#pragma unroll
      for (int k = 0; k < kC; ++k)
        if (r + u < r1)
          acc[k] = __fadd_rn(acc[k], FWD && p_bf16 ? round_bf16(x[u][k])
                                                   : x[u][k]);
  }
#pragma unroll
  for (int k = 0; k < kC; ++k) part[warp][lane + 32 * k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kKeylessCols) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kKeylessWarps; ++w)
      sum = __fadd_rn(sum, part[w][threadIdx.x]);
    block_sum[threadIdx.x] = sum;
  }
  cluster.sync();  // every block's sums are written
  if (threadIdx.x < kKeylessCols) {
    float sum = 0.0f;
    for (int q = 0; q < kKeylessCluster; ++q)
      sum = __fadd_rn(sum, cluster.map_shared_rank(block_sum, q)[threadIdx.x]);
    total[threadIdx.x] = sum;
  }
  cluster.sync();  // no block leaves while its sums are read; total written
  const int width = min(kKeylessCols, dv - c0);
  if (!FWD) {
    if (rank == 0 && threadIdx.x < width)
      g[bh * dv + c0 + threadIdx.x] = total[threadIdx.x] / den;
    return;
  }
  // block r's share of the keyless rows [0, a) then [b, sq), a warp a
  // row, lane l its columns l + 32 k
  const int nk = a + sq - b;
  const int share = (nk + kKeylessCluster - 1) / kKeylessCluster;
  const int k0 = rank * share;
  const int k1 = min(nk, k0 + share);
  T mean[kC];
#pragma unroll
  for (int k = 0; k < kC; ++k)
    mean[k] = from_f<T>(on[k] ? total[lane + 32 * k] / den : 0.0f);
  T* ob = o + bh * (long long)sq * dv + c0 + lane;
  for (int t = k0 + warp; t < k1; t += kKeylessWarps) {
    T* orow = ob + (long long)(t < a ? t : b + (t - a)) * dv;
#pragma unroll
    for (int k = 0; k < kC; ++k)
      if (on[k]) orow[32 * k] = mean[k];
  }
  if (lse != nullptr && c0 == 0)
    for (int t = k0 + threadIdx.x; t < k1; t += kThreads)
      lse[bh * sq + (t < a ? t : b + (t - a))] = kKeylessLse;
}

// The arguments of one launch: shapes, mask, scale and the p_dtype flag.
struct Args {
  long long bh, sq, sk, d, dv;
  Mask mk;
  float scale;
  int p_bf16;
};

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           void* lse, const Args& a, cudaStream_t stream) {
  const long long d = a.d;
  const long long dp = (d + 3) & ~3LL;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (dp + 4)
                                       + (size_t)kBK * 16 * NC
                                       + (size_t)kBK * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (a.sq + kBQ - 1) / kBQ;
  flash_kernel<T, NC><<<(unsigned)(nq * a.bh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), (int)a.bh, (int)a.sq, (int)a.sk, (int)d,
      (int)a.dv, a.mk, a.scale, a.p_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slabs(const void* q, const void* k, const void* v, void* o,
                 void* lse, const Args& a, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * kLdS + (size_t)kBK * kSlab
                       + (size_t)kBK * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (a.sq + kBQ - 1) / kBQ;
  const long long n_slabs = (a.dv + kSlab - 1) / kSlab;
  const long long blocks = nq * a.bh * n_slabs;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  flash_slab_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), (int)a.bh, (int)a.sq, (int)a.sk, (int)a.d,
      (int)a.dv, a.mk, a.scale, a.p_bf16, (int)n_slabs);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_FLASH_NC(n)                                                  \
  case n:                                                                 \
    return launch<T, n>(q, k, v, o, lse, a, s);

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, const Args& a, cudaStream_t s) {
  if (a.d > kMaxD || a.dv > kMaxD)
    return launch_slabs<T>(q, k, v, o, lse, a, s);
  switch ((a.dv + 15) / 16) {
    REPRO_FLASH_NC(1) REPRO_FLASH_NC(2) REPRO_FLASH_NC(3) REPRO_FLASH_NC(4)
    REPRO_FLASH_NC(5) REPRO_FLASH_NC(6) REPRO_FLASH_NC(7) REPRO_FLASH_NC(8)
    REPRO_FLASH_NC(9) REPRO_FLASH_NC(10) REPRO_FLASH_NC(11)
    REPRO_FLASH_NC(12)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_FLASH_NC

bool bad_shape(long long bh, long long sq, long long sk, long long d,
               long long dv, long long q_offset, long long window) {
  return d <= 0 || dv <= 0 || sk <= 0 || d > (1LL << 20)
         || dv > (1LL << 20) || sq > (1LL << 28) || sk > (1LL << 28)
         || q_offset > (1LL << 28) || q_offset < -(1LL << 28) || window < 0
         || window > (1LL << 28)
         || ((sq + kBQ - 1) / kBQ) * bh > 2147483647LL;
}

}  // namespace

// q: (bh, sq, d), k: (bh, sk, d), v: (bh, sk, dv), o: (bh, sq, dv) of the
// type `dtype` names (0 float32, 1 bfloat16, 2 float16), contiguous; o is
// written in full, and lse, when it is not NULL, gets the (bh, sq) float32
// row log-sum-exp m + log(l) of the scaled scores (the backward's input;
// an epilogue store only).  Key j is valid for query i iff j < kv_len,
// j <= i + q_offset when causal is 1, and j > i + q_offset - window when
// window > 0 (kv_len is clipped to 0..sk).  A query with no valid key gets
// zeros here (repro_flash_keyless writes its row).  scale: the score
// scale, 1/sqrt(d) rounded once to float32.  p_bf16 = 1 rounds P and V to
// bf16 before P.V.  D and Dv up to kMaxD take flash_kernel, wider ones
// flash_slab_kernel.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a type, d or dv outside 1..2^20, sk < 1, an
// sq, sk, |q_offset| or window past 2^28 (so that positions and their sums
// stay in int), or a grid the launch cannot hold.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     long long bh,
                                     long long sq, long long sk, long long d,
                                     long long dv, int causal,
                                     long long q_offset, long long window,
                                     long long kv_len, float scale,
                                     int p_bf16, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (bad_shape(bh, sq, sk, d, dv, q_offset, window) || dtype < 0
      || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mk{causal, (int)q_offset, (int)window,
                (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len)};
  const Args a{bh, sq, sk, d, dv, mk, scale, p_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch<__nv_bfloat16>(q, k, v, o, lse, a, s);
    case 2: return dispatch<__half>(q, k, v, o, lse, a, s);
    default: return dispatch<float>(q, k, v, o, lse, a, s);
  }
}

// The queries with no valid key, [0, a) and [b, sq), of an attention call
// on v (bh, sk, dv) and o (bh, sq, dv) of the type `dtype` names: their
// rows of o get sum_{j < sk} v_j / den (v rounded to bf16 with p_bf16),
// their lse (when not NULL) +1e30.  fwd = 0 is the backward's share
// instead: g (bh, dv) float32 = sum_i dout_i / den over those queries, the
// dV every key j < sk gets from them; dout (bh, sq, dv) passed as v and g
// as o.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_keyless(const void* v, void* o, void* lse,
                                   long long bh, long long sq, long long sk,
                                   long long dv, long long a, long long b,
                                   float den, int p_bf16, int dtype, int fwd,
                                   void* stream) {
  if (bh <= 0 || dv <= 0 || (a <= 0 && b >= sq)) return 0;
  if (sq > (1LL << 28) || sk <= 0 || sk > (1LL << 28) || a < 0 || b > sq
      || a > b || dtype < 0 || dtype > 2 || !(den > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_slabs = (dv + kKeylessCols - 1) / kKeylessCols;
  if (bh * n_slabs * kKeylessCluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)(bh * n_slabs * kKeylessCluster);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_KEYLESS(T)                                                    \
  if (fwd)                                                                \
    keyless_kernel<T, true><<<blocks, kThreads, 0, s>>>(                  \
        static_cast<const T*>(v), static_cast<T*>(o), nullptr,            \
        static_cast<float*>(lse), (int)sq, (int)sk, (int)dv, (int)a,      \
        (int)b, (int)n_slabs, den, p_bf16);                               \
  else                                                                    \
    keyless_kernel<T, false><<<blocks, kThreads, 0, s>>>(                 \
        static_cast<const T*>(v), nullptr, static_cast<float*>(o),        \
        nullptr, (int)sq, (int)sk, (int)dv, (int)a, (int)b, (int)n_slabs, \
        den, 0);
  switch (dtype) {
    case 1: REPRO_KEYLESS(__nv_bfloat16) break;
    case 2: REPRO_KEYLESS(__half) break;
    default: REPRO_KEYLESS(float) break;
  }
#undef REPRO_KEYLESS
  return static_cast<int>(cudaGetLastError());
}
