// The backward of the fused flash attention (K7): dq, dk and dv of
// o = softmax(q.k^T * scale, masked) . v for q of (BH, Sq, D), k of
// (BH, Sk, D), v of (BH, Sk, Dv), any D and Dv, float32, bf16 or float16,
// under the forward's masks: key j is valid for query i iff j < kv_len,
// j <= i + q_offset when causal, and j > i + q_offset - window when
// window > 0.  It is the gradient route of ops.flash_attention_masked and
// ops.flash_attention_fused (kernels/flash_attention.py, _FlashAttention)
// for float32, and for 16-bit heads past the tensor-core backward's 256
// columns (flash_bwd_wgmma.cuh).
//
// Replaces no Pallas kernel: the reference's training differentiates its
// chunked attention (repro/models/attention.py:32-127) with XLA's autodiff,
// and has no Pallas backward.  The port's model sends every full-sequence
// attention through K7's forward (flash_attention.cu and
// flash_attention_wgmma.cu), and the port runs no plain version on a CUDA
// tensor, so a training step needs this kernel.
//
// What bounds it on an H100: operations.  At granite-3-2b's training shape
// (BH 64 = 2 x 32 heads, S 2,048, D 64, causal) the 1.343e8 valid pairs
// need 10 * D = 640 FLOP a pair (recompute S, dV, dP, dQ, dK), 8.6e10
// FLOP: 0.087 ms at the tensor cores' 989 TFLOP/s bf16 rate, 1.3 ms at the
// CUDA cores' 67 TFLOP/s float32 rate.  The bytes (q, k, v, o, do, dq, dk,
// dv: 134 MB in bf16) take 0.04 ms at 3.35 TB/s.  This kernel runs on the
// CUDA cores in float32 for both dtypes (the tensor cores are a later
// kernel's work), and recomputes S and dP in both of its passes: 14 * D
// FLOP a pair.
//
// Design: FlashAttention-2's schedule, without atomics, so that a gradient
// is the same bits run to run.
//   1. delta_kernel: Delta_i = sum_c do_ic * o_ic in float32, one warp a
//      row (o is the forward's output in the operands' dtype).
//   2. dkdv_kernel: one block of 256 threads per (bh, 64-key tile).  K and
//      V are staged once; the loop runs over the 64-query tiles whose
//      queries may see a key of the tile (from the causal diagonal to the
//      window's far edge), in ascending order.  Per query tile: S = K.Q^T
//      and dP = V.dO^T as 4 x 4 patches a thread (rows 4*ty+i, queries
//      tx+16*j), P = exp(S * scale - lse) with invalid pairs set to 0,
//      dS = P * (dP - Delta); then P^T and dS^T go through shared memory
//      (transposed, as the forward's P does) and each thread adds
//      dV += P^T.dO and dK += dS^T.Q into its 4 rows x ceil(D/16) columns.
//      dK is scaled once, at the end.
//   3. dq_kernel: one block per (bh, 64-query tile) over the kv tiles the
//      forward visits, in ascending order: S = Q.K^T, dP = dO.V^T, dS as
//      above, dQ += dS.K, scaled at the end.
// Each output element is written by one thread of one block, after a loop
// in a fixed order: no atomics, no cross-block sums.  lse is the forward's
// float32 row log-sum-exp (m + log l); a row with no valid key has lse
// +1e30 (flash_attention.cu's keyless pass), so its P is 0 here; the dV
// such rows give every key, summed by that file's keyless_kernel,
// comes in as keyless_dv and is added before dV is rounded.  Inputs of any
// of the three types are converted to float32 as they are staged; dq, dk
// and dv are written in the operands' type.  The widths are padded to a
// multiple of 32 with zero columns (template NCK = 2 * ceil(max(D, Dv) /
// 32) columns of 16 for both, or NCV = 8 for MLA's 192 / 128).  Shared
// memory at D = Dv = 192: Q, dO, K and V tiles of 64 x 196 floats and one
// 64 x 68 tile of P^T or dS^T, 218,624 bytes.  Wider heads take the slab
// kernels (dkdv_slab_kernel, dq_slab_kernel): a block owns one 64-column
// slab of its outputs and sums S and dP over 64-column slabs of its
// operands staged in turn, recomputing them for each of its slabs.
//
// p_dtype (p_bf16 = 1): the forward rounded P and V to bf16 before P.V
// (repro/models/attention.py:96-104).  The backward takes that rounding's
// gradient as the identity, as JAX's gradient of a cast is: dP = dO.V^T
// with V rounded to bf16, and dV = P^T.dO with P rounded to bf16.
#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kBQ = 64;        // queries per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 192;
constexpr int kLdP = kBQ + 4;  // row stride of the transposed P / dS tile

constexpr int kSlab = 64;      // columns of a slab (the slab kernels)
constexpr int kLdS = kSlab + 4;  // row stride of a staged slab

using dtypes::from_f;
using dtypes::round_bf16;
using dtypes::to_f;

// rows x dp floats of columns [c0, c0 + dp) of src (s_len rows x `width`
// columns, row-major, from row r0) into dst with row stride ld; zeros at or
// past column `width` and at or past row s_len; rounded to bf16 with rnd.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int rows, int s_len, int width,
                                      int dp, int ld, int c0 = 0,
                                      bool rnd = false) {
  for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e - r * dp;
    const int row = r0 + r;
    const float x = (row < s_len && c0 + c < width)
                        ? to_f(src[(long long)row * width + c0 + c]) : 0.0f;
    dst[r * ld + c] = rnd ? round_bf16(x) : x;
  }
}

// P or dS (this thread's 4 x 4, s[i][j] for rows 4*ty+i and columns
// tx+16*j) into pt transposed, rounded to bf16 with rnd.
__device__ __forceinline__ void store_t(float* pt, const float (&s)[4][4],
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

// acc[i][j] += A[ra + i] . B[rb + j] over dp columns: the 4 x 4 patch of
// rows 4*ty+i of A and rows tx+16*j of B (both row stride ld, float4s).
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

// acc[i][kk] += sum_r pt[r][4*ty+i] * x[r][tx+16*kk] over kBQ rows r: the
// transposed tile times a staged tile (row stride ldx), NC column groups.
template <int NC>
__device__ __forceinline__ void accumulate(float (&acc)[4][NC],
                                           const float* pt, const float* x,
                                           int ty, int tx, int ldx) {
#pragma unroll 4
  for (int r = 0; r < kBQ; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(&pt[r * kLdP + 4 * ty]);
    const float* xr = x + r * ldx + tx;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const float xv = xr[16 * kk];
      acc[0][kk] = fmaf(p.x, xv, acc[0][kk]);
      acc[1][kk] = fmaf(p.y, xv, acc[1][kk]);
      acc[2][kk] = fmaf(p.z, xv, acc[2][kk]);
      acc[3][kk] = fmaf(p.w, xv, acc[3][kk]);
    }
  }
}

struct Mask {
  int causal, q_offset, window, kv_len, sq;
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    const int p = qi + q_offset;
    return qi < sq && kj < kv_len && (!causal || kj <= p)
           && (window <= 0 || kj > p - window);
  }
};

// Delta[r] = sum_c do[r][c] * o[r][c] in float32, one warp a row (lanes
// over the columns, then a butterfly sum: one order on every run).
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32)
    s = fmaf(to_f(dout[row * dv + c]), to_f(o[row * dv + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Shared memory of either pass: two tiles of the qk width, two of the
// value width, the transposed P / dS tile, and lse and Delta of a tile.
template <int NCK, int NCV>
constexpr int smem_bytes() {
  return 4 * ((kBQ + kBK) * (16 * NCK + 4) + (kBQ + kBK) * (16 * NCV + 4)
              + kBK * kLdP + 2 * kBQ);
}

// One block per (bh, 64-key tile): dK and dV of its keys.
template <typename T, int NCK, int NCV>
__global__ void __launch_bounds__(kThreads, NCK > 6 ? 1 : 2)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv_out,
            const float* __restrict__ kl, int bh_count, int sq, int sk,
            int d, int dv, Mask mask, float scale, int p_bf16) {
  extern __shared__ float4 smem4[];
  constexpr int kDK = 16 * NCK, kDV = 16 * NCV;
  constexpr int kLdK = kDK + 4, kLdV = kDV + 4;
  float* ks = reinterpret_cast<float*>(smem4);  // kBK x kLdK
  float* vs = ks + kBK * kLdK;                   // kBK x kLdV
  float* qs = vs + kBK * kLdV;                   // kBQ x kLdK
  float* ds = qs + kBQ * kLdK;                   // kBQ x kLdV (dO)
  float* pt = ds + kBQ * kLdV;                   // kBQ x kLdP: P^T / dS^T
  float* lse_s = pt + kBQ * kLdP;
  float* del_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int kt = (int)(blockIdx.x / bh_count);  // early keys (most work) first
  const long long bh = blockIdx.x % bh_count;
  const int k0 = kt * kBK;
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;
  const T* dob = dout + bh * sq * (long long)dv;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  stage(ks, kb, k0, kBK, mask.kv_len, d, kDK, kLdK);
  stage(vs, vb, k0, kBK, mask.kv_len, dv, kDV, kLdV, 0, p_bf16 != 0);

  float acc_k[4][NCK], acc_v[4][NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int kk = 0; kk < NCK; ++kk) acc_k[i][kk] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NCV; ++kk) acc_v[i][kk] = 0.0f;
  }

  // the queries [i_lo, i_hi) that may see a key of [k0, k0 + kBK)
  const int k1 = min(k0 + kBK, mask.kv_len);
  int i_lo = 0, i_hi = sq;
  if (mask.causal) i_lo = max(0, k0 - mask.q_offset);
  if (mask.window > 0) i_hi = min(sq, k1 - 1 + mask.window - mask.q_offset);
  if (k0 >= mask.kv_len) i_hi = i_lo;
  const int t_lo = i_lo / kBQ;
  const int t_hi = i_hi > i_lo ? (i_hi + kBQ - 1) / kBQ : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int q0 = t * kBQ;
    __syncthreads();  // the previous tile's Q, dO and P^T are consumed
    stage(qs, qb, q0, kBQ, sq, d, kDK, kLdK);
    stage(ds, dob, q0, kBQ, sq, dv, kDV, kLdV);
    for (int r = tid; r < kBQ; r += kThreads) {
      const bool in = q0 + r < sq;
      lse_s[r] = in ? lb[q0 + r] : 0.0f;
      del_s[r] = in ? db[q0 + r] : 0.0f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    patch(s, ks, qs, ty, tx, kDK, kLdK);   // keys x queries
    patch(dp, vs, ds, ty, tx, kDV, kLdV);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx + 16 * j;
        const float p = mask.ok(qi, k0 + 4 * ty + i)
            ? expf(s[i][j] * scale - lse_s[tx + 16 * j]) : 0.0f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - del_s[tx + 16 * j]);  // now dS
      }
    store_t(pt, s, ty, tx, p_bf16 != 0);
    __syncthreads();
    accumulate<NCV>(acc_v, pt, ds, ty, tx, kLdV);  // dV += P^T.dO
    __syncthreads();
    store_t(pt, dp, ty, tx, false);
    __syncthreads();
    accumulate<NCK>(acc_k, pt, qs, ty, tx, kLdK);  // dK += dS^T.Q
  }

  T* dkb = dk + bh * sk * (long long)d;
  T* dvb = dv_out + bh * sk * (long long)dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= sk) continue;
#pragma unroll
    for (int kk = 0; kk < NCK; ++kk) {
      const int c = tx + 16 * kk;
      if (c < d) dkb[(long long)row * d + c] = from_f<T>(acc_k[i][kk] * scale);
    }
#pragma unroll
    for (int kk = 0; kk < NCV; ++kk) {
      const int c = tx + 16 * kk;
      if (c < dv)
        dvb[(long long)row * dv + c] = from_f<T>(
            kl != nullptr ? acc_v[i][kk] + kl[bh * dv + c] : acc_v[i][kk]);
    }
  }
}

// One block per (bh, 64-query tile): dQ of its queries.
template <typename T, int NCK, int NCV>
__global__ void __launch_bounds__(kThreads, NCK > 6 ? 1 : 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int bh_count, int sq, int sk, int d, int dv,
          Mask mask, float scale, int p_bf16) {
  extern __shared__ float4 smem4[];
  constexpr int kDK = 16 * NCK, kDV = 16 * NCV;
  constexpr int kLdK = kDK + 4, kLdV = kDV + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // kBQ x kLdK
  float* ds = qs + kBQ * kLdK;                   // kBQ x kLdV (dO)
  float* ks = ds + kBQ * kLdV;                   // kBK x kLdK
  float* vs = ks + kBK * kLdK;                   // kBK x kLdV
  float* pt = vs + kBK * kLdV;                   // kBK x kLdP: dS^T

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int nq = (sq + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);  // heaviest first
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kBQ;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;

  stage(qs, q + bh * sq * (long long)d, q0, kBQ, sq, d, kDK, kLdK);
  stage(ds, dout + bh * sq * (long long)dv, q0, kBQ, sq, dv, kDV, kLdV);
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < sq ? lse[bh * sq + row] : 0.0f;
    del_r[i] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  float acc[4][NCK];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < NCK; ++kk) acc[i][kk] = 0.0f;

  // the kv tiles the forward visits for this query tile
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int hi = mask.causal ? min(mask.kv_len, last_q + mask.q_offset + 1)
                             : mask.kv_len;
  const int lo = mask.window > 0
      ? max(0, q0 + mask.q_offset - mask.window + 1) : 0;
  const int t_lo = lo / kBK;
  const int t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and dS^T are consumed
    stage(ks, kb, k0, kBK, mask.kv_len, d, kDK, kLdK);
    stage(vs, vb, k0, kBK, mask.kv_len, dv, kDV, kLdV, 0, p_bf16 != 0);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    patch(s, qs, ks, ty, tx, kDK, kLdK);   // queries x keys
    patch(dp, ds, vs, ty, tx, kDV, kLdV);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mask.ok(q0 + 4 * ty + i, k0 + tx + 16 * j)
            ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        dp[i][j] = p * (dp[i][j] - del_r[i]);  // dS
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * kLdP + 4 * ty]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();
    accumulate<NCK>(acc, pt, ks, ty, tx, kLdK);  // dQ += dS.K
  }

  T* dqb = dq + bh * sq * (long long)d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
#pragma unroll
    for (int kk = 0; kk < NCK; ++kk) {
      const int c = tx + 16 * kk;
      if (c < d) dqb[(long long)row * d + c] = from_f<T>(acc[i][kk] * scale);
    }
  }
}

// Shared memory of either slab kernel: two 64 x kLdS slabs, the
// transposed P / dS tile, and lse and Delta of a tile.
constexpr int kSlabSmem = 4 * (2 * 64 * kLdS + kBK * kLdP + 2 * kBQ);

// Any widths: one block per (output slab, 64-key tile, bh) computes dK's
// and dV's columns [64 slab, 64 slab + 64) of its keys.  S = K.Q^T and
// dP = V.dO^T are summed over 64-column slabs of the operands, staged in
// turn into the two slab buffers a and b.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv_out, const float* __restrict__ kl,
                 int bh_count, int sq, int sk, int d, int dv, Mask mask,
                 float scale, int p_bf16, int n_slabs) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);  // 64 x kLdS
  float* sb = sa + 64 * kLdS;                    // 64 x kLdS
  float* pt = sb + 64 * kLdS;                    // kBK x kLdP
  float* lse_s = pt + kBK * kLdP;
  float* del_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int slab = (int)(blockIdx.x % n_slabs);
  const long long rest = blockIdx.x / n_slabs;
  const int kt = (int)(rest / bh_count);  // early keys (most work) first
  const long long bh = rest % bh_count;
  const int k0 = kt * kBK;
  const int c0 = slab * kSlab;
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;
  const T* dob = dout + bh * sq * (long long)dv;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_k[i][kk] = acc_v[i][kk] = 0.0f;

  // the queries [i_lo, i_hi) that may see a key of [k0, k0 + kBK)
  const int k1 = min(k0 + kBK, mask.kv_len);
  int i_lo = 0, i_hi = sq;
  if (mask.causal) i_lo = max(0, k0 - mask.q_offset);
  if (mask.window > 0) i_hi = min(sq, k1 - 1 + mask.window - mask.q_offset);
  if (k0 >= mask.kv_len) i_hi = i_lo;
  const int t_lo = i_lo / kBQ;
  const int t_hi = i_hi > i_lo ? (i_hi + kBQ - 1) / kBQ : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int q0 = t * kBQ;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int c = 0; c < d; c += kSlab) {  // S = K.Q^T: keys x queries
      __syncthreads();  // the slabs (and the last tile's P^T) consumed
      stage(sa, kb, k0, kBK, mask.kv_len, d, kSlab, kLdS, c);
      stage(sb, qb, q0, kBQ, sq, d, kSlab, kLdS, c);
      if (c == 0)
        for (int r = tid; r < kBQ; r += kThreads) {
          const bool in = q0 + r < sq;
          lse_s[r] = in ? lb[q0 + r] : 0.0f;
          del_s[r] = in ? db[q0 + r] : 0.0f;
        }
      __syncthreads();
      patch(s, sa, sb, ty, tx, kSlab, kLdS);
    }
    for (int c = 0; c < dv; c += kSlab) {  // dP = V.dO^T
      __syncthreads();
      stage(sa, vb, k0, kBK, mask.kv_len, dv, kSlab, kLdS, c, p_bf16 != 0);
      stage(sb, dob, q0, kBQ, sq, dv, kSlab, kLdS, c);
      __syncthreads();
      patch(dp, sa, sb, ty, tx, kSlab, kLdS);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + tx + 16 * j;
        const float p = mask.ok(qi, k0 + 4 * ty + i)
            ? expf(s[i][j] * scale - lse_s[tx + 16 * j]) : 0.0f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - del_s[tx + 16 * j]);  // now dS
      }
    __syncthreads();  // the operand slabs are consumed
    store_t(pt, s, ty, tx, p_bf16 != 0);
    stage(sb, dob, q0, kBQ, sq, dv, kSlab, kLdS, c0);  // dO's slab
    stage(sa, qb, q0, kBQ, sq, d, kSlab, kLdS, c0);    // Q's slab
    __syncthreads();
    accumulate<4>(acc_v, pt, sb, ty, tx, kLdS);  // dV += P^T.dO
    __syncthreads();
    store_t(pt, dp, ty, tx, false);
    __syncthreads();
    accumulate<4>(acc_k, pt, sa, ty, tx, kLdS);  // dK += dS^T.Q
  }

  T* dkb = dk + bh * sk * (long long)d;
  T* dvb = dv_out + bh * sk * (long long)dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + 4 * ty + i;
    if (row >= sk) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = c0 + tx + 16 * kk;
      if (c < d) dkb[(long long)row * d + c] = from_f<T>(acc_k[i][kk] * scale);
      if (c < dv)
        dvb[(long long)row * dv + c] = from_f<T>(
            kl != nullptr ? acc_v[i][kk] + kl[bh * dv + c] : acc_v[i][kk]);
    }
  }
}

// Any widths: one block per (dQ slab, 64-query tile, bh) computes dQ's
// columns [64 slab, 64 slab + 64) of its queries.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
dq_slab_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, int bh_count, int sq, int sk, int d,
               int dv, Mask mask, float scale, int p_bf16, int n_slabs) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);  // 64 x kLdS
  float* sb = sa + 64 * kLdS;                    // 64 x kLdS
  float* pt = sb + 64 * kLdS;                    // kBK x kLdP: dS^T

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
  const T* dob = dout + bh * sq * (long long)dv;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv;
  float lse_r[4], del_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    lse_r[i] = row < sq ? lse[bh * sq + row] : 0.0f;
    del_r[i] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc[i][kk] = 0.0f;

  // the kv tiles the forward visits for this query tile
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int hi = mask.causal ? min(mask.kv_len, last_q + mask.q_offset + 1)
                             : mask.kv_len;
  const int lo = mask.window > 0
      ? max(0, q0 + mask.q_offset - mask.window + 1) : 0;
  const int t_lo = lo / kBK;
  const int t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int c = 0; c < d; c += kSlab) {  // S = Q.K^T: queries x keys
      __syncthreads();  // the slabs (and the last tile's dS^T) consumed
      stage(sa, qb, q0, kBQ, sq, d, kSlab, kLdS, c);
      stage(sb, kb, k0, kBK, mask.kv_len, d, kSlab, kLdS, c);
      __syncthreads();
      patch(s, sa, sb, ty, tx, kSlab, kLdS);
    }
    for (int c = 0; c < dv; c += kSlab) {  // dP = dO.V^T
      __syncthreads();
      stage(sa, dob, q0, kBQ, sq, dv, kSlab, kLdS, c);
      stage(sb, vb, k0, kBK, mask.kv_len, dv, kSlab, kLdS, c, p_bf16 != 0);
      __syncthreads();
      patch(dp, sa, sb, ty, tx, kSlab, kLdS);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mask.ok(q0 + 4 * ty + i, k0 + tx + 16 * j)
            ? expf(s[i][j] * scale - lse_r[i]) : 0.0f;
        dp[i][j] = p * (dp[i][j] - del_r[i]);  // dS
      }
    __syncthreads();  // the operand slabs are consumed
    store_t(pt, dp, ty, tx, false);
    stage(sa, kb, k0, kBK, mask.kv_len, d, kSlab, kLdS, c0);  // K's slab
    __syncthreads();
    accumulate<4>(acc, pt, sa, ty, tx, kLdS);  // dQ += dS.K
  }

  T* dqb = dq + bh * sq * (long long)d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = c0 + tx + 16 * kk;
      if (c < d) dqb[(long long)row * d + c] = from_f<T>(acc[i][kk] * scale);
    }
  }
}

// The arguments of one call: pointers, shapes, mask, scale and the
// p_dtype flag.
struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  const void* kl;
  long long bh, sq, sk, d, dv_w;
  Mask mask;
  float scale;
  int p_bf16;
};

// The Delta pre-pass.
template <typename T>
int launch_delta(const Args& a, cudaStream_t stream) {
  const long long rows = a.bh * a.sq;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, (int)a.dv_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NCK, int NCV>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NCK, NCV>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, NCK, NCV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, NCK, NCV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  err = static_cast<cudaError_t>(launch_delta<T>(a, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nk = (a.sk + kBK - 1) / kBK;
  dkdv_kernel<T, NCK, NCV><<<(unsigned)(nk * a.bh), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<const float*>(a.kl), (int)a.bh, (int)a.sq, (int)a.sk,
      (int)a.d, (int)a.dv_w, a.mask, a.scale, a.p_bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (a.sq + kBQ - 1) / kBQ;
  dq_kernel<T, NCK, NCV><<<(unsigned)(nq * a.bh), kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dq), (int)a.bh,
      (int)a.sq, (int)a.sk, (int)a.d, (int)a.dv_w, a.mask, a.scale,
      a.p_bf16);
  return static_cast<int>(cudaGetLastError());
}

// Widths past kMaxD: the slab kernels.
template <typename T>
int launch_slabs(const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSlabSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_slab_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSlabSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  const float* delta = static_cast<const float*>(a.delta);
  const long long wide = a.d > a.dv_w ? a.d : a.dv_w;
  const long long kv_slabs = (wide + kSlab - 1) / kSlab;
  const long long q_slabs = (a.d + kSlab - 1) / kSlab;
  const long long nk = (a.sk + kBK - 1) / kBK;
  const long long nq = (a.sq + kBQ - 1) / kBQ;
  if (nk * a.bh * kv_slabs > 2147483647LL
      || nq * a.bh * q_slabs > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  err = static_cast<cudaError_t>(launch_delta<T>(a, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_slab_kernel<T><<<(unsigned)(nk * a.bh * kv_slabs), kThreads,
                        kSlabSmem, stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<const float*>(a.kl), (int)a.bh, (int)a.sq, (int)a.sk,
      (int)a.d, (int)a.dv_w, a.mask, a.scale, a.p_bf16, (int)kv_slabs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_slab_kernel<T><<<(unsigned)(nq * a.bh * q_slabs), kThreads, kSlabSmem,
                      stream>>>(
      q, k, v, dout, lse, delta, static_cast<T*>(a.dq), (int)a.bh,
      (int)a.sq, (int)a.sk, (int)a.d, (int)a.dv_w, a.mask, a.scale,
      a.p_bf16, (int)q_slabs);
  return static_cast<int>(cudaGetLastError());
}

// The widths' kernels: both widths padded to the wider one rounded up to a
// multiple of 32 (NCK columns of 16; V, or Q and K, zero-filled past their
// width), or NCV = 8 for a qk width past 160 with dv <= 128 (MLA's 192 /
// 128); past kMaxD the slab kernels.
template <typename T>
int dispatch(const Args& a, cudaStream_t s) {
  const long long wide = a.d > a.dv_w ? a.d : a.dv_w;
  if (wide > kMaxD) return launch_slabs<T>(a, s);
  const int nck = 2 * (int)((wide + 31) / 32);
  if (nck == 12 && a.dv_w <= 128) return launch<T, 12, 8>(a, s);
  switch (nck) {
    case 2: return launch<T, 2, 2>(a, s);
    case 4: return launch<T, 4, 4>(a, s);
    case 6: return launch<T, 6, 6>(a, s);
    case 8: return launch<T, 8, 8>(a, s);
    case 10: return launch<T, 10, 10>(a, s);
    default: return launch<T, 12, 12>(a, s);
  }
}

}  // namespace

// q, dq: (bh, sq, d); k, dk: (bh, sk, d); v, dv: (bh, sk, dv_w); o, dout:
// (bh, sq, dv_w), all of the type `dtype` names (0 float32, 1 bfloat16,
// 2 float16), contiguous; lse: the forward's (bh, sq) float32 row
// log-sum-exp (+1e30 on a row without keys); delta: (bh, sq) float32
// scratch; keyless_dv: NULL, or the (bh, dv_w) float32 dV that every key
// gets from the queries without a key (repro_flash_keyless), added to dv
// before its rounding.  dq, dk and dv are written in full (keys at or past
// kv_len get zeros, plus keyless_dv).  The mask, scale and p_bf16 are the
// forward's.  Three launches on
// `stream`: the Delta pre-pass, the dK/dV pass and the dQ pass.  Returns
// cudaGetLastError() after them, or cudaErrorInvalidValue for a type, d or
// dv_w outside 1..2^20, sk < 1, an sq, sk, |q_offset| or window past 2^28,
// or a grid the launch cannot hold.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, const void* keyless_dv, long long bh, long long sq,
    long long sk, long long d,
    long long dv_w, int causal, long long q_offset, long long window,
    long long kv_len, float scale, int p_bf16, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > (1LL << 20) || dv_w <= 0 || dv_w > (1LL << 20)
      || sk <= 0 || dtype < 0 || dtype > 2
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28)
      || ((sq + kBQ - 1) / kBQ) * bh > 2147483647LL
      || ((sk + kBK - 1) / kBK) * bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal, (int)q_offset, (int)window,
                  (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len),
                  (int)sq};
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, keyless_dv, bh, sq,
               sk, d, dv_w, mask, scale, p_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return dispatch<__nv_bfloat16>(a, s);
    case 2: return dispatch<__half>(a, s);
    default: return dispatch<float>(a, s);
  }
}
