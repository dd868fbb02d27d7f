// The backward of the fused flash attention (K7) for bf16 operands, on the
// tensor cores of a Hopper GPU (sm_90a): dq, dk and dv of
// o = softmax(q.k^T * scale, masked) . v for q of (BH, Sq, D), k of
// (BH, Sk, D), v of (BH, Sk, Dv), Dv <= D, with D <= kMaxD or (MLA's
// build) D <= kWideD and Dv <= kWideDV, under the forward's masks: key j
// is valid for query i iff j < kv_len, j <= i + q_offset when causal, and
// j > i + q_offset - window when window > 0.  The bf16 route of K7's
// gradient (kernels/flash_attention.py, bwd_route); float32 operands and
// the other heads past 128 go to flash_attention_bwd.cu, on the CUDA
// cores.
//
// Replaces no Pallas kernel: the reference's training differentiates its
// chunked attention (repro/models/attention.py:32) with XLA's autodiff and
// has no Pallas backward.  It computes what
// flash_attention_masked_bwd_plain computes: Delta = sum(do * o) a row,
// P = exp(S * scale - lse) (0 on invalid pairs), dV = P^T.dO,
// dS = P * (dO.V^T - Delta), dQ = dS.K * scale, dK = dS^T.Q * scale, in
// float32 from the bf16 operands, each gradient rounded once to bf16.
//
// What bounds it on an H100: operations.  A valid pair needs 6 D + 4 Dv
// FLOP (S, dQ and dK over D; dP and dV over Dv); this kernel's own work is
// 16 D + 10 Dv: S and dP in both passes (4 D + 4 Dv), and dV, dK and dQ
// each with a three-term A operand (6 Dv + 12 D).  At granite-3-2b's
// training shape (BH 64 = 2 x 32 heads, S 2,048, D 64, causal) the
// 1.343e8 valid pairs need 8.6e10 FLOP, 0.087 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 134 MB of operands and gradients (0.04 ms at
// 3.35 TB/s); its own work is 2.24e11 FLOP, 0.226 ms.  At
// DeepSeek-V2-Lite's (BH 32 = 2 x 16 heads, S 2,048, MLA's D 192 / Dv
// 128) the 6.71e7 pairs need 1,664 FLOP each, 1.12e11, 0.113 ms; its own
// 4,352 a pair, 2.92e11, 0.295 ms.
//
// Design (what it does about that bound): every product on the tensor
// cores with wgmma, bf16 operands and float32 accumulators.
//   1. delta_kernel: Delta_i = sum_c do_ic * o_ic in float32, one warp a
//      row, a butterfly sum in one order (as in flash_attention_bwd.cu).
//   2. dkdv_kernel: one block of two warpgroups per (bh, kRows keys), each
//      warpgroup owning 64 keys; the heaviest key blocks first.  K and V
//      are staged once; the loop runs over the kBT-query tiles (kWideBT
//      in MLA's build) that may see a key of the block (from the causal
//      diagonal to the window's far edge), in ascending order.  Per tile,
//      S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16, m64n32k16 in MLA's
//      build, both operands K-major from SW128
//      panels; bf16 products are exact in float32; two commit groups, so
//      that P^T is computed while dP^T runs), then on the accumulator
//      fragments P^T = 2^(S^T * scale * log2 e - lse * log2 e)
//      (ex2.approx) and dS^T = P^T * (dP^T - Delta), lse and Delta indexed
//      by the fragment's column (the query) from shared memory.  Pairs are
//      masked elementwise only on tiles that reach past kv_len, Sq, a
//      diagonal or a window edge.  dV += P^T.dO and dK += dS^T.Q take P^T
//      and dS^T from registers: the m64n64 accumulator layout is the A
//      fragment layout of the following m64k16 products, so nothing goes
//      through shared memory; dO and Q are the B operands read MN-major
//      (transpose bit) from the same SW128 tiles that were K-major
//      operands a moment before.  A warpgroup skips a tile none of whose
//      queries sees one of its keys.
//   3. dq_kernel: one block of two warpgroups per (bh, kRows queries), 64
//      queries a warpgroup, the heaviest query blocks first, over the
//      kBT-key tiles the forward visits, in ascending order: S = Q.K^T,
//      dP = dO.V^T (P again while dP runs), dS = P * (dP - Delta) with lse
//      and Delta of the thread's two rows in registers, dQ += dS.K with dS
//      from registers and K MN-major, as the forward's P.V.
//   P and dS go into their products as kTerms bf16 terms each,
//   t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1 - t2), multiplied
//   into the same float32 accumulator: float32 precision, as the forward
//   carries P.  dK and dQ are scaled once, at the end.
//   Staging: a two-stage ring of cp.async 16-byte zero-fill copies (the
//   Q / dO tiles with their lse and Delta in the dK/dV pass, the K / V
//   tiles in the dQ pass): the next tile's copies are in flight while this
//   one multiplies.  Element by element where D % 8 != 0 or a pointer is
//   not 16-byte aligned.  No TMA, no producer warp, no setmaxnreg.
//   Determinism: each of dq, dk and dv is written by one warpgroup after a
//   loop in a fixed order; no atomics, no sums across blocks, so a
//   gradient is the same bits run to run.
//   Widths: the square builds pad the qk width with zeros to DQ, a
//   multiple of 32 up to kMaxD, and the value width to DV = DQ (V and dO
//   zero-filled past Dv).  Registers bound the width: in the dK/dV pass
//   dK, dV, S^T and dP^T hold 32 floats a thread each at D = 64 (64 each
//   of dK and dV at D = 128), and each 16-query step's bf16 terms of P^T
//   and dS^T 24 more while its products run.  ptxas: 211 registers a
//   thread at D = 64, 242 at 96, 255 at 128, no spill.  MLA's build
//   (kWideD 192 / kWideDV 128, for any D in 129..192 with Dv <= 128) holds
//   dK's 96 floats and dV's 64: its dK/dV pass streams kWideBT = 32-query
//   tiles, so that S^T and dP^T are m64n32, 16 floats each, and splits a
//   step's terms only once the step before it is done (one step's 24
//   live); 255 registers, no spill.  Its dQ pass keeps the 64-key tiles
//   (dQ 96 floats, S and dP 32 each: 219 registers).  Every other head
//   past 128 runs on the CUDA cores.  One block an SM (256 threads; 66 KB
//   of shared memory at D = 64, 130 KB at 96 and 128; 122 KB in MLA's
//   dK/dV pass, 161 KB in its dQ pass).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::sw128;
using hopper::sw128_desc;

constexpr int kWG = 2;          // consumer warpgroups per block
constexpr int kThreads = 256;   // 128 * kWG
constexpr int kRows = 128;      // keys (dK/dV pass) or queries (dQ pass) a block
constexpr int kBT = 64;         // queries (dK/dV pass) or keys (dQ pass) a tile
constexpr int kStages = 2;      // ring depth of the streamed tiles
constexpr int kTerms = 3;       // bf16 terms of P and dS
constexpr int kMaxD = 128;      // the widest qk width of the square builds
constexpr int kWideD = 192;     // the qk width of MLA's build
constexpr int kWideDV = 128;    //   its value width
constexpr int kWideBT = 32;     //   the queries of its dK/dV pass's tile
constexpr uint32_t kTile = kBT * 128;     // a 64-column panel of a streamed tile
constexpr uint32_t kPanel = kRows * 128;  // a 64-column panel of a block's rows
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kThreads == 128 * kWG && kRows == 64 * kWG, "warpgroups");

// Columns of panel p of a DP-wide tile.
template <int DP>
__device__ constexpr int panel_cols(int p) {
  return (p + 1) * 64 <= DP ? 64 : DP - 64 * p;
}

// Keep the compiler from moving accesses of the accumulator values a
// DP-wide tile uses across a wgmma region.
template <int DP, int NP>
__device__ __forceinline__ void fence_acc(float (&acc)[NP][32]) {
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (i < panel_cols<DP>(p) / 2)
        asm volatile("" : "+f"(acc[p][i]) :: "memory");
}

// Rows [r0, r0 + rows) of an (s_len x d) bf16 matrix into the DP-wide SW128
// tile at shared address `tile` (panels `rows` x 128 bytes apart): zeros
// past s_len and past d.  vec: whole 16-byte chunks by cp.async (d % 8 == 0
// and 16-byte aligned rows); else element by element.
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int s_len, int d,
                                          bool vec) {
  const uint32_t panel = rows * 128;
  if (vec) {
    constexpr int kChunks = DP / 8;
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int ch = e - r * kChunks;
      const int row = r0 + r;
      const bool ok = row < s_len && ch * 8 < d;
      hopper::cp_async_16(tile + (ch >> 3) * panel + sw128(r, ch & 7),
                          ok ? src + (long long)row * d + ch * 8 : src,
                          ok ? 16 : 0);
    }
  } else {
    const uint16_t* bits = reinterpret_cast<const uint16_t*>(src);
    for (int e = threadIdx.x; e < rows * DP; e += kThreads) {
      const int r = e / DP;
      const int c = e - r * DP;
      const int row = r0 + r;
      hopper::st_shared_u16(
          tile + (c >> 6) * panel + sw128(r, (c >> 3) & 7) + (c & 7) * 2,
          row < s_len && c < d ? bits[(long long)row * d + c] : 0);
    }
  }
}

// lse and Delta of the queries [q0, q0 + BT) into 2 * BT floats at shared
// address `dst` (lse first), zeros past sq.
template <int BT>
__device__ __forceinline__ void load_stats(uint32_t dst,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int q0, int sq) {
  const int t = threadIdx.x;
  if (t < 2 * BT) {
    const int r = t & (BT - 1);
    const bool ok = q0 + r < sq;
    const float* src = (t < BT ? lse : delta) + q0 + r;
    hopper::cp_async_4(dst + 4 * t, ok ? src : lse, ok ? 4 : 0);
  }
}

// The A fragments of 16 columns (kk) of an m64n(2 N) accumulator x as
// kTerms bf16 terms: values 8 kk .. 8 kk + 7, pairwise (rows r, r + 8, r,
// r + 8).
template <int N>
__device__ __forceinline__ void split_terms(const float (&x)[N], int kk,
                                            uint32_t (&a)[kTerms][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float u = x[8 * kk + 2 * r], w = x[8 * kk + 2 * r + 1];
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      const __nv_bfloat162 t2 = __floats2bfloat162_rn(u, w);
      const float2 back = __bfloat1622float2(t2);
      a[term][r] = hopper::bf16x2_bits(t2);
      u -= back.x;  // exact: the term is within half a bf16 step
      w -= back.y;
    }
  }
}

// acc[p] += A . B for each 64-column panel p of a DP-wide B operand read
// MN-major (transpose bit) from the BT-row SW128 tile at `b` (panels
// BT * 128 bytes apart), rows 16 kk .. 16 kk + 15; A in kTerms register
// terms.
template <int DP, int NP, int BT = kBT>
__device__ __forceinline__ void mma_terms(float (&acc)[NP][32],
                                          const uint32_t (&a)[kTerms][4],
                                          uint32_t b, int kk) {
  constexpr uint32_t tile = BT * 128;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint64_t desc = sw128_desc(b + p * tile + kk * 2048, tile, 1024);
#pragma unroll
    for (int term = 0; term < kTerms; ++term) {
      if (panel_cols<DP>(p) == 64)
        hopper::wgmma_rs_m64n64k16(acc[p], a[term], desc);
      else
        hopper::wgmma_rs_m64n32k16(acc[p], a[term], desc);
    }
  }
}

// s (+)= A . B^T over DP columns in steps of 16: A the 64 rows at `a`
// (panels pa bytes apart), B the BT rows at `b` (panels BT * 128 bytes
// apart), both K-major SW128; s the m64n(BT) accumulator.
template <int DP, int BT = kBT>
__device__ __forceinline__ void mma_kmajor(float (&s)[BT / 2], uint32_t a,
                                           uint32_t pa, uint32_t b) {
  constexpr uint32_t tile = BT * 128;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = sw128_desc(a + (kk >> 2) * pa + off, 16, 1024);
    const uint64_t db = sw128_desc(b + (kk >> 2) * tile + off, 16, 1024);
    if constexpr (BT == 64)
      hopper::wgmma_ss_m64n64k16(s, da, db, kk > 0);
    else
      hopper::wgmma_ss_m64n32k16(s, da, db, kk > 0);
  }
}

// One DP-wide accumulator (rows row0 and row0 + 8 of this thread, times
// `mul`) into an (n_rows x d) bf16 matrix.
template <int DP, int NP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[NP][32],
                                           int row0, int n_rows, int d,
                                           int col0, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n_rows) continue;
    __nv_bfloat16* orow = out + (long long)row * d;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= panel_cols<DP>(p)) continue;
        const int c = 64 * p + 8 * j + col0;
        const float x = acc[p][4 * j + 2 * h] * mul;
        const float y = acc[p][4 * j + 2 * h + 1] * mul;
        if (c + 1 < d && (d & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x, y);
        } else {
          if (c < d) orow[c] = __float2bfloat16(x);
          if (c + 1 < d) orow[c + 1] = __float2bfloat16(y);
        }
      }
  }
}

struct Mask {
  int causal, q_offset, window, kv_len, sq;
  // query p (in key coordinates) sees the keys [key_lo(p), key_hi(p)),
  // both nondecreasing in p
  __device__ __forceinline__ int key_lo(int p) const {
    return window > 0 ? p - window + 1 : 0;
  }
  __device__ __forceinline__ int key_hi(int p) const {
    return causal ? min(kv_len, p + 1) : kv_len;
  }
  __device__ __forceinline__ bool ok(int qi, int kj) const {
    const int p = qi + q_offset;
    return qi < sq && kj >= key_lo(p) && kj < key_hi(p);
  }
};

// Delta[r] = sum_c do[r][c] * o[r][c] in float32, one warp a row (lanes
// over the columns, then a butterfly sum: one order on every run).
__global__ void __launch_bounds__(kThreads)
delta_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, long long rows, int dv) {
  const long long row = (long long)blockIdx.x * (kThreads / 32)
                        + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < dv; c += 32)
    s = fmaf(__bfloat162float(dout[row * dv + c]),
             __bfloat162float(o[row * dv + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Shared memory of the dQ pass: Q and dO of the block, the K / V ring,
// and 1024 bytes to align the panels.
template <int DQ, int DV>
constexpr int dq_smem() {
  return 1024 + ((DQ + 63) / 64 + (DV + 63) / 64)
                    * ((int)kPanel + kStages * (int)kTile);
}

// Shared memory of the dK/dV pass: K and V of the block, the ring of
// BT-query Q / dO tiles (at BT = kBT the same bytes as the dQ pass's), and
// lse and Delta of each stage.
template <int DQ, int DV, int BT>
constexpr int dkdv_smem() {
  return 1024 + ((DQ + 63) / 64 + (DV + 63) / 64)
                    * ((int)kPanel + kStages * BT * 128)
         + kStages * 2 * BT * 4;
}

// One block per (bh, kRows keys): dK and dV of its keys, over BT-query
// tiles.
template <int DQ, int DV, int BT>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv_out,
            int bh_count, int sk, int d, int dv, Mask mask, float scale,
            float scale_log2, int vec) {
  constexpr int NQ = (DQ + 63) / 64;  // 64-column panels of Q, K and dK
  constexpr int NV = (DV + 63) / 64;  // of V, dO and dV
  constexpr uint32_t tile = BT * 128;  // a 64-column panel of a Q / dO tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = hopper::smem_addr(smem_raw);
  const uint32_t ks = (base + 1023) & ~1023u;  // K: NQ panels of kRows rows
  const uint32_t vs = ks + NQ * kPanel;        // V: NV panels
  // stage st: Q panels at qs(st), dO panels NQ * tile after
  const uint32_t ring = vs + NV * kPanel;
  auto qs = [&](int st) { return ring + st * (NQ + NV) * tile; };
  // stage st's lse and Delta: 2 * BT floats
  const uint32_t stats = ring + kStages * (NQ + NV) * tile;
  const float* stats_f =
      reinterpret_cast<const float*>(smem_raw + (stats - base));

  const int sq = mask.sq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int kt = (int)(blockIdx.x / bh_count);  // early keys (most work) first
  const long long bh = blockIdx.x % bh_count;
  const int k0 = kt * kRows;
  const __nv_bfloat16* qb = q + bh * sq * (long long)d;
  const __nv_bfloat16* kb = k + bh * sk * (long long)d;
  const __nv_bfloat16* vb = v + bh * sk * (long long)dv;
  const __nv_bfloat16* dob = dout + bh * sq * (long long)dv;
  const float* lb = lse + bh * sq;
  const float* db = delta + bh * sq;

  // the query tiles [t_lo, t_hi) that hold the queries [i_lo, i_hi) that
  // may see a key of [k0, k1)
  const int k1 = min(k0 + kRows, mask.kv_len);
  int i_lo = 0, i_hi = sq;
  if (mask.causal) i_lo = max(0, k0 - mask.q_offset);
  if (mask.window > 0) i_hi = min(sq, k1 - 1 + mask.window - mask.q_offset);
  if (k0 >= mask.kv_len) i_hi = i_lo;
  const int t_lo = i_lo / BT;
  const int t_hi = i_hi > i_lo ? (i_hi + BT - 1) / BT : t_lo;

  auto load_q = [&](int st, int t) {
    load_tile<DQ>(qs(st), qb, t * BT, BT, sq, d, vec);
    load_tile<DV>(qs(st) + NQ * tile, dob, t * BT, BT, sq, dv, vec);
    load_stats<BT>(stats + st * 2 * BT * 4, lb, db, t * BT, sq);
  };
  if (t_lo < t_hi) {
    load_tile<DQ>(ks, kb, k0, kRows, mask.kv_len, d, vec);
    load_tile<DV>(vs, vb, k0, kRows, mask.kv_len, dv, vec);
    load_q(0, t_lo);
    hopper::cp_async_commit();
  }

  // This thread's accumulator rows (keys r and r + 8) and first column
  // (query): value i of a 64 x N accumulator sits at row
  // 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
  // 2 * (lane % 4) + i % 2.
  const int kw0 = k0 + 64 * wg;  // this warpgroup's first key
  const int row0 = kw0 + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t k_wg = ks + wg * 64 * 128;
  const uint32_t v_wg = vs + wg * 64 * 128;

  float s[BT / 2], dp[BT / 2];
  float dk_acc[NQ][32], dv_acc[NV][32];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < NQ; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = 0.0f;
#pragma unroll
  for (int p = 0; p < NV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[p][i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) load_q((t + 1 - t_lo) % kStages, t + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and K, V) have landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int q0 = t * BT;
    const int q_last = min(q0 + BT, sq) - 1;
    // some query of the tile sees a key of this warpgroup
    if (kw0 < mask.key_hi(q_last + mask.q_offset)
        && kw0 + 64 > mask.key_lo(q0 + mask.q_offset)) {
      const uint32_t qt = qs(st);
      const uint32_t dot = qt + NQ * tile;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      mma_kmajor<DQ, BT>(s, k_wg, kPanel, qt);    // S^T = K.Q^T
      hopper::wgmma_commit();
      mma_kmajor<DV, BT>(dp, v_wg, kPanel, dot);  // dP^T = V.dO^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S^T is done, dP^T may still run
      hopper::fence_regs(s);

      // P^T and dS^T; every pair of the tile is valid unless it reaches
      // past Sq, or some key of the warpgroup lies outside some query's
      // range
      const bool edge = q0 + BT > sq
          || kw0 < mask.key_lo(q0 + BT - 1 + mask.q_offset)
          || kw0 + 64 > mask.key_hi(q0 + mask.q_offset);
      const float* lse_t = stats_f + st * 2 * BT;
      const float* del_t = lse_t + BT;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + col0);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float p = hopper::ex2(
                fmaf(s[i], scale_log2, -(e ? l2.y : l2.x) * kLog2e));
            if (edge && !mask.ok(q0 + 8 * j + col0 + e, row0 + 8 * h))
              p = 0.0f;
            s[i] = p;
          }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(del_t + 8 * j + col0);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i)
          dp[i] = s[i] * (dp[i] - (i & 1 ? dl.y : dl.x));
      }

      // dV += P^T.dO and dK += dS^T.Q in BT / 16 steps of 16 queries, a
      // commit group each: a step's terms are computed while the tensor
      // cores run the step before it, and once that step's group is done
      // its terms' registers are free again (at D = 128 the dK/dV pass
      // then fits 255 registers a thread without a spill).  MLA's build
      // (BT < kBT) holds dK's 96 floats a thread: it waits for a step's
      // products before it splits the next step's terms, so that only one
      // step's terms are live
      uint32_t pa[BT / 16][kTerms][4], da[BT / 16][kTerms][4];
      fence_acc<DV>(dv_acc);
      fence_acc<DQ>(dk_acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        if (BT < kBT && kk > 0) hopper::wgmma_wait<0>();
        split_terms(s, kk, pa[kk]);
        split_terms(dp, kk, da[kk]);
        hopper::wgmma_fence();
        mma_terms<DV, NV, BT>(dv_acc, pa[kk], dot, kk);
        mma_terms<DQ, NQ, BT>(dk_acc, da[kk], qt, kk);
        hopper::wgmma_commit();
        if (kk > 0) hopper::wgmma_wait<1>();  // step kk - 1 is done
      }
      hopper::wgmma_wait<0>();
      fence_acc<DV>(dv_acc);
      fence_acc<DQ>(dk_acc);
    }
    __syncthreads();  // stage st is consumed before it is loaded again
  }

  store_rows<DQ>(dk + bh * sk * (long long)d, dk_acc, row0, sk, d, col0,
                 scale);
  store_rows<DV>(dv_out + bh * sk * (long long)dv, dv_acc, row0, sk, dv,
                 col0, 1.0f);
}

// One block per (bh, kRows queries): dQ of its queries.
template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int bh_count, int sk, int d,
          int dv, Mask mask, float scale, float scale_log2, int vec) {
  constexpr int NQ = (DQ + 63) / 64;
  constexpr int NV = (DV + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + NQ * kPanel;
  // stage st: K panels at ks(st), V panels NQ * kTile after
  const uint32_t ring = dos + NV * kPanel;
  auto ks = [&](int st) { return ring + st * (NQ + NV) * kTile; };

  const int sq = mask.sq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int nq = (sq + kRows - 1) / kRows;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);  // heaviest first
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kRows;
  const __nv_bfloat16* kb = k + bh * sk * (long long)d;
  const __nv_bfloat16* vb = v + bh * sk * (long long)dv;

  // the key tiles [t_lo, t_hi) that hold the keys [lo, hi) some query of
  // this block may see: the forward's
  const int last_q = min(q0 + kRows, sq) - 1;
  const int hi = mask.key_hi(last_q + mask.q_offset);
  const int lo = max(0, mask.key_lo(q0 + mask.q_offset));
  const int t_lo = lo / kBT;
  const int t_hi = hi > lo ? (hi + kBT - 1) / kBT : t_lo;

  if (t_lo < t_hi) {
    load_tile<DQ>(qs, q + bh * sq * (long long)d, q0, kRows, sq, d, vec);
    load_tile<DV>(dos, dout + bh * sq * (long long)dv, q0, kRows, sq, dv,
                  vec);
    load_tile<DQ>(ks(0), kb, t_lo * kBT, kBT, mask.kv_len, d, vec);
    load_tile<DV>(ks(0) + NQ * kTile, vb, t_lo * kBT, kBT, mask.kv_len, dv,
                  vec);
    hopper::cp_async_commit();
  }

  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // this warpgroup's queries p0 .. p0 + 63: some of them see a key of
  // [some_lo, some_hi), all of them every key of [all_lo, all_hi); this
  // thread's two rows see [lo_r[h], hi_r[h])
  const int p0 = wg_q0 + mask.q_offset;
  const int some_lo = mask.key_lo(p0), some_hi = mask.key_hi(p0 + 63);
  const int all_lo = mask.key_lo(p0 + 63), all_hi = mask.key_hi(p0);
  const int lo_r[2] = {mask.key_lo(row0 + mask.q_offset),
                       mask.key_lo(row0 + 8 + mask.q_offset)};
  const int hi_r[2] = {mask.key_hi(row0 + mask.q_offset),
                       mask.key_hi(row0 + 8 + mask.q_offset)};
  // lse in the log2 domain, negated, and Delta of the two rows
  float nl_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    nl_r[h] = row < sq ? -lse[bh * sq + row] * kLog2e : 0.0f;
    del_r[h] = row < sq ? delta[bh * sq + row] : 0.0f;
  }
  const uint32_t q_wg = qs + wg * 64 * 128;
  const uint32_t do_wg = dos + wg * 64 * 128;

  float s[32], dp[32];
  float acc[NQ][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < NQ; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) {
      const uint32_t nxt = ks((t + 1 - t_lo) % kStages);
      load_tile<DQ>(nxt, kb, (t + 1) * kBT, kBT, mask.kv_len, d, vec);
      load_tile<DV>(nxt + NQ * kTile, vb, (t + 1) * kBT, kBT, mask.kv_len,
                    dv, vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and Q, dO) have landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = t * kBT;
    if (k0 + kBT > some_lo && k0 < some_hi) {  // a query here sees a key
      const uint32_t kt = ks(st);
      const uint32_t vt = kt + NQ * kTile;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      mma_kmajor<DQ>(s, q_wg, kPanel, kt);    // S = Q.K^T
      hopper::wgmma_commit();
      mma_kmajor<DV>(dp, do_wg, kPanel, vt);  // dP = dO.V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is done, dP may still run
      hopper::fence_regs(s);

      // dS = P * (dP - Delta); mask only the tiles where some key is
      // invalid for some query of this warpgroup, against each row's
      // bounds moved to this thread's first column of the tile
      const bool edge = k0 < all_lo || k0 + kBT > all_hi;
      const int c0 = k0 + col0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        float p = hopper::ex2(fmaf(s[i], scale_log2, nl_r[h]));
        if (edge) {
          const int key = 8 * (i >> 2) + (i & 1);  // past c0
          if (key < lo_r[h] - c0 || key >= hi_r[h] - c0) p = 0.0f;
        }
        s[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - del_r[(i >> 1) & 1]);

      // dQ += dS.K in four steps of 16 keys, a commit group each
      uint32_t da[4][kTerms][4];
      fence_acc<DQ>(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_terms(dp, kk, da[kk]);
        hopper::wgmma_fence();
        mma_terms<DQ>(acc, da[kk], kt, kk);
        hopper::wgmma_commit();
        if (kk > 0) hopper::wgmma_wait<1>();  // step kk - 1 is done
      }
      hopper::wgmma_wait<0>();
      fence_acc<DQ>(acc);
    }
    __syncthreads();  // stage st is consumed before it is loaded again
  }

  store_rows<DQ>(dq + bh * sq * (long long)d, acc, row0, sq, d, col0, scale);
}

// The arguments of one call: pointers, shapes, mask and scale.
struct Args {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  long long bh, sq, sk, d, dv_w;
  Mask mask;
  float scale;
};

// The three launches at tile widths (DQ, DV), the dK/dV pass over BT-query
// tiles.
template <int DQ, int DV, int BT = kBT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem_kv = dkdv_smem<DQ, DV, BT>(), smem_q = dq_smem<DQ, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<DQ, DV, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<DQ, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* delta = static_cast<float*>(a.delta);
  const int vec = a.d % 8 == 0 && a.dv_w % 8 == 0
      && ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k)
           | reinterpret_cast<uintptr_t>(a.v)
           | reinterpret_cast<uintptr_t>(a.dout)) & 15) == 0;
  // the scale and log2(e) in one float, for exp2
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  const long long rows = a.bh * a.sq;
  const int rows_per_block = kThreads / 32;
  delta_kernel<<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                 kThreads, 0, stream>>>(static_cast<const bf16*>(a.o), dout,
                                        delta, rows, (int)a.dv_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nk = (a.sk + kRows - 1) / kRows;
  dkdv_kernel<DQ, DV, BT><<<(unsigned)(nk * a.bh), kThreads, smem_kv,
                             stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), (int)a.bh, (int)a.sk, (int)a.d, (int)a.dv_w,
      a.mask, a.scale, scale_log2, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (a.sq + kRows - 1) / kRows;
  dq_kernel<DQ, DV><<<(unsigned)(nq * a.bh), kThreads, smem_q, stream>>>(
      q, k, v, dout, lse, delta, static_cast<bf16*>(a.dq), (int)a.bh,
      (int)a.sk, (int)a.d, (int)a.dv_w, a.mask, a.scale, scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq: (bh, sq, d); k, dk: (bh, sk, d); v, dv: (bh, sk, dv_w); o, dout:
// (bh, sq, dv_w), all bfloat16, contiguous; lse: the forward's (bh, sq)
// float32 row log-sum-exp; delta: (bh, sq) float32 scratch.  dq, dk and dv
// are written in full (keys at or past kv_len get zeros).  The mask and
// scale are the forward's.  Three launches on `stream`: the Delta
// pre-pass, the dK/dV pass and the dQ pass.  Returns cudaGetLastError()
// after them, or cudaErrorInvalidValue for d < 1, dv_w outside 1..d, a
// head no build takes (d past kMaxD unless d <= kWideD and dv_w <=
// kWideDV: MLA's build), sk < 1, an sq, sk, |q_offset| or window past
// 2^28, or a grid the launch cannot hold.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, long long bh, long long sq, long long sk, long long d,
    long long dv_w, int causal, long long q_offset, long long window,
    long long kv_len, float scale, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (d <= 0 || dv_w <= 0 || dv_w > d || sk <= 0
      || (d > kMaxD && (d > kWideD || dv_w > kWideDV))
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28)
      || ((sq + kRows - 1) / kRows) * bh > 2147483647LL
      || ((sk + kRows - 1) / kRows) * bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal, (int)q_offset, (int)window,
                  (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len),
                  (int)sq};
  const Args a{q, k, v, o, lse, dout, dq, dk, dv, delta, bh, sq, sk, d,
               dv_w, mask, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > kMaxD) return launch<kWideD, kWideDV, kWideBT>(a, s);
  switch ((d + 31) / 32) {
    case 1: return launch<32, 32>(a, s);
    case 2: return launch<64, 64>(a, s);
    case 3: return launch<96, 96>(a, s);
    default: return launch<128, 128>(a, s);
  }
}
