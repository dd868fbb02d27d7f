// The backward of the fused flash attention (K7) for 16-bit operands, on
// the tensor cores of a Hopper GPU (sm_90a): dq, dk and dv of
// o = softmax(q.k^T * scale, masked) . v for q of (BH, Sq, D), k of
// (BH, Sk, D), v of (BH, Sk, Dv), D and Dv up to kSplitD, under the
// forward's masks: key j is valid for query i iff j < kv_len,
// j <= i + q_offset when causal, and j > i + q_offset - window when
// window > 0.  The bf16 and float16 route of K7's gradient
// (kernels/flash_attention.py, bwd_route); float32 operands and wider heads
// go to flash_attention_bwd.cu, on the CUDA cores.  Built by
// flash_attention_bwd_wgmma.cu (bf16), flash_attention_bwd_wgmma_f16.cu
// (float16), both up to 192 columns, and flash_attention_bwd_wgmma_wide.cu
// (both types, the <kSplitD, kSplitD> build), each an entry point.
//
// Replaces no Pallas kernel: the reference's training differentiates its
// chunked attention (repro/models/attention.py:32) with XLA's autodiff and
// has no Pallas backward.  It computes what
// flash_attention_masked_bwd_plain computes: Delta = sum(do * o) a row,
// P = exp(S * scale - lse) (0 on invalid pairs), dV = P^T.dO,
// dS = P * (dP - Delta), dQ = dS.K * scale, dK = dS^T.Q * scale, in
// float32 from the 16-bit operands, each gradient rounded once to their
// type; under p_dtype with V rounded to bf16 in dP = dO.V^T and P in
// P^T.dO; the dV of the queries without a key added before dV rounds.
//
// What bounds it on an H100: operations.  A valid pair needs 6 D + 4 Dv
// FLOP (S, dQ and dK over D; dP and dV over Dv); the square builds' own
// work is 16 D + 10 Dv: S and dP in both passes (4 D + 4 Dv), and dV, dK
// and dQ each with a three-term A operand (6 Dv + 12 D).  At granite-3-2b's
// training shape (BH 64 = 2 x 32 heads, S 2,048, D 64, causal) the
// 1.343e8 valid pairs need 8.6e10 FLOP, 0.087 ms at the 989 TFLOP/s bf16
// tensor-core rate, against 134 MB of operands and gradients (0.04 ms at
// 3.35 TB/s); its own work is 2.24e11 FLOP, 0.226 ms.  At
// DeepSeek-V2-Lite's (BH 32 = 2 x 16 heads, S 2,048, MLA's D 192 / Dv
// 128) the 6.71e7 pairs need 1,664 FLOP each, 1.12e11, 0.113 ms; its own
// 4,352 a pair, 2.92e11, 0.295 ms.  At D = Dv = 256 (BH 16, S 2,048) the
// 3.36e7 pairs need 8.6e10 FLOP, 0.087 ms; the split build's own work is
// 18 D + 10 Dv a pair (S three times), 2.4e11, 0.24 ms.
//
// Design (what it does about that bound): every product on the tensor
// cores with wgmma, 16-bit operands and float32 accumulators.
//   1. delta_kernel (flash_wgmma_common.cuh): Delta_i = sum_c do_ic * o_ic
//      in float32, one warp a row, a butterfly sum in one order.
//   2. dkdv_kernel: one block of two warpgroups per (bh, kRows keys), each
//      warpgroup owning 64 keys; the heaviest key blocks first.  K and V
//      are staged once; the loop runs over the BT-query tiles that may see
//      a key of the block (from the causal diagonal to the window's far
//      edge), in ascending order.  Per tile, S^T = K.Q^T and
//      dP^T = V.dO^T (wgmma m64nBTk16, both operands K-major from SW128
//      panels; 16-bit products are exact in float32; two commit groups, so
//      that P^T is computed while dP^T runs), then on the accumulator
//      fragments P^T = 2^(S^T * scale * log2 e - lse * log2 e)
//      (ex2.approx) and dS^T = P^T * (dP^T - Delta), lse and Delta indexed
//      by the fragment's column (the query) from shared memory.  Pairs are
//      masked elementwise only on tiles that reach past kv_len, Sq, a
//      diagonal or a window edge.  dV += P^T.dO and dK += dS^T.Q take P^T
//      and dS^T from registers: the accumulator layout is the A fragment
//      layout of the following m64k16 products, so nothing goes through
//      shared memory; dO and Q are the B operands read MN-major (transpose
//      bit) from the same SW128 tiles that were K-major operands a moment
//      before.  A warpgroup skips a tile none of whose queries sees one of
//      its keys.
//   3. dq_kernel: one block of two warpgroups per (bh, kRows queries), 64
//      queries a warpgroup, the heaviest query blocks first, over the
//      BK-key tiles the forward visits, in ascending order: S = Q.K^T,
//      dP = dO.V^T (P again while dP runs), dS = P * (dP - Delta) with lse
//      and Delta of the thread's two rows in registers, dQ += dS.K with dS
//      from registers and K MN-major, as the forward's P.V.
//   P and dS go into their products as NT terms of T each (three bf16
//   terms, 2^-24 of the value, or two f16 terms, 2^-22: one term of either
//   type misses chip_smoke.py's backward gate, tests/test_torch_flash_bwd.py
//   emulates each), multiplied into the same float32 accumulator.  f16's P
//   is carried as p * kF16PScale, dV scaled back at its store; f16's dS
//   as dS * 2^e, one power of two a bh (ds_scale: from the bound 2 max_i
//   |dO_i| max_j |V_j| that ds_stats_kernel gathers, kF16DsLog2; folded
//   into dP's multiplier and Delta, exactly), so that a large dS does not
//   overflow f16 and a small one keeps normal f16 terms; bf16's dS, in
//   float32's range, as it is.  dK and dQ are scaled once, at the end (by
//   scale / 2^e: exact).
//   Staging: a two-stage ring of cp.async 16-byte zero-fill copies (the
//   Q / dO tiles with their lse and Delta in the dK/dV pass, the K / V
//   tiles in the dQ pass): the next tile's copies are in flight while this
//   one multiplies.  Element by element where D % 8 != 0 or a pointer is
//   not 16-byte aligned.  No TMA, no producer warp, no setmaxnreg.
//   Determinism: each of dq, dk and dv is written by one warpgroup after a
//   loop in a fixed order; no atomics, no sums across blocks, so a
//   gradient is the same bits run to run.
//   p_dtype (PR): the forward rounded P and V to bf16 before P.V; the
//   backward takes that rounding's gradient as the identity, as JAX's
//   gradient of a cast is: dV = P^T.dO with P rounded to bf16, one term (in
//   f16, bf16(p) * 2^15 is an f16 number for p >= 2^-32), and dP = dO.V^T
//   with V rounded to bf16: bf16's V already is; f16's V is rounded and
//   halved in shared memory once it has landed, f16(bf16(v) / 2)
//   (round_tile_bf16_half), and dP is doubled back (exact).  dS keeps its
//   NT terms.
//   Keyless rows: the dV every key gets from the queries without a key
//   (flash_attention.cu's keyless pass, float32) comes in as kl and is
//   added to dV before dV rounds; their lse is +1e30, so their P is 0.
//   Widths: the square builds pad the qk width with zeros to DQ, a
//   multiple of 32 up to kMaxD, and the value width to DV = DQ (V and dO
//   zero-filled past Dv; Q and K past D where Dv > D).  Registers bound the
//   width: in the dK/dV pass dK, dV, S^T and dP^T hold 32 floats a thread
//   each at D = 64 (64 each of dK and dV at D = 128), and each 16-query
//   step's terms of P^T and dS^T 24 more while its products run.  ptxas
//   (bf16): 211 registers a thread at D = 64, 242 at 96, 247 at 128, no
//   spill; the p_dtype builds, with one P term in dV, fewer.
//   kNarrowD / kNarrowDV (64 / 128) is the build of a value width past
//   the qk width (qk 64 / v 128): dK 32 floats, dV 64.  MLA's build
//   (kWideD 192 / kWideDV 128, for any D in 129..192 with Dv <= 128) holds
//   dK's 96 floats and dV's 64: its dK/dV pass streams kWideBT = 32-query
//   tiles, so that S^T and dP^T are m64n32, 16 floats each, and splits a
//   step's terms only once the step before it is done (one step's 24
//   live); 246 registers, no spill.  Its dQ pass keeps the 64-key tiles
//   (dQ 96 floats, S and dP 32 each: 213 registers).  The split build's
//   passes take 202-205 registers.  The split build
//   (kSplitD, any other head up to 256 columns) cannot hold dK's and dV's
//   128 floats each in one thread: its dK/dV pass runs two blocks per key
//   block, one computing dV (S^T, P^T, dV += P^T.dO) and one dK (S^T, dP^T,
//   dS^T, dK += dS^T.Q), each over kSplitBT = 32-query tiles with one
//   step's terms live, so S^T is computed twice; its dQ pass streams
//   32-key tiles.  One block an SM (256 threads; 66 KB of shared memory at
//   D = 64, 130 KB at 96 and 128; 122 KB in MLA's dK/dV pass, 161 KB in
//   its dQ pass; 194 KB in either pass of the split build).
#pragma once

#include "flash_wgmma_common.cuh"

namespace k7wg {
namespace {

constexpr int kBT = 64;         // queries (dK/dV pass) or keys (dQ pass) a tile
constexpr int kStages = 2;      // ring depth of the streamed tiles
constexpr int kTerms = 3;       // bf16 terms of P and dS
constexpr int kTermsF16 = 2;    // f16 terms of P and dS
constexpr int kMaxD = 128;      // the widest qk width of the square builds
constexpr int kNarrowD = 64;    // the qk width of the Dv > D build
constexpr int kNarrowDV = 128;  //   its value width
constexpr int kWideD = 192;     // the qk width of MLA's build
constexpr int kWideDV = 128;    //   its value width
constexpr int kWideBT = 32;     //   the queries of its dK/dV pass's tile
constexpr int kSplitD = 256;    // the widths of the split build
constexpr int kSplitBT = 32;    //   its query (dK/dV) and key (dQ) tiles
constexpr uint32_t kPanel = kRows * 128;  // a 64-column panel of a block's rows

// What a dK/dV block computes: both gradients, or (the split build) one.
constexpr int kBoth = 0, kOnlyDV = 1, kOnlyDK = 2;

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

// The pointers, shapes, mask and scales of one call's passes.
struct BwdParams {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *kl;
  void *dq, *dk, *dv;
  int bh_count, sk, d, dv_w, vec;
  Mask mask;
  float scale, scale_log2;
};

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

// The power of two f16's dS is carried at in bh: 2^e with 2^e * 2
// sqrt(max |dO_i|^2) sqrt(max |V_j|^2) < 2^kF16DsLog2, from
// ds_stats_kernel's stats, which follow Delta's bh * sq floats; 1 where
// the bound is 0 or not finite.
__device__ __forceinline__ float ds_scale(const BwdParams& a, long long bh) {
  const float* stats = a.delta + (long long)a.bh_count * a.mask.sq;
  const float bound =
      2.0f * sqrtf(stats[2 * bh]) * sqrtf(stats[2 * bh + 1]);
  if (!(bound > 0.0f && bound <= 3.0e38f)) return 1.0f;
  int e;
  frexpf(bound, &e);  // bound < 2^e
  e = kF16DsLog2 - e;
  return ldexpf(1.0f, e < -100 ? -100 : e > 100 ? 100 : e);
}

// The A fragments of 16 columns (kk) of an m64n(2 N) accumulator x as NT
// terms of T: values 8 kk .. 8 kk + 7, pairwise (rows r, r + 8, r, r + 8),
// each times `mul`, and rounded to bf16 first where `bf16`.
template <typename T, int NT, int N>
__device__ __forceinline__ void split_terms(const float (&x)[N], int kk,
                                            uint32_t (&a)[NT][4],
                                            float mul = 1.0f,
                                            bool bf16 = false) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float u = x[8 * kk + 2 * r] * mul, w = x[8 * kk + 2 * r + 1] * mul;
    if (bf16) {
      u = dtypes::round_bf16(u);
      w = dtypes::round_bf16(w);
    }
    split_pair<T, NT>(u, w, a, r);
  }
}

// acc[p] += A . B for each 64-column panel p of a DP-wide B operand read
// MN-major (transpose bit) from the BT-row SW128 tile at `b` (panels
// BT * 128 bytes apart), rows 16 kk .. 16 kk + 15; A in the first NU of
// its NT register terms.
template <typename T, int DP, int NP, int BT, int NT, int NU = NT>
__device__ __forceinline__ void mma_terms(float (&acc)[NP][32],
                                          const uint32_t (&a)[NT][4],
                                          uint32_t b, int kk) {
  constexpr uint32_t tile = BT * 128;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint64_t desc = sw128_desc(b + p * tile + kk * 2048, tile, 1024);
#pragma unroll
    for (int term = 0; term < NU; ++term) {
      if (panel_cols<DP>(p) == 64)
        hopper::wgmma_rs_m64n64k16<T>(acc[p], a[term], desc);
      else
        hopper::wgmma_rs_m64n32k16<T>(acc[p], a[term], desc);
    }
  }
}

// s (+)= A . B^T over DP columns in steps of 16: A the 64 rows at `a`
// (panels pa bytes apart), B the BT rows at `b` (panels BT * 128 bytes
// apart), both K-major SW128; s the m64n(BT) accumulator.
template <typename T, int DP, int BT>
__device__ __forceinline__ void mma_kmajor(float (&s)[BT / 2], uint32_t a,
                                           uint32_t pa, uint32_t b) {
  constexpr uint32_t tile = BT * 128;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = sw128_desc(a + (kk >> 2) * pa + off, 16, 1024);
    const uint64_t db = sw128_desc(b + (kk >> 2) * tile + off, 16, 1024);
    if constexpr (BT == 64)
      hopper::wgmma_ss_m64n64k16<T>(s, da, db, kk > 0);
    else
      hopper::wgmma_ss_m64n32k16<T>(s, da, db, kk > 0);
  }
}

// One DP-wide accumulator (rows row0 and row0 + 8 of this thread, times
// `mul`, plus add[c] where add is not NULL) into an (n_rows x d) matrix
// of T.
template <typename T, int DP, int NP>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NP][32],
                                           int row0, int n_rows, int d,
                                           int col0, float mul,
                                           const float* add) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n_rows) continue;
    T* orow = out + (long long)row * d;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= panel_cols<DP>(p)) continue;
        const int c = 64 * p + 8 * j + col0;
        if (c >= d) continue;
        float x = acc[p][4 * j + 2 * h] * mul;
        float y = acc[p][4 * j + 2 * h + 1] * mul;
        if (add != nullptr) {
          x += add[c];
          if (c + 1 < d) y += add[c + 1];
        }
        float2 back;
        if (c + 1 < d && (d & 1) == 0) {
          const uint32_t bits = pack2(T(), x, y, back);
          *reinterpret_cast<uint32_t*>(orow + c) = bits;
        } else {
          orow[c] = dtypes::from_f<T>(x);
          if (c + 1 < d) orow[c + 1] = dtypes::from_f<T>(y);
        }
      }
  }
}

// Shared memory of the dQ pass: Q and dO of the block, the ring of BK-key
// K / V tiles, and 1024 bytes to align the panels.
template <int DQ, int DV, int BK>
constexpr int dq_smem() {
  return 1024 + ((DQ + 63) / 64 + (DV + 63) / 64)
                    * ((int)kPanel + kStages * BK * 128);
}

// Shared memory of the dK/dV pass: K and V of the block, the ring of
// BT-query Q / dO tiles, and lse and Delta of each stage.
template <int DQ, int DV, int BT>
constexpr int dkdv_smem() {
  return 1024 + ((DQ + 63) / 64 + (DV + 63) / 64)
                    * ((int)kPanel + kStages * BT * 128)
         + kStages * 2 * BT * 4;
}

// dK and dV (OUT: or one of them) of the kRows keys of key block `idx`
// (its bh and its place in bh's keys), over BT-query tiles; PR: p_dtype.
template <typename T, int DQ, int DV, int BT, int OUT, bool PR>
__device__ __forceinline__ void dkdv_body(const BwdParams& a, int idx) {
  constexpr bool kF16 = hopper::is_f16<T>;
  constexpr int NT = kF16 ? kTermsF16 : kTerms;
  constexpr bool kDoDV = OUT != kOnlyDK, kDoDK = OUT != kOnlyDV;
  constexpr int NQ = (DQ + 63) / 64;  // 64-column panels of Q, K and dK
  constexpr int NV = (DV + 63) / 64;  // of V, dO and dV
  constexpr uint32_t tile = BT * 128;  // a 64-column panel of a Q / dO tile
  // P's scale (f16: kF16PScale), dP's (f16 under p_dtype: the halved V)
  constexpr float kPMul = kF16 ? kF16PScale : 1.0f;
  constexpr float kDPMul = kF16 && PR ? 2.0f : 1.0f;
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

  const Mask& mask = a.mask;
  const int sq = mask.sq, sk = a.sk, d = a.d, dv = a.dv_w;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int kt = idx / a.bh_count;  // early keys (most work) first
  const long long bh = idx % a.bh_count;
  // f16: dS at ds_scale's power of two, folded into dP's multiplier and
  // Delta (exact), and out of dK's scale at its store
  const float ds_mul = kF16 ? ds_scale(a, bh) : 1.0f;
  const int k0 = kt * kRows;
  const T* qb = static_cast<const T*>(a.q) + bh * sq * (long long)d;
  const T* kb = static_cast<const T*>(a.k) + bh * sk * (long long)d;
  const T* vb = static_cast<const T*>(a.v) + bh * sk * (long long)dv;
  const T* dob = static_cast<const T*>(a.dout) + bh * sq * (long long)dv;
  const float* lb = a.lse + bh * sq;
  const float* db = a.delta + bh * sq;

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
    load_tile<DQ>(qs(st), qb, t * BT, BT, sq, d, d, a.vec);
    load_tile<DV>(qs(st) + NQ * tile, dob, t * BT, BT, sq, dv, dv, a.vec);
    load_stats<BT>(stats + st * 2 * BT * 4, lb, db, t * BT, sq);
  };
  if (t_lo < t_hi) {
    load_tile<DQ>(ks, kb, k0, kRows, mask.kv_len, d, d, a.vec);
    load_tile<DV>(vs, vb, k0, kRows, mask.kv_len, dv, dv, a.vec);
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
  float dk_acc[kDoDK ? NQ : 1][32], dv_acc[kDoDV ? NV : 1][32];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < (kDoDK ? NQ : 1); ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = 0.0f;
#pragma unroll
  for (int p = 0; p < (kDoDV ? NV : 1); ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv_acc[p][i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) load_q((t + 1 - t_lo) % kStages, t + 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and K, V) have landed
    if constexpr (kF16 && PR && kDoDK) {  // p_dtype: V rounded, halved
      if (t == t_lo) round_tile_bf16_half<DV>(vs, kRows, a.vec);
    }
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
      if constexpr (kDoDK) hopper::fence_regs(dp);
      hopper::wgmma_fence();
      mma_kmajor<T, DQ, BT>(s, k_wg, kPanel, qt);  // S^T = K.Q^T
      hopper::wgmma_commit();
      if constexpr (kDoDK) {
        mma_kmajor<T, DV, BT>(dp, v_wg, kPanel, dot);  // dP^T = V.dO^T
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S^T is done, dP^T may still run
      } else {
        hopper::wgmma_wait<0>();
      }
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
                fmaf(s[i], a.scale_log2, -(e ? l2.y : l2.x) * kLog2e));
            if (edge && !mask.ok(q0 + 8 * j + col0 + e, row0 + 8 * h))
              p = 0.0f;
            s[i] = p;
          }
      }
      if constexpr (kDoDK) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
#pragma unroll
        for (int j = 0; j < BT / 8; ++j) {
          float2 dl =
              *reinterpret_cast<const float2*>(del_t + 8 * j + col0);
          if constexpr (kF16) {
            dl.x *= ds_mul;
            dl.y *= ds_mul;
#pragma unroll
            for (int i = 4 * j; i < 4 * j + 4; ++i)
              dp[i] = s[i] * (dp[i] * (kDPMul * ds_mul)
                              - (i & 1 ? dl.y : dl.x));
          } else {
#pragma unroll
            for (int i = 4 * j; i < 4 * j + 4; ++i)
              dp[i] = s[i] * (dp[i] * kDPMul - (i & 1 ? dl.y : dl.x));
          }
        }
      }

      // dV += P^T.dO and dK += dS^T.Q in BT / 16 steps of 16 queries, a
      // commit group each: a step's terms are computed while the tensor
      // cores run the step before it, and once that step's group is done
      // its terms' registers are free again (at D = 128 the dK/dV pass
      // then fits 255 registers a thread without a spill).  The 32-query
      // builds (BT < kBT) hold 96 or 128 accumulator floats a thread: they
      // wait for a step's products before they split the next step's
      // terms, so that only one step's terms are live.  Under p_dtype P
      // goes to dV as one term, rounded to bf16
      uint32_t pa[BT / 16][NT][4], da[BT / 16][NT][4];
      if constexpr (kDoDV) fence_acc<DV>(dv_acc);
      if constexpr (kDoDK) fence_acc<DQ>(dk_acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        if (BT < kBT && kk > 0) hopper::wgmma_wait<0>();
        if constexpr (kDoDV) split_terms<T, NT>(s, kk, pa[kk], kPMul, PR);
        if constexpr (kDoDK) split_terms<T, NT>(dp, kk, da[kk]);
        hopper::wgmma_fence();
        if constexpr (kDoDV)
          mma_terms<T, DV, NV, BT, NT, PR ? 1 : NT>(dv_acc, pa[kk], dot, kk);
        if constexpr (kDoDK)
          mma_terms<T, DQ, NQ, BT, NT>(dk_acc, da[kk], qt, kk);
        hopper::wgmma_commit();
        if (kk > 0) hopper::wgmma_wait<1>();  // step kk - 1 is done
      }
      hopper::wgmma_wait<0>();
      if constexpr (kDoDV) fence_acc<DV>(dv_acc);
      if constexpr (kDoDK) fence_acc<DQ>(dk_acc);
    }
    __syncthreads();  // stage st is consumed before it is loaded again
  }

  if constexpr (kDoDK)
    store_rows<T, DQ>(static_cast<T*>(a.dk) + bh * sk * (long long)d, dk_acc,
                      row0, sk, d, col0, kF16 ? a.scale / ds_mul : a.scale,
                      nullptr);
  if constexpr (kDoDV)
    store_rows<T, DV>(static_cast<T*>(a.dv) + bh * sk * (long long)dv,
                      dv_acc, row0, sk, dv, col0, 1.0f / kPMul,
                      a.kl == nullptr ? nullptr : a.kl + bh * dv);
}

// One block per (bh, kRows keys): dK and dV of its keys; the split build
// (SPLIT) two blocks, the odd one dK, the even one dV.
template <typename T, int DQ, int DV, int BT, bool SPLIT, bool PR>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const BwdParams a) {
  if constexpr (SPLIT) {
    if (blockIdx.x & 1)
      dkdv_body<T, DQ, DV, BT, kOnlyDK, PR>(a, (int)(blockIdx.x >> 1));
    else
      dkdv_body<T, DQ, DV, BT, kOnlyDV, PR>(a, (int)(blockIdx.x >> 1));
  } else {
    dkdv_body<T, DQ, DV, BT, kBoth, PR>(a, (int)blockIdx.x);
  }
}

// One block per (bh, kRows queries): dQ of its queries, over BK-key tiles;
// PR: p_dtype (f16's halved V).
template <typename T, int DQ, int DV, int BK, bool PR>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const BwdParams a) {
  constexpr bool kF16 = hopper::is_f16<T>;
  constexpr int NT = kF16 ? kTermsF16 : kTerms;
  constexpr int NQ = (DQ + 63) / 64;
  constexpr int NV = (DV + 63) / 64;
  constexpr uint32_t tile = BK * 128;  // a 64-column panel of a K / V tile
  constexpr float kDPMul = kF16 && PR ? 2.0f : 1.0f;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + NQ * kPanel;
  // stage st: K panels at ks(st), V panels NQ * tile after
  const uint32_t ring = dos + NV * kPanel;
  auto ks = [&](int st) { return ring + st * (NQ + NV) * tile; };

  const Mask& mask = a.mask;
  const int sq = mask.sq, sk = a.sk, d = a.d, dv = a.dv_w;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int nq = (sq + kRows - 1) / kRows;
  const int qt = nq - 1 - (int)(blockIdx.x / a.bh_count);  // heaviest first
  const long long bh = blockIdx.x % a.bh_count;
  // f16: dS at ds_scale's power of two, folded into dP's multiplier and
  // Delta (exact), and out of dQ's scale at its store
  const float ds_mul = kF16 ? ds_scale(a, bh) : 1.0f;
  const int q0 = qt * kRows;
  const T* kb = static_cast<const T*>(a.k) + bh * sk * (long long)d;
  const T* vb = static_cast<const T*>(a.v) + bh * sk * (long long)dv;

  // the key tiles [t_lo, t_hi) that hold the keys [lo, hi) some query of
  // this block may see: the forward's
  const int last_q = min(q0 + kRows, sq) - 1;
  const int hi = mask.key_hi(last_q + mask.q_offset);
  const int lo = max(0, mask.key_lo(q0 + mask.q_offset));
  const int t_lo = lo / BK;
  const int t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;

  if (t_lo < t_hi) {
    load_tile<DQ>(qs, static_cast<const T*>(a.q) + bh * sq * (long long)d,
                  q0, kRows, sq, d, d, a.vec);
    load_tile<DV>(dos, static_cast<const T*>(a.dout) + bh * sq * (long long)dv,
                  q0, kRows, sq, dv, dv, a.vec);
    load_tile<DQ>(ks(0), kb, t_lo * BK, BK, mask.kv_len, d, d, a.vec);
    load_tile<DV>(ks(0) + NQ * tile, vb, t_lo * BK, BK, mask.kv_len, dv, dv,
                  a.vec);
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
    nl_r[h] = row < sq ? -a.lse[bh * sq + row] * kLog2e : 0.0f;
    del_r[h] = row < sq ? a.delta[bh * sq + row] : 0.0f;
  }
  const uint32_t q_wg = qs + wg * 64 * 128;
  const uint32_t do_wg = dos + wg * 64 * 128;

  float s[BK / 2], dp[BK / 2];
  float acc[NQ][32];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < NQ; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) {
      const uint32_t nxt = ks((t + 1 - t_lo) % kStages);
      load_tile<DQ>(nxt, kb, (t + 1) * BK, BK, mask.kv_len, d, d, a.vec);
      load_tile<DV>(nxt + NQ * tile, vb, (t + 1) * BK, BK, mask.kv_len, dv,
                    dv, a.vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and Q, dO) have landed
    if constexpr (kF16 && PR)  // p_dtype: V rounded to bf16, halved
      round_tile_bf16_half<DV>(ks(st) + NQ * tile, BK, a.vec);
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = t * BK;
    if (k0 + BK > some_lo && k0 < some_hi) {  // a query here sees a key
      const uint32_t kt = ks(st);
      const uint32_t vt = kt + NQ * tile;
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      mma_kmajor<T, DQ, BK>(s, q_wg, kPanel, kt);    // S = Q.K^T
      hopper::wgmma_commit();
      mma_kmajor<T, DV, BK>(dp, do_wg, kPanel, vt);  // dP = dO.V^T
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is done, dP may still run
      hopper::fence_regs(s);

      // dS = P * (dP - Delta); mask only the tiles where some key is
      // invalid for some query of this warpgroup, against each row's
      // bounds moved to this thread's first column of the tile
      const bool edge = k0 < all_lo || k0 + BK > all_hi;
      const int c0 = k0 + col0;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = hopper::ex2(fmaf(s[i], a.scale_log2, nl_r[h]));
        if (edge) {
          const int key = 8 * (i >> 2) + (i & 1);  // past c0
          if (key < lo_r[h] - c0 || key >= hi_r[h] - c0) p = 0.0f;
        }
        s[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      if constexpr (kF16) {
        const float dpm = kDPMul * ds_mul;
        const float del_s[2] = {del_r[0] * ds_mul, del_r[1] * ds_mul};
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          dp[i] = s[i] * (dp[i] * dpm - del_s[(i >> 1) & 1]);
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          dp[i] = s[i] * (dp[i] * kDPMul - del_r[(i >> 1) & 1]);
      }

      // dQ += dS.K in BK / 16 steps of 16 keys, a commit group each (one
      // step's terms live in the 32-key builds, as in the dK/dV pass)
      uint32_t da[BK / 16][NT][4];
      fence_acc<DQ>(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (BK < kBT && kk > 0) hopper::wgmma_wait<0>();
        split_terms<T, NT>(dp, kk, da[kk]);
        hopper::wgmma_fence();
        mma_terms<T, DQ, NQ, BK, NT>(acc, da[kk], kt, kk);
        hopper::wgmma_commit();
        if (kk > 0) hopper::wgmma_wait<1>();  // step kk - 1 is done
      }
      hopper::wgmma_wait<0>();
      fence_acc<DQ>(acc);
    }
    __syncthreads();  // stage st is consumed before it is loaded again
  }

  store_rows<T, DQ>(static_cast<T*>(a.dq) + bh * sq * (long long)d, acc,
                    row0, sq, d, col0, kF16 ? a.scale / ds_mul : a.scale,
                    nullptr);
}

// The arguments of one call: pointers, shapes, mask and scale.
struct BwdArgs {
  const void *q, *k, *v, *o, *lse, *dout;
  void *dq, *dk, *dv, *delta;
  const void* kl;
  long long bh, sq, sk, d, dv_w;
  Mask mask;
  float scale;
  int p_bf16;
};

// The three launches at tile widths (DQ, DV): the dK/dV pass over
// BT-query tiles (SPLIT: dK and dV in blocks of their own), the dQ pass
// over BK-key tiles; PR: p_dtype.
template <typename T, int DQ, int DV, int BT, int BK, bool SPLIT, bool PR>
int launch_bwd_pr(const BwdArgs& a, cudaStream_t stream) {
  // the dQ pass needs p_dtype's build only for f16's halved V
  constexpr bool kPRQ = PR && hopper::is_f16<T>;
  constexpr int smem_kv = dkdv_smem<DQ, DV, BT>();
  constexpr int smem_q = dq_smem<DQ, DV, BK>();
  static_assert(smem_kv <= 232448 && smem_q <= 232448, "shared memory");
  const long long nk = (a.sk + kRows - 1) / kRows;
  const long long nq = (a.sq + kRows - 1) / kRows;
  const long long kv_blocks = nk * a.bh * (SPLIT ? 2 : 1);
  if (kv_blocks > 2147483647LL || nq * a.bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, DQ, DV, BT, SPLIT, PR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<T, DQ, DV, BK, kPRQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdParams p;
  p.q = a.q;
  p.k = a.k;
  p.v = a.v;
  p.dout = a.dout;
  p.lse = static_cast<const float*>(a.lse);
  p.delta = static_cast<const float*>(a.delta);
  p.kl = static_cast<const float*>(a.kl);
  p.dq = a.dq;
  p.dk = a.dk;
  p.dv = a.dv;
  p.bh_count = (int)a.bh;
  p.sk = (int)a.sk;
  p.d = (int)a.d;
  p.dv_w = (int)a.dv_w;
  p.vec = a.d % 8 == 0 && a.dv_w % 8 == 0
      && ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k)
           | reinterpret_cast<uintptr_t>(a.v)
           | reinterpret_cast<uintptr_t>(a.dout)) & 15) == 0;
  p.mask = a.mask;
  p.scale = a.scale;
  // the scale and log2(e) in one float, for exp2
  p.scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  const long long rows = a.bh * a.sq;
  const int rows_per_block = kThreads / 32;
  delta_kernel<T><<<(unsigned)((rows + rows_per_block - 1) / rows_per_block),
                    kThreads, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<float*>(a.delta), rows, (int)a.dv_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // f16: the dS scale's stats, (bh, 2) floats after Delta
  if constexpr (hopper::is_f16<T>) {
    float* stats = static_cast<float*>(a.delta) + rows;
    if (a.bh * kStatBlocks > 2147483647LL)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaMemsetAsync(stats, 0, sizeof(float) * 2 * a.bh, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    ds_stats_kernel<T>
        <<<dim3((unsigned)(a.bh * kStatBlocks), 1, 2), kThreads, 0, stream>>>(
            static_cast<const T*>(a.dout), static_cast<const T*>(a.v), stats,
            (int)a.sq, (int)a.sk, (int)a.dv_w);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, DQ, DV, BT, SPLIT, PR>
      <<<(unsigned)kv_blocks, kThreads, smem_kv, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, DQ, DV, BK, kPRQ>
      <<<(unsigned)(nq * a.bh), kThreads, smem_q, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DQ, int DV, int BT = kBT, int BK = kBT,
          bool SPLIT = false>
int launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  return a.p_bf16
      ? launch_bwd_pr<T, DQ, DV, BT, BK, SPLIT, true>(a, stream)
      : launch_bwd_pr<T, DQ, DV, BT, BK, SPLIT, false>(a, stream);
}

// The builds up to MLA's widths: the square builds (D, or Dv where it is
// wider, rounded up to 32, up to kMaxD), the Dv > D build (D <= kNarrowD <
// Dv <= kNarrowDV) and MLA's (D <= kWideD, Dv <= kWideDV).
template <typename T>
int launch_bwd_narrow(const BwdArgs& a, cudaStream_t s) {
  const long long wide = a.d > a.dv_w ? a.d : a.dv_w;
  if (wide > kMaxD) return launch_bwd<T, kWideD, kWideDV, kWideBT>(a, s);
  if (a.d <= kNarrowD && a.dv_w > kNarrowD)
    return launch_bwd<T, kNarrowD, kNarrowDV>(a, s);
  switch ((wide + 31) / 32) {
    case 1: return launch_bwd<T, 32, 32>(a, s);
    case 2: return launch_bwd<T, 64, 64>(a, s);
    case 3: return launch_bwd<T, 96, 96>(a, s);
    default: return launch_bwd<T, 128, 128>(a, s);
  }
}

// The entry points' checks: 0 and the arguments in `a`, or the error code
// of a call outside the limits (d and dv_w up to max_dv and max_d, sk >= 1,
// positions up to 2^28).
inline int bwd_args(const void* q, const void* k, const void* v,
                    const void* o, const void* lse, const void* dout,
                    void* dq, void* dk, void* dv, void* delta,
                    const void* keyless_dv, long long bh, long long sq,
                    long long sk, long long d, long long dv_w, int causal,
                    long long q_offset, long long window, long long kv_len,
                    float scale, int p_bf16, long long max_d,
                    long long max_dv, BwdArgs& a) {
  if (d <= 0 || d > max_d || dv_w <= 0 || dv_w > max_dv || sk <= 0
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal, (int)q_offset, (int)window,
                  (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len),
                  (int)sq};
  a = BwdArgs{q, k, v, o, lse, dout, dq, dk, dv, delta, keyless_dv, bh, sq,
              sk, d, dv_w, mask, scale, p_bf16};
  return 0;
}

}  // namespace
}  // namespace k7wg
