// Fused online-softmax attention (flash attention) for 16-bit q of
// (BH, Sq, D), k of (BH, Sk, D) and v of (BH, Sk, Dv), on the tensor cores
// of a Hopper GPU (sm_90a): the bf16 and float16 routes of
// ops.flash_attention_fused and ops.flash_attention_masked, for qk widths
// up to kWideD and any value width.  float32 inputs go to
// flash_attention_wgmma_f32.cu (up to 256 columns) and flash_attention.cu,
// wider heads to flash_attention.cu.  The output is (BH, Sq, Dv).  Built by
// flash_attention_wgmma.cu (bf16, D and Dv up to kMaxD),
// flash_attention_wgmma_f16.cu (float16, the same widths) and
// flash_attention_wgmma_wide.cu (both types past kMaxD), each an entry
// point of its own.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:73
// (flash_attention_fused; body _flash_kernel :29).  What it computes, as
// there: q, k and v taken as float32, S = Q.K^T * (1/sqrt(D)) in float32,
// invalid keys masked with -1e30, a running max m, denominator l and
// accumulator acc in float32 over kv tiles in ascending order,
// P = exp(S - m) kept in float32 for P.V, and the output
// acc / max(l, 1e-30) rounded to the inputs' type (round to nearest even).
// Key j is valid for query i iff j < kv_len, j <= i + q_offset when
// causal, and j > i + q_offset - window when window > 0: the Pallas
// kernel's causal mask widened to the masks of the model's chunked
// attention (repro/models/attention.py:25-29, :92-95), so that windowed,
// offset, cross- and ragged attention run here too.
//
// What bounds it on an H100: operations.  At Phi-3-mini's prefill (BH 64,
// S 4,096, D 96, causal) Q.K^T and P.V over the pairs on and below the
// diagonal are 2.06e11 FLOP, 0.2085 ms at the 989 TFLOP/s bf16 and f16
// tensor-core rate, against 201 MB of q, k, v and o (0.060 ms at
// 3.35 TB/s).  P in three bf16 terms (below) makes the tensor cores do
// 4.12e11 operations, 0.417 ms at that rate (two f16 terms: 3.43e11).  At
// DeepSeek-V2-Lite's MLA prefill (BH 32, S 4,096, D 192 = 128 + 64 rope
// lanes, Dv 128, causal): 1.72e11 FLOP, 0.174 ms, against 168 MB
// (0.050 ms); with P's three terms 3.09e11, 0.313 ms.  At D = Dv = 320
// (BH 32, S 4,096): 3.44e11 FLOP, 0.348 ms; its two value slabs of 160
// compute S twice, 2.6e11 of it, and P.V once in three terms, 7.7e11 in
// all, 0.78 ms.
//
// Design (what it does about that bound): both products on the tensor
// cores with wgmma, 16-bit operands and float32 accumulators.
//   * One block of two consumer warpgroups owns 128 query rows of one bh
//     (64 rows a warpgroup) and one slab of at most DV value columns, and
//     runs the kv loop over tiles of 64 keys, from the tile of the first
//     key any of its queries may see (past the window of its first query)
//     to the tile of the last (kv_len, and the causal limit of its last
//     query); a warpgroup skips the products of a tile that none of its
//     own 64 queries may see, and the heaviest query tiles are scheduled
//     first.  Only tiles that reach past kv_len, a diagonal or a window
//     edge of the warpgroup are masked elementwise.  Q is staged against
//     Sq, K and V against kv_len.  For D <= 96 two blocks share an SM (128
//     registers a thread, 97 KB of shared memory a block), so four
//     warpgroups interleave their softmax with each other's products.
//   * Q (once) and each K and V tile are staged into shared memory by
//     cp.async (16-byte copies with zero-fill) into a ring of two stages:
//     the copies of tile i+1 are in flight while tile i is multiplied.
//     cp.async rather than TMA: a TMA tensor map needs row strides that are
//     multiples of 16 bytes (D % 8 == 0), and every D is taken; zero-fill
//     pads rows past S and columns past D in the same instruction.  For
//     D % 8 != 0 (or unaligned tensors) the same tiles are filled element
//     by element, synchronously.  No producer warp, no setmaxnreg.
//   * Tiles are SW128 panels of 64 columns (flash_wgmma_common.cuh).  The
//     qk width D is padded with zeros to DQ and the value slab to DV, each
//     a multiple of 32; the padded output columns are not stored.  The two
//     widths are template parameters of their own, so a wide Q.K^T
//     (MLA's 192) costs shared memory and k-steps but no accumulator
//     registers.
//   * Value slabs: a call with Dv past DV runs ceil(Dv / DV) slabs, one
//     block each (the grid's fastest index), each computing S over the
//     full qk width and writing its DV columns of O; the first slab writes
//     lse.  The wide builds (kSlabD / kSlabDV = 320 / 160, kWideD /
//     kWideDV = 384 / 128) hold Q and a two-stage K/V ring of the full qk
//     width in shared memory: 209 KB at 320 / 160, 225 KB at 384 / 128,
//     the widest qk width that fits the 227 KB a block may use.
//   * S = Q.K^T: DQ/16 wgmma m64n64k16, Q and K both K-major from shared
//     memory.  16-bit products are exact in float32, so the scores differ
//     from the reference only in the order of the sums.
//   * Softmax on the accumulator fragments, in float32: a thread holds two
//     rows (r and r + 8) x 16 keys; the row max goes across the quad of
//     threads that share the rows with two shuffles, each thread keeps a
//     partial l (the quad's l is summed once, at the end).  The scale is
//     folded with log2(e) into one multiply, and p = 2^(x - m) comes from
//     the special-function unit (ex2.approx, relative error about 2^-22).
//   * P.V: P is the register A operand (the m64n64 accumulator layout is
//     the A fragment layout of the following m64k16 products, so no data
//     moves), V the B operand read MN-major from shared memory (transpose
//     bit).  P keeps float32 precision as PT terms, t1 = T(p),
//     t2 = T(p - t1), ..., each multiplied into the same float32
//     accumulator: three bf16 terms (2^-24 of p; two, 2^-16, miss
//     chip_smoke.py's bf16 gate on outputs near zero, where the gate's
//     absolute 1e-6 binds), or two f16 terms (2^-22; one misses the f16
//     gate: tests/test_torch_flash.py emulates each).  f16's P is carried
//     as p * kF16PScale (2^15), so that its terms stay normal f16 numbers,
//     and the output is scaled back by the same power of two.
//
// p_dtype (the reference's p_bf16: P rounded to bf16 before P.V, l summed
// from the unrounded P, repro/models/attention.py:96-104) is the build with
// one P term (PT = 1): in bf16, t1 = bf16(p) is that rounding, and V is
// already bf16.  In f16, P is rounded to bf16 and carried as one f16 term
// (bf16(p) * 2^15 is an f16 number for p >= 2^-32), and each V tile is
// rounded to bf16 and halved in shared memory once it has landed,
// f16(bf16(v) / 2) (round_tile_bf16_half: halved so that it stays in f16's
// range); the output is scaled back by 2^14.
//
// The masked-row trap: a row whose first processed tile is wholly masked
// (under a window, the later queries of a warpgroup see none of its first
// tiles) gets m = -1e30 and p = 2^0 = 1 on every masked key, so l and acc
// pick up terms that are not its own.  They are wiped exactly once a real
// score arrives: corr = 2^(-1e30 - m_new) is 0 (ex2.approx flushes it to
// +0), and l * 0 and acc * 0 are 0.  From then on a masked key's
// p = 2^(-1e30 - m) is exactly 0.  The reference's chunked loop does the
// same.  A row with no valid key at all keeps those terms; the wrapper
// overwrites such rows with flash_attention.cu's keyless pass.  Query rows
// past Sq are computed on zero rows and not stored.
#pragma once

#include "flash_wgmma_common.cuh"

namespace k7wg {
namespace {

constexpr int kBK = 64;              // keys per kv tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kPTerms = 3;           // bf16 terms of P (1 under p_dtype)
constexpr int kPTermsF16 = 2;        // f16 terms of P (1 under p_dtype)
constexpr int kMaxD = 256;           // the widest head of the square builds
constexpr int kSlabD = 320;          // the qk width of the first wide build
constexpr int kSlabDV = 160;         //   its value slab
constexpr int kWideD = 384;          // the qk width of the widest build
constexpr int kWideDV = 128;         //   its value slab
constexpr int kSmemLimit = 232448;   // the dynamic shared memory of a block
constexpr uint32_t kTile = kBK * 128;  // one 64-column panel of a K/V tile

// Dynamic shared memory of a launch: Q and the K/V ring in 64-column
// panels of 128-byte rows (DQ wide for Q and K, DV for V), and 1024 bytes
// to align them.
template <int DQ, int DV>
constexpr int smem_bytes() {
  return 1024 + ((DQ + 63) / 64) * 128 * kRows
         + kStages * (int)kTile * ((DQ + 63) / 64 + (DV + 63) / 64);
}

// Two float32 values into o[0], o[1] as T (a pair store where `pair`).
__device__ __forceinline__ void store2(__nv_bfloat16* o, float x, float y,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(x, y);
  } else {
    o[0] = __float2bfloat16_rn(x);
    if (second) o[1] = __float2bfloat16_rn(y);
  }
}
__device__ __forceinline__ void store2(__half* o, float x, float y,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__half2*>(o) = __floats2half2_rn(x, y);
  } else {
    o[0] = __float2half_rn(x);
    if (second) o[1] = __float2half_rn(y);
  }
}

// T operands; PT P terms (1: p_dtype).  Two blocks an SM hold the
// accumulators of D <= 96 in 128 registers a thread, and their shared
// memory; wider tiles need one block an SM.
template <typename T, int DQ, int DV, int PT>
__global__ void __launch_bounds__(kThreads, DQ > 96 || DV > 96 ? 1 : 2)
flash_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o,
                   float* __restrict__ lse, int bh_count, int sq, int sk,
                   int d, int dv, int causal, int q_offset, int window,
                   int kv_len, float scale_log2, int vec, int n_slabs) {
  constexpr bool kF16 = hopper::is_f16<T>;
  constexpr int NQ = (DQ + 63) / 64;  // 64-column panels of Q and K
  constexpr int NV = (DV + 63) / 64;  // of V and the accumulator
  constexpr uint32_t kQBytes = NQ * kRows * 128;
  // what the output is scaled back by: f16's P scale, and under p_dtype
  // the halved V
  constexpr float kOutMul =
      !kF16 ? 1.0f : PT == 1 ? 2.0f / kF16PScale : 1.0f / kF16PScale;
  extern __shared__ unsigned char smem_raw[];
  // panels start on 1024-byte boundaries (the SW128 pattern's period)
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  // stage st: K panels at ks(st), V panels kTile * NQ after
  auto ks = [&](int st) { return qs + kQBytes + st * (NQ + NV) * kTile; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int nq = (sq + kRows - 1) / kRows;
  // value slabs: only the wide builds run more than one (the square builds
  // hold every value column, and keep no slab arithmetic)
  constexpr bool kSlabs = DQ > kMaxD;
  const int slab = kSlabs ? (int)(blockIdx.x % n_slabs) : 0;
  const int rest = kSlabs ? (int)(blockIdx.x / n_slabs) : (int)blockIdx.x;
  const int qt = nq - 1 - rest / bh_count;  // heaviest first
  const long long bh = rest % bh_count;
  const int q0 = qt * kRows;
  const int v0 = slab * DV;                    // this slab's first column
  const int vw = kSlabs ? min(DV, dv - v0) : dv;  // and its columns
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + bh * sk * (long long)d;
  const T* vb = v + bh * sk * (long long)dv + v0;
  const long long base_o = bh * sq * (long long)dv + v0;

  // the kv tiles [t_lo, t_hi) that hold the keys [lo, hi) some query of
  // this block may see
  const int last_q = min(q0 + kRows, sq) - 1;
  const int hi = causal ? min(kv_len, last_q + q_offset + 1) : kv_len;
  const int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_lo = lo / kBK;
  const int t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;

  if (t_lo < t_hi) {
    load_tile<DQ>(qs, qb, q0, kRows, sq, d, d, vec);
    load_tile<DQ>(ks(0), kb, t_lo * kBK, kBK, kv_len, d, d, vec);
    load_tile<DV>(ks(0) + NQ * kTile, vb, t_lo * kBK, kBK, kv_len, vw, dv,
                  vec);
    hopper::cp_async_commit();
  }

  // This thread's accumulator rows (r and r + 8) and first column: the
  // wgmma layout puts value i of a 64 x N accumulator at row
  // 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
  // 2 * (lane % 4) + i % 2.
  const int wg_q0 = q0 + 64 * wg;
  const int row0 = wg_q0 + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  // Query p (in key coordinates) sees the keys [key_lo(p), key_hi(p)),
  // both nondecreasing in p.  This warpgroup's queries p0 .. p0 + 63: some
  // of them see a key of [some_lo, some_hi), all of them every key of
  // [all_lo, all_hi); this thread's two rows see [lo_r[h], hi_r[h]).
  const int p0 = wg_q0 + q_offset;
  auto key_lo = [&](int p) { return window > 0 ? p - window + 1 : 0; };
  auto key_hi = [&](int p) { return causal ? min(kv_len, p + 1) : kv_len; };
  const int some_lo = key_lo(p0), some_hi = key_hi(p0 + 63);
  const int all_lo = key_lo(p0 + 63), all_hi = key_hi(p0);
  const int lo_r[2] = {key_lo(row0 + q_offset), key_lo(row0 + 8 + q_offset)};
  const int hi_r[2] = {key_hi(row0 + q_offset), key_hi(row0 + 8 + q_offset)};
  const uint32_t q_wg = qs + wg * 64 * 128;

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float s[32];
  float acc[NV][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
  for (int p = 0; p < NV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) {
      const uint32_t nxt = ks((t + 1 - t_lo) % kStages);
      load_tile<DQ>(nxt, kb, (t + 1) * kBK, kBK, kv_len, d, d, vec);
      load_tile<DV>(nxt + NQ * kTile, vb, (t + 1) * kBK, kBK, kv_len, vw, dv,
                    vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and Q) have landed
    if constexpr (kF16 && PT == 1)  // p_dtype: V rounded to bf16, halved
      round_tile_bf16_half<DV>(ks(st) + NQ * kTile, kBK, vec);
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = t * kBK;
    if (k0 + kBK > some_lo && k0 < some_hi) {  // a query here sees a key
      const uint32_t kt = ks(st);
      const uint32_t vt = kt + NQ * kTile;
      // S = Q.K^T over DQ in steps of 16 (32 bytes of a 128-byte row)
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        hopper::wgmma_ss_m64n64k16<T>(
            s, sw128_desc(q_wg + (kk >> 2) * (kRows * 128) + off, 16, 1024),
            sw128_desc(kt + (kk >> 2) * kTile + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // scale into the log2 domain; mask only the tiles where some key is
      // invalid for some query of this warpgroup, against each row's
      // bounds moved to this thread's first column of the tile
      const bool edge = k0 < all_lo || k0 + kBK > all_hi;
      const int c0 = k0 + col0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = s[i] * scale_log2;
        if (edge) {
          const int h = (i >> 1) & 1;
          const int key = 8 * (i >> 2) + (i & 1);  // past c0
          if (key < lo_r[h] - c0 || key >= hi_r[h] - c0) x = kNegInf;
        }
        s[i] = x;
      }
      // the running max over the quad's 64 keys; rescale l and acc
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float corr = hopper::ex2(m[h] - m_new);
        l[h] *= corr;
        m[h] = m_new;
#pragma unroll
        for (int p = 0; p < NV; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (8 * j >= panel_cols<DV>(p)) continue;
            acc[p][4 * j + 2 * h] *= corr;
            acc[p][4 * j + 2 * h + 1] *= corr;
          }
      }

      // acc += P.V in four steps of 16 keys (V rows 16 kk .. 16 kk + 15,
      // 2048 bytes into a panel).  Step kk's A fragments are accumulator
      // values 8 kk .. 8 kk + 7, pairwise (rows r, r + 8, r, r + 8); its
      // exponentials and terms are computed while the tensor cores run the
      // steps before it.
      uint32_t pa[4][PT][4];
      fence_acc<DV>(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int h = r & 1;
          float a = hopper::ex2(s[8 * kk + 2 * r] - m[h]);
          float b = hopper::ex2(s[8 * kk + 2 * r + 1] - m[h]);
          l[h] += a + b;
          if constexpr (kF16) {
            a *= kF16PScale;
            b *= kF16PScale;
            if constexpr (PT == 1) {  // p_dtype: P rounded to bf16
              a = dtypes::round_bf16(a);
              b = dtypes::round_bf16(b);
            }
          }
          split_pair<T, PT>(a, b, pa[kk], r);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int p = 0; p < NV; ++p) {
          const uint64_t desc = sw128_desc(vt + p * kTile + kk * 2048,
                                           kTile, 1024);
#pragma unroll
          for (int term = 0; term < PT; ++term) {
            if (panel_cols<DV>(p) == 64)
              hopper::wgmma_rs_m64n64k16<T>(acc[p], pa[kk][term], desc);
            else
              hopper::wgmma_rs_m64n32k16<T>(acc[p], pa[kk][term], desc);
          }
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      fence_acc<DV>(acc);
    }
    __syncthreads();  // stage st is consumed before it is loaded again
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // m is in the log2 domain: lse = ln 2 * (m + log2 l)
    if (lse != nullptr && slab == 0 && (lane & 3) == 0)
      lse[bh * sq + row] = (m[h] + log2f(l[h])) * 0.69314718055994531f;
    T* orow = o + base_o + (long long)row * dv;
#pragma unroll
    for (int p = 0; p < NV; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= panel_cols<DV>(p)) continue;
        const int c = 64 * p + 8 * j + col0;
        if (c >= vw) continue;
        store2(orow + c, acc[p][4 * j + 2 * h] * kOutMul / denom,
               acc[p][4 * j + 2 * h + 1] * kOutMul / denom,
               c + 1 < vw && (dv & 1) == 0, c + 1 < vw);
      }
  }
}

// The arguments of one launch: shapes, mask and scale.
struct FwdArgs {
  long long bh, sq, sk, d, dv;
  int causal, q_offset, window, kv_len;
  float scale;
  int p_bf16;
};

// One launch of the <T, DQ, DV, PT> build: ceil(dv / DV) value slabs
// (one in the square builds, whose DV covers dv).
template <typename T, int DQ, int DV, int PT>
int launch_fwd_pt(const void* q, const void* k, const void* v, void* o,
                  void* lse, const FwdArgs& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DQ, DV>();
  static_assert(smem <= kSmemLimit, "shared memory of a block");
  const long long n_slabs = DQ > kMaxD ? (a.dv + DV - 1) / DV : 1;
  const long long nq = (a.sq + kRows - 1) / kRows;
  if (nq * a.bh * n_slabs > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, DQ, DV, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = a.d % 8 == 0 && a.dv % 8 == 0
      && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
           | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  // the scale and log2(e) in one float, for exp2
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  flash_wgmma_kernel<T, DQ, DV, PT>
      <<<(unsigned)(nq * a.bh * n_slabs), kThreads, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o),
          static_cast<float*>(lse), (int)a.bh, (int)a.sq, (int)a.sk,
          (int)a.d, (int)a.dv, a.causal, a.q_offset, a.window, a.kv_len,
          scale_log2, vec, (int)n_slabs);
  return static_cast<int>(cudaGetLastError());
}

// The P terms of T (three bf16, two f16), or one under p_dtype.
template <typename T, int DQ, int DV>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, const FwdArgs& a, cudaStream_t stream) {
  constexpr int kTerms = hopper::is_f16<T> ? kPTermsF16 : kPTerms;
  return a.p_bf16 ? launch_fwd_pt<T, DQ, DV, 1>(q, k, v, o, lse, a, stream)
                  : launch_fwd_pt<T, DQ, DV, kTerms>(q, k, v, o, lse, a,
                                                     stream);
}

// The value width's build for a square tile width of DQ (the wider of d
// and dv rounded up, up to kMaxD): DV = DQ (V, or Q and K, zero-filled past
// their width), or 128 for a qk width past 128 with dv <= 128 (MLA's
// 192 / 128), up to 192.
template <typename T, int DQ>
int launch_dq(const void* q, const void* k, const void* v, void* o,
              void* lse, const FwdArgs& a, cudaStream_t stream) {
  if constexpr (DQ > 128 && DQ <= 192) {
    if (a.dv <= 128) return launch_fwd<T, DQ, 128>(q, k, v, o, lse, a, stream);
  }
  return launch_fwd<T, DQ, DQ>(q, k, v, o, lse, a, stream);
}

// The square builds of T: D and Dv up to kMaxD.
template <typename T>
int launch_square(const void* q, const void* k, const void* v, void* o,
                  void* lse, const FwdArgs& a, cudaStream_t s) {
  switch (((a.d > a.dv ? a.d : a.dv) + 31) / 32) {
    case 1: return launch_dq<T, 32>(q, k, v, o, lse, a, s);
    case 2: return launch_dq<T, 64>(q, k, v, o, lse, a, s);
    case 3: return launch_dq<T, 96>(q, k, v, o, lse, a, s);
    case 4: return launch_dq<T, 128>(q, k, v, o, lse, a, s);
    case 5: return launch_dq<T, 160>(q, k, v, o, lse, a, s);
    case 6: return launch_dq<T, 192>(q, k, v, o, lse, a, s);
    default: return launch_dq<T, 256>(q, k, v, o, lse, a, s);
  }
}

// The entry points' checks: 0 and the arguments in `a`, or the error code
// of a call no build of width limits (max_d, max_dv) takes.
inline int fwd_args(long long bh, long long sq, long long sk, long long d,
                    long long dv, int causal, long long q_offset,
                    long long window, long long kv_len, float scale,
                    int p_bf16, long long max_d, long long max_dv,
                    FwdArgs& a) {
  if (d <= 0 || d > max_d || dv <= 0 || dv > max_dv || sk <= 0
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28))
    return static_cast<int>(cudaErrorInvalidValue);
  a = FwdArgs{bh, sq, sk, d, dv, causal, (int)q_offset, (int)window,
              (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len), scale,
              p_bf16};
  return 0;
}

}  // namespace
}  // namespace k7wg
