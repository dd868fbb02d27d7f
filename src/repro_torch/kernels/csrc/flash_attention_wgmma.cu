// Fused online-softmax attention (flash attention) for bf16 q of
// (BH, Sq, D), k of (BH, Sk, D) and v of (BH, Sk, Dv), D and Dv up to 256,
// on the tensor cores of a Hopper GPU (sm_90a): the bf16 route of
// ops.flash_attention_fused and ops.flash_attention_masked.  float32 and
// float16 inputs, and wider bf16 heads, go to flash_attention.cu.  The
// output is (BH, Sq, Dv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:73
// (flash_attention_fused; body _flash_kernel :29).  What it computes, as
// there: q, k and v taken as float32, S = Q.K^T * (1/sqrt(D)) in float32,
// invalid keys masked with -1e30, a running max m, denominator l and
// accumulator acc in float32 over kv tiles in ascending order,
// P = exp(S - m) kept in float32 for P.V, and the output
// acc / max(l, 1e-30) rounded to bf16 (round to nearest even).  Key j is
// valid for query i iff j < kv_len, j <= i + q_offset when causal, and
// j > i + q_offset - window when window > 0: the Pallas kernel's causal
// mask widened to the masks of the model's chunked attention
// (repro/models/attention.py:25-29, :92-95), so that windowed, offset,
// cross- and ragged attention run here too.
//
// What bounds it on an H100: operations.  At Phi-3-mini's prefill (BH 64,
// S 4,096, D 96, causal) Q.K^T and P.V over the pairs on and below the
// diagonal are 2.06e11 FLOP, 0.2085 ms at the 989 TFLOP/s bf16 tensor-core
// rate, against 201 MB of q, k, v and o (0.060 ms at 3.35 TB/s).  P in
// three bf16 terms (below) makes the tensor cores do 4.12e11 operations,
// 0.417 ms at that rate.  At DeepSeek-V2-Lite's MLA prefill (BH 32, S
// 4,096, D 192 = 128 + 64 rope lanes, Dv 128, causal): 1.72e11 FLOP, 0.174
// ms, against 168 MB (0.050 ms); with P's three terms 3.09e11, 0.313 ms.
// Zamba2's shared block (BH 32, S 8,192, D 64, causal, window 4,096) needs
// 2.06e11 FLOP over the valid pairs, 0.21 ms; Whisper's encoder (BH 40,
// S 1,500, D 64, no mask) 2.3e10, 0.023 ms.
//
// Design (what it does about that bound): both products on the tensor
// cores with wgmma, bf16 operands and float32 accumulators.
//   * One block of two consumer warpgroups owns 128 query rows of one bh
//     (64 rows a warpgroup) and runs the kv loop over tiles of 64 keys,
//     from the tile of the first key any of its queries may see (past the
//     window of its first query) to the tile of the last (kv_len, and the
//     causal limit of its last query); a warpgroup skips the products of a
//     tile that none of its own 64 queries may see, and the heaviest query
//     tiles are scheduled first.  Only tiles that reach past kv_len, a
//     diagonal or a window edge of the warpgroup are masked elementwise.
//     Q is staged against Sq, K and V against kv_len.  For
//     D <= 96 two blocks share an SM (128 registers a thread, 97 KB of
//     shared memory a block), so four warpgroups interleave their softmax
//     with each other's products (one block an SM, one warpgroup a block
//     and tiles of 32 keys each measured slower at the Phi-3 shape).
//   * Q (once) and each K and V tile are staged into shared memory by
//     cp.async (16-byte copies with zero-fill) into a ring of two stages:
//     the copies of tile i+1 are in flight while tile i is multiplied.
//     cp.async rather than TMA: a TMA tensor map needs row strides that are
//     multiples of 16 bytes (D % 8 == 0), and every D from 1 to 128 is
//     taken; zero-fill pads rows past S and columns past D in the same
//     instruction.  For D % 8 != 0 (or unaligned tensors) the same tiles
//     are filled element by element, synchronously.  No producer warp, no
//     setmaxnreg, no overlap of one tile's softmax with the next tile's
//     Q.K^T inside a warpgroup (FlashAttention-3's shape): every thread
//     copies, then computes.
//   * Tiles are SW128 panels of 64 columns (hopper.cuh).  The qk width D
//     is padded with zeros to DQ and the value width Dv to DV, each a
//     multiple of 32 (D = 96: two panels, the second half used); the
//     padded output columns are not stored.  The two widths are template
//     parameters of their own, so a wide Q.K^T (MLA's 192) costs shared
//     memory and k-steps but no accumulator registers: DV <= 128 keeps the
//     registers of the D = 128 kernel.  Dv < D below 128 runs the DQ-wide
//     kernel with V's columns past Dv zero-filled.  Shared memory at
//     (DQ, DV) = (192, 128): Q 48 KB, two K stages 48 KB, two V stages
//     32 KB, 129 KB with the alignment: one block an SM.
//   * S = Q.K^T: DQ/16 wgmma m64n64k16, Q and K both K-major from shared
//     memory.  bf16 x bf16 products are exact in float32, so the scores
//     differ from the reference only in the order of the sums.
//   * Softmax on the accumulator fragments, in float32: a thread holds two
//     rows (r and r + 8) x 16 keys; the row max goes across the quad of
//     threads that share the rows with two shuffles, each thread keeps a
//     partial l (the quad's l is summed once, at the end).  The scale is
//     folded with log2(e) into one multiply, and p = 2^(x - m) comes from
//     the special-function unit (ex2.approx, relative error about 2^-22).
//     The exponentials and bf16 terms of each 16 keys are computed while
//     the tensor cores multiply the 16 before them.
//   * P.V: P is the register A operand (the m64n64 accumulator layout is
//     the A fragment layout of the following m64k16 products, so no data
//     moves), V the B operand read MN-major from shared memory (transpose
//     bit).  P keeps float32 precision as three bf16 terms, p1 = bf16(p),
//     p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), each multiplied into the
//     same float32 accumulator: a relative error of at most 2^-24 of p.
//     Two terms (2^-16 of p) miss chip_smoke.py's bf16 gate on outputs near
//     zero, where the gate's absolute 1e-6 binds (tests/test_torch_flash.py
//     emulates both).
//
// p_dtype (the reference's p_bf16: P rounded to bf16 before P.V, l summed
// from the unrounded P, repro/models/attention.py:96-104) is the build with
// one P term (PT = 1): p1 = bf16(p) is that rounding, and V is already
// bf16.
//
// Widths: the qk and value tiles are DQ = DV = the wider of D and Dv
// rounded up to 32 (V, or Q and K, zero-filled past their width), except
// MLA's DV = 128 past a qk width of 128 with Dv <= 128; D or Dv in
// 193..256 takes the <256, 256> build: a warpgroup's float32 accumulator at
// 256 columns is 128 registers a thread, and Q and a two-stage K/V ring
// take 193 KB of shared memory.
//
// The masked-row trap: a row whose first processed tile is wholly masked
// (under a window, the later queries of a warpgroup see none of its first
// tiles) gets m = -1e30 and p = 2^0 = 1 on every masked key, so l and acc
// pick up terms that are not its own.  They are wiped exactly once a real
// score arrives: corr = 2^(-1e30 - m_new) is 0 (ex2.approx flushes it to
// +0), and l * 0 and acc * 0 are 0.  From then on a masked key's
// p = 2^(-1e30 - m) is exactly 0.  The reference's chunked loop does the
// same.  A row with no valid key at all keeps those terms; the wrapper
// overwrites such rows with flash_attention.cu's keyless pass.  Query rows past Sq are computed on zero rows
// and not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::sw128;
using hopper::sw128_desc;

constexpr int kWG = 2;               // consumer warpgroups per block
constexpr int kRows = 64 * kWG;      // query rows per block
constexpr int kThreads = 128 * kWG;
constexpr int kBK = 64;              // keys per kv tile
constexpr int kStages = 2;           // K/V ring depth
constexpr int kPTerms = 3;           // bf16 terms of P (1 under p_dtype)
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
constexpr uint32_t kTile = kBK * 128;  // one 64-column panel of a K/V tile

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

// Two blocks an SM hold the accumulators of D <= 96 in 128 registers a
// thread, and their shared memory; wider tiles need one block an SM.
template <int DQ, int DV, int PT>
__global__ void __launch_bounds__(kThreads, DQ > 96 || DV > 96 ? 1 : 2)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int bh_count, int sq,
                   int sk, int d, int dv, int causal, int q_offset,
                   int window, int kv_len, float scale_log2, int vec) {
  constexpr int NQ = (DQ + 63) / 64;  // 64-column panels of Q and K
  constexpr int NV = (DV + 63) / 64;  // of V and the accumulator
  constexpr uint32_t kQBytes = NQ * kRows * 128;
  extern __shared__ unsigned char smem_raw[];
  // panels start on 1024-byte boundaries (the SW128 pattern's period)
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  // stage st: K panels at ks(st), V panels kTile * NQ after
  auto ks = [&](int st) { return qs + kQBytes + st * (NQ + NV) * kTile; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int nq = (sq + kRows - 1) / kRows;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);  // heaviest first
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kRows;
  const __nv_bfloat16* qb = q + bh * sq * (long long)d;
  const __nv_bfloat16* kb = k + bh * sk * (long long)d;
  const __nv_bfloat16* vb = v + bh * sk * (long long)dv;
  const long long base_o = bh * sq * (long long)dv;

  // the kv tiles [t_lo, t_hi) that hold the keys [lo, hi) some query of
  // this block may see
  const int last_q = min(q0 + kRows, sq) - 1;
  const int hi = causal ? min(kv_len, last_q + q_offset + 1) : kv_len;
  const int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_lo = lo / kBK;
  const int t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;

  if (t_lo < t_hi) {
    load_tile<DQ>(qs, qb, q0, kRows, sq, d, vec);
    load_tile<DQ>(ks(0), kb, t_lo * kBK, kBK, kv_len, d, vec);
    load_tile<DV>(ks(0) + NQ * kTile, vb, t_lo * kBK, kBK, kv_len, dv, vec);
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
      load_tile<DQ>(nxt, kb, (t + 1) * kBK, kBK, kv_len, d, vec);
      load_tile<DV>(nxt + NQ * kTile, vb, (t + 1) * kBK, kBK, kv_len, dv,
                    vec);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // tile t (and Q) have landed
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
        hopper::wgmma_ss_m64n64k16(
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
      // exponentials and bf16 terms are computed while the tensor cores run
      // the steps before it.
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
#pragma unroll
          for (int term = 0; term < PT; ++term) {
            const __nv_bfloat162 t2 = __floats2bfloat162_rn(a, b);
            const float2 back = __bfloat1622float2(t2);
            pa[kk][term][r] = hopper::bf16x2_bits(t2);
            a -= back.x;  // exact: the term is within half a bf16 step
            b -= back.y;
          }
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int p = 0; p < NV; ++p) {
          const uint64_t desc = sw128_desc(vt + p * kTile + kk * 2048,
                                           kTile, 1024);
#pragma unroll
          for (int term = 0; term < PT; ++term) {
            if (panel_cols<DV>(p) == 64)
              hopper::wgmma_rs_m64n64k16(acc[p], pa[kk][term], desc);
            else
              hopper::wgmma_rs_m64n32k16(acc[p], pa[kk][term], desc);
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
    if (lse != nullptr && (lane & 3) == 0)
      lse[bh * sq + row] = (m[h] + log2f(l[h])) * 0.69314718055994531f;
    __nv_bfloat16* orow = o + base_o + (long long)row * dv;
#pragma unroll
    for (int p = 0; p < NV; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= panel_cols<DV>(p)) continue;
        const int c = 64 * p + 8 * j + col0;
        const float x = acc[p][4 * j + 2 * h] / denom;
        const float y = acc[p][4 * j + 2 * h + 1] / denom;
        if (c + 1 < dv && (dv & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x, y);
        } else {
          if (c < dv) orow[c] = __float2bfloat16(x);
          if (c + 1 < dv) orow[c + 1] = __float2bfloat16(y);
        }
      }
  }
}

// Dynamic shared memory of a launch: Q and the K/V ring in 64-column
// panels of 128-byte rows (DQ wide for Q and K, DV for V), and 1024 bytes
// to align them.
template <int DQ, int DV>
constexpr int smem_bytes() {
  return 1024 + ((DQ + 63) / 64) * 128 * kRows
         + kStages * (int)kTile * ((DQ + 63) / 64 + (DV + 63) / 64);
}

// The arguments of one launch: shapes, mask and scale.
struct Args {
  long long bh, sq, sk, d, dv;
  int causal, q_offset, window, kv_len;
  float scale;
  int p_bf16;
};

template <int DQ, int DV, int PT>
int launch_pt(const void* q, const void* k, const void* v, void* o,
           void* lse, const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DQ, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DQ, DV, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = a.d % 8 == 0 && a.dv % 8 == 0
      && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
           | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  // the scale and log2(e) in one float, for exp2
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  const long long nq = (a.sq + kRows - 1) / kRows;
  flash_wgmma_kernel<DQ, DV, PT><<<(unsigned)(nq * a.bh), kThreads, smem,
                                   stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), (int)a.bh, (int)a.sq, (int)a.sk, (int)a.d,
      (int)a.dv, a.causal, a.q_offset, a.window, a.kv_len, scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

// Three P terms, or one under p_dtype.
template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           void* lse, const Args& a, cudaStream_t stream) {
  return a.p_bf16 ? launch_pt<DQ, DV, 1>(q, k, v, o, lse, a, stream)
                  : launch_pt<DQ, DV, kPTerms>(q, k, v, o, lse, a, stream);
}

// The value width's kernel for a tile width of DQ (the wider of d and dv
// rounded up): DV = DQ (V or Q and K zero-filled past their width), or 128
// for a qk width past 128 with dv <= 128 (MLA's 192 / 128), up to 192.
template <int DQ>
int launch_dq(const void* q, const void* k, const void* v, void* o,
              void* lse, const Args& a, cudaStream_t stream) {
  if constexpr (DQ > 128 && DQ <= 192) {
    if (a.dv <= 128) return launch<DQ, 128>(q, k, v, o, lse, a, stream);
  }
  return launch<DQ, DQ>(q, k, v, o, lse, a, stream);
}

}  // namespace

// q: (bh, sq, d), k: (bh, sk, d), v: (bh, sk, dv), o: (bh, sq, dv)
// bfloat16, contiguous; o is written in full, and lse, when it is not
// NULL, gets the (bh, sq) float32 row log-sum-exp m + log(l) of the scaled
// scores (the backward's input; an epilogue store only).  Key j is
// valid for query i iff j < kv_len, j <= i + q_offset when causal is 1, and
// j > i + q_offset - window when window > 0 (kv_len is clipped to
// 0..sk).  A query with no valid key gets zeros here (the wrapper's
// keyless pass writes its row).  scale: the score scale, 1/sqrt(d) rounded
// once to float32.  p_bf16 = 1 carries P in one bf16 term (p_dtype).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for d or dv outside 1..256, sk < 1, an sq, sk, |q_offset| or window past
// 2^28 (so that positions and their sums stay in int), or a grid the
// launch cannot hold.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* lse, long long bh,
                                           long long sq,
                                           long long sk, long long d,
                                           long long dv, int causal,
                                           long long q_offset,
                                           long long window, long long kv_len,
                                           float scale, int p_bf16,
                                           void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > kMaxD || dv <= 0 || dv > kMaxD || sk <= 0
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28)
      || ((sq + kRows - 1) / kRows) * bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{bh, sq, sk, d, dv, causal, (int)q_offset, (int)window,
               (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len), scale,
               p_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (((d > dv ? d : dv) + 31) / 32) {
    case 1: return launch_dq<32>(q, k, v, o, lse, a, s);
    case 2: return launch_dq<64>(q, k, v, o, lse, a, s);
    case 3: return launch_dq<96>(q, k, v, o, lse, a, s);
    case 4: return launch_dq<128>(q, k, v, o, lse, a, s);
    case 5: return launch_dq<160>(q, k, v, o, lse, a, s);
    case 6: return launch_dq<192>(q, k, v, o, lse, a, s);
    default: return launch_dq<256>(q, k, v, o, lse, a, s);
  }
}
