// Fused online-softmax attention (flash attention) for float32 q of
// (BH, Sq, D), k of (BH, Sk, D) and v of (BH, Sk, Dv), D and Dv up to
// kF32MaxD, on the tensor cores of a Hopper GPU (sm_90a): the float32 route
// of ops.flash_attention_fused and ops.flash_attention_masked.  Wider heads
// and float32 calls under p_dtype go to flash_attention.cu (the CUDA
// cores); bf16 and float16 to flash_wgmma.cuh.  The output is (BH, Sq, Dv)
// float32.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:73
// (flash_attention_fused; body _flash_kernel :29), as flash_wgmma.cuh does,
// under the same masks (key j is valid for query i iff j < kv_len,
// j <= i + q_offset when causal, j > i + q_offset - window when
// window > 0): S = Q.K^T * (1/sqrt(D)) in float32, invalid keys masked with
// -1e30, a running max m, denominator l and accumulator acc in float32 over
// kv tiles in ascending order, P = exp(S - m) in float32 for P.V, the output
// acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  Phi-3-mini's prefill in float32
// (BH 64, S 4,096, D 96, causal) needs 2.06e11 FLOP of Q.K^T and P.V, 3.07
// ms at the CUDA cores' 67 TFLOP/s float32 rate; the tensor cores take no
// float32 operand.  One bf16 product keeps 8 bits of each operand and
// TF32 10, against float32's 24.
//
// Design (what it does about that bound): every float32 operand is carried
// as kF32Terms = 3 bf16 terms, x = t1 + t2 + t3 with t1 = bf16(x),
// t2 = bf16(x - t1), t3 = bf16(x - t1 - t2) (each difference exact in
// float32, so the terms keep 24 bits of x), and a product is the sum of
// the term products t_i u_j with i + j < kF32Terms, six of the nine (the
// three left out are below 2^-26 of the product), each exact in float32
// and summed by wgmma into float32 accumulators:
//   S = sum_{i+j<3} Q_i K_j^T and P.V = sum_{i+j<3} P_i V_j,
// 6x the bf16 route's Q.K^T and 2x its P.V (P in three terms there too):
// 1.25 ms at 989 TFLOP/s at Phi-3's shape, 1.67 ms at D 256 (BH 32,
// S 4,096).  tests/test_torch_flash.py emulates the arithmetic: three
// terms meet chip_smoke.py's float32 gate (rtol = atol = 1e-5) against the
// plain version, two terms (three products) miss it, and so do three terms
// on one side with two on the other.
//   * split_kernel writes Q, K and V once as three bf16 planes each, into
//     the caller's scratch (f32_scratch_elems), rows zero-padded to a
//     multiple of kF32Pad columns: a float32 operand cannot be split by the
//     copy that stages it (cp.async moves bytes), and the planes make every
//     later copy a whole, aligned 16-byte one, for any D and alignment.
//   * flash_f32_kernel: one block of one warpgroup (128 threads) owns
//     kF32Rows = 64 query rows of one bh, heaviest query tiles first, and
//     runs the kv loop over tiles of kF32BK = 64 keys, from the tile of the
//     first key any of its queries may see to that of the last, as
//     flash_wgmma.cuh does; only the tiles that reach past kv_len, a
//     diagonal or a window edge are masked elementwise.  Q's three planes
//     (64 rows x D) stay in shared memory.  Three planes of a whole K and
//     V tile do not fit beside them at D 256 (2 x 96 KB), so K and V pass
//     through a ring of kF32Stages stages, each one 64-column panel of a
//     tile in its three planes (24 KB, 64 keys x 128 bytes a plane, SW128):
//     a tile's ceil(D / 64) K panels, then its ceil(Dv / 64) V panels, the
//     copies of the panel kF32Stages - 1 ahead in flight (cp.async) while
//     one is multiplied.  Shared memory: 24 KB x (ceil(D / 64) + stages),
//     plus 1 KB to align: 97 KB at D 96 (two blocks an SM), 145 KB at D 256.
//   * S: for each K panel and 16-column step, the six products
//     wgmma m64n64k16 Q_i . K_j^T, both operands K-major in shared memory.
//   * Softmax as flash_wgmma.cuh's, on the accumulator fragments in the
//     log2 domain (ex2.approx), then P split into its three terms in the
//     register A fragments of the four 16-key steps of P.V.
//   * P.V: for each V panel, acc[p] += P_i . V_j (i + j < 3) over the four
//     16-key steps, V read MN-major from shared memory (transpose bit);
//     a panel of 32 value columns uses m64n32k16.
//   * The epilogue divides by l and stores float32 pairs; the first query
//     row's lse is m + log(l) (natural log) for the backward.
// No atomics: a repeat gives the same bits.  Queries with no valid key get
// zeros here; the wrapper's keyless pass (flash_attention.cu) writes their
// rows.  The masked-row trap is flash_wgmma.cuh's: terms a wholly masked
// first tile leaves in l and acc are wiped once a real score arrives
// (corr = 2^(-1e30 - m) = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

namespace {

using hopper::sw128;
using hopper::sw128_desc;
using k7wg::kNegInf;
using k7wg::panel_cols;

constexpr int kF32Terms = 3;      // bf16 terms of a float32 operand
constexpr int kF32Rows = 64;      // query rows a block (one warpgroup)
constexpr int kF32Threads = 128;
constexpr int kF32BK = 64;        // keys a kv tile
constexpr int kF32MaxD = 256;     // the widest qk and value width
constexpr int kF32Pad = 16;       // a plane's row: columns a multiple of it
constexpr int kF32Stages = 2;     // K/V panels in the ring (24 KB each)
constexpr int kF32SplitThreads = 256;
constexpr uint32_t kPanel = 64 * 128;             // 64 rows x 64 bf16
constexpr uint32_t kStage = kF32Terms * kPanel;   // a panel's three planes

static_assert(kF32Stages >= 2, "the ring needs two stages");

// The element count of one term plane of an (rows x width) operand.
__host__ __device__ constexpr long long plane_elems(long long rows,
                                                    long long width) {
  return rows * ((width + kF32Pad - 1) / kF32Pad * kF32Pad);
}

// x as three bf16 terms, t1 = bf16(x), t2 = bf16(x - t1), t3 = bf16(x - t1
// - t2), eight values at a time, as three 16-byte words.
__device__ __forceinline__ void split8(const float (&x)[8], uint4 (&w)[3]) {
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = x[i];
#pragma unroll
  for (int t = 0; t < kF32Terms; ++t) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 back;
      u[i] = k7wg::pack2(__nv_bfloat16(), r[2 * i], r[2 * i + 1], back);
      r[2 * i] -= back.x;
      r[2 * i + 1] -= back.y;
    }
    w[t] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// One operand (rows x width float32, rows `width` apart) into its three
// planes at `planes` (pitch = width rounded up to kF32Pad, zeros past
// width): thread e of the grid-stride loop takes 8 columns of one row.
__device__ __forceinline__ void split_operand(const float* __restrict__ x,
                                              __nv_bfloat16* __restrict__ pl,
                                              long long rows, int width,
                                              bool vec, long long e0,
                                              long long stride) {
  const int pitch = (width + kF32Pad - 1) / kF32Pad * kF32Pad;
  const int groups = pitch / 8;
  const long long n = rows * groups;
  const long long te = plane_elems(rows, width);
  for (long long e = e0; e < n; e += stride) {
    const long long row = e / groups;
    const int c0 = (int)(e - row * groups) * 8;
    const float* src = x + row * width + c0;
    float v[8];
    if (vec && c0 + 8 <= width) {
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c0 + i < width ? src[i] : 0.0f;
    }
    uint4 w[kF32Terms];
    split8(v, w);
#pragma unroll
    for (int t = 0; t < kF32Terms; ++t)
      *reinterpret_cast<uint4*>(pl + t * te + row * pitch + c0) = w[t];
  }
}

// Q, K and V into their planes (the q planes, then k's, then v's).
__global__ void __launch_bounds__(kF32SplitThreads)
split_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, __nv_bfloat16* __restrict__ pl,
             long long q_rows, long long k_rows, int d, int dv, int vec_qk,
             int vec_v) {
  const long long e0 = (long long)blockIdx.x * kF32SplitThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kF32SplitThreads;
  __nv_bfloat16* kp = pl + kF32Terms * plane_elems(q_rows, d);
  __nv_bfloat16* vp = kp + kF32Terms * plane_elems(k_rows, d);
  split_operand(q, pl, q_rows, d, vec_qk, e0, stride);
  split_operand(k, kp, k_rows, d, vec_qk, e0, stride);
  split_operand(v, vp, k_rows, dv, vec_v, e0, stride);
}

// Rows [row0, row0 + 64) of the three planes at `pl` (term planes `te`
// elements apart, rows `pitch` apart), columns [c0, c0 + 64), into the
// stage at shared address `dst` (term t's SW128 panel at dst + t * kPanel):
// zeros for rows r >= rows and columns past the pitch.
__device__ __forceinline__ void load_panel(uint32_t dst,
                                           const __nv_bfloat16* pl,
                                           long long te, long long row0,
                                           int rows, int pitch, int c0) {
  for (int e = threadIdx.x; e < kF32Terms * 64 * 8; e += kF32Threads) {
    const int t = e >> 9, r = (e >> 3) & 63, ch = e & 7;
    const bool ok = r < rows && c0 + ch * 8 < pitch;
    hopper::cp_async_16(
        dst + t * kPanel + sw128(r, ch),
        ok ? pl + t * te + (row0 + r) * pitch + c0 + ch * 8 : pl,
        ok ? 16 : 0);
  }
}

// DV: the value width rounded up to 32 (the accumulator's panels, the last
// one 32 columns wide where DV % 64 == 32); the qk width is a runtime
// value (its panels are streamed, not held).
template <int DV>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_f32_kernel(const __nv_bfloat16* __restrict__ pl, float* __restrict__ o,
                 float* __restrict__ lse, int bh_count, int sq, int sk,
                 int d, int dv, int causal, int q_offset, int window,
                 int kv_len, float scale_log2) {
  constexpr int NV = (DV + 63) / 64;  // value panels
  const int dqp = (d + kF32Pad - 1) / kF32Pad * kF32Pad;  // plane pitches
  const int dvp = (dv + kF32Pad - 1) / kF32Pad * kF32Pad;
  const int nqp = (dqp + 63) / 64;   // qk panels
  const int np = nqp + NV;           // the panels of one kv tile
  const long long q_te = (long long)bh_count * sq * dqp;
  const long long k_te = (long long)bh_count * sk * dqp;
  const long long v_te = (long long)bh_count * sk * dvp;
  const __nv_bfloat16* kpl = pl + kF32Terms * q_te;
  const __nv_bfloat16* vpl = kpl + kF32Terms * k_te;

  extern __shared__ unsigned char smem_raw[];
  // panels start on 1024-byte boundaries (the SW128 pattern's period):
  // Q's panels (three planes each), then the ring's stages
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t rs = qs + nqp * kStage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nq = (sq + kF32Rows - 1) / kF32Rows;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);  // heaviest first
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kF32Rows;

  // the kv tiles [t_lo, t_hi) that hold the keys [lo, hi) some query of
  // this block may see (every key of [lo, hi) is seen by one of them)
  const int last_q = min(q0 + kF32Rows, sq) - 1;
  const int hi = causal ? min(kv_len, last_q + q_offset + 1) : kv_len;
  const int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_lo = lo / kF32BK;
  const int t_hi = hi > lo ? (hi + kF32BK - 1) / kF32BK : t_lo;
  const int n_panels = (t_hi - t_lo) * np;

  // panel g of the call: tile t_lo + g / np; its K panels, then its V
  // panels, each into stage g % kF32Stages (an empty group past the last)
  auto fetch = [&](int g) {
    if (g < n_panels) {
      const int t = t_lo + g / np, j = g % np;
      const int k0 = t * kF32BK;
      const uint32_t dst = rs + (g % kF32Stages) * kStage;
      const long long row0 = bh * sk + k0;
      if (j < nqp)
        load_panel(dst, kpl, k_te, row0, kv_len - k0, dqp, 64 * j);
      else
        load_panel(dst, vpl, v_te, row0, kv_len - k0, dvp, 64 * (j - nqp));
    }
    hopper::cp_async_commit();
  };
  // panel g has landed in every thread's copies, and every thread is done
  // with panel g - 1, whose stage then takes the copies of panel
  // g + kF32Stages - 1
  auto ready = [&](int g) {
    hopper::cp_async_wait<kF32Stages - 2>();
    hopper::fence_proxy_async();
    __syncthreads();
    fetch(g + kF32Stages - 1);
  };

  if (n_panels > 0) {
    for (int p = 0; p < nqp; ++p)
      load_panel(qs + p * kStage, pl, q_te, bh * sq + q0, sq - q0, dqp,
                 64 * p);
    for (int g = 0; g < kF32Stages - 1; ++g) fetch(g);  // Q with panel 0
  }

  // This thread's accumulator rows (r and r + 8) and first column, as in
  // flash_wgmma.cuh: value i of a 64 x N accumulator at row
  // 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) +
  // 2 * (lane % 4) + i % 2.
  const int row0 = q0 + 16 * (tid >> 5) + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const int p0 = q0 + q_offset;
  auto key_lo = [&](int p) { return window > 0 ? p - window + 1 : 0; };
  auto key_hi = [&](int p) { return causal ? min(kv_len, p + 1) : kv_len; };
  const int all_lo = key_lo(p0 + kF32Rows - 1), all_hi = key_hi(p0);
  const int lo_r[2] = {key_lo(row0 + q_offset), key_lo(row0 + 8 + q_offset)};
  const int hi_r[2] = {key_hi(row0 + q_offset), key_hi(row0 + 8 + q_offset)};

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  float acc[NV][32];
#pragma unroll
  for (int p = 0; p < NV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;

  int g = 0;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kF32BK;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
    // S = sum_{i+j<3} Q_i . K_j^T, a K panel at a time
    for (int kp = 0; kp < nqp; ++kp, ++g) {
      ready(g);
      const uint32_t kt = rs + (g % kF32Stages) * kStage;
      const uint32_t qt_ = qs + kp * kStage;
      const int steps = min(64, dqp - 64 * kp) / 16;
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= steps) break;
#pragma unroll
        for (int i = 0; i < kF32Terms; ++i)
#pragma unroll
          for (int j = 0; i + j < kF32Terms; ++j)
            hopper::wgmma_ss_m64n64k16<__nv_bfloat16>(
                s, sw128_desc(qt_ + i * kPanel + kk * 32, 16, 1024),
                sw128_desc(kt + j * kPanel + kk * 32, 16, 1024), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
    }

    // scale into the log2 domain; mask only the tiles where some key is
    // invalid for some query of this block
    const bool edge = k0 < all_lo || k0 + kF32BK > all_hi;
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
    // P and its terms: step kk's A fragments are accumulator values
    // 8 kk .. 8 kk + 7, pairwise (rows r, r + 8, r, r + 8)
    uint32_t pa[4][kF32Terms][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1;
        const float a = hopper::ex2(s[8 * kk + 2 * r] - m[h]);
        const float b = hopper::ex2(s[8 * kk + 2 * r + 1] - m[h]);
        l[h] += a + b;
        k7wg::split_pair<__nv_bfloat16, kF32Terms>(a, b, pa[kk], r);
      }

    // acc[p] += sum_{i+j<3} P_i . V_j, a V panel at a time
    for (int vp = 0; vp < NV; ++vp, ++g) {
      ready(g);
      const uint32_t vt = rs + (g % kF32Stages) * kStage;
#pragma unroll
      for (int p = 0; p < NV; ++p) {
        if (p != vp) continue;
        k7wg::fence_acc<DV>(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < kF32Terms; ++i)
#pragma unroll
            for (int j = 0; i + j < kF32Terms; ++j) {
              const uint64_t desc =
                  sw128_desc(vt + j * kPanel + kk * 2048, kPanel, 1024);
              if (panel_cols<DV>(p) == 64)
                hopper::wgmma_rs_m64n64k16<__nv_bfloat16>(acc[p], pa[kk][i],
                                                         desc);
              else
                hopper::wgmma_rs_m64n32k16<__nv_bfloat16>(acc[p], pa[kk][i],
                                                         desc);
            }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        k7wg::fence_acc<DV>(acc);
      }
    }
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
    float* orow = o + (bh * sq + row) * (long long)dv;
#pragma unroll
    for (int p = 0; p < NV; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= panel_cols<DV>(p)) continue;
        const int c = 64 * p + 8 * j + col0;
        if (c >= dv) continue;
        const float x = acc[p][4 * j + 2 * h] / denom;
        const float y = acc[p][4 * j + 2 * h + 1] / denom;
        if (c + 1 < dv && (dv & 1) == 0)
          *reinterpret_cast<float2*>(orow + c) = make_float2(x, y);
        else {
          orow[c] = x;
          if (c + 1 < dv) orow[c + 1] = y;
        }
      }
  }
}

template <int DV>
int launch(const __nv_bfloat16* pl, float* o, float* lse, long long bh,
           long long sq, long long sk, int d, int dv, int causal,
           int q_offset, int window, int kv_len, float scale,
           cudaStream_t stream) {
  const int nqp = ((d + kF32Pad - 1) / kF32Pad * kF32Pad + 63) / 64;
  const int smem = 1024 + (nqp + kF32Stages) * (int)kStage;
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (sq + kF32Rows - 1) / kF32Rows;
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  flash_f32_kernel<DV><<<(unsigned)(nq * bh), kF32Threads, smem, stream>>>(
      pl, o, lse, (int)bh, (int)sq, (int)sk, d, dv, causal, q_offset, window,
      kv_len, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (bh, sq, d), k: (bh, sk, d), v: (bh, sk, dv), o: (bh, sq, dv)
// float32, contiguous; scratch: scratch_elems bf16 elements, 16-byte
// aligned, at least three planes each of q, k and v, their rows padded to
// kF32Pad columns (flash_attention.f32_scratch_elems).  o is written in
// full, and lse, when it is not NULL, gets the (bh, sq) float32 row
// log-sum-exp m + log(l).  Masks, scale and the rows of queries without a
// key as repro_flash_attention_wgmma (flash_attention_wgmma.cu).  p_bf16
// must be 0 and dtype 0 (float32).  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for another type, p_bf16, d or dv
// outside 1..kF32MaxD, sk < 1, an sq, sk, |q_offset| or window past 2^28, a
// scratch too small or unaligned, or a grid the launch cannot hold.
extern "C" int repro_flash_attention_wgmma_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    void* scratch, long long scratch_elems, long long bh, long long sq,
    long long sk, long long d, long long dv, int causal, long long q_offset,
    long long window, long long kv_len, float scale, int p_bf16, int dtype,
    void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  k7wg::FwdArgs a;
  const int err = k7wg::fwd_args(bh, sq, sk, d, dv, causal, q_offset, window,
                                 kv_len, scale, p_bf16, kF32MaxD, kF32MaxD,
                                 a);
  if (err != 0) return err;
  if (dtype != 0 || p_bf16 != 0
      || (sq + kF32Rows - 1) / kF32Rows * bh > 2147483647LL
      || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0
      || scratch_elems < kF32Terms * (plane_elems(bh * sq, d)
                                      + plane_elems(bh * sk, d)
                                      + plane_elems(bh * sk, dv)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* pl = static_cast<__nv_bfloat16*>(scratch);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_qk = d % 4 == 0 && aligned(q) && aligned(k);
  const int vec_v = dv % 4 == 0 && aligned(v);
  const long long groups = (bh * sq + bh * sk)
      * ((d + kF32Pad - 1) / kF32Pad * kF32Pad / 8);
  const long long blocks = (groups + kF32SplitThreads - 1) / kF32SplitThreads;
  split_kernel<<<(unsigned)(blocks < 2048 ? blocks : 2048), kF32SplitThreads,
                 0, s>>>(static_cast<const float*>(q),
                         static_cast<const float*>(k),
                         static_cast<const float*>(v), pl, bh * sq, bh * sk,
                         (int)d, (int)dv, vec_qk, vec_v);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  float* out = static_cast<float*>(o);
  float* ls = static_cast<float*>(lse);
  const int di = (int)a.d, dvi = (int)a.dv;
#define K7F32_LAUNCH(W)                                                     \
  return launch<W>(pl, out, ls, a.bh, a.sq, a.sk, di, dvi, a.causal,       \
                   a.q_offset, a.window, a.kv_len, a.scale, s)
  switch ((dvi + 31) / 32) {
    case 1: K7F32_LAUNCH(32);
    case 2: K7F32_LAUNCH(64);
    case 3: K7F32_LAUNCH(96);
    case 4: K7F32_LAUNCH(128);
    case 5: K7F32_LAUNCH(160);
    case 6: K7F32_LAUNCH(192);
    case 7: K7F32_LAUNCH(224);
    default: K7F32_LAUNCH(256);
  }
#undef K7F32_LAUNCH
}
