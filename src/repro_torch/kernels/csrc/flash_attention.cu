// Fused online-softmax attention (flash attention) on float32 q of
// (BH, Sq, D), k of (BH, Sk, D) and v of (BH, Sk, Dv), Dv <= D <= 192, on
// the CUDA cores: the float32 route of ops.flash_attention_fused and
// ops.flash_attention_masked.  bf16 inputs go to the tensor-core kernel,
// flash_attention_wgmma.cu.  The output is (BH, Sq, Dv).
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
// already expanded to the query head count.
//
// What bounds it on an H100: operations.  At Phi-3-mini's prefill shape in
// float32 (BH 64, S 4,096, D 96, causal) the blocks on and below the
// diagonal need about 2.1e11 FLOP (Q.K^T and P.V), ~3 ms at the CUDA
// cores' 67 TFLOP/s float32 rate, against about 403 MB of q, k, v and o,
// 0.12 ms at 3.35 TB/s.  The S x S scores never reach device memory: that
// is the point of the kernel, as on the TPU.
//
// Design: the arithmetic is float32 on the CUDA cores, as the reference's
// float32 products are (wgmma in TF32 would keep 10 mantissa bits).  One
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
// The masked-row trap: a row whose first processed tile is wholly masked
// (under a window, the block's later queries see none of its first tiles)
// gets m = -1e30 and p = exp(0) = 1 on every masked key, so l and acc pick
// up terms that are not its own.  They are wiped exactly once a real score
// arrives: corr = exp(-1e30 - m_new) is 0 in float32, and l * 0 and acc * 0
// are 0.  From then on a masked key's p = exp(-1e30 - m) is exactly 0.  The
// reference's chunked loop does the same.  A row with no valid key at all
// would keep those terms; the wrappers refuse such calls.
//
// Internal tiles (64 x 64) are the kernel's choice: masking is elementwise
// and the function does not depend on them.  The kernel and the Python
// version differ only in the order of float32 sums.  D <= 192 (MLA's 128 +
// 64 rope lanes; at D = Dv = 192, Q and K tiles of 64 x 196 floats and V's
// and P's take 166,912 bytes of shared memory), Dv <= D.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kMaxD = 192;
constexpr int kLdP = kBQ + 4;  // row stride of P^T in shared memory
constexpr float kNegInf = -1e30f;

// rows x dp floats from src (rows x d, row-major, starting at row r0)
// into dst with row stride ld; zero past d and at or past row s_len.
__device__ __forceinline__ void stage(float* dst,
                                      const float* __restrict__ src,
                                      int r0, int rows, int s_len, int d,
                                      int dp, int ld) {
  for (int e = threadIdx.x; e < rows * dp; e += kThreads) {
    const int r = e / dp;
    const int c = e - r * dp;
    const int row = r0 + r;
    dst[r * ld + c] = (row < s_len && c < d)
                          ? src[(long long)row * d + c] : 0.0f;
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

// NC = ceil(Dv / 16): output columns per thread (tx + 16 * kk).
template <int NC>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int bh_count, int sq, int sk, int d,
             int dv, int causal, int q_offset, int window, int kv_len,
             float scale) {
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
  const long long base_q = bh * sq * (long long)d;
  const long long base_k = bh * sk * (long long)d;
  const long long base_v = bh * sk * (long long)dv;
  const long long base_o = bh * sq * (long long)dv;

  stage(qs, q + base_q, q0, kBQ, sq, d, dp, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) acc[i][kk] = 0.0f;
  }

  // the keys [lo, hi) some query of this tile may see
  const int last_q = min(q0 + kBQ, sq) - 1;
  const int hi = causal ? min(kv_len, last_q + q_offset + 1) : kv_len;
  const int lo = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int t_lo = lo / kBK;
  const int t_hi = hi > lo ? (hi + kBK - 1) / kBK : t_lo;
  for (int kt = t_lo; kt < t_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage(ks, k + base_k, k0, kBK, kv_len, d, dp, ld);
    for (int e = tid; e < kBK * kLdV; e += kThreads) {
      const int r = e / kLdV;
      const int c = e - r * kLdV;
      const int row = k0 + r;
      vs[e] = (row < kv_len && c < dv)
                  ? v[base_v + (long long)row * dv + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < dp; c += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(4 * ty + i) * ld + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(&ks[(tx + 16 * j) * ld + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, b[j].x, t);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          t = fmaf(a[i].w, b[j].w, t);
          s[i][j] = t;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i + q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < kv_len && (!causal || kpos <= qpos)
                        && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
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
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * kLdP + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&pt[c * kLdP + 4 * ty]);
      const float* vr = vs + c * kLdV + tx;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0) lse[bh * sq + row] = m[i] + logf(l[i]);
    float* orow = o + base_o + (long long)row * dv;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const int n = tx + 16 * kk;
      if (n < dv) orow[n] = acc[i][kk] / denom;
    }
  }
}

// The arguments of one launch: shapes, mask and scale.
struct Args {
  long long bh, sq, sk, d, dv;
  int causal, q_offset, window, kv_len;
  float scale;
};

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           void* lse, const Args& a, cudaStream_t stream) {
  const long long d = a.d;
  const long long dp = (d + 3) & ~3LL;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (dp + 4)
                                       + (size_t)kBK * 16 * NC
                                       + (size_t)kBK * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (a.sq + kBQ - 1) / kBQ;
  flash_kernel<NC><<<(unsigned)(nq * a.bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), (int)a.bh,
      (int)a.sq, (int)a.sk, (int)d, (int)a.dv, a.causal, a.q_offset,
      a.window, a.kv_len, a.scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_FLASH_NC(n)                                                  \
  case n:                                                                 \
    return launch<n>(q, k, v, o, lse, a, s);

int dispatch(const void* q, const void* k, const void* v, void* o,
             void* lse, const Args& a, cudaStream_t s) {
  switch ((a.dv + 15) / 16) {
    REPRO_FLASH_NC(1) REPRO_FLASH_NC(2) REPRO_FLASH_NC(3) REPRO_FLASH_NC(4)
    REPRO_FLASH_NC(5) REPRO_FLASH_NC(6) REPRO_FLASH_NC(7) REPRO_FLASH_NC(8)
    REPRO_FLASH_NC(9) REPRO_FLASH_NC(10) REPRO_FLASH_NC(11)
    REPRO_FLASH_NC(12)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_FLASH_NC

}  // namespace

// q: (bh, sq, d), k: (bh, sk, d), v: (bh, sk, dv), o: (bh, sq, dv)
// float32, contiguous; o is written in full, and lse, when it is not
// NULL, gets the (bh, sq) float32 row log-sum-exp m + log(l) of the scaled
// scores (the backward's input; an epilogue store only).  Key j is
// valid for query i iff j < kv_len, j <= i + q_offset when causal is 1, and
// j > i + q_offset - window when window > 0 (kv_len is clipped to
// 0..sk).  A query with no valid key gets zeros.  scale: the score scale,
// 1/sqrt(d) rounded once to float32.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for d outside 1..192, dv outside 1..d,
// sk < 1, an sq, sk, |q_offset| or window past 2^28 (so that positions
// and their sums stay in int), or a grid the launch cannot hold.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     long long bh,
                                     long long sq, long long sk, long long d,
                                     long long dv, int causal,
                                     long long q_offset, long long window,
                                     long long kv_len, float scale,
                                     void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  if (d <= 0 || d > kMaxD || dv <= 0 || dv > d || sk <= 0
      || sq > (1LL << 28) || sk > (1LL << 28) || q_offset > (1LL << 28)
      || q_offset < -(1LL << 28) || window < 0 || window > (1LL << 28)
      || ((sq + kBQ - 1) / kBQ) * bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{bh, sq, sk, d, dv, causal, (int)q_offset, (int)window,
               (int)(kv_len < 0 ? 0 : kv_len > sk ? sk : kv_len), scale};
  return dispatch(q, k, v, o, lse, a, static_cast<cudaStream_t>(stream));
}
