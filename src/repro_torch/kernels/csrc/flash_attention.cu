// Fused online-softmax attention (flash attention) on float32 q and k of
// (BH, S, D) and v of (BH, S, Dv), Dv <= D <= 192, on the CUDA cores: the
// float32 route of ops.flash_attention_fused.  bf16 inputs go to the
// tensor-core kernel, flash_attention_wgmma.cu.  The output is (BH, S, Dv).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_fused (_flash_kernel: grid (BH, nq, nk) with the kv axis
// innermost and sequential on a TPU core, the running max m, denominator l
// and accumulator acc carried in VMEM scratch across kv steps; causal calls
// skip kv blocks wholly above the diagonal and mask the diagonal block with
// -1e30; the output is acc / max(l, 1e-30) in the operands' dtype).  K and V
// come already expanded to the query head count.
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
//      key rows fall in distinct banks;
//   2. each thread forms a 4 x 4 patch of S = Q.K^T (rows 4*ty+i, keys
//      tx+16*j), scales it by 1/sqrt(D), and masks keys past the diagonal
//      (causal) or past S with -1e30, as the reference does;
//   3. row max and row sum go across the 16 threads of a row group with
//      warp shuffles; m, l and the rescale corr = exp(m_prev - m_new) stay
//      in registers, expf (not __expf) throughout;
//   4. P goes to shared memory transposed, and each thread adds P.V into
//      its 4 rows x ceil(Dv/16) columns of the float32 accumulator.
// Causal calls stop the loop at the last tile that holds a key <= the
// tile's last query; the heaviest query tiles are scheduled first.
//
// The masked-row trap: a row whose first processed tile were wholly masked
// would get m = -1e30 and p = exp(0) = 1 on every masked key until a later
// tile corrected it.  Here the kv loop starts at key 0, which every query
// may see (causal or not), so every row's max is a real score after the
// first tile, and a masked key's p = exp(-1e30 - m) is exactly 0.
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

// rows x dp floats from src (rows x d, row-major, starting at row r0 of
// s_len) into dst with row stride ld; zero past d and past s_len.
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
             const float* __restrict__ v, float* __restrict__ o, int bh_count,
             int s_len, int d, int dv, int causal, float scale) {
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
  const int nq = (s_len + kBQ - 1) / kBQ;
  // heaviest causal tiles (the last query tiles) first
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kBQ;
  const long long base = bh * s_len * (long long)d;
  const long long base_v = bh * s_len * (long long)dv;

  stage(qs, q + base, q0, kBQ, s_len, d, dp, ld);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) acc[i][kk] = 0.0f;
  }

  const int n_kv = (s_len + kBK - 1) / kBK;
  int n_tiles = n_kv;
  if (causal) {
    const int last_q = min(q0 + kBQ, s_len) - 1;
    n_tiles = min(n_kv, last_q / kBK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    stage(ks, k + base, k0, kBK, s_len, d, dp, ld);
    for (int e = tid; e < kBK * kLdV; e += kThreads) {
      const int r = e / kLdV;
      const int c = e - r * kLdV;
      const int row = k0 + r;
      vs[e] = (row < s_len && c < dv)
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
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < s_len && (!causal || kpos <= qpos);
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
    if (row >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + base_v + (long long)row * dv;
#pragma unroll
    for (int kk = 0; kk < NC; ++kk) {
      const int n = tx + 16 * kk;
      if (n < dv) orow[n] = acc[i][kk] / denom;
    }
  }
}

template <int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           long long bh, long long s_len, long long d, long long dv,
           int causal, float scale, cudaStream_t stream) {
  const long long dp = (d + 3) & ~3LL;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (dp + 4)
                                       + (size_t)kBK * 16 * NC
                                       + (size_t)kBK * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nq = (s_len + kBQ - 1) / kBQ;
  flash_kernel<NC><<<(unsigned)(nq * bh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), (int)bh,
      (int)s_len, (int)d, (int)dv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_FLASH_NC(n)                                                  \
  case n:                                                                 \
    return launch<n>(q, k, v, o, bh, s_len, d, dv, causal, scale, s);

int dispatch(const void* q, const void* k, const void* v, void* o,
             long long bh, long long s_len, long long d, long long dv,
             int causal, float scale, cudaStream_t s) {
  switch ((dv + 15) / 16) {
    REPRO_FLASH_NC(1) REPRO_FLASH_NC(2) REPRO_FLASH_NC(3) REPRO_FLASH_NC(4)
    REPRO_FLASH_NC(5) REPRO_FLASH_NC(6) REPRO_FLASH_NC(7) REPRO_FLASH_NC(8)
    REPRO_FLASH_NC(9) REPRO_FLASH_NC(10) REPRO_FLASH_NC(11)
    REPRO_FLASH_NC(12)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef REPRO_FLASH_NC

}  // namespace

// q, k: (bh, s_len, d), v, o: (bh, s_len, dv) float32, contiguous; o is
// written in full.  causal: 1 masks keys after each query.  scale: the
// score scale, 1/sqrt(d) rounded once to float32.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// d outside 1..192, dv outside 1..d or a grid the launch cannot hold.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, long long bh,
                                     long long s_len, long long d,
                                     long long dv, int causal, float scale,
                                     void* stream) {
  if (bh <= 0 || s_len <= 0) return 0;
  if (d <= 0 || d > kMaxD || dv <= 0 || dv > d || s_len > 2147483647LL
      || ((s_len + kBQ - 1) / kBQ) * bh > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, o, bh, s_len, d, dv, causal, scale,
                  static_cast<cudaStream_t>(stream));
}
