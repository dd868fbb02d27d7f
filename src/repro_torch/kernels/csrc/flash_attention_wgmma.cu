// K7's forward for bf16 inputs with D and Dv up to kMaxD (256), on the
// tensor cores: the bf16 instantiations of flash_wgmma.cuh (which holds the
// kernel, its design and what it replaces) and their entry point.  float16
// is built by flash_attention_wgmma_f16.cu, heads past kMaxD by
// flash_attention_wgmma_wide.cu, so that the three compile in parallel.
//
// Widths: the qk and value tiles are DQ = DV = the wider of D and Dv
// rounded up to 32 (V, or Q and K, zero-filled past their width), except
// MLA's DV = 128 past a qk width of 128 with Dv <= 128; D or Dv in
// 193..256 takes the <256, 256> build: a warpgroup's float32 accumulator at
// 256 columns is 128 registers a thread, and Q and a two-stage K/V ring
// take 193 KB of shared memory.  Each width in two P-term counts: 9
// builds, 18 kernels.
#include "flash_wgmma.cuh"

// q: (bh, sq, d), k: (bh, sk, d), v: (bh, sk, dv), o: (bh, sq, dv)
// bfloat16, contiguous; o is written in full, and lse, when it is not
// NULL, gets the (bh, sq) float32 row log-sum-exp m + log(l) of the scaled
// scores (the backward's input; an epilogue store only).  Key j is
// valid for query i iff j < kv_len, j <= i + q_offset when causal is 1, and
// j > i + q_offset - window when window > 0 (kv_len is clipped to
// 0..sk).  A query with no valid key gets zeros here (the wrapper's
// keyless pass writes its row).  scale: the score scale, 1/sqrt(d) rounded
// once to float32.  p_bf16 = 1 carries P in one bf16 term (p_dtype).
// dtype: the operands' type code, 1 (bfloat16).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// another type, d or dv outside 1..256, sk < 1, an sq, sk, |q_offset| or
// window past 2^28 (so that positions and their sums stay in int), or a
// grid the launch cannot hold.
extern "C" int repro_flash_attention_wgmma(const void* q, const void* k,
                                           const void* v, void* o,
                                           void* lse, long long bh,
                                           long long sq,
                                           long long sk, long long d,
                                           long long dv, int causal,
                                           long long q_offset,
                                           long long window, long long kv_len,
                                           float scale, int p_bf16,
                                           int dtype, void* stream) {
  using namespace k7wg;
  if (bh <= 0 || sq <= 0) return 0;
  FwdArgs a;
  const int err = fwd_args(bh, sq, sk, d, dv, causal, q_offset, window,
                           kv_len, scale, p_bf16, kMaxD, kMaxD, a);
  if (err != 0 || dtype != kCodeBF16)
    return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
  return launch_square<__nv_bfloat16>(q, k, v, o, lse, a,
                                      static_cast<cudaStream_t>(stream));
}
