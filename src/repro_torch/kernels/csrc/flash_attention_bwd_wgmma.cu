// K7's backward for bf16 operands up to MLA's widths, on the tensor cores:
// the bf16 instantiations of flash_bwd_wgmma.cuh (which holds the kernels,
// their design and what they replace) and their entry point.  float16 is
// built by flash_attention_bwd_wgmma_f16.cu, heads past these widths by
// flash_attention_bwd_wgmma_wide.cu, so that the three compile in
// parallel.  Six builds (the square 32, 64, 96 and 128, qk 64 / v 128,
// MLA's 192 / 128), each with and without p_dtype: 18 kernels.
#include "flash_bwd_wgmma.cuh"

// q, dq: (bh, sq, d); k, dk: (bh, sk, d); v, dv: (bh, sk, dv_w); o, dout:
// (bh, sq, dv_w), all bfloat16, contiguous; lse: the forward's (bh, sq)
// float32 row log-sum-exp (+1e30 on a row without keys); delta: bh * sq +
// 2 bh float32 scratch (Delta, then float16's dS stats); keyless_dv: NULL, or the (bh, dv_w) float32 dV that
// every key gets from the queries without a key (repro_flash_keyless),
// added to dv before its rounding.  dq, dk and dv are written in full
// (keys at or past kv_len get zeros, plus keyless_dv).  The mask, scale and
// p_bf16 (p_dtype: P rounded to bf16 in dV) are the forward's; dtype: the
// operands' type code, 1 (bfloat16).  Three launches on `stream`: the
// Delta pre-pass, the dK/dV pass and the dQ pass.  Returns
// cudaGetLastError() after them, or cudaErrorInvalidValue for another
// type, a head no build here takes (d or dv_w past kMaxD unless d <=
// kWideD and dv_w <= kWideDV: MLA's build), sk < 1, an sq, sk, |q_offset|
// or window past 2^28, or a grid the launch cannot hold.
extern "C" int repro_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, const void* keyless_dv, long long bh, long long sq,
    long long sk, long long d, long long dv_w, int causal,
    long long q_offset, long long window, long long kv_len, float scale,
    int p_bf16, int dtype, void* stream) {
  using namespace k7wg;
  if (bh <= 0 || sq <= 0) return 0;
  BwdArgs a;
  int err = bwd_args(q, k, v, o, lse, dout, dq, dk, dv, delta, keyless_dv,
                     bh, sq, sk, d, dv_w, causal, q_offset, window, kv_len,
                     scale, p_bf16, kWideD, kWideDV > kMaxD ? kWideDV : kMaxD,
                     a);
  if (err == 0 && (dtype != kCodeBF16 || (d > kMaxD && dv_w > kWideDV)))
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  return launch_bwd_narrow<__nv_bfloat16>(a,
                                          static_cast<cudaStream_t>(stream));
}
