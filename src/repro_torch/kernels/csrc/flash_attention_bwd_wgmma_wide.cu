// K7's backward for bf16 and float16 heads up to kSplitD (256) columns
// that the narrower builds do not take (D or Dv past kMaxD, other than
// MLA's D <= 192 with Dv <= 128), on the tensor cores: the split build of
// flash_bwd_wgmma.cuh (which holds the kernels, their design and what they
// replace), <256, 256>, whose dK/dV pass computes dK and dV in blocks of
// their own over 32-query tiles and whose dQ pass streams 32-key tiles,
// and its entry point.  Two types, with and without p_dtype: 4 dK/dV
// kernels and 3 dQ kernels.
#include "flash_bwd_wgmma.cuh"

// As repro_flash_attention_bwd_wgmma (flash_attention_bwd_wgmma.cu), for
// bfloat16 (dtype 1) or float16 (dtype 2) operands with d and dv_w up to
// 256.
extern "C" int repro_flash_attention_bwd_wgmma_wide(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, const void* keyless_dv, long long bh, long long sq,
    long long sk, long long d, long long dv_w, int causal,
    long long q_offset, long long window, long long kv_len, float scale,
    int p_bf16, int dtype, void* stream) {
  using namespace k7wg;
  if (bh <= 0 || sq <= 0) return 0;
  BwdArgs a;
  const int err = bwd_args(q, k, v, o, lse, dout, dq, dk, dv, delta,
                           keyless_dv, bh, sq, sk, d, dv_w, causal, q_offset,
                           window, kv_len, scale, p_bf16, kSplitD, kSplitD,
                           a);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kCodeBF16)
    return launch_bwd<__nv_bfloat16, kSplitD, kSplitD, kSplitBT, kSplitBT,
                      true>(a, s);
  if (dtype == kCodeF16)
    return launch_bwd<__half, kSplitD, kSplitD, kSplitBT, kSplitBT, true>(a,
                                                                          s);
  return static_cast<int>(cudaErrorInvalidValue);
}
