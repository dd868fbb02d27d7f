// K7's backward for float16 operands up to MLA's widths, on the tensor
// cores: the f16 instantiations of flash_bwd_wgmma.cuh (which holds the
// kernels, their design and what they replace) and their entry point.  The
// builds are flash_attention_bwd_wgmma.cu's; P and dS go in kTermsF16 = 2
// f16 terms: 24 kernels (the dQ pass too has a p_dtype build, which rounds
// V to bf16).
#include "flash_bwd_wgmma.cuh"

// As repro_flash_attention_bwd_wgmma (flash_attention_bwd_wgmma.cu), for
// float16 operands (dtype 2).
extern "C" int repro_flash_attention_bwd_wgmma_f16(
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
  if (err == 0 && (dtype != kCodeF16 || (d > kMaxD && dv_w > kWideDV)))
    err = static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  return launch_bwd_narrow<__half>(a, static_cast<cudaStream_t>(stream));
}
