// K7's forward for float16 inputs with D and Dv up to kMaxD (256), on the
// tensor cores: the f16 instantiations of flash_wgmma.cuh (which holds the
// kernel, its design and what it replaces) and their entry point.  The
// widths are flash_attention_wgmma.cu's; P is carried in kPTermsF16 = 2
// f16 terms (2^-22 of p), or one under p_dtype: 9 builds, 18 kernels.
#include "flash_wgmma.cuh"

// As repro_flash_attention_wgmma (flash_attention_wgmma.cu), for float16
// q, k, v and o (dtype 2); under p_dtype (p_bf16 = 1) P and V are rounded
// to bf16 before P.V, as the reference rounds them.
extern "C" int repro_flash_attention_wgmma_f16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long bh, long long sq, long long sk, long long d, long long dv,
    int causal, long long q_offset, long long window, long long kv_len,
    float scale, int p_bf16, int dtype, void* stream) {
  using namespace k7wg;
  if (bh <= 0 || sq <= 0) return 0;
  FwdArgs a;
  const int err = fwd_args(bh, sq, sk, d, dv, causal, q_offset, window,
                           kv_len, scale, p_bf16, kMaxD, kMaxD, a);
  if (err != 0 || dtype != kCodeF16)
    return err != 0 ? err : static_cast<int>(cudaErrorInvalidValue);
  return launch_square<__half>(q, k, v, o, lse, a,
                               static_cast<cudaStream_t>(stream));
}
