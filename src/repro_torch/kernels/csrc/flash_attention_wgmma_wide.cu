// K7's forward for bf16 and float16 heads past kMaxD (256), on the tensor
// cores: the wide instantiations of flash_wgmma.cuh (which holds the
// kernel, its design and what it replaces) and their entry point.  A qk
// width up to kSlabD (320) takes the <320, 160> build, up to kWideD (384)
// the <384, 128> build; the value columns run in slabs of the build's
// value width, one block a (query tile, slab), each slab recomputing S on
// the tensor cores.  Two builds x two types x two P-term counts: 8
// kernels.
#include "flash_wgmma.cuh"

namespace {

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                void* lse, const k7wg::FwdArgs& a, cudaStream_t s) {
  using namespace k7wg;
  if (a.d <= kSlabD)
    return launch_fwd<T, kSlabD, kSlabDV>(q, k, v, o, lse, a, s);
  return launch_fwd<T, kWideD, kWideDV>(q, k, v, o, lse, a, s);
}

}  // namespace

// As repro_flash_attention_wgmma (flash_attention_wgmma.cu), for bfloat16
// (dtype 1) or float16 (dtype 2) operands with d up to 384 and dv up to
// 2^20 columns.  Returns cudaErrorInvalidValue for another type or
// width.
extern "C" int repro_flash_attention_wgmma_wide(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long bh, long long sq, long long sk, long long d, long long dv,
    int causal, long long q_offset, long long window, long long kv_len,
    float scale, int p_bf16, int dtype, void* stream) {
  using namespace k7wg;
  if (bh <= 0 || sq <= 0) return 0;
  FwdArgs a;
  const int err = fwd_args(bh, sq, sk, d, dv, causal, q_offset, window,
                           kv_len, scale, p_bf16, kWideD, 1LL << 20, a);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kCodeBF16)
    return launch_wide<__nv_bfloat16>(q, k, v, o, lse, a, s);
  if (dtype == kCodeF16) return launch_wide<__half>(q, k, v, o, lse, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
