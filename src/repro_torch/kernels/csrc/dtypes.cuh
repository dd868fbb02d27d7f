// The element types the CUDA-core kernels take, and their conversions to
// and from float32.  The C entry points name a type by one int, the
// wrappers' `ops.dtype_code`: 0 float32, 1 bfloat16, 2 float16 (and 3
// float64 where an entry takes it).  Each kernel that takes these types
// loads an element, computes in float32 (or float64), and rounds once where
// it stores, to nearest even; `round_to<T>` is the float32 value an add in
// T gives (the CPU's and XLA's bf16 and f16 adds: the float32 sum rounded
// to T).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace dtypes {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ double to_f(double x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: exact for float, one rounding for bf16 and f16.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// x rounded to bfloat16 and back (the attention's p_dtype).
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace dtypes
