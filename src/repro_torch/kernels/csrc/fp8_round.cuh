// fp8 stores rounded as XLA converts f32 (kernels/ref.round_to), shared by
// csrc/stencil3d.cu and csrc/flash_attn.cuh: to nearest even, each result
// with x's sign. float8_e4m3fn has no infinity and 448 is its largest
// value: NaN, +-inf and every |x| > 464 (the midpoint past 448) give NaN,
// where the library's saturating conversion would give 448.
// float8_e5m2 gives +-inf from 61440 (the midpoint past 57344) and NaN for
// NaN. The saturating conversion runs only where the result is finite.

#pragma once

#include <cuda_fp8.h>

__device__ __forceinline__ __nv_fp8_storage_t fp8_e4m3_as_xla(float x) {
  if (fabsf(x) <= 464.0f) return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
  return static_cast<__nv_fp8_storage_t>((signbit(x) ? 0x80 : 0x00) | 0x7F);
}

__device__ __forceinline__ __nv_fp8_storage_t fp8_e5m2_as_xla(float x) {
  const int sign = signbit(x) ? 0x80 : 0x00;
  if (isnan(x)) return static_cast<__nv_fp8_storage_t>(sign | 0x7F);
  if (fabsf(x) >= 61440.0f) return static_cast<__nv_fp8_storage_t>(sign | 0x7C);
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E5M2);
}
