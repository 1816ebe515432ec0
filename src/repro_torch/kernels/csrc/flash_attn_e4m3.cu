// flash_attention_fwd's and flash_attention_bwd's simple designs
// (flash_attn.cuh, flash_attn_bwd.cuh) on float8_e4m3fn q, k and v: the C entry
// points of libflash_attn_e4m3.so (kernels/flash_attn.py).

#include "flash_attn_bwd.cuh"

extern "C" {

int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, void* ws, const void* plan,
                              int bh, int sq, int sk, int d, int bq, int bk,
                              int causal, float scale, void* stream) {
  return flash_entry<__nv_fp8_e4m3>(q, k, v, o, lse, ws, plan, bh, sq, sk, d, bq, bk,
                                    causal, scale, stream);
}

int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* lse, const void* dout,
                              void* dq, void* dk, void* dv, void* delta, void* ws,
                              int bh, int sq, int sk, int d, int bq, int bk,
                              int causal, float scale, void* stream) {
  return flash_bwd_entry<__nv_fp8_e4m3>(q, k, v, o, lse, dout, dq, dk, dv, delta, ws, bh, sq,
                                        sk, d, bq, bk, causal, scale, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
