// flash_attention_fwd's simple design (flash_attn.cuh) on bfloat16 q, k and
// v: the C entry point of libflash_attn_bf16.so (kernels/flash_attn.py).

#include "flash_attn.cuh"

extern "C" {

int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, void* ws, const void* plan, int bh, int sq,
                              int sk, int d, int bq, int bk, int causal,
                              float scale, void* stream) {
  return flash_entry<__nv_bfloat16>(q, k, v, o, ws, plan, bh, sq, sk, d, bq, bk, causal,
                                    scale, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
