// The repack form's tap sum, redesigned for Hopper (sm_90a).
//
// Replaces, with csrc/stencil3d.cu's halo_sum_kernel beside it for the
// shapes this design does not take (kernels/stencil3d.blocks_design picks
// one): stencil_sum_blocks (_halo_kernel), src/repro/kernels/stencil3d.py:114
// (pallas_call at :129): acc[b] = sum_d w[d] * blocks[b, z+d] over
// halo-extended (nb, W, W, W) blocks, W = T + 2g, of f32, bf16 or f16,
// into f32 (nb, T, T, T). It takes T in {8, 16} and g in {1, 2}, where a
// block's W^3 elements are a multiple of 16 bytes (every such shape in
// these three dtypes) and the ring fits in shared memory.
//
// Numerics, bit-identical to kernels/ref.py's stencil_sum_ref: each
// accumulator starts at 0.0f and takes its (2g+1)^3 terms in dk, di, dj
// order through __fmul_rn / __fadd_rn (never contracted; the library is
// built with -fmad=false and chip_smoke.py checks its SASS for FFMA). A
// bf16 or f16 element widens to f32 exactly as it is loaded.
//
// What bounds it on an H100. Each input byte is read once and each output
// byte written once: at M=256, T=8, g=1 in f32, 131.1 MB in and 67.1 MB out,
// 0.0592 ms at 3.35 TB/s (bf16: 65.5 MB in, 0.0396 ms). The arithmetic is
// 27 multiplies and 27 adds per site, 0.91 G f32 instructions at M=256,
// 0.027 ms at 33.5 T a second: below the bytes, so the design's work is to
// keep the memory busy. The first design (one thread block per block, its
// window copied 4 bytes a thread, then computed) overlaps a block's load
// with its compute only across co-resident thread blocks. This design:
//   1. Bulk copies into a ring. A halo-extended block is one contiguous
//      run of W^3 elements (4,000 B at T=8, g=1 in f32). Thread blocks are
//      persistent, as many per SM as fit, each walking a contiguous run of
//      block ids (the curve's order). One thread issues one 1-D bulk copy
//      (cp.async.bulk, the TMA's unit) per block into a ring of STAGES
//      windows, each guarded by an mbarrier that counts the bytes as they
//      land; the ring holds two rounds, so one round's copies are in
//      flight while the other's blocks are computed.
//   2. Compute from registers. A round takes R blocks (R = 4 at T = 8, one
//      warp a block; R = 1 at T = 16). A thread owns columns of NZ = 4
//      sites along k times NX = 4 along j; it streams the window's k-planes
//      in increasing order, loads each plane row of NX + 2g values once
//      (pairs: 8-byte f32, 4-byte bf16/f16 loads) and adds it to the up to
//      2g+1 accumulators whose dk that plane is, in di, dj order, so each
//      accumulator still sees dk, di, dj in order. Shared loads per site
//      fall from 27 to 3.4 (T = 8, g = 1); the weights sit in registers;
//      every shape is a compile-time constant.
//   3. Write out wide: each thread stores its NX sites of a row as one
//      16-byte f32 store, a half warp covering 256 contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;             // threads per thread block
constexpr int NX = 4;               // sites per thread along j (one f32x4 store)
constexpr int NZ = 4;               // sites per thread along k
constexpr int SMEM_LIMIT = 232448;  // shared memory of one thread block

constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;

// The plan of one instance; kernels/stencil3d.blocks_sm90_smem_bytes is
// the same model of its shared memory.
template <int T, int G, int ITEM>
struct Plan {
  static constexpr int W = T + 2 * G;
  static constexpr int K = 2 * G + 1;
  static constexpr int TAPS = K * K * K;
  static constexpr int WIN_BYTES = W * W * W * ITEM;  // one block's window
  static constexpr int NCOL = (T / NZ) * T * (T / NX);  // columns of a block
  static constexpr int R = NCOL >= NT ? 1 : NT / NCOL;  // blocks per round
  static constexpr int TPB = NT / R;                    // threads per block
  static constexpr int STAGES = 2 * R > 4 ? 2 * R : 4;  // ring depth
  static constexpr int SMEM = STAGES * WIN_BYTES + 8 * STAGES;
  static_assert(T % NZ == 0 && T % NX == 0 && NCOL % TPB == 0, "column plan");
  static_assert(W % 2 == 0, "pair loads need an even row pitch");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory; the barrier expects them and counts them
// as they land.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Two neighbouring elements at an even index, widened exactly to f32.
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// One column: sites (z0 .. z0+NZ-1, y, x0 .. x0+NX-1) of the block whose
// window is `win`, into `dst` (the block's T^3 f32 output).
template <typename E, int T, int G, int TAPS>
__device__ __forceinline__ void column(const E* __restrict__ win,
                                       float* __restrict__ dst, int col,
                                       const float (&w)[TAPS]) {
  constexpr int W = T + 2 * G;
  constexpr int K = 2 * G + 1;
  constexpr int RW = NX + 2 * G;  // values of one plane row
  constexpr int XG = T / NX;
  const int xg = col % XG;
  const int y = (col / XG) % T;
  const int z0 = (col / (XG * T)) * NZ;
  const E* src = win + (z0 * W + y) * W + xg * NX;
  float acc[NZ][NX];
#pragma unroll
  for (int j = 0; j < NZ; ++j)
#pragma unroll
    for (int x = 0; x < NX; ++x) acc[j][x] = 0.0f;
#pragma unroll
  for (int p = 0; p < NZ + 2 * G; ++p) {
#pragma unroll
    for (int di = 0; di < K; ++di) {
      // row di of plane z0 + p: columns xg*NX .. xg*NX + RW - 1
      float r[RW];
#pragma unroll
      for (int q = 0; q < RW; q += 2) {
        const float2 v = load_pair(src + (p * W + di) * W + q);
        r[q] = v.x;
        r[q + 1] = v.y;
      }
      // into every accumulator for which this plane is tap row dk
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        const int dk = p - j;
        if (dk < 0 || dk >= K) continue;
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
          const float wt = w[(dk * K + di) * K + dj];
#pragma unroll
          for (int x = 0; x < NX; ++x)
            acc[j][x] = __fadd_rn(acc[j][x], __fmul_rn(wt, r[x + dj]));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NZ; ++j)
    *reinterpret_cast<float4*>(dst + ((z0 + j) * T + y) * T + xg * NX) =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
}

// Thread block i computes blocks [nb*i/grid, nb*(i+1)/grid), R at a time.
// Block n of the run lives in ring stage n % STAGES, in that stage's
// (n / STAGES)-th use.
template <typename E, int T, int G>
__global__ void __launch_bounds__(NT)
blocks_sm90_kernel(const E* __restrict__ blocks, float* __restrict__ out,
                   const float* __restrict__ weights, int nb) {
  using P = Plan<T, G, static_cast<int>(sizeof(E))>;
  constexpr int W3 = P::W * P::W * P::W;
  constexpr int T3 = T * T * T;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[P::STAGES];

  const int begin = static_cast<int>(static_cast<int64_t>(nb) * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<int64_t>(nb) * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  const int t = threadIdx.x;
  const uint32_t ring0 = smem_addr(ring), full0 = smem_addr(full);

  if (t == 0) {
    for (int s = 0; s < P::STAGES; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int n = 0; n < P::STAGES && begin + n < end; ++n)
      bulk_load(ring0 + n * P::WIN_BYTES, blocks + static_cast<int64_t>(begin + n) * W3,
                P::WIN_BYTES, full0 + 8 * n);
  }

  float w[P::TAPS];
#pragma unroll
  for (int i = 0; i < P::TAPS; ++i) w[i] = __ldg(weights + i);

  const int r = t / P::TPB;   // this thread's block of each round
  const int c0 = t % P::TPB;  // and its first column there
  for (int b0 = begin; b0 < end; b0 += P::R) {
    const int b = b0 + r;
    if (b < end) {
      const int n = b - begin;
      const int s = n % P::STAGES;
      mbar_wait(full0 + 8 * s, (n / P::STAGES) & 1);
      const E* win = reinterpret_cast<const E*>(ring + s * P::WIN_BYTES);
      float* dst = out + static_cast<int64_t>(b) * T3;
#pragma unroll 1
      for (int k = 0; k < P::NCOL / P::TPB; ++k)  // 1 at T = 8, 2 at T = 16
        column<E, T, G>(win, dst, c0 + k * P::TPB, w);
    }
    __syncthreads();  // every thread is done with this round's windows
    if (t == 0) {
      for (int q = 0; q < P::R; ++q) {
        const int bn = b0 + q + P::STAGES;  // the block after the next round's
        if (bn < end) {
          const int n = bn - begin;
          bulk_load(ring0 + (n % P::STAGES) * P::WIN_BYTES,
                    blocks + static_cast<int64_t>(bn) * W3, P::WIN_BYTES,
                    full0 + 8 * (n % P::STAGES));
        }
      }
    }
  }
}

// As many persistent thread blocks as fit on the card at once (the
// occupancy calculator's count, cached per device), but no more than
// there are rounds of blocks.
template <typename E, int T, int G>
cudaError_t launch(const void* blocks, float* out, const float* w, int nb,
                   cudaStream_t stream) {
  using P = Plan<T, G, static_cast<int>(sizeof(E))>;
  if constexpr (P::WIN_BYTES % 16 != 0 || P::SMEM > SMEM_LIMIT) {
    return cudaErrorInvalidValue;
  } else {
    auto kern = blocks_sm90_kernel<E, T, G>;
    constexpr int MAX_DEVICES = 64;
    static int occupancy[MAX_DEVICES][2];  // per device: SMs, blocks per SM
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int* occ = occupancy[dev];
    const size_t dyn = static_cast<size_t>(P::STAGES) * P::WIN_BYTES;
    if (occ[0] == 0) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(dyn));
      if (err != cudaSuccess) return err;
      int sms = 0, per = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, NT, dyn)) !=
              cudaSuccess)
        return err;
      if (per < 1) return cudaErrorInvalidConfiguration;
      occ[1] = per;
      occ[0] = sms;
    }
    const int rounds = (nb + P::R - 1) / P::R;
    const int grid = rounds < occ[0] * occ[1] ? rounds : occ[0] * occ[1];
    kern<<<grid, NT, dyn, stream>>>(static_cast<const E*>(blocks), out, w, nb);
    return cudaGetLastError();
  }
}

template <typename E>
cudaError_t dispatch(int T, int g, const void* blocks, float* out,
                     const float* w, int nb, cudaStream_t st) {
  if (T == 8 && g == 1) return launch<E, 8, 1>(blocks, out, w, nb, st);
  if (T == 8 && g == 2) return launch<E, 8, 2>(blocks, out, w, nb, st);
  if (T == 16 && g == 1) return launch<E, 16, 1>(blocks, out, w, nb, st);
  if (T == 16 && g == 2) return launch<E, 16, 2>(blocks, out, w, nb, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Repack form: blocks (nb, T+2g, T+2g, T+2g) of dtype (0: f32, 1: bf16,
// 2: f16) -> out f32 (nb, T,T,T); both 16-byte aligned. An instance this
// design does not take, or a misaligned pointer, returns
// cudaErrorInvalidValue.
int repro_stencil_sum_blocks_sm90(const void* blocks, void* out, const void* w,
                                  int nb, int T, int g, int dtype,
                                  void* stream) {
  if (nb < 1 || reinterpret_cast<uintptr_t>(blocks) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto o = static_cast<float*>(out);
  auto wp = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return dispatch<float>(T, g, blocks, o, wp, nb, st);
    case DTYPE_BF16: return dispatch<__nv_bfloat16>(T, g, blocks, o, wp, nb, st);
    case DTYPE_F16: return dispatch<__half>(T, g, blocks, o, wp, nb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
