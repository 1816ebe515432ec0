// SFC-blocked 3-D weighted stencil kernels for Hopper (sm_90a).
// (fused_kernel now serves the shapes and dtypes csrc/stencil3d_sm90.cu does
// not take: T outside {8, 16}, g outside {1, 2}, three windows too large, or
// a bf16, f16 or fp8 store; halo_sum_kernel the shapes and dtypes
// csrc/stencil3d_blocks_sm90.cu does not take, fp8 blocks among them.)
//
// Three kernels, behind a plain C interface loaded with ctypes
// (kernels/_build.py, kernels/stencil3d.py):
//
//   fused_kernel<RULE, G>   replaces stencil_step_fused (_fused_kernel) of
//                           src/repro/kernels/stencil3d.py: S substeps of
//                           ghost refresh + tap sum + update rule per launch
//                           over the resident curve-ordered block store.
//   the same template with RULE_IDENTITY, S = 1, periodic
//                           replaces stencil_sum_resident (_resident_kernel):
//                           on an f32 store the identity rule's output is
//                           the tap sum itself.
//   halo_sum_kernel<G>      replaces stencil_sum_blocks (_halo_kernel): the
//                           tap sum of one halo-extended block per thread
//                           block (the repack baseline).
//
// Element types. Every kernel is templated on the store's element type
// (float, __nv_bfloat16, __half, __nv_fp8_e4m3 or __nv_fp8_e5m2). Loads
// widen to f32 exactly, the window in shared memory is f32, and every
// substep runs in f32; the one write rounds to the store's type (the fused
// step) or is f32 (the two tap sums), as the reference does
// (src/repro/kernels/stencil3d.py: _assemble_window casts to f32,
// _fused_kernel writes in o_ref's dtype). The fp8 writes round as XLA
// converts (fp8_round.cuh, kernels/ref.round_to): e4m3fn gives NaN above
// 464 in magnitude, where the library's saturating conversion gives 448.
//
// Numerics. Every product and sum uses the round-to-nearest intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn), which the compiler never contracts
// into a fused multiply-add, and the library is also built with
// -fmad=false and -prec-div=true and never with --use_fast_math. So
// `acc + w*x` rounds exactly as the plain PyTorch version's separate
// multiply and add, taps go in dk, di, dj order, and jacobi divides
// as IEEE division: all four rules are bit-identical to kernels/ref.py.
//
// What bounds them on an H100 (3.35 TB/s HBM, 67 TFLOP/s f32 without the
// tensor cores; a stencil does no matrix product, so wgmma has no use).
//   fused: the compulsory traffic is one read and one write of the store
//     (C*M^3*4 B each way; 134 MB for M=256, C=1). What the launch really
//     streams is fused_items_per_launch * 4 B (stencil/pipeline.py): every
//     block reads its whole (T+2Sg)^3 window, so neighbour planes are read
//     again by each block that needs them (604 MB for M=256, T=8, S=4,
//     g=1), mostly from L2, because consecutive blocks along the curve
//     share neighbours. Inside the block the (2g+1)^3 = 27 shared-memory
//     loads per site and substep, and the 2*27 f32 operations beside them,
//     are the larger cost. The function needs S*M^3*54 operations (3.6
//     GFLOP at M=256, S=4, 0.054 ms at 67 TFLOP/s, its bound); this design
//     also recomputes the halo sites each shrinking window still needs,
//     about 10.6 GFLOP and 21 GB of shared-memory traffic per launch at
//     that shape (T=8). The design keeps the whole window
//     and both substep buffers in shared memory, so nothing between the
//     first read and the last write touches device memory, and holds the
//     weights in registers (G > 0) so that each tap is one shared load.
//     Register tiling along k, TMA loads and more than one block per
//     thread block are left for later work.
//   resident: as fused with S = 1: a (T+2g)^3 window read and a T^3 write
//     per block; 27 shared loads per site.
//   halo_sum: bound by its input, the halo-duplicated (T+2g)^3 block read
//     once ((10/8)^3 = 1.95x the store for T=8, g=1), plus the T^3 write.
//     Nothing here overlaps a block's load with its compute but the
//     co-resident thread blocks; csrc/stencil3d_blocks_sm90.cu, the Hopper
//     design, does (bulk copies into a ring) for T in {8, 16}, g in {1, 2}.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fp8_round.cuh"

namespace {

constexpr int RULE_GOL = 0;
constexpr int RULE_JACOBI = 1;
constexpr int RULE_IDENTITY = 2;
constexpr int RULE_WAVE = 3;

constexpr int BC_PERIODIC = 0;
constexpr int BC_DIRICHLET = 1;
constexpr int BC_NEUMANN0 = 2;

// The store's element type, as the wrapper passes it.
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;
constexpr int DTYPE_F16 = 2;
constexpr int DTYPE_E4M3 = 3;
constexpr int DTYPE_E5M2 = 4;

constexpr int THREADS = 256;
// Taps are unrolled with the weights in registers for g = 1 and g = 2
// (27 and 125 taps, Weights<1>, Weights<2>); above 125 taps a runtime loop
// reads them through the read-only cache (Weights<0>).

// Per-axis boundary contract, k then i then j (kernels/rules.py).
struct Bc {
  int kind[3];
  float value[3];
};

__host__ __device__ constexpr int channels_of(int rule) {
  return rule == RULE_WAVE ? 2 : 1;
}

// Exact widening of a stored element, and the one rounding of a result.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ float widen(__nv_fp8_e5m2 x) { return static_cast<float>(x); }

__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void put(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void put(__nv_fp8_e4m3* p, float x) {
  *reinterpret_cast<__nv_fp8_storage_t*>(p) = fp8_e4m3_as_xla(x);
}
__device__ __forceinline__ void put(__nv_fp8_e5m2* p, float x) {
  *reinterpret_cast<__nv_fp8_storage_t*>(p) = fp8_e5m2_as_xla(x);
}

// Weights of a compile-time radius held in registers; a runtime radius
// reads them through the read-only cache.
template <int G>
struct Weights {
  static constexpr int s = 2 * G + 1;
  float w[s * s * s];
  __device__ __forceinline__ void load(const float* __restrict__ gw, int) {
#pragma unroll
    for (int t = 0; t < s * s * s; ++t) w[t] = __ldg(gw + t);
  }
  __device__ __forceinline__ int radius() const { return G; }
  // acc = sum over (dk, di, dj) of w * x[(z+dk, y+di, x+dj)], window edge E
  __device__ __forceinline__ float tap(const float* x, int E) const {
    float acc = 0.0f;
#pragma unroll
    for (int dk = 0; dk < s; ++dk)
#pragma unroll
      for (int di = 0; di < s; ++di)
#pragma unroll
        for (int dj = 0; dj < s; ++dj)
          acc = __fadd_rn(acc, __fmul_rn(w[(dk * s + di) * s + dj],
                                         x[(dk * E + di) * E + dj]));
    return acc;
  }
};

template <>
struct Weights<0> {
  const float* __restrict__ w;
  int g;
  __device__ __forceinline__ void load(const float* __restrict__ gw, int g_rt) {
    w = gw;
    g = g_rt;
  }
  __device__ __forceinline__ int radius() const { return g; }
  __device__ __forceinline__ float tap(const float* x, int E) const {
    const int s = 2 * g + 1;
    float acc = 0.0f;
    for (int dk = 0; dk < s; ++dk)
      for (int di = 0; di < s; ++di)
        for (int dj = 0; dj < s; ++dj)
          acc = __fadd_rn(acc, __fmul_rn(__ldg(w + (dk * s + di) * s + dj),
                                         x[(dk * E + di) * E + dj]));
    return acc;
  }
};

__device__ __forceinline__ float gol_rule(float centre, float tap, int g) {
  const int n = (2 * g + 1) * (2 * g + 1) * (2 * g + 1) - 1;
  const float lo = static_cast<float>((2 * n) / 8);
  const float hi = static_cast<float>((3 * n) / 8);  // also the birth count
  const bool alive = centre > 0.5f;
  const bool next = alive ? (tap >= lo && tap <= hi) : (tap == hi);
  return next ? 1.0f : 0.0f;
}

__device__ __forceinline__ float jacobi_rule(float centre, float tap, int g) {
  const int n = (2 * g + 1) * (2 * g + 1) * (2 * g + 1) - 1;
  return __fdiv_rn(__fadd_rn(centre, tap), static_cast<float>(n + 1));
}

// Wave leapfrog: lap = tap_u - n*u with n*u subtracted as power-of-two
// multiples in descending order; v' = v + 2^-5 * lap; u' = u + v'.
__device__ __forceinline__ void wave_rule(float u, float v, float tap_u, int g,
                                          float* u2, float* v2) {
  const int n = (2 * g + 1) * (2 * g + 1) * (2 * g + 1) - 1;
  float lap = tap_u;
  int rem = n;
  for (int bit = 1 << (31 - __clz(n)); bit; bit >>= 1) {
    if (rem >= bit) {
      lap = __fsub_rn(lap, __fmul_rn(static_cast<float>(bit), u));
      rem -= bit;
    }
  }
  const float vn = __fadd_rn(v, __fmul_rn(0.03125f, lap));
  *v2 = vn;
  *u2 = __fadd_rn(u, vn);
}

// apply_window_bc (kernels/rules.py) on a C-channel window of edge E in
// shared memory: per clamped axis, k then i then j, the outer `depth`
// layers of each flagged face take the dirichlet value or the adjacent
// in-domain plane (depth, E-1-depth). Low and high regions and the planes
// they copy from are disjoint, so one pass per axis suffices; the barrier
// between axes lets the next axis read corners the earlier one wrote.
__device__ void refresh_ghosts(float* buf, int C, int E, int depth,
                               const Bc& bc, const int* flags) {
  const int E3 = E * E * E;
  const int stride[3] = {E * E, E, 1};
  for (int ax = 0; ax < 3; ++ax) {
    if (bc.kind[ax] == BC_PERIODIC) continue;
    const bool lo = flags[2 * ax] != 0, hi = flags[2 * ax + 1] != 0;
    if (!lo && !hi) continue;  // uniform across the thread block
    const bool dir = bc.kind[ax] == BC_DIRICHLET;
    const float val = bc.value[ax];
    for (int idx = threadIdx.x; idx < C * E3; idx += blockDim.x) {
      const int r = idx % E3;
      const int coord = (r / stride[ax]) % E;
      int src;
      if (lo && coord < depth) {
        src = idx + (depth - coord) * stride[ax];
      } else if (hi && coord >= E - depth) {
        src = idx - (coord - (E - 1 - depth)) * stride[ax];
      } else {
        continue;
      }
      buf[idx] = dir ? val : buf[src];
    }
    __syncthreads();
  }
}

// One thread block per output block b (grid = nb). Dynamic shared memory
// holds two C*(T+2Sg)^3 f32 windows that the substeps ping-pong between.
// In is the store's element type, Out the output's (In for the fused step,
// float for the resident sum).
template <typename In, typename Out, int RULE, int G>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const In* __restrict__ store, Out* __restrict__ out,
             const float* __restrict__ weights, const int* __restrict__ nbr,
             const int* __restrict__ bnd, int nb, int nb_src, int out_nb,
             int T, int g_rt, int S, Bc bc) {
  constexpr int C = channels_of(RULE);
  extern __shared__ float smem[];
  __shared__ int s_nbr[27];
  __shared__ int s_flags[6];

  const int b = blockIdx.x;
  Weights<G> wt;
  wt.load(weights, g_rt);
  const int g = wt.radius();
  const int h = S * g;
  const int E0 = T + 2 * h;
  const int T3 = T * T * T;

  if (threadIdx.x < 27) {
    const int blk = nbr[static_cast<int64_t>(b) * 27 + threadIdx.x];
    if (blk < 0 || blk >= nb_src) __trap();  // a table that does not fit the store
    s_nbr[threadIdx.x] = blk;
  } else if (threadIdx.x < 33) {
    s_flags[threadIdx.x - 27] =
        bnd ? bnd[static_cast<int64_t>(b) * 6 + threadIdx.x - 27] : 0;
  }
  __syncthreads();

  // Window assembly: the piece at offset (a, b, c) of OFFSETS_FULL reads,
  // per axis, the neighbour's last h planes (low), its full T (centre) or
  // its first h (high) — the spans of ref.assemble_halo_ref.
  float* cur = smem;
  float* nxt = smem + C * E0 * E0 * E0;
  {
    const int E3 = E0 * E0 * E0;
    for (int idx = threadIdx.x; idx < C * E3; idx += blockDim.x) {
      const int c = idx / E3;
      const int r = idx - c * E3;
      const int z = r / (E0 * E0), y = (r / E0) % E0, x = r % E0;
      const int pa = z < h ? 0 : (z < h + T ? 1 : 2);
      const int pb = y < h ? 0 : (y < h + T ? 1 : 2);
      const int pc = x < h ? 0 : (x < h + T ? 1 : 2);
      const int sz = z - h + (pa == 0 ? T : (pa == 2 ? -T : 0));
      const int sy = y - h + (pb == 0 ? T : (pb == 2 ? -T : 0));
      const int sx = x - h + (pc == 0 ? T : (pc == 2 ? -T : 0));
      const int blk = s_nbr[pa * 9 + pb * 3 + pc];
      cur[idx] = widen(store[(static_cast<int64_t>(c) * nb_src + blk) * T3 +
                             (sz * T + sy) * T + sx]);
    }
  }
  __syncthreads();

  const bool clamped = bc.kind[0] != BC_PERIODIC || bc.kind[1] != BC_PERIODIC ||
                       bc.kind[2] != BC_PERIODIC;
  for (int u = 0; u < S; ++u) {
    const int E = T + 2 * g * (S - u);   // window edge before this substep
    const int oe = E - 2 * g;            // and after it
    if (clamped) refresh_ghosts(cur, C, E, g * (S - u), bc, s_flags);
    const int E3 = E * E * E, O3 = oe * oe * oe;
    for (int idx = threadIdx.x; idx < O3; idx += blockDim.x) {
      const int z = idx / (oe * oe), y = (idx / oe) % oe, x = idx % oe;
      const int at = (z * E + y) * E + x;                // window corner of the taps
      const int mid = at + (g * E + g) * E + g;          // the site itself
      if (RULE == RULE_WAVE) {
        // The rule reads u's tap sum only; v's would be discarded, so it
        // is not computed (the plain version computes and drops it).
        const float tu = wt.tap(cur + at, E);
        float u2, v2;
        wave_rule(cur[mid], cur[E3 + mid], tu, g, &u2, &v2);
        nxt[idx] = u2;
        nxt[O3 + idx] = v2;
      } else {
        const float tap = wt.tap(cur + at, E);
        float v;
        if (RULE == RULE_GOL) v = gol_rule(cur[mid], tap, g);
        else if (RULE == RULE_JACOBI) v = jacobi_rule(cur[mid], tap, g);
        else v = tap;
        nxt[idx] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  for (int idx = threadIdx.x; idx < C * T3; idx += blockDim.x) {
    const int c = idx / T3;
    put(out + (static_cast<int64_t>(c) * out_nb + b) * T3 + (idx - c * T3), cur[idx]);
  }
}

// One thread block per halo-extended block: stage its (T+2g)^3 window in
// shared memory, then tap-sum the T^3 interior.
template <typename In, int G>
__global__ void __launch_bounds__(THREADS)
halo_sum_kernel(const In* __restrict__ blocks, float* __restrict__ out,
                const float* __restrict__ weights, int T, int g_rt) {
  extern __shared__ float win[];
  Weights<G> wt;
  wt.load(weights, g_rt);
  const int W = T + 2 * wt.radius();
  const int W3 = W * W * W, T3 = T * T * T;
  const int64_t b = blockIdx.x;
  for (int idx = threadIdx.x; idx < W3; idx += blockDim.x)
    win[idx] = widen(blocks[b * W3 + idx]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < T3; idx += blockDim.x) {
    const int z = idx / (T * T), y = (idx / T) % T, x = idx % T;
    out[b * T3 + idx] = wt.tap(win + (z * W + y) * W + x, W);
  }
}

template <typename In, typename Out, int RULE, int G>
cudaError_t launch_fused(const void* store, void* out, const float* w,
                         const int* nbr, const int* bnd, int nb, int nb_src,
                         int out_nb, int T, int g, int S, Bc bc,
                         cudaStream_t stream) {
  const int E0 = T + 2 * S * g;
  const size_t smem = sizeof(float) * 2 * channels_of(RULE) *
                      static_cast<size_t>(E0) * E0 * E0;
  auto kern = fused_kernel<In, Out, RULE, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<nb, THREADS, smem, stream>>>(static_cast<const In*>(store),
                                      static_cast<Out*>(out), w, nbr, bnd, nb,
                                      nb_src, out_nb, T, g, S, bc);
  return cudaGetLastError();
}

template <typename In, typename Out, int RULE>
cudaError_t dispatch_g(const void* store, void* out, const float* w,
                       const int* nbr, const int* bnd, int nb, int nb_src,
                       int out_nb, int T, int g, int S, Bc bc,
                       cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch_fused<In, Out, RULE, 1>(store, out, w, nbr, bnd, nb, nb_src,
                                            out_nb, T, g, S, bc, stream);
    case 2:
      return launch_fused<In, Out, RULE, 2>(store, out, w, nbr, bnd, nb, nb_src,
                                            out_nb, T, g, S, bc, stream);
    default:
      return launch_fused<In, Out, RULE, 0>(store, out, w, nbr, bnd, nb, nb_src,
                                            out_nb, T, g, S, bc, stream);
  }
}

template <typename E>
cudaError_t dispatch_rule(int rule, const void* store, void* out,
                          const float* w, const int* nbr, const int* bnd,
                          int nb, int nb_src, int out_nb, int T, int g, int S,
                          Bc bc, cudaStream_t st) {
  switch (rule) {
    case RULE_GOL:
      return dispatch_g<E, E, RULE_GOL>(store, out, w, nbr, bnd, nb, nb_src,
                                        out_nb, T, g, S, bc, st);
    case RULE_JACOBI:
      return dispatch_g<E, E, RULE_JACOBI>(store, out, w, nbr, bnd, nb, nb_src,
                                           out_nb, T, g, S, bc, st);
    case RULE_IDENTITY:
      return dispatch_g<E, E, RULE_IDENTITY>(store, out, w, nbr, bnd, nb,
                                             nb_src, out_nb, T, g, S, bc, st);
    case RULE_WAVE:
      return dispatch_g<E, E, RULE_WAVE>(store, out, w, nbr, bnd, nb, nb_src,
                                         out_nb, T, g, S, bc, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename In, int G>
cudaError_t launch_halo_sum(const void* blocks, float* out, const float* w,
                            int nb, int T, int g, cudaStream_t stream) {
  const int W = T + 2 * g;
  const size_t smem = sizeof(float) * static_cast<size_t>(W) * W * W;
  auto kern = halo_sum_kernel<In, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<nb, THREADS, smem, stream>>>(static_cast<const In*>(blocks), out, w, T, g);
  return cudaGetLastError();
}

template <typename In>
cudaError_t dispatch_halo_sum(const void* blocks, float* out, const float* w,
                              int nb, int T, int g, cudaStream_t st) {
  switch (g) {
    case 1: return launch_halo_sum<In, 1>(blocks, out, w, nb, T, g, st);
    case 2: return launch_halo_sum<In, 2>(blocks, out, w, nb, T, g, st);
    default: return launch_halo_sum<In, 0>(blocks, out, w, nb, T, g, st);
  }
}

}  // namespace

extern "C" {

// S fused timesteps: store (C, nb_src, T,T,T) -> out (C, nb, T,T,T) in the
// store's dtype (0: f32, 1: bf16, 2: f16, 3: fp8 e4m3fn, 4: fp8 e5m2;
// C = 2 for wave, else 1), whose channels lie out_nb >= nb blocks apart
// (out_nb > nb: the core of a larger, extended store); nbr int32 (nb, 27);
// bnd int32 (nb, 6) or null when every axis is periodic; bc_* per axis k,
// i, j.
int repro_stencil_step_fused(const void* store, void* out, const void* w,
                             const void* nbr, const void* bnd, int nb,
                             int nb_src, int out_nb, int T, int g, int S,
                             int rule, int bc_k, int bc_i, int bc_j,
                             float val_k, float val_i, float val_j, int dtype,
                             void* stream) {
  const Bc bc = {{bc_k, bc_i, bc_j}, {val_k, val_i, val_j}};
  auto st = static_cast<cudaStream_t>(stream);
  auto wp = static_cast<const float*>(w);
  auto nt = static_cast<const int*>(nbr);
  auto bt = static_cast<const int*>(bnd);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_rule<float>(rule, store, out, wp, nt, bt, nb, nb_src,
                                  out_nb, T, g, S, bc, st);
    case DTYPE_BF16:
      return dispatch_rule<__nv_bfloat16>(rule, store, out, wp, nt, bt, nb,
                                          nb_src, out_nb, T, g, S, bc, st);
    case DTYPE_F16:
      return dispatch_rule<__half>(rule, store, out, wp, nt, bt, nb, nb_src,
                                   out_nb, T, g, S, bc, st);
    case DTYPE_E4M3:
      return dispatch_rule<__nv_fp8_e4m3>(rule, store, out, wp, nt, bt, nb,
                                          nb_src, out_nb, T, g, S, bc, st);
    case DTYPE_E5M2:
      return dispatch_rule<__nv_fp8_e5m2>(rule, store, out, wp, nt, bt, nb,
                                          nb_src, out_nb, T, g, S, bc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 tap sum over the periodic store: the S = 1 identity case of the
// fused kernel. store (nb, T,T,T) of dtype (as above), nbr (nb, 27) ->
// out f32 (nb, T,T,T).
int repro_stencil_sum_resident(const void* store, void* out, const void* w,
                               const void* nbr, int nb, int T, int g,
                               int dtype, void* stream) {
  const Bc bc = {{BC_PERIODIC, BC_PERIODIC, BC_PERIODIC}, {0.f, 0.f, 0.f}};
  auto st = static_cast<cudaStream_t>(stream);
  auto wp = static_cast<const float*>(w);
  auto nt = static_cast<const int*>(nbr);
  switch (dtype) {
    case DTYPE_F32:
      return dispatch_g<float, float, RULE_IDENTITY>(store, out, wp, nt, nullptr,
                                                     nb, nb, nb, T, g, 1, bc, st);
    case DTYPE_BF16:
      return dispatch_g<__nv_bfloat16, float, RULE_IDENTITY>(
          store, out, wp, nt, nullptr, nb, nb, nb, T, g, 1, bc, st);
    case DTYPE_F16:
      return dispatch_g<__half, float, RULE_IDENTITY>(store, out, wp, nt, nullptr,
                                                      nb, nb, nb, T, g, 1, bc, st);
    case DTYPE_E4M3:
      return dispatch_g<__nv_fp8_e4m3, float, RULE_IDENTITY>(
          store, out, wp, nt, nullptr, nb, nb, nb, T, g, 1, bc, st);
    case DTYPE_E5M2:
      return dispatch_g<__nv_fp8_e5m2, float, RULE_IDENTITY>(
          store, out, wp, nt, nullptr, nb, nb, nb, T, g, 1, bc, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Repack form: blocks (nb, T+2g, T+2g, T+2g) of dtype (as above) -> out
// f32 (nb, T,T,T).
int repro_stencil_sum_blocks(const void* blocks, void* out, const void* w,
                             int nb, int T, int g, int dtype, void* stream) {
  auto o = static_cast<float*>(out);
  auto wp = static_cast<const float*>(w);
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DTYPE_F32: return dispatch_halo_sum<float>(blocks, o, wp, nb, T, g, st);
    case DTYPE_BF16: return dispatch_halo_sum<__nv_bfloat16>(blocks, o, wp, nb, T, g, st);
    case DTYPE_F16: return dispatch_halo_sum<__half>(blocks, o, wp, nb, T, g, st);
    case DTYPE_E4M3: return dispatch_halo_sum<__nv_fp8_e4m3>(blocks, o, wp, nb, T, g, st);
    case DTYPE_E5M2: return dispatch_halo_sum<__nv_fp8_e5m2>(blocks, o, wp, nb, T, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
