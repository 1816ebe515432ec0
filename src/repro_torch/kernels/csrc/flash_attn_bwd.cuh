// Flash attention backward on the CUDA cores: the simple design, included
// with the forward's (flash_attn.cuh) by one source per element type
// (flash_attn_{f32,bf16,f16,e4m3,e5m2}.cu), so that each library holds both
// directions of its type.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward. Its
// custom_vjp (_fa_bwd, src/repro/kernels/ops.py:215) recomputes the dense
// oracle attention_ref under jax.vjp; this computes the same gradient from
// what the forward saved. It takes every case the forward takes that the
// Hopper backward (flash_attn_bwd_sm90.cu) does not: f32, f16, bf16 at any
// other head dim or blocks, float8_e4m3fn and float8_e5m2, any head dim.
//
// The function, as kernels/ref.py's flash_attention_bwd_ref states it: q,
// k, v, the forward's output o and the output's cotangent dO widened
// exactly to f32; s = q.k scaled by 1/sqrt(D); P = exp(s - lse) from the
// forward's per-row log-sum-exp (a key past the causal diagonal, aligned
// to the end, gets P = 0, and so does every key of a row with no key,
// whose lse is +inf); Δ = rowsum(dO∘O); dP = dO.v; dS = P∘(dP - Δ);
// dV = Pᵀ dO, dK = dSᵀ Q / sqrt(D), dQ = dS K / sqrt(D), each accumulated
// in f32 and rounded once to the element type (fp8 as XLA rounds:
// fp8_round.cuh). Products and sums are explicit fmaf.
//
// Design (the simple first kernels), three launches in one call:
//   1. delta: one thread per q row, Δ = Σ dO∘O in column order, into an f32
//      scratch of (bh, sq);
//   2. dK/dV: one thread block per (head, 16 keys), 16 x 16 threads, one
//      (q row, key) pair a thread. It walks the tiles of 16 q rows that see
//      its keys, from the diagonal on (every tile without a causal mask).
//      For each: the thread's s and dP as dot products over the head dim,
//      staged BS = 128 columns at a time as f32 in shared memory (q, dO, k,
//      v: 16 rows each; k and v stay staged across tiles where the head dim
//      fits one slice); then P and dS into shared memory; then dV += Pᵀ dO
//      and dK += dSᵀ Q over the slices, one (key, column) a thread, its 16
//      terms in q-row order. The accumulators of the 16 keys live in shared
//      memory (2 x 16 x D f32, 128 KiB at D = 1024) up to a head dim of
//      ACC_MAX_D, and above it in an f32 workspace from the wrapper, one
//      float per gradient element;
//   3. dQ: one thread block per (head, 16 q rows), the same tiles walked
//      over the keys its rows see, dQ += dS K.
// No atomics: every gradient element is summed by one thread in a fixed
// order, so a run repeats bit for bit. S and dP are computed twice (once
// per kernel) for that.
//
// What bounds it on an H100: the function needs 5 products of 2 * D
// operations for each visible (q row, key) pair (10 * D * BH * Sq(Sk+1)/2
// with the causal mask at Sq = Sk): at the f32 training check's shape
// (BH = 15, S = 2048, D = 64) 2.0e10, 0.30 ms at 67 TFLOP/s in f32, against
// 63 MB of traffic (0.019 ms): operations. These kernels run them as f32
// FMAs from shared memory, one load beside each FMA in the dK/dV and dQ
// updates, so they stay far from that bound; the tensor cores are the
// Hopper design's work.

#pragma once

#include "flash_attn.cuh"

namespace {

constexpr int BT = 16;           // q rows and keys of a tile
constexpr int BT2 = BT * BT;     // threads of a thread block
constexpr int BS = 128;          // head-dim columns staged at a time
constexpr int BSP = BS + 1;      // a staged row's pitch: 16 rows' reads of
                                 // one column fall on 16 banks
constexpr int ACC_MAX_D = 1024;  // widest head dim with accumulators in
                                 // shared memory

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* orow = o + r * d;
  const T* grow = dout + r * d;
  float acc = 0.f;
  for (int c = 0; c < d; ++c) acc = fmaf(widen(grow[c]), widen(orow[c]), acc);
  delta[r] = acc;
}

// The shared memory of one tile: q, dO, k and v slices (BT rows of BS
// columns, widened to f32), P and dS of the tile, and its rows' lse and Δ.
struct BwdTile {
  float q[BT * BSP];
  float dout[BT * BSP];
  float k[BT * BSP];
  float v[BT * BSP];
  float p[BT][BT + 1];
  float ds[BT][BT + 1];
  float lse[BT];
  float delta[BT];
};

// Stage columns c0 .. c0 + w - 1 of `n` rows from `src` (row stride d)
// into `dst` (BT rows of pitch BSP); rows past n are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int n, int d, int c0, int w) {
  for (int e = threadIdx.x; e < BT * w; e += BT2) {
    const int r = e / w, c = e - r * w;
    dst[r * BSP + c] = r < n ? widen(src[static_cast<int64_t>(r) * d + c0 + c]) : 0.f;
  }
}

// P and dS of the tile of nr q rows from row q0 and nk keys from key k0
// into t.p and t.ds: the thread's (q row tid / BT, key tid % BT) pair.
// q, dO, k and v are the tile's first rows; q and dO (when stage_q) and k
// and v (when stage_kv) are staged slice by slice, and those not staged
// are taken as staged already (a head dim of one slice); the last slice
// stays staged. lse and Δ of the rows are loaded with the first slice.
template <typename T>
__device__ __forceinline__ void tile_p_ds(
    BwdTile& t, const T* __restrict__ q, const T* __restrict__ dout,
    const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ delta, int nr,
    int nk, int q0, int k0, int offs, int d, int causal, float scale,
    bool stage_q, bool stage_kv) {
  const int tr = threadIdx.x / BT, tj = threadIdx.x % BT;
  float s = 0.f, dp = 0.f;
  for (int c0 = 0; c0 < d; c0 += BS) {
    const int w = min(BS, d - c0);
    __syncthreads();  // the previous slice, P and dS are read
    if (stage_q) {
      stage(t.q, q, nr, d, c0, w);
      stage(t.dout, dout, nr, d, c0, w);
    }
    if (stage_kv) {
      stage(t.k, k, nk, d, c0, w);
      stage(t.v, v, nk, d, c0, w);
    }
    if (c0 == 0 && threadIdx.x < BT) {
      t.lse[threadIdx.x] = threadIdx.x < nr ? lse[threadIdx.x] : INFINITY;
      t.delta[threadIdx.x] = threadIdx.x < nr ? delta[threadIdx.x] : 0.f;
    }
    __syncthreads();
    const float* qr = t.q + tr * BSP;
    const float* gr = t.dout + tr * BSP;
    const float* kr = t.k + tj * BSP;
    const float* vr = t.v + tj * BSP;
    for (int c = 0; c < w; ++c) {
      s = fmaf(qr[c], kr[c], s);
      dp = fmaf(gr[c], vr[c], dp);
    }
  }
  const bool visible = tr < nr && tj < nk && (!causal || k0 + tj <= q0 + tr + offs);
  const float p = visible ? expf(fmaf(s, scale, -t.lse[tr])) : 0.f;
  t.p[tr][tj] = p;
  t.ds[tr][tj] = p * (dp - t.delta[tr]);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(BT2)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ ws_k,
                      float* __restrict__ ws_v, int bh0, int sq, int sk, int d,
                      int causal, float scale) {
  __shared__ BwdTile t;
  extern __shared__ float4 acc4[];
  const int64_t bh = static_cast<int64_t>(bh0) + blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const int nk = min(BT, sk - k0);
  const int offs = sk - sq;
  const int64_t kbase = (bh * sk + k0) * d;
  // the accumulators of the nk keys, (nk, d) each, row-major
  float* acc_k = d <= ACC_MAX_D ? reinterpret_cast<float*>(acc4) : ws_k + kbase;
  float* acc_v = d <= ACC_MAX_D ? acc_k + BT * d : ws_v + kbase;
  for (int e = threadIdx.x; e < nk * d; e += BT2) {
    acc_k[e] = 0.f;
    acc_v[e] = 0.f;
  }
  // the first q row that sees key k0: row k0 - offs on the diagonal
  const int first = causal ? max(0, k0 - offs) / BT * BT : 0;
  const bool one_slice = d <= BS;
  for (int q0 = first; q0 < sq; q0 += BT) {
    const int nr = min(BT, sq - q0);
    const int64_t qbase = (bh * sq + q0) * d;
    tile_p_ds(t, q + qbase, dout + qbase, k + kbase, v + kbase, lse + bh * sq + q0,
              delta + bh * sq + q0, nr, nk, q0, k0, offs, d, causal, scale, true,
              !one_slice || q0 == first);
    // dV += Pᵀ dO and dK += dSᵀ Q, slice by slice
    for (int c0 = 0; c0 < d; c0 += BS) {
      const int w = min(BS, d - c0);
      if (!one_slice) {
        __syncthreads();  // every thread is done with the last slice
        stage(t.q, q + qbase, nr, d, c0, w);
        stage(t.dout, dout + qbase, nr, d, c0, w);
        __syncthreads();
      }
      for (int e = threadIdx.x; e < nk * w; e += BT2) {
        const int j = e / w, c = e - j * w;
        float* ak = acc_k + j * d + c0 + c;
        float* av = acc_v + j * d + c0 + c;
        float xk = *ak, xv = *av;
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          xv = fmaf(t.p[r][j], t.dout[r * BSP + c], xv);
          xk = fmaf(t.ds[r][j], t.q[r * BSP + c], xk);
        }
        *ak = xk;
        *av = xv;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nk * d; e += BT2) {
    store(dk + kbase + e, acc_k[e] * scale);
    store(dv + kbase + e, acc_v[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(BT2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, float* __restrict__ ws_q, int bh0, int sq,
                    int sk, int d, int causal, float scale) {
  __shared__ BwdTile t;
  extern __shared__ float4 acc4[];
  const int64_t bh = static_cast<int64_t>(bh0) + blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const int nr = min(BT, sq - q0);
  const int offs = sk - sq;
  const int64_t qbase = (bh * sq + q0) * d;
  float* acc = d <= ACC_MAX_D ? reinterpret_cast<float*>(acc4) : ws_q + qbase;
  for (int e = threadIdx.x; e < nr * d; e += BT2) acc[e] = 0.f;
  // keys up to the one the last row sees
  const int stop = causal ? min(sk, q0 + nr + offs) : sk;
  const bool one_slice = d <= BS;
  for (int k0 = 0; k0 < stop; k0 += BT) {
    const int nk = min(BT, sk - k0);
    const int64_t kbase = (bh * sk + k0) * d;
    tile_p_ds(t, q + qbase, dout + qbase, k + kbase, v + kbase, lse + bh * sq + q0,
              delta + bh * sq + q0, nr, nk, q0, k0, offs, d, causal, scale,
              !one_slice || k0 == 0, true);
    // dQ += dS K, slice by slice
    for (int c0 = 0; c0 < d; c0 += BS) {
      const int w = min(BS, d - c0);
      if (!one_slice) {
        __syncthreads();
        stage(t.k, k + kbase, nk, d, c0, w);
        __syncthreads();
      }
      for (int e = threadIdx.x; e < nr * w; e += BT2) {
        const int r = e / w, c = e - r * w;
        float* a = acc + r * d + c0 + c;
        float x = *a;
#pragma unroll
        for (int j = 0; j < BT; ++j) x = fmaf(t.ds[r][j], t.k[j * BSP + c], x);
        *a = x;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * d; e += BT2) store(dq + qbase + e, acc[e] * scale);
}

// The C entry point's body for one element type: q, o, dout (bh, sq, d),
// k, v (bh, sk, d), contiguous, of type T; lse f32 (bh, sq) from the
// forward; delta an f32 scratch of (bh, sq); dq, dk, dv like q, k, v; d a
// multiple of 8, and above ACC_MAX_D ws an f32 workspace of
// bh * (sq + 2 sk) * d elements, [dq | dk | dv] (else unused). The blocks
// bq and bk do not
// change this design's tiles. The wrapper checks all of this.
template <typename T>
int flash_bwd_entry(const void* q, const void* k, const void* v, const void* o,
                    const void* lse, const void* dout, void* dq, void* dk, void* dv,
                    void* delta, void* ws, int bh, int sq, int sk, int d, int bq,
                    int bk, int causal, float scale, void* stream) {
  if (d < 8 || d % 8 || (d > ACC_MAX_D && ws == nullptr) || bh < 1 || sq < 1 ||
      sk < 1 || bq < 1 || bk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(dout);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int64_t rows = static_cast<int64_t>(bh) * sq;
  // the workspace's parts: dq (bh, sq, d), then dk and dv (bh, sk, d)
  float* ws_q = static_cast<float*>(ws);
  float* ws_k = ws_q == nullptr ? nullptr : ws_q + rows * d;
  float* ws_v = ws_q == nullptr ? nullptr : ws_k + static_cast<int64_t>(bh) * sk * d;
  flash_bwd_delta_kernel<T><<<static_cast<unsigned>((rows + 255) / 256), 256, 0, st>>>(
      static_cast<const T*>(o), tg, dl, rows, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kv_smem = d <= ACC_MAX_D ? 2 * BT * d * 4 : 0;
  const int q_smem = d <= ACC_MAX_D ? BT * d * 4 : 0;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a launch covers at most MAX_GRID_Y folded heads: chunks, each kernel
  // told its first head
  for (int h0 = 0; h0 < bh; h0 += MAX_GRID_Y) {
    const int nh = bh - h0 < MAX_GRID_Y ? bh - h0 : MAX_GRID_Y;
    flash_bwd_dkdv_kernel<T><<<dim3((sk + BT - 1) / BT, nh), BT2, kv_smem, st>>>(
        tq, tk, tv, tg, ls, dl, static_cast<T*>(dk), static_cast<T*>(dv), ws_k, ws_v,
        h0, sq, sk, d, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_kernel<T><<<dim3((sq + BT - 1) / BT, nh), BT2, q_smem, st>>>(
        tq, tk, tv, tg, ls, dl, static_cast<T*>(dq), ws_q, h0, sq, sk, d, causal,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace
