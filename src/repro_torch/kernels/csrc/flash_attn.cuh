// Flash attention forward for Hopper (sm_90a), on a space-filling-curve
// schedule of the (q-block x kv-block) grid: the simple design, included by
// one source per element type (flash_attn_{f32,bf16,f16,e4m3,e5m2}.cu), so
// that nvcc builds the five libraries in parallel (kernels/_build.py) and
// no one source compiles all 35 (element type, DP) instances.
//
// Replaces flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attn.py. On the TPU one sequential grid axis
// walks the (causally filtered) cells in curve order, and the online-
// softmax state of every q block lives in VMEM scratch between visits.
// Here blocks run in parallel, so each thread block owns one (bh, q block)
// and keeps that state in registers for its whole life:
//   - the curve sets which thread blocks run together: blockIdx.x is the
//     position of the q block in the order the curve first visits it
//     (an L2 swizzle: neighbouring thread blocks of one head share K/V);
//   - the curve sets the order of the kv blocks within a thread block: the
//     cells of that q row, in the order the schedule visits them (Hilbert's
//     is not monotone, and the online softmax does not care).
// The wrapper (kernels/flash_attn.py) turns the cell list into that plan,
// [q_order (nq) | row_ptr (nq+1) | cols (ncells)], once per grid shape.
//
// Arithmetic, as the TPU kernel: q, k and v (f32, bf16, f16, fp8 e4m3fn or
// e5m2) widened exactly to f32, scores q.k in f32 scaled by 1/sqrt(D) after
// the product, keys past the causal diagonal (aligned to the end: col <=
// row + Sk - Sq) masked to -inf, running max and sum per row, a row with no
// key gives 0, the output rounded once to q's dtype (fp8 as XLA rounds:
// fp8_round.cuh; the output is a convex combination of v's rows, so it
// cannot overflow). Products and sums are explicit fmaf, so the build's
// -fmad=false costs nothing here. Where the caller asks for it (a non-null
// lse, for the backward: flash_attn_bwd.cuh), each row's log-sum-exp of
// its scaled scores, m + log(l) in f32, is stored beside the output; a row
// with no key stores +inf, the sentinel under which the backward's
// exp(s - lse) is 0. Serving passes null and stores nothing more.
//
// Design (the simple first kernel): one thread per q row (blockDim = the q
// block, 1..128 rows), its q row and f32 accumulator in registers; each
// kv tile of K and V is staged in shared memory as f32 (2 * bk * DP * 4
// bytes, 64 KiB at bk = 128, D = 64), and every thread reads it by
// broadcast, 16 bytes at a time. Keys are scored 16 at a time before one
// online-softmax update. D is padded to DP (16, 32, 64, 128, 256, 512 or
// 1024) with zeros. Any bk in [1, 128] runs (the reference runs every
// block that divides the sequence): where bk is not a multiple of 16, the
// last chunk's keys past the tile read its last row, with their scores
// masked to -inf.
// Head dims above 128 (DP = 256, gemma3-1b's D; DP = 512 and 1024): NS =
// DP/128 threads per q row, each owning 128 columns of the head dim, so
// each keeps 128 + 128 floats as the DP = 128 instance does. A thread
// block has at most 256 threads above DP = 256 (max_rows), so that each
// may keep 255 registers (a 128-row block of 1024 threads would cap them
// at 64 and spill those floats): a q block of more rows (64 at DP = 512,
// 32 at 1024) runs as several thread blocks, each staging the same K/V
// tiles. The partial dot products meet in log2(NS) __shfl_xor_sync steps
// of a butterfly, after which every lane of the row holds the same score
// (each step adds the same two values in either order, and a + b == b + a
// in IEEE arithmetic). f32 K and V tiles of 128
// keys at DP = 256 would take 256 KiB, over the 227 KiB a thread block may
// use: the tile is staged 64 keys at a time at DP = 256, 32 at 512 and 16
// at 1024 (128 KiB of tiles at most), whatever bk is. Each part of a tile
// row starts 16 bytes after the one before it, so that the parts' 16-byte
// reads of one key fall on different banks.
//
// Head dims above 1024 (the wide instance, flash_fwd_wide_kernel): a q row
// no longer fits in registers, so a thread block of 16 x 16 threads takes
// 16 q rows and scores 16 keys at a time, one (row, key) pair a thread,
// walking the head dim in slices of 256 columns staged in shared memory
// (q and k for the scores, then v for the products). Each row's f32
// accumulator lives in a workspace in global memory (one f32 per output
// element, from the wrapper) and is updated slice by slice, acc = acc *
// alpha + P V, in the order of the narrow instances: the online-softmax
// update per 16 keys, each product an fmaf in key order. Any head dim
// runs.
//
// Any number of folded heads runs: a launch covers at most 65535 of them
// (gridDim.y's limit), so the heads are launched in chunks, each kernel
// told its first head (bh0).
//
// What bounds it on an H100: at the prefill's shape (BH = 60, S = 2048,
// D = 64, causal, bf16) the function needs 4 * D * BH * S(S+1)/2 = 3.2e10
// operations (0.033 ms at 989 TFLOP/s in bf16) against 42 MB of traffic
// (0.013 ms at 3.35 TB/s): operations. This kernel runs them as f32 FMAs
// on the CUDA cores (67 TFLOP/s at most) with one shared-memory load per
// four FMAs, so it cannot come within 15x of that bound; wgmma on the
// tensor cores, TMA and warp specialisation are the redesign's work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fp8_round.cuh"

namespace {

constexpr int KC = 16;           // keys scored per online-softmax update
constexpr int MAX_ROWS = 128;    // largest q block
constexpr int MAX_DP = 1024;     // widest head dim kept in registers
constexpr int MAX_GRID_Y = 65535;  // folded heads a launch covers

// Threads per q row, and keys staged in shared memory at a time, at DP.
__host__ __device__ constexpr int threads_per_row(int dp) { return dp > 128 ? dp / 128 : 1; }
__host__ __device__ constexpr int staged_keys(int dp) { return dp > 128 ? 16384 / dp : 128; }
// Floats a tile row takes in shared memory: with NS threads a row, each
// part of the row starts 16 bytes after the one before it.
__host__ __device__ constexpr int row_pitch(int dp) {
  return dp + 4 * (threads_per_row(dp) - 1);
}
// q rows one thread block takes: a whole q block up to DP = 256; above, at
// most 256 threads (64 rows at DP = 512, 32 at 1024), so that each thread
// may keep up to 255 registers for its 128 + 128 floats, and a q block of
// more rows runs as several thread blocks.
__host__ __device__ constexpr int max_rows(int dp) {
  return dp <= 256 ? MAX_ROWS : 256 / threads_per_row(dp);
}

__device__ __forceinline__ void load8(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// eight fp8 values (8 bytes), each widened exactly through f16
template <__nv_fp8_interpretation_t KIND>
__device__ __forceinline__ void load8_fp8(const void* p, float* dst) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8_storage_t* b = reinterpret_cast<const __nv_fp8_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = __half2float(__half(__nv_cvt_fp8_to_halfraw(b[i], KIND)));
}
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* dst) {
  load8_fp8<__NV_E4M3>(p, dst);
}
__device__ __forceinline__ void load8(const __nv_fp8_e5m2* p, float* dst) {
  load8_fp8<__NV_E5M2>(p, dst);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }
__device__ __forceinline__ void store(__nv_fp8_e4m3* p, float x) {
  *reinterpret_cast<__nv_fp8_storage_t*>(p) = fp8_e4m3_as_xla(x);
}
__device__ __forceinline__ void store(__nv_fp8_e5m2* p, float x) {
  *reinterpret_cast<__nv_fp8_storage_t*>(p) = fp8_e5m2_as_xla(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(max_rows(DP) * threads_per_row(DP))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ plan, int bh0,
                 int sq, int sk, int d, int bq, int bk, int causal, float scale) {
  constexpr int NS = threads_per_row(DP);  // threads per q row
  constexpr int DH = DP / NS;              // head-dim columns per thread
  constexpr int RP = row_pitch(DP);        // a tile row in shared memory
  const int kt = min(bk, staged_keys(DP)); // keys in shared memory at a time
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (kt, RP)
  float* vs = ks + kt * RP;                     // (kt, RP)
  const int nq = sq / bq;
  const int* q_order = plan;
  const int* row_ptr = plan + nq;
  const int* cols = plan + 2 * nq + 1;

  // the q block of this thread block, and its rows: q block q_order[i] is
  // run by `parts` consecutive thread blocks of max_rows(DP) rows each
  const int parts = (bq + max_rows(DP) - 1) / max_rows(DP);
  const int iq = q_order[blockIdx.x / parts];
  const int r = (blockIdx.x % parts) * max_rows(DP) + threadIdx.x / NS;
  const bool live = r < bq;  // the last part's rows past the q block idle
  const int c0 = (threadIdx.x % NS) * DH;  // this thread's first column
  const int t0 = (threadIdx.x % NS) * (DH + 4);  // and where it lies in a row
  // the NS lanes of a q row, for the dot products' exchange
  const unsigned lanes = ((1u << NS) - 1) << ((threadIdx.x & 31) & ~(NS - 1));
  const int row = iq * bq + r;
  const int offs = sk - sq;
  const int64_t bh = static_cast<int64_t>(bh0) + blockIdx.y;
  const int64_t qbase = (bh * sq + row) * d;
  const int64_t kvbase = bh * sk * d;

  float qr[DH], acc[DH];
#pragma unroll
  for (int c = 0; c < DH; c += 8) {
    if (live && c0 + c < d) {
      load8(q + qbase + c0 + c, qr + c);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) qr[c + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c + i] = 0.f;
  }
  // the padded columns [d, DP) of the tiles stay zero
  for (int e = threadIdx.x; e < kt * (DP - d); e += blockDim.x) {
    const int j = e / (DP - d), c = d + e % (DP - d);
    const int at = j * RP + c + (c / DH) * 4;
    ks[at] = 0.f;
    vs[at] = 0.f;
  }

  float m = -INFINITY, l = 0.f;
  const int vec_per_row = d / 8;
  const int stop = row_ptr[iq + 1];
  for (int t = row_ptr[iq]; t < stop; ++t) {
    const int ik = cols[t];
    // the tile's keys jb .. jb+n-1, kt at a time (one pass where kt = bk)
    for (int jb = 0; jb < bk; jb += kt) {
      const int n = min(kt, bk - jb);
      __syncthreads();  // every row is done with the previous keys
      for (int e = threadIdx.x; e < n * vec_per_row; e += blockDim.x) {
        const int j = e / vec_per_row, c = (e - j * vec_per_row) * 8;
        const int64_t g = kvbase + static_cast<int64_t>(ik * bk + jb + j) * d + c;
        const int at = j * RP + c + (c / DH) * 4;
        float tmp[8];
        load8(k + g, tmp);
        reinterpret_cast<float4*>(ks + at)[0] = make_float4(tmp[0], tmp[1], tmp[2], tmp[3]);
        reinterpret_cast<float4*>(ks + at)[1] = make_float4(tmp[4], tmp[5], tmp[6], tmp[7]);
        load8(v + g, tmp);
        reinterpret_cast<float4*>(vs + at)[0] = make_float4(tmp[0], tmp[1], tmp[2], tmp[3]);
        reinterpret_cast<float4*>(vs + at)[1] = make_float4(tmp[4], tmp[5], tmp[6], tmp[7]);
      }
      __syncthreads();
      // keys j <= lim of these n are visible to this row
      const int lim = !live ? -1
                      : causal ? min(n - 1, row + offs - ik * bk - jb) : n - 1;
      for (int j0 = 0; j0 <= lim; j0 += KC) {
        float s[KC];
        float mc = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          const float* kr = ks + min(j0 + jj, n - 1) * RP + t0;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < DH; c += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(kr + c);
            dot = fmaf(qr[c], kk.x, dot);
            dot = fmaf(qr[c + 1], kk.y, dot);
            dot = fmaf(qr[c + 2], kk.z, dot);
            dot = fmaf(qr[c + 3], kk.w, dot);
          }
#pragma unroll
          for (int o = 1; o < NS; o <<= 1) dot += __shfl_xor_sync(lanes, dot, o);
          s[jj] = (j0 + jj <= lim) ? dot * scale : -INFINITY;
          mc = fmaxf(mc, s[jj]);
        }
        // s[0] is visible, so m_new is finite; alpha = 0 on the first update
        const float m_new = fmaxf(m, mc);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int c = 0; c < DH; ++c) acc[c] *= alpha;
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float* vr = vs + min(j0 + jj, n - 1) * RP + t0;
#pragma unroll
          for (int c = 0; c < DH; c += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + c);
            acc[c] = fmaf(p, vv.x, acc[c]);
            acc[c + 1] = fmaf(p, vv.y, acc[c + 1]);
            acc[c + 2] = fmaf(p, vv.z, acc[c + 2]);
            acc[c + 3] = fmaf(p, vv.w, acc[c + 3]);
          }
        }
        m = m_new;
      }
    }
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
  for (int c = 0; c < DH; ++c) {
    if (live && c0 + c < d) store(o + qbase + c0 + c, acc[c] * inv);
  }
  if (lse != nullptr && live && c0 == 0)
    lse[bh * sq + row] = l > 0.f ? m + logf(l) : INFINITY;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* plan, int bh, int sq, int sk, int d,
                   int bq, int bk, int causal, float scale, cudaStream_t stream) {
  const int kt = bk < staged_keys(DP) ? bk : staged_keys(DP);
  const size_t smem = 2 * static_cast<size_t>(kt) * row_pitch(DP) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = bq < max_rows(DP) ? bq : max_rows(DP);
  const int parts = (bq + rows - 1) / rows;
  for (int h0 = 0; h0 < bh; h0 += MAX_GRID_Y) {
    const int nh = bh - h0 < MAX_GRID_Y ? bh - h0 : MAX_GRID_Y;
    kern<<<dim3(sq / bq * parts, nh), rows * threads_per_row(DP), smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, plan, h0, sq, sk, d,
        bq, bk, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- head dims above MAX_DP: the wide instance
constexpr int WR = 16;       // q rows per thread block
constexpr int WK = KC;       // keys per online-softmax update
constexpr int WS = 256;      // head-dim columns staged at a time
constexpr int WP = WS + 1;   // a staged row's pitch: the 16 keys' reads of
                             // one column fall on 16 banks
static_assert(WR == WK, "q rows and keys are staged by one loop");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
__device__ __forceinline__ float widen(__nv_fp8_e5m2 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E5M2)));
}

template <typename T>
__global__ void __launch_bounds__(WR * WK)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, float* __restrict__ ws,
                      const int* __restrict__ plan,
                      int bh0, int sq, int sk, int d, int bq, int bk,
                      int causal, float scale) {
  __shared__ float qs[WR * WP];   // a slice of the q rows
  __shared__ float kv[WK * WP];   // a slice of the keys, then of the values
  __shared__ float sp[WR][WK];    // scores, then probabilities
  __shared__ float scale_r[WR];   // each row's alpha, at the end 1 / l
  const int nq = sq / bq;
  const int* q_order = plan;
  const int* row_ptr = plan + nq;
  const int* cols = plan + 2 * nq + 1;
  // q block q_order[i] is run by `parts` thread blocks of WR rows each
  const int parts = (bq + WR - 1) / WR;
  const int iq = q_order[blockIdx.x / parts];
  const int r0 = iq * bq + (blockIdx.x % parts) * WR;  // first q row
  const int nr = min(WR, iq * bq + bq - r0);           // rows of this part
  const int tid = threadIdx.x, tr = tid / WK, tj = tid % WK;
  const int offs = sk - sq;
  const int64_t bh = static_cast<int64_t>(bh0) + blockIdx.y;
  const int64_t qbase = (bh * sq + r0) * d;
  const int64_t kvbase = bh * sk * d;
  float* acc = ws + qbase;  // (nr, d), row-major like the output
  for (int e = tid; e < nr * d; e += blockDim.x) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;  // row tid's running max and sum (tid < WR)

  const int stop = row_ptr[iq + 1];
  for (int t = row_ptr[iq]; t < stop; ++t) {
    for (int jb = 0; jb < bk; jb += WK) {
      const int key0 = cols[t] * bk + jb;
      const int n = min(WK, bk - jb);
      // no row of this part sees these keys, nor the tile's later ones
      if (causal && key0 > r0 + nr - 1 + offs) break;
      // the scores: each thread's dot product, slice by slice
      float dot = 0.f;
      for (int c0 = 0; c0 < d; c0 += WS) {
        const int w = min(WS, d - c0);
        __syncthreads();  // the previous slice (or the previous P V) is done
        for (int e = tid; e < WR * w; e += blockDim.x) {
          const int r = e / w, c = e - r * w;
          qs[r * WP + c] = r < nr ? widen(q[qbase + static_cast<int64_t>(r) * d + c0 + c]) : 0.f;
          kv[r * WP + c] = r < n ? widen(k[kvbase + static_cast<int64_t>(key0 + r) * d + c0 + c])
                                 : 0.f;
        }
        __syncthreads();
        const float* qr = qs + tr * WP;
        const float* kr = kv + tj * WP;
        for (int c = 0; c < w; ++c) dot = fmaf(qr[c], kr[c], dot);
      }
      const bool visible = tr < nr && tj < n && (!causal || key0 + tj <= r0 + tr + offs);
      sp[tr][tj] = visible ? dot * scale : -INFINITY;
      __syncthreads();
      // the online softmax, one thread a row: as the narrow instances do
      // for one chunk of 16 keys; a row that sees none of them is left as
      // it was (alpha = 1, p = 0)
      if (tid < WR) {
        float mc = -INFINITY;
        for (int j = 0; j < WK; ++j) mc = fmaxf(mc, sp[tid][j]);
        if (mc == -INFINITY) {
          scale_r[tid] = 1.f;
          for (int j = 0; j < WK; ++j) sp[tid][j] = 0.f;
        } else {
          const float m_new = fmaxf(m, mc);
          const float alpha = expf(m - m_new);
          l *= alpha;
          for (int j = 0; j < WK; ++j) {
            const float p = expf(sp[tid][j] - m_new);
            l += p;
            sp[tid][j] = p;
          }
          scale_r[tid] = alpha;
          m = m_new;
        }
      }
      // acc = acc * alpha + P V, slice by slice
      for (int c0 = 0; c0 < d; c0 += WS) {
        const int w = min(WS, d - c0);
        __syncthreads();  // P and alpha are written; kv is free
        for (int e = tid; e < WK * w; e += blockDim.x) {
          const int j = e / w, c = e - j * w;
          kv[j * WP + c] = j < n ? widen(v[kvbase + static_cast<int64_t>(key0 + j) * d + c0 + c])
                                 : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < nr * w; e += blockDim.x) {
          const int r = e / w, c = e - r * w;
          float* a = acc + static_cast<int64_t>(r) * d + c0 + c;
          float x = *a * scale_r[r];
          for (int j = 0; j < WK; ++j) x = fmaf(sp[r][j], kv[j * WP + c], x);
          *a = x;
        }
      }
    }
  }
  __syncthreads();
  if (tid < WR) scale_r[tid] = l > 0.f ? 1.f / l : 0.f;
  if (lse != nullptr && tid < nr)
    lse[bh * sq + r0 + tid] = l > 0.f ? m + logf(l) : INFINITY;
  __syncthreads();  // and every thread's last acc update is visible
  for (int e = tid; e < nr * d; e += blockDim.x)
    store(o + qbase + e, acc[e] * scale_r[e / d]);
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        float* lse, float* ws, const int* plan, int bh, int sq, int sk,
                        int d, int bq, int bk, int causal, float scale,
                        cudaStream_t stream) {
  const int parts = (bq + WR - 1) / WR;
  for (int h0 = 0; h0 < bh; h0 += MAX_GRID_Y) {
    const int nh = bh - h0 < MAX_GRID_Y ? bh - h0 : MAX_GRID_Y;
    flash_fwd_wide_kernel<T><<<dim3(sq / bq * parts, nh), WR * WK, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, ws, plan, h0, sq, sk,
        d, bq, bk, causal, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, const int* plan, int bh, int sq, int sk, int d,
                     int bq, int bk, int causal, float scale, cudaStream_t st) {
  if (d <= 16) return launch<T, 16>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  if (d <= 256) return launch<T, 256>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  if (d <= 512) return launch<T, 512>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
  return launch<T, 1024>(q, k, v, o, lse, plan, bh, sq, sk, d, bq, bk, causal, scale, st);
}

// The C entry point of one element type's library: q (bh, sq, d), k and v
// (bh, sk, d), o (bh, sq, d), contiguous, all of type T, 16-byte aligned; d
// a multiple of 8, and above MAX_DP ws an f32 workspace of bh * sq * d
// elements (else unused); lse null or f32 (bh, sq); bq and bk in [1, 128]
// dividing sq and sk; plan int32 [q_order (sq/bq) | row_ptr (sq/bq + 1) |
// cols]. The wrapper checks all of this; the kernel trusts it.
template <typename T>
int flash_entry(const void* q, const void* k, const void* v, void* o, void* lse,
                void* ws, const void* plan, int bh, int sq, int sk, int d, int bq,
                int bk, int causal, float scale, void* stream) {
  if (d < 8 || d % 8 || (d > MAX_DP && ws == nullptr) || bh < 1 || bq < 1 ||
      bq > MAX_ROWS || bk < 1 || bk > 128 || sq % bq || sk % bk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* pl = static_cast<const int*>(plan);
  auto st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  if (d > MAX_DP)
    return static_cast<int>(launch_wide<T>(q, k, v, o, ls, static_cast<float*>(ws), pl,
                                           bh, sq, sk, d, bq, bk, causal, scale, st));
  return static_cast<int>(launch_d<T>(q, k, v, o, ls, pl, bh, sq, sk, d, bq, bk,
                                      causal, scale, st));
}

}  // namespace
