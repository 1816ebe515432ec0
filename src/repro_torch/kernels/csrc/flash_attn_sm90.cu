// Flash attention forward for Hopper (sm_90a) in bf16: wgmma on the tensor
// cores, K/V tiles fed by TMA into a ring of shared-memory stages, and warp
// specialisation, on a space-filling-curve schedule of the (q-block x
// kv-block) grid.
//
// Replaces flash_attention_fwd (_flash_kernel) of
// src/repro/kernels/flash_attn.py for bf16 q, k, v with D in {64, 128} and
// block_q, block_k in {64, 128}; kernels/flash_attn.py picks it by a pure
// function of dtype, D and block sizes (flash_design), and every other case
// runs the simple kernel of csrc/flash_attn.cuh. The function is the same:
// scores q.k in f32 scaled by 1/sqrt(D), keys past the causal diagonal
// (aligned to the end: col <= row + Sk - Sq) masked, an online softmax per
// row, a row with no key gives 0, the output rounded once to bf16. Where
// the caller asks for it (a non-null lse, for the backward:
// flash_attn_bwd_sm90.cu), each row's log-sum-exp of its scaled scores,
// (m + log2(l)) ln 2 in f32, is stored beside the output, +inf for a row
// with no key (the sentinel under which the backward's P is 0); serving
// passes null and stores nothing more. One
// thread block owns one (bh, q block); blockIdx.x is the q block's place in
// the order the curve first visits it, and the block walks its kv blocks
// in the curve's order, from the plan [q_order | row_ptr | cols] that the
// wrapper builds (schedule_plan).
//
// Design:
//   - warp specialisation: one consumer warpgroup per 64 q rows (1 or 2)
//     and, last, a producer warpgroup whose one thread issues every TMA
//     load; with two consumers, setmaxnreg moves registers from the
//     producer (40) to the consumers (232);
//   - the Q tile is loaded by TMA once; K and V tiles (bk x D bf16) go
//     into a ring of STAGES stages guarded by full/empty mbarriers, so the
//     next tile loads while this one is computed. Every tile is stored as
//     64-column halves of 128-byte rows with the 128-byte swizzle, the
//     layout that TMA writes and wgmma reads;
//   - S = Q K^T: wgmma m64n{bk}k16 with Q and K from shared memory (both
//     K-major, D contiguous), f32 accumulators;
//   - the online softmax on the accumulator fragment, in f32: exp2 on the
//     special-function unit (ex2.approx, one instruction) of scores scaled
//     by log2(e)/sqrt(D); only tiles that cross the diagonal are masked,
//     and a row that has seen no key yet keeps m = -inf without producing
//     NaN (the JAX kernel's still_empty guard);
//   - O += P V: wgmma m64n{D}k16 with P from registers (the S accumulator
//     fragment is the A fragment of this product) and V from shared memory
//     with the transpose bit (V is MN-major for it). P is split into
//     bf16(P) + bf16(P - bf16(P)) and both halves are multiplied, so P
//     keeps about 16 bits: a single bf16 P errs by up to 2^-8 per
//     probability, which where positive and negative values of v cancel is
//     far above the plain version's tolerance (one bf16 unit + 1e-5);
//   - a stage is released once its P V is done; the two consumer
//     warpgroups run the same kv walk independently, so one's softmax can
//     overlap the other's products.
//
// What bounds it on an H100: at the prefill's shape (BH = 60, S = 2048,
// D = 64, causal) the function needs 4 * D * BH * S(S+1)/2 = 3.2e10
// operations (0.033 ms at 989 TFLOP/s in bf16) against 42 MB of traffic
// (0.013 ms at 3.35 TB/s): operations. The split P makes the design's own
// work 1.5x the function's. What holds it below that bound is the issue
// of the softmax's instructions (max, exp, sum and the split: about seven
// per score) beside narrow m64n64 products at D = 64.

#include "flash_sm90.cuh"

namespace {

constexpr int STAGES = 2;    // K/V ring depth
constexpr int ROWS_WG = 64;  // q rows per consumer warpgroup (wgmma's M)

// S = Q K^T for one warpgroup: q_rows is its 64 rows of the Q tile, k_tile
// a K stage; both K-major, D in 64-column halves of 128-byte rows.
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint32_t q_rows,
                                        uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int h = ks / 4, kk = ks % 4;
    wgmma_ss<BK>(sc, sw128_desc(q_rows + h * BQ * 128 + kk * 32, 16, 1024),
                 sw128_desc(k_tile + h * BK * 128 + kk * 32, 16, 1024), ks > 0);
  }
}

// O += P V with P = hi + lo from registers; V rows 16ks .. 16ks + 15 are
// two 8-row swizzle atoms (SBO), and the 64-column halves of D = 128 lie
// BK rows apart (LBO).
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    const uint64_t db = sw128_desc(v_tile + ks * 16 * 128, BK * 128, 1024);
    wgmma_rs<D>(acc, hi[ks], db);
    wgmma_rs<D>(acc, lo[ks], db);
  }
}

// The online softmax of one tile of scores sc (raw q.k), in place: keys
// 8j + e of this thread's columns with 8j + e > lim + 8h (row h of its
// two) are masked when `mask`; m (scaled by scale_log2) and l are updated,
// alpha is the factor for the accumulator, sc becomes p.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool mask, int lim, float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j + e > lim + 8 * h) sc[4 * j + 2 * h + e] = -INFINITY;
        }
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * h + e];
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // the running max stays -inf while the row has seen no key; then
    // m_use = 0 keeps -inf - (-inf) out, and alpha = 0 meets a zero sum
    const float m_new = fmaxf(m[h], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[h] = fast_exp2(m[h] - m_use);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * j + 2 * h + e];
        x = fast_exp2(fmaf(x, scale_log2, -m_use));
        sum += x;
      }
    }
    l[h] = fmaf(l[h], alpha[h], sum);
  }
}

// P = hi + lo, both bf16, in the A fragment of m64nDk16: for k-step ks,
// registers 0..3 hold (row, cols 2c..2c+1), (row + 8, same), (row, 8 +
// ...), (row + 8, 8 + ...) of its 16 keys — the accumulator registers
// 8ks .. 8ks + 7 of the scores, in order.
template <int BK>
__device__ __forceinline__ void split_p(const float (&p)[BK / 2],
                                        uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = p[8 * ks + 2 * i], b = p[8 * ks + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[ks][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[ks][i] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__((BQ / ROWS_WG + 1) * 128, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      const int* __restrict__ plan, int bh0, int sq, int sk,
                      int causal, float scale_log2) {
  constexpr int NC = BQ / ROWS_WG;          // consumer warpgroups
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_k = s_q + Q_BYTES;                 // STAGES K tiles
  const uint32_t s_v = s_k + STAGES * KV_BYTES;       // STAGES V tiles
  const uint32_t bar_q = s_v + STAGES * KV_BYTES;
  const uint32_t bar_full = bar_q + 8;                // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;   // STAGES barriers

  const int nq = sq / BQ;
  const int iq = plan[blockIdx.x];
  const int first = plan[nq + iq];
  const int n_tiles = plan[nq + iq + 1] - first;
  const int* cols = plan + 2 * nq + 1 + first;
  const int bh = bh0 + blockIdx.y;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer: one thread issues every TMA load
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128 && n_tiles > 0) {
      mbar_expect_tx(bar_q, Q_BYTES);
#pragma unroll
      for (int h = 0; h < D / 64; ++h)
        tma_load_2d(s_q + h * BQ * 128, &tm_q, h * 64, bh * sq + iq * BQ, bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * KV_BYTES);
        const int row = bh * sk + cols[t] * BK;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_2d(s_k + s * KV_BYTES + h * BK * 128, &tm_k, h * 64, row,
                      bar_full + 8 * s);
          tma_load_2d(s_v + s * KV_BYTES + h * BK * 128, &tm_v, h * 64, row,
                      bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows per warpgroup
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int offs = sk - sq;
    const int q0 = iq * BQ + wg * ROWS_WG;           // this warpgroup's first row
    const int r0 = q0 + (tid / 32) * 16 + lane / 4;  // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max, scaled by scale_log2
    float l[2] = {0.f, 0.f};              // this thread's part of the row sums
    const uint32_t q_rows = s_q + wg * ROWS_WG * 128;
    float sc[BK / 2], alpha[2];
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int k0 = cols[t] * BK;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
      issue_s<D, BQ, BK>(sc, q_rows, s_k + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      // only a tile that crosses this warpgroup's diagonal is masked
      softmax_tile<BK>(sc, m, l, alpha, causal && k0 + BK - 1 > q0 + offs,
                       r0 + offs - k0 - c0, scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      split_p<BK>(sc, p_hi, p_lo);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, p_hi, p_lo, s_v + s * KV_BYTES);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    // the row sums over the four threads that share each row
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      inv[h] = sum > 0.f ? 1.f / sum : 0.f;
      if (lse != nullptr && lane % 4 == 0)
        lse[static_cast<int64_t>(bh) * sq + r0 + 8 * h] =
            sum > 0.f ? (m[h] + log2f(sum)) * 0.6931471805599453f : INFINITY;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * sq + r0 + 8 * h) * D + c0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);
      }
    }
  }
}


template <int D, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const int* plan, int bh, int sq, int sk, int causal,
                   float scale_log2, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = make_map(&tm_q, q, static_cast<int64_t>(bh) * sq, D, BQ);
  if (err == cudaSuccess) err = make_map(&tm_k, k, static_cast<int64_t>(bh) * sk, D, BK);
  if (err == cudaSuccess) err = make_map(&tm_v, v, static_cast<int64_t>(bh) * sk, D, BK);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + BQ * D * 2 + 2 * STAGES * BK * D * 2 + 8 * (1 + 2 * STAGES);
  auto kern = flash_fwd_sm90_kernel<D, BQ, BK>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // a launch covers at most 65535 folded heads (gridDim.y): the heads go
  // in chunks, each kernel told its first head; the maps span them all
  for (int h0 = 0; h0 < bh; h0 += 65535) {
    const int nh = bh - h0 < 65535 ? bh - h0 : 65535;
    kern<<<dim3(sq / BQ, nh), (BQ / ROWS_WG + 1) * 128, smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, plan, h0, sq, sk,
        causal, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_blocks(const void* q, const void* k, const void* v, void* o,
                          float* lse, const int* plan, int bh, int sq, int sk,
                          int bq, int bk, int causal, float sl, cudaStream_t st) {
  if (bq == 64 && bk == 64) return launch<D, 64, 64>(q, k, v, o, lse, plan, bh, sq, sk, causal, sl, st);
  if (bq == 64) return launch<D, 64, 128>(q, k, v, o, lse, plan, bh, sq, sk, causal, sl, st);
  if (bk == 64) return launch<D, 128, 64>(q, k, v, o, lse, plan, bh, sq, sk, causal, sl, st);
  return launch<D, 128, 128>(q, k, v, o, lse, plan, bh, sq, sk, causal, sl, st);
}

}  // namespace

extern "C" {

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d): contiguous bf16,
// 16-byte aligned; lse null or f32 (bh, sq); d in {64, 128}; bq, bk in
// {64, 128} dividing sq, sk. plan int32 [q_order (sq/bq) | row_ptr (sq/bq +
// 1) | cols]. scale = 1/sqrt(d). The wrapper checks all of this; the
// kernel trusts it.
int repro_flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const void* plan, int bh,
                                   int sq, int sk, int d, int bq, int bk,
                                   int causal, float scale, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto pl = static_cast<const int*>(plan);
  auto ls = static_cast<float*>(lse);
  if ((d != 64 && d != 128) || (bq != 64 && bq != 128) ||
      (bk != 64 && bk != 128) || sq % bq || sk % bk || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float sl = scale * 1.4426950408889634f;  // log2(e) / sqrt(d)
  if (d == 64) return launch_blocks<64>(q, k, v, o, ls, pl, bh, sq, sk, bq, bk, causal, sl, st);
  return launch_blocks<128>(q, k, v, o, ls, pl, bh, sq, sk, bq, bk, causal, sl, st);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
