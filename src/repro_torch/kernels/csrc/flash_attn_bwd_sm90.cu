// Flash attention backward for Hopper (sm_90a) in bf16: wgmma on the tensor
// cores, tiles fed by TMA into a ring of shared-memory stages, and warp
// specialisation; no atomics.
//
// Replaces no TPU kernel: the JAX package has no Pallas backward. Its
// custom_vjp (_fa_bwd, src/repro/kernels/ops.py:215) recomputes the dense
// oracle attention_ref under jax.vjp, and the port's training step used to
// do the same with PyTorch's dense products (4 GiB score tensors at the
// step's shape). This computes that gradient from what the forward
// (flash_attn_sm90.cu) saved: its output O and each row's log-sum-exp. It
// takes bf16 q, k, v with D, block_q and block_k in {64, 128}, the shapes
// every trained arch gives (kernels/flash_attn.flash_design); every other
// case runs the simple design of csrc/flash_attn_bwd.cuh.
//
// The function (kernels/ref.py's flash_attention_bwd_ref): s = q.k /
// sqrt(D); P = exp(s - lse) (0 past the causal diagonal, aligned to the
// end, and on a row with no key, whose lse is +inf); Δ = rowsum(dO∘O);
// dP = dO.v; dS = P∘(dP - Δ); dV = Pᵀ dO, dK = dSᵀ Q / sqrt(D),
// dQ = dS K / sqrt(D), accumulated in f32 and rounded once to bf16.
//
// Design, three launches in one call:
//   1. delta: Δ in f32 (bh, sq), eight threads a row, from bf16 O and dO;
//   2. dK/dV: one thread block per (bh, block_k keys); one consumer
//      warpgroup per 64 keys (1 or 2) and a producer warpgroup whose one
//      thread issues every copy. The block's K and V tiles are loaded by
//      TMA once; the tiles of 64 q rows that see its keys (from the
//      diagonal on) stream through a ring of STAGES stages of Q, dO (TMA)
//      and their rows' lse and Δ (1-D bulk copies), guarded by full/empty
//      mbarriers. Per tile, per consumer warpgroup:
//        Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: wgmma m64n64k16, both operands from
//          shared memory (K-major, D contiguous), f32 accumulators;
//        Pᵀ = exp2(Sᵀ·log2(e)/sqrt(D) - lse·log2(e)) on the special-
//          function unit, masked only on tiles that cross the diagonal;
//          dSᵀ = Pᵀ∘(dPᵀ - Δ), in f32, each packed into bf16 A fragments;
//        dV += Pᵀ dO and dK += dSᵀ Q: wgmma m64n{D}k16 with Pᵀ and dSᵀ
//          from registers (the accumulator fragment of a product is the A
//          fragment of the next) and dO, Q from shared memory with the
//          transpose bit (MN-major for these products);
//      dK is scaled by 1/sqrt(D) once, at the end;
//   3. dQ: one thread block per (bh, block_q rows), one consumer
//      warpgroup per 64 rows; Q and dO loaded once, K and V tiles of 64
//      keys (up to the last the rows see) through the ring; S = Q Kᵀ,
//      dP = dO Vᵀ, P and dS as above (lse and Δ per row, from global
//      memory once), dQ += dS K with dS from registers.
// Each dK, dV and dQ element is summed by one thread in a fixed order, so
// a run repeats bit for bit (the training step's kill-and-resume check
// needs that under torch.use_deterministic_algorithms); the price is that
// S and dP are computed twice, once in each kernel. Every tile is stored
// as 64-column halves of 128-byte rows with the 128-byte swizzle, the
// layout TMA writes and wgmma reads (flash_sm90.cuh).
//
// Rounded to bf16: P (for dV += Pᵀ dO) and dS (for dK and dQ), once each,
// a relative error of at most 2^-9 per term, summed over many terms in f32:
// the gradients' relative L2 error against the f32 plain version is of
// that order (chip_smoke.py holds dq, dk and dv within 1e-2). The training
// step's gates compare the loss, which the backward does not touch, and
// the gradient norm, a sum over 362M squares in which such independent
// errors cancel: the forward needed its P split into two bf16 halves
// because one output element is a short convex combination that the
// plain version's tolerance (one bf16 unit) holds to; a gradient has no
// such bound, and splitting would double the dV, dK and dQ products.
//
// What bounds it on an H100: at the training step's shape (BH = 60,
// S = 4096, D = 64, causal) the function's five products need
// 10 * D * BH * S(S+1)/2 = 3.22e11 operations, 0.326 ms at 989 TFLOP/s in
// bf16, against 252 MB of traffic (0.075 ms at 3.35 TB/s): operations.
// The design's own work is 7/5 of that (S and dP twice). The tensor cores
// do all of it; what holds the kernels below the bound is the issue of the
// elementwise work on every score (exp2, mask, dS, two bf16 packs) between
// products that wait for each other, with one or two consumer warpgroups
// per SM.

#include "flash_sm90.cuh"

namespace {

constexpr int STAGES = 2;  // ring depth
constexpr int TILE = 64;   // q rows (dK/dV) or keys (dQ) of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

// acc[64 x N] = A[64 x D] B[N x D]ᵀ: A's 64 rows from a tile of A_ROWS rows
// (a_rows: their first row), B a tile of N rows; both K-major, D in
// 64-column halves of 128-byte rows.
template <int D, int A_ROWS, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t a_rows,
                                         uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int h = ks / 4, kk = ks % 4;
    wgmma_ss<N>(acc, sw128_desc(a_rows + h * A_ROWS * 128 + kk * 32, 16, 1024),
                sw128_desc(b_tile + h * N * 128 + kk * 32, 16, 1024), ks > 0);
  }
}

// acc[64 x D] += A[64 x K] B[K x D]: A from registers (K / 16 fragments), B
// a tile of K rows of D columns, MN-major for this product: rows 16ks ..
// 16ks + 15 are two 8-row swizzle atoms (SBO), and the 64-column halves of
// D = 128 lie K rows apart (LBO).
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[K / 16][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_rs<D>(acc, a[ks], sw128_desc(b_tile + ks * 16 * 128, K * 128, 1024));
}

// The A fragments of m64nDk16 are the accumulator fragment of a product of
// 64 columns, in bf16 pairs: registers 8ks .. 8ks + 7 of the accumulator
// are k-step ks, so the pair (4j + 2h, 4j + 2h + 1) (column group j, row
// half h) is register 2 (j % 2) + h of k-step j / 2.

// Keep the compiler from reusing an A fragment's registers while an
// asynchronous wgmma may still read them.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[TILE / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i]) :: "memory");
  }
}

// Write a (64 x D) f32 accumulator fragment, times `mul`, as bf16 rows
// r0 and r0 + 8 (columns c0 + 8j) of out.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           float mul, int64_t r0, int c0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    __nv_bfloat16* row = out + (r0 + 8 * h) * D + c0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
  }
}

// Δ = rowsum(dO∘O) in f32: eight threads a row, each 8 columns at a time
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_sm90_kernel(const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                  int64_t rows) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  float acc = 0.f;
  if (r < rows) {
#pragma unroll
    for (int c = part * 8; c < D; c += 64) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + r * D + c);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + r * D + c);
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(ha[i]), fb = __bfloat1622float2(hb[i]);
        acc = fmaf(fa.x, fb.x, acc);
        acc = fmaf(fa.y, fb.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (r < rows && part == 0) delta[r] = acc;
}

// ---- dK and dV: one thread block per (bh, BK keys)
template <int D, int BK>
__global__ void __launch_bounds__((BK / 64 + 1) * 128, 1)
flash_bwd_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                 int bh0, int sq, int sk, int causal, float scale_log2, float scale) {
  constexpr int NC = BK / 64;              // consumer warpgroups
  constexpr int KV_BYTES = BK * D * 2;     // the K or the V tile
  constexpr int T_BYTES = TILE * D * 2;    // one Q or dO tile
  constexpr int ST_BYTES = TILE * 4;       // one stage's lse or Δ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (s_k - raw);               // s_k, generic
  const uint32_t s_v = s_k + KV_BYTES;
  const uint32_t s_q = s_v + KV_BYTES;                  // STAGES Q tiles
  const uint32_t s_do = s_q + STAGES * T_BYTES;         // STAGES dO tiles
  const uint32_t s_st = s_do + STAGES * T_BYTES;        // STAGES x (lse, Δ)
  const uint32_t bar_kv = s_st + STAGES * 2 * ST_BYTES;
  const uint32_t bar_full = bar_kv + 8;                 // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // STAGES barriers

  const int bh = bh0 + blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int offs = sk - sq;
  // the q tiles that see these keys: from the one holding row k0 - offs
  const int t0 = causal ? max(0, k0 - offs) / TILE : 0;
  const int n_tiles = max(0, sq / TILE - t0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer: one thread issues every copy
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128 && n_tiles > 0) {
      mbar_expect_tx(bar_kv, 2 * KV_BYTES);
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        tma_load_2d(s_k + h * BK * 128, &tm_k, h * 64, bh * sk + k0, bar_kv);
        tma_load_2d(s_v + h * BK * 128, &tm_v, h * 64, bh * sk + k0, bar_kv);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * T_BYTES + 2 * ST_BYTES);
        const int row = bh * sq + (t0 + t) * TILE;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_2d(s_q + s * T_BYTES + h * TILE * 128, &tm_q, h * 64, row,
                      bar_full + 8 * s);
          tma_load_2d(s_do + s * T_BYTES + h * TILE * 128, &tm_do, h * 64, row,
                      bar_full + 8 * s);
        }
        bulk_copy(s_st + s * 2 * ST_BYTES, lse + row, ST_BYTES, bar_full + 8 * s);
        bulk_copy(s_st + s * 2 * ST_BYTES + ST_BYTES, delta + row, ST_BYTES,
                  bar_full + 8 * s);
      }
    }
  } else {
    // ---------------- consumers: 64 keys per warpgroup
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int kw = k0 + wg * 64;                      // this warpgroup's first key
    const int kr = kw + (tid / 32) * 16 + lane / 4;   // keys kr and kr + 8
    const int c0 = 2 * (lane % 4);
    const uint32_t k_rows = s_k + wg * 64 * 128, v_rows = s_v + wg * 64 * 128;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float sc[TILE / 2], dp[TILE / 2];
    uint32_t pf[TILE / 16][4], dsf[TILE / 16][4];
    if (n_tiles > 0) mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int qt = (t0 + t) * TILE;  // the tile's first q row
      const uint32_t q_tile = s_q + s * T_BYTES, do_tile = s_do + s * T_BYTES;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) sc[i] = dp[i] = 0.f;  // no value carried
      wgmma_fence();
      issue_ss<D, BK, TILE>(sc, k_rows, q_tile);   // Sᵀ = K Qᵀ
      issue_ss<D, BK, TILE>(dp, v_rows, do_tile);  // dPᵀ = V dOᵀ
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      // Pᵀ and dSᵀ into bf16 A fragments: column (q row) qt + 8j + c0 + e
      // of key rows kr + 8h, hidden where kr + 8h > qt + 8j + c0 + e + offs
      const float* st = reinterpret_cast<const float*>(base + (s_st - s_k) + s * 2 * ST_BYTES);
      const bool mask = causal && kw + 63 > qt + offs;
      const int lim = kr - offs - qt - c0;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + c0);
        const float2 d2 = *reinterpret_cast<const float2*>(st + TILE + 8 * j + c0);
        const float ll[2] = {l2.x * LOG2E, l2.y * LOG2E}, dd[2] = {d2.x, d2.y};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            p[e] = mask && 8 * j + e < lim + 8 * h
                       ? 0.f : fast_exp2(fmaf(sc[i], scale_log2, -ll[e]));
            ds[e] = p[e] * (dp[i] - dd[e]);
          }
          pf[j / 2][2 * (j % 2) + h] = pack_bf16(p[0], p[1]);
          dsf[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
        }
      }
      fence_regs(dva);
      fence_regs(dka);
      fence_frag(pf);
      fence_frag(dsf);
      wgmma_fence();
      issue_rs<D, TILE>(dva, pf, do_tile);   // dV += Pᵀ dO
      issue_rs<D, TILE>(dka, dsf, q_tile);   // dK += dSᵀ Q
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dva);
      fence_regs(dka);
      fence_frag(pf);
      fence_frag(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    const int64_t row = static_cast<int64_t>(bh) * sk + kr;
    store_rows<D>(dv, dva, 1.f, row, c0);
    store_rows<D>(dk, dka, scale, row, c0);
  }
}

// ---- dQ: one thread block per (bh, BQ q rows)
template <int D, int BQ>
__global__ void __launch_bounds__((BQ / 64 + 1) * 128, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dq, int bh0, int sq, int sk, int causal,
               float scale_log2, float scale) {
  constexpr int NC = BQ / 64;              // consumer warpgroups
  constexpr int Q_BYTES = BQ * D * 2;      // the Q or the dO tile
  constexpr int T_BYTES = TILE * D * 2;    // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s_q = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t s_do = s_q + Q_BYTES;
  const uint32_t s_k = s_do + Q_BYTES;                  // STAGES K tiles
  const uint32_t s_v = s_k + STAGES * T_BYTES;          // STAGES V tiles
  const uint32_t bar_q = s_v + STAGES * T_BYTES;
  const uint32_t bar_full = bar_q + 8;                  // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // STAGES barriers

  const int bh = bh0 + blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int offs = sk - sq;
  // the key tiles up to the last key the last row sees
  const int stop = causal ? min(sk, q0 + BQ + offs) : sk;
  const int n_tiles = stop > 0 ? (stop + TILE - 1) / TILE : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---------------- producer
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NC * 128 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
#pragma unroll
      for (int h = 0; h < D / 64; ++h) {
        tma_load_2d(s_q + h * BQ * 128, &tm_q, h * 64, bh * sq + q0, bar_q);
        tma_load_2d(s_do + h * BQ * 128, &tm_do, h * 64, bh * sq + q0, bar_q);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(bar_empty + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * T_BYTES);
        const int row = bh * sk + t * TILE;
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          tma_load_2d(s_k + s * T_BYTES + h * TILE * 128, &tm_k, h * 64, row,
                      bar_full + 8 * s);
          tma_load_2d(s_v + s * T_BYTES + h * TILE * 128, &tm_v, h * 64, row,
                      bar_full + 8 * s);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 q rows per warpgroup
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int qw = q0 + wg * 64;                      // this warpgroup's first row
    const int r0 = qw + (tid / 32) * 16 + lane / 4;   // rows r0 and r0 + 8
    const int c0 = 2 * (lane % 4);
    const uint32_t q_rows = s_q + wg * 64 * 128, do_rows = s_do + wg * 64 * 128;
    const int64_t rbase = static_cast<int64_t>(bh) * sq + r0;
    const float ll[2] = {lse[rbase] * LOG2E, lse[rbase + 8] * LOG2E};
    const float dd[2] = {delta[rbase], delta[rbase + 8]};
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    float sc[TILE / 2], dp[TILE / 2];
    uint32_t dsf[TILE / 16][4];
    if (n_tiles > 0) mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const int kt = t * TILE;  // the tile's first key
      const uint32_t k_tile = s_k + s * T_BYTES, v_tile = s_v + s * T_BYTES;
      mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) sc[i] = dp[i] = 0.f;  // no value carried
      wgmma_fence();
      issue_ss<D, BQ, TILE>(sc, q_rows, k_tile);   // S = Q Kᵀ
      issue_ss<D, BQ, TILE>(dp, do_rows, v_tile);  // dP = dO Vᵀ
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      // key kt + 8j + c0 + e of rows r0 + 8h, hidden where it lies past
      // row + offs (only on tiles that cross this warpgroup's diagonal)
      const bool mask = causal && kt + TILE - 1 > qw + offs;
      const int lim = r0 + offs - kt - c0;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float p = mask && 8 * j + e > lim + 8 * h
                                ? 0.f : fast_exp2(fmaf(sc[i], scale_log2, -ll[h]));
            ds[e] = p * (dp[i] - dd[h]);
          }
          dsf[j / 2][2 * (j % 2) + h] = pack_bf16(ds[0], ds[1]);
        }
      }
      fence_regs(dqa);
      fence_frag(dsf);
      wgmma_fence();
      issue_rs<D, TILE>(dqa, dsf, k_tile);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dqa);
      fence_frag(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }
    store_rows<D>(dq, dqa, scale, rbase, c0);
  }
}

template <int D, int BK>
cudaError_t launch_dkdv(const CUtensorMap& tq, const CUtensorMap& tdo,
                        const void* k, const void* v, const float* lse,
                        const float* delta, void* dk, void* dv, int bh, int sq,
                        int sk, int causal, float sl, float scale, cudaStream_t st) {
  CUtensorMap tk, tv;
  cudaError_t err = make_map(&tk, k, static_cast<int64_t>(bh) * sk, D, BK);
  if (err == cudaSuccess) err = make_map(&tv, v, static_cast<int64_t>(bh) * sk, D, BK);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + 2 * BK * D * 2 + STAGES * (2 * TILE * D * 2 + 2 * TILE * 4) +
                   8 * (1 + 2 * STAGES);
  auto kern = flash_bwd_dkdv_sm90_kernel<D, BK>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  for (int h0 = 0; h0 < bh; h0 += 65535) {
    const int nh = bh - h0 < 65535 ? bh - h0 : 65535;
    kern<<<dim3(sk / BK, nh), (BK / 64 + 1) * 128, smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), h0, sq, sk, causal, sl, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D, int BQ>
cudaError_t launch_dq(const void* q, const void* dout, const CUtensorMap& tk,
                      const CUtensorMap& tv, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int causal, float sl,
                      float scale, cudaStream_t st) {
  CUtensorMap tq, tdo;
  cudaError_t err = make_map(&tq, q, static_cast<int64_t>(bh) * sq, D, BQ);
  if (err == cudaSuccess) err = make_map(&tdo, dout, static_cast<int64_t>(bh) * sq, D, BQ);
  if (err != cudaSuccess) return err;
  const int smem = 1024 + 2 * BQ * D * 2 + STAGES * 2 * TILE * D * 2 + 8 * (1 + 2 * STAGES);
  auto kern = flash_bwd_dq_sm90_kernel<D, BQ>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  for (int h0 = 0; h0 < bh; h0 += 65535) {
    const int nh = bh - h0 < 65535 ? bh - h0 : 65535;
    kern<<<dim3(sq / BQ, nh), (BQ / 64 + 1) * 128, smem, st>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), h0, sq, sk,
        causal, sl, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, void* dq, void* dk,
                       void* dv, float* delta, int bh, int sq, int sk, int bq,
                       int bk, int causal, float scale, cudaStream_t st) {
  const int64_t rows = static_cast<int64_t>(bh) * sq;
  flash_bwd_delta_sm90_kernel<D><<<static_cast<unsigned>((rows * 8 + 255) / 256), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the streamed tiles' maps: Q and dO by 64 rows (dK/dV), K and V by 64
  // keys (dQ)
  CUtensorMap tq, tdo, tk, tv;
  err = make_map(&tq, q, rows, D, TILE);
  if (err == cudaSuccess) err = make_map(&tdo, dout, rows, D, TILE);
  if (err == cudaSuccess) err = make_map(&tk, k, static_cast<int64_t>(bh) * sk, D, TILE);
  if (err == cudaSuccess) err = make_map(&tv, v, static_cast<int64_t>(bh) * sk, D, TILE);
  if (err != cudaSuccess) return err;
  const float sl = scale * LOG2E;
  err = bk == 64
      ? launch_dkdv<D, 64>(tq, tdo, k, v, lse, delta, dk, dv, bh, sq, sk, causal, sl, scale, st)
      : launch_dkdv<D, 128>(tq, tdo, k, v, lse, delta, dk, dv, bh, sq, sk, causal, sl, scale, st);
  if (err != cudaSuccess) return err;
  return bq == 64
      ? launch_dq<D, 64>(q, dout, tk, tv, lse, delta, dq, bh, sq, sk, causal, sl, scale, st)
      : launch_dq<D, 128>(q, dout, tk, tv, lse, delta, dq, bh, sq, sk, causal, sl, scale, st);
}

}  // namespace

extern "C" {

// q, o, dout, dq (bh, sq, d); k, v, dk, dv (bh, sk, d): contiguous bf16,
// 16-byte aligned; lse f32 (bh, sq) from the forward; delta an f32 scratch
// of (bh, sq); ws unused (the simple design's workspace); d in {64, 128};
// bq, bk in {64, 128} dividing sq, sk; scale = 1/sqrt(d). The wrapper
// checks all of this; the kernels trust it.
int repro_flash_attention_bwd_sm90(const void* q, const void* k, const void* v,
                                   const void* o, const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   void* ws, int bh, int sq, int sk, int d, int bq,
                                   int bk, int causal, float scale, void* stream) {
  (void)ws;
  auto st = static_cast<cudaStream_t>(stream);
  auto ls = static_cast<const float*>(lse);
  auto dl = static_cast<float*>(delta);
  if ((d != 64 && d != 128) || (bq != 64 && bq != 128) ||
      (bk != 64 && bk != 128) || sq % bq || sk % bk || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d == 64)
    return static_cast<int>(launch_bwd<64>(q, k, v, o, ls, dout, dq, dk, dv, dl, bh, sq,
                                           sk, bq, bk, causal, scale, st));
  return static_cast<int>(launch_bwd<128>(q, k, v, o, ls, dout, dq, dk, dv, dl, bh, sq,
                                          sk, bq, bk, causal, scale, st));
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
