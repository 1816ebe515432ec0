// The fused SFC-blocked 3-D stencil, redesigned for Hopper (sm_90a).
//
// Replaces, with csrc/stencil3d.cu's fused_kernel beside it for the shapes
// this design does not take (kernels/stencil3d.fused_design picks one):
//   stencil_step_fused (_fused_kernel), src/repro/kernels/stencil3d.py:296
//     (pallas_call at :377): S substeps of ghost refresh + tap sum + update
//     rule per launch over the resident curve-ordered block store;
//   stencil_sum_resident (_resident_kernel), src/repro/kernels/stencil3d.py:212
//     (pallas_call at :238): the same with the identity rule, S = 1,
//     periodic (on an f32 store the identity rule's output is the tap sum).
// It takes T in {8, 16}, g in {1, 2}, S*g | T, C in {1, 2} (C = 2 is the
// wave rule, which tap-sums u only), wherever three C*(T+2Sg)^3 f32
// windows fit in shared memory (its group design, 4. below, T = 8 where
// two C*(2T+2Sg)^3 windows fit); every rule and boundary contract of the
// first design, the extended stores of the distributed path (nb <= nb_src,
// out channels out_nb >= nb blocks apart), and its __trap on a neighbour
// id outside the store.
//
// Numerics, bit-identical to kernels/ref.py as the first design is: each
// accumulator starts at 0.0f and takes its (2g+1)^3 terms in dk, di, dj
// order through __fmul_rn / __fadd_rn (never contracted; the library is
// also built with -fmad=false and never with --use_fast_math). Jacobi's
// mean s / n is the IEEE quotient, computed as the double product
// s * (1.0 / n) rounded once to float: n = (2g+1)^3 is odd, so s / n lies
// at least 1/54 of a float spacing from any rounding midpoint, far beyond
// the double product's error, and the rounding is the quotient's. That
// keeps the library free of FFMA (a float division's Newton step is one),
// which chip_smoke.py checks in the SASS.
//
// What bounds it on an H100. The function needs S*M^3*(2g+1)^3 multiplies
// and as many adds (3.62 GFLOP at M=256, S=4, g=1; 0.054 ms at 67 TFLOP/s).
// Without FMA each tap is two f32 instructions, and 132 SMs x 128 lanes x
// 1.98 GHz issue 33.5 T of them a second: 0.108 ms. A tile's window also
// recomputes the halo sites its shrinking windows still need: 2.92x the
// function's work for one T=8 block at S=4 (0.317 ms), 1.74x for a 2x2x2
// group of them (0.189 ms). So the limit is the instruction stream, and
// every instruction beside the multiplies and adds costs issue slots. What
// each part of the design does about it:
//   1. Compile-time shapes: one kernel per (rule, g, T, S); every window
//      edge, pitch, loop bound and index division is a constant.
//   2. Register tiling: a thread owns a column of NZ sites along k times
//      NX = 2 along j. It streams the window's k-planes in increasing
//      order, loads each plane's 2g+1 rows of NX+2g values once (8-byte
//      shared loads), and adds them to the 2g+1 live accumulators whose dk
//      that plane is, in di, dj order; so each accumulator still sees dk
//      in order, bit for bit as the plain version. Shared loads per site
//      fall from 27 to about 5 (T=8, S=4), the site's own value comes
//      from those registers, and the weights sit in (uniform) registers.
//      NZ is picked per substep (column_depth) so that the columns fill
//      the thread block's rounds: a substep waits for its slowest thread.
//   3. Overlap: persistent thread blocks, as many per SM as fit, each
//      walking a contiguous run of the store's blocks in the store's own
//      (curve) order. While a block's substeps run, the next block's
//      window streams into a third buffer with cp.async (16-byte pieces
//      where S*g % 4 == 0, else 8 or 4), and the table row after it is
//      already in flight in registers. Consecutive blocks of one thread
//      block share most of their neighbours, which stay in L2. The launch
//      takes this only where the third window costs no thread block per
//      SM; elsewhere one thread block per output block, two windows, and
//      the hardware's scheduling overlaps blocks (launch()).
//   4. The group design (fused_group_sm90_kernel), for the periodic
//      resident cube with T=8 and S*g >= 2: one thread block of 512
//      threads, one an SM, steps an aligned 2x2x2 group of blocks as one
//      tile of edge 2T from a host-built group table (core/neighbors.
//      group_table: each group's 4x4x4 window blocks and 8 outputs, in the
//      store's order), so the recomputed halo falls from 2.92x to 1.74x
//      the function's work and the window bytes read per output block to
//      0.42x. Two 24^3 windows of the wave's two channels fill 221 KB, so
//      there the next group's window streams into the buffer the result
//      does not occupy while the result is written; where a third window
//      fits (one channel, or 20^3) it streams in beside the substeps,
//      2-5% quicker a launch (see PERF.md).
// Not done: skipping the multiplies by all-ones weights and the zero
// centre tap (the wave's reference adds just the 26 neighbours), a bf16
// instance, groups of T=16 blocks. See PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RULE_GOL = 0;
constexpr int RULE_JACOBI = 1;
constexpr int RULE_IDENTITY = 2;
constexpr int RULE_WAVE = 3;

constexpr int BC_PERIODIC = 0;
constexpr int BC_DIRICHLET = 1;

constexpr int NT = 128;              // threads per thread block
constexpr int NX = 2;                // sites per thread along j
constexpr int TABLE_INTS = 33;       // a block's 27 neighbour ids, 6 face flags
constexpr int SMEM_LIMIT = 232448;   // shared memory of one thread block

// Per-axis boundary contract, k then i then j (kernels/rules.py).
struct Bc {
  int kind[3];
  float value[3];
};

__host__ __device__ constexpr int channels_of(int rule) {
  return rule == RULE_WAVE ? 2 : 1;
}

// The window of one output block: edge P = T + 2Sg (also the pitch of
// every buffer: each substep's smaller window sits at the origin), C
// channels of P^3 f32 each.
template <int C, int G, int T, int S>
struct Shape {
  static constexpr int H = S * G;
  static constexpr int P = T + 2 * H;
  static constexpr int BUF = C * P * P * P;
  static constexpr int K = 2 * G + 1;
  static constexpr int TAPS = K * K * K;
};

// Three windows (current, substep partner, next block's) and the two
// table rows; kernels/stencil3d.sm90_smem_bytes is the same model.
template <int C, int G, int T, int S>
constexpr bool fits() {
  return T % (S * G) == 0 &&
         3LL * Shape<C, G, T, S>::BUF * 4 + 2 * TABLE_INTS * 4 <= SMEM_LIMIT;
}

__host__ __device__ constexpr int neighbours(int G) {
  return (2 * G + 1) * (2 * G + 1) * (2 * G + 1) - 1;
}

__host__ __device__ constexpr int top_bit(int n) {
  return n < 2 ? n : 2 * top_bit(n / 2);
}

template <int G>
__device__ __forceinline__ float gol_rule(float centre, float tap) {
  constexpr int n = neighbours(G);
  constexpr float lo = static_cast<float>((2 * n) / 8);
  constexpr float hi = static_cast<float>((3 * n) / 8);  // also the birth count
  const bool alive = centre > 0.5f;
  const bool next = alive ? (tap >= lo && tap <= hi) : (tap == hi);
  return next ? 1.0f : 0.0f;
}

template <int G>
__device__ __forceinline__ float jacobi_rule(float centre, float tap) {
  constexpr double inv = 1.0 / (neighbours(G) + 1);
  return __double2float_rn(
      __dmul_rn(static_cast<double>(__fadd_rn(centre, tap)), inv));
}

// Wave leapfrog: lap = tap_u - n*u with n*u subtracted as power-of-two
// multiples in descending order; v' = v + 2^-5 * lap; u' = u + v'.
template <int G>
__device__ __forceinline__ void wave_rule(float u, float v, float tap_u,
                                          float* u2, float* v2) {
  constexpr int n = neighbours(G);
  constexpr int top = top_bit(n);
  float lap = tap_u;
  int rem = n;
#pragma unroll
  for (int bit = top; bit; bit >>= 1) {
    if (rem >= bit) {
      lap = __fsub_rn(lap, __fmul_rn(static_cast<float>(bit), u));
      rem -= bit;
    }
  }
  const float vn = __fadd_rn(v, __fmul_rn(0.03125f, lap));
  *v2 = vn;
  *u2 = __fadd_rn(u, vn);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Entry t < 33 of block b's table row: neighbour id t (t < 27) or face
// flag t - 27 (0 without a flag table: every axis periodic).
__device__ __forceinline__ int table_entry(const int* __restrict__ nbr,
                                           const int* __restrict__ bnd, int b,
                                           int t) {
  if (t < 27) return __ldg(nbr + static_cast<int64_t>(b) * 27 + t);
  return bnd ? __ldg(bnd + static_cast<int64_t>(b) * 6 + t - 27) : 0;
}

__device__ __forceinline__ void put_entry(int* row, int t, int v, int nb_src) {
  if (t < 27 && (v < 0 || v >= nb_src)) __trap();  // a table that does not fit the store
  row[t] = v;
}

// Issue the cp.async copies of one block's window into buf: the piece at
// offset (a, b, c) of OFFSETS_FULL reads, per axis, the neighbour's last H
// planes (low), its full T (centre) or its first H (high), as
// ref.assemble_halo_ref. Each copy stays inside one piece's row.
template <int C, int G, int T, int S>
__device__ __forceinline__ void stage_window(float* buf,
                                             const float* __restrict__ store,
                                             const int* s_nbr, int nb_src) {
  using Sh = Shape<C, G, T, S>;
  constexpr int H = Sh::H, P = Sh::P, T3 = T * T * T;
  constexpr int GE = H % 4 == 0 ? 4 : (H % 2 == 0 ? 2 : 1);  // floats a copy
  constexpr int CPR = P / GE;
  constexpr int N = C * P * P * CPR;
  for (int i = threadIdx.x; i < N; i += NT) {
    const int xc = i % CPR, row = i / CPR;
    const int y = row % P, cz = row / P;
    const int z = cz % P, c = cz / P;
    const int x = xc * GE;
    const int pa = z < H ? 0 : (z < H + T ? 1 : 2);
    const int pb = y < H ? 0 : (y < H + T ? 1 : 2);
    const int pc = x < H ? 0 : (x < H + T ? 1 : 2);
    const int sz = z - H + (pa == 0 ? T : (pa == 2 ? -T : 0));
    const int sy = y - H + (pb == 0 ? T : (pb == 2 ? -T : 0));
    const int sx = x - H + (pc == 0 ? T : (pc == 2 ? -T : 0));
    const int blk = s_nbr[pa * 9 + pb * 3 + pc];
    cp_async<4 * GE>(
        buf + ((c * P + z) * P + y) * P + x,
        store + (static_cast<int64_t>(c) * nb_src + blk) * T3 + (sz * T + sy) * T + sx);
  }
}

// apply_window_bc (kernels/rules.py) on the C-channel window of edge E
// (pitch P) before a substep: per clamped axis, k then i then j, the outer
// D layers of each flagged face take the dirichlet value or the adjacent
// in-domain plane (D, E-1-D). Low and high layers and the planes they copy
// from are disjoint, so one pass per axis suffices; the barrier between
// axes lets the next axis read corners the earlier one wrote.
template <int C, int P, int E, int D>
__device__ __forceinline__ void refresh_ghosts(float* buf, const Bc& bc,
                                               const int* flags) {
  constexpr int P2 = P * P, P3 = P2 * P;
  constexpr int N = C * 2 * D * E * E;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (bc.kind[ax] == BC_PERIODIC) continue;
    const bool lo = flags[2 * ax] != 0, hi = flags[2 * ax + 1] != 0;
    if (!lo && !hi) continue;  // uniform across the thread block
    const bool dir = bc.kind[ax] == BC_DIRICHLET;
    const float val = bc.value[ax];
    // the axis' stride, then those of the other two axes in k, i, j order
    const int s_ax = ax == 0 ? P2 : (ax == 1 ? P : 1);
    const int s_a = ax == 0 ? P : P2;
    const int s_b = ax == 2 ? P : 1;
    for (int i = threadIdx.x; i < N; i += NT) {
      const int b = i % E;
      int t = i / E;
      const int a = t % E;
      t /= E;
      const int l = t % D;
      t /= D;
      const int face = t % 2, c = t / 2;
      if (face == 0 ? !lo : !hi) continue;
      const int at = face == 0 ? l : E - 1 - l;
      const int from = face == 0 ? D : E - 1 - D;
      const int base = c * P3 + a * s_a + b * s_b;
      buf[base + at * s_ax] = dir ? val : buf[base + from * s_ax];
    }
    __syncthreads();
  }
}

// The instructions of one column of nz sites along k (times NX along j):
// its multiplies and adds, the shared loads of its nz + 2g planes (8
// bytes each), the rule and store of each site pair, its set-up.
__host__ __device__ constexpr int column_cost(int G, int nz) {
  const int K = 2 * G + 1;
  return nz * (2 * NX * K * K * K + 8) + (nz + 2 * G) * K * (NX + 2 * G) / 2 + 25;
}

// The rounds of nth columns (one a thread) that a substep of O^3 sites
// takes in columns nz deep (the last column of a ragged k extent moved back
// to end at O).
__host__ __device__ constexpr int column_rounds(int O, int nz, int nth) {
  return (((O + nz - 1) / nz) * O * (O / NX) + nth - 1) / nth;
}

// The column depth that makes a substep's slowest thread quickest: rounds
// times the cost of a column, the deepest on a tie (deeper columns share
// more loads); at most 8 for g = 1, 2 for g = 2 (registers).
__host__ __device__ constexpr int column_depth(int G, int O, int nth) {
  int best = 1;
  for (int nz = 2; nz <= (G == 1 ? 8 : 2) && nz <= O; ++nz)
    if (column_rounds(O, nz, nth) * column_cost(G, nz) <=
        column_rounds(O, best, nth) * column_cost(G, best))
      best = nz;
  return best;
}

// One substep: the O^3 sites of cur's window (edge O + 2G at the origin,
// pitch P) into nxt at the origin, by a thread block of NTH threads.
// Columns of NZ x NX sites; the last column of a ragged k extent is moved
// back to end at O (its overlap is computed twice and written twice,
// alike).
template <int RULE, int G, int P, int O, int NTH, int TAPS>
__device__ __forceinline__ void substep(const float* __restrict__ cur,
                                        float* __restrict__ nxt,
                                        const float (&w)[TAPS]) {
  constexpr int C = channels_of(RULE);
  constexpr int K = 2 * G + 1;
  constexpr int NZ = column_depth(G, O, NTH);
  constexpr int NZG = (O + NZ - 1) / NZ;
  constexpr int XG = O / NX;
  constexpr int NCOL = NZG * O * XG;
  constexpr int R = NX + 2 * G;
  constexpr int P2 = P * P, P3 = P2 * P;
  static_assert(O % NX == 0 && P % 2 == 0 && R % 2 == 0, "8-byte rows");
  for (int col = threadIdx.x; col < NCOL; col += NTH) {
    const int xg = col % XG, t = col / XG;
    const int y = t % O, zg = t / O;
    const int z0 = min(zg * NZ, O - NZ);
    const int off = z0 * P2 + y * P + xg * NX;
    const float* src = cur + off;
    float* dst = nxt + off;
    float acc[NZ][NX], ctr[NZ][NX];
#pragma unroll
    for (int j = 0; j < NZ; ++j)
#pragma unroll
      for (int x = 0; x < NX; ++x) acc[j][x] = 0.0f;
#pragma unroll
    for (int p = 0; p < NZ + 2 * G; ++p) {
      // plane z0 + p: its K rows y .. y+2G, columns xg*NX .. xg*NX+R-1
      float r[K][R];
#pragma unroll
      for (int di = 0; di < K; ++di)
#pragma unroll
        for (int q = 0; q < R; q += 2) {
          const float2 v = *reinterpret_cast<const float2*>(src + p * P2 + di * P + q);
          r[di][q] = v.x;
          r[di][q + 1] = v.y;
        }
      // into every accumulator for which this plane is tap row dk
#pragma unroll
      for (int j = 0; j < NZ; ++j) {
        const int dk = p - j;
        if (dk < 0 || dk >= K) continue;
#pragma unroll
        for (int di = 0; di < K; ++di)
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const float wt = w[(dk * K + di) * K + dj];
#pragma unroll
            for (int x = 0; x < NX; ++x)
              acc[j][x] = __fadd_rn(acc[j][x], __fmul_rn(wt, r[di][x + dj]));
          }
      }
      if (p >= G && p - G < NZ) {  // the sites' own values, for the rule
#pragma unroll
        for (int x = 0; x < NX; ++x) ctr[p - G][x] = r[G][x + G];
      }
      if (p >= 2 * G) {  // site row j has all its taps: the rule, the store
        const int j = p - 2 * G;
        float o[C][NX];
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          if constexpr (RULE == RULE_WAVE) {
            // the rule reads u's tap sum only; v's is never computed
            const float v = src[P3 + (j + G) * P2 + G * P + G + x];
            wave_rule<G>(ctr[j][x], v, acc[j][x], &o[0][x], &o[C - 1][x]);
          } else if constexpr (RULE == RULE_GOL) {
            o[0][x] = gol_rule<G>(ctr[j][x], acc[j][x]);
          } else if constexpr (RULE == RULE_JACOBI) {
            o[0][x] = jacobi_rule<G>(ctr[j][x], acc[j][x]);
          } else {
            o[0][x] = acc[j][x];
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          *reinterpret_cast<float2*>(dst + c * P3 + j * P2) =
              make_float2(o[c][0], o[c][1]);
      }
    }
  }
}

// Substeps U .. S-1 from cur (ping-pong with nxt); returns the buffer that
// holds the block's T^3 result at the origin.
template <int RULE, int G, int T, int S, int U, int TAPS>
__device__ __forceinline__ const float* substeps(float* cur, float* nxt,
                                                 const float (&w)[TAPS],
                                                 const Bc& bc, const int* flags) {
  if constexpr (U == S) {
    return cur;
  } else {
    constexpr int P = Shape<channels_of(RULE), G, T, S>::P;
    constexpr int D = G * (S - U);  // ghost depth before this substep
    constexpr int E = T + 2 * D;    // window edge before it
    refresh_ghosts<channels_of(RULE), P, E, D>(cur, bc, flags);
    substep<RULE, G, P, E - 2 * G, NT>(cur, nxt, w);
    __syncthreads();
    return substeps<RULE, G, T, S, U + 1>(nxt, cur, w, bc, flags);
  }
}

template <int C, int T, int P>
__device__ __forceinline__ void write_block(const float* fin,
                                            float* __restrict__ out, int b,
                                            int out_nb) {
  constexpr int VW = P % 4 == 0 ? 4 : 2;  // floats a store
  constexpr int VPR = T / VW;
  constexpr int N = C * T * T * VPR;
  constexpr int T3 = T * T * T;
  for (int i = threadIdx.x; i < N; i += NT) {
    const int xv = i % VPR, r = i / VPR;
    const int y = r % T, cz = r / T;
    const int z = cz % T, c = cz / T;
    const float* s = fin + ((c * P + z) * P + y) * P + xv * VW;
    float* d = out + (static_cast<int64_t>(c) * out_nb + b) * T3 +
               (z * T + y) * T + xv * VW;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
    } else {
      *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(s);
    }
  }
}

// Thread block i computes output blocks [nb*i/grid, nb*(i+1)/grid). The
// dynamic shared memory holds the current window, its substep partner and,
// when the run has a next block, that block's window.
template <int RULE, int G, int T, int S>
__global__ void __launch_bounds__(NT, G == 1 ? 5 : 1)
fused_sm90_kernel(const float* __restrict__ store, float* __restrict__ out,
                  const float* __restrict__ weights, const int* __restrict__ nbr,
                  const int* __restrict__ bnd, int nb, int nb_src, int out_nb,
                  Bc bc) {
  constexpr int C = channels_of(RULE);
  using Sh = Shape<C, G, T, S>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tab[2][TABLE_INTS];

  const int begin = static_cast<int>(static_cast<int64_t>(nb) * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<int64_t>(nb) * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  const int t = threadIdx.x;

  float w[Sh::TAPS];
#pragma unroll
  for (int i = 0; i < Sh::TAPS; ++i) w[i] = __ldg(weights + i);

  float* win = smem;
  float* alt = smem + Sh::BUF;
  float* stg = smem + 2 * Sh::BUF;

  if (t < TABLE_INTS) put_entry(s_tab[0], t, table_entry(nbr, bnd, begin, t), nb_src);
  int ahead = t < TABLE_INTS && begin + 1 < end ? table_entry(nbr, bnd, begin + 1, t) : 0;
  __syncthreads();
  stage_window<C, G, T, S>(win, store, s_tab[0], nb_src);
  cp_async_commit();

  for (int b = begin; b < end; ++b) {
    const int k = (b - begin) & 1;
    if (b + 1 < end) {
      if (t < TABLE_INTS) {
        put_entry(s_tab[k ^ 1], t, ahead, nb_src);
        if (b + 2 < end) ahead = table_entry(nbr, bnd, b + 2, t);
      }
      __syncthreads();
      stage_window<C, G, T, S>(stg, store, s_tab[k ^ 1], nb_src);
      cp_async_commit();
      cp_async_wait<1>();  // this block's window; the next one's may fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* fin = substeps<RULE, G, T, S, 0>(win, alt, w, bc, s_tab[k] + 27);
    write_block<C, T, Sh::P>(fin, out, b, out_nb);
    __syncthreads();
    float* done = win;
    win = stg;
    stg = done;
  }
}

struct Args {
  const float* store;
  float* out;
  const float* w;
  const int* nbr;
  const int* bnd;
  int nb, nb_src, out_nb;
  Bc bc;
  int overlap;
  cudaStream_t stream;
};

// Two ways to run an instance. With the overlap: as many persistent
// thread blocks as fit on the card at once, three windows each. Without
// it: one thread block per output block, two windows, no prefetch (the
// hardware's own scheduling then overlaps one block's gather with
// another's arithmetic). overlap < 0 takes the overlap exactly when its
// third window costs no thread block per SM (the occupancy calculator's
// counts for both, cached per device): on shapes bound by their
// instructions a thread block more per SM is worth more than a prefetch.
template <int RULE, int G, int T, int S>
cudaError_t launch(const Args& a) {
  if constexpr (!fits<channels_of(RULE), G, T, S>()) {
    return cudaErrorInvalidValue;
  } else {
    using Sh = Shape<channels_of(RULE), G, T, S>;
    auto kern = fused_sm90_kernel<RULE, G, T, S>;
    constexpr int MAX_DEVICES = 64;
    // per device: SMs, thread blocks per SM with three and with two windows
    static int occupancy[MAX_DEVICES][3];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    int* occ = occupancy[dev];
    if (occ[0] == 0) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sizeof(float) * 3 * Sh::BUF));
      if (err != cudaSuccess) return err;
      int sms = 0, with3 = 0, with2 = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &with3, kern, NT, sizeof(float) * 3 * Sh::BUF)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &with2, kern, NT, sizeof(float) * 2 * Sh::BUF)) != cudaSuccess)
        return err;
      if (with3 < 1) return cudaErrorInvalidConfiguration;
      occ[1] = with3;
      occ[2] = with2;
      occ[0] = sms;
    }
    const bool overlap = a.overlap < 0 ? occ[1] >= occ[2] : a.overlap != 0;
    const size_t smem = sizeof(float) * (overlap ? 3 : 2) * Sh::BUF;
    const int grid = overlap && a.nb > occ[0] * occ[1] ? occ[0] * occ[1] : a.nb;
    kern<<<grid, NT, smem, a.stream>>>(a.store, a.out, a.w, a.nbr, a.bnd, a.nb,
                                      a.nb_src, a.out_nb, a.bc);
    return cudaGetLastError();
  }
}

template <int RULE, int G, int T>
cudaError_t dispatch_s(int S, const Args& a) {
  switch (S) {
    case 1: return launch<RULE, G, T, 1>(a);
    case 2: return launch<RULE, G, T, 2>(a);
    case 4: return launch<RULE, G, T, 4>(a);
    case 8: return launch<RULE, G, T, 8>(a);
    case 16: return launch<RULE, G, T, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int RULE>
cudaError_t dispatch(int T, int g, int S, const Args& a) {
  if (T == 8 && g == 1) return dispatch_s<RULE, 1, 8>(S, a);
  if (T == 8 && g == 2) return dispatch_s<RULE, 2, 8>(S, a);
  if (T == 16 && g == 1) return dispatch_s<RULE, 1, 16>(S, a);
  if (T == 16 && g == 2) return dispatch_s<RULE, 2, 16>(S, a);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The group design: one thread block steps an aligned 2x2x2 group of T = 8
// store blocks as one tile of edge 2T over the periodic resident cube. Its
// window has edge P = 2T + 2Sg (24 at S = 4, g = 1), so the substeps
// compute O^3 = 22^3, 20^3, 18^3, 16^3 sites for the 16^3 it keeps: 1.74x
// the function's work where one block's window computes 2.92x. The window
// is cut from the 4x4x4 blocks around the group, whose ids (and the
// group's 8 output ids) are one row of the host's group table
// (core/neighbors.group_table); the substeps are the same register-tiled
// substep() at NTG threads.

constexpr int NTG = 512;             // threads per thread block of the group design
constexpr int GROUP_WIN = 64;        // a group row: its 4x4x4 window blocks,
constexpr int GROUP_INTS = 72;       // then its 8 output blocks

// Two windows (current and substep partner), the two table rows, and a
// third window (the next group's, prefetched) where it fits and is taken;
// kernels/stencil3d.group_smem_bytes is the same model.
template <int C, int G, int T, int S>
__host__ __device__ constexpr long long group_bytes(int windows) {
  return windows * 4LL * Shape<C, G, 2 * T, S>::BUF + 2 * GROUP_INTS * 4;
}

// The instances: T = 8, a recomputed halo (S*g >= 2), S*g | T, two windows.
template <int C, int G, int T, int S>
__host__ __device__ constexpr bool group_fits() {
  return T == 8 && S * G >= 2 && T % (S * G) == 0 &&
         group_bytes<C, G, T, S>(2) <= SMEM_LIMIT;
}

template <int C, int G, int T, int S>
__host__ __device__ constexpr bool group_prefetches() {
  return group_bytes<C, G, T, S>(3) <= SMEM_LIMIT;
}

__device__ __forceinline__ void put_id(int* row, int t, int v, int nb_src) {
  if (v < 0 || v >= nb_src) __trap();  // a group table that does not fit the store
  row[t] = v;
}

// Issue the cp.async copies of one group's window into buf: per axis the
// window is the last H planes of window block 0, all T of blocks 1 and 2
// and the first H of block 3 (stage_window's pieces, one block wider).
template <int C, int G, int T, int S>
__device__ __forceinline__ void stage_group(float* buf,
                                            const float* __restrict__ store,
                                            const int* s_ids, int nb_src) {
  using Sh = Shape<C, G, 2 * T, S>;
  constexpr int H = Sh::H, P = Sh::P, T3 = T * T * T;
  constexpr int GE = H % 4 == 0 ? 4 : (H % 2 == 0 ? 2 : 1);  // floats a copy
  constexpr int CPR = P / GE;
  constexpr int N = C * P * P * CPR;
  for (int i = threadIdx.x; i < N; i += NTG) {
    const int xc = i % CPR, row = i / CPR;
    const int y = row % P, cz = row / P;
    const int z = cz % P, c = cz / P;
    const int x = xc * GE;
    const int pa = z < H ? 0 : (z - H) / T + 1;  // 0 .. 3
    const int pb = y < H ? 0 : (y - H) / T + 1;
    const int pc = x < H ? 0 : (x - H) / T + 1;
    const int sz = z - H - (pa - 1) * T;
    const int sy = y - H - (pb - 1) * T;
    const int sx = x - H - (pc - 1) * T;
    const int blk = s_ids[(pa * 4 + pb) * 4 + pc];
    cp_async<4 * GE>(
        buf + ((c * P + z) * P + y) * P + x,
        store + (static_cast<int64_t>(c) * nb_src + blk) * T3 + (sz * T + sy) * T + sx);
  }
}

// Substeps U .. S-1 of a group's tile (edge TT = 2T) from cur, ping-pong
// with nxt; returns the buffer that holds the (TT)^3 result at the origin.
template <int RULE, int G, int TT, int S, int U, int TAPS>
__device__ __forceinline__ float* group_substeps(float* cur, float* nxt,
                                                       const float (&w)[TAPS]) {
  if constexpr (U == S) {
    return cur;
  } else {
    constexpr int P = TT + 2 * S * G;
    substep<RULE, G, P, TT + 2 * G * (S - U - 1), NTG>(cur, nxt, w);
    __syncthreads();
    return group_substeps<RULE, G, TT, S, U + 1>(nxt, cur, w);
  }
}

// The tile's result (edge 2T at fin's origin, pitch P) into its 8 output
// blocks, the ids s_out[(dk * 2 + di) * 2 + dj].
template <int C, int T, int P>
__device__ __forceinline__ void write_group(const float* fin,
                                            float* __restrict__ out,
                                            const int* s_out, int out_nb) {
  constexpr int TT = 2 * T, VW = 4;  // floats a store
  constexpr int VPR = TT / VW;
  constexpr int N = C * TT * TT * VPR;
  constexpr int T3 = T * T * T;
  static_assert(P % VW == 0 && T % VW == 0, "16-byte rows");
  for (int i = threadIdx.x; i < N; i += NTG) {
    const int xv = i % VPR, r = i / VPR;
    const int y = r % TT, cz = r / TT;
    const int z = cz % TT, c = cz / TT;
    const int x = xv * VW;
    const int b = s_out[((z / T) * 2 + y / T) * 2 + x / T];
    const float* s = fin + ((c * P + z) * P + y) * P + x;
    float* d = out + (static_cast<int64_t>(c) * out_nb + b) * T3 +
               ((z % T) * T + y % T) * T + x % T;
    *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(s);
  }
}

// Thread block i steps groups [ng*i/grid, ng*(i+1)/grid) of the table, one
// thread block an SM. With prefetch (where a third window fits) the next
// group's window streams in while this group's substeps run; else it
// streams into the buffer the result does not occupy while the result is
// written.
template <int RULE, int G, int T, int S>
__global__ void __launch_bounds__(NTG, 1)
fused_group_sm90_kernel(const float* __restrict__ store, float* __restrict__ out,
                        const float* __restrict__ weights,
                        const int* __restrict__ groups, int ng, int nb_src,
                        int out_nb, bool prefetch) {
  constexpr int C = channels_of(RULE);
  using Sh = Shape<C, G, 2 * T, S>;
  constexpr bool PREFETCH = group_prefetches<C, G, T, S>();
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tab[2][GROUP_INTS];

  const int begin = static_cast<int>(static_cast<int64_t>(ng) * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(static_cast<int64_t>(ng) * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  const int t = threadIdx.x;

  float w[Sh::TAPS];
#pragma unroll
  for (int i = 0; i < Sh::TAPS; ++i) w[i] = __ldg(weights + i);

  float* win = smem;
  float* alt = smem + Sh::BUF;
  float* stg = smem + 2 * Sh::BUF;  // used only with prefetch
  auto row = [&](int gi) {
    return __ldg(groups + static_cast<int64_t>(gi) * GROUP_INTS + t);
  };

  if (t < GROUP_INTS) put_id(s_tab[0], t, row(begin), nb_src);
  int ahead = t < GROUP_INTS && begin + 1 < end ? row(begin + 1) : 0;
  __syncthreads();
  stage_group<C, G, T, S>(win, store, s_tab[0], nb_src);
  cp_async_commit();

  for (int gi = begin; gi < end; ++gi) {
    const int k = (gi - begin) & 1;
    const bool more = gi + 1 < end;
    if (more && t < GROUP_INTS) {
      put_id(s_tab[k ^ 1], t, ahead, nb_src);
      if (gi + 2 < end) ahead = row(gi + 2);
    }
    if (PREFETCH && prefetch) {
      if (more) {
        __syncthreads();
        stage_group<C, G, T, S>(stg, store, s_tab[k ^ 1], nb_src);
        cp_async_commit();
        cp_async_wait<1>();  // this group's window; the next one's may fly
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* fin = group_substeps<RULE, G, 2 * T, S, 0>(win, alt, w);
      write_group<C, T, Sh::P>(fin, out, s_tab[k] + GROUP_WIN, out_nb);
      __syncthreads();
      float* done = win;
      win = stg;
      stg = done;
    } else {
      cp_async_wait<0>();
      __syncthreads();
      float* fin = group_substeps<RULE, G, 2 * T, S, 0>(win, alt, w);
      float* next = fin == win ? alt : win;
      if (more) {
        stage_group<C, G, T, S>(next, store, s_tab[k ^ 1], nb_src);
        cp_async_commit();
      }
      write_group<C, T, Sh::P>(fin, out, s_tab[k] + GROUP_WIN, out_nb);
      __syncthreads();
      win = next;
      alt = fin;
    }
  }
}

struct GroupArgs {
  const float* store;
  float* out;
  const float* w;
  const int* groups;
  int ng, nb_src, out_nb;
  int overlap;
  cudaStream_t stream;
};

// As many persistent thread blocks as the card holds at once (one an SM,
// with two windows or three: the registers of 512 threads allow no
// second), or one a group where there are fewer groups. overlap < 0
// prefetches wherever a third window fits, 0 never, 1 always (refused
// where it does not fit).
template <int RULE, int G, int T, int S>
cudaError_t launch_group(const GroupArgs& a) {
  constexpr int C = channels_of(RULE);
  if constexpr (!group_fits<C, G, T, S>()) {
    return cudaErrorInvalidValue;
  } else {
    constexpr bool FITS3 = group_prefetches<C, G, T, S>();
    if (a.overlap > 0 && !FITS3) return cudaErrorInvalidValue;
    const bool prefetch = FITS3 && a.overlap != 0;
    auto kern = fused_group_sm90_kernel<RULE, G, T, S>;
    constexpr int MAX_DEVICES = 64;
    constexpr size_t smax = sizeof(float) * (FITS3 ? 3 : 2) * Shape<C, G, 2 * T, S>::BUF;
    const size_t smem = sizeof(float) * (prefetch ? 3 : 2) * Shape<C, G, 2 * T, S>::BUF;
    static int resident[MAX_DEVICES];  // thread blocks the card holds at once
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smax));
      if (err != cudaSuccess) return err;
      int sms = 0, per = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, NTG, smax)) !=
              cudaSuccess)
        return err;
      if (per < 1) return cudaErrorInvalidConfiguration;
      resident[dev] = sms * per;
    }
    const int grid = a.ng < resident[dev] ? a.ng : resident[dev];
    kern<<<grid, NTG, smem, a.stream>>>(a.store, a.out, a.w, a.groups, a.ng,
                                        a.nb_src, a.out_nb, prefetch);
    return cudaGetLastError();
  }
}

template <int RULE>
cudaError_t dispatch_group(int T, int g, int S, const GroupArgs& a) {
  if (T != 8) return cudaErrorInvalidValue;
  if (g == 1 && S == 2) return launch_group<RULE, 1, 8, 2>(a);
  if (g == 1 && S == 4) return launch_group<RULE, 1, 8, 4>(a);
  if (g == 2 && S == 1) return launch_group<RULE, 2, 8, 1>(a);
  if (g == 2 && S == 2) return launch_group<RULE, 2, 8, 2>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// S fused timesteps: store f32 (C, nb_src, T,T,T) -> out f32 (C, nb, T,T,T)
// (C = 2 for wave, else 1), whose channels lie out_nb >= nb blocks apart;
// nbr int32 (nb, 27); bnd int32 (nb, 6) or null when every axis is
// periodic; bc_* per axis k, i, j. store and out 16-byte aligned.
// overlap: 1 with, 0 without, -1 as the occupancy decides (launch()). An
// instance this design does not take returns cudaErrorInvalidValue.
int repro_stencil_step_fused_sm90_f32(const void* store, void* out,
                                      const void* w, const void* nbr,
                                      const void* bnd, int nb, int nb_src,
                                      int out_nb, int T, int g, int S,
                                      int rule, int bc_k, int bc_i, int bc_j,
                                      float val_k, float val_i, float val_j,
                                      int overlap, void* stream) {
  const Args a = {static_cast<const float*>(store), static_cast<float*>(out),
                  static_cast<const float*>(w), static_cast<const int*>(nbr),
                  static_cast<const int*>(bnd), nb, nb_src, out_nb,
                  {{bc_k, bc_i, bc_j}, {val_k, val_i, val_j}}, overlap,
                  static_cast<cudaStream_t>(stream)};
  switch (rule) {
    case RULE_GOL: return dispatch<RULE_GOL>(T, g, S, a);
    case RULE_JACOBI: return dispatch<RULE_JACOBI>(T, g, S, a);
    case RULE_IDENTITY: return dispatch<RULE_IDENTITY>(T, g, S, a);
    case RULE_WAVE: return dispatch<RULE_WAVE>(T, g, S, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The f32 tap sum over the periodic store: the S = 1 identity case.
// store (nb, T,T,T), nbr (nb, 27) -> out (nb, T,T,T).
int repro_stencil_sum_resident_sm90_f32(const void* store, void* out,
                                        const void* w, const void* nbr, int nb,
                                        int T, int g, int overlap,
                                        void* stream) {
  const Args a = {static_cast<const float*>(store), static_cast<float*>(out),
                  static_cast<const float*>(w), static_cast<const int*>(nbr),
                  nullptr, nb, nb, nb,
                  {{BC_PERIODIC, BC_PERIODIC, BC_PERIODIC}, {0.f, 0.f, 0.f}},
                  overlap, static_cast<cudaStream_t>(stream)};
  return dispatch<RULE_IDENTITY>(T, g, 1, a);
}

// S fused timesteps of the group design over the periodic resident cube:
// store f32 (C, nb_src, T,T,T) -> out f32 (C, nb_src, T,T,T), channels
// out_nb >= nb_src blocks apart; groups int32 (ng, 72), one row a group
// (its 4x4x4 window blocks, then its 8 output blocks; every block an
// output of one row). store and out 16-byte aligned. overlap: 1 prefetches
// the next group's window beside the substeps, 0 streams it in while the
// result is written, -1 prefetches where a third window fits
// (launch_group()). An instance this design does not take returns
// cudaErrorInvalidValue.
int repro_stencil_step_fused_group_sm90_f32(const void* store, void* out,
                                            const void* w, const void* groups,
                                            int ng, int nb_src, int out_nb,
                                            int T, int g, int S, int rule,
                                            int overlap, void* stream) {
  const GroupArgs a = {static_cast<const float*>(store), static_cast<float*>(out),
                       static_cast<const float*>(w), static_cast<const int*>(groups),
                       ng, nb_src, out_nb, overlap, static_cast<cudaStream_t>(stream)};
  switch (rule) {
    case RULE_GOL: return dispatch_group<RULE_GOL>(T, g, S, a);
    case RULE_JACOBI: return dispatch_group<RULE_JACOBI>(T, g, S, a);
    case RULE_IDENTITY: return dispatch_group<RULE_IDENTITY>(T, g, S, a);
    case RULE_WAVE: return dispatch_group<RULE_WAVE>(T, g, S, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
