// Trellis quantisation: the batched 9-state CABAC-cost Viterbi over the
// zigzag levels of each block, for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/trellis.py::trellis_quant.  This kernel has
// no TPU counterpart: the reference runs the Viterbi as XLA (an unrolled
// lax.scan of ~40 array operations per step and a scan backtrack), which
// eager PyTorch would pay for with one launch per operation (~700 per call
// at 16 positions, ~2800 at 64).  Its plain twin, bit for bit, is
// x264_tpu_torch/ops/trellis.py::trellis_quant_plain.
//
// Bound on the H100: the bytes (coefficients and dq in, levels out, 12 per
// coefficient) against the Viterbi's float operations (kernels/trellis.py
// counts both); at 1080p 4x4 luma, 130560 blocks x 16 positions, both are a
// few microseconds.  A block's steps are a dependent chain, so the kernel
// needs many blocks in flight to reach that rate, and the calls come in two
// sizes: a P or B frame's (32640-130560 blocks) and the I wavefront's (at
// most 960 per launch, 508 launches per 1080p I4x4 IDR).  Two layouts,
// chosen by the launcher from the block count (trellis_auto_layout):
//
// - Thread per block (trellis_tall), for the large calls: a CTA stages its
//   blocks' coefficients and dq through shared memory with asynchronous
//   4-byte copies (coalesced, none waiting for another; rows padded to an
//   odd stride, so that the per-thread column reads hit distinct banks).
//   A step computes only the moves that can be finite (kCand: 36 of the
//   45, 27 comparisons instead of 44), with the per-state constants in
//   registers and the next step's per-block terms issued ahead of this
//   step's comparisons; each step's back-pointers are one 16-bit word
//   per block in shared memory; the seed levels overwrite the staged
//   coefficients and the final levels the seeds, which go back to device
//   memory with coalesced stores.
// - Lanes per state (trellis_wide), for the small calls: 16 lanes per
//   block, so the I wavefront's 960 blocks fill 480 warps instead of 30.
//   A prologue computes each step's per-block terms (seed, distortions,
//   escape costs) on all lanes at once; then per step lane s computes the
//   five moves out of source state s into shared memory (lcg from a
//   per-call table unless a warp holds an escape level), and lane t takes
//   the first minimum of target t's group (target 4's 13 columns split
//   over lanes 4 and 9, joined by a shuffle).  The 45 candidates are (move,
//   source) pairs whose move differs by target, so they pass through shared
//   memory rather than shuffles.  Instead of back-pointers and a serial
//   backtrack, each lane carries the path of move kinds into its state (2
//   bits a step, in registers), taking its source's path by a shuffle; the
//   final state's path gives every level at once.
//   The launcher takes this layout up to kWideMax blocks (kWideMax64 at
//   nc 64), where tools/nxn_trellis_bench.py's sweep on an H100 found it
//   the faster one: up to 4096 blocks of 15 or 16 (thread per block from
//   8160 on), up to 2048 blocks of 64 (thread per block from 4080 on).
//
// Float semantics follow the twin exactly, which follows XLA's CPU code:
// __fmaf_rn at the three sites XLA contracts (the level error c - a*dq, the
// first step's |coef|*k - a*dq, and the level-bin count of lcg), and
// __fmul_rn / __fadd_rn / __fdiv_rn everywhere else, so that nvcc's
// --fmad=true cannot contract anything.  Each target's first minimum is
// taken over its group in column order with a strict <, then the dummy
// column 45 (cost BIG) where the group is shorter than kGroupMax.  The
// escape length is an exact integer bit length (__clz).  Both layouts do
// the same float operations on the same operands for every move that can
// be finite, and so reach the same levels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNc = 64;
constexpr float kBig = 1e30f;
constexpr int kGroupMax = 13;
// block counts up to these take the lanes-per-state layout
constexpr int kWideMax = 4096;
constexpr int kWideMax64 = 2048;

// Layout of the per-call parameter block (kernels/trellis.py packs it):
// per position p < nc - 1: sig0, fl, fm; per state (9): lc1, b0e1, gt1e0,
// gt1e1, fin; then byp; per position p < nc: k, w.
struct Params {
  const float *sig0, *fl, *fm, *lc1, *b0e1, *gt1e0, *gt1e1, *fin, *k, *w;
  float byp;
};

__device__ __forceinline__ Params unpack(const float* s, int nc) {
  Params p;
  const int m = nc - 1;
  p.sig0 = s;
  p.fl = s + m;
  p.fm = s + 2 * m;
  p.lc1 = s + 3 * m;
  p.b0e1 = p.lc1 + 9;
  p.gt1e0 = p.lc1 + 18;
  p.gt1e1 = p.lc1 + 27;
  p.fin = p.lc1 + 36;
  p.byp = s[3 * m + 45];
  p.k = s + 3 * m + 46;
  p.w = p.k + nc;
  return p;
}

__host__ __device__ constexpr int params_len(int nc) {
  return 3 * (nc - 1) + 46 + 2 * nc;
}

// The 45 (move, source) transitions grouped by target state: column =
// move * 9 + source (move 0 level 0, 1 a1 == 1, 2 a1 > 1, 3 a2 == 1,
// 4 a2 > 1); a group shorter than kGroupMax ends with the dummy column 45
// (cost BIG, source 8, kind 0).  Mirrors ops/trellis.py GROUP_IDX.  Called
// with constant arguments only (unrolled loops), so the tables fold away.
__host__ __device__ constexpr int group_len(int t) {
  constexpr int kGroupLen[9] = {1, 5, 3, 5, 13, 5, 5, 7, 1};
  return kGroupLen[t];
}

__host__ __device__ constexpr int group_col(int t, int g) {
  constexpr int kGroupCol[9][kGroupMax] = {
      {0},
      {1, 9, 17, 27, 35},
      {2, 10, 28},
      {3, 11, 12, 29, 30},
      {4, 13, 18, 19, 20, 21, 26, 31, 36, 37, 38, 39, 44},
      {5, 14, 22, 32, 40},
      {6, 15, 23, 33, 41},
      {7, 16, 24, 25, 34, 42, 43},
      {8},
  };
  return kGroupCol[t][g];
}

// back-pointer byte of a column: source state | move kind << 4
__host__ __device__ constexpr int col_code(int col) {
  const int move = col / 9;
  return col == 45 ? 8 : (col % 9) | ((move == 0 ? 0 : move <= 2 ? 1 : 2) << 4);
}

// The thread-per-block layout keeps only the moves that can be finite.
// Per step at most two of moves 1-4 are allowed (a1 == 1: move 1;
// a1 == 2: moves 2 and 3; a1 >= 3: moves 2 and 4), and the rest cost BIG.
// A state whose best cost is below BIG (every state on the final path:
// the unstarted state's costs are finite, and its path's sources are
// finite too) takes its first minimum among the allowed columns, so a
// state keeps, in column order, the moves of four kinds: 0 level 0 from
// itself (move 0), 1 the level a1 > 1 (move 2), 2 the level 1 (move 1
// when a1 == 1, move 3 when a2 == 1), 3 the level a2 > 1 (move 4), with
// the sources that enter it by TRANS_GT1 (kinds 1, 3) or TRANS_EQ1 (kind
// 2).  kCand lists them as kind << 4 | source, in the group's column order
// for every a1 (tests/test_torch_kernel_layouts.py checks it against
// GROUP_IDX).  States at or above BIG may then differ from the twin's in
// cost and back-pointer; no path into a finite state goes through them,
// so the levels do not.
constexpr int kCandMax = 12;

__host__ __device__ constexpr int cand_len(int t) {
  constexpr int kCandLen[9] = {1, 3, 2, 3, 12, 4, 4, 6, 1};
  return kCandLen[t];
}

__host__ __device__ constexpr int cand(int t, int g) {
  constexpr int kCand[9][kCandMax] = {
      {0},
      {1, 32, 40},
      {2, 33},
      {3, 34, 35},
      {4, 16, 17, 18, 19, 24, 36, 48, 49, 50, 51, 56},
      {5, 20, 37, 52},
      {6, 21, 38, 53},
      {7, 22, 23, 39, 54, 55},
      {8},
  };
  return kCand[t][g];
}

// the back-pointer word: per target, the winner's place in its list, in
// cand_bits(t) bits at cand_shift(t)
__host__ __device__ constexpr int cand_bits(int t) {
  return cand_len(t) <= 1 ? 0 : cand_len(t) <= 2 ? 1
         : cand_len(t) <= 4 ? 2 : cand_len(t) <= 8 ? 3 : 4;
}

__host__ __device__ constexpr int cand_shift(int t) {
  int sh = 0;
  for (int i = 0; i < t; ++i) sh += cand_bits(i);
  return sh;
}

static_assert(cand_shift(8) + cand_bits(8) <= 16, "back-pointers fit 16 bits");

// the per-block terms of one step: the seed level, its two candidate
// levels a1 = lr and a2 = max(lr - 1, 0), the distortion of level 0 and of
// each candidate, and each candidate's escape cost (a >= 15)
struct StepTerms {
  int seed, a1, a2;
  float d0, da1, da2, esc1, esc2;
};

__device__ __forceinline__ StepTerms step_terms(int ci, float dq, int step,
                                                int p, const Params& P) {
  StepTerms s;
  const float cabs = __int2float_rn(abs(ci));
  const float kp = P.k[p], wp = P.w[p];
  const float c = __fmul_rn(cabs, kp);
  const int lr = (int)floorf(__fadd_rn(__fdiv_rn(c, dq), 0.5f));
  s.seed = (lr << 1) | (ci < 0);
  s.a1 = lr;
  s.a2 = max(lr - 1, 0);
  s.d0 = __fmul_rn(__fmul_rn(wp, c), c);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int a = j == 0 ? s.a1 : s.a2;
    const float af = __int2float_rn(a);
    const float e = step == 0
        ? __fmaf_rn(cabs, kp, -__fmul_rn(af, dq))
        : __fmaf_rn(-af, dq, c);
    const float da = __fmul_rn(__fmul_rn(wp, e), e);
    float esc = 0.0f;
    if (a >= 15) {
      const int len = 31 - __clz(a - 14);        // floor(log2(a - 14))
      esc = __fmul_rn(P.byp, __int2float_rn(2 * len + 1));
    }
    (j == 0 ? s.da1 : s.da2) = da;
    (j == 0 ? s.esc1 : s.esc2) = esc;
  }
  return s;
}

// the level of a back-pointer's move kind, signed by the seed
__device__ __forceinline__ int level_of(int kind, int seed) {
  const int lr = seed >> 1;
  const int lvl = kind == 1 ? lr : (kind == 2 ? max(lr - 1, 0) : 0);
  return (seed & 1) ? -lvl : lvl;
}

// The level-bin cost lcg of a level a >= 2 out of state s depends on a
// only through min(a, 15) and, from 15 on, the escape.  The lanes-per-
// state layout, whose steps wait on it, reads it from lcg_table: per call,
// row a holds it for a = 2..14 and row 15 the product term of the escape
// levels, to which lcg_of adds the escape and the bypass bin in the twin's
// order.  (In the thread-per-block layout the table was slower.)
constexpr int kLcgRows = 16;

__device__ __forceinline__ void lcg_table(float* tab, const Params& P,
                                          int tid, int nthreads) {
  for (int i = tid; i < kLcgRows * 9; i += nthreads) {
    const int a = i / 9, s = i - 9 * (i / 9);
    const float mm2 = __fadd_rn(fminf(__int2float_rn(a), 15.0f), -2.0f);
    const float fma = __fmaf_rn(mm2, P.gt1e1[s], P.b0e1[s]);
    tab[i] = a < 15 ? __fadd_rn(__fadd_rn(fma, P.gt1e0[s]), P.byp) : fma;
  }
}

// kEscape: some level of the warp's blocks at this step is >= 15 (a
// warp-uniform choice); rows 0 and 1 are read for a <= 1 and unused
template <bool kEscape>
__device__ __forceinline__ float lcg_of(int a, float esc, int s,
                                        const float* tab, const Params& P) {
  if (kEscape && a >= 15)
    return __fadd_rn(__fadd_rn(tab[15 * 9 + s], esc), P.byp);
  return tab[min(a, 15) * 9 + s];
}

// the five moves out of source state s: mc[m] = the path cost through
// column m * 9 + s
template <bool kEscape>
__device__ __forceinline__ void moves_from(float mc[5], float cost, int s,
                                           int step, int p, const Params& P,
                                           const StepTerms& st,
                                           const float* lcg) {
  const float flv = step == 0 ? (s < 8 ? kBig : 0.0f)
                              : (s < 8 ? P.fm[p] : P.fl[p]);
  const float sig0v = step == 0 ? 0.0f : (s < 8 ? P.sig0[p] : 0.0f);
  mc[0] = __fadd_rn(__fadd_rn(cost, st.d0), sig0v);
  const float base_e = __fadd_rn(cost, __fadd_rn(flv, P.lc1[s]));
  const float gt_base = __fadd_rn(cost, flv);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int a = j == 0 ? st.a1 : st.a2;
    const float da = j == 0 ? st.da1 : st.da2;
    const float lc = lcg_of<kEscape>(a, j == 0 ? st.esc1 : st.esc2, s, lcg,
                                     P);
    mc[1 + 2 * j] = a == 1 ? __fadd_rn(base_e, da) : kBig;
    mc[2 + 2 * j] = a > 1 ? __fadd_rn(__fadd_rn(gt_base, lc), da) : kBig;
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Stage rows b0 .. b0 + nb - 1 of coefs and dq into shared memory at row
// stride S, with asynchronous copies that do not wait for each other;
// rows nb .. rows - 1 get zeros (dq 1), which compute a level-0 path.
template <int NC, int S>
__device__ __forceinline__ void stage_rows(int* sc, float* sd,
                                           const int* coefs, const float* dqs,
                                           size_t b0, int nb, int rows,
                                           int tid, int nthreads) {
  for (int i = tid; i < rows * NC; i += nthreads) {
    const int r = i / NC, q = i - r * NC;
    if (r < nb) {
      cp_async4(sc + r * S + q, coefs + b0 * NC + i);
      cp_async4(sd + r * S + q, dqs + b0 * NC + i);
    } else {
      sc[r * S + q] = 0;
      sd[r * S + q] = 1.0f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- thread per block ----
template <int NC>
struct Tall {
  static constexpr int kThreads = NC == kMaxNc ? 32 : 128;
  static constexpr int kStride = NC | 1;   // odd: conflict-free columns
};

// Each target's first minimum over its kCand list, and the back-pointer
// word, unrolled by template recursion: the lists are constant
// expressions here, so the moves stay in registers.
template <int t, int g>
__device__ __forceinline__ void take_min(const float (&v)[4][9], float& best,
                                         int& pick) {
  if constexpr (g < cand_len(t)) {
    constexpr int c = cand(t, g);
    const float x = v[c >> 4][c & 15];
    if (x < best) {
      best = x;
      pick = g;
    }
    take_min<t, g + 1>(v, best, pick);
  }
}

template <int t>
__device__ __forceinline__ void first_mins(const float (&v)[4][9],
                                           float (&cost)[9], uint32_t& word) {
  constexpr int c = cand(t, 0);
  float best = v[c >> 4][c & 15];
  int pick = 0;
  take_min<t, 1>(v, best, pick);
  word |= (uint32_t)pick << cand_shift(t);
  cost[t] = best;   // read below only through v, already computed
  if constexpr (t + 1 < 9) first_mins<t + 1>(v, cost, word);
}

// the decode table: kCand by target, 16 places a target
template <int t, int g>
__device__ __forceinline__ void fill_cands(uint8_t* dec) {
  if constexpr (t < 9) {
    if constexpr (g < cand_len(t)) {
      dec[t * 16 + g] = (uint8_t)cand(t, g);
      fill_cands<t, g + 1>(dec);
    } else {
      fill_cands<t + 1, 0>(dec);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(Tall<NC>::kThreads)
trellis_tall(const int* __restrict__ coefs, const float* __restrict__ dqs,
             const float* __restrict__ params, int* __restrict__ out,
             int nblocks) {
  constexpr int T = Tall<NC>::kThreads, S = Tall<NC>::kStride;
  __shared__ float sp[params_len(NC)];
  __shared__ int sc[T * S];           // coefficients, then seeds, then levels
  __shared__ float sd[T * S];         // dq
  __shared__ uint16_t sbp[NC * T];    // back-pointer words, [step][thread]
  __shared__ uint8_t sdec[9 * 16];    // kCand by target and place
  const int tid = threadIdx.x;
  const size_t b0 = (size_t)blockIdx.x * T;
  const int nb = min(T, nblocks - (int)blockIdx.x * T);
  for (int i = tid; i < params_len(NC); i += T) cp_async4(sp + i, params + i);
  if (tid == 0) fill_cands<0, 0>(sdec);
  stage_rows<NC, S>(sc, sd, coefs, dqs, b0, nb, T, tid, T);
  __syncthreads();
  const Params P = unpack(sp, NC);
  float lc1[9], b0e1[9], gt1e0[9], gt1e1[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    lc1[s] = P.lc1[s];
    b0e1[s] = P.b0e1[s];
    gt1e0[s] = P.gt1e0[s];
    gt1e1[s] = P.gt1e1[s];
  }
  int* crow = sc + tid * S;
  const float* dqrow = sd + tid * S;
  float cost[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) cost[s] = s < 8 ? kBig : 0.0f;
  StepTerms st = step_terms(crow[NC - 1], dqrow[NC - 1], 0, NC - 1, P);
#pragma unroll 1
  for (int step = 0; step < NC; ++step) {
    const int p = NC - 1 - step;
    // the next step's terms do not wait for this step's costs
    const StepTerms nx = step + 1 < NC
        ? step_terms(crow[p - 1], dqrow[p - 1], step + 1, p - 1, P) : st;
    // step 0: significance inferred, no started source
    const float flv_s = step == 0 ? kBig : P.fm[p];   // started sources
    const float flv_u = step == 0 ? 0.0f : P.fl[p];   // the unstarted one
    const float sig0 = step == 0 ? 0.0f : P.sig0[p];
    // a move that is not allowed ends at BIG or above: its last term is
    // BIG instead of its distortion (the allowed ones add theirs)
    const float da_e = st.a1 == 1 ? st.da1 : st.a1 == 2 ? st.da2 : kBig;
    const float da_g = st.a1 > 1 ? st.da1 : kBig;
    const float da_g2 = st.a2 > 1 ? st.da2 : kBig;
    const float mm2a = __fadd_rn(fminf(__int2float_rn(st.a1), 15.0f), -2.0f);
    const float mm2b = __fadd_rn(fminf(__int2float_rn(st.a2), 15.0f), -2.0f);
    // the moves out of every state, by kind: v[kind][source]
    float v[4][9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      const float flv = s < 8 ? flv_s : flv_u;
      v[0][s] = __fadd_rn(__fadd_rn(cost[s], st.d0), s < 8 ? sig0 : 0.0f);
      const float base_e = __fadd_rn(cost[s], __fadd_rn(flv, lc1[s]));
      v[2][s] = __fadd_rn(base_e, da_e);
      const float gt_base = __fadd_rn(cost[s], flv);
      const float lcga = __fadd_rn(
          __fadd_rn(__fmaf_rn(mm2a, gt1e1[s], b0e1[s]),
                    st.a1 >= 15 ? st.esc1 : gt1e0[s]), P.byp);
      const float lcgb = __fadd_rn(
          __fadd_rn(__fmaf_rn(mm2b, gt1e1[s], b0e1[s]),
                    st.a2 >= 15 ? st.esc2 : gt1e0[s]), P.byp);
      v[1][s] = __fadd_rn(__fadd_rn(gt_base, lcga), da_g);
      v[3][s] = __fadd_rn(__fadd_rn(gt_base, lcgb), da_g2);
    }
    // first minimum of each target's list
    uint32_t word = 0;
    first_mins<0>(v, cost, word);
    sbp[step * T + tid] = (uint16_t)word;
    crow[p] = st.seed;
    st = nx;
  }
  // coded_block_flag decides all-zero (unstarted) vs any-nonzero
  int state = 0;
  float best = __fadd_rn(cost[0], P.fin[0]);
#pragma unroll
  for (int s = 1; s < 9; ++s) {
    const float x = __fadd_rn(cost[s], P.fin[s]);
    if (x < best) {
      best = x;
      state = s;
    }
  }
  // the fields' places: 4 bits of shift and 3 of width a target
  constexpr uint64_t kShifts =
      (uint64_t)cand_shift(0) | (uint64_t)cand_shift(1) << 4 |
      (uint64_t)cand_shift(2) << 8 | (uint64_t)cand_shift(3) << 12 |
      (uint64_t)cand_shift(4) << 16 | (uint64_t)cand_shift(5) << 20 |
      (uint64_t)cand_shift(6) << 24 | (uint64_t)cand_shift(7) << 28 |
      (uint64_t)cand_shift(8) << 32;
  constexpr uint32_t kBits =
      cand_bits(0) | cand_bits(1) << 3 | cand_bits(2) << 6 |
      cand_bits(3) << 9 | cand_bits(4) << 12 | cand_bits(5) << 15 |
      cand_bits(6) << 18 | cand_bits(7) << 21 | cand_bits(8) << 24;
#pragma unroll 1
  for (int step = NC - 1; step >= 0; --step) {
    const uint32_t w = sbp[step * T + tid];
    const int sh = (int)((kShifts >> (4 * state)) & 15);
    const int nbits = (int)((kBits >> (3 * state)) & 7);
    const int e = sdec[state * 16 + (int)((w >> sh) & ((1u << nbits) - 1))];
    const int q = NC - 1 - step;
    const int seed = crow[q], lr = seed >> 1;
    const int kind = e >> 4;
    const int lvl = kind == 0 ? 0 : kind == 1 ? lr : kind == 2 ? 1
                                                   : max(lr - 1, 0);
    crow[q] = (seed & 1) ? -lvl : lvl;
    state = e & 15;
  }
  __syncthreads();
  for (int i = tid; i < nb * NC; i += T) {
    const int r = i / NC, q = i - r * NC;
    out[b0 * NC + i] = sc[r * S + q];
  }
}

// ---- lanes per state: 16 lanes a block ----
constexpr int kWideThreads = 128;
constexpr int kWideBlocks = kWideThreads / 16;
constexpr int kListLen = 7;   // the longest group a lane takes

template <int NC>
__global__ void __launch_bounds__(kWideThreads)
trellis_wide(const int* __restrict__ coefs, const float* __restrict__ dqs,
             const float* __restrict__ params, int* __restrict__ out,
             int nblocks) {
  // 2 bits of move kind a step: the path of kinds into each state
  constexpr int kPathWords = (2 * NC + 31) / 32;
  __shared__ float sp[params_len(NC)];
  __shared__ float slcg[kLcgRows * 9];
  __shared__ int sc[kWideBlocks * NC];       // coefficients, seeds, levels
  __shared__ float sd[kWideBlocks * NC];     // dq
  __shared__ StepTerms sst[kWideBlocks][NC];
  __shared__ float sx[kWideBlocks][2][48];   // moves by column; 45: BIG
  const int tid = threadIdx.x;
  const int wb = tid >> 4, l = tid & 15;
  const int b0 = blockIdx.x * kWideBlocks;
  const int nb = min(kWideBlocks, nblocks - b0);
  for (int i = tid; i < params_len(NC); i += kWideThreads)
    cp_async4(sp + i, params + i);
  stage_rows<NC, NC>(sc, sd, coefs, dqs, (size_t)b0, nb, kWideBlocks, tid,
                     kWideThreads);
  if (l >= 13) {
    sx[wb][0][45 + l - 13] = kBig;
    sx[wb][1][45 + l - 13] = kBig;
  }
  __syncthreads();
  const Params P = unpack(sp, NC);
  lcg_table(slcg, P, tid, kWideThreads);
  int* row = sc + wb * NC;
  // this block's per-step terms, a step a lane
  for (int step = l; step < NC; step += 16) {
    const int p = NC - 1 - step;
    const StepTerms st = step_terms(row[p], sd[wb * NC + p], step, p, P);
    sst[wb][step] = st;
    row[p] = st.seed;
  }
  // this lane's columns: target l's group (target 4: its first 7, lane 9
  // the other 6), padded with its last column, which cannot win again
  int cols[kListLen];
#pragma unroll
  for (int g = 0; g < kListLen; ++g) cols[g] = 45;
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    const int tt = t == 9 ? 4 : t;
    const int off = t == 9 ? kListLen : 0;
    const int n = t == 4 ? kListLen : group_len(tt) - off;
    if (l == t) {
#pragma unroll
      for (int g = 0; g < kListLen; ++g)
        cols[g] = group_col(tt, off + (g < n ? g : n - 1));
    }
  }
  const int s = l < 9 ? l : 8;
  float cost = l < 8 ? kBig : 0.0f;
  uint32_t path[kPathWords];
#pragma unroll
  for (int w = 0; w < kPathWords; ++w) path[w] = 0;
  __syncthreads();
#pragma unroll 1
  for (int step = 0; step < NC; ++step) {
    const int p = NC - 1 - step;
    float* x = sx[wb][step & 1];
    const StepTerms& st = sst[wb][step];
    if (__any_sync(0xffffffffu, st.a1 >= 15)) {
      if (l < 9) {
        float mc[5];
        moves_from<true>(mc, cost, s, step, p, P, st, slcg);
#pragma unroll
        for (int m = 0; m < 5; ++m) x[m * 9 + s] = mc[m];
      }
    } else if (l < 9) {
      float mc[5];
      moves_from<false>(mc, cost, s, step, p, P, st, slcg);
#pragma unroll
      for (int m = 0; m < 5; ++m) x[m * 9 + s] = mc[m];
    }
    __syncwarp();
    float best = x[cols[0]];
    int pick = cols[0];
#pragma unroll
    for (int g = 1; g < kListLen; ++g) {
      const float v = x[cols[g]];
      if (v < best) {
        best = v;
        pick = cols[g];
      }
    }
    const float b9 = __shfl_down_sync(0xffffffffu, best, 5, 16);
    const int p9 = __shfl_down_sync(0xffffffffu, pick, 5, 16);
    if (l == 4 && b9 < best) {
      best = b9;
      pick = p9;
    }
    if (l != 4 && kBig < best) {
      best = kBig;
      pick = 45;
    }
    // the path into this target: its source's, then this move's kind
    const int code = col_code(pick);
#pragma unroll
    for (int w = 0; w < kPathWords; ++w)
      path[w] = __shfl_sync(0xffffffffu, path[w], code & 15, 16);
#pragma unroll
    for (int w = 0; w < kPathWords; ++w)
      if (w == step >> 4) path[w] |= (uint32_t)(code >> 4) << (2 * (step & 15));
    cost = best;
  }
  // coded_block_flag decides all-zero (unstarted) vs any-nonzero
  const float fin = __fadd_rn(cost, P.fin[s]);
  int state = 0;
  float best = __shfl_sync(0xffffffffu, fin, 0, 16);
#pragma unroll
  for (int t = 1; t < 9; ++t) {
    const float v = __shfl_sync(0xffffffffu, fin, t, 16);
    if (v < best) {
      best = v;
      state = t;
    }
  }
#pragma unroll
  for (int w = 0; w < kPathWords; ++w)
    path[w] = __shfl_sync(0xffffffffu, path[w], state, 16);
#pragma unroll
  for (int w = 0; w < kPathWords; ++w) {
    const int step = 16 * w + l;
    if (step < NC) {
      const int q = NC - 1 - step;
      row[q] = level_of((path[w] >> (2 * l)) & 3, row[q]);
    }
  }
  __syncthreads();
  for (int i = tid; i < nb * NC; i += kWideThreads)
    out[(size_t)b0 * NC + i] = sc[i];
}

template <int NC>
cudaError_t launch(const int* c, const float* dq, const float* params,
                   int* out, int nblocks, int layout, cudaStream_t stream) {
  if (layout == 2) {
    trellis_wide<NC><<<(nblocks + kWideBlocks - 1) / kWideBlocks,
                       kWideThreads, 0, stream>>>(c, dq, params, out,
                                                  nblocks);
  } else {
    constexpr int T = Tall<NC>::kThreads;
    trellis_tall<NC><<<(nblocks + T - 1) / T, T, 0, stream>>>(
        c, dq, params, out, nblocks);
  }
  return cudaGetLastError();
}

}  // namespace

// 1: thread per block, 2: lanes per state
extern "C" int trellis_auto_layout(int nblocks, int nc) {
  return nblocks <= (nc == kMaxNc ? kWideMax64 : kWideMax) ? 2 : 1;
}

// layout 0 chooses by the block count (trellis_launch); 1 and 2 force one
// (kernels/trellis._trellis_quant_layout: the card's tests and
// chip_smoke.py hold both to the twin at every shape)
extern "C" int trellis_launch_layout(const void* coefs, const void* dq,
                                     const void* params, void* out,
                                     int nblocks, int nc, int layout,
                                     void* stream) {
  if (nc != 15 && nc != 16 && nc != kMaxNc) return (int)cudaErrorInvalidValue;
  if (layout < 0 || layout > 2) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  if (layout == 0) layout = trellis_auto_layout(nblocks, nc);
  const int* c = (const int*)coefs;
  const float* d = (const float*)dq;
  const float* p = (const float*)params;
  int* o = (int*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (nc == 15) return (int)launch<15>(c, d, p, o, nblocks, layout, s);
  if (nc == 16) return (int)launch<16>(c, d, p, o, nblocks, layout, s);
  return (int)launch<kMaxNc>(c, d, p, o, nblocks, layout, s);
}

extern "C" int trellis_launch(const void* coefs, const void* dq,
                              const void* params, void* out, int nblocks,
                              int nc, void* stream) {
  return trellis_launch_layout(coefs, dq, params, out, nblocks, nc, 0,
                               stream);
}

extern "C" int trellis_params_len(int nc) { return params_len(nc); }
