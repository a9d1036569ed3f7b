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
// Design: one thread per block (B up to 130560 at 1080p), a simple kernel.
// The nine path costs live in registers; each step's back-pointers (source
// state in the low 4 bits, move kind in the next 2) are one byte per state
// in local memory, at most 64 x 9 bytes, beside the block's seed levels and
// coefficient signs; the backtrack walks them and writes each signed level
// once.  Coefficients and dq are read once.  The per-call tables (lambda
// folded into the bit costs, the position weights) sit in shared memory.
//
// Bound on the H100: the bytes (coefficients and dq in, levels out, 12 per
// coefficient) against the Viterbi's float operations (kernels/trellis.py
// counts both); at 1080p 4x4 luma, 130560 blocks x 16 positions, both are a
// few microseconds.  The kernel is latency-bound instead: each thread runs
// its 16-64 steps in sequence.
//
// Float semantics follow the twin exactly, which follows XLA's CPU code:
// __fmaf_rn at the three sites XLA contracts (the level error c - a*dq, the
// first step's |coef|*k - a*dq, and the level-bin count of lcg), and
// __fmul_rn / __fadd_rn / __fdiv_rn everywhere else, so that nvcc's
// --fmad=true cannot contract anything.  The escape length is an exact
// integer bit length (__clz).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxNc = 64;
constexpr float kBig = 1e30f;

constexpr int kGroupMax = 13;

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

__global__ void __launch_bounds__(kThreads)
trellis_kernel(const int* __restrict__ coefs, const float* __restrict__ dqs,
               const float* __restrict__ params, int* __restrict__ out,
               int nblocks, int nc) {
  __shared__ float sp[params_len(kMaxNc)];
  for (int i = threadIdx.x; i < params_len(nc); i += blockDim.x)
    sp[i] = params[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblocks) return;
  const Params P = unpack(sp, nc);
  // The 45 (move, source) transitions grouped by target state: column =
  // move * 9 + source (move 0 level 0, 1 a1 == 1, 2 a1 > 1, 3 a2 == 1,
  // 4 a2 > 1); a group shorter than kGroupMax ends with the dummy column 45
  // (cost BIG, source 8, kind 0).  Mirrors ops/trellis.py GROUP_IDX.
  constexpr int kGroupLen[9] = {1, 5, 3, 5, 13, 5, 5, 7, 1};
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
  const int* crow = coefs + (size_t)b * nc;
  const float* dqrow = dqs + (size_t)b * nc;

  uint8_t bp[kMaxNc * 9];   // back-pointers: src | kind << 4
  int seed[kMaxNc];         // Lr << 1 | (coef < 0), by step

  float cost[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) cost[s] = s < 8 ? kBig : 0.0f;

#pragma unroll 1
  for (int step = 0; step < nc; ++step) {
    const int p = nc - 1 - step;
    const int ci = crow[p];
    const float dq = dqrow[p];
    const float cabs = __int2float_rn(abs(ci));
    const float kp = P.k[p], wp = P.w[p];
    const float c = __fmul_rn(cabs, kp);
    const int lr = (int)floorf(__fadd_rn(__fdiv_rn(c, dq), 0.5f));
    seed[step] = (lr << 1) | (ci < 0);
    const int a1 = lr, a2 = max(lr - 1, 0);
    const float d0 = __fmul_rn(__fmul_rn(wp, c), c);

    float flv[9], sig0v[9];
#pragma unroll
    for (int s = 0; s < 9; ++s) {
      if (step == 0) {      // significance inferred, no started source
        flv[s] = s < 8 ? kBig : 0.0f;
        sig0v[s] = 0.0f;
      } else {
        flv[s] = s < 8 ? P.fm[p] : P.fl[p];
        sig0v[s] = s < 8 ? P.sig0[p] : 0.0f;
      }
    }
    // candidate costs by move: [0] level 0, [1] a1 == 1, [2] a1 > 1,
    // [3] a2 == 1, [4] a2 > 1
    float mc[5][9];
#pragma unroll
    for (int s = 0; s < 9; ++s)
      mc[0][s] = __fadd_rn(__fadd_rn(cost[s], d0), sig0v[s]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int a = j == 0 ? a1 : a2;
      const float af = __int2float_rn(a);
      const float e = step == 0
          ? __fmaf_rn(cabs, kp, -__fmul_rn(af, dq))
          : __fmaf_rn(-af, dq, c);
      const float da = __fmul_rn(__fmul_rn(wp, e), e);
      const float mm2 = __fadd_rn(fminf(af, 15.0f), -2.0f);
      float esc = 0.0f;
      if (a >= 15) {
        const int len = 31 - __clz(a - 14);        // floor(log2(a - 14))
        esc = __fmul_rn(P.byp, __int2float_rn(2 * len + 1));
      }
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float base_e = __fadd_rn(cost[s], __fadd_rn(flv[s], P.lc1[s]));
        const float gt_base = __fadd_rn(cost[s], flv[s]);
        const float eg0 = a >= 15 ? esc : P.gt1e0[s];
        const float lcg = __fadd_rn(
            __fadd_rn(__fmaf_rn(mm2, P.gt1e1[s], P.b0e1[s]), eg0), P.byp);
        mc[1 + 2 * j][s] = a == 1 ? __fadd_rn(base_e, da) : kBig;
        mc[2 + 2 * j][s] =
            a > 1 ? __fadd_rn(__fadd_rn(gt_base, lcg), da) : kBig;
      }
    }
    // first minimum of each target's group, in column order
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float best = 0.0f;
      int pick = 0;
#pragma unroll
      for (int g = 0; g < kGroupMax; ++g) {
        if (g < kGroupLen[t]) {
          const int col = kGroupCol[t][g];
          const float v = mc[col / 9][col % 9];
          if (g == 0 || v < best) {
            best = v;
            pick = col;
          }
        }
      }
      if (kGroupLen[t] < kGroupMax && kBig < best) {
        best = kBig;
        pick = 45;
      }
      const int src = pick == 45 ? 8 : pick % 9;
      const int move = pick == 45 ? 0 : pick / 9;
      const int kind = move == 0 ? 0 : (move <= 2 ? 1 : 2);
      bp[step * 9 + t] = (uint8_t)(src | (kind << 4));
      cost[t] = best;   // read below only through mc, already computed
    }
  }

  // coded_block_flag decides all-zero (unstarted) vs any-nonzero
  int state = 0;
  float best = __fadd_rn(cost[0], P.fin[0]);
#pragma unroll
  for (int s = 1; s < 9; ++s) {
    const float v = __fadd_rn(cost[s], P.fin[s]);
    if (v < best) {
      best = v;
      state = s;
    }
  }
  int* orow = out + (size_t)b * nc;
#pragma unroll 1
  for (int step = nc - 1; step >= 0; --step) {
    const int r = bp[step * 9 + state];
    const int kind = r >> 4;
    const int lr = seed[step] >> 1;
    const int lvl = kind == 1 ? lr : (kind == 2 ? max(lr - 1, 0) : 0);
    orow[nc - 1 - step] = (seed[step] & 1) ? -lvl : lvl;
    state = r & 15;
  }
}

}  // namespace

extern "C" int trellis_launch(const void* coefs, const void* dq,
                              const void* params, void* out, int nblocks,
                              int nc, void* stream) {
  if (nc < 2 || nc > kMaxNc) return (int)cudaErrorInvalidValue;
  if (nblocks <= 0) return (int)cudaSuccess;
  const int grid = (nblocks + kThreads - 1) / kThreads;
  trellis_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)coefs, (const float*)dq, (const float*)params, (int*)out,
      nblocks, nc);
  return (int)cudaGetLastError();
}

extern "C" int trellis_params_len(int nc) { return params_len(nc); }
