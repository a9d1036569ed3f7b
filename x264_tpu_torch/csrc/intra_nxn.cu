// The I4x4 and I8x8 candidates of one knight step of the I-frame wavefront,
// for Hopper (sm_90a).
//
// Replaces: the NxN candidate chain inside
// x264_tpu/models/intra_device.py::i4_frame_core (the I4x4 block loop,
// intra_device.py:360-445, and the I8x8 block loop, :447-554).  The
// reference has no Pallas kernel here: it unrolls the 16 + 4 blocks as XLA
// ops inside its lax.scan, which eager PyTorch would pay for with ~40
// launches per block.  The plain twin, bit for bit, is
// x264_tpu_torch/kernels/intra_nxn.py::nxn_candidates_plain.
//
// Bound on the H100: the integer operations of the 9-mode searches (about
// 75k per MB, kernels/intra_nxn.py counts them) over the card's int32 rate,
// against a few KB per MB of bytes; both are tens of microseconds per IDR.
// The kernel is latency-bound instead: a step cannot end before one MB's
// chain of dependent blocks does, and a step holds at most 60 MBs at 1080p,
// so most SMs idle.  The design therefore shortens that chain:
//
// - One launch per knight step d (MBs (d - 2y, y), y = jmin .. jmin +
//   count - 1), one CUDA block per MB: warp 0 runs the I4x4 chain, warp 1
//   (t8_mode) the I8x8 chain beside it.  Their intra-MB edges come from
//   their own tiles, so they share only the MB-external edges, loaded once.
// - Lanes over pixels, not modes: every lane evaluates the same mode at the
//   same time, so the nine modes never diverge inside a warp.  A prediction
//   is one shared-memory read: each mode's value at each pixel is an entry
//   of the block's value row [E, F2, F3, DC], where E is the edge line
//   (left column bottom-up, the corner, the top row; for I8x8 after the
//   8.3.2.2.1 filter), F2 its two-tap and F3 its three-tap averages (ends
//   replicated), and kPred4 / kPred8 give the entry per (mode, pixel)
//   (tests/test_torch_nxn_schedule.py derives them from the plain
//   predictors).  The SATD's Hadamards and every sum run across lanes with
//   __shfl_xor_sync; the first minimum is the packed (cost << 4) | mode
//   key, so a tie goes to the lower mode.
// - I4x4 follows the reference's ten sub-steps (kSubsteps, the twin's
//   _SUBSTEPS): the two blocks of a sub-step run in the two half-warps, a
//   lane per pixel.  Every block's left, top and top-right neighbours come
//   in an earlier sub-step, and the per-MB sums are integer, so the outputs
//   equal the z-order chain's.
// - I8x8 runs its four blocks in order in one warp, two pixels per lane
//   (rows y and y + 4); its 8x8 transforms gather a row or a column by
//   shuffles, so every lane works in every pass.
// - Transform, quantisation, dequantisation and reconstruction stay in
//   registers and shuffles.  Shared memory holds the MB's source and edges
//   (unavailable edges load as zeros), the value rows, the modes and the
//   trial recon.  All integer: bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the constant tables (kernels/intra_nxn.py packs them, raster positions)
constexpr int kQ4 = 0, kD4 = 96, kQ8 = 192, kD8 = 576, kZ4 = 960, kZ8 = 976;

// per-MB output row (kernels/intra_nxn.py splits it)
constexpr int oModes4 = 0, oAcs4 = 16, oNnz4 = 272, oCost4 = 288,
              oSsd4 = 289, oRb4 = 290, oTile8 = 291, oModes8 = 547,
              oLv64 = 551, oCost8 = 807, oSsd8 = 808, oRb8 = 809;
constexpr int kOutWords = 810;

// The I4x4 sub-steps: {x4, y4} of the blocks that half-warps 0 and 1 take
// (x4 + 2 * y4 = the sub-step; {-1, -1}: half-warp 1 idles).  Called with
// constant arguments only (an unrolled loop), so the table folds away.
__host__ __device__ constexpr int substep_block(int s, int h, int k) {
  constexpr int kSubsteps[10][2][2] = {
      {{0, 0}, {-1, -1}},
      {{1, 0}, {-1, -1}},
      {{2, 0}, {0, 1}},
      {{3, 0}, {1, 1}},
      {{2, 1}, {0, 2}},
      {{3, 1}, {1, 2}},
      {{2, 2}, {0, 3}},
      {{3, 2}, {1, 3}},
      {{2, 3}, {-1, -1}},
      {{3, 3}, {-1, -1}},
  };
  return kSubsteps[s][h][k];
}

// The value rows: I4x4 [E 0-12 | F2 13-24 | F3 25-37 | DC 38] with E =
// L3 L2 L1 L0, the corner, T0..T7; I8x8 [E 0-24 | F2 25-48 | F3 49-73 |
// DC 74] with E = the filtered L7..L0, corner, T0..T15.
constexpr int kVal4 = 39, kVal8 = 75;

// entry of the value row per mode [V, H, DC, DDL, DDR, VR, HD, VL, HU] and
// pixel (raster)
__device__ const uint8_t kPred4[9][16] = {
    {5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8, 5, 6, 7, 8},
    {3, 3, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 0, 0, 0, 0},
    {38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38, 38},
    {31, 32, 33, 34, 32, 33, 34, 35, 33, 34, 35, 36, 34, 35, 36, 37},
    {29, 30, 31, 32, 28, 29, 30, 31, 27, 28, 29, 30, 26, 27, 28, 29},
    {17, 18, 19, 20, 29, 30, 31, 32, 28, 17, 18, 19, 27, 29, 30, 31},
    {16, 29, 30, 31, 15, 28, 16, 29, 14, 27, 15, 28, 13, 26, 14, 27},
    {18, 19, 20, 21, 31, 32, 33, 34, 19, 20, 21, 22, 32, 33, 34, 35},
    {15, 27, 14, 26, 14, 26, 13, 25, 13, 25, 0, 0, 0, 0, 0, 0},
};

__device__ const uint8_t kPred8[9][64] = {
    {9, 10, 11, 12, 13, 14, 15, 16, 9, 10, 11, 12, 13, 14, 15, 16,
     9, 10, 11, 12, 13, 14, 15, 16, 9, 10, 11, 12, 13, 14, 15, 16,
     9, 10, 11, 12, 13, 14, 15, 16, 9, 10, 11, 12, 13, 14, 15, 16,
     9, 10, 11, 12, 13, 14, 15, 16, 9, 10, 11, 12, 13, 14, 15, 16},
    {7, 7, 7, 7, 7, 7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6,
     5, 5, 5, 5, 5, 5, 5, 5, 4, 4, 4, 4, 4, 4, 4, 4,
     3, 3, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
     1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0},
    {74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74,
     74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74,
     74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74,
     74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74, 74},
    {59, 60, 61, 62, 63, 64, 65, 66, 60, 61, 62, 63, 64, 65, 66, 67,
     61, 62, 63, 64, 65, 66, 67, 68, 62, 63, 64, 65, 66, 67, 68, 69,
     63, 64, 65, 66, 67, 68, 69, 70, 64, 65, 66, 67, 68, 69, 70, 71,
     65, 66, 67, 68, 69, 70, 71, 72, 66, 67, 68, 69, 70, 71, 72, 73},
    {57, 58, 59, 60, 61, 62, 63, 64, 56, 57, 58, 59, 60, 61, 62, 63,
     55, 56, 57, 58, 59, 60, 61, 62, 54, 55, 56, 57, 58, 59, 60, 61,
     53, 54, 55, 56, 57, 58, 59, 60, 52, 53, 54, 55, 56, 57, 58, 59,
     51, 52, 53, 54, 55, 56, 57, 58, 50, 51, 52, 53, 54, 55, 56, 57},
    {33, 34, 35, 36, 37, 38, 39, 40, 57, 58, 59, 60, 61, 62, 63, 64,
     56, 33, 34, 35, 36, 37, 38, 39, 55, 57, 58, 59, 60, 61, 62, 63,
     54, 56, 33, 34, 35, 36, 37, 38, 53, 55, 57, 58, 59, 60, 61, 62,
     52, 54, 56, 33, 34, 35, 36, 37, 51, 53, 55, 57, 58, 59, 60, 61},
    {32, 57, 58, 59, 60, 61, 62, 63, 31, 56, 32, 57, 58, 59, 60, 61,
     30, 55, 31, 56, 32, 57, 58, 59, 29, 54, 30, 55, 31, 56, 32, 57,
     28, 53, 29, 54, 30, 55, 31, 56, 27, 52, 28, 53, 29, 54, 30, 55,
     26, 51, 27, 52, 28, 53, 29, 54, 25, 50, 26, 51, 27, 52, 28, 53},
    {34, 35, 36, 37, 38, 39, 40, 41, 59, 60, 61, 62, 63, 64, 65, 66,
     35, 36, 37, 38, 39, 40, 41, 42, 60, 61, 62, 63, 64, 65, 66, 67,
     36, 37, 38, 39, 40, 41, 42, 43, 61, 62, 63, 64, 65, 66, 67, 68,
     37, 38, 39, 40, 41, 42, 43, 44, 62, 63, 64, 65, 66, 67, 68, 69},
    {31, 55, 30, 54, 29, 53, 28, 52, 30, 54, 29, 53, 28, 52, 27, 51,
     29, 53, 28, 52, 27, 51, 26, 50, 28, 52, 27, 51, 26, 50, 25, 49,
     27, 51, 26, 50, 25, 49, 0, 0, 26, 50, 25, 49, 0, 0, 0, 0,
     25, 49, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
};

struct Smem {
  int src[256];
  int etop[25];     // row y0-1, columns x0-1 .. x0+23 (0 where unavailable)
  int eleft[16];    // column x0-1, rows y0 .. y0+15
  int gl[4], gt[4]; // mode grid left of / above the MB (-1 outside)
  // warp 0: I4x4
  int rec4[256];
  int mode4[16];
  int val4[2][kVal4 + 1];   // one value row per half-warp
  // warp 1: I8x8
  int tile8[256];
  int val8[kVal8 + 1];
  int modes8[4];
};

__device__ __forceinline__ int half_sum(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// one butterfly of a Walsh-Hadamard transform across lanes (lane bit o):
// the lower lane keeps the sum, the upper one the difference.  The sum of
// absolute values over the block does not depend on the output order.
__device__ __forceinline__ int wht(int v, int o, int lane) {
  const int w = __shfl_xor_sync(kFull, v, o);
  return (lane & o) ? w - v : v + w;
}

// the arbitration's rate proxy of one level: 2 x its bit length (at most
// 14) + 1 when nonzero
__device__ __forceinline__ int rate_of(int lv) {
  const int a = lv < 0 ? -lv : lv;
  if (a == 0) return 0;
  const int nb = 32 - __clz(a);
  return 2 * (nb < 14 ? nb : 14) + 1;
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int z4(int x4, int y4) {
  return 8 * (y4 >> 1) + 4 * (x4 >> 1) + 2 * (y4 & 1) + (x4 & 1);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// mode availability [V, H, DC, DDL, DDR, VR, HD, VL, HU] (8.3.1.2)
__device__ __forceinline__ bool mode_avail(int m, bool at, bool al, bool atl) {
  if (m == 0 || m == 3 || m == 7) return at;
  if (m == 1 || m == 8) return al;
  if (m == 2) return true;
  return at && al && atl;
}

__device__ __forceinline__ int dc_of(bool at, bool al, int st, int sl,
                                     int both_add, int both_sh, int one_add,
                                     int one_sh) {
  if (at && al) return (st + sl + both_add) >> both_sh;
  if (at) return (st + one_add) >> one_sh;
  if (al) return (sl + one_add) >> one_sh;
  return 128;
}

// out[k] of eight values, k in 0..7, by selects (no local array)
__device__ __forceinline__ int pick8(int k, int o0, int o1, int o2, int o3,
                                     int o4, int o5, int o6, int o7) {
  const int a = (k & 1) ? o1 : o0, b = (k & 1) ? o3 : o2;
  const int c = (k & 1) ? o5 : o4, d = (k & 1) ? o7 : o6;
  const int e = (k & 2) ? b : a, f = (k & 2) ? d : c;
  return (k & 4) ? f : e;
}

__device__ __forceinline__ int pick4(int k, int o0, int o1, int o2, int o3) {
  const int a = (k & 1) ? o1 : o0, b = (k & 1) ? o3 : o2;
  return (k & 2) ? b : a;
}

// 4-point forward core transform (Cf): output k of x0..x3
__device__ __forceinline__ int cf4(int k, int x0, int x1, int x2, int x3) {
  const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  return pick4(k, s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12);
}

// 4-point normative inverse (8.5.12.2): output k of d0..d3
__device__ __forceinline__ int icf4(int k, int d0, int d1, int d2, int d3) {
  const int e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3,
            e3 = d1 + (d3 >> 1);
  return pick4(k, e0 + e3, e1 + e2, e1 - e2, e0 - e3);
}

// 8-point forward transform (High profile, x264's order): output k
__device__ __forceinline__ int dct8(int k, const int d[8]) {
  const int s07 = d[0] + d[7], s16 = d[1] + d[6], s25 = d[2] + d[5],
            s34 = d[3] + d[4];
  const int a0 = s07 + s34, a1 = s16 + s25, a2 = s07 - s34, a3 = s16 - s25;
  const int d07 = d[0] - d[7], d16 = d[1] - d[6], d25 = d[2] - d[5],
            d34 = d[3] - d[4];
  const int a4 = d16 + d25 + (d07 + (d07 >> 1));
  const int a5 = d07 - d34 - (d25 + (d25 >> 1));
  const int a6 = d07 + d34 - (d16 + (d16 >> 1));
  const int a7 = d16 - d25 + (d34 + (d34 >> 1));
  return pick8(k, a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
               a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7);
}

// 8-point normative inverse (8.5.12.3): output k
__device__ __forceinline__ int idct8(int k, const int d[8]) {
  const int e0 = d[0] + d[4], e2 = d[0] - d[4];
  const int e4 = (d[2] >> 1) - d[6], e6 = d[2] + (d[6] >> 1);
  const int e1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
  const int e3 = d[1] + d[7] - d[3] - (d[3] >> 1);
  const int e5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
  const int e7 = d[3] + d[5] + d[1] + (d[1] >> 1);
  const int f0 = e0 + e6, f2 = e2 + e4, f4 = e2 - e4, f6 = e0 - e6;
  const int f1 = e1 + (e7 >> 2), f3 = e3 + (e5 >> 2);
  const int f5 = (e3 >> 2) - e5, f7 = e7 - (e1 >> 2);
  return pick8(k, f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3,
               f2 - f5, f0 - f7);
}

// the 4-point pass over lanes base + i * stride (i = 0..3) of a half-warp
template <bool kInverse>
__device__ __forceinline__ int pass4(int v, int k, int base, int stride) {
  const int x0 = __shfl_sync(kFull, v, base, 16);
  const int x1 = __shfl_sync(kFull, v, base + stride, 16);
  const int x2 = __shfl_sync(kFull, v, base + 2 * stride, 16);
  const int x3 = __shfl_sync(kFull, v, base + 3 * stride, 16);
  return kInverse ? icf4(k, x0, x1, x2, x3) : cf4(k, x0, x1, x2, x3);
}

// ---- warp 0: the I4x4 chain, a half-warp per block, a lane per pixel ----
__device__ void i4_chain(Smem& sm, int lane, bool at, bool al, bool notlast,
                         int qp, int lam, const int* __restrict__ tab,
                         int* out) {
  const int h = lane >> 4, p = lane & 15, px = p & 3, py = p >> 2;
  const unsigned hmask = 0xffffu << (16 * h);
  const int q6 = qp / 6, qm = qp % 6;
  const int qbits = 15 + q6, fq = (1 << qbits) / 3;
  const int mf = tab[kQ4 + qm * 16 + p], dqv = tab[kD4 + qm * 16 + p];
  const int zz = tab[kZ4 + p];     // raster position of zigzag index p
  int pidx[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) pidx[m] = kPred4[m][p];
  int cost_acc = 0, ssd_acc = 0, rb_acc = 0;
#pragma unroll
  for (int s = 0; s < 10; ++s) {
    // an idle half-warp shadows half-warp 0's block and writes nothing
    const bool active = h == 0 || substep_block(s, 1, 0) >= 0;
    const bool second = active && h;   // constant arguments only
    const int x4 = second ? substep_block(s, 1, 0) : substep_block(s, 0, 0);
    const int y4 = second ? substep_block(s, 1, 1) : substep_block(s, 0, 1);
    const int r = 4 * y4 + x4;
    const bool a4 = y4 > 0 || at;
    const bool l4 = x4 > 0 || al;
    const bool tl4 = (y4 > 0 && x4 > 0) ? true
                     : (y4 > 0 ? al : (x4 > 0 ? at : (at && al)));
    const bool tr4 = y4 == 0 ? (x4 < 3 ? at : (at && notlast))
                             : (x4 < 3 && z4(x4 + 1, y4 - 1) < z4(x4, y4));
    // the edge line: lane p < 13 holds E[p]
    int e = 0;
    if (p < 4) {
      const int i = 3 - p;
      e = x4 == 0 ? sm.eleft[4 * y4 + i]
                  : sm.rec4[(4 * y4 + i) * 16 + 4 * x4 - 1];
    } else if (p == 4) {
      e = y4 == 0 ? sm.etop[4 * x4]
                  : (x4 == 0 ? sm.eleft[4 * y4 - 1]
                             : sm.rec4[(4 * y4 - 1) * 16 + 4 * x4 - 1]);
    } else if (p < 13) {
      const int i = (p - 5 >= 4 && !tr4) ? 3 : p - 5;   // 8.3.1.2.1
      e = y4 == 0 ? sm.etop[1 + 4 * x4 + i]
                  : (4 * x4 + i < 16 ? sm.rec4[(4 * y4 - 1) * 16 + 4 * x4 + i]
                                     : 0);
    }
    const int en = __shfl_down_sync(kFull, e, 1, 16);
    const int ep = __shfl_up_sync(kFull, e, 1, 16);
    const int sums = half_sum(p < 4 ? e << 16 : (p >= 5 && p < 9 ? e : 0));
    const int dc = dc_of(a4, l4, sums & 0xffff, sums >> 16, 4, 3, 2, 2);
    int* val = sm.val4[h];
    if (p < 13) {
      val[p] = e;
      if (p < 12) val[13 + p] = (e + en + 1) >> 1;
      val[25 + p] = ((p > 0 ? ep : e) + 2 * e + (p < 12 ? en : e) + 2) >> 2;
    } else if (p == 13) {
      val[38] = dc;
    }
    // the predicted mode from the left and top blocks' modes
    const int lm = x4 > 0 ? sm.mode4[r - 1] : sm.gl[y4];
    const int tm = y4 > 0 ? sm.mode4[r - 4] : sm.gt[x4];
    const int pmode = (lm < 0 || tm < 0) ? 2 : imin(lm, tm);
    const int sv = sm.src[(4 * y4 + py) * 16 + 4 * x4 + px];
    __syncwarp();
    unsigned long long best = ~0ull;
    int pred = 0;
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      const int pv = val[pidx[m]];
      int d = sv - pv;
      d = wht(d, 1, p);
      d = wht(d, 2, p);
      d = wht(d, 4, p);
      d = wht(d, 8, p);
      const int satd = half_sum(d < 0 ? -d : d);
      const int cost = (satd >> 1) + lam * (m == pmode ? 1 : 4);
      const unsigned long long key =
          ((unsigned long long)(unsigned)cost << 4) | (unsigned)m;
      if (mode_avail(m, a4, l4, tl4) && key < best) {
        best = key;
        pred = pv;
      }
    }
    const int m = (int)(best & 15);
    const int bc = (int)(best >> 4);
    // transform (vertical, then horizontal), quant, dequant, inverse
    // (horizontal, then vertical), reconstruction
    int c = pass4<false>(sv - pred, py, px, 4);
    c = pass4<false>(c, px, 4 * py, 1);
    const int a = ((c < 0 ? -c : c) * mf + fq) >> qbits;
    const int lv = c < 0 ? -a : a;
    const int nnz = __popc(__ballot_sync(kFull, lv != 0) & hmask);
    const int rate = half_sum(rate_of(lv));
    const int lvz = __shfl_sync(kFull, lv, zz, 16);
    int res = pass4<true>((lv * dqv) << q6, px, 4 * py, 1);
    res = pass4<true>(res, py, px, 4);
    const int pix = clip255(pred + ((res + 32) >> 6));
    const int err = sv - pix;
    const int ssd = half_sum(err * err);
    if (active) {
      out[oAcs4 + r * 16 + p] = lvz;
      sm.rec4[(4 * y4 + py) * 16 + 4 * x4 + px] = pix;
      if (p == 0) {
        sm.mode4[r] = m;
        out[oModes4 + r] = m;
        out[oNnz4 + r] = nnz;
      }
      cost_acc += bc;
      ssd_acc += ssd;
      rb_acc += rate + (m == pmode ? 1 : 4);
    }
    __syncwarp();
  }
  cost_acc += __shfl_xor_sync(kFull, cost_acc, 16);
  ssd_acc += __shfl_xor_sync(kFull, ssd_acc, 16);
  rb_acc += __shfl_xor_sync(kFull, rb_acc, 16);
  if (lane == 0) {
    out[oCost4] = 24 * lam + cost_acc;
    out[oSsd4] = ssd_acc;
    out[oRb4] = 24 + rb_acc;
  }
}

// the 8-point pass over the lanes of a column (reg 0: rows 0-3, reg 1: rows
// 4-7) or of a row; returns the outputs of this lane's two pixels
template <bool kInverse>
__device__ __forceinline__ void col8(int& v0, int& v1, int x, int y) {
  int d[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = __shfl_sync(kFull, v0, x + 8 * k);
    d[4 + k] = __shfl_sync(kFull, v1, x + 8 * k);
  }
  v0 = kInverse ? idct8(y, d) : dct8(y, d);
  v1 = kInverse ? idct8(y + 4, d) : dct8(y + 4, d);
}

template <bool kInverse>
__device__ __forceinline__ int row8(int v, int x, int y) {
  int d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = __shfl_sync(kFull, v, 8 * y + k);
  return kInverse ? idct8(x, d) : dct8(x, d);
}

// ---- warp 1: the I8x8 chain, two pixels per lane ----
__device__ void i8_chain(Smem& sm, int lane, bool at, bool al, bool notlast,
                         int qp, int lam, const int* __restrict__ tab,
                         int* out) {
  const int x = lane & 7, y = lane >> 3;      // pixels (x, y), (x, y + 4)
  const int p0 = 8 * y + x, p1 = p0 + 32;
  const int q6 = qp / 6, qm = qp % 6;
  const int qbits = 16 + q6, fq = (1 << qbits) / 3;
  const int mf0 = tab[kQ8 + qm * 64 + p0], mf1 = tab[kQ8 + qm * 64 + p1];
  const int ls0 = tab[kD8 + qm * 64 + p0] * 16,
            ls1 = tab[kD8 + qm * 64 + p1] * 16;
  // zigzag indices lane and lane + 32: raster position -> (lane, register)
  const int zp0 = tab[kZ8 + lane], zp1 = tab[kZ8 + lane + 32];
  const int zl0 = (zp0 & 7) + 8 * ((zp0 >> 3) & 3), zr0 = zp0 >> 5;
  const int zl1 = (zp1 & 7) + 8 * ((zp1 >> 3) & 3), zr1 = zp1 >> 5;
  int pidx[9];
#pragma unroll
  for (int m = 0; m < 9; ++m) pidx[m] = kPred8[m][p0] | (kPred8[m][p1] << 8);
  int cost_acc = 0, ssd_acc = 0, rb_acc = 0;
  for (int b8 = 0; b8 < 4; ++b8) {
    const int x8 = b8 & 1, y8 = b8 >> 1;
    bool a_t, a_l, a_tl, a_tr;
    if (b8 == 0) {
      a_t = at; a_l = al; a_tl = at && al; a_tr = at;
    } else if (b8 == 1) {
      a_t = at; a_l = true; a_tl = at; a_tr = at && notlast;
    } else if (b8 == 2) {
      a_t = true; a_l = al; a_tl = al; a_tr = true;
    } else {
      a_t = true; a_l = true; a_tl = true; a_tr = false;
    }
    // the raw edge line: lane < 25 holds L7..L0, the corner, T0..T15
    int e = 0;
    if (lane < 8) {
      const int i = 7 - lane;
      e = x8 == 0 ? sm.eleft[8 * y8 + i] : sm.tile8[(8 * y8 + i) * 16 + 7];
    } else if (lane == 8) {
      e = y8 == 0 ? sm.etop[8 * x8]
                  : (x8 == 0 ? sm.eleft[7] : sm.tile8[7 * 16 + 7]);
    } else if (lane < 25) {
      const int i = (lane - 9 >= 8 && !a_tr) ? 7 : lane - 9;
      e = y8 == 0 ? sm.etop[1 + 8 * x8 + i]
                  : sm.tile8[7 * 16 + (x8 == 0 ? i : 8 + (i & 7))];
    }
    // the 8.3.2.2.1 low-pass filter: a neighbour that is unavailable (or
    // off the line's ends) counts as the centre
    {
      const int en = __shfl_down_sync(kFull, e, 1);
      const int ep = __shfl_up_sync(kFull, e, 1);
      const bool lok =
          lane > 0 && !(lane == 8 && !a_l) && !(lane == 9 && !a_tl);
      const bool rok =
          lane < 24 && !(lane == 8 && !a_t) && !(lane == 7 && !a_tl);
      e = ((lok ? ep : e) + 2 * e + (rok ? en : e) + 2) >> 2;
    }
    const int en = __shfl_down_sync(kFull, e, 1);
    const int ep = __shfl_up_sync(kFull, e, 1);
    const int sums = warp_sum(lane < 8 ? e << 16
                              : (lane >= 9 && lane < 17 ? e : 0));
    const int dc = dc_of(a_t, a_l, sums & 0xffff, sums >> 16, 8, 4, 4, 3);
    if (lane < 25) {
      sm.val8[lane] = e;
      if (lane < 24) sm.val8[25 + lane] = (e + en + 1) >> 1;
      sm.val8[49 + lane] =
          ((lane > 0 ? ep : e) + 2 * e + (lane < 24 ? en : e) + 2) >> 2;
    } else if (lane == 25) {
      sm.val8[74] = dc;
    }
    int lm, tm;
    if (b8 == 0) { lm = sm.gl[0]; tm = sm.gt[0]; }
    else if (b8 == 1) { lm = sm.modes8[0]; tm = sm.gt[2]; }
    else if (b8 == 2) { lm = sm.gl[2]; tm = sm.modes8[0]; }
    else { lm = sm.modes8[2]; tm = sm.modes8[1]; }
    const int pmode = (lm < 0 || tm < 0) ? 2 : imin(lm, tm);
    const int* src = sm.src + (8 * y8) * 16 + 8 * x8;
    const int sv0 = src[y * 16 + x], sv1 = src[(y + 4) * 16 + x];
    __syncwarp();
    unsigned long long best = ~0ull;
    int pred0 = 0, pred1 = 0;
#pragma unroll
    for (int m = 0; m < 9; ++m) {
      const int pv0 = sm.val8[pidx[m] & 255], pv1 = sm.val8[pidx[m] >> 8];
      int d0 = sv0 - pv0, d1 = sv1 - pv1;
      // four 4x4 Hadamards: x over lane bits 0-1, y over lane bits 3-4
#pragma unroll
      for (int o = 1; o <= 16; o <<= 1) {
        if (o == 4) continue;
        d0 = wht(d0, o, lane);
        d1 = wht(d1, o, lane);
      }
      const int satd = warp_sum((d0 < 0 ? -d0 : d0) + (d1 < 0 ? -d1 : d1));
      const int cost = (satd >> 1) + lam * (m == pmode ? 1 : 4);
      const unsigned long long key =
          ((unsigned long long)(unsigned)cost << 4) | (unsigned)m;
      if (mode_avail(m, a_t, a_l, a_tl) && key < best) {
        best = key;
        pred0 = pv0;
        pred1 = pv1;
      }
    }
    const int m = (int)(best & 15);
    const int bc = (int)(best >> 4);
    // transform (vertical, then horizontal), quant, dequant
    int c0 = sv0 - pred0, c1 = sv1 - pred1;
    col8<false>(c0, c1, x, y);
    c0 = row8<false>(c0, x, y);
    c1 = row8<false>(c1, x, y);
    const int a0 = ((c0 < 0 ? -c0 : c0) * mf0 + fq) >> qbits;
    const int a1 = ((c1 < 0 ? -c1 : c1) * mf1 + fq) >> qbits;
    const int lv0 = c0 < 0 ? -a0 : a0, lv1 = c1 < 0 ? -a1 : a1;
    const int rate = warp_sum(rate_of(lv0) + rate_of(lv1));
    {
      const int u0 = __shfl_sync(kFull, lv0, zl0);
      const int u1 = __shfl_sync(kFull, lv1, zl0);
      const int w0 = __shfl_sync(kFull, lv0, zl1);
      const int w1 = __shfl_sync(kFull, lv1, zl1);
      out[oLv64 + b8 * 64 + lane] = zr0 ? u1 : u0;
      out[oLv64 + b8 * 64 + lane + 32] = zr1 ? w1 : w0;
    }
    int r0 = q6 >= 6 ? (lv0 * ls0) << (q6 - 6)
                     : (lv0 * ls0 + (1 << (5 - q6))) >> (6 - q6);
    int r1 = q6 >= 6 ? (lv1 * ls1) << (q6 - 6)
                     : (lv1 * ls1 + (1 << (5 - q6))) >> (6 - q6);
    // inverse: horizontal, then vertical
    r0 = row8<true>(r0, x, y);
    r1 = row8<true>(r1, x, y);
    col8<true>(r0, r1, x, y);
    const int pix0 = clip255(pred0 + ((r0 + 32) >> 6));
    const int pix1 = clip255(pred1 + ((r1 + 32) >> 6));
    sm.tile8[(8 * y8 + y) * 16 + 8 * x8 + x] = pix0;
    sm.tile8[(8 * y8 + y + 4) * 16 + 8 * x8 + x] = pix1;
    const int e0 = sv0 - pix0, e1 = sv1 - pix1;
    const int ssd = warp_sum(e0 * e0 + e1 * e1);
    if (lane == 0) {
      sm.modes8[b8] = m;
      out[oModes8 + b8] = m;
    }
    cost_acc += bc;
    ssd_acc += ssd;
    rb_acc += rate + (m == pmode ? 1 : 4);
    __syncwarp();
  }
  for (int i = lane; i < 256; i += 32) out[oTile8 + i] = sm.tile8[i];
  if (lane == 0) {
    out[oCost8] = 24 * lam + cost_acc;
    out[oSsd8] = ssd_acc;
    out[oRb8] = 24 + rb_acc;
  }
}

__global__ void __launch_bounds__(64)
intra_nxn_kernel(int* __restrict__ ry, int* __restrict__ grid,
                 const int* __restrict__ ysrc, const int* __restrict__ qp_mb,
                 const int* __restrict__ lam_p, const int* __restrict__ tab,
                 int* __restrict__ out, int d, int jmin, int mbw, int mbh) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ys = jmin + blockIdx.x, xs = d - 2 * ys;
  const int w16 = 16 * mbw, gw = 4 * mbw;
  const int y0 = 16 * ys, x0 = 16 * xs;
  const bool at = ys > 0, al = xs > 0, notlast = xs < mbw - 1;
  for (int i = tid; i < 256; i += nthr)
    sm.src[i] = ysrc[(y0 + (i >> 4)) * w16 + x0 + (i & 15)];
  for (int i = tid; i < 25; i += nthr) {
    const bool ok = at && (i == 0 ? al : (i <= 16 || notlast));
    sm.etop[i] = ok ? ry[(y0 - 1) * w16 + x0 - 1 + i] : 0;
  }
  for (int i = tid; i < 16; i += nthr)
    sm.eleft[i] = al ? ry[(y0 + i) * w16 + x0 - 1] : 0;
  if (tid < 4) {
    sm.gl[tid] = al ? grid[(4 * ys + tid) * gw + 4 * xs - 1] : -1;
    sm.gt[tid] = at ? grid[(4 * ys - 1) * gw + 4 * xs + tid] : -1;
  }
  __syncthreads();
  const int qp = qp_mb[ys * mbw + xs];
  const int lam = *lam_p;
  int* o = out + (size_t)blockIdx.x * kOutWords;
  const int lane = tid & 31;
  if (tid < 32) {
    i4_chain(sm, lane, at, al, notlast, qp, lam, tab, o);
    __syncwarp();
    for (int i = lane; i < 256; i += 32)
      ry[(y0 + (i >> 4)) * w16 + x0 + (i & 15)] = sm.rec4[i];
    if (lane < 16)
      grid[(4 * ys + (lane >> 2)) * gw + 4 * xs + (lane & 3)] =
          sm.mode4[lane];
  } else {
    i8_chain(sm, lane, at, al, notlast, qp, lam, tab, o);
  }
}

}  // namespace

extern "C" int intra_nxn_launch(void* ry, void* grid, const void* ysrc,
                                const void* qp, const void* lam,
                                const void* tab, void* out, int d, int jmin,
                                int count, int mbw, int mbh, int t8_mode,
                                void* stream) {
  if (count <= 0) return (int)cudaSuccess;
  intra_nxn_kernel<<<count, t8_mode ? 64 : 32, 0, (cudaStream_t)stream>>>(
      (int*)ry, (int*)grid, (const int*)ysrc, (const int*)qp,
      (const int*)lam, (const int*)tab, (int*)out, d, jmin, mbw, mbh);
  return (int)cudaGetLastError();
}
