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
// Design: one launch per knight step d (MBs (d - 2y, y) for y = jmin ..
// jmin + count - 1), one CUDA block per MB.  Warp 0 runs the I4x4 chain:
// the 16 blocks in z-order, each block's nine modes one per lane
// (prediction, SATD, lambda * mode bits), the first minimum by a packed
// (cost << 4) | mode key, then transform, intra deadzone quant, dequant,
// inverse transform and clip of the chosen block, on the MB's trial recon
// in shared memory.  Warp 1 (t8_mode) runs the I8x8 chain beside it: its
// intra-MB edges come from its own tile, so the two warps share only the
// MB-external edges, loaded once.  At the end warp 0 writes the trial recon
// into the recon plane and the 16 modes into the mode grid (the core then
// lets the I16 or I8x8 winner overwrite them).  All integer: bit-exact.
//
// Bound on the H100: the integer operations of the 9-mode searches (about
// 75k per MB, kernels/intra_nxn.py counts them) over the card's int32 rate,
// against a few KB per MB of bytes; both are tens of microseconds per IDR.
// The kernel is latency-bound instead: a step cannot end before one MB's
// chain of 16 dependent 4x4 blocks does, and a step holds at most 60 MBs at
// 1080p, so most SMs idle.  One persistent kernel over the whole frame is
// the later design (ROADMAP B).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the constant tables (kernels/intra_nxn.py packs them, raster positions)
constexpr int kQ4 = 0, kD4 = 96, kQ8 = 192, kD8 = 576, kZ4 = 960, kZ8 = 976;
constexpr int kTabLen = 1040;

// per-MB output row (kernels/intra_nxn.py splits it)
constexpr int oModes4 = 0, oAcs4 = 16, oNnz4 = 272, oCost4 = 288,
              oSsd4 = 289, oRb4 = 290, oTile8 = 291, oModes8 = 547,
              oLv64 = 551, oCost8 = 807, oSsd8 = 808, oRb8 = 809;
constexpr int kOutWords = 810;

struct Smem {
  int tab[kTabLen];
  int src[256];
  int etop[25];     // row y0-1, columns x0-1 .. x0+23 (0 where unavailable)
  int eleft[16];    // column x0-1, rows y0 .. y0+15
  int gl[4], gt[4]; // mode grid left of / above the MB (-1 outside)
  // warp 0: I4x4
  int rec4[256];
  int mode4[16];
  int pred4[9 * 16];
  int c4[16];
  int lv4[16];
  int t4[9], l4[5];
  // warp 1: I8x8
  int tile8[256];
  int pred8[9 * 64];
  int c8[64];
  int lv8[64];
  int rt[16], rl[8], rtl;
  int ft[17], fl[9];
  int modes8[4];
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
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

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// sum of |H4 . d . H4^T| over one 4x4 block
__device__ __forceinline__ int hadamard_abs(int d[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s01 = d[4 * i] + d[4 * i + 1], d01 = d[4 * i] - d[4 * i + 1];
    const int s23 = d[4 * i + 2] + d[4 * i + 3],
              d23 = d[4 * i + 2] - d[4 * i + 3];
    d[4 * i] = s01 + s23;
    d[4 * i + 1] = s01 - s23;
    d[4 * i + 2] = d01 - d23;
    d[4 * i + 3] = d01 + d23;
  }
  int sum = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s01 = d[j] + d[4 + j], d01 = d[j] - d[4 + j];
    const int s23 = d[8 + j] + d[12 + j], d23 = d[8 + j] - d[12 + j];
    sum += abs(s01 + s23) + abs(s01 - s23) + abs(d01 - d23) + abs(d01 + d23);
  }
  return sum;
}

// ---- prediction: T(i) = t[i + 1] (t[0] the corner), L(i) = l[i + 1] ----

__device__ int pred4(int m, int x, int y, const int* t, const int* l,
                     int dc) {
#define T(i) t[(i) + 1]
#define L(i) l[(i) + 1]
  const int tl = t[0];
  switch (m) {
    case 0: return T(x);
    case 1: return L(y);
    case 2: return dc;
    case 3: {
      if (x == 3 && y == 3) return (T(6) + 3 * T(7) + 2) >> 2;
      const int s = x + y;
      return (T(imin(s, 5)) + 2 * T(imin(s + 1, 6)) + T(imin(s + 2, 7)) + 2)
             >> 2;
    }
    case 4: {
      const int z = x - y;
      if (z > 0)
        return (T(imax(z - 2, -1)) + 2 * T(imax(z - 1, -1)) + T(z) + 2) >> 2;
      if (z < 0) {
        const int w = -z;
        return (L(imax(w - 2, -1)) + 2 * L(imax(w - 1, -1)) + L(w) + 2) >> 2;
      }
      return (T(0) + 2 * tl + L(0) + 2) >> 2;
    }
    case 5: {
      const int zvr = 2 * x - y, i = x - (y >> 1);
      if (zvr >= 0) {
        if ((zvr & 1) == 0) return (T(imax(i - 1, -1)) + T(imax(i, -1)) + 1) >> 1;
        return (T(imax(i - 2, -1)) + 2 * T(imax(i - 1, -1)) + T(imax(i, -1))
                + 2) >> 2;
      }
      if (zvr == -1) return (L(0) + 2 * tl + T(0) + 2) >> 2;
      return (L(imax(y - 1, -1)) + 2 * L(imax(y - 2, -1)) + L(imax(y - 3, -1))
              + 2) >> 2;
    }
    case 6: {
      const int zhd = 2 * y - x, j = y - (x >> 1);
      if (zhd >= 0) {
        if ((zhd & 1) == 0) return (L(imax(j - 1, -1)) + L(imax(j, -1)) + 1) >> 1;
        return (L(imax(j - 2, -1)) + 2 * L(imax(j - 1, -1)) + L(imax(j, -1))
                + 2) >> 2;
      }
      if (zhd == -1) return (L(0) + 2 * tl + T(0) + 2) >> 2;
      return (T(imax(x - 1, -1)) + 2 * T(imax(x - 2, -1)) + T(imax(x - 3, -1))
              + 2) >> 2;
    }
    case 7: {
      const int k = x + (y >> 1);
      if ((y & 1) == 0) return (T(k) + T(imin(k + 1, 7)) + 1) >> 1;
      return (T(k) + 2 * T(imin(k + 1, 7)) + T(imin(k + 2, 7)) + 2) >> 2;
    }
    default: {
      const int zhu = x + 2 * y, mm = y + (x >> 1);
      if (zhu > 5) return L(3);
      if (zhu == 5) return (L(2) + 3 * L(3) + 2) >> 2;
      if ((zhu & 1) == 0) return (L(imin(mm, 3)) + L(imin(mm + 1, 3)) + 1) >> 1;
      return (L(imin(mm, 3)) + 2 * L(imin(mm + 1, 3)) + L(imin(mm + 2, 3)) + 2)
             >> 2;
    }
  }
}

// t, l: the filtered edges (8.3.2.2.1), t[0] = l[0] the filtered corner
__device__ int pred8(int m, int x, int y, const int* t, const int* l,
                     int dc) {
  const int tl = t[0];
  switch (m) {
    case 0: return T(x);
    case 1: return L(y);
    case 2: return dc;
    case 3: {
      if (x == 7 && y == 7) return (T(14) + 3 * T(15) + 2) >> 2;
      const int s = x + y;
      return (T(s) + 2 * T(imin(s + 1, 15)) + T(imin(s + 2, 15)) + 2) >> 2;
    }
    case 4: {
      const int z = x - y;
      if (z > 0)
        return (T(imax(z - 2, -1)) + 2 * T(imax(z - 1, -1)) + T(z) + 2) >> 2;
      if (z < 0) {
        const int w = -z;
        return (L(imax(w - 2, -1)) + 2 * L(imax(w - 1, -1)) + L(w) + 2) >> 2;
      }
      return (T(0) + 2 * tl + L(0) + 2) >> 2;
    }
    case 5: {
      const int zvr = 2 * x - y, i = x - (y >> 1);
      if (zvr >= 0) {
        if ((zvr & 1) == 0) return (T(imax(i - 1, -1)) + T(imax(i, -1)) + 1) >> 1;
        return (T(imax(i - 2, -1)) + 2 * T(imax(i - 1, -1)) + T(imax(i, -1))
                + 2) >> 2;
      }
      if (zvr == -1) return (L(0) + 2 * tl + T(0) + 2) >> 2;
      const int q = y - 2 * x;
      return (L(imax(q - 1, -1)) + 2 * L(imax(q - 2, -1)) + L(imax(q - 3, -1))
              + 2) >> 2;
    }
    case 6: {
      const int zhd = 2 * y - x, j = y - (x >> 1);
      if (zhd >= 0) {
        if ((zhd & 1) == 0) return (L(imax(j - 1, -1)) + L(imax(j, -1)) + 1) >> 1;
        return (L(imax(j - 2, -1)) + 2 * L(imax(j - 1, -1)) + L(imax(j, -1))
                + 2) >> 2;
      }
      if (zhd == -1) return (L(0) + 2 * tl + T(0) + 2) >> 2;
      const int r = x - 2 * y;
      return (T(imax(r - 1, -1)) + 2 * T(imax(r - 2, -1)) + T(imax(r - 3, -1))
              + 2) >> 2;
    }
    case 7: {
      const int k = x + (y >> 1);
      if ((y & 1) == 0) return (T(k) + T(imin(k + 1, 15)) + 1) >> 1;
      return (T(k) + 2 * T(imin(k + 1, 15)) + T(imin(k + 2, 15)) + 2) >> 2;
    }
    default: {
      const int zhu = x + 2 * y, mm = y + (x >> 1);
      if (zhu > 13) return L(7);
      if (zhu == 13) return (L(6) + 3 * L(7) + 2) >> 2;
      if ((zhu & 1) == 0) return (L(imin(mm, 7)) + L(imin(mm + 1, 7)) + 1) >> 1;
      return (L(imin(mm, 7)) + 2 * L(imin(mm + 1, 7)) + L(imin(mm + 2, 7)) + 2)
             >> 2;
    }
  }
#undef T
#undef L
}

// mode availability [V, H, DC, DDL, DDR, VR, HD, VL, HU] (8.3.1.2)
__device__ __forceinline__ bool mode_avail(int m, bool at, bool al, bool atl) {
  const bool full = at && al && atl;
  switch (m) {
    case 0: case 3: case 7: return at;
    case 1: case 8: return al;
    case 2: return true;
    default: return full;
  }
}

__device__ __forceinline__ int dc_of(bool at, bool al, int st, int sl,
                                     int both_add, int both_sh, int one_add,
                                     int one_sh) {
  if (at && al) return (st + sl + both_add) >> both_sh;
  if (at) return (st + one_add) >> one_sh;
  if (al) return (sl + one_add) >> one_sh;
  return 128;
}

// 4-point forward core transform (Cf) in place on v[0], v[s], v[2s], v[3s]
__device__ __forceinline__ void cf4(int* v, int s) {
  const int x0 = v[0], x1 = v[s], x2 = v[2 * s], x3 = v[3 * s];
  const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  v[0] = s03 + s12;
  v[s] = 2 * d03 + d12;
  v[2 * s] = s03 - s12;
  v[3 * s] = d03 - 2 * d12;
}

// 4-point normative inverse (8.5.12.2) in place
__device__ __forceinline__ void icf4(int* v, int s) {
  const int d0 = v[0], d1 = v[s], d2 = v[2 * s], d3 = v[3 * s];
  const int e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  v[0] = e0 + e3;
  v[s] = e1 + e2;
  v[2 * s] = e1 - e2;
  v[3 * s] = e0 - e3;
}

// 8-point forward transform (High profile, x264's order) in place
__device__ __forceinline__ void dct8(int* v, int s) {
  int d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = v[i * s];
  const int s07 = d[0] + d[7], s16 = d[1] + d[6], s25 = d[2] + d[5],
            s34 = d[3] + d[4];
  const int a0 = s07 + s34, a1 = s16 + s25, a2 = s07 - s34, a3 = s16 - s25;
  const int d07 = d[0] - d[7], d16 = d[1] - d[6], d25 = d[2] - d[5],
            d34 = d[3] - d[4];
  const int a4 = d16 + d25 + (d07 + (d07 >> 1));
  const int a5 = d07 - d34 - (d25 + (d25 >> 1));
  const int a6 = d07 + d34 - (d16 + (d16 >> 1));
  const int a7 = d16 - d25 + (d34 + (d34 >> 1));
  v[0] = a0 + a1;
  v[s] = a4 + (a7 >> 2);
  v[2 * s] = a2 + (a3 >> 1);
  v[3 * s] = a5 + (a6 >> 2);
  v[4 * s] = a0 - a1;
  v[5 * s] = a6 - (a5 >> 2);
  v[6 * s] = (a2 >> 1) - a3;
  v[7 * s] = (a4 >> 2) - a7;
}

// 8-point normative inverse (8.5.12.3) in place
__device__ __forceinline__ void idct8(int* v, int s) {
  int d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = v[i * s];
  const int e0 = d[0] + d[4], e2 = d[0] - d[4];
  const int e4 = (d[2] >> 1) - d[6], e6 = d[2] + (d[6] >> 1);
  const int e1 = -d[3] + d[5] - d[7] - (d[7] >> 1);
  const int e3 = d[1] + d[7] - d[3] - (d[3] >> 1);
  const int e5 = -d[1] + d[7] + d[5] + (d[5] >> 1);
  const int e7 = d[3] + d[5] + d[1] + (d[1] >> 1);
  const int f0 = e0 + e6, f2 = e2 + e4, f4 = e2 - e4, f6 = e0 - e6;
  const int f1 = e1 + (e7 >> 2), f3 = e3 + (e5 >> 2);
  const int f5 = (e3 >> 2) - e5, f7 = e7 - (e1 >> 2);
  v[0] = f0 + f7;
  v[s] = f2 + f5;
  v[2 * s] = f4 + f3;
  v[3 * s] = f6 + f1;
  v[4 * s] = f6 - f1;
  v[5 * s] = f4 - f3;
  v[6 * s] = f2 - f5;
  v[7 * s] = f0 - f7;
}

// ---- warp 0: the I4x4 chain ----
__device__ void i4_chain(Smem& sm, int lane, bool at, bool al, bool notlast,
                         int qp, int lam, int* out) {
  const int q6 = qp / 6, qm = qp % 6;
  const int qbits = 15 + q6, fq = (1 << qbits) / 3;
  int cost_acc = 24 * lam, ssd_acc = 0, rb_acc = 24;
  for (int k = 0; k < 16; ++k) {
    const int x4 = (k & 1) | ((k >> 1) & 2);
    const int y4 = ((k >> 1) & 1) | ((k >> 2) & 2);
    const int r = 4 * y4 + x4;
    const bool a4 = y4 > 0 || at;
    const bool l4 = x4 > 0 || al;
    const bool tl4 = (y4 > 0 && x4 > 0) ? true
                     : (y4 > 0 ? al : (x4 > 0 ? at : (at && al)));
    const bool tr4 = y4 == 0 ? (x4 < 3 ? at : (at && notlast))
                             : (x4 < 3 && z4(x4 + 1, y4 - 1) < z4(x4, y4));
    // edges: raw top p[0..7,-1], the corner, left p[-1,0..3]
    if (lane < 8) {
      int v = 0;
      if (y4 == 0)
        v = sm.etop[1 + 4 * x4 + lane];
      else if (4 * x4 + lane < 16)
        v = sm.rec4[(4 * y4 - 1) * 16 + 4 * x4 + lane];
      sm.t4[1 + lane] = v;
    } else if (lane == 8) {
      const int v = y4 == 0 ? sm.etop[4 * x4]
                    : (x4 == 0 ? sm.eleft[4 * y4 - 1]
                               : sm.rec4[(4 * y4 - 1) * 16 + 4 * x4 - 1]);
      sm.t4[0] = v;
      sm.l4[0] = v;
    } else if (lane < 13) {
      const int i = lane - 9;
      sm.l4[1 + i] = x4 == 0 ? sm.eleft[4 * y4 + i]
                             : sm.rec4[(4 * y4 + i) * 16 + 4 * x4 - 1];
    }
    __syncwarp();
    if (!tr4 && lane >= 4 && lane < 8) sm.t4[1 + lane] = sm.t4[4];
    __syncwarp();
    // the predicted mode from the left and top blocks' modes
    const int lm = x4 > 0 ? sm.mode4[r - 1] : sm.gl[y4];
    const int tm = y4 > 0 ? sm.mode4[r - 4] : sm.gt[x4];
    const int pmode = (lm < 0 || tm < 0) ? 2 : imin(lm, tm);
    const int* src = sm.src + (4 * y4) * 16 + 4 * x4;
    unsigned long long key = ~0ull;
    if (lane < 9 && mode_avail(lane, a4, l4, tl4)) {
      const int st = sm.t4[1] + sm.t4[2] + sm.t4[3] + sm.t4[4];
      const int sl = sm.l4[1] + sm.l4[2] + sm.l4[3] + sm.l4[4];
      const int dc = dc_of(a4, l4, st, sl, 4, 3, 2, 2);
      int d[16];
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int pv = pred4(lane, p & 3, p >> 2, sm.t4, sm.l4, dc);
        sm.pred4[lane * 16 + p] = pv;
        d[p] = src[(p >> 2) * 16 + (p & 3)] - pv;
      }
      const int cost = (hadamard_abs(d) >> 1) + lam * (lane == pmode ? 1 : 4);
      key = ((unsigned long long)(unsigned)cost << 4) | (unsigned)lane;
    }
    key = warp_min(key);
    const int m = (int)(key & 15);
    const int bc = (int)(key >> 4);
    __syncwarp();
    const int* pred = sm.pred4 + m * 16;
    if (lane < 16) sm.c4[lane] = src[(lane >> 2) * 16 + (lane & 3)] - pred[lane];
    __syncwarp();
    if (lane < 4) cf4(sm.c4 + lane, 4);          // vertical
    __syncwarp();
    if (lane < 4) cf4(sm.c4 + 4 * lane, 1);      // horizontal
    __syncwarp();
    int lv = 0;
    if (lane < 16) {
      const int c = sm.c4[lane];
      const int a = ((c < 0 ? -c : c) * sm.tab[kQ4 + qm * 16 + lane] + fq)
                    >> qbits;
      lv = c < 0 ? -a : a;
      sm.lv4[lane] = lv;
      sm.c4[lane] = (lv * sm.tab[kD4 + qm * 16 + lane]) << q6;
    }
    const int nnz = __popc(__ballot_sync(kFull, lv != 0));
    const int rate = warp_sum(rate_of(lv));
    __syncwarp();
    if (lane < 16)
      out[oAcs4 + r * 16 + lane] = sm.lv4[sm.tab[kZ4 + lane]];
    if (lane < 4) icf4(sm.c4 + 4 * lane, 1);     // horizontal
    __syncwarp();
    if (lane < 4) icf4(sm.c4 + lane, 4);         // vertical
    __syncwarp();
    int e2 = 0;
    if (lane < 16) {
      const int pix = clip255(pred[lane] + ((sm.c4[lane] + 32) >> 6));
      sm.rec4[(4 * y4 + (lane >> 2)) * 16 + 4 * x4 + (lane & 3)] = pix;
      const int e = src[(lane >> 2) * 16 + (lane & 3)] - pix;
      e2 = e * e;
    }
    const int ssd = warp_sum(e2);
    if (lane == 0) {
      sm.mode4[r] = m;
      out[oModes4 + r] = m;
      out[oNnz4 + r] = nnz;
    }
    cost_acc += bc;
    ssd_acc += ssd;
    rb_acc += rate + (m == pmode ? 1 : 4);
    __syncwarp();
  }
  if (lane == 0) {
    out[oCost4] = cost_acc;
    out[oSsd4] = ssd_acc;
    out[oRb4] = rb_acc;
  }
}

// ---- warp 1: the I8x8 chain ----
__device__ void i8_chain(Smem& sm, int lane, bool at, bool al, bool notlast,
                         int qp, int lam, int* out) {
  const int q6 = qp / 6, qm = qp % 6;
  const int qbits = 16 + q6, fq = (1 << qbits) / 3;
  int cost_acc = 24 * lam, ssd_acc = 0, rb_acc = 24;
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
    // raw edges: top p[0..15,-1], left p[-1,0..7], the corner
    if (lane < 16) {
      sm.rt[lane] = y8 == 0 ? sm.etop[1 + 8 * x8 + lane]
                    : sm.tile8[7 * 16 + (x8 == 0 ? lane : 8 + (lane & 7))];
    } else if (lane < 24) {
      const int i = lane - 16;
      sm.rl[i] = x8 == 0 ? sm.eleft[8 * y8 + i]
                         : sm.tile8[(8 * y8 + i) * 16 + 7];
    } else if (lane == 24) {
      sm.rtl = y8 == 0 ? sm.etop[8 * x8]
               : (x8 == 0 ? sm.eleft[7] : sm.tile8[7 * 16 + 7]);
    }
    __syncwarp();
    if (!a_tr && lane >= 8 && lane < 16) sm.rt[lane] = sm.rt[7];
    __syncwarp();
    // the 8.3.2.2.1 low-pass filter
    {
      const int* t = sm.rt;
      const int* l = sm.rl;
      const int tl = sm.rtl;
      if (lane == 0)
        sm.ft[1] = a_tl ? (tl + 2 * t[0] + t[1] + 2) >> 2
                        : (3 * t[0] + t[1] + 2) >> 2;
      else if (lane < 15)
        sm.ft[1 + lane] = (t[lane - 1] + 2 * t[lane] + t[lane + 1] + 2) >> 2;
      else if (lane == 15)
        sm.ft[16] = (t[14] + 3 * t[15] + 2) >> 2;
      else if (lane == 16)
        sm.fl[1] = a_tl ? (tl + 2 * l[0] + l[1] + 2) >> 2
                        : (3 * l[0] + l[1] + 2) >> 2;
      else if (lane < 23) {
        const int i = lane - 16;
        sm.fl[1 + i] = (l[i - 1] + 2 * l[i] + l[i + 1] + 2) >> 2;
      } else if (lane == 23)
        sm.fl[8] = (l[6] + 3 * l[7] + 2) >> 2;
      else if (lane == 24) {
        const int f = (a_t && a_l) ? (t[0] + 2 * tl + l[0] + 2) >> 2
                      : a_t ? (3 * tl + t[0] + 2) >> 2
                      : a_l ? (3 * tl + l[0] + 2) >> 2 : tl;
        sm.ft[0] = f;
        sm.fl[0] = f;
      }
    }
    __syncwarp();
    int lm, tm;
    if (b8 == 0) { lm = sm.gl[0]; tm = sm.gt[0]; }
    else if (b8 == 1) { lm = sm.modes8[0]; tm = sm.gt[2]; }
    else if (b8 == 2) { lm = sm.gl[2]; tm = sm.modes8[0]; }
    else { lm = sm.modes8[2]; tm = sm.modes8[1]; }
    const int pmode = (lm < 0 || tm < 0) ? 2 : imin(lm, tm);
    const int* src = sm.src + (8 * y8) * 16 + 8 * x8;
    unsigned long long key = ~0ull;
    if (lane < 9 && mode_avail(lane, a_t, a_l, a_tl)) {
      int st = 0, sl = 0;
#pragma unroll
      for (int i = 1; i <= 8; ++i) {
        st += sm.ft[i];
        sl += sm.fl[i];
      }
      const int dc = dc_of(a_t, a_l, st, sl, 8, 4, 4, 3);
      int satd = 0;
#pragma unroll
      for (int sb = 0; sb < 4; ++sb) {
        const int bx = 4 * (sb & 1), by = 4 * (sb >> 1);
        int d[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          const int x = bx + (p & 3), y = by + (p >> 2);
          const int pv = pred8(lane, x, y, sm.ft, sm.fl, dc);
          sm.pred8[lane * 64 + y * 8 + x] = pv;
          d[p] = src[y * 16 + x] - pv;
        }
        satd += hadamard_abs(d);
      }
      const int cost = (satd >> 1) + lam * (lane == pmode ? 1 : 4);
      key = ((unsigned long long)(unsigned)cost << 4) | (unsigned)lane;
    }
    key = warp_min(key);
    const int m = (int)(key & 15);
    const int bc = (int)(key >> 4);
    __syncwarp();
    const int* pred = sm.pred8 + m * 64;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      sm.c8[p] = src[(p >> 3) * 16 + (p & 7)] - pred[p];
    }
    __syncwarp();
    if (lane < 8) dct8(sm.c8 + lane, 8);         // vertical
    __syncwarp();
    if (lane < 8) dct8(sm.c8 + 8 * lane, 1);     // horizontal
    __syncwarp();
    int rate = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const int c = sm.c8[p];
      const int a = ((c < 0 ? -c : c) * sm.tab[kQ8 + qm * 64 + p] + fq)
                    >> qbits;
      const int lv = c < 0 ? -a : a;
      sm.lv8[p] = lv;
      rate += rate_of(lv);
      const int ls16 = sm.tab[kD8 + qm * 64 + p] * 16;
      sm.c8[p] = q6 >= 6 ? (lv * ls16) << (q6 - 6)
                         : (lv * ls16 + (1 << (5 - q6))) >> (6 - q6);
    }
    rate = warp_sum(rate);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kz = lane + 32 * h;
      out[oLv64 + b8 * 64 + kz] = sm.lv8[sm.tab[kZ8 + kz]];
    }
    if (lane < 8) idct8(sm.c8 + 8 * lane, 1);    // horizontal
    __syncwarp();
    if (lane < 8) idct8(sm.c8 + lane, 8);        // vertical
    __syncwarp();
    int e2 = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = lane + 32 * h;
      const int y = p >> 3, x = p & 7;
      const int pix = clip255(pred[p] + ((sm.c8[p] + 32) >> 6));
      sm.tile8[(8 * y8 + y) * 16 + 8 * x8 + x] = pix;
      const int e = src[y * 16 + x] - pix;
      e2 += e * e;
    }
    const int ssd = warp_sum(e2);
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
    out[oCost8] = cost_acc;
    out[oSsd8] = ssd_acc;
    out[oRb8] = rb_acc;
  }
}

__global__ void intra_nxn_kernel(int* __restrict__ ry, int* __restrict__ grid,
                                 const int* __restrict__ ysrc,
                                 const int* __restrict__ qp_mb,
                                 const int* __restrict__ lam_p,
                                 const int* __restrict__ tab,
                                 int* __restrict__ out, int d, int jmin,
                                 int mbw, int mbh) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ys = jmin + blockIdx.x, xs = d - 2 * ys;
  const int w16 = 16 * mbw, gw = 4 * mbw;
  const int y0 = 16 * ys, x0 = 16 * xs;
  const bool at = ys > 0, al = xs > 0, notlast = xs < mbw - 1;
  for (int i = tid; i < kTabLen; i += nthr) sm.tab[i] = tab[i];
  for (int i = tid; i < 256; i += nthr) {
    sm.src[i] = ysrc[(y0 + (i >> 4)) * w16 + x0 + (i & 15)];
    sm.rec4[i] = 0;
    sm.tile8[i] = 0;
  }
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
    i4_chain(sm, lane, at, al, notlast, qp, lam, o);
    __syncwarp();
    for (int i = lane; i < 256; i += 32)
      ry[(y0 + (i >> 4)) * w16 + x0 + (i & 15)] = sm.rec4[i];
    if (lane < 16)
      grid[(4 * ys + (lane >> 2)) * gw + 4 * xs + (lane & 3)] =
          sm.mode4[lane];
  } else {
    i8_chain(sm, lane, at, al, notlast, qp, lam, o);
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
