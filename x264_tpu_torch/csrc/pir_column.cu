// The periodic-intra-refresh bar of a P frame, for Hopper (sm_90a).
//
// Replaces: x264_tpu/models/inter_device.py::_pir_column_pass, which the
// reference runs as XLA (a lax.scan over the MB rows, the bar's columns
// unrolled inside each step; no Pallas kernel).  Eager PyTorch would pay
// some 60-100 small launches per MB for it.  The plain twin, bit for bit,
// is x264_tpu_torch/kernels/pir_column.py::pir_column_pass_plain.
//
// Contract: the bar is ncols MB columns from pir_col on; columns at or past
// mbw are skipped.  Each bar MB, rows top to bottom and the columns of a
// row left to right, is coded as I16x16 from the live int32 recon planes
// (so it sees the bar MBs above and left of it): the first cheapest of the
// four I16x16 modes [V, H, DC, Plane] by SATD among the available ones, the
// 4x4 transform, the DC Hadamard, the intra deadzone quantiser (no
// trellis), dequantisation and the inverse; then chroma the same way with
// the modes [DC, H, V, Plane] by the sum of the U and V SATDs.  The recon
// planes and the MB's fields are written in place.
//
// Bound on the H100: bytes and operations are tiny (a few KB and ~34k
// int32 operations per MB, kernels/pir_column.py counts them: well under
// a microsecond for a 1080p bar).  The kernel is latency-bound instead:
// every MB depends on the one above it and the one to its left, so the bar
// is one chain of bar_mbs steps (204 at 1080p with keyint 60).  The design
// is the simplest that keeps that chain on the card: one launch per P
// frame, one CUDA block of 256 threads (a thread per luma pixel; 128 of
// them take the chroma pixels) walking the MBs in order, each step a few
// barrier-separated phases in shared memory.  All integer: bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
// the constant block (kernels/pir_column.py packs it): zigzag, then the 4x4
// quant and dequant tables by qp % 6, raster positions
constexpr int kZig = 0, kQ4 = 16, kD4 = 112;

struct Fields {
  int* luma_dc;      // (N, 16) zigzag DC levels
  int* luma_ac;      // (N, 16, 16) zigzag AC levels per raster 4x4 block
  int* luma_nnz;     // (N, 16)
  int* nnz_deblock;  // (N, 16)
  int* cbp_luma;     // (N,)
  int* chroma_dc;    // (N, 2, 4)
  int* chroma_ac;    // (N, 2, 4, 16)
  int* chroma_nnz;   // (N, 2, 4)
  int* cbp_chroma;   // (N,)
  int* i16_mode;     // (N,)
  int* chroma_mode;  // (N,)
  int* mb_cost;      // (N,)
  bool* intra_mask;  // (N,)
  bool* t8;          // (N,)
};

struct Smem {
  int tab[208];
  int src[256];          // luma source, raster in the MB
  int diff[4][256];      // source - prediction per luma mode
  int coef[256];         // the chosen mode's coefficients, block-major
  int blk[4][16];        // |Hadamard| sums per mode and 4x4 block
  int top[16], left[16], tl;
  int dc_pred, pl_a, pl_b, pl_c;
  int cost;              // the chosen luma mode's SATD
  int mode;
  int dc[16], dcq[16], dcdeq[16];
  int nnz[16];
  int csrc[2][64];
  int cdiff[4][2][64];   // per chroma mode and plane
  int cblk[4][2][4];
  int ctop[2][8], cleft[2][8], ctl[2];
  int cq[2][4];          // chroma DC per quadrant (00, 10, 01, 11)
  int cpa[2], cpb[2], cpc[2];
  int cmode;
  int ccoef[2][64];      // block-major per plane
  int cdc[2][4];         // their DC coefficients
  int cdcq[2][4], cdcdeq[2][4];
  int cnnz[2][4];
};

__device__ __forceinline__ int clamp255(int x) {
  return x < 0 ? 0 : (x > 255 ? 255 : x);
}

// H4 over one axis: (x0, x1, x2, x3) -> the butterfly of ops/pixel.hadamard4
__device__ __forceinline__ void had4(int& a, int& b, int& c, int& d) {
  const int s01 = a + b, d01 = a - b, s23 = c + d, d23 = c - d;
  a = s01 + s23;
  b = s01 - s23;
  c = d01 - d23;
  d = d01 + d23;
}

// H4 x H4^T of a 4x4 block held raster in v[16], in place
__device__ void had4x4(int* v) {
  for (int r = 0; r < 4; ++r)
    had4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
  for (int c = 0; c < 4; ++c) had4(v[c], v[4 + c], v[8 + c], v[12 + c]);
}

// sum |H4 x H4^T| of a 4x4 block held raster in v[16]
__device__ int satd4(int* v) {
  had4x4(v);
  int s = 0;
  for (int k = 0; k < 16; ++k) s += v[k] < 0 ? -v[k] : v[k];
  return s;
}

// the forward core transform rows of ops/transform._cf_rows
__device__ __forceinline__ void cf4(int& x0, int& x1, int& x2, int& x3) {
  const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  x0 = s03 + s12;
  x1 = 2 * d03 + d12;
  x2 = s03 - s12;
  x3 = d03 - 2 * d12;
}

__device__ void dct4(int* v) {  // raster 4x4, in place
  for (int c = 0; c < 4; ++c) cf4(v[c], v[4 + c], v[8 + c], v[12 + c]);
  for (int r = 0; r < 4; ++r)
    cf4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
}

// normative 4x4 inverse (8.5.12.2) with the final (x + 32) >> 6, as
// ops/transform.idct4x4: along each row first, then along each column
__device__ void idct4(int* d) {
  int f[16];
  for (int r = 0; r < 4; ++r) {
    const int* x = d + 4 * r;
    const int e0 = x[0] + x[2], e1 = x[0] - x[2];
    const int e2 = (x[1] >> 1) - x[3], e3 = x[1] + (x[3] >> 1);
    f[4 * r] = e0 + e3;
    f[4 * r + 1] = e1 + e2;
    f[4 * r + 2] = e1 - e2;
    f[4 * r + 3] = e0 - e3;
  }
  for (int c = 0; c < 4; ++c) {
    const int g0 = f[c] + f[8 + c], g1 = f[c] - f[8 + c];
    const int g2 = (f[4 + c] >> 1) - f[12 + c];
    const int g3 = f[4 + c] + (f[12 + c] >> 1);
    d[c] = (g0 + g3 + 32) >> 6;
    d[4 + c] = (g1 + g2 + 32) >> 6;
    d[8 + c] = (g1 - g2 + 32) >> 6;
    d[12 + c] = (g0 - g3 + 32) >> 6;
  }
}

// the intra deadzone quant of ops/transform.quant4x4 / _dc_quant
__device__ __forceinline__ int quant(int c, int mf, int f, int qbits) {
  const int a = c < 0 ? -c : c;
  const int l = (a * mf + f) >> qbits;
  return c < 0 ? -l : l;
}

// the DC of a plane-mode predictor's gradient: sum_{x=1..half} x *
// (e[half-1+x] - e[half-1-x]) with e[-1] = the corner
__device__ int gradient(const int* e, int corner, int half) {
  int s = 0;
  for (int x = 1; x <= half; ++x) {
    const int hi = e[half - 1 + x];
    const int lo = half - 1 - x >= 0 ? e[half - 1 - x] : corner;
    s += x * (hi - lo);
  }
  return s;
}

__device__ int dc_pred(bool at, bool al, int st, int sl, int both_add,
                       int both_sh, int one_add, int one_sh) {
  if (at && al) return (st + sl + both_add) >> both_sh;
  if (at) return (st + one_add) >> one_sh;
  if (al) return (sl + one_add) >> one_sh;
  return 128;
}

__global__ void __launch_bounds__(256)
pir_column_kernel(const uint8_t* __restrict__ ysrc,
                  const uint8_t* __restrict__ usrc,
                  const uint8_t* __restrict__ vsrc, int* ry, int* ru, int* rv,
                  const int* __restrict__ qpa, const int* __restrict__ qpca,
                  Fields out, const int* __restrict__ tab_g, int pir_col,
                  int ncols, int mbw, int mbh) {
  __shared__ Smem s;
  const int t = threadIdx.x;
  const int W = 16 * mbw, CW = 8 * mbw;
  for (int k = t; k < 208; k += 256) s.tab[k] = tab_g[k];
  const int py = t >> 4, px = t & 15;
  // chroma lanes: threads 0-127, plane t >> 6, pixel t & 63
  const int cpl = (t >> 6) & 1, cp = t & 63, cy = cp >> 3, cx = cp & 7;
  const bool clane = t < 128;

  for (int r = 0; r < mbh; ++r) {
    for (int ci = 0; ci < ncols; ++ci) {
      const int c = pir_col + ci;
      if (c >= mbw) continue;  // uniform across the block
      const bool at = r > 0, al = c > 0;
      const int y0 = 16 * r, x0 = 16 * c, cy0 = 8 * r, cx0 = 8 * c;
      const int mb = r * mbw + c;
      const int qp = qpa[mb], qpc = qpca[mb];
      __syncthreads();  // the previous MB's recon writes are visible

      // ---- load the source and the edges (clamped reads) ----
      s.src[t] = ysrc[(y0 + py) * W + x0 + px];
      const int yt = y0 > 0 ? y0 - 1 : 0, xl = x0 > 0 ? x0 - 1 : 0;
      if (t < 16) s.top[t] = ry[yt * W + x0 + t];
      else if (t < 32) s.left[t - 16] = ry[(y0 + t - 16) * W + xl];
      else if (t == 32) s.tl = ry[yt * W + xl];
      if (clane) {
        const uint8_t* sp = cpl ? vsrc : usrc;
        s.csrc[cpl][cp] = sp[(cy0 + cy) * CW + cx0 + cx];
      }
      const int cyt = cy0 > 0 ? cy0 - 1 : 0, cxl = cx0 > 0 ? cx0 - 1 : 0;
      if (t >= 64 && t < 96) {
        const int k = t - 64, pl = k >> 4, i = k & 7;
        int* rp = pl ? rv : ru;
        if ((k & 15) < 8) s.ctop[pl][i] = rp[cyt * CW + cx0 + i];
        else s.cleft[pl][i] = rp[(cy0 + i) * CW + cxl];
      } else if (t == 96 || t == 97) {
        int* rp = t == 97 ? rv : ru;
        s.ctl[t - 96] = rp[cyt * CW + cxl];
      }
      __syncthreads();

      // ---- predictor scalars ----
      if (t == 0) {
        int st = 0, sl = 0;
        for (int k = 0; k < 16; ++k) {
          st += s.top[k];
          sl += s.left[k];
        }
        s.dc_pred = dc_pred(at, al, st, sl, 16, 5, 8, 4);
        s.pl_b = (5 * gradient(s.top, s.tl, 8) + 32) >> 6;
        s.pl_c = (5 * gradient(s.left, s.tl, 8) + 32) >> 6;
        s.pl_a = 16 * (s.left[15] + s.top[15]);
      } else if (t == 32 || t == 64) {
        const int pl = t == 64;
        const int* tp = s.ctop[pl];
        const int* lp = s.cleft[pl];
        const int st0 = tp[0] + tp[1] + tp[2] + tp[3];
        const int st1 = tp[4] + tp[5] + tp[6] + tp[7];
        const int sl0 = lp[0] + lp[1] + lp[2] + lp[3];
        const int sl1 = lp[4] + lp[5] + lp[6] + lp[7];
        s.cq[pl][0] = dc_pred(at, al, st0, sl0, 4, 3, 2, 2);
        s.cq[pl][3] = dc_pred(at, al, st1, sl1, 4, 3, 2, 2);
        s.cq[pl][1] = at ? (st1 + 2) >> 2 : (al ? (sl0 + 2) >> 2 : 128);
        s.cq[pl][2] = al ? (sl1 + 2) >> 2 : (at ? (st0 + 2) >> 2 : 128);
        s.cpa[pl] = 16 * (lp[7] + tp[7]);
        s.cpb[pl] = (17 * gradient(tp, s.ctl[pl], 4) + 16) >> 5;
        s.cpc[pl] = (17 * gradient(lp, s.ctl[pl], 4) + 16) >> 5;
      }
      __syncthreads();

      // ---- every mode's prediction and difference ----
      {
        const int v = s.src[t];
        const int pv = s.top[px], ph = s.left[py], pd = s.dc_pred;
        const int pp = clamp255(
            (s.pl_a + s.pl_b * (px - 7) + s.pl_c * (py - 7) + 16) >> 5);
        s.diff[0][t] = v - pv;
        s.diff[1][t] = v - ph;
        s.diff[2][t] = v - pd;
        s.diff[3][t] = v - pp;
      }
      if (clane) {
        const int v = s.csrc[cpl][cp];
        const int q = (cy < 4 ? 0 : 2) + (cx < 4 ? 0 : 1);
        const int pdc = s.cq[cpl][q];
        const int ph = s.cleft[cpl][cy], pv = s.ctop[cpl][cx];
        const int pp = clamp255((s.cpa[cpl] + s.cpb[cpl] * (cx - 3) +
                                 s.cpc[cpl] * (cy - 3) + 16) >> 5);
        s.cdiff[0][cpl][cp] = v - pdc;
        s.cdiff[1][cpl][cp] = v - ph;
        s.cdiff[2][cpl][cp] = v - pv;
        s.cdiff[3][cpl][cp] = v - pp;
      }
      __syncthreads();

      // ---- SATD of every 4x4 block of every mode ----
      if (t < 64) {
        const int m = t >> 4, b = t & 15, by = b >> 2, bx = b & 3;
        int v[16];
        for (int k = 0; k < 16; ++k)
          v[k] = s.diff[m][(4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3)];
        s.blk[m][b] = satd4(v);
      } else if (t < 96) {
        const int k = t - 64, m = k >> 3, pl = (k >> 2) & 1, b = k & 3;
        const int by = b >> 1, bx = b & 1;
        int v[16];
        for (int j = 0; j < 16; ++j)
          v[j] = s.cdiff[m][pl][(4 * by + (j >> 2)) * 8 + 4 * bx + (j & 3)];
        s.cblk[m][pl][b] = satd4(v);
      }
      __syncthreads();

      // ---- mode decisions: the first cheapest available mode ----
      if (t == 0) {
        const bool av[4] = {at, al, true, at && al};
        int best = kBig, bm = 0;
        for (int m = 0; m < 4; ++m) {
          int sum = 0;
          for (int b = 0; b < 16; ++b) sum += s.blk[m][b];
          const int cost = av[m] ? sum >> 1 : kBig;
          if (cost < best) {
            best = cost;
            bm = m;
          }
        }
        s.mode = bm;
        s.cost = best;
      } else if (t == 32) {
        const bool av[4] = {true, al, at, at && al};
        int best = kBig, bm = 0;
        for (int m = 0; m < 4; ++m) {
          int su = 0, sv = 0;
          for (int b = 0; b < 4; ++b) {
            su += s.cblk[m][0][b];
            sv += s.cblk[m][1][b];
          }
          const int cost = av[m] ? (su >> 1) + (sv >> 1) : kBig;
          if (cost < best) {
            best = cost;
            bm = m;
          }
        }
        s.cmode = bm;
      }
      __syncthreads();

      // ---- forward transforms of the chosen residuals ----
      if (t < 16) {
        const int by = t >> 2, bx = t & 3;
        int v[16];
        for (int k = 0; k < 16; ++k)
          v[k] = s.diff[s.mode][(4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3)];
        dct4(v);
        for (int k = 0; k < 16; ++k) s.coef[16 * t + k] = v[k];
        s.dc[t] = v[0];
      } else if (t >= 32 && t < 40) {
        const int k = t - 32, pl = k >> 2, b = k & 3, by = b >> 1, bx = b & 1;
        int v[16];
        for (int j = 0; j < 16; ++j)
          v[j] = s.cdiff[s.cmode][pl]
                        [(4 * by + (j >> 2)) * 8 + 4 * bx + (j & 3)];
        dct4(v);
        for (int j = 0; j < 16; ++j) s.ccoef[pl][16 * b + j] = v[j];
        s.cdc[pl][b] = v[0];
      }
      __syncthreads();

      const int q6 = qp / 6, qm = qp % 6;
      const int qbits = 15 + q6, fi = (1 << qbits) / 3;
      const int cq6 = qpc / 6, cqm = qpc % 6;
      const int cqbits = 15 + cq6, cfi = (1 << cqbits) / 3;
      // ---- the DC paths (one thread each) ----
      if (t == 0) {
        // luma: forward Hadamard with (x + 1) >> 1, quant, inverse, scale
        int h[16];
        for (int k = 0; k < 16; ++k) h[k] = s.dc[k];
        had4x4(h);
        const int mf0 = s.tab[kQ4 + 16 * qm];
        int lv[16];
        for (int k = 0; k < 16; ++k) {
          lv[k] = quant((h[k] + 1) >> 1, mf0, 2 * fi, qbits + 1);
          s.dcq[k] = lv[k];
        }
        had4x4(lv);
        const int ls16 = s.tab[kD4 + 16 * qm] * 16;
        for (int k = 0; k < 16; ++k)
          s.dcdeq[k] = q6 >= 6 ? (lv[k] * ls16) << (q6 - 6)
                               : (lv[k] * ls16 + (1 << (5 - q6))) >> (6 - q6);
      } else if (t == 32 || t == 33) {
        // chroma plane t - 32: the 2x2 Hadamard, quant, inverse, scale
        const int pl = t - 32;
        const int x00 = s.cdc[pl][0], x01 = s.cdc[pl][1];
        const int x10 = s.cdc[pl][2], x11 = s.cdc[pl][3];
        const int a0 = x00 + x10, a1 = x01 + x11;
        const int b0 = x00 - x10, b1 = x01 - x11;
        const int hd[4] = {a0 + a1, a0 - a1, b0 + b1, b0 - b1};
        const int mf0 = s.tab[kQ4 + 16 * cqm];
        int lv[4];
        for (int k = 0; k < 4; ++k) {
          lv[k] = quant(hd[k], mf0, 2 * cfi, cqbits + 1);
          s.cdcq[pl][k] = lv[k];
        }
        const int c0 = lv[0] + lv[2], c1 = lv[1] + lv[3];
        const int e0 = lv[0] - lv[2], e1 = lv[1] - lv[3];
        const int ih[4] = {c0 + c1, c0 - c1, e0 + e1, e0 - e1};
        const int ls16 = s.tab[kD4 + 16 * cqm] * 16;
        for (int k = 0; k < 4; ++k)
          s.cdcdeq[pl][k] = ((ih[k] * ls16) << cq6) >> 5;
      }
      // ---- AC quant of every coefficient (position 0 left to the DC) ----
      {
        const int k = t & 15;
        const int lv = k == 0 ? 0
                              : quant(s.coef[t], s.tab[kQ4 + 16 * qm + k], fi,
                                      qbits);
        s.coef[t] = lv;
      }
      if (clane) {
        const int k = cp & 15;
        const int lv = k == 0 ? 0
                              : quant(s.ccoef[cpl][cp],
                                      s.tab[kQ4 + 16 * cqm + k], cfi, cqbits);
        s.ccoef[cpl][cp] = lv;
      }
      __syncthreads();

      // ---- counts, zigzag levels out, dequant and inverse per block ----
      if (t < 16) {
        int* lv = s.coef + 16 * t;
        int cnt = 0;
        for (int j = 0; j < 16; ++j) {
          const int v = lv[s.tab[kZig + j]];
          out.luma_ac[(size_t)mb * 256 + 16 * t + j] = v;
          cnt += v != 0;
        }
        s.nnz[t] = cnt;
        out.luma_nnz[(size_t)mb * 16 + t] = cnt;
        out.nnz_deblock[(size_t)mb * 16 + t] = cnt;
        out.luma_dc[(size_t)mb * 16 + t] = s.dcq[s.tab[kZig + t]];
        int d[16];
        for (int j = 0; j < 16; ++j)
          d[j] = (lv[j] * s.tab[kD4 + 16 * qm + j]) << q6;
        d[0] = s.dcdeq[t];
        idct4(d);
        for (int j = 0; j < 16; ++j) lv[j] = d[j];  // the residual, raster
      } else if (t >= 32 && t < 40) {
        const int k = t - 32, pl = k >> 2, b = k & 3;
        int* lv = s.ccoef[pl] + 16 * b;
        int cnt = 0;
        const size_t o = ((size_t)mb * 2 + pl) * 4 + b;
        for (int j = 0; j < 16; ++j) {
          const int v = lv[s.tab[kZig + j]];
          out.chroma_ac[o * 16 + j] = v;
          cnt += v != 0;
        }
        s.cnnz[pl][b] = cnt;
        out.chroma_nnz[o] = cnt;
        out.chroma_dc[o] = s.cdcq[pl][b];
        int d[16];
        for (int j = 0; j < 16; ++j)
          d[j] = (lv[j] * s.tab[kD4 + 16 * cqm + j]) << cq6;
        d[0] = s.cdcdeq[pl][b];
        idct4(d);
        for (int j = 0; j < 16; ++j) lv[j] = d[j];
      }
      __syncthreads();

      // ---- recon into the live planes, and the MB's scalar fields ----
      {
        const int b = (py >> 2) * 4 + (px >> 2), k = (py & 3) * 4 + (px & 3);
        const int pred = s.src[t] - s.diff[s.mode][t];
        ry[(y0 + py) * W + x0 + px] = clamp255(pred + s.coef[16 * b + k]);
      }
      if (clane) {
        const int b = (cy >> 2) * 2 + (cx >> 2), k = (cy & 3) * 4 + (cx & 3);
        const int pred = s.csrc[cpl][cp] - s.cdiff[s.cmode][cpl][cp];
        int* rp = cpl ? rv : ru;
        rp[(cy0 + cy) * CW + cx0 + cx] =
            clamp255(pred + s.ccoef[cpl][16 * b + k]);
      }
      if (t == 0) {
        int any = 0;
        for (int b = 0; b < 16; ++b) any |= s.nnz[b];
        out.cbp_luma[mb] = any ? 15 : 0;
        out.i16_mode[mb] = s.mode;
        out.mb_cost[mb] = s.cost;
        out.intra_mask[mb] = true;
        out.t8[mb] = false;
      } else if (t == 32) {
        int any_ac = 0, any_dc = 0;
        for (int pl = 0; pl < 2; ++pl)
          for (int b = 0; b < 4; ++b) {
            any_ac |= s.cnnz[pl][b];
            any_dc |= s.cdcq[pl][b];
          }
        out.cbp_chroma[mb] = any_ac ? 2 : (any_dc ? 1 : 0);
        out.chroma_mode[mb] = s.cmode;
      }
    }
  }
}

}  // namespace

extern "C" int pir_column_launch(
    const void* y, const void* u, const void* v, void* ry, void* ru,
    void* rv, const void* qp, const void* qpc, void* luma_dc, void* luma_ac,
    void* luma_nnz, void* nnz_deblock, void* cbp_luma, void* chroma_dc,
    void* chroma_ac, void* chroma_nnz, void* cbp_chroma, void* i16_mode,
    void* chroma_mode, void* mb_cost, void* intra_mask, void* t8,
    const void* tab, int pir_col, int ncols, int mbw, int mbh,
    void* stream) {
  if (pir_col < 0 || pir_col >= mbw || ncols < 1 || mbh < 1)
    return (int)cudaErrorInvalidValue;
  Fields f{(int*)luma_dc,    (int*)luma_ac,    (int*)luma_nnz,
           (int*)nnz_deblock, (int*)cbp_luma,  (int*)chroma_dc,
           (int*)chroma_ac,  (int*)chroma_nnz, (int*)cbp_chroma,
           (int*)i16_mode,   (int*)chroma_mode, (int*)mb_cost,
           (bool*)intra_mask, (bool*)t8};
  pir_column_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, (int*)ry,
      (int*)ru, (int*)rv, (const int*)qp, (const int*)qpc, f,
      (const int*)tab, pir_col, ncols, mbw, mbh);
  return (int)cudaGetLastError();
}
