// The periodic-intra-refresh bar of a P frame, for Hopper (sm_90a).
//
// Replaces: x264_tpu/models/inter_device.py::_pir_column_pass, which the
// reference runs as XLA (a lax.scan over the MB rows, the bar's columns
// unrolled inside each step; no Pallas kernel).  Eager PyTorch would pay
// some 60-100 small launches per MB for it.  The plain twin, bit for bit,
// is x264_tpu_torch/kernels/pir_column.py::pir_column_pass_plain.
//
// Contract: the bar is ncols MB columns from pir_col on; columns at or past
// mbw are skipped.  Each bar MB is coded as I16x16 from the live recon
// (so it sees the bar MBs above and left of it, as the reference's rows
// top to bottom and columns left to right do): the first cheapest of the
// four I16x16 modes [V, H, DC, Plane] by SATD among the available ones,
// the 4x4 transform, the DC Hadamard, the intra deadzone quantiser (no
// trellis), dequantisation and the inverse; then chroma the same way with
// the modes [DC, H, V, Plane] by the sum of the U and V SATDs.  The int32
// recon planes and the MB's fields are written in place.
//
// Bound on the H100: bytes and operations are tiny (a few KB and ~34k
// int32 operations per MB, kernels/pir_column.py counts them: well under
// a microsecond for a 1080p bar).  The kernel is bound by its chain
// instead.  No I16x16 or chroma mode reads the top-right, so MB (r, c)
// depends only on its top, left and top-left neighbours, all on smaller
// anti-diagonals r + c: the bar is a wavefront of mbh + ncols - 1 steps
// (70 at 1080p with keyint 60), not a chain of its mbh * ncols MBs.
//
// Design: one launch per P frame, one block of G MB warps (one for each
// MB of the widest diagonal, at most 16).
// Step d codes the bar MBs with r + ci = d, dealt to the warps in turn (a
// warp codes several when the diagonal holds more than G), and the block
// meets at one __syncthreads() a step, never inside an MB.  A warp codes a
// whole MB: lanes 0-15 the luma 4x4 blocks, lanes 16-23 the chroma blocks
// (U then V), lanes 24-31 a copy of 16-23; every lane runs the same code.
// Each lane takes its plane's predictor sums and gradients from the edge
// bytes with dp4a; the four modes' SATDs come from one Hadamard of the
// source block (V, H and DC change only its first row, first column or
// DC term); an MB's cross-block sums (the mode costs, the DC Hadamards,
// the cbps) are warp shuffles and ballots.  The chain never leaves the
// SM: an MB leaves its bottom row, right column and left-edge corner in
// shared memory, per bar column and double-buffered by the step's
// parity, where the MB below and the MB to the right read them; the
// column left of the bar, P recon this pass never changes, is loaded
// once.  The recon and the fields go to global memory, 16 bytes a store,
// and are never read back; the levels and fields leave as soon as they
// are known, so that their stores drain while the inverse runs.  While a
// warp codes one MB, cp.async brings its next MB's source and QPs into a
// second buffer.  The launcher refuses tensors off the 16-byte boundaries
// (8 for the chroma sources) that these copies and stores need; the
// encoder's planes and fields are whole allocations or MB-padded frames
// of a batch.  All integer: bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 30;
// the constant block (kernels/pir_column.py packs it): zigzag, then the 4x4
// quant and dequant tables by qp % 6, raster positions
constexpr int kQ4 = 16, kD4 = 112, kTab = 208;
constexpr int kMaxGroups = 16;  // MB warps a block
constexpr unsigned kAll = 0xffffffffu;
// the 4x4 zigzag scan, a nibble per scan index (equal to the block's
// first 16 words: the tests hold the kernel to the twin)
constexpr unsigned long long kZigzag = 0xfeb7adc963258410ull;

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int zigzag(int j) {
  return (int)((kZigzag >> (4 * j)) & 15);
}

#ifndef CUDA_SHIM
// The device primitives a CPU build of this file replaces (see
// tests/test_torch_kernel_layouts.py): the dynamic shared memory, and the
// asynchronous copy of bytes (16, 8 or 4, aligned so) from global to
// shared memory, its commit and its wait.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char pir_smem[];
  return pir_smem;
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
#endif

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

// one MB's source and QPs, as a warp's copy brings them
struct alignas(16) Src {
  uint8_t y[256];    // luma, raster
  uint8_t c[2][64];  // U and V, raster
  int qp, qpc, pad[2];
};

// what a bar MB leaves its neighbours: its bottom row and right column,
// and its left edge's last pixel (the top-left of the MB below it)
struct alignas(16) Edge {
  uint8_t bot[16], right[16];
  uint8_t cbot[2][8], cright[2][8];
  int corner, ccorner[2], pad;
};

// the dynamic shared memory: the constant block, two source buffers per
// warp, the edges of each bar column for both step parities, and the
// column left of the bar (luma, then U and V; 16 words a load, so the V
// plane's last row reads 8 words of padding)
__host__ __device__ inline size_t smem_bytes(int groups, int ncl, int mbh) {
  return kTab * 4 + sizeof(Src) * 2 * groups + sizeof(Edge) * 2 * ncl +
         (size_t)4 * (32 * mbh + 16);
}

// the block's MB warps: one for each MB of the widest diagonal
inline int mb_warps(int ncl, int mbh) {
  return imin(kMaxGroups, imin(ncl, mbh));
}

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

// output i of had4(a, b, c, d)
__device__ __forceinline__ int had4_at(int a, int b, int c, int d, int i) {
  const int s01 = a + b, d01 = a - b, s23 = c + d, d23 = c - d;
  return i == 0 ? s01 + s23 : i == 1 ? s01 - s23 : i == 2 ? d01 - d23
                                                          : d01 + d23;
}

// H4 x H4^T of a 4x4 block held raster in v[16], in place
__device__ __forceinline__ void had4x4(int* v) {
  for (int r = 0; r < 4; ++r)
    had4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
  for (int c = 0; c < 4; ++c) had4(v[c], v[4 + c], v[8 + c], v[12 + c]);
}

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// the forward core transform rows of ops/transform._cf_rows
__device__ __forceinline__ void cf4(int& x0, int& x1, int& x2, int& x3) {
  const int s03 = x0 + x3, d03 = x0 - x3, s12 = x1 + x2, d12 = x1 - x2;
  x0 = s03 + s12;
  x1 = 2 * d03 + d12;
  x2 = s03 - s12;
  x3 = d03 - 2 * d12;
}

__device__ __forceinline__ void dct4(int* v) {  // raster 4x4, in place
  for (int c = 0; c < 4; ++c) cf4(v[c], v[4 + c], v[8 + c], v[12 + c]);
  for (int r = 0; r < 4; ++r)
    cf4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
}

// normative 4x4 inverse (8.5.12.2) with the final (x + 32) >> 6, as
// ops/transform.idct4x4: along each row first, then along each column
__device__ __forceinline__ void idct4(int* d) {
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

__device__ __forceinline__ int pick4(int a, int b, int c, int d, int i) {
  return i == 0 ? a : i == 1 ? b : i == 2 ? c : d;
}

__device__ __forceinline__ uint32_t pick4(const uint32_t* w, int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

__device__ __forceinline__ void unpack4(uint32_t w, int* v) {
  for (int x = 0; x < 4; ++x) v[x] = (w >> (8 * x)) & 255;
}

// 16 bytes of an edge (luma; chroma uses the first 8) as 4 words
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t* w) {
  const uint2 a = *(const uint2*)p, b = *(const uint2*)(p + 8);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// per word of 4 edge pixels (indices 4i..4i+3): their sum and their sum
// weighted by the index
__device__ __forceinline__ void edge_sums(const uint32_t* w, int* d, int* e) {
  for (int i = 0; i < 4; ++i) {
    d[i] = (int)__dp4a(w[i], 0x01010101u, 0u);
    e[i] = (int)__dp4a(w[i], 0x03020100u + 0x04040404u * i, 0u);
  }
}

// 16 words from 16-byte aligned shared memory
__device__ __forceinline__ void load16(const int* p, int* v) {
  for (int i = 0; i < 4; ++i) {
    const int4 q = ((const int4*)p)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ void store4(int* p, int a, int b, int c, int d) {
  *(int4*)p = make_int4(a, b, c, d);
}

// whether a launch's planes take the kernel's 16- and 8-byte copies and
// its 16-byte stores: the source planes' and the recon planes' rows are
// whole such units when the planes start on their boundaries, and so are
// the AC levels' blocks
inline bool vector_io(const void* y, const void* u, const void* v,
                      const void* ry, const void* ru, const void* rv,
                      const void* luma_ac, const void* chroma_ac) {
  return !(((uintptr_t)y | (uintptr_t)ry | (uintptr_t)ru | (uintptr_t)rv |
            (uintptr_t)luma_ac | (uintptr_t)chroma_ac) & 15) &&
         !(((uintptr_t)u | (uintptr_t)v) & 7);
}

__global__ void __launch_bounds__(32 * kMaxGroups)
pir_column_kernel(const uint8_t* __restrict__ ysrc,
                  const uint8_t* __restrict__ usrc,
                  const uint8_t* __restrict__ vsrc, int* ry, int* ru, int* rv,
                  const int* __restrict__ qpa, const int* __restrict__ qpca,
                  Fields out, const int* __restrict__ tab_g, int pir_col,
                  int ncols, int mbw, int mbh) {
  const int t = threadIdx.x, nt = blockDim.x, G = nt >> 5;
  const int w = t >> 5, lane = t & 31;
  const int ncl = imin(ncols, mbw - pir_col), steps = mbh + ncl - 1;
  const int W = 16 * mbw, CW = 8 * mbw;

  unsigned char* base = smem_base();
  int* tab = (int*)base;
  Src* srcb = (Src*)(base + kTab * 4) + 2 * w;  // this warp's two buffers
  Edge* edge = (Edge*)(base + kTab * 4 + sizeof(Src) * 2 * G);
  int* lcol = (int*)(edge + 2 * ncl);  // (16 mbh) luma, then (2, 8 mbh)

  // ---- once: the constant block, the edges cleared, the left column ----
  for (int k = t; k < kTab; k += nt) tab[k] = tab_g[k];
  for (int k = t; k < 2 * ncl * (int)sizeof(Edge) / 4; k += nt)
    ((int*)edge)[k] = 0;
  for (int k = t; k < 32 * mbh + 16; k += nt) {
    int v = 0;
    if (pir_col > 0 && k < 32 * mbh) {
      if (k < 16 * mbh) {
        v = ry[(size_t)k * W + 16 * pir_col - 1];
      } else {
        const int pl = (k - 16 * mbh) / (8 * mbh);
        const int y = k - 16 * mbh - pl * 8 * mbh;
        v = (pl ? rv : ru)[(size_t)y * CW + 8 * pir_col - 1];
      }
    }
    lcol[k] = v;
  }

  // ---- the lane's part of an MB ----
  const bool isl = lane < 16;                 // a luma block
  const int cl = (lane - 16) & 7;             // chroma lanes: U 0-3, V 4-7
  const int pl = isl ? 0 : cl >> 2, cb = cl & 3;
  const int bx = isl ? lane & 3 : cb & 1, by = isl ? lane >> 2 : cb >> 1;
  const int half = isl ? 8 : 4, last = isl ? 3 : 1;
  const bool writer = lane < 24;
  // the luma DC Hadamard's place of every lane (a luma lane's own block)
  const int lbx = lane & 3, lby = (lane >> 2) & 3;

  auto diag_len = [&](int d) {
    return imin(d, ncl - 1) - imax(0, d - mbh + 1) + 1;
  };
  // copy MB j of diagonal d's source and QPs into buffer b, asynchronously:
  // lanes 0-15 a luma row of 16 bytes, 16-31 a chroma row of 8 (U, then
  // V), lanes 0 and 1 the QPs
  const bool ly = lane < 16;
  const int fp = (lane >> 3) & 1, frow = lane & 7;
  const uint8_t* fsrc =
      ly ? ysrc + (size_t)lane * W : (fp ? vsrc : usrc) + (size_t)frow * CW;
  const size_t fmb_row = ly ? (size_t)16 * W : (size_t)8 * CW;
  const int fmb_col = ly ? 16 : 8;
  const int fdst = ly ? 16 * lane : 256 + 64 * fp + 8 * frow;  // in a Src
  auto fetch = [&](int d, int j, Src* b) {
    const int ci = imax(0, d - mbh + 1) + j, r = d - ci, c = pir_col + ci;
    unsigned char* dst = (unsigned char*)b + fdst;
    const uint8_t* src = fsrc + r * fmb_row + fmb_col * c;
    copy_async(dst, src, ly ? 16 : 8);
    if (lane < 2)
      copy_async(lane ? &b->qpc : &b->qp, (lane ? qpca : qpa) + r * mbw + c,
                 4);
    copy_async_commit();
  };

  // the warp's MBs: j = w, w + G, ... of each diagonal in turn; (cd, cj) is
  // the next one to fetch
  int cd = 0, cj = w;
  while (cd < steps && cj >= diag_len(cd)) {
    ++cd;
    cj = w;
  }
  if (cd < steps) fetch(cd, cj, srcb);
  __syncthreads();

  int k = 0;
  for (int d = 0; d < steps; ++d) {
    const int n = diag_len(d), lo = imax(0, d - mbh + 1);
    const Edge* prev = edge + ((d + 1) & 1) * ncl;  // written at step d - 1
    Edge* cur = edge + (d & 1) * ncl;
    for (int j = w; j < n; j += G, ++k) {
      // ---- this MB's source in, the next one's copy started ----
      copy_async_wait();
      __syncwarp();
      cj += G;
      while (cd < steps && cj >= diag_len(cd)) {
        ++cd;
        cj = w;
      }
      if (cd < steps) fetch(cd, cj, srcb + ((k + 1) & 1));
      const Src& sb = srcb[k & 1];

      const int ci = lo + j, r = d - ci, c = pir_col + ci;
      const int mb = r * mbw + c;
      const bool at = r > 0, al = c > 0;

      // ---- edges: top and corner from the MB above, left from the MB
      // to the left or the column left of the bar ----
      const Edge& et = prev[ci];
      const Edge& el = prev[ci ? ci - 1 : 0];  // read only when ci > 0
      // the lane's plane's top and left edges: per 4 pixels their sum and
      // index-weighted sum, the lane's own 4 pixels, and the last pixel
      int td[4], te[4], ld[4], le[4], t4[4], l4[4], top_e, left_e;
      {
        uint32_t wd[4];
        load_words(isl ? et.bot : et.cbot[pl], wd);
        edge_sums(wd, td, te);
        unpack4(pick4(wd, bx), t4);
        top_e = (int)((isl ? wd[3] : wd[1]) >> 24);
      }
      if (ci) {
        uint32_t wd[4];
        load_words(isl ? el.right : el.cright[pl], wd);
        edge_sums(wd, ld, le);
        unpack4(pick4(wd, by), l4);
        left_e = (int)((isl ? wd[3] : wd[1]) >> 24);
      } else {  // the column left of the bar, int32
        int v[16];
        load16(isl ? lcol + 16 * r : lcol + (16 + 8 * pl) * mbh + 8 * r, v);
        for (int i = 0; i < 4; ++i) {
          ld[i] = v[4 * i] + v[4 * i + 1] + v[4 * i + 2] + v[4 * i + 3];
          le[i] = 4 * i * ld[i] + v[4 * i + 1] + 2 * v[4 * i + 2] +
                  3 * v[4 * i + 3];
          l4[i] = pick4(v[i], v[4 + i], v[8 + i], v[12 + i], by);
        }
        left_e = isl ? v[15] : v[7];
      }
      const int tl = isl ? et.corner : et.ccorner[pl];

      // ---- predictor scalars: DC, and the plane's gradients, where
      // sum_x x (e[half-1+x] - e[half-1-x]) = sum_i i e[i] - (half - 1)
      // sum_i e[i] - half * corner ----
      // (one formula for both kinds of lane, so no lane waits on the
      // other kind's branch; chroma quadrant 1 prefers the top, 2 the left)
      const int sum_t = td[0] + td[1] + (isl ? td[2] + td[3] : 0);
      const int sum_l = ld[0] + ld[1] + (isl ? ld[2] + ld[3] : 0);
      const int gt = te[0] + te[1] + (isl ? te[2] + te[3] : 0) -
                     (half - 1) * sum_t - half * tl;
      const int gl = le[0] + le[1] + (isl ? le[2] + le[3] : 0) -
                     (half - 1) * sum_l - half * tl;
      const int gm = isl ? 5 : 17, gsh = isl ? 6 : 5;
      const int pb = (gm * gt + (1 << (gsh - 1))) >> gsh;
      const int pc = (gm * gl + (1 << (gsh - 1))) >> gsh;
      const int dt = isl ? sum_t : (cb & 1 ? td[1] : td[0]);
      const int dl = isl ? sum_l : (cb >> 1 ? ld[1] : ld[0]);
      const int dsh = isl ? 4 : 2, drnd = 1 << (dsh - 1);
      const bool use_t = at && (isl || cb != 2 || !al);
      const bool use_l = al && (isl || cb != 1 || !at);
      const int dcv = use_t && use_l ? (dt + dl + 2 * drnd) >> (dsh + 1)
                      : use_t        ? (dt + drnd) >> dsh
                      : use_l        ? (dl + drnd) >> dsh
                                     : 128;
      const int pa = 16 * (left_e + top_e);

      // ---- the source block, the plane prediction ----
      int src[16], pp[16];
      {
        const uint8_t* sp = isl ? sb.y + 64 * by + 4 * bx
                                : sb.c[pl] + 32 * by + 4 * bx;
        const int stride = isl ? 16 : 8;
        for (int y = 0; y < 4; ++y) {
          const uint32_t wd = *(const uint32_t*)(sp + y * stride);
          for (int x = 0; x < 4; ++x) src[4 * y + x] = (wd >> (8 * x)) & 255;
        }
        const int b0 = pa + pb * (4 * bx - half + 1) +
                       pc * (4 * by - half + 1) + 16;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x)
            pp[4 * y + x] = clamp255((b0 + pb * x + pc * y) >> 5);
      }

      // ---- SATD of the four modes, in the order [V, H, DC, Plane] ----
      int sat[4];
      {
        int hs[16];
        for (int i = 0; i < 16; ++i) hs[i] = src[i];
        had4x4(hs);
        int all = 0;
        for (int i = 0; i < 16; ++i) all += iabs(hs[i]);
        int tv[4] = {t4[0], t4[1], t4[2], t4[3]};
        int lv[4] = {l4[0], l4[1], l4[2], l4[3]};
        had4(tv[0], tv[1], tv[2], tv[3]);
        had4(lv[0], lv[1], lv[2], lv[3]);
        int sv = all, sh = all;
        for (int i = 0; i < 4; ++i) {
          sv += iabs(hs[i] - 4 * tv[i]) - iabs(hs[i]);
          sh += iabs(hs[4 * i] - 4 * lv[i]) - iabs(hs[4 * i]);
        }
        sat[0] = sv;
        sat[1] = sh;
        sat[2] = all - iabs(hs[0]) + iabs(hs[0] - 16 * dcv);
        int dp[16];
        for (int i = 0; i < 16; ++i) dp[i] = src[i] - pp[i];
        had4x4(dp);
        int s = 0;
        for (int i = 0; i < 16; ++i) s += iabs(dp[i]);
        sat[3] = s;
      }
      // ---- the mode costs: luma sums 16 blocks then halves, chroma
      // halves each plane's sum of 4 then adds the planes ----
      for (int m = 0; m < 4; ++m) {
        int v = sat[m];
        v += __shfl_xor_sync(kAll, v, 1);
        v += __shfl_xor_sync(kAll, v, 2);
        v >>= isl ? 0 : 1;
        v += __shfl_xor_sync(kAll, v, 4);
        const int o = __shfl_xor_sync(kAll, v, 8);
        sat[m] = isl ? (v + o) >> 1 : v;
      }
      // the first cheapest available mode in the plane's own order (luma
      // [V, H, DC, Plane], chroma [DC, H, V, Plane]); g: its kind above
      int best = kBig, bm = 0, bg = 0;
      for (int m = 0; m < 4; ++m) {
        const int g = (isl || (m & 1)) ? m : 2 - m;
        const int v = (isl || (m & 1)) ? sat[m] : sat[2 - m];
        const bool av = g == 0 ? at : g == 1 ? al : g == 2 ? true : at && al;
        const int cost = av ? v : kBig;
        if (cost < best) {
          best = cost;
          bm = m;
          bg = g;
        }
      }

      // ---- the chosen prediction, the residual's transform ----
      int pr[16], co[16];
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          const int i = 4 * y + x;
          pr[i] = bg == 3 ? pp[i] : bg == 2 ? dcv : bg == 1 ? l4[y] : t4[x];
          co[i] = src[i] - pr[i];
        }
      dct4(co);

      const int qq = isl ? sb.qp : sb.qpc;
      const int q6 = qq / 6, qm = qq % 6;
      const int qbits = 15 + q6, fi = (1 << qbits) / 3;
      int mf[16], dq[16];
      load16(tab + kQ4 + 16 * qm, mf);
      load16(tab + kD4 + 16 * qm, dq);
      // ---- AC quant (position 0 is the DC's) ----
      int lv[16];
      int nnz = 0;
      lv[0] = 0;
      for (int i = 1; i < 16; ++i) {
        lv[i] = quant(co[i], mf[i], fi, qbits);
        nnz += lv[i] != 0;
      }

      // ---- luma DC: the 16-point Hadamard across lanes 0-15, (x + 1) >>
      // 1, quant, the inverse and the scale; every lane runs it ----
      const int dc0 = co[0];
      int a0 = __shfl_sync(kAll, dc0, 4 * lby), a1 = __shfl_sync(kAll, dc0, 4 * lby + 1);
      int a2 = __shfl_sync(kAll, dc0, 4 * lby + 2), a3 = __shfl_sync(kAll, dc0, 4 * lby + 3);
      int h = had4_at(a0, a1, a2, a3, lbx);
      a0 = __shfl_sync(kAll, h, lbx);
      a1 = __shfl_sync(kAll, h, 4 + lbx);
      a2 = __shfl_sync(kAll, h, 8 + lbx);
      a3 = __shfl_sync(kAll, h, 12 + lbx);
      h = had4_at(a0, a1, a2, a3, lby);
      const int lq = quant((h + 1) >> 1, mf[0], 2 * fi, qbits + 1);
      const int zq = __shfl_sync(kAll, lq, zigzag(lane & 15));
      a0 = __shfl_sync(kAll, lq, 4 * lby);
      a1 = __shfl_sync(kAll, lq, 4 * lby + 1);
      a2 = __shfl_sync(kAll, lq, 4 * lby + 2);
      a3 = __shfl_sync(kAll, lq, 4 * lby + 3);
      h = had4_at(a0, a1, a2, a3, lbx);
      a0 = __shfl_sync(kAll, h, lbx);
      a1 = __shfl_sync(kAll, h, 4 + lbx);
      a2 = __shfl_sync(kAll, h, 8 + lbx);
      a3 = __shfl_sync(kAll, h, 12 + lbx);
      h = had4_at(a0, a1, a2, a3, lby);
      const int ls16 = dq[0] * 16;
      // ---- chroma DC: each plane's 2x2 transform across its 4 lanes ----
      const int gb = lane & ~3;
      const int x0 = __shfl_sync(kAll, dc0, gb), x1 = __shfl_sync(kAll, dc0, gb + 1);
      const int x2 = __shfl_sync(kAll, dc0, gb + 2), x3 = __shfl_sync(kAll, dc0, gb + 3);
      int cdc, dcd;
      {
        const int s0 = x0 + x2, s1 = x1 + x3, e0 = x0 - x2, e1 = x1 - x3;
        const int c0 = quant(s0 + s1, mf[0], 2 * fi, qbits + 1);
        const int c1 = quant(s0 - s1, mf[0], 2 * fi, qbits + 1);
        const int c2 = quant(e0 + e1, mf[0], 2 * fi, qbits + 1);
        const int c3 = quant(e0 - e1, mf[0], 2 * fi, qbits + 1);
        const int u0 = c0 + c2, u1 = c1 + c3, v0 = c0 - c2, v1 = c1 - c3;
        const int ih = pick4(u0 + u1, u0 - u1, v0 + v1, v0 - v1, cb);
        cdc = pick4(c0, c1, c2, c3, cb);
        dcd = isl ? (q6 >= 6 ? (h * ls16) << (q6 - 6)
                             : (h * ls16 + (1 << (5 - q6))) >> (6 - q6))
                  : ((ih * ls16) << q6) >> 5;
      }

      // ---- the levels, counts and fields out, early: their stores drain
      // while the inverse runs ----
      const unsigned any_l = __ballot_sync(kAll, isl && nnz);
      const unsigned any_cac = __ballot_sync(kAll, !isl && writer && nnz);
      const unsigned any_cdc = __ballot_sync(kAll, !isl && writer && cdc);
      if (writer) {
        const int o = isl ? mb * 16 + lane : (mb * 2 + pl) * 4 + cb;
        int* acp = (isl ? out.luma_ac : out.chroma_ac) + 16 * o;
        for (int i = 0; i < 16; i += 4)
          store4(acp + i, lv[zigzag(i)], lv[zigzag(i + 1)],
                       lv[zigzag(i + 2)], lv[zigzag(i + 3)]);
        (isl ? out.luma_nnz : out.chroma_nnz)[o] = nnz;
        (isl ? out.luma_dc : out.chroma_dc)[o] = isl ? zq : cdc;
        if (isl) out.nnz_deblock[o] = nnz;
      }
      if (lane == 0) {
        out.cbp_luma[mb] = any_l ? 15 : 0;
        out.i16_mode[mb] = bm;
        out.mb_cost[mb] = best;
        out.intra_mask[mb] = true;
        out.t8[mb] = false;
      }
      if (lane == 16) {
        out.cbp_chroma[mb] = any_cac ? 2 : (any_cdc ? 1 : 0);
        out.chroma_mode[mb] = bm;
      }

      // ---- the block's dequant, inverse and recon ----
      int res[16];
      res[0] = dcd;
      for (int i = 1; i < 16; ++i) res[i] = (lv[i] * dq[i]) << q6;
      idct4(res);
      int rec[16];
      for (int i = 0; i < 16; ++i) rec[i] = clamp255(pr[i] + res[i]);

      if (writer) {
        // ---- the edges this MB leaves its neighbours ----
        Edge& eo = cur[ci];
        if (by == last) {
          uint8_t* bp = (isl ? eo.bot : eo.cbot[pl]) + 4 * bx;
          *(uint32_t*)bp = (uint32_t)rec[12] | ((uint32_t)rec[13] << 8) |
                           ((uint32_t)rec[14] << 16) |
                           ((uint32_t)rec[15] << 24);
          if (bx == 0) (isl ? eo.corner : eo.ccorner[pl]) = l4[3];
        }
        if (bx == last) {
          uint8_t* rpp = (isl ? eo.right : eo.cright[pl]) + 4 * by;
          *(uint32_t*)rpp = (uint32_t)rec[3] | ((uint32_t)rec[7] << 8) |
                            ((uint32_t)rec[11] << 16) |
                            ((uint32_t)rec[15] << 24);
        }
        // ---- the recon rows ----
        int* rp = isl ? ry + (16 * r + 4 * by) * W + 16 * c + 4 * bx
                      : (pl ? rv : ru) + (8 * r + 4 * by) * CW + 8 * c + 4 * bx;
        const int stride = isl ? W : CW;
        for (int y = 0; y < 4; ++y)
          store4(rp + y * stride, rec[4 * y], rec[4 * y + 1],
                       rec[4 * y + 2], rec[4 * y + 3]);
      }
    }
    __syncthreads();  // this step's edges are written
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
  if (pir_col < 0 || pir_col >= mbw || ncols < 1 || mbh < 1 ||
      !vector_io(y, u, v, ry, ru, rv, luma_ac, chroma_ac))
    return (int)cudaErrorInvalidValue;
  const int ncl = imin(ncols, mbw - pir_col), groups = mb_warps(ncl, mbh);
  const size_t smem = smem_bytes(groups, ncl, mbh);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pir_column_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  Fields f{(int*)luma_dc,    (int*)luma_ac,    (int*)luma_nnz,
           (int*)nnz_deblock, (int*)cbp_luma,  (int*)chroma_dc,
           (int*)chroma_ac,  (int*)chroma_nnz, (int*)cbp_chroma,
           (int*)i16_mode,   (int*)chroma_mode, (int*)mb_cost,
           (bool*)intra_mask, (bool*)t8};
  pir_column_kernel<<<1, 32 * groups, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)y, (const uint8_t*)u, (const uint8_t*)v, (int*)ry,
      (int*)ru, (int*)rv, (const int*)qp, (const int*)qpc, f,
      (const int*)tab, pir_col, ncols, mbw, mbh);
  return (int)cudaGetLastError();
}

// The launch's geometry for a bar, as pir_column_launch makes it:
// out = (MB warps, dynamic shared memory bytes, wavefront steps).
extern "C" int pir_column_geom(int pir_col, int ncols, int mbw, int mbh,
                               int* out) {
  if (pir_col < 0 || pir_col >= mbw || ncols < 1 || mbh < 1)
    return (int)cudaErrorInvalidValue;
  const int ncl = imin(ncols, mbw - pir_col);
  out[0] = mb_warps(ncl, mbh);
  out[1] = (int)smem_bytes(out[0], ncl, mbh);
  out[2] = mbh + ncl - 1;
  return 0;
}
