// The exhaustive fullpel search (ESA) shared by esa16.cu and esa_parts.cu,
// for Hopper (sm_90a).
//
// Contract (x264_tpu/ops/device/me.py::_full_search_xla and
// me_parts.py::full_search_parts_xla): for every MB and every (dx, dy) in
// [-r, r]^2, the SAD of the source MB against ref_pad at
// (PAD+16mby+dy, PAD+16mbx+dx) plus lam * (bits[4dx+4r] + bits[4dy+4r]);
// each unit keeps its least cost, ties going to the first candidate in
// (dy, dx) raster order.  Units: the 16x16 block alone (esa16), or the four
// 8x8 quadrants q = 2*qy + qx, the 16x8 halves (q0+q1, q2+q3), the 8x16
// halves (q0+q2, q1+q3) and the 16x16 block (esa_parts), in that order.
//
// What bounds it on the H100: the integer pipe.  Per MB and candidate it
// takes 64 vabsdiff4 (four |a-b| summed into an accumulator each; 64 per SM
// per clock, measured by esa16.cu's probe) plus a cost and a running
// minimum per unit: 2.3 G absolute differences per 1080p frame at r = 16,
// against ~19 MB of windows.  A SAD has no multiply-accumulate form, so the
// tensor cores (IMMA, wgmma) cannot compute it; what the card offers for it
// is the integer pipe, shared memory and asynchronous copies.
//
// Design:
// - A CTA holds up to `mbs` MBs at a time (a group) and walks groups
//   blockIdx.x, blockIdx.x + gridDim.x, ... (a persistent grid of as many
//   CTAs as the SMs keep resident); the MBs left after the last full round
//   are spread over all CTAs, so that round is short.  While it searches
//   one group, 16-byte cp.async copies stage the next group's windows and
//   source MBs into the other half of a double buffer.  A window is staged
//   from the 16-byte-aligned column at or before its first column (the row
//   stride of ref_pad, W + 2*PAD, is a multiple of 16); its row stride is
//   4 words times an odd number, so rows four apart sit 16 banks apart.
// - Each thread owns a tile of 4 dx x TY dy candidates of one MB (at r = 16
//   and TY = 4, 81 tiles per MB: three MBs fill 243 of 256 lanes).  The
//   source MB lives in registers: all 64 words for a tall tile (TY >= 8),
//   else only the TY rows a window row meets, loaded as the walk goes down
//   (4 * TY words), which leaves esa_parts' four accumulators per
//   candidate room for two CTAs per SM.
// - The tile's 4 dx share one aligned group of 5 window words: the thread
//   walks its 15 + TY window rows once, forms the 4 shifted forms of each
//   row with 12 __byte_perm (the offset of the window's first column folds
//   into which group and which shift a candidate takes), and feeds every
//   (dx, dy) of the tile whose source row j = k - dy is in 0-15.  All of
//   it is unrolled; r stays a runtime argument.
// - Each kernel has two tile heights (Tiles): the tall one from r = 12 on,
//   the short one below.  These are the heights an issue-slot model picks
//   at the ranges the encoder searches, r = 16 and lookahead's r = 8.
// - The argmin key is 32 bits: (cost << 13) | raster candidate, unsigned.
//   At r <= 32 there are at most 65^2 = 4225 < 2^13 candidates.  Per
//   candidate, base = (bias << 13) | c, and each unit costs one IMAD
//   (sad * 8192 + base) and one min.  A candidate of a tile that lies past
//   the range takes kMaskedBase, whose keys exceed every real key as long
//   as the largest cost plus the largest SAD is under 2^19, which the
//   wrapper checks (kernels/esa16.check_key_range).
// - The keys of one MB meet in a warp reduction (redux.sync over the lanes
//   of that MB, found with match.any) and a shared-memory atomicMin; the
//   CTA that searched an MB writes its result, so a call is one launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace esa {

constexpr int kThreads = 256;
constexpr int kMaxMbs = 16;        // MBs per group at most (small ranges)
constexpr int kMaxRange = 32;
constexpr int kCandBits = 13;
constexpr uint32_t kSadMax = 256 * 255;
constexpr uint32_t kMaskedBase =
    (((1u << (32 - kCandBits)) - 1 - kSadMax) << kCandBits)
    | ((1u << kCandBits) - 1);
// dynamic shared memory per CTA (above 48 KB the launch opts in)
constexpr int kMaxSmem = 96 * 1024;

// Launch geometry, the same for every MB of a call.
struct Geom {
  int r, span, win;
  int off;      // byte offset of window column 0 in its staged row
  int g0;       // staged word of the first candidate group
  int ngx;      // groups of 4 dx
  int ngy;      // tile rows of TY dy
  int tiles;    // per MB
  int chunks;   // 16-byte copies per window row
  int stride;   // shared-memory words per window row
  int rows;     // shared-memory rows per window: the last tile row reads
                // past win, and a group's fifth word may be the next row's
                // first
  int per_mb;   // shared-memory words per MB: window, then the source MB
  int copies;   // 16-byte copies per MB
  int mbs;      // MBs per group
};

inline Geom make_geom(int r, int pad, int ty) {
  Geom g;
  g.r = r;
  g.span = 2 * r + 1;
  g.win = 16 + 2 * r;
  g.off = (pad - r) & 15;
  g.g0 = g.off >> 2;
  g.ngx = ((g.off + g.span - 1) >> 2) - g.g0 + 1;
  g.ngy = (g.span + ty - 1) / ty;
  g.tiles = g.ngx * g.ngy;
  g.chunks = (g.off + g.win + 15) / 16;
  g.stride = 4 * (g.chunks | 1);
  g.rows = g.ngy * ty + 16;
  g.per_mb = g.rows * g.stride + 64;
  g.copies = g.win * g.chunks + 16;
  const int fit = kMaxSmem / (2 * 4 * g.per_mb);     // double buffer
  g.mbs = kThreads / g.tiles;
  g.mbs = g.mbs < 1 ? 1 : (g.mbs > kMaxMbs ? kMaxMbs : g.mbs);
  g.mbs = g.mbs > fit ? fit : g.mbs;
  return g;
}

// Tile heights (dy per thread) and resident CTAs per SM of each kernel.
// esa16 at r = 16: 33 = 3 x 11 rows, 44 accumulators, one CTA per SM;
// esa_parts' four accumulators per candidate hold it to 4 rows, which
// leaves room for two CTAs per SM (on an H100, one CTA per SM took 23%
// longer at r = 16; tools/esa_variants.py's parts_minb1).
constexpr int kTallFrom = 12;      // the tall height from this range on
template <int UNITS>
struct Tiles;
template <>
struct Tiles<1> {
  static constexpr int kShort = 6, kTall = 11, kMinBlocks = 1;
};
template <>
struct Tiles<9> {
  static constexpr int kShort = 3, kTall = 4, kMinBlocks = 2;
};

template <int UNITS>
inline int tile_rows(int r) {
  return r >= kTallFrom ? Tiles<UNITS>::kTall : Tiles<UNITS>::kShort;
}

// Output planes of the four unit groups: q (4 per MB), h (2), v (2), f (1).
struct Out {
  int* cost[4];
  int* mv[4];
};

__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

// One MB's SADs of one tile, and the tile's keys folded into best[]; w is
// the tile's first window word, s_src the MB's 16 source rows of 4 words.
template <int UNITS, int TY>
__device__ __forceinline__ void search_tile(
    const uint32_t* __restrict__ w, const uint32_t* __restrict__ s_src,
    const int* s_bits, int stride, int span, int dx0, int dy0, int lam,
    uint32_t (&best)[UNITS]) {
  constexpr int Q = UNITS == 1 ? 1 : 4;   // accumulators per candidate
  uint32_t acc[TY][4][Q];
#pragma unroll
  for (int u = 0; u < TY; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int q = 0; q < Q; ++q) acc[u][x][q] = 0;

  constexpr int R = TY < 8 ? TY : 16;   // source rows held
  uint32_t s[R][4];                      // source row j sits in s[j % R]
#pragma unroll
  for (int k = 0; k < 15 + TY; ++k) {
    // all 16 source rows at the start, or row k as the walk reaches it
    const int j0 = R == 16 ? (k ? 16 : 0) : k;
    const int j1 = R == 16 ? 16 : (k < 16 ? k + 1 : k);
#pragma unroll
    for (int j = j0; j < j1; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(s_src + 4 * j);
      s[j % R][0] = v.x;
      s[j % R][1] = v.y;
      s[j % R][2] = v.z;
      s[j % R][3] = v.w;
    }
    uint32_t a[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) a[e] = w[e];
    w += stride;
    uint32_t sh[4][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sh[0][e] = a[e];
#pragma unroll
      for (int x = 1; x < 4; ++x)
        sh[x][e] = __byte_perm(a[e], a[e + 1], 0x3210u + 0x1111u * x);
    }
#pragma unroll
    for (int u = 0; u < TY; ++u) {
      const int j = k - u;             // source row (static)
      if (j < 0 || j >= 16) continue;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = Q == 1 ? 0 : 2 * (j >> 3) + (e >> 1);
          acc[u][x][q] = sad4(s[j % R][e], sh[x][e], acc[u][x][q]);
        }
    }
  }

  // keys: a candidate's base (bias << 13) | c is xb[x] + yb, with
  // xb = (lam * bits(dx) << 13) + dx index and yb = (lam * bits(dy) << 13)
  // + dy index * span; one IMAD per unit, and mins taken two keys at a time
  uint32_t xb[4];
  bool xin[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int dxi = dx0 + x;
    xin[x] = dxi >= 0 && dxi < span;
    xb[x] = ((uint32_t)(lam * s_bits[4 * min(max(dxi, 0), span - 1)])
             << kCandBits) + (uint32_t)dxi;
  }
#pragma unroll
  for (int u = 0; u < TY; ++u) {
    const int dyi = dy0 + u;
    const uint32_t yb =
        ((uint32_t)(lam * s_bits[4 * min(dyi, span - 1)]) << kCandBits)
        + (uint32_t)(dyi * span);
    uint32_t base[4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      base[x] = dyi < span && xin[x] ? xb[x] + yb : kMaskedBase;
#pragma unroll
    for (int x = 0; x < 4; x += 2) {
      const uint32_t(&p)[Q] = acc[u][x];
      const uint32_t(&o)[Q] = acc[u][x + 1];
      if constexpr (UNITS == 1) {
        best[0] = min(best[0], min(p[0] * (1u << kCandBits) + base[x],
                                   o[0] * (1u << kCandBits) + base[x + 1]));
      } else {
        const uint32_t sp[9] = {p[0],        p[1],        p[2],
                                p[3],        p[0] + p[1], p[2] + p[3],
                                p[0] + p[2], p[1] + p[3],
                                p[0] + p[1] + p[2] + p[3]};
        const uint32_t so[9] = {o[0],        o[1],        o[2],
                                o[3],        o[0] + o[1], o[2] + o[3],
                                o[0] + o[2], o[1] + o[3],
                                o[0] + o[1] + o[2] + o[3]};
#pragma unroll
        for (int k = 0; k < UNITS; ++k)
          best[k] = min(best[k],
                        min(sp[k] * (1u << kCandBits) + base[x],
                            so[k] * (1u << kCandBits) + base[x + 1]));
      }
    }
  }
}

template <int UNITS, int MINB, int TY>
__global__ void __launch_bounds__(kThreads, MINB)
search_kernel(const uint8_t* __restrict__ src,
              const uint8_t* __restrict__ ref, const int* __restrict__ bits,
              Out out, Geom gp, int mbw, int n_mb, int lam, int pad) {
  const Geom g = gp;           // a local copy: the lambda below captures it
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t s_best[kMaxMbs * UNITS];
  __shared__ int s_bits[8 * kMaxRange + 1];
  const int tid = threadIdx.x;
  const int wp = 16 * mbw + 2 * pad;
  // groups: `rounds` rounds of g.mbs MBs per CTA, then the rem MBs left
  // spread evenly, q or q + 1 per CTA, so the last round is short
  const int nb = gridDim.x, b = blockIdx.x;
  const int rounds = n_mb / (g.mbs * nb);
  const int rem = n_mb - rounds * g.mbs * nb;
  const int q = rem / nb, rr = rem - q * nb;
  const int n_it = rounds + (q + (b < rr) > 0);
  auto group = [&](int it, int& mb0, int& nmb) {
    if (it < rounds) {
      mb0 = (it * nb + b) * g.mbs;
      nmb = g.mbs;
    } else {
      mb0 = rounds * nb * g.mbs + b * q + min(b, rr);
      nmb = q + (b < rr);
    }
  };

  for (int i = tid; i <= 8 * g.r; i += kThreads) s_bits[i] = bits[i];
  for (int i = tid; i < g.mbs * UNITS; i += kThreads) s_best[i] = ~0u;

  // stage a group: this thread's (at most two) 16-byte copies per MB, each
  // a shared-memory word and a byte offset from the MB's window origin or
  // source MB origin (recomputed per group, which holds no registers)
  auto stage = [&](int it, uint32_t* buf) {
    int c_sm[2], c_gl[2];
    bool c_src[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int j = tid + k * kThreads;
      const int nw = g.win * g.chunks;
      const int row = j / g.chunks, ch = j - row * g.chunks;
      c_src[k] = j >= nw;
      c_sm[k] = c_src[k] ? g.rows * g.stride + 4 * (j - nw)
                         : row * g.stride + 4 * ch;
      c_gl[k] = c_src[k] ? (j - nw) * 16 * mbw : row * wp + 16 * ch;
    }
    int mb0, nmb;
    group(it, mb0, nmb);
    int mby = mb0 / mbw, mbx = mb0 - mby * mbw;
    for (int m = 0; m < nmb; ++m) {
      const uint8_t* wo = ref + (size_t)(pad + 16 * mby - g.r) * wp
                          + pad + 16 * mbx - g.r - g.off;
      const uint8_t* so = src + (size_t)16 * mby * 16 * mbw + 16 * mbx;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (tid + k * kThreads < g.copies)
          cp_async16(buf + m * g.per_mb + c_sm[k],
                     (c_src[k] ? so : wo) + c_gl[k]);
      if (++mbx == mbw) {
        mbx = 0;
        ++mby;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // every item of a thread belongs to one MB of the group (a thread walks
  // several items only when a group is one MB); idle lanes join the last
  const int items = g.mbs * g.tiles;
  const int my_m = min(tid / g.tiles, g.mbs - 1);
  const unsigned peers = __match_any_sync(0xffffffffu, my_m);
  const bool leader = (tid & 31) == __ffs(peers) - 1;
  const int buf_words = g.mbs * g.per_mb;

  if (n_it) stage(0, smem);
  for (int it = 0; it < n_it; ++it) {
    const uint32_t* cur = smem + (it & 1) * buf_words;
    if (it + 1 < n_it)
      stage(it + 1, smem + ((it + 1) & 1) * buf_words);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();

    int mb0, nmb;
    group(it, mb0, nmb);
    uint32_t best[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) best[k] = ~0u;
    if (my_m < nmb) {
      const uint32_t* mb_sm = cur + my_m * g.per_mb;
      for (int i = tid; i < items; i += kThreads) {
        const int t = i - my_m * g.tiles;
        const int gy = t / g.ngx, gx = t - gy * g.ngx;
        const int gw = g.g0 + gx;
        search_tile<UNITS, TY>(mb_sm + TY * gy * g.stride + gw,
                               mb_sm + g.rows * g.stride, s_bits, g.stride,
                               g.span, 4 * gw - g.off, TY * gy, lam, best);
      }
    }

    // the MB's lanes of this warp, then the CTA (shared-memory atomics)
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const uint32_t lo = __reduce_min_sync(peers, best[k]);
      if (leader) atomicMin(&s_best[my_m * UNITS + k], lo);
    }
    __syncthreads();
    for (int i = tid; i < nmb * UNITS; i += kThreads) {
      const int m = i / UNITS, k = i - m * UNITS;
      const uint32_t key = s_best[i];
      s_best[i] = ~0u;
      const int cand = (int)(key & ((1u << kCandBits) - 1));
      const int dyi = cand / g.span, dxi = cand - dyi * g.span;
      // unit k -> group (q, h, v, f) and its slot in the MB's row
      const int grp_k = UNITS == 1 ? 3
                        : (k < 4 ? 0 : (k < 6 ? 1 : (k < 8 ? 2 : 3)));
      const int per = grp_k == 0 ? 4 : (grp_k == 3 ? 1 : 2);
      const int slot = UNITS == 1 ? 0
                       : (k < 4 ? k : (k < 8 ? (k - 4) & 1 : 0));
      const int idx = (mb0 + m) * per + slot;
      // constant indices: a computed one would copy `out` to local memory
      int* c_out = grp_k == 0 ? out.cost[0] : grp_k == 1 ? out.cost[1]
                   : grp_k == 2 ? out.cost[2] : out.cost[3];
      int* m_out = grp_k == 0 ? out.mv[0] : grp_k == 1 ? out.mv[1]
                   : grp_k == 2 ? out.mv[2] : out.mv[3];
      c_out[idx] = (int)(key >> kCandBits);
      m_out[2 * idx] = 4 * (dxi - g.r);
      m_out[2 * idx + 1] = 4 * (dyi - g.r);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int UNITS, int MINB, int TY>
int launch_rows(const Geom& g, const void* src, const void* ref,
                const void* bits, const Out& out, int mbw, int n_mb, int lam,
                int pad, void* stream) {
  // no static caches: a function template's statics are one object for
  // every library of a process that instantiates it, and each library's
  // kernel needs its own opt-in
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // beside the static shared memory, even a little under 48 KB of dynamic
  // needs the opt-in
  const size_t smem = 2 * (size_t)g.mbs * g.per_mb * sizeof(uint32_t);
  err = cudaFuncSetAttribute(search_kernel<UNITS, MINB, TY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 1;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, search_kernel<UNITS, MINB, TY>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_groups = (n_mb + g.mbs - 1) / g.mbs;
  const int grid = n_groups < n_sm * per_sm ? n_groups : n_sm * per_sm;
  search_kernel<UNITS, MINB, TY>
      <<<grid > 0 ? grid : 1, kThreads, smem, (cudaStream_t)stream>>>(
          (const uint8_t*)src, (const uint8_t*)ref, (const int*)bits, out, g,
          mbw, n_mb, lam, pad);
  return (int)cudaGetLastError();
}

// One launch of the search with this range's tile height; returns a
// cudaError_t.
template <int UNITS>
int launch(const void* src, const void* ref, const void* bits,
           const Out& out, int mbw, int mbh, int r, int lam, int pad,
           void* stream) {
  if (r < 0 || r > pad || r > kMaxRange || pad % 16 || mbw < 1 || mbh < 1)
    return (int)cudaErrorInvalidValue;
  using T = Tiles<UNITS>;
  const int ty = tile_rows<UNITS>(r);
  const Geom g = make_geom(r, pad, ty);
  return ty == T::kTall
             ? launch_rows<UNITS, T::kMinBlocks, T::kTall>(
                   g, src, ref, bits, out, mbw, mbw * mbh, lam, pad, stream)
             : launch_rows<UNITS, T::kMinBlocks, T::kShort>(
                   g, src, ref, bits, out, mbw, mbw * mbh, lam, pad, stream);
}

}  // namespace esa
