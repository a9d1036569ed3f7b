// H.264 in-loop deblocking filter (spec 8.7) for Hopper (sm_90a): one
// launch per frame filters Y, Cb and Cr together (4 vertical, then 4
// horizontal luma edges per 16x16 MB; edges 0 and 2 of each direction per
// 8x8 chroma MB).
//
// Replaces: x264_tpu/ops/device/deblock_pallas.py::deblock_filter_pallas,
// both its pallas_calls (luma body _luma_kernel_body, chroma body
// _chroma_kernel_body), whose contract is x264_tpu/ops/device/deblock.py::
// _deblock_filter (the edge arithmetic is _luma_filter_params /
// _chroma_filter_params there).
//
// What bounds it on the H100: the dependency chain, not bytes or
// arithmetic.  An MB's edges read pixels its left and top neighbours
// wrote, and its top-right neighbour's vertical edge 0, so a 1080p frame
// is a chain of 254 knight steps of 8 dependent luma edge passes each; the
// ~7 MB of planes and strengths are a few microseconds of bandwidth.
//
// Design: the Pallas kernel's property, the frame resident in fast memory
// through one launch, kept the Hopper way.
// - One block of one warp per MB row (mbh blocks).  Lanes 0-15 take the 16
//   luma lines of an edge, lanes 16-23 the Cb lines and 24-31 the Cr lines;
//   chroma is the luma filter with ap = aq = false and tc = tc0 + 1, so all
//   32 lanes run one instruction stream, and the chroma lanes' edges ride
//   on luma passes 0, 2, 4 and 6 (vertical 0, 2, horizontal 0, 2).  Passes
//   meet at __syncwarp().
// - A block takes its row from an atomic ticket, not from blockIdx.x, so it
//   waits only on a row whose block is already running: no deadlock when
//   the grid has more blocks than the card keeps resident.
// - progress[y] counts the MBs of row y whose pixels are final in global
//   memory (as far as row y writes them; row y+1's top edges change rows
//   13-15 later).  MB x-1 of row y is final once MB x has run its vertical
//   edge 0, which changes columns 13-15 (chroma: 7) of MB x-1, so row y
//   publishes x right after MB x's vertical edges, and mbw at the end of
//   the row.  Vertical edges touch only the row's own pixels, so they run
//   without waiting.  MB x's horizontal edge 0 reads the bottom 4 luma (2
//   chroma) lines of row y-1's MB x and writes 3 (1) of them, so it waits
//   for progress[y-1] > x (row y-1 has run MB x+1's vertical edges).
// - Row y's own pixels are touched by nobody before row y filters them, so
//   the next MB's pixels, strengths and QPs are loaded into registers
//   while the current one filters.
// - The MB and its margins live in shared memory: luma 4 px left and 4
//   lines above, chroma 4 and 4 (the unified filter reads 4 taps either
//   side; chroma uses 2).  The left margin is the previous MB of the same
//   block.  The previous MB's last 4 columns are written back after the
//   current MB's vertical edges; the current MB's first 12 (4) columns and
//   the 3 (1) lines above after its horizontal edges.
// - Memory order: the producer's lanes store, meet at __syncwarp(), and
//   lane 0 publishes with st.release.gpu (CUTLASS's semaphore pattern; an
//   extra __threadfence() before it cost ~10% at 1080p).  Every consumer lane polls with ld.acquire.gpu itself, so its
//   own later loads are ordered after the acquire; those loads of the row
//   above also go through __ldcg (L2, not L1), so no L1 line that this SM
//   held from before can be served.
// alpha, beta and tc0 come from the ALPHA/BETA/TC0 tables (state.py),
// copied to shared memory once per block; qp_av = (qp_c + qp_n + 1) >> 1
// with the left MB for vertical edge 0 and the top MB for horizontal edge
// 0.  Frame-border edges (left edge 0 of column 0, top edge 0 of row 0)
// are never filtered.
//
// deblock_chain_probe (a probe, not part of the filter; launched only by
// chip_smoke.py) runs one warp through the same per-MB passes on a tile
// already in shared memory, with no global memory and no other block: the
// time of the dependent chain alone, the bound's second term.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LW = 20, LH = 20;   // luma tile: 4 + 16 columns, 4 + 16 rows
constexpr int CW = 12, CH = 12;   // chroma tile per plane: 4 + 8, 4 + 8
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  const int* alpha;   // (52,)
  const int* beta;    // (52,)
  const int* tc0;     // (52, 3)
  int off_a, off_b;
};

struct Shared {
  uint8_t y[LH * LW];
  uint8_t c[2][CH * CW];
  int alpha[52], beta[52], tc0[156];
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t* word(uint8_t* p) {
  return reinterpret_cast<uint32_t*>(p);
}

// One line across an edge: q0 at p[0], p0 at p[-s], s = tap stride.
// Chroma is the luma filter with ap = aq = false and tc = tc0 + 1: only p0
// and q0 change (8.7.2.3/.4).
__device__ void filter_line(uint8_t* p, int s, int bs, int qp_av,
                            bool chroma, const Shared& sh, int off_a,
                            int off_b) {
  const int ia = clip3(0, 51, qp_av + off_a);
  const int ib = clip3(0, 51, qp_av + off_b);
  const int alpha = sh.alpha[ia], beta = sh.beta[ib];
  const int p0 = p[-s], p1 = p[-2 * s], p2 = p[-3 * s];
  const int q0 = p[0], q1 = p[s], q2 = p[2 * s];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta
        && iabs(q1 - q0) < beta))
    return;
  const bool ap = !chroma && iabs(p2 - p0) < beta;
  const bool aq = !chroma && iabs(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = sh.tc0[3 * ia + bs - 1];
    const int tc = chroma ? tc0 + 1 : tc0 + ap + aq;
    const int delta =
        clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    p[-s] = (uint8_t)clip3(0, 255, p0 + delta);
    p[0] = (uint8_t)clip3(0, 255, q0 - delta);
    if (ap)
      p[-2 * s] = (uint8_t)(p1 + clip3(-tc0, tc0,
                                       (p2 + ((p0 + q0 + 1) >> 1) - p1 * 2)
                                           >> 1));
    if (aq)
      p[s] = (uint8_t)(q1 + clip3(-tc0, tc0,
                                  (q2 + ((p0 + q0 + 1) >> 1) - q1 * 2) >> 1));
    return;
  }
  const bool strong = iabs(p0 - q0) < ((alpha >> 2) + 2);
  const int p3 = p[-4 * s], q3 = p[3 * s];
  if (ap && strong) {
    p[-s] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    p[-2 * s] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    p[-3 * s] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    p[-s] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (aq && strong) {
    p[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
    p[s] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
    p[2 * s] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    p[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

// What one lane filters: its line of the luma tile (lanes 0-15) or of the
// Cb / Cr tile (lanes 16-23 / 24-31).
struct Lane {
  uint8_t* tile;
  int w;        // tile row stride
  int step;     // distance between edges: 4 (luma) or 2 (chroma)
  int line;     // 0..15 (luma) or 0..7 (chroma)
  bool chroma;
};

__device__ __forceinline__ Lane lane_role(Shared& sh, int lane) {
  if (lane < 16) return Lane{sh.y, LW, 4, lane, false};
  return Lane{sh.c[(lane >> 3) & 1], CW, 2, lane & 7, true};
}

// Passes k0..k1-1 of one MB's 8: vertical edges 0-3, then horizontal
// edges 0-3.  bs[k] is this lane's strength on pass k (0: nothing to do,
// as on the chroma lanes' odd passes and on frame-border edges).
__device__ __forceinline__ void mb_passes(const Lane& ln, const int bs[8],
                                          int qp_c, int qav_l, int qav_t,
                                          const Shared& sh, int off_a,
                                          int off_b, int k0, int k1) {
#pragma unroll
  for (int k = k0; k < k1; ++k) {
    if (bs[k] > 0) {
      const int e = k & 3;
      uint8_t* p = k < 4
          ? ln.tile + (4 + ln.line) * ln.w + 4 + e * ln.step
          : ln.tile + (4 + e * ln.step) * ln.w + 4 + ln.line;
      const int qp_av = k == 0 ? qav_l : (k == 4 ? qav_t : qp_c);
      filter_line(p, k < 4 ? 1 : ln.w, bs[k], qp_av, ln.chroma, sh, off_a,
                  off_b);
    }
    __syncwarp();
  }
}

__device__ void load_tables(Shared& sh, const Tables& tb, int lane) {
  for (int i = lane; i < 52; i += 32) {
    sh.alpha[i] = tb.alpha[i];
    sh.beta[i] = tb.beta[i];
  }
  for (int i = lane; i < 156; i += 32) sh.tc0[i] = tb.tc0[i];
  for (int i = lane; i < LH * LW / 4; i += 32) word(sh.y)[i] = 0;
  for (int i = lane; i < 2 * CH * CW / 4; i += 32) word(&sh.c[0][0])[i] = 0;
  __syncwarp();   // before other lanes write the tiles or read the tables
}

// What one lane loads of an MB, one MB ahead of filtering it: luma words
// lane and lane + 32 of the 16 rows x 4 words, chroma word lane of the 2
// planes x 8 rows x 2; its strengths on the 8 passes; the QPs (luma or
// chroma) of the MB and of its left and top neighbours.
struct MbIn {
  uint32_t l0, l1, c;
  int bs[8];
  int qp_c, qp_l, qp_t;
};

struct Planes {
  uint8_t* y;
  uint8_t* u;
  uint8_t* v;
  int w, cw;    // luma and chroma row strides
};

__device__ __forceinline__ uint8_t* luma_at(const Planes& pl, int mby,
                                            int mbx, int r, int col) {
  return pl.y + (size_t)(16 * mby + r) * pl.w + 16 * mbx + col;
}

__device__ __forceinline__ uint8_t* chroma_at(const Planes& pl, int plane,
                                              int mby, int mbx, int r,
                                              int col) {
  return (plane ? pl.v : pl.u) + (size_t)(8 * mby + r) * pl.cw + 8 * mbx
      + col;
}

// g: the row (vertical edges) or column (horizontal edges) of this lane's
// line in the MB's 4x4 grid of bS.
__device__ __forceinline__ MbIn load_mb(const Planes& pl,
                                        const int* __restrict__ bs_v,
                                        const int* __restrict__ bs_h,
                                        const int* __restrict__ q, int mbw,
                                        int mby, int mbx, int lane, int g,
                                        bool chroma) {
  MbIn m;
  m.l0 = *word(luma_at(pl, mby, mbx, lane >> 2, 4 * (lane & 3)));
  m.l1 = *word(luma_at(pl, mby, mbx, 8 + (lane >> 2), 4 * (lane & 3)));
  m.c = *word(chroma_at(pl, lane >> 4, mby, mbx, (lane >> 1) & 7,
                        4 * (lane & 1)));
  const int gw = 4 * mbw;
  const int4 bv = *reinterpret_cast<const int4*>(
      bs_v + (size_t)(4 * mby + g) * gw + 4 * mbx);
  m.bs[0] = mbx > 0 ? bv.x : 0;
  m.bs[1] = bv.y;
  m.bs[2] = bv.z;
  m.bs[3] = bv.w;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    m.bs[4 + e] = e > 0 || mby > 0
        ? bs_h[(size_t)(4 * mby + e) * gw + 4 * mbx + g] : 0;
  if (chroma) m.bs[1] = m.bs[3] = m.bs[5] = m.bs[7] = 0;
  const int mb = mby * mbw + mbx;
  m.qp_c = q[mb];
  m.qp_l = mbx > 0 ? q[mb - 1] : m.qp_c;
  m.qp_t = mby > 0 ? q[mb - mbw] : m.qp_c;
  return m;
}

__device__ __forceinline__ void store_mb_to_tile(Shared& sh, const MbIn& m,
                                                 int lane) {
  const int c4 = 4 + 4 * (lane & 3);
  *word(sh.y + (4 + (lane >> 2)) * LW + c4) = m.l0;
  *word(sh.y + (12 + (lane >> 2)) * LW + c4) = m.l1;
  *word(sh.c[lane >> 4] + (4 + ((lane >> 1) & 7)) * CW + 4
        + 4 * (lane & 1)) = m.c;
}

// Write back the left margin of the tile (the last 4 columns of MB mbx,
// which the next MB's vertical edge 0 has filtered): luma by lanes 0-15,
// chroma by lanes 16-31.
__device__ __forceinline__ void write_margin(Shared& sh, const Planes& pl,
                                             int mby, int mbx, int lane) {
  if (lane < 16) {
    *word(luma_at(pl, mby, mbx, lane, 12)) = *word(sh.y + (4 + lane) * LW);
  } else {
    const int plane = (lane >> 3) & 1, r = lane & 7;
    *word(chroma_at(pl, plane, mby, mbx, r, 4)) =
        *word(sh.c[plane] + (4 + r) * CW);
  }
}

// Publish progress[row] = n after every lane's stores: the warp meets,
// then one lane's release store, which is cumulative over the stores the
// barrier ordered before it (CUTLASS's semaphore release pattern).
__device__ __forceinline__ void publish(int* progress, int row, int n,
                                        int lane) {
  __syncwarp();
  if (lane == 0) st_release(progress + row, n);
}

__global__ void __launch_bounds__(32)
deblock_kernel(Planes pl, const int* __restrict__ bs_v,
               const int* __restrict__ bs_h, const int* __restrict__ qp,
               const int* __restrict__ qpc, Tables tb, int mbw,
               int* ticket, int* progress) {
  __shared__ __align__(16) Shared sh;
  const int lane = threadIdx.x;
  load_tables(sh, tb, lane);
  int row = 0;
  if (lane == 0) row = atomicAdd(ticket, 1);
  const int mby = __shfl_sync(FULL, row, 0);
  const Lane ln = lane_role(sh, lane);
  const int* q = ln.chroma ? qpc : qp;
  const int g = ln.chroma ? ln.line >> 1 : ln.line >> 2;
  int seen = 0;               // progress[mby - 1] as last read
  MbIn cur = load_mb(pl, bs_v, bs_h, q, mbw, mby, 0, lane, g, ln.chroma);
  for (int mbx = 0; mbx < mbw; ++mbx) {
    store_mb_to_tile(sh, cur, lane);
    const int qav_l = (cur.qp_c + cur.qp_l + 1) >> 1;
    const int qav_t = (cur.qp_c + cur.qp_t + 1) >> 1;
    __syncwarp();

    // vertical edges: this row's pixels only, so no wait
    mb_passes(ln, cur.bs, cur.qp_c, qav_l, qav_t, sh, tb.off_a, tb.off_b,
              0, 4);
    // vertical edge 0 was the last to touch the previous MB
    if (mbx > 0) {
      write_margin(sh, pl, mby, mbx - 1, lane);
      publish(progress, mby, mbx, lane);
    }
    // loaded after the release, which would otherwise wait for them
    MbIn next;
    if (mbx + 1 < mbw)
      next = load_mb(pl, bs_v, bs_h, q, mbw, mby, mbx + 1, lane, g,
                     ln.chroma);
    if (mby > 0) {
      while (seen <= mbx) seen = ld_acquire(progress + mby - 1);
      // the bottom 4 luma / 2 chroma lines of the MB above
      if (lane < 16) {
        *word(sh.y + (lane >> 2) * LW + 4 + 4 * (lane & 3)) = __ldcg(
            reinterpret_cast<const unsigned int*>(
                luma_at(pl, mby - 1, mbx, 12 + (lane >> 2),
                        4 * (lane & 3))));
      } else if (lane < 24) {
        const int plane = (lane >> 2) & 1, r = (lane >> 1) & 1;
        *word(sh.c[plane] + (2 + r) * CW + 4 + 4 * (lane & 1)) = __ldcg(
            reinterpret_cast<const unsigned int*>(
                chroma_at(pl, plane, mby - 1, mbx, 6 + r, 4 * (lane & 1))));
      }
    }
    __syncwarp();
    mb_passes(ln, cur.bs, cur.qp_c, qav_l, qav_t, sh, tb.off_a, tb.off_b,
              4, 8);

    // write back what is final: this MB's first 12 (chroma 4) columns and
    // the 3 (1) lines above; its last 4 become the next MB's left margin
    for (int i = lane; i < 48 + 16; i += 32) {
      if (i < 48) {
        const int r = i / 3, c = i % 3;
        *word(luma_at(pl, mby, mbx, r, 4 * c)) =
            *word(sh.y + (4 + r) * LW + 4 + 4 * c);
      } else {
        const int plane = (i - 48) >> 3, r = (i - 48) & 7;
        *word(chroma_at(pl, plane, mby, mbx, r, 0)) =
            *word(sh.c[plane] + (4 + r) * CW + 4);
      }
    }
    if (mby > 0) {
      if (lane < 12) {
        const int r = 1 + lane / 4, c = lane & 3;
        *word(luma_at(pl, mby - 1, mbx, 12 + r, 4 * c)) =
            *word(sh.y + r * LW + 4 + 4 * c);
      } else if (lane < 16) {
        const int plane = (lane >> 1) & 1, c = lane & 1;
        *word(chroma_at(pl, plane, mby - 1, mbx, 7, 4 * c)) =
            *word(sh.c[plane] + 3 * CW + 4 + 4 * c);
      }
    }
    if (lane < 16) {
      *word(sh.y + (4 + lane) * LW) = *word(sh.y + (4 + lane) * LW + 16);
    } else {
      uint8_t* t = sh.c[(lane >> 3) & 1] + (4 + (lane & 7)) * CW;
      *word(t) = *word(t + 8);
    }
    __syncwarp();
    if (mbx + 1 < mbw) cur = next;
  }
  write_margin(sh, pl, mby, mbw - 1, lane);
  publish(progress, mby, mbw, lane);
}

// The probe: `steps` MBs' worth of the 8 passes on a tile already in
// shared memory, every luma line at strength bs (chroma lanes on passes
// 0, 2, 4, 6, as in deblock_kernel), QP 26; writes the tile out so that
// the work is kept.
__global__ void __launch_bounds__(32)
deblock_chain_probe(uint8_t* out, Tables tb, int steps, int bs_all) {
  __shared__ __align__(16) Shared sh;
  const int lane = threadIdx.x;
  load_tables(sh, tb, lane);
  for (int i = lane; i < LH * LW; i += 32)
    sh.y[i] = (uint8_t)(100 + 3 * (i % LW) + (i / LW) + (i * 7) % 5);
  uint8_t* c = &sh.c[0][0];
  for (int i = lane; i < 2 * CH * CW; i += 32)
    c[i] = (uint8_t)(120 + 2 * (i % CW) + (i * 5) % 3);
  __syncwarp();
  const Lane ln = lane_role(sh, lane);
  int bs[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    bs[k] = (ln.chroma && (k & 1)) ? 0 : bs_all;
  for (int t = 0; t < steps; ++t)
    mb_passes(ln, bs, 26, 26, 26, sh, tb.off_a, tb.off_b, 0, 8);
  for (int i = lane; i < LH * LW; i += 32) out[i] = sh.y[i];
  for (int i = lane; i < 2 * CH * CW; i += 32) out[LH * LW + i] = c[i];
}

}  // namespace

// ticket_progress: mbh + 1 zeroed ints (the ticket, then one progress
// counter per MB row); the caller allocates and zeroes them.
extern "C" int deblock_launch(void* y, void* u, void* v, const void* bs_v,
                              const void* bs_h, const void* qp,
                              const void* qpc, const void* alpha,
                              const void* beta, const void* tc0,
                              void* ticket_progress, int mbw, int mbh,
                              int off_a, int off_b, void* stream) {
  const Tables tb{(const int*)alpha, (const int*)beta, (const int*)tc0,
                  off_a, off_b};
  const Planes pl{(uint8_t*)y, (uint8_t*)u, (uint8_t*)v, 16 * mbw, 8 * mbw};
  int* sync = (int*)ticket_progress;
  deblock_kernel<<<mbh, 32, 0, (cudaStream_t)stream>>>(
      pl, (const int*)bs_v, (const int*)bs_h, (const int*)qp,
      (const int*)qpc, tb, mbw, sync, sync + 1);
  return (int)cudaGetLastError();
}

// out: LH*LW + 2*CH*CW bytes.
extern "C" int deblock_chain_probe_launch(void* out, const void* alpha,
                                          const void* beta, const void* tc0,
                                          int steps, int bs, void* stream) {
  const Tables tb{(const int*)alpha, (const int*)beta, (const int*)tc0, 0,
                  0};
  deblock_chain_probe<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint8_t*)out, tb, steps, bs);
  return (int)cudaGetLastError();
}

extern "C" const char* x264tpu_cuda_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
