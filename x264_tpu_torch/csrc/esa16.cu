// Exhaustive fullpel 16x16 motion search (ESA) for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/me_pallas.py::full_search_pallas (the
// Mosaic kernel body _phase_body), whose contract is
// x264_tpu/ops/device/me.py::_full_search_xla: for every MB the (dx, dy) in
// [-r, r]^2 of least SAD + lam * (bits[4dx+4r] + bits[4dy+4r]), ties going
// to the first candidate in (dy, dx) raster order; mv in qpel and the cost.
//
// The search, its bound on the H100 and its design are esa_core.cuh's, with
// one unit (the 16x16 block) and tiles of 4 dx x TY dy, TY 11 from r = 12
// on (r = 16: 33 = 3 x 11 rows, 44 accumulators) and 6 below.
//
// esa_sad_probe (a probe, not part of the search; launched only by
// chip_smoke.py) runs eight independent vabsdiff4 chains per thread on
// every SM: the card's rate for the instruction the search is made of, the
// bound's operation rate.  esa_geom_query hands out the geometry that both
// kernels' launches compute, for the tests to hold against their mirror.
#include "esa_core.cuh"

namespace {

constexpr int kProbeUnroll = 16;

__global__ void __launch_bounds__(esa::kThreads)
esa_sad_probe(uint32_t* out, int iters) {
  uint32_t a[8], b[8], acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = 0x01010101u * (threadIdx.x + 3 * i + 1);
    b[i] = a[i] ^ 0x5a3c96e1u;
    acc[i] = 0;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kProbeUnroll; ++k)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = esa::sad4(a[i], b[(i + k) & 7], acc[i]);
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= acc[i];
  if (s == 0x9e3779b9u) out[0] = s;    // keeps the chains live
}

}  // namespace

extern "C" int esa16_launch(const void* src, const void* ref,
                            const void* bits, void* mv, void* cost, int mbw,
                            int mbh, int r, int lam, int pad,
                            void* stream) {
  esa::Out out{};
  out.cost[3] = (int*)cost;
  out.mv[3] = (int*)mv;
  return esa::launch<1>(src, ref, bits, out, mbw, mbh, r, lam, pad, stream);
}

// The launch geometry of the kernel with `units` units (1 or 9) at range
// r: out[0] the tile height, out[1..14] the Geom's fields in their order.
extern "C" int esa_geom_query(int units, int r, int pad, int* out) {
  if (units != 1 && units != 9) return (int)cudaErrorInvalidValue;
  const int ty = units == 1 ? esa::tile_rows<1>(r) : esa::tile_rows<9>(r);
  const esa::Geom g = esa::make_geom(r, pad, ty);
  const int v[] = {ty,      g.r,     g.span,  g.win,    g.off,
                   g.g0,    g.ngx,   g.ngy,   g.tiles,  g.chunks,
                   g.stride, g.rows, g.per_mb, g.copies, g.mbs};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

// vabsdiff4 per launch: blocks * esa::kThreads * iters * 8 * 16
extern "C" int esa_sad_probe_launch(void* out, int blocks, int iters,
                                    void* stream) {
  esa_sad_probe<<<blocks, esa::kThreads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, iters);
  return (int)cudaGetLastError();
}
