// Exhaustive fullpel partition search (ESA, nine units) for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/me_parts_pallas.py::full_search_parts_pallas
// (the Mosaic kernel body _phase_body), whose contract is
// x264_tpu/ops/device/me_parts.py::full_search_parts_xla: esa16's search
// with nine units per candidate — quadrants q0..q3 (q = 2*qy + qx), 16x8
// halves h = (q0+q1, q2+q3), 8x16 halves v = (q0+q2, q1+q3) and the 16x16
// block f — each plus the same bias, each with its own raster-first argmin.
//
// The search, its bound on the H100 and its design are esa_core.cuh's, with
// four quadrant accumulators per candidate and tiles of 4 dx x TY dy, TY 4
// from r = 12 on and 3 below (four accumulators per candidate hold the
// height down), two CTAs per SM.  The Pallas kernel's packed int32 key
// capped r at 24; the unsigned 32-bit key here holds r up to the padding.
#include "esa_core.cuh"

extern "C" int esa_parts_launch(const void* src, const void* ref,
                                const void* bits, void* cost_q, void* mv_q,
                                void* cost_h, void* mv_h, void* cost_v,
                                void* mv_v, void* cost_f, void* mv_f,
                                int mbw, int mbh, int r, int lam, int pad,
                                void* stream) {
  const esa::Out out{{(int*)cost_q, (int*)cost_h, (int*)cost_v,
                      (int*)cost_f},
                     {(int*)mv_q, (int*)mv_h, (int*)mv_v, (int*)mv_f}};
  return esa::launch<9>(src, ref, bits, out, mbw, mbh, r, lam, pad, stream);
}
