// H.264 in-loop deblocking filter (spec 8.7) for Hopper (sm_90a):
// deblock_luma (4 vertical, then 4 horizontal edges per 16x16 MB) and
// deblock_chroma (edges 0 and 2 of each direction per 8x8 MB, Cb and Cr).
//
// Replaces: x264_tpu/ops/device/deblock_pallas.py::deblock_filter_pallas,
// its luma body _luma_kernel_body and its chroma body _chroma_kernel_body,
// whose contract is x264_tpu/ops/device/deblock.py::_deblock_filter (the
// edge arithmetic is _luma_filter_params / _chroma_filter_params there).
//
// What bounds it on the H100: the dependency chain, not bytes or
// arithmetic.  An MB's edges read pixels its left and top neighbours wrote
// (and its top-right neighbour's vertical edges), so MBs on the knight
// diagonal t = mbx + 2*mby are the only independent set: 254 dependent
// steps at 1080p with at most 68 MBs each.  The whole frame is ~3 MB, so
// each step is a few microseconds of work behind a launch.
//
// Design: one launch per knight step, one block per MB of that step, the
// threads spanning the 16 (luma) or 8 (chroma, Cb and Cr side by side)
// lines of an edge.  Each thread filters its line of one edge in place in
// global memory, and the block meets at __syncthreads() after every edge,
// because a horizontal edge reads pixels the vertical edges of other lines
// wrote (neighbouring edges overlap by 3 pixels).  alpha, beta and tc0
// come from the ALPHA/BETA/TC0 tables of x264_tpu/ops/reference/deblock.py,
// uploaded once; qp_av = (qp_c + qp_neighbour + 1) >> 1 with the left MB
// for vertical edge 0 and the top MB for horizontal edge 0.  Frame-border
// edges (left edge 0 of column 0, top edge 0 of row 0) are never filtered.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Tables {
  const int* alpha;   // (52,)
  const int* beta;    // (52,)
  const int* tc0;     // (52, 3)
  int off_a, off_b;
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// One luma line across an edge: q0 at p[0], p0 at p[-s], s = tap stride.
__device__ void filter_luma_line(uint8_t* p, int s, int bs, int qp_av,
                                 const Tables& tb) {
  const int ia = clip3(0, 51, qp_av + tb.off_a);
  const int ib = clip3(0, 51, qp_av + tb.off_b);
  const int alpha = tb.alpha[ia], beta = tb.beta[ib];
  const int p0 = p[-s], p1 = p[-2 * s], p2 = p[-3 * s];
  const int q0 = p[0], q1 = p[s], q2 = p[2 * s];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta
        && iabs(q1 - q0) < beta))
    return;
  const bool ap = iabs(p2 - p0) < beta;
  const bool aq = iabs(q2 - q0) < beta;
  if (bs < 4) {
    const int tc0 = tb.tc0[3 * ia + clip3(1, 3, bs) - 1];
    const int tc = tc0 + ap + aq;
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

// One chroma line across an edge: only p0 and q0 change.
__device__ void filter_chroma_line(uint8_t* p, int s, int bs, int qp_av,
                                   const Tables& tb) {
  const int ia = clip3(0, 51, qp_av + tb.off_a);
  const int ib = clip3(0, 51, qp_av + tb.off_b);
  const int alpha = tb.alpha[ia], beta = tb.beta[ib];
  const int p0 = p[-s], p1 = p[-2 * s];
  const int q0 = p[0], q1 = p[s];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta
        && iabs(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tb.tc0[3 * ia + clip3(1, 3, bs) - 1] + 1;
    const int delta =
        clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    p[-s] = (uint8_t)clip3(0, 255, p0 + delta);
    p[0] = (uint8_t)clip3(0, 255, q0 - delta);
  } else {
    p[-s] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    p[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

// Block = one MB of knight step t; thread = one line (0..15).
__global__ void __launch_bounds__(16)
deblock_luma_kernel(uint8_t* __restrict__ y, const int* __restrict__ bs_v,
                    const int* __restrict__ bs_h, const int* __restrict__ qp,
                    Tables tb, int mbw, int t, int ymin) {
  const int mby = ymin + blockIdx.x, mbx = t - 2 * mby;
  const int mb = mby * mbw + mbx, i = threadIdx.x;
  const int w = 16 * mbw, gw = 4 * mbw;
  const int qp_c = qp[mb];
  for (int e = 0; e < 4; ++e) {
    if (e > 0 || mbx > 0) {
      const int bs = bs_v[(4 * mby + (i >> 2)) * gw + 4 * mbx + e];
      if (bs > 0) {
        const int qp_n = e == 0 ? qp[mb - 1] : qp_c;
        filter_luma_line(y + (size_t)(16 * mby + i) * w + 16 * mbx + 4 * e,
                         1, bs, (qp_c + qp_n + 1) >> 1, tb);
      }
    }
    __syncthreads();
  }
  for (int e = 0; e < 4; ++e) {
    if (e > 0 || mby > 0) {
      const int bs = bs_h[(4 * mby + e) * gw + 4 * mbx + (i >> 2)];
      if (bs > 0) {
        const int qp_n = e == 0 ? qp[mb - mbw] : qp_c;
        filter_luma_line(y + (size_t)(16 * mby + 4 * e) * w + 16 * mbx + i,
                         w, bs, (qp_c + qp_n + 1) >> 1, tb);
      }
    }
    __syncthreads();
  }
}

// Block = one MB of knight step t; threads 0-7 filter Cb lines, 8-15 Cr.
__global__ void __launch_bounds__(16)
deblock_chroma_kernel(uint8_t* __restrict__ u, uint8_t* __restrict__ v,
                      const int* __restrict__ bs_v,
                      const int* __restrict__ bs_h,
                      const int* __restrict__ qpc, Tables tb, int mbw, int t,
                      int ymin) {
  const int mby = ymin + blockIdx.x, mbx = t - 2 * mby;
  const int mb = mby * mbw + mbx, i = threadIdx.x & 7;
  uint8_t* c = threadIdx.x < 8 ? u : v;
  const int w = 8 * mbw, gw = 4 * mbw;
  const int qp_c = qpc[mb];
  for (int e = 0; e < 4; e += 2) {
    if (e > 0 || mbx > 0) {
      const int bs = bs_v[(4 * mby + (i >> 1)) * gw + 4 * mbx + e];
      if (bs > 0) {
        const int qp_n = e == 0 ? qpc[mb - 1] : qp_c;
        filter_chroma_line(c + (size_t)(8 * mby + i) * w + 8 * mbx + 2 * e,
                           1, bs, (qp_c + qp_n + 1) >> 1, tb);
      }
    }
    __syncthreads();
  }
  for (int e = 0; e < 4; e += 2) {
    if (e > 0 || mby > 0) {
      const int bs = bs_h[(4 * mby + e) * gw + 4 * mbx + (i >> 1)];
      if (bs > 0) {
        const int qp_n = e == 0 ? qpc[mb - mbw] : qp_c;
        filter_chroma_line(c + (size_t)(8 * mby + 2 * e) * w + 8 * mbx + i,
                           w, bs, (qp_c + qp_n + 1) >> 1, tb);
      }
    }
    __syncthreads();
  }
}

// MB rows [ymin, ymax] of knight step t = mbx + 2*mby.
inline int step_rows(int t, int mbw, int mbh, int* ymin) {
  const int lo = t - (mbw - 1) > 0 ? (t - (mbw - 1) + 1) / 2 : 0;
  const int hi = t / 2 < mbh - 1 ? t / 2 : mbh - 1;
  *ymin = lo;
  return hi - lo + 1;
}

}  // namespace

extern "C" int deblock_luma_launch(void* y, const void* bs_v,
                                   const void* bs_h, const void* qp,
                                   const void* alpha, const void* beta,
                                   const void* tc0, int mbw, int mbh,
                                   int off_a, int off_b, void* stream) {
  const Tables tb{(const int*)alpha, (const int*)beta, (const int*)tc0,
                  off_a, off_b};
  for (int t = 0; t < mbw + 2 * mbh - 2; ++t) {
    int ymin;
    const int count = step_rows(t, mbw, mbh, &ymin);
    if (count <= 0) continue;   // a one-MB-wide frame has empty steps
    deblock_luma_kernel<<<count, 16, 0, (cudaStream_t)stream>>>(
        (uint8_t*)y, (const int*)bs_v, (const int*)bs_h, (const int*)qp, tb,
        mbw, t, ymin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int deblock_chroma_launch(void* u, void* v, const void* bs_v,
                                     const void* bs_h, const void* qpc,
                                     const void* alpha, const void* beta,
                                     const void* tc0, int mbw, int mbh,
                                     int off_a, int off_b, void* stream) {
  const Tables tb{(const int*)alpha, (const int*)beta, (const int*)tc0,
                  off_a, off_b};
  for (int t = 0; t < mbw + 2 * mbh - 2; ++t) {
    int ymin;
    const int count = step_rows(t, mbw, mbh, &ymin);
    if (count <= 0) continue;
    deblock_chroma_kernel<<<count, 16, 0, (cudaStream_t)stream>>>(
        (uint8_t*)u, (uint8_t*)v, (const int*)bs_v, (const int*)bs_h,
        (const int*)qpc, tb, mbw, t, ymin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* x264tpu_cuda_error(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
