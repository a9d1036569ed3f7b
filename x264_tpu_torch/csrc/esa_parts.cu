// Exhaustive fullpel partition search (ESA, nine units) for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/me_parts_pallas.py::full_search_parts_pallas
// (the Mosaic kernel body _phase_body), whose contract is
// x264_tpu/ops/device/me_parts.py::full_search_parts_xla: for every MB and
// every (dx, dy) in [-r, r]^2, the four 8x8 quadrant SADs of the source MB
// against ref_pad at (PAD+16mby+dy, PAD+16mbx+dx) give nine unit costs —
// quadrants q0..q3 (q = 2*qy + qx), 16x8 halves h = (q0+q1, q2+q3), 8x16
// halves v = (q0+q2, q1+q3) and the 16x16 block f = q0+q1+q2+q3 — each plus
// the same bias lam * (bits[4dx+4r] + bits[4dy+4r]), added once per unit.
// Each unit keeps its least cost, ties going to the first candidate in
// (dy, dx) raster order (the reference loop's strict-< updates).
//
// What bounds it on the H100: integer throughput, as for esa16.cu — the
// same 256 absolute differences per candidate (2.3 G per 1080p frame at
// r = 16), plus nine running minima per candidate instead of one; the
// bytes moved are ~19 MB of windows per frame.
//
// Design (esa16.cu's, with nine argmins): one block per MB stages its
// (16+2r)^2 reference window and its source MB in shared memory; threads
// stride over the candidates.  A candidate's quadrant SAD is 8 rows x 2
// words of __vsadu4 on __byte_perm-aligned words.  Each thread keeps nine
// 64-bit keys (cost << 32) | candidate, whose least value is the raster-
// first least cost; the keys are reduced across the block with warp
// shuffles, then shared memory.  The 64-bit key has no range cap (the
// Pallas kernel's int32 key limited r to 24); the limit is the padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 9;

__device__ __forceinline__ unsigned long long kmin(unsigned long long a,
                                                   unsigned long long b) {
  return a < b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
esa_parts_kernel(const uint8_t* __restrict__ src,
                 const uint8_t* __restrict__ ref,
                 const int* __restrict__ bits, int* __restrict__ cost_q,
                 int* __restrict__ mv_q, int* __restrict__ cost_h,
                 int* __restrict__ mv_h, int* __restrict__ cost_v,
                 int* __restrict__ mv_v, int* __restrict__ cost_f,
                 int* __restrict__ mv_f, int mbw, int r, int lam, int pad) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long s_red[kUnits][kWarps];
  const int span = 2 * r + 1;
  const int win = 16 + 2 * r;
  // words per window row: the shifted read of a candidate's row touches
  // one word past its 16 bytes
  const int stride_w = (win + 3) / 4 + 1;
  uint32_t* s_src = smem;          // 16 rows x 4 words
  uint32_t* s_win = smem + 64;     // win rows x stride_w words
  const int mb = blockIdx.x;
  const int mby = mb / mbw, mbx = mb - mby * mbw;
  const int w = 16 * mbw;
  const int wp = w + 2 * pad;

  for (int i = threadIdx.x; i < 64; i += blockDim.x) {
    const uint8_t* p = src + (size_t)(16 * mby + (i >> 2)) * w
                       + 16 * mbx + 4 * (i & 3);
    s_src[i] = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
               | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  }
  uint8_t* s_win_b = reinterpret_cast<uint8_t*>(s_win);
  const int row_b = 4 * stride_w;
  const uint8_t* ref0 = ref + (size_t)(pad + 16 * mby - r) * wp
                        + pad + 16 * mbx - r;
  for (int i = threadIdx.x; i < win * row_b; i += blockDim.x) {
    const int row = i / row_b, col = i - row * row_b;
    s_win_b[i] = col < win ? ref0[(size_t)row * wp + col] : 0;
  }
  __syncthreads();

  unsigned long long best[kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) best[k] = ~0ull;
  const int ncand = span * span;
  for (int c = threadIdx.x; c < ncand; c += blockDim.x) {
    const int dyi = c / span, dxi = c - dyi * span;
    const unsigned sel = 0x3210u + 0x1111u * (unsigned)(dxi & 3);
    const uint32_t* rw = s_win + dyi * stride_w + (dxi >> 2);
    unsigned q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 4
      for (int j = 0; j < 8; ++j) {
        const uint32_t a0 = rw[0], a1 = rw[1], a2 = rw[2], a3 = rw[3],
                       a4 = rw[4];
        const uint32_t* sw = s_src + 4 * (8 * half + j);
        q[2 * half] += __vsadu4(sw[0], __byte_perm(a0, a1, sel))
                       + __vsadu4(sw[1], __byte_perm(a1, a2, sel));
        q[2 * half + 1] += __vsadu4(sw[2], __byte_perm(a2, a3, sel))
                           + __vsadu4(sw[3], __byte_perm(a3, a4, sel));
        rw += stride_w;
      }
    }
    // bits index 4*d + 4r for d = idx - r, i.e. 4*idx
    const unsigned bias = (unsigned)(lam * (bits[4 * dxi] + bits[4 * dyi]));
    const unsigned cost[kUnits] = {
        q[0] + bias,        q[1] + bias,        q[2] + bias,
        q[3] + bias,        q[0] + q[1] + bias, q[2] + q[3] + bias,
        q[0] + q[2] + bias, q[1] + q[3] + bias,
        q[0] + q[1] + q[2] + q[3] + bias};
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
      best[k] = kmin(best[k],
                     ((unsigned long long)cost[k] << 32) | (unsigned)c);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    unsigned long long b = best[k];
    for (int off = 16; off > 0; off >>= 1)
      b = kmin(b, __shfl_down_sync(0xffffffffu, b, off));
    if (lane == 0) s_red[k][warp] = b;
  }
  __syncthreads();
  if (threadIdx.x < kUnits) {
    const int k = threadIdx.x;
    unsigned long long b = s_red[k][0];
    for (int i = 1; i < kWarps; ++i) b = kmin(b, s_red[k][i]);
    const int cand = (int)(b & 0xffffffffu);
    const int cdy = cand / span, cdx = cand - cdy * span;
    const int cost = (int)(b >> 32);
    int* c_out;
    int* m_out;
    if (k < 4) {
      c_out = cost_q + 4 * mb + k;
      m_out = mv_q + 2 * (4 * mb + k);
    } else if (k < 6) {
      c_out = cost_h + 2 * mb + (k - 4);
      m_out = mv_h + 2 * (2 * mb + (k - 4));
    } else if (k < 8) {
      c_out = cost_v + 2 * mb + (k - 6);
      m_out = mv_v + 2 * (2 * mb + (k - 6));
    } else {
      c_out = cost_f + mb;
      m_out = mv_f + 2 * mb;
    }
    *c_out = cost;
    m_out[0] = 4 * (cdx - r);
    m_out[1] = 4 * (cdy - r);
  }
}

}  // namespace

extern "C" int esa_parts_launch(const void* src, const void* ref,
                                const void* bits, void* cost_q, void* mv_q,
                                void* cost_h, void* mv_h, void* cost_v,
                                void* mv_v, void* cost_f, void* mv_f,
                                int mbw, int mbh, int r, int lam, int pad,
                                void* stream) {
  const int win = 16 + 2 * r;
  const int stride_w = (win + 3) / 4 + 1;
  const size_t smem = (64 + (size_t)win * stride_w) * sizeof(uint32_t);
  esa_parts_kernel<<<mbw * mbh, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)ref, (const int*)bits,
      (int*)cost_q, (int*)mv_q, (int*)cost_h, (int*)mv_h, (int*)cost_v,
      (int*)mv_v, (int*)cost_f, (int*)mv_f, mbw, r, lam, pad);
  return (int)cudaGetLastError();
}
