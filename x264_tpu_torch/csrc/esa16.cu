// Exhaustive fullpel 16x16 motion search (ESA) for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/me_pallas.py::full_search_pallas (the
// Mosaic kernel body _phase_body), whose contract is
// x264_tpu/ops/device/me.py::_full_search_xla: for every MB and every
// (dx, dy) in [-r, r]^2, cost = SAD(src MB, ref_pad at (PAD+16mby+dy,
// PAD+16mbx+dx)) + lam * (bits[4dx+4r] + bits[4dy+4r]); the winner is the
// least cost, ties going to the first candidate in (dy, dx) raster order.
//
// What bounds it on the H100: integer throughput.  At 1080p and r = 16
// there are 8160 MBs x 1089 candidates x 256 absolute differences
// (2.3 G), while the bytes moved are small (one 48x48 reference window and
// one 16x16 source block per MB, ~19 MB per frame against 3.35 TB/s).
//
// Design: one block per MB stages its (16+2r)^2 reference window and its
// source MB in shared memory, so every candidate reads shared memory only.
// Threads stride over the candidates; a candidate's row of 16 pixels is
// four byte-packed words, formed from five aligned shared-memory words
// with __byte_perm, and reduced with __vsadu4 (four |a-b| per
// instruction).  The argmin is a block-wide minimum of the 64-bit key
// (cost << 32) | (dy_idx * span + dx_idx), whose least value is exactly
// the reference loop's strict-< first-in-raster winner; the 64-bit key
// also lifts the Pallas kernel's int32 key cap on the range.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
esa16_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ ref,
             const int* __restrict__ bits, int* __restrict__ mv_out,
             int* __restrict__ cost_out, int mbw, int r, int lam, int pad) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long s_red[kThreads / 32];
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

  unsigned long long best = ~0ull;
  const int ncand = span * span;
  for (int c = threadIdx.x; c < ncand; c += blockDim.x) {
    const int dyi = c / span, dxi = c - dyi * span;
    const unsigned sel = 0x3210u + 0x1111u * (unsigned)(dxi & 3);
    const uint32_t* rw = s_win + dyi * stride_w + (dxi >> 2);
    unsigned sad = 0;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const uint32_t a0 = rw[0], a1 = rw[1], a2 = rw[2], a3 = rw[3],
                     a4 = rw[4];
      const uint32_t* sw = s_src + 4 * j;
      sad += __vsadu4(sw[0], __byte_perm(a0, a1, sel));
      sad += __vsadu4(sw[1], __byte_perm(a1, a2, sel));
      sad += __vsadu4(sw[2], __byte_perm(a2, a3, sel));
      sad += __vsadu4(sw[3], __byte_perm(a3, a4, sel));
      rw += stride_w;
    }
    // bits index 4*d + 4r for d = idx - r, i.e. 4*idx
    const int cost = (int)sad + lam * (bits[4 * dxi] + bits[4 * dyi]);
    const unsigned long long key =
        ((unsigned long long)(unsigned)cost << 32) | (unsigned)c;
    best = key < best ? key : best;
  }

  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = o < best ? o : best;
  }
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k)
      best = s_red[k] < best ? s_red[k] : best;
    const int cand = (int)(best & 0xffffffffu);
    const int dyi = cand / span, dxi = cand - dyi * span;
    mv_out[2 * mb] = 4 * (dxi - r);
    mv_out[2 * mb + 1] = 4 * (dyi - r);
    cost_out[mb] = (int)(best >> 32);
  }
}

}  // namespace

extern "C" int esa16_launch(const void* src, const void* ref,
                            const void* bits, void* mv, void* cost, int mbw,
                            int mbh, int r, int lam, int pad,
                            void* stream) {
  const int win = 16 + 2 * r;
  const int stride_w = (win + 3) / 4 + 1;
  const size_t smem = (64 + (size_t)win * stride_w) * sizeof(uint32_t);
  esa16_kernel<<<mbw * mbh, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)ref, (const int*)bits, (int*)mv,
      (int*)cost, mbw, r, lam, pad);
  return (int)cudaGetLastError();
}
