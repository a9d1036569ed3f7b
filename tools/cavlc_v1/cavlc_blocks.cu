// CAVLC residual block coding for Hopper (sm_90a): the (value, length)
// codes of every 4x4, chroma-DC or AC block of a frame.
//
// Replaces: x264_tpu/ops/device/cavlc.py::code_blocks, which the reference
// runs as XLA (one-hot matmuls for the reversal and the compaction of the
// nonzero levels, then the 16 level codes and 15 run_befores unrolled over
// the whole batch).  Its plain twin, op for op, is
// x264_tpu_torch/ops/cavlc.py::code_blocks_plain.
//
// Contract: coefs (B, 16) int32 zigzag levels, left-aligned to the block's
// length blen (4, 15 or 16); nC (B,) the coeff_token context (-1 chroma DC
// 4:2:0, -2 chroma DC 4:2:2, else >= 0); gate (B,) uint8 or null: a block
// whose gate is 0 keeps its values and gets every length 0, as the
// reference masks uncoded blocks.  Out: vals and lens (B, 36) int32 in the
// reference's slot layout: [0] coeff_token, [1:4] the trailing ones' signs,
// [4:20] level codes (prefix and suffix in one token), [20] total_zeros,
// [21:36] run_before.  tables: the code tables as val | len << 16 words
// (kernels/cavlc.py::table_block, built from bitstream/tables.py).
//
// Bound on the H100: the bytes (64 in and 288 out per block, plus blen, nC
// and the gate): at 1080p, 8160 MBs x 27 blocks, about 79 MB, 0.024 ms at
// 3.35 TB/s; the arithmetic is a few hundred integer operations a block.
// Design: a thread per block; its walk (reversal, compaction, trailing
// ones, the suffix-length chain, the zero runs) is serial over at most 16
// levels, so it visits the nonzero levels in reverse zigzag order through
// a 16-bit mask (highest set bit first) and reads them from shared memory,
// with no per-thread arrays to spill.  A CTA stages its blocks' levels
// through shared memory with coalesced loads, fills its 36 slots per block
// in shared memory (rows padded to an odd stride, so the threads of a warp
// write distinct banks) and stores them with coalesced writes.  The tables
// (821 words) are copied to shared memory per CTA: their indices differ
// from thread to thread, which constant memory would serialise.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;           // blocks per CTA
constexpr int kSlots = 36;
constexpr int kInStride = 17;
constexpr int kOutStride = 37;
// offsets in the table block: coeff_token (6, 17, 4), total_zeros (15,
// 16), chroma DC 2x2 (3, 4) and 2x4 (7, 8), run_before (7, 15)
constexpr int kCT = 0;
constexpr int kTZ = kCT + 6 * 17 * 4;
constexpr int kTZ2 = kTZ + 15 * 16;
constexpr int kTZ24 = kTZ2 + 3 * 4;
constexpr int kRB = kTZ24 + 7 * 8;
constexpr int kTableLen = kRB + 7 * 15;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// The fused unary prefix + suffix code of level code lc at suffix length
// sl (cavlc.py::_level_codes; the branches are its where-chain).
__device__ __forceinline__ void level_code(int lc, int sl, int& v, int& ln) {
  const int prefix = lc >> (sl > 1 ? sl : 1);
  const int lcr = (sl == 0 ? lc - 15 : lc) - (15 << sl);
  if (sl == 0 && lc < 14) {
    v = 1;
    ln = lc + 1;
  } else if (sl == 0 && lc < 30) {
    v = 16 | (lc - 14);
    ln = 19;
  } else if (sl > 0 && prefix < 15) {
    v = (1 << sl) | (lc & ((1 << sl) - 1));
    ln = prefix + 1 + sl;
  } else if (lcr < 4096) {
    v = (1 << 12) | max(lcr, 0);
    ln = 28;
  } else {
    v = (1 << 13) | max(lcr - 4096, 0);
    ln = 30;
  }
}

// One block: c its levels in shared memory, ov/ol its 36 slots (zeroed).
__device__ void code_block(const int* c, int bl, int nc, bool on,
                           const int* tab, int* ov, int* ol) {
  unsigned mask = 0u;                  // nonzero zigzag positions < blen
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if (p < bl && c[p] != 0) mask |= 1u << p;
  const int total = __popc(mask);
  const int pos0 = mask ? 31 - __clz(mask) : 0;

  int t1 = 0;                          // trailing ones: leading +-1, <= 3
  {
    unsigned m = mask;
    for (int k = 0; k < 3 && m; ++k) {
      const int p = 31 - __clz(m);
      m &= ~(1u << p);
      if (c[p] != 1 && c[p] != -1) break;
      ++t1;
    }
  }

  const int t = nc == -1 ? 4 : nc == -2 ? 5 : nc < 2 ? 0 : nc < 4 ? 1
                                              : nc < 8 ? 2 : 3;
  const int ct = tab[kCT + (t * 17 + total) * 4 + t1];
  ov[0] = ct & 0xFFFF;
  ol[0] = ct >> 16;

  const int tz = pos0 + 1 - total;
  if (total > 0 && total < bl) {
    const int w = nc == -1 ? tab[kTZ2 + clampi(total - 1, 0, 2) * 4
                                 + clampi(tz, 0, 3)]
                : nc == -2 ? tab[kTZ24 + clampi(total - 1, 0, 6) * 8
                                 + clampi(tz, 0, 7)]
                           : tab[kTZ + clampi(total - 1, 0, 14) * 16
                                 + clampi(tz, 0, 15)];
    ov[20] = w & 0xFFFF;
    ol[20] = w >> 16;
  }

  // the nonzero levels in reverse zigzag order: signs of the trailing
  // ones, level codes with the suffix-length chain, zero runs
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  int zeros_left = total > 0 ? tz : 0;
  int prev = pos0;
  unsigned m = mask;
  for (int k = 0; k < total; ++k) {
    const int p = 31 - __clz(m);
    m &= ~(1u << p);
    const int lvl = c[p];
    if (k < t1) {
      ov[1 + k] = lvl < 0 ? 1 : 0;
      ol[1 + k] = 1;
    } else {
      int lc = lvl > 0 ? 2 * lvl - 2 : -2 * lvl - 1;
      if (k == t1 && t1 < 3) lc -= 2;
      int v, ln;
      level_code(lc, sl, v, ln);
      ov[4 + k] = v;
      ol[4 + k] = ln;
      int sn = max(sl, 1);
      if (abs(lvl) > (3 << (sn - 1)) && sn < 6) ++sn;
      sl = sn;
    }
    if (k >= 1 && zeros_left > 0) {
      const int run = clampi(prev - p - 1, 0, 14);
      const int ri = clampi(min(zeros_left, 7) - 1, 0, 6);
      const int w = tab[kRB + ri * 15 + run];
      ov[20 + k] = w & 0xFFFF;
      ol[20 + k] = w >> 16;
      zeros_left -= run;
    }
    prev = p;
  }
  if (!on)
    for (int k = 0; k < kSlots; ++k) ol[k] = 0;
}

__global__ void __launch_bounds__(kThreads)
cavlc_blocks_kernel(const int* __restrict__ coefs,
                    const int* __restrict__ blen,
                    const int* __restrict__ nC,
                    const uint8_t* __restrict__ gate,
                    const int* __restrict__ tables, int* __restrict__ vals,
                    int* __restrict__ lens, int nblocks) {
  __shared__ int s_tab[kTableLen];
  __shared__ int s_coef[kThreads * kInStride];
  __shared__ int s_val[kThreads * kOutStride];
  __shared__ int s_len[kThreads * kOutStride];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, nblocks - b0);

  for (int i = t; i < kTableLen; i += kThreads) s_tab[i] = __ldg(tables + i);
  const int* cin = coefs + (size_t)b0 * 16;
  for (int i = t; i < rows * 16; i += kThreads)
    s_coef[(i >> 4) * kInStride + (i & 15)] = __ldg(cin + i);
  int* ov = s_val + t * kOutStride;
  int* ol = s_len + t * kOutStride;
  for (int k = 0; k < kSlots; ++k) {
    ov[k] = 0;
    ol[k] = 0;
  }
  __syncthreads();

  if (t < rows) {
    const int b = b0 + t;
    code_block(s_coef + t * kInStride, __ldg(blen + b), __ldg(nC + b),
               gate == nullptr || gate[b] != 0, s_tab, ov, ol);
  }
  __syncthreads();

  int* vo = vals + (size_t)b0 * kSlots;
  int* lo = lens + (size_t)b0 * kSlots;
  for (int i = t; i < rows * kSlots; i += kThreads) {
    const int r = i / kSlots;
    const int k = i - r * kSlots;
    vo[i] = s_val[r * kOutStride + k];
    lo[i] = s_len[r * kOutStride + k];
  }
}

}  // namespace

extern "C" int cavlc_table_len() { return kTableLen; }

extern "C" int cavlc_blocks_launch(const void* coefs, const void* blen,
                                   const void* nC, const void* gate,
                                   const void* tables, void* vals, void* lens,
                                   int nblocks, void* stream) {
  if (nblocks < 0) return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return 0;
  const int grid = (nblocks + kThreads - 1) / kThreads;
  cavlc_blocks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)coefs, (const int*)blen, (const int*)nC,
      (const uint8_t*)gate, (const int*)tables, (int*)vals, (int*)lens,
      nblocks);
  return (int)cudaGetLastError();
}
