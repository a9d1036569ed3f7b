// CAVLC residual coding for Hopper (sm_90a): the (value, length) slot grid
// of every MB of a frame, straight from the frame cores' fields.
//
// Replaces: x264_tpu/ops/device/cavlc.py::residual_slots, that is its
// block_inputs (the coded-order gather, the I16 shift, the chroma pads,
// blen, nC from the neighbours' counts and the cbp gate) and code_blocks
// (one-hot matmuls for the reversal and the compaction of the nonzero
// levels, then the 16 level codes and 15 run_befores unrolled over the
// batch), which the reference runs as XLA (no Pallas kernel).  Its plain
// twin is x264_tpu_torch/ops/cavlc.py::block_inputs followed by
// code_blocks_plain.
//
// Contract (all int32, contiguous, 16-byte aligned): luma_dc (N, 16) and
// luma_ac (N, 16, 16) zigzag levels, luma_ac by raster 4x4 block;
// luma_nnz (N, 16) raster; chroma_dc (N, 2, 4); chroma_ac (N, 2, 4, 16);
// chroma_nnz (N, 2, 4); cbp_luma, cbp_chroma (N,); is_i16 (N,) bool (one
// byte); N = mbw * mbh in raster order.  Out: vals and lens (N, 27 * 36)
// in emission order [luma DC | 16 luma AC in coded order | 2 chroma DC |
// 8 chroma AC], 36 slots a block: [0] coeff_token, [1:4] the trailing
// ones' signs, [4:20] level codes (prefix and suffix in one token), [20]
// total_zeros, [21:36] run_before.  A block whose gate is off keeps its
// values and gets every length 0, as the reference masks uncoded blocks.
// tables: the code tables as val | len << 16 words, padded to kTableWords
// (kernels/cavlc.py::tables_on).
//
// Bound on the H100: the bytes.  An MB reads 1.8 KB of levels and counts
// and writes 7.6 KB of slots: at 1080p (8160 MBs) about 79 MB, 0.023 ms
// at 3.35 TB/s; the arithmetic is a few hundred integer operations a
// block.  Design: a warp an MB, a lane a block (27 of 32), 4 MBs a CTA
// (31 KB of shared memory: 7 CTAs, 28 warps an SM).  The CTA brings the
// 821-word table (once per 108 blocks) and each warp
// its MB's levels into shared memory with 16-byte asynchronous copies
// (rows padded to 20 words, so the lanes' reads of 16 rows hit at most
// two ways of a bank), and computes the lanes' nC from the neighbours'
// counts while the copies fly.  A lane's walk over its block (reversal,
// compaction, trailing ones, the suffix-length chain, the zero runs) is
// serial over at most 16 levels: it builds a 16-bit mask of the nonzero
// levels from five 16-byte reads of its row, visits them in reverse
// zigzag order through the mask, reads them from shared memory and
// writes its 36 slots into the warp's slot rows there (the lengths, at
// most 30, as bytes); the warp then stores the MB's 972 values and 972
// lengths with 16-byte coalesced streaming writes (the packer reads them
// once, next).  The I16 shift is an offset of the lane's row pointer, the pads
// are never read (a block reads only its first blen levels).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMbsPerCta = 4;
constexpr int kThreads = 32 * kMbsPerCta;
constexpr int kBlocks = 27;
constexpr int kSlots = 36;
constexpr int kMbSlots = kBlocks * kSlots;  // 972
constexpr int kRow = 20;                    // a staged 16-level row
// offsets in the table block: coeff_token (6, 17, 4), total_zeros (15,
// 16), chroma DC 2x2 (3, 4) and 2x4 (7, 8), run_before (7, 15)
constexpr int kCT = 0;
constexpr int kTZ = kCT + 6 * 17 * 4;
constexpr int kTZ2 = kTZ + 15 * 16;
constexpr int kTZ24 = kTZ2 + 3 * 4;
constexpr int kRB = kTZ24 + 7 * 8;
constexpr int kTableLen = kRB + 7 * 15;
constexpr int kTableWords = (kTableLen + 3) / 4 * 4;
// one MB's staged levels: luma DC, 16 luma AC rows, chroma DC, 8 chroma
// AC rows (words)
constexpr int kLvDc = 0;
constexpr int kLvAc = 16;
constexpr int kLvCdc = kLvAc + 16 * kRow;
constexpr int kLvCac = kLvCdc + 8;
constexpr int kLvWords = kLvCac + 8 * kRow;  // 504
constexpr int kLenWords = (kMbSlots + 15) / 16 * 4;  // the lengths' bytes
constexpr int kWarpWords = kLvWords + kMbSlots + kLenWords;
constexpr int kSmemBytes = 4 * (kTableWords + kMbsPerCta * kWarpWords);

static_assert(kLvWords % 4 == 0 && kMbSlots % 4 == 0 &&
                  kLenWords % 4 == 0 && kTableWords % 4 == 0,
              "16-byte staging");
static_assert(kSmemBytes <= 48 * 1024, "no shared-memory opt-in");

#ifndef CUDA_SHIM
// The device primitives a CPU build of this file replaces (see
// tests/test_torch_kernel_layouts.py): the dynamic shared memory and the
// asynchronous 16-byte copy from global to shared memory.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char cavlc_smem[];
  return cavlc_smem;
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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
  const int* luma_dc;
  const int* luma_ac;
  const int* luma_nnz;
  const int* chroma_dc;
  const int* chroma_ac;
  const int* chroma_nnz;
  const int* cbp_luma;
  const int* cbp_chroma;
  const uint8_t* is_i16;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

__device__ __forceinline__ int high_bit(unsigned m) { return 31 - __clz(m); }

// nC (9.2.1) from the left and top neighbours on a count grid: both
// available -> their rounded mean, one -> its count, none -> 0.
__device__ __forceinline__ int nc_rule(bool has_l, int l, bool has_t, int t) {
  return has_l && has_t ? (l + t + 1) >> 1 : has_l ? l : has_t ? t : 0;
}

// luma grid (4 mbw x 4 mbh), raster 4x4 blocks inside each MB
__device__ __forceinline__ int luma_count(const int* nnz, int mbw, int gx,
                                          int gy) {
  return __ldg(nnz + ((gy >> 2) * mbw + (gx >> 2)) * 16 + (gy & 3) * 4 +
               (gx & 3));
}

// one chroma plane's grid (2 mbw x 2 mbh)
__device__ __forceinline__ int chroma_count(const int* nnz, int mbw, int p,
                                            int gx, int gy) {
  return __ldg(nnz + ((gy >> 1) * mbw + (gx >> 1)) * 8 + p * 4 +
               (gy & 1) * 2 + (gx & 1));
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
    v = (1 << 12) | (lcr > 0 ? lcr : 0);
    ln = 28;
  } else {
    v = (1 << 13) | (lcr - 4096 > 0 ? lcr - 4096 : 0);
    ln = 30;
  }
}

// One block: c its levels (the first bl read; c is a staged row, or one
// word past it), ov/ol its 36 slots in shared memory, zeroed; a block
// that is off writes no length.
__device__ void code_block(const int* c, int bl, int nc, bool on,
                           const int* tab, int* ov, uint8_t* ol) {
  // the nonzero zigzag positions < blen, from five 16-byte reads of the
  // row (its padding read, never used)
  const bool shift = ((uintptr_t)c & 15) != 0;
  const int4* r4 = (const int4*)(c - (shift ? 1 : 0));
  int a[20];
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int4 v = r4[q];
    a[4 * q] = v.x;
    a[4 * q + 1] = v.y;
    a[4 * q + 2] = v.z;
    a[4 * q + 3] = v.w;
  }
  unsigned mask = 0u;
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if (p < bl && (shift ? a[p + 1] : a[p]) != 0) mask |= 1u << p;
  const int total = __popc(mask);
  const int pos0 = mask ? high_bit(mask) : 0;

  int t1 = 0;                          // trailing ones: leading +-1, <= 3
  {
    unsigned m = mask;
    for (int k = 0; k < 3 && m; ++k) {
      const int p = high_bit(m);
      m &= ~(1u << p);
      if (c[p] != 1 && c[p] != -1) break;
      ++t1;
    }
  }

  const int t = nc == -1 ? 4 : nc == -2 ? 5 : nc < 2 ? 0 : nc < 4 ? 1
                                              : nc < 8 ? 2 : 3;
  const int ct = tab[kCT + (t * 17 + total) * 4 + t1];
  ov[0] = ct & 0xFFFF;
  if (on) ol[0] = ct >> 16;

  const int tz = pos0 + 1 - total;
  if (total > 0 && total < bl) {
    const int w = nc == -1 ? tab[kTZ2 + clampi(total - 1, 0, 2) * 4
                                 + clampi(tz, 0, 3)]
                : nc == -2 ? tab[kTZ24 + clampi(total - 1, 0, 6) * 8
                                 + clampi(tz, 0, 7)]
                           : tab[kTZ + clampi(total - 1, 0, 14) * 16
                                 + clampi(tz, 0, 15)];
    ov[20] = w & 0xFFFF;
    if (on) ol[20] = w >> 16;
  }

  // the nonzero levels in reverse zigzag order: signs of the trailing
  // ones, level codes with the suffix-length chain, zero runs
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  int zeros_left = total > 0 ? tz : 0;
  int prev = pos0;
  unsigned m = mask;
  for (int k = 0; k < total; ++k) {
    const int p = high_bit(m);
    m &= ~(1u << p);
    const int lvl = c[p];
    if (k < t1) {
      ov[1 + k] = lvl < 0 ? 1 : 0;
      if (on) ol[1 + k] = 1;
    } else {
      int lc = lvl > 0 ? 2 * lvl - 2 : -2 * lvl - 1;
      if (k == t1 && t1 < 3) lc -= 2;
      int v, ln;
      level_code(lc, sl, v, ln);
      ov[4 + k] = v;
      if (on) ol[4 + k] = ln;
      int sn = sl > 1 ? sl : 1;
      if ((lvl < 0 ? -lvl : lvl) > (3 << (sn - 1)) && sn < 6) ++sn;
      sl = sn;
    }
    if (k >= 1 && zeros_left > 0) {
      const int run = clampi(prev - p - 1, 0, 14);
      const int ri = clampi((zeros_left < 7 ? zeros_left : 7) - 1, 0, 6);
      const int w = tab[kRB + ri * 15 + run];
      ov[20 + k] = w & 0xFFFF;
      if (on) ol[20 + k] = w >> 16;
      zeros_left -= run;
    }
    prev = p;
  }
}

__global__ void __launch_bounds__(kThreads)
cavlc_mb_kernel(Fields f, const int* __restrict__ tables,
                int* __restrict__ vals, int* __restrict__ lens, int mbw,
                int n) {
  int* s_tab = (int*)smem_base();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kMbsPerCta + warp;
  int* s_lv = s_tab + kTableWords + warp * kWarpWords;
  int* s_val = s_lv + kLvWords;
  uint8_t* s_len = (uint8_t*)(s_val + kMbSlots);

  // the copies: the table (CTA), the MB's levels (its warp)
  for (int c = threadIdx.x; c < kTableWords / 4; c += kThreads)
    copy_async(s_tab + 4 * c, tables + 4 * c, 16);
  if (mb < n) {
    for (int c = lane; c < 102; c += 32) {
      const int* src;
      int* dst;
      if (c < 4) {                       // luma DC
        src = f.luma_dc + (size_t)mb * 16 + 4 * c;
        dst = s_lv + kLvDc + 4 * c;
      } else if (c < 68) {               // luma AC, raster rows
        const int r = (c - 4) >> 2, q = (c - 4) & 3;
        src = f.luma_ac + (size_t)mb * 256 + r * 16 + 4 * q;
        dst = s_lv + kLvAc + r * kRow + 4 * q;
      } else if (c < 70) {               // chroma DC
        src = f.chroma_dc + (size_t)mb * 8 + 4 * (c - 68);
        dst = s_lv + kLvCdc + 4 * (c - 68);
      } else {                           // chroma AC rows
        const int r = (c - 70) >> 2, q = (c - 70) & 3;
        src = f.chroma_ac + (size_t)mb * 128 + r * 16 + 4 * q;
        dst = s_lv + kLvCac + r * kRow + 4 * q;
      }
      copy_async(dst, src, 16);
    }
  }
  copy_async_commit();

  // while they fly: zero the slot rows, and each lane's block (levels
  // row, blen, nC, gate)
  if (mb < n) {
    int4* z = (int4*)s_val;
    for (int c = lane; c < (kMbSlots + kLenWords) / 4; c += 32)
      z[c] = make_int4(0, 0, 0, 0);
  }
  int row = 0, bl = 0, nc = 0;
  bool on = false;
  if (mb < n && lane < kBlocks) {
    const int mx = mb % mbw, my = mb / mbw;
    const bool i16 = f.is_i16[mb] != 0;
    if (lane <= 16) {                    // luma DC (block 0's nC), AC
      int x = 0, y = 0;
      if (lane == 0) {
        row = kLvDc;
        bl = 16;
        on = i16;
      } else {
        const int k = lane - 1, q = k >> 2, s = k & 3;
        x = (q & 1) * 2 + (s & 1);
        y = (q >> 1) * 2 + (s >> 1);
        row = kLvAc + (4 * y + x) * kRow + (i16 ? 1 : 0);
        bl = i16 ? 15 : 16;
        on = ((__ldg(f.cbp_luma + mb) >> q) & 1) != 0;
      }
      const int gx = 4 * mx + x, gy = 4 * my + y;
      nc = nc_rule(gx > 0, gx > 0 ? luma_count(f.luma_nnz, mbw, gx - 1, gy)
                                  : 0,
                   gy > 0, gy > 0 ? luma_count(f.luma_nnz, mbw, gx, gy - 1)
                                  : 0);
    } else if (lane <= 18) {             // chroma DC
      row = kLvCdc + 4 * (lane - 17);
      bl = 4;
      nc = -1;
      on = __ldg(f.cbp_chroma + mb) > 0;
    } else {                             // chroma AC
      const int j = lane - 19, p = j >> 2, b = j & 3;
      row = kLvCac + j * kRow + 1;
      bl = 15;
      const int gx = 2 * mx + (b & 1), gy = 2 * my + (b >> 1);
      nc = nc_rule(gx > 0, gx > 0 ? chroma_count(f.chroma_nnz, mbw, p,
                                                 gx - 1, gy)
                                  : 0,
                   gy > 0, gy > 0 ? chroma_count(f.chroma_nnz, mbw, p, gx,
                                                 gy - 1)
                                  : 0);
      on = __ldg(f.cbp_chroma + mb) == 2;
    }
  }
  copy_async_wait();
  __syncthreads();

  if (mb < n) {
    if (lane < kBlocks)
      code_block(s_lv + row, bl, nc, on, s_tab, s_val + lane * kSlots,
                 s_len + lane * kSlots);
    __syncwarp();
    int4* vo = (int4*)(vals + (size_t)mb * kMbSlots);
    int4* lo = (int4*)(lens + (size_t)mb * kMbSlots);
    const int4* sv = (const int4*)s_val;
    const uint32_t* sl = (const uint32_t*)s_len;
    for (int c = lane; c < kMbSlots / 4; c += 32) {
      const uint32_t b = sl[c];          // streaming: read once, later
      __stcs(vo + c, sv[c]);
      __stcs(lo + c,
             make_int4(b & 255, (b >> 8) & 255, (b >> 16) & 255, b >> 24));
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int cavlc_table_len() { return kTableLen; }

extern "C" int cavlc_smem_bytes() { return kSmemBytes; }

extern "C" int cavlc_mb_launch(const void* luma_dc, const void* luma_ac,
                               const void* luma_nnz, const void* chroma_dc,
                               const void* chroma_ac, const void* chroma_nnz,
                               const void* cbp_luma, const void* cbp_chroma,
                               const void* is_i16, const void* tables,
                               void* vals, void* lens, int mbw, int mbh,
                               void* stream) {
  if (mbw < 1 || mbh < 1 || !aligned16(luma_dc) || !aligned16(luma_ac) ||
      !aligned16(chroma_dc) || !aligned16(chroma_ac) ||
      !aligned16(tables) || !aligned16(vals) || !aligned16(lens))
    return (int)cudaErrorInvalidValue;
  const int n = mbw * mbh;
  Fields f{(const int*)luma_dc,    (const int*)luma_ac,
           (const int*)luma_nnz,   (const int*)chroma_dc,
           (const int*)chroma_ac,  (const int*)chroma_nnz,
           (const int*)cbp_luma,   (const int*)cbp_chroma,
           (const uint8_t*)is_i16};
  const int grid = (n + kMbsPerCta - 1) / kMbsPerCta;
  cavlc_mb_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      f, (const int*)tables, (int*)vals, (int*)lens, mbw, n);
  return (int)cudaGetLastError();
}
