// Per-MB bit packing of CAVLC token slots, and the MBs' strings placed in
// the slice payload, for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/bitpack.py::pack_tokens, which the
// reference runs as XLA (a lax.scan over the S token slots of every MB,
// each step a masked OR into all n_words words), with its callers'
// concatenations (ops/device/cavlc.py's blob: the header and residual
// grids side by side, then words, nbits and the per-MB fields), and the
// host merge that follows it (bitstream/slice_assemble.py::
// merge_mb_strings: a TPU cannot scatter, so the reference packs per MB
// and merges on the host).  Plain twins: x264_tpu_torch/kernels/
// bitpack.py::pack_tokens_plain and place_plain.
//
// Contract of bitpack_launch: an MB's tokens are the h slots of its
// header row, then the r slots of its residual row (vals and lens int32,
// a token of lens bits, 0 = none, at most 30, its value fitting them),
// appended in that order to a big-endian bitstring (bit 0 is the MSB of
// word 0).  Out: the blob rows (N, n_words + 1 + nf): the first n_words
// words (uint32 bit patterns in int32), nbits (the MB's whole length),
// then the MB's nf fields; bits past 32 * n_words are dropped, as the
// scan drops them, so an MB that overflows keeps its first words and its
// true nbits.  Contract of bitplace_launch, run on such a blob after it:
// the payload (pay_words words), every MB's first min(ceil(nbits / 32),
// n_words) words placed at the MB's bit offset, the exclusive sum of the
// nbits before it (merge_mb_strings' placement), the other words zero;
// words past pay_words are dropped.
//
// Bound on the H100: the bytes.  Vals and lens read once (8 bytes a
// slot), the blob and the payload's used words written once: at a 1080p
// P8x8 frame (8160 MBs x 994 slots, 64 words) about 67 MB, 0.020 ms at
// 3.35 TB/s.  Packing: CTAs of 512 threads, 4 MBs a CTA, 128 threads an
// MB.  A group brings its MB's two rows into shared memory with
// asynchronous copies issued up front (16 bytes at a time for the
// residual row, whose rows are 16-byte aligned; the header row 4 bytes
// at a time, placed so that the residual row lands on a 16-byte
// boundary, the gap zero-length slots).  Each thread then takes 8
// consecutive slots (two 16-byte reads per array): its lengths' sum, a
// shuffle scan of the sums over each warp and the warp sums through
// shared memory give every token its bit position in two short dependent
// steps instead of one per 32 slots.  Tokens OR their one or two parts
// into the MB's words in shared memory (the bit ranges are disjoint, so
// the order does not matter) and the group writes the blob row.
// Placement, two launches in stream order after the packing, so no CTA
// ever waits on another: CTAs that each sum 256 MBs' nbits (a thread an
// MB: the nbits lie a row apart, so one CTA scanning them all is bound
// by its own loads), beside CTAs that zero the payload; then a warp an
// MB, whose CTA adds the sums of the blocks before it and the nbits
// before it in its own block, stores the MB's words at its offset, the
// words it alone covers with plain stores, the first and the last two,
// which it may share with its neighbours, with atomicOr.  (The placement
// was first fused into the packing launch, placer CTAs spinning on the
// packers' published sums: that counts on the packers being resident
// while the placers spin, which CUDA does not promise.)  No host
// synchronisation and fixed sizes, so a CUDA graph captures all three
// launches.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 128;                 // threads an MB
constexpr int kMbs = 4;                     // MBs a packer
constexpr int kThreads = kGroup * kMbs;
constexpr int kPer = 8;                     // consecutive slots a thread
constexpr int kRound = kGroup * kPer;       // an MB's slots a pass
constexpr int kMaxRounds = 4;
constexpr int kMaxWords = 3072;
constexpr int kMaxFields = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSumMbs = 256;                // MBs a sum of the placement
constexpr int kPlaceMbs = 8;                // a warp an MB
constexpr int kPlaceThreads = 32 * kPlaceMbs;
constexpr int kMaxMbs = 1 << 20;

#ifndef CUDA_SHIM
// The device primitives a CPU build of this file replaces (see
// tests/test_torch_kernel_layouts.py): the dynamic shared memory, and the
// asynchronous copy of 16 or 4 bytes (aligned so) from global to shared
// memory, its commit and its wait.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(16) unsigned char bitpack_smem[];
  return bitpack_smem;
}

__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
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

struct Grid {
  const int* hv;
  const int* hl;
  int h;
  const int* rv;
  const int* rl;
  int r;
};

struct Fields {
  const int* f[kMaxFields];  // (N,) each
  int nf;
};

__host__ __device__ inline int pad_of(int h) { return (4 - (h & 3)) & 3; }

__host__ __device__ inline int rounds_of(int h, int r) {
  const int s = pad_of(h) + h + r;
  return s > 0 ? (s + kRound - 1) / kRound : 1;
}

__host__ __device__ inline int word_cap(int n_words) {
  return (n_words + 3) & ~3;
}

// an MB's group: its lengths, values and words, and 8 words for the
// warp sums
__host__ __device__ inline int group_words(int h, int r, int n_words) {
  return 2 * rounds_of(h, r) * kRound + word_cap(n_words) + 8;
}

__host__ __device__ inline size_t smem_bytes(int h, int r, int n_words) {
  return 4 * (size_t)kMbs * group_words(h, r, n_words);
}

// 4 CTAs an SM (32 registers, a few spilled): 4-10% faster than 3 CTAs
// (40 registers, none spilled) at a 1080p frame and band
__global__ void __launch_bounds__(kThreads, 4)
bitpack_kernel(Grid g, Fields fl, int* __restrict__ blob, int n_words,
               int n) {
  const int t = threadIdx.x;
  const int grp = t / kGroup, gt = t % kGroup;
  const int gwarp = gt >> 5, lane = t & 31;
  const int rounds = rounds_of(g.h, g.r);
  const int span = rounds * kRound;
  int* s_len = (int*)smem_base() + grp * group_words(g.h, g.r, n_words);
  int* s_val = s_len + span;
  unsigned* s_words = (unsigned*)(s_val + span);
  int* s_misc = (int*)(s_words + word_cap(n_words));  // 8 words
  const int pad = pad_of(g.h);
  const int s_end = pad + g.h + g.r;
  const int stride = n_words + 1 + fl.nf;

  const int tile = blockIdx.x;
  const int mb = tile * kMbs + grp;
  const bool live = mb < n;

  // the copies, issued up front; meanwhile the gaps and the words zeroed
  if (live) {
    const int* hv = g.hv + (size_t)mb * g.h;
    const int* hl = g.hl + (size_t)mb * g.h;
    for (int i = gt; i < g.h; i += kGroup) {
      copy_async(s_len + pad + i, hl + i, 4);
      copy_async(s_val + pad + i, hv + i, 4);
    }
    const int* rv = g.rv + (size_t)mb * g.r;
    const int* rl = g.rl + (size_t)mb * g.r;
    const int base = pad + g.h;          // a multiple of 4
    for (int c = gt; c < g.r / 4; c += kGroup) {
      copy_async(s_len + base + 4 * c, rl + 4 * c, 16);
      copy_async(s_val + base + 4 * c, rv + 4 * c, 16);
    }
  }
  copy_async_commit();
  for (int i = gt; i < pad; i += kGroup) s_len[i] = 0;
  for (int i = (live ? s_end : 0) + gt; i < span; i += kGroup) s_len[i] = 0;
  for (int j = gt; j < n_words; j += kGroup) s_words[j] = 0u;
  copy_async_wait();
  __syncthreads();

  // bit positions: 8 consecutive slots a thread, scanned over the group
  unsigned carry = 0;                    // bits of the earlier rounds
  for (int k = 0; k < rounds; ++k) {
    const int s0 = k * kRound + gt * kPer;
    const int4 la = *(const int4*)(s_len + s0);
    const int4 lb = *(const int4*)(s_len + s0 + 4);
    const int4 va = *(const int4*)(s_val + s0);
    const int4 vb = *(const int4*)(s_val + s0 + 4);
    const int l[kPer] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
    const int v[kPer] = {va.x, va.y, va.z, va.w, vb.x, vb.y, vb.z, vb.w};
    int sum = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) sum += l[j] > 0 ? l[j] : 0;
    int incl = sum;                      // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_misc[gwarp] = incl;
    __syncthreads();
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < kGroup / 32; ++w) {
      const int ws = s_misc[w];
      before += w < gwarp ? ws : 0;
      all += ws;
    }
    unsigned pos = carry + (unsigned)(before + incl - sum);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (l[j] <= 0) continue;
      const unsigned lu = (unsigned)l[j], val = (unsigned)v[j];
      const unsigned sh = pos & 31u, w0 = pos >> 5;
      if (sh + lu <= 32u) {
        if (w0 < (unsigned)n_words)
          atomicOr(s_words + w0, val << (32u - sh - lu));
      } else {
        if (w0 < (unsigned)n_words)
          atomicOr(s_words + w0, val >> (sh + lu - 32u));
        if (w0 + 1u < (unsigned)n_words)
          atomicOr(s_words + w0 + 1u, val << (64u - sh - lu));
      }
      pos += lu;
    }
    carry += (unsigned)all;
    __syncthreads();                     // s_misc is read before reuse
  }
  const unsigned nbits = carry;          // 0 for a group past the frame

  // the blob rows
  if (live) {
    int* row = blob + (size_t)mb * stride;
    for (int j = gt; j < n_words; j += kGroup) row[j] = (int)s_words[j];
    if (gt == 0) row[n_words] = (int)nbits;
    if (gt < fl.nf) {                    // static indices: no stack copy
      const int* f = gt == 0 ? fl.f[0] : gt == 1 ? fl.f[1]
                   : gt == 2 ? fl.f[2] : fl.f[3];
      row[n_words + 1 + gt] = __ldg(f + mb);
    }
  }
}

// Sum of v over the 32 lanes of a warp (every lane gets it), in 64 bits
// exchanged as two 32-bit halves.
__device__ __forceinline__ unsigned long long warp_sum64(
    unsigned long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const unsigned lo = (unsigned)__shfl_xor_sync(kFull, (int)(unsigned)v, o);
    const unsigned hi =
        (unsigned)__shfl_xor_sync(kFull, (int)(unsigned)(v >> 32), o);
    v += ((unsigned long long)hi << 32) | lo;
  }
  return v;
}

__device__ __forceinline__ unsigned nbits_of(const int* blob, int stride,
                                             int n_words, int m) {
  return (unsigned)__ldg(blob + (size_t)m * stride + n_words);
}

// The placement's first launch.  CTA b < ceil(N / 256) sums the nbits of
// MBs [256 b, 256 b + 256) (column n_words of the blob's rows, a thread
// an MB) into sums[b]; the other CTAs zero the payload.
__global__ void __launch_bounds__(kSumMbs)
bitsum_kernel(const int* __restrict__ blob, int stride, int n_words, int n,
              unsigned* __restrict__ sums, unsigned* __restrict__ payload,
              long long pay_words) {
  const int t = threadIdx.x;
  const int blocks = (n + kSumMbs - 1) / kSumMbs;
  if ((int)blockIdx.x >= blocks) {
    const long long step = (long long)(gridDim.x - blocks) * kSumMbs;
    for (long long i = (long long)(blockIdx.x - blocks) * kSumMbs + t;
         i < pay_words; i += step)
      payload[i] = 0u;
    return;
  }
  unsigned* s_warp = (unsigned*)smem_base();          // 8 words
  const int m = blockIdx.x * kSumMbs + t;
  // 256 MBs of at most 4093 x 30 bits: under 2^32
  unsigned v = m < n ? nbits_of(blob, stride, n_words, m) : 0u;
#pragma unroll
  for (int o = 16; o; o >>= 1) v += (unsigned)__shfl_xor_sync(kFull, (int)v, o);
  if ((t & 31) == 0) s_warp[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    unsigned all = 0;
    for (int w = 0; w < kSumMbs / 32; ++w) all += s_warp[w];
    sums[blockIdx.x] = all;
  }
}

// The placement's second launch, after the first: a warp an MB, 8 MBs a
// CTA.  The CTA's first MB's offset is the sums of the whole blocks
// before it and the nbits of the MBs of its own block before it, a term
// or two a thread; the warp's MB adds those of the CTA's earlier MBs.
// The warp stores the MB's first min(ceil(nbits / 32), n_words) words
// shifted to its offset: word j of the run is the row's word j shifted
// right and the end of word j - 1 shifted left.  Only the first and the
// last two words may hold another MB's bits (the zeroed payload takes
// their OR).
__global__ void __launch_bounds__(kPlaceThreads)
bitplace_kernel(const int* __restrict__ blob, int stride, int n_words,
                int n, const unsigned* __restrict__ sums,
                unsigned* __restrict__ payload, long long pay_words) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned long long* s_part = (unsigned long long*)smem_base();  // 8
  unsigned* s_nb = (unsigned*)(s_part + kPlaceMbs);               // 8
  const int m0 = blockIdx.x * kPlaceMbs;
  const int blk = m0 / kSumMbs, first = blk * kSumMbs;
  unsigned long long part = 0;
  for (int i = t; i < blk; i += kPlaceThreads) part += __ldg(sums + i);
  for (int m = first + t; m < m0; m += kPlaceThreads)
    part += nbits_of(blob, stride, n_words, m);
  part = warp_sum64(part);
  const int mb = m0 + warp;
  const unsigned nb = mb < n ? nbits_of(blob, stride, n_words, mb) : 0u;
  if (lane == 0) {
    s_part[warp] = part;
    s_nb[warp] = nb;
  }
  __syncthreads();
  unsigned long long off = 0;
#pragma unroll
  for (int w = 0; w < kPlaceMbs; ++w)
    off += s_part[w] + (w < warp ? s_nb[w] : 0u);
  if (mb >= n) return;
  const unsigned words = (nb + 31) >> 5;
  const int used = words < (unsigned)n_words ? (int)words : n_words;
  const unsigned sh = (unsigned)(off & 31);
  const long long w0 = (long long)(off >> 5);
  const int* row = blob + (size_t)mb * stride;
  for (int j = lane; j <= used; j += 32) {
    const unsigned hi = j < used ? (unsigned)__ldg(row + j) >> sh : 0u;
    const unsigned lo =
        j > 0 && sh ? (unsigned)__ldg(row + j - 1) << (32u - sh) : 0u;
    const unsigned w = hi | lo;
    const long long at = w0 + j;
    if (w == 0u || at >= pay_words) continue;
    if (j == 0 || j >= used - 1)
      atomicOr(payload + at, w);
    else
      payload[at] = w;
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

extern "C" int bitpack_max_words() { return kMaxWords; }

extern "C" int bitpack_max_slots() { return kMaxRounds * kRound - 3; }

extern "C" int bitpack_max_fields() { return kMaxFields; }

extern "C" int bitpack_smem_bytes(int h, int r, int n_words) {
  return (int)smem_bytes(h, r, n_words);
}

extern "C" int bitpack_launch(const void* hv, const void* hl, int h,
                              const void* rv, const void* rl, int r,
                              const void* f0, const void* f1, const void* f2,
                              const void* f3, int nf, void* blob,
                              int n_words, int n, void* stream) {
  if (n < 0 || h < 0 || r < 0 || (r & 3) || nf < 0 || nf > kMaxFields ||
      n_words < 1 || n_words > kMaxWords || rounds_of(h, r) > kMaxRounds ||
      (r && !(aligned16(rv) && aligned16(rl))))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // the > 48 KB opt-in at the largest size, once per device (before any
  // graph capture: the wrapper's first call on a device is eager)
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(
        bitpack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(0, kMaxRounds * kRound - 3, kMaxWords));
    if (e != cudaSuccess) return (int)e;
    opted[dev] = true;
  }
  Grid g{(const int*)hv, (const int*)hl, h, (const int*)rv, (const int*)rl,
         r};
  Fields fl{{(const int*)f0, (const int*)f1, (const int*)f2,
             (const int*)f3}, nf};
  bitpack_kernel<<<(n + kMbs - 1) / kMbs, kThreads,
                   smem_bytes(h, r, n_words), (cudaStream_t)stream>>>(
      g, fl, (int*)blob, n_words, n);
  return (int)cudaGetLastError();
}

extern "C" int bitplace_max_mbs() { return kMaxMbs; }

extern "C" int bitplace_sum_mbs() { return kSumMbs; }

// The payload of a blob that bitpack_launch wrote (rows of stride words,
// nbits in column n_words): sums, ceil(n / bitplace_sum_mbs()) words of
// the caller's, takes the sums of 256 MBs' nbits; payload (pay_words
// words) needs no zeroing.
extern "C" int bitplace_launch(const void* blob, int stride, int n_words,
                               int n, void* sums, void* payload,
                               long long pay_words, void* stream) {
  if (n < 0 || n > kMaxMbs || n_words < 1 || n_words > kMaxWords ||
      stride < n_words + 1 || pay_words < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0 && pay_words == 0) return 0;
  const int blocks = (n + kSumMbs - 1) / kSumMbs;
  const long long zero_ctas = (pay_words + 16 * kSumMbs - 1) /
                              (16 * kSumMbs);
  bitsum_kernel<<<blocks + (int)(zero_ctas < 1024 ? zero_ctas : 1024),
                  kSumMbs, kSumMbs / 32 * sizeof(unsigned),
                  (cudaStream_t)stream>>>(
      (const int*)blob, stride, n_words, n, (unsigned*)sums,
      (unsigned*)payload, pay_words);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return (int)e;
  bitplace_kernel<<<(n + kPlaceMbs - 1) / kPlaceMbs, kPlaceThreads,
                    kPlaceMbs * (sizeof(unsigned long long) +
                                 sizeof(unsigned)),
                    (cudaStream_t)stream>>>(
      (const int*)blob, stride, n_words, n, (const unsigned*)sums,
      (unsigned*)payload, pay_words);
  return (int)cudaGetLastError();
}
