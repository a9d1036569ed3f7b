// Per-MB bit packing of CAVLC token slots for Hopper (sm_90a).
//
// Replaces: x264_tpu/ops/device/bitpack.py::pack_tokens, which the
// reference runs as XLA (a lax.scan over the S token slots of every MB,
// each step a masked OR into all n_words words).  Its plain twin is
// x264_tpu_torch/kernels/bitpack.py::pack_tokens_plain.
//
// Contract: vals/lens (N, S) int32, a token of lens[k] bits (0 = none,
// at most 30) whose value fits those bits; tokens are appended in slot
// order to a big-endian bitstring per MB (bit 0 is the MSB of word 0).
// Out: words (N, n_words) (uint32 bit patterns in int32) and nbits (N,),
// the MB's whole length.  Bits past 32 * n_words are dropped as the scan
// drops them (a token's part lands only on a word index below n_words),
// so an overflowing MB's words and nbits equal the reference's too.
//
// Bound on the H100: the bytes (vals and lens read once, 8 bytes a slot;
// words and nbits written once): at 1080p, 8160 MBs x 981 slots, about
// 66 MB, 0.020 ms at 3.35 TB/s.  Design: a warp per MB.  Lane i takes
// slots i, i + 32, ..., so each row is read with coalesced loads; a warp
// scan of the lengths, with the running bit count carried from one round
// to the next, gives each token its bit position.  Tokens OR their one
// or two parts into the warp's word buffer in shared memory (atomicOr:
// the bit ranges are disjoint, so the order does not matter), and the
// warp then writes the words out with coalesced stores.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;               // MBs per CTA
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
bitpack_kernel(const int* __restrict__ vals, const int* __restrict__ lens,
               int* __restrict__ words, int* __restrict__ nbits, int n,
               int s, int n_words) {
  extern __shared__ uint32_t sw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mb = blockIdx.x * kWarps + warp;
  if (mb >= n) return;                  // a whole warp; no CTA barrier
  uint32_t* buf = sw + warp * n_words;
  for (int j = lane; j < n_words; j += 32) buf[j] = 0u;
  __syncwarp();

  const int* vrow = vals + (size_t)mb * s;
  const int* lrow = lens + (size_t)mb * s;
  const uint32_t cap = (uint32_t)n_words;
  int carry = 0;                        // bits of the earlier rounds
  for (int base = 0; base < s; base += 32) {
    const int k = base + lane;
    int ln = 0;
    uint32_t val = 0u;
    if (k < s) {
      ln = __ldg(lrow + k);
      val = (uint32_t)__ldg(vrow + k);
    }
    const int l = ln > 0 ? ln : 0;
    int incl = l;                       // inclusive scan of the lengths
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (l > 0) {
      const uint32_t pos = (uint32_t)(carry + incl - l);
      const uint32_t sh = pos & 31u;
      const uint32_t w0 = pos >> 5;
      const uint32_t lu = (uint32_t)l;
      if (sh + lu <= 32u) {
        if (w0 < cap) atomicOr(buf + w0, val << (32u - sh - lu));
      } else {
        if (w0 < cap) atomicOr(buf + w0, val >> (sh + lu - 32u));
        if (w0 + 1u < cap) atomicOr(buf + w0 + 1u, val << (64u - sh - lu));
      }
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  int* out = words + (size_t)mb * n_words;
  for (int j = lane; j < n_words; j += 32) out[j] = (int)buf[j];
  if (lane == 0) nbits[mb] = carry;
}

}  // namespace

// Shared memory per CTA: kWarps * n_words words, so n_words up to 3072
// fits the 48 KB a launch gets without an opt-in.
extern "C" int bitpack_max_words() { return (48 * 1024) / (4 * kWarps); }

extern "C" int bitpack_launch(const void* vals, const void* lens,
                              void* words, void* nbits, int n, int s,
                              int n_words, void* stream) {
  if (n_words < 1 || n_words > bitpack_max_words() || s < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kWarps - 1) / kWarps;
  bitpack_kernel<<<grid, kWarps * 32, kWarps * n_words * sizeof(uint32_t),
                   (cudaStream_t)stream>>>(
      (const int*)vals, (const int*)lens, (int*)words, (int*)nbits, n, s,
      n_words);
  return (int)cudaGetLastError();
}
