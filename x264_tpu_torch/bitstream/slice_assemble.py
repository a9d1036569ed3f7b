"""Host finalization of device-packed CAVLC slices: bit-merge the N
per-MB packed bitstrings (``kernels/bitpack.py``) into the slice payload.

Copied verbatim from x264_tpu/bitstream/slice_assemble.py.  Cost: one
np.bincount over ~N * (W+1) word contributions (disjoint bit ranges, so
per-byte sums equal OR).
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.bits import BitWriter


def merge_mb_strings(words: np.ndarray, nbits: np.ndarray):
    """words (N, W) uint32 big-endian bitstrings, nbits (N,).
    Returns (payload_words uint32 array, total_bits) — the concatenated
    bitstring of all MBs in order."""
    n, w_cap = words.shape
    nbits = nbits.astype(np.int64)
    offs = np.concatenate(([0], np.cumsum(nbits)))
    total = int(offs[-1])
    out_words = (total + 31) // 32 + 2

    sh = (offs[:-1] & 31).astype(np.uint64)
    w0 = (offs[:-1] >> 5).astype(np.int64)
    used = ((nbits + 31) >> 5).astype(np.int64)

    # each input word spreads across two output words when sh != 0
    wsrc = words.astype(np.uint64)
    j = np.arange(w_cap, dtype=np.int64)
    valid = j[None, :] < used[:, None]
    # contribution to output word (w0 + j): wsrc >> sh
    hi = (wsrc >> sh[:, None]) * valid
    # contribution to output word (w0 + j + 1): wsrc << (32 - sh)
    lo = np.where(sh[:, None] > 0,
                  (wsrc << (np.uint64(32) - sh[:, None])) & np.uint64(0xFFFFFFFF),
                  0) * valid
    pos_hi = (w0[:, None] + j[None, :]).reshape(-1)
    pos_lo = pos_hi + 1
    pos = np.concatenate([pos_hi, pos_lo])
    con = np.concatenate([hi.reshape(-1), lo.reshape(-1)])
    # disjoint bit ranges -> sums == OR; float64 exact up to 2^53 but a
    # 32-bit word can receive multiple contributions in the same bit span?
    # No: bit spans are disjoint, so each of the 32 bits is set by at most
    # one contribution; sum over at most ~dozens of contributions of
    # disjoint bits <= 2^32-1 < 2^53 -> exact.
    buf = np.bincount(pos, weights=con.astype(np.float64),
                      minlength=out_words)[:out_words]
    return buf.astype(np.uint64).astype(np.uint32), total


def append_payload(bs: BitWriter, payload_words: np.ndarray,
                   total_bits: int) -> None:
    """Append a packed bitstring to a BitWriter as 32-bit tokens."""
    if total_bits == 0:
        return
    n_full = total_bits // 32
    rem = total_bits & 31
    if n_full:
        bs.put_many(np.full(n_full, 32, np.int64),
                    payload_words[:n_full].astype(np.uint64))
    if rem:
        tail = int(payload_words[n_full]) >> (32 - rem)
        bs.put(rem, tail)
