"""Bit-level I/O for H.264 bitstream writing.

Design: unlike x264's byte-at-a-time `bs_t` writer (reference
common/bitstream.h:39-126), the hot path here is *vectorized*: codes are
accumulated as (value, nbits) pairs in growable NumPy arrays and packed to
bytes in one `np.packbits` pass at flush time.  This matches the TPU-first
architecture where the device emits per-MB symbol tensors and the host
serializes them in bulk.

Copied from x264_tpu/bitstream/bits.py (the writer only).
"""

from __future__ import annotations

import numpy as np

_MAX_CODE_BITS = 48  # longest single code we ever emit (CAVLC escape <= 28)


class BitWriter:
    """Accumulates (value, nbits) codes; packs to bytes on demand.

    Values must fit in `nbits` bits (callers mask).  nbits may be 0 (no-op).
    """

    __slots__ = ("_vals", "_lens", "_n", "_cap")

    def __init__(self, cap: int = 4096):
        self._cap = cap
        self._vals = np.zeros(cap, dtype=np.uint64)
        self._lens = np.zeros(cap, dtype=np.uint8)
        self._n = 0

    def _grow(self, need: int) -> None:
        while self._cap < need:
            self._cap *= 2
        self._vals = np.resize(self._vals, self._cap)
        self._lens = np.resize(self._lens, self._cap)

    # -- scalar API ---------------------------------------------------------
    def put(self, nbits: int, value: int) -> None:
        if nbits == 0:
            return
        assert 0 < nbits <= _MAX_CODE_BITS
        if self._n >= self._cap:
            self._grow(self._n + 1)
        self._vals[self._n] = value
        self._lens[self._n] = nbits
        self._n += 1

    def put1(self, bit: int) -> None:
        self.put(1, bit)

    def ue(self, v: int) -> None:
        """Unsigned exp-Golomb (spec 9.1)."""
        vv = v + 1
        nbits = vv.bit_length()
        self.put(2 * nbits - 1, vv)

    def se(self, v: int) -> None:
        """Signed exp-Golomb (spec 9.1.1): v>0 -> 2v-1, v<=0 -> -2v."""
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    # -- bulk API (vectorized CAVLC path) ------------------------------------
    def put_many(self, nbits: np.ndarray, values: np.ndarray) -> None:
        """Append arrays of codes. Zero-length entries are kept (skipped at pack)."""
        m = len(nbits)
        if self._n + m > self._cap:
            self._grow(self._n + m)
        self._vals[self._n:self._n + m] = values.astype(np.uint64)
        self._lens[self._n:self._n + m] = nbits.astype(np.uint8)
        self._n += m

    def ue_many(self, v: np.ndarray) -> None:
        vv = (v + 1).astype(np.uint64)
        nb = np.zeros(len(vv), dtype=np.uint8)
        x = vv.copy()
        while np.any(x):
            nb += (x > 0).astype(np.uint8)
            x >>= np.uint64(1)
        self.put_many(2 * nb - 1, vv)

    # -- introspection -------------------------------------------------------
    @property
    def bit_length(self) -> int:
        return int(self._lens[:self._n].astype(np.int64).sum())

    def _pack(self) -> tuple[np.ndarray, int]:
        """Pack all codes to a byte array (MSB-first bit order).  Returns
        (bytes uint8, total_bits).

        Fast path: each code's bits are blitted into a 7-byte window at its
        byte offset; windows of adjacent codes overlap only in bytes, never
        in *set bits*, so summing the per-byte contributions (np.bincount
        with weights) equals the OR — one C-speed pass, no Python loop."""
        lens = self._lens[:self._n].astype(np.int64)
        vals = self._vals[:self._n]
        live = lens > 0
        lens = lens[live]
        vals = vals[live]
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, dtype=np.uint8), 0
        offs = np.concatenate(([0], np.cumsum(lens)))[:-1]
        starts = offs >> 3
        bitpos = offs & 7
        # span = bitpos + len <= 7 + 48 = 55 bits -> 7-byte window
        word = vals << (56 - bitpos - lens).astype(np.uint64)
        nbytes = (total + 7) >> 3
        jj = np.arange(7, dtype=np.int64)
        pos = (starts[:, None] + jj[None, :]).reshape(-1)
        byts = ((word[:, None] >> ((48 - 8 * jj)[None, :].astype(np.uint64)))
                & np.uint64(0xFF)).reshape(-1)
        buf = np.bincount(pos, weights=byts, minlength=nbytes + 7)[:nbytes]
        return buf.astype(np.uint8), total

    def pack_bits(self) -> np.ndarray:
        """Return the bit string as a uint8 array of 0/1 (MSB first)."""
        buf, total = self._pack()
        return np.unpackbits(buf)[:total]

    def to_rbsp(self) -> bytes:
        """rbsp_trailing_bits: append stop bit '1', pad with zeros to byte."""
        self.put1(1)
        buf, total = self._pack()
        self._n -= 1  # leave writer state unchanged
        return buf.tobytes()

    def to_bytes_aligned(self) -> bytes:
        """Pack without trailing bits; caller guarantees byte alignment."""
        buf, total = self._pack()
        assert total % 8 == 0, "bitstream not byte aligned"
        return buf.tobytes()
