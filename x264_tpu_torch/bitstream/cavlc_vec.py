"""Vectorized CAVLC — whole-frame entropy coding as NumPy array ops.

CAVLC has no adaptive state across blocks (unlike CABAC): every residual
block's bitstring is a pure function of its coefficients and its nC context
(which is known ahead of time from the nnz tensors the device pipeline
emits).  So the entire slice payload is computed as fixed-slot (value,
length) grids — one row per block, one column per potential code — and
packed in a single pass.  This is the TPU-first restructuring of x264's
per-coefficient bs_t loop (reference encoder/cavlc.c
block_residual_write_cavlc, common/bitstream.h:86-126): same codes, emitted
by batched table gathers instead of a serial state machine.

Slot layout per residual block (36 slots):
  [0]      coeff_token
  [1:4]    trailing-one signs
  [4:20]   level codes (prefix+suffix fused into one code each)
  [20]     total_zeros
  [21:36]  run_before
Unused slots carry length 0 and vanish at pack time.

Copied from x264_tpu/bitstream/cavlc_vec.py but for its import lines (the port's
host layer; tests/test_torch_host.py holds the copy).
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.tables import (
    COEFF_TOKEN_LEN,
    COEFF_TOKEN_VAL,
    RUN_BEFORE_LEN,
    RUN_BEFORE_VAL,
    TOTAL_ZEROS_LEN,
    TOTAL_ZEROS_VAL,
    TZ_2x2_LEN,
    TZ_2x2_VAL,
    TZ_2x4_LEN,
    TZ_2x4_VAL,
)

BLOCK_SLOTS = 36
_I64 = np.int64


def bit_length_vec(x: np.ndarray) -> np.ndarray:
    """Exact integer bit_length for x >= 0 (values < 2^52)."""
    x = x.astype(np.int64)
    out = np.zeros_like(x)
    nz = x > 0
    out[nz] = np.floor(np.log2(x[nz])).astype(np.int64) + 1
    # guard against float rounding at exact powers of two boundaries
    too_low = nz & ((np.int64(1) << np.clip(out, 0, 62)) <= x)
    out[too_low] += 1
    too_high = nz & ((np.int64(1) << np.clip(out - 1, 0, 62)) > x)
    out[too_high] -= 1
    return out


def ue_codes(v: np.ndarray):
    """Vectorized unsigned exp-Golomb: returns (vals, lens)."""
    vv = v.astype(np.int64) + 1
    nb = bit_length_vec(vv)
    return vv, 2 * nb - 1


def se_codes(v: np.ndarray):
    v = v.astype(np.int64)
    k = np.where(v > 0, 2 * v - 1, -2 * v)
    return ue_codes(k)


def _level_codes(lc, sl):
    """Vectorized _write_level (cavlc.py): fuse unary prefix + suffix into
    one (val, len) code.  lc, sl: int64 arrays."""
    lc = lc.astype(_I64)
    sl = sl.astype(_I64)
    mask = (np.int64(1) << sl) - 1

    # A: sl==0, lc<14            -> len lc+1, val 1
    # B: sl==0, 14<=lc<30        -> len 19, val (1<<4)|(lc-14)
    # C: sl>0, (lc>>sl)<15       -> len (lc>>sl)+1+sl, val (1<<sl)|(lc&mask)
    # escape (with lc' = lc-15 when sl==0):
    # D: lcr<4096                -> len 28, val (1<<12)|lcr
    # E: else                    -> len 30, val (1<<13)|(lcr-4096)
    prefix = lc >> np.maximum(sl, 1)
    lc_esc = np.where(sl == 0, lc - 15, lc)
    lcr = lc_esc - (np.int64(15) << sl)

    cond_a = (sl == 0) & (lc < 14)
    cond_b = (sl == 0) & (lc >= 14) & (lc < 30)
    cond_c = (sl > 0) & (prefix < 15)
    cond_d = lcr < 4096

    val = np.select(
        [cond_a, cond_b, cond_c, cond_d],
        [np.ones_like(lc),
         (np.int64(1) << 4) | (lc - 14),
         (np.int64(1) << sl) | (lc & mask),
         (np.int64(1) << 12) | np.clip(lcr, 0, None)],
        (np.int64(1) << 13) | np.clip(lcr - 4096, 0, None))
    ln = np.select(
        [cond_a, cond_b, cond_c, cond_d],
        [lc + 1, np.full_like(lc, 19), prefix + 1 + sl,
         np.full_like(lc, 28)],
        np.full_like(lc, 30))
    return val, ln


def code_blocks(coefs: np.ndarray, blen: np.ndarray, nC: np.ndarray):
    """coefs (B,16) int, zigzag order left-aligned to each block's length
    (entries >= blen[b] must be 0).  blen (B,): 4, 15, or 16.
    nC (B,): CAVLC context (-1 chroma DC 2x2, -2 chroma DC 2x4, else >=0).
    Returns (vals (B,36) int64, lens (B,36) int64); caller masks uncoded
    blocks by zeroing their lens."""
    B = coefs.shape[0]
    L = 16
    coefs = coefs.astype(_I64)
    blen = blen.astype(_I64)
    nC = nC.astype(_I64)
    j = np.arange(L, dtype=_I64)

    # reverse within each block's own length (highest frequency first)
    src = blen[:, None] - 1 - j[None, :]
    rev = np.take_along_axis(coefs, np.clip(src, 0, L - 1), axis=1)
    rev = np.where(src >= 0, rev, 0)

    nzmask = rev != 0
    total = nzmask.sum(1)
    order = np.argsort(~nzmask, axis=1, kind="stable")
    seq = np.take_along_axis(rev, order, axis=1)        # nonzeros, hi-freq first
    pos_zig = blen[:, None] - 1 - order                  # their zigzag positions

    kk = j[None, :]
    in_range = kk < total[:, None]
    abs1 = in_range & (np.abs(seq) == 1)
    t1 = (abs1[:, 0].astype(_I64)
          + (abs1[:, 0] & abs1[:, 1]).astype(_I64)
          + (abs1[:, 0] & abs1[:, 1] & abs1[:, 2]).astype(_I64))

    vals = np.zeros((B, BLOCK_SLOTS), _I64)
    lens = np.zeros((B, BLOCK_SLOTS), _I64)

    # --- coeff_token ---
    t = np.select([nC == -1, nC == -2, nC < 2, nC < 4, nC < 8],
                  [4, 5, 0, 1, 2], 3)
    vals[:, 0] = COEFF_TOKEN_VAL[t, total, t1]
    lens[:, 0] = COEFF_TOKEN_LEN[t, total, t1]

    # --- trailing-one signs ---
    for k in range(3):
        on = k < t1
        vals[:, 1 + k] = np.where(on & (seq[:, k] < 0), 1, 0)
        lens[:, 1 + k] = on.astype(_I64)

    # --- levels ---
    sl = np.where((total > 10) & (t1 < 3), 1, 0).astype(_I64)
    for k in range(L):
        active = (k >= t1) & (k < total)
        lvl = seq[:, k]
        lc = np.where(lvl > 0, 2 * lvl - 2, -2 * lvl - 1)
        lc = np.where((k == t1) & (t1 < 3), lc - 2, lc)
        v, ln = _level_codes(lc, sl)
        vals[:, 4 + k] = np.where(active, v, 0)
        lens[:, 4 + k] = np.where(active, ln, 0)
        sl_n = np.maximum(sl, 1)
        sl_n = np.where((np.abs(lvl) > (np.int64(3) << (sl_n - 1))) & (sl_n < 6),
                        sl_n + 1, sl_n)
        sl = np.where(active, sl_n, sl)

    # --- total_zeros ---
    tz = pos_zig[:, 0] + 1 - total
    tzc = np.clip(tz, 0, 15)
    ridx = np.clip(total - 1, 0, 14)
    tz_v = TOTAL_ZEROS_VAL[ridx, tzc].astype(_I64)
    tz_l = TOTAL_ZEROS_LEN[ridx, tzc].astype(_I64)
    tz2_v = TZ_2x2_VAL[np.clip(total - 1, 0, 2), np.clip(tz, 0, 3)].astype(_I64)
    tz2_l = TZ_2x2_LEN[np.clip(total - 1, 0, 2), np.clip(tz, 0, 3)].astype(_I64)
    tz24_v = TZ_2x4_VAL[np.clip(total - 1, 0, 6), np.clip(tz, 0, 7)].astype(_I64)
    tz24_l = TZ_2x4_LEN[np.clip(total - 1, 0, 6), np.clip(tz, 0, 7)].astype(_I64)
    on = (total > 0) & (total < blen)
    vals[:, 20] = np.where(on, np.select([nC == -1, nC == -2], [tz2_v, tz24_v], tz_v), 0)
    lens[:, 20] = np.where(on, np.select([nC == -1, nC == -2], [tz2_l, tz24_l], tz_l), 0)

    # --- run_before ---
    zeros_left = np.where(total > 0, tz, 0)
    prev_pos = pos_zig[:, 0]
    for k in range(1, L):
        active = (k < total) & (zeros_left > 0)
        run = np.clip(prev_pos - pos_zig[:, k] - 1, 0, 14)
        ri = np.clip(np.minimum(zeros_left, 7) - 1, 0, 6)
        vals[:, 20 + k] = np.where(active, RUN_BEFORE_VAL[ri, run], 0)
        lens[:, 20 + k] = np.where(active, RUN_BEFORE_LEN[ri, run], 0)
        zeros_left = np.where(active, zeros_left - run, zeros_left)
        prev_pos = np.where(k < total, pos_zig[:, k], prev_pos)

    # blocks with total==0 emit only their coeff_token
    none = total == 0
    lens[none, 1:] = 0
    return vals, lens
