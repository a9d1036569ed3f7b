"""CAVLC residual block coding (spec 9.2; capability parity with reference
encoder/cavlc.c block_residual_write_cavlc).

Copied from x264_tpu/bitstream/cavlc.py but for its import lines:
`write_residual_block`, the scalar writer that the host-syntax path's
I4x4 frames reach (bitstream/slice_writer.py); the reference's
test-oracle decoder is not copied.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.bits import BitWriter
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


def ct_table_idx(nC: int) -> int:
    if nC == -1:
        return 4
    if nC == -2:
        return 5
    if nC < 2:
        return 0
    if nC < 4:
        return 1
    if nC < 8:
        return 2
    return 3


def _write_level(bs: BitWriter, level_code: int, sl: int) -> None:
    if sl == 0:
        if level_code < 14:
            bs.put(level_code + 1, 1)
            return
        if level_code < 30:
            bs.put(15, 1)                   # prefix 14
            bs.put(4, level_code - 14)
            return
        level_code -= 15                    # decoder adds 15 for prefix>=15, sl==0
    else:
        if (level_code >> sl) < 15:
            prefix = level_code >> sl
            bs.put(prefix + 1, 1)
            bs.put(sl, level_code & ((1 << sl) - 1))
            return
    # escape: prefix >= 15
    lcr = level_code - (15 << sl)
    if lcr < 4096:
        bs.put(16, 1)                       # 15 zeros + stop bit
        bs.put(12, lcr)
    else:
        lcr -= 4096
        assert lcr < (1 << 13), "level beyond prefix-16 escape (impossible for 8-bit)"
        bs.put(17, 1)                       # prefix 16
        bs.put(13, lcr)


def write_residual_block(bs: BitWriter, coefs, nC: int, max_coeff: int) -> int:
    """coefs: zigzag-ordered int array of length max_coeff.
    Returns total_coeff (for nnz bookkeeping)."""
    coefs = np.asarray(coefs, dtype=np.int64)
    nz = np.nonzero(coefs)[0]
    total = len(nz)
    t = ct_table_idx(nC)

    if total == 0:
        bs.put(int(COEFF_TOKEN_LEN[t, 0, 0]), int(COEFF_TOKEN_VAL[t, 0, 0]))
        return 0

    # trailing ones: up to 3 consecutive +-1 from the highest-frequency end
    t1 = 0
    for i in nz[::-1]:
        if abs(int(coefs[i])) == 1 and t1 < 3:
            t1 += 1
        else:
            break

    bs.put(int(COEFF_TOKEN_LEN[t, total, t1]), int(COEFF_TOKEN_VAL[t, total, t1]))

    # trailing-one signs, highest frequency first
    for i in nz[::-1][:t1]:
        bs.put1(1 if coefs[i] < 0 else 0)

    # remaining levels, highest frequency first
    sl = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for i in nz[::-1][t1:]:
        level = int(coefs[i])
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if first and t1 < 3:
            level_code -= 2
        first = False
        _write_level(bs, level_code, sl)
        if sl == 0:
            sl = 1
        if abs(level) > (3 << (sl - 1)) and sl < 6:
            sl += 1

    # total_zeros
    total_zeros = int(nz[-1]) + 1 - total
    if total < max_coeff:
        if nC == -1:
            bs.put(int(TZ_2x2_LEN[total - 1, total_zeros]),
                   int(TZ_2x2_VAL[total - 1, total_zeros]))
        elif nC == -2:
            bs.put(int(TZ_2x4_LEN[total - 1, total_zeros]),
                   int(TZ_2x4_VAL[total - 1, total_zeros]))
        else:
            bs.put(int(TOTAL_ZEROS_LEN[total - 1, total_zeros]),
                   int(TOTAL_ZEROS_VAL[total - 1, total_zeros]))

    # run_before, highest frequency first (last run is implied)
    zeros_left = total_zeros
    prev = int(nz[-1])
    for i in nz[::-1][1:]:
        if zeros_left <= 0:
            break
        run = prev - int(i) - 1
        ridx = min(zeros_left, 7) - 1
        bs.put(int(RUN_BEFORE_LEN[ridx, run]), int(RUN_BEFORE_VAL[ridx, run]))
        zeros_left -= run
        prev = int(i)
    return total
