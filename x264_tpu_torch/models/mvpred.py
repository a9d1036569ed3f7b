"""Normative MV prediction (spec 8.4.1; parity with reference
common/mvpred.c x264_mb_predict_mv / x264_mb_predict_mv_pskip).

This is the truly sequential part of inter coding: the skip decision for MB
n depends on the decoded state of its neighbors.  It runs as a cheap host
scan over per-MB arrays after the batched device ME/transform pass — the
TPU-first split of x264's per-MB analyse loop.

All mvs in quarter-pel units, [x, y] order.

Copied from x264_tpu/models/mvpred.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.models.syntax import MB_I4, MB_I16, MB_P16, MB_PSKIP


def _median(a, b, c):
    return a + b + c - min(a, b, c) - max(a, b, c)


def predict_mv_16x16(mv_dec: np.ndarray, ref_dec: np.ndarray,
                     mbx: int, mby: int, mbw: int, cur_ref: int = 0):
    """Median MVP for a full-MB partition (8.4.1.3).  mv_dec/ref_dec hold
    the *decoded-so-far* state (intra/unavail -> ref -1, mv 0)."""

    def nb(x, y):
        if x < 0 or y < 0 or x >= mbw:
            return None
        return y * mbw + x

    ia = nb(mbx - 1, mby)
    ib = nb(mbx, mby - 1)
    ic = nb(mbx + 1, mby - 1)
    if ic is None:
        ic = nb(mbx - 1, mby - 1)  # D substitution

    def info(i):
        if i is None:
            return np.zeros(2, np.int32), -1, False
        return mv_dec[i], int(ref_dec[i]), True

    mva, refa, av_a = info(ia)
    mvb, refb, av_b = info(ib)
    mvc, refc, av_c = info(ic)

    if not av_b and not av_c and av_a:
        return mva.copy()

    match = [(mva, refa), (mvb, refb), (mvc, refc)]
    same = [m for m, r in match if r == cur_ref]
    if len(same) == 1:
        return same[0].copy()

    return np.array([_median(int(mva[0]), int(mvb[0]), int(mvc[0])),
                     _median(int(mva[1]), int(mvb[1]), int(mvc[1]))], np.int32)


# partition geometry: (shape, part) -> (local bx, by, w4, h4) in 4x4 units
PART_GEOM = {
    (0, 0): (0, 0, 4, 4),
    (1, 0): (0, 0, 4, 2), (1, 1): (0, 2, 4, 2),
    (2, 0): (0, 0, 2, 4), (2, 1): (2, 0, 2, 4),
    (3, 0): (0, 0, 2, 2), (3, 1): (2, 0, 2, 2),
    (3, 2): (0, 2, 2, 2), (3, 3): (2, 2, 2, 2),
}
N_PARTS_OF_SHAPE = (1, 2, 2, 4)


def predict_mv_part(mv4: np.ndarray, ref4: np.ndarray, av4: np.ndarray,
                    mbx: int, mby: int, shape: int, part: int,
                    cur_ref: int):
    """Partition median MVP (8.4.1.3) over decoded 4x4-grain state.

    mv4 (H4, W4, 2) / ref4 (H4, W4) / av4 (H4, W4) hold the
    decoded-so-far 4x4-block grid (intra -> ref -1 mv 0 avail True;
    not-yet-decoded -> avail False).  Scalar oracle for the parallel
    device form (ops/device/header.classify_p_parts); parity anchor
    reference common/mvpred.c x264_mb_predict_mv."""
    h4, w4g = ref4.shape
    lbx, lby, pw, ph = PART_GEOM[(shape, part)]
    bx, by = 4 * mbx + lbx, 4 * mby + lby

    def blk(x, y):
        if x < 0 or y < 0 or x >= w4g or y >= h4 or not av4[y, x]:
            return np.zeros(2, np.int32), -1, False
        return mv4[y, x], int(ref4[y, x]), True

    mva, refa, av_a = blk(bx - 1, by)
    mvb, refb, av_b = blk(bx, by - 1)
    mvc, refc, av_c = blk(bx + pw, by - 1)
    if not av_c:
        mvc, refc, av_c = blk(bx - 1, by - 1)   # D substitution

    # directional shortcuts (8.4.1.3, 16x8 / 8x16 rules)
    if shape == 1:                               # 16x8
        if part == 0 and refb == cur_ref:
            return mvb.copy()
        if part == 1 and refa == cur_ref:
            return mva.copy()
    elif shape == 2:                             # 8x16
        if part == 0 and refa == cur_ref:
            return mva.copy()
        if part == 1 and refc == cur_ref:
            return mvc.copy()

    if not av_b and not av_c and av_a:
        return mva.copy()
    same = [m for m, r in ((mva, refa), (mvb, refb), (mvc, refc))
            if r == cur_ref]
    if len(same) == 1:
        return same[0].copy()
    return np.array([_median(int(mva[0]), int(mvb[0]), int(mvc[0])),
                     _median(int(mva[1]), int(mvb[1]), int(mvc[1]))],
                    np.int32)


def classify_p_parts_scan(shape: np.ndarray, mv8: np.ndarray,
                          ref8: np.ndarray, intra: np.ndarray,
                          cbp_l: np.ndarray, cbp_c: np.ndarray,
                          mbw: int, mbh: int):
    """Host decode-order scan: partition MVP/mvd + P_Skip over the
    4x4-grain decoded state.  shape (N,) in {0:16x16,1:16x8,2:8x16,
    3:8x8}; mv8 (N,4,2) per-QUADRANT chosen mvs (quadrant q = 2*qy+qx);
    ref8 (N,4); intra (N,) bool.  Returns (is_skip (N,) bool,
    mvd_part (N,4,2) in partition-slot order).  The test oracle for the
    parallel device classification."""
    n = mbw * mbh
    h4, w4g = 4 * mbh, 4 * mbw
    mv4 = np.zeros((h4, w4g, 2), np.int32)
    ref4 = np.full((h4, w4g), -1, np.int32)
    av4 = np.zeros((h4, w4g), bool)
    is_skip = np.zeros(n, bool)
    mvd_part = np.zeros((n, 4, 2), np.int32)

    for i in range(n):
        mby, mbx = divmod(i, mbw)
        gy, gx = 4 * mby, 4 * mbx
        if intra[i]:
            av4[gy:gy + 4, gx:gx + 4] = True     # ref -1, mv 0 already
            continue
        sh = int(shape[i])
        if sh == 0:
            # P_Skip first (8.4.1.1, MB-granularity A/B)
            skip_mv = _pskip_mv4(mv4, ref4, av4, mbx, mby)
            q0 = mv8[i, 0]
            if (cbp_l[i] == 0 and cbp_c[i] == 0 and ref8[i, 0] == 0
                    and q0[0] == skip_mv[0] and q0[1] == skip_mv[1]):
                is_skip[i] = True
                _fill4(mv4, ref4, av4, gy, gx, 4, 4, skip_mv, 0)
                continue
        for p in range(N_PARTS_OF_SHAPE[sh]):
            lbx, lby, pw, ph = PART_GEOM[(sh, p)]
            q = (lby // 2) * 2 + (lbx // 2)   # first member quadrant
            cur_ref = int(ref8[i, q])
            mvp = predict_mv_part(mv4, ref4, av4, mbx, mby, sh, p,
                                  cur_ref)
            mvd_part[i, p] = mv8[i, q] - mvp
            _fill4(mv4, ref4, av4, gy + lby, gx + lbx, pw, ph,
                   mv8[i, q], cur_ref)
    return is_skip, mvd_part


def _fill4(mv4, ref4, av4, y, x, w, h, mv, ref):
    mv4[y:y + h, x:x + w] = mv
    ref4[y:y + h, x:x + w] = ref
    av4[y:y + h, x:x + w] = True


def _pskip_mv4(mv4, ref4, av4, mbx, mby):
    """P_Skip mv (8.4.1.1) from the 4x4-grain decoded grids."""
    if mbx == 0 or mby == 0:
        return np.zeros(2, np.int32)
    gy, gx = 4 * mby, 4 * mbx
    a_ok = av4[gy, gx - 1]
    b_ok = av4[gy - 1, gx]
    if not a_ok or not b_ok:
        return np.zeros(2, np.int32)
    if ref4[gy, gx - 1] == 0 and not mv4[gy, gx - 1].any():
        return np.zeros(2, np.int32)
    if ref4[gy - 1, gx] == 0 and not mv4[gy - 1, gx].any():
        return np.zeros(2, np.int32)
    return predict_mv_part(mv4, ref4, av4, mbx, mby, 0, 0, 0)


def pskip_mv(mv_dec: np.ndarray, ref_dec: np.ndarray,
             mbx: int, mby: int, mbw: int):
    """P_Skip motion vector (8.4.1.1)."""
    if mbx == 0 or mby == 0:
        # A or B unavailable (left edge / top edge) -> (0,0)
        return np.zeros(2, np.int32)
    ia = mby * mbw + (mbx - 1)
    ib = (mby - 1) * mbw + mbx
    if (int(ref_dec[ia]) == 0 and mv_dec[ia][0] == 0 and mv_dec[ia][1] == 0):
        return np.zeros(2, np.int32)
    if (int(ref_dec[ib]) == 0 and mv_dec[ib][0] == 0 and mv_dec[ib][1] == 0):
        return np.zeros(2, np.int32)
    return predict_mv_16x16(mv_dec, ref_dec, mbx, mby, mbw, cur_ref=0)
