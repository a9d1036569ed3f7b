"""In-loop deblocking filter (spec 8.7; parity with reference
common/deblock.c x264_frame_deblock_row).

Structure: boundary-strength (bS) computation is fully parallel over the
frame (pure function of mb types, nnz, mvs, refs); the pixel filtering is
a MB-raster wavefront (each MB filters its vertical then horizontal edges
using already-filtered neighbors).  This NumPy tier runs the wavefront
serially per MB with each 16-line edge vectorized; the JAX tier batches
MBs per diagonal.

Threshold tables are normative constants from spec Table 8-16.

Copied from x264_tpu/ops/reference/deblock.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.models.syntax import MB_I4, MB_I16
from x264_tpu_torch.state import CHROMA_QP_TABLE

# Table 8-16 (qp 0..51)
ALPHA = np.array([0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22,
                             25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
                             101, 113, 127, 144, 162, 182, 203, 226, 255, 255],
                 dtype=np.int64)
BETA = np.array([0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                            9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
                            15, 16, 16, 17, 17, 18, 18], dtype=np.int64)
# TC0[qp][bs-1] for bs in 1..3
TC0 = np.zeros((52, 3), dtype=np.int64)
_tc0_rows = (
    [(0, 0, 0)] * 17 + [(0, 0, 1)] * 4 + [(0, 1, 1)] * 2 + [(1, 1, 1)] * 4 +
    [(1, 1, 2)] * 4 + [(1, 2, 3)] * 2 + [(2, 2, 3)] + [(2, 2, 4)] +
    [(2, 3, 4)] * 2 + [(3, 3, 5)] + [(3, 4, 6)] * 2 + [(4, 5, 7)] +
    [(4, 5, 8)] + [(4, 6, 9)] + [(5, 7, 10)] + [(6, 8, 11)] + [(6, 8, 13)] +
    [(7, 10, 14)] + [(8, 11, 16)] + [(9, 12, 18)] + [(10, 13, 20)] +
    [(11, 15, 23)] + [(13, 17, 25)]
)
for _q, _row in enumerate(_tc0_rows):
    TC0[_q] = _row


def _clip255(x):
    return np.clip(x, 0, 255)


def _filter_luma_lines(p3, p2, p1, p0, q0, q1, q2, q3, bs, qp_av, off_a, off_b):
    """Filter L parallel lines across one edge. Returns new (p2,p1,p0,q0,q1,q2)."""
    idx_a = np.clip(qp_av + off_a, 0, 51)
    idx_b = np.clip(qp_av + off_b, 0, 51)
    alpha = ALPHA[idx_a]
    beta = BETA[idx_b]
    tc0 = TC0[idx_a, np.clip(bs, 1, 3) - 1]

    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & \
           (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta

    # --- bs 1..3 ---
    tc = tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = _clip255(p0 + delta)
    q0_n = _clip255(q0 - delta)
    p1_n = np.where(ap, p1 + np.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1,
                                     -tc0, tc0), p1)
    q1_n = np.where(aq, q1 + np.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1,
                                     -tc0, tc0), q1)

    # --- bs 4 ---
    strong = np.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp = ap & strong
    sq = aq & strong
    p0_s = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                    (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0_s = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                    (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    bs4 = bs == 4
    out_p0 = np.where(filt, np.where(bs4, p0_s, p0_n), p0)
    out_q0 = np.where(filt, np.where(bs4, q0_s, q0_n), q0)
    out_p1 = np.where(filt, np.where(bs4, p1_s, p1_n), p1)
    out_q1 = np.where(filt, np.where(bs4, q1_s, q1_n), q1)
    out_p2 = np.where(filt & bs4, p2_s, p2)
    out_q2 = np.where(filt & bs4, q2_s, q2)
    return out_p2, out_p1, out_p0, out_q0, out_q1, out_q2


def _filter_chroma_lines(p1, p0, q0, q1, bs, qp_av, off_a, off_b):
    idx_a = np.clip(qp_av + off_a, 0, 51)
    idx_b = np.clip(qp_av + off_b, 0, 51)
    alpha = ALPHA[idx_a]
    beta = BETA[idx_b]
    tc0 = TC0[idx_a, np.clip(bs, 1, 3) - 1]

    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) & \
           (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    tc = tc0 + 1
    delta = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = _clip255(p0 + delta)
    q0_n = _clip255(q0 - delta)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    bs4 = bs == 4
    out_p0 = np.where(filt, np.where(bs4, p0_s, p0_n), p0)
    out_q0 = np.where(filt, np.where(bs4, q0_s, q0_n), q0)
    return out_p0, out_q0


def compute_bs(syn, mbx: int, mby: int, vertical: bool, edge: int) -> np.ndarray:
    """bS (4,) for one luma edge (4 4x4-block pairs along it). 8.7.2.1."""
    mbw = syn.mb_width
    mb = mby * mbw + mbx
    intra_cur = int(syn.mb_class[mb]) in (MB_I16, MB_I4)
    nnz = syn.luma_nnz_grid()
    gx0, gy0 = mbx * 4, mby * 4

    if edge == 0:
        nb = mb - 1 if vertical else mb - mbw
        intra_nb = int(syn.mb_class[nb]) in (MB_I16, MB_I4)
        if intra_cur or intra_nb:
            return np.full(4, 4, np.int64)
    elif intra_cur:
        return np.full(4, 3, np.int64)

    bs = np.zeros(4, np.int64)
    for k in range(4):
        if vertical:
            qy, qx = gy0 + k, gx0 + edge
            py, px = qy, qx - 1
        else:
            qy, qx = gy0 + edge, gx0 + k
            py, px = qy - 1, qx
        if nnz[qy, qx] or nnz[py, px]:
            bs[k] = 2
            continue
        # mv/ref comparison (16x16 partitions: per-MB mv)
        mb_q = (qy // 4) * mbw + (qx // 4)
        mb_p = (py // 4) * mbw + (px // 4)
        mvq, mvp = syn.mv[mb_q], syn.mv[mb_p]
        refq, refp = int(syn.ref[mb_q]), int(syn.ref[mb_p])
        if refq != refp or abs(int(mvq[0]) - int(mvp[0])) >= 4 \
                or abs(int(mvq[1]) - int(mvp[1])) >= 4:
            bs[k] = 1
    return bs


def deblock_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray, syn,
                  alpha_off2: int = 0, beta_off2: int = 0,
                  chroma_qp_offset: int = 0):
    """Filter recon planes in MB raster order (in-place on copies).
    alpha_off2/beta_off2 are slice_{alpha_c0,beta}_offset_div2.
    Returns (y, u, v) filtered."""
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    mbw, mbh = syn.mb_width, syn.mb_height
    off_a, off_b = alpha_off2 * 2, beta_off2 * 2
    qp_mb = syn.qp.astype(np.int64)
    qpc_mb = CHROMA_QP_TABLE[np.clip(qp_mb + chroma_qp_offset, 0, 51)]

    for mby in range(mbh):
        for mbx in range(mbw):
            mb = mby * mbw + mbx
            y0, x0 = mby * 16, mbx * 16
            cy0, cx0 = mby * 8, mbx * 8

            # ---- vertical edges (filter left to right) ----
            for e in range(4):
                if e == 0 and mbx == 0:
                    continue
                bs = compute_bs(syn, mbx, mby, True, e)
                if not bs.any():
                    continue
                nb_qp = qp_mb[mb - 1] if e == 0 else qp_mb[mb]
                qp_av = (qp_mb[mb] + nb_qp + 1) >> 1
                x = x0 + 4 * e
                rows = slice(y0, y0 + 16)
                cols = [y[rows, x - 4 + i] for i in range(8)]
                bs16 = np.repeat(bs, 4)
                res = _filter_luma_lines(*cols, bs16, qp_av, off_a, off_b)
                for i, arr in enumerate(res):
                    y[rows, x - 3 + i] = arr
                if e in (0, 2):
                    cqp_av = (qpc_mb[mb] + (qpc_mb[mb - 1] if e == 0 else qpc_mb[mb]) + 1) >> 1
                    cx = cx0 + 2 * e
                    crows = slice(cy0, cy0 + 8)
                    bs8 = np.repeat(bs, 2)
                    for pl in (u, v):
                        p1c, p0c = pl[crows, cx - 2], pl[crows, cx - 1]
                        q0c, q1c = pl[crows, cx], pl[crows, cx + 1]
                        np0, nq0 = _filter_chroma_lines(p1c, p0c, q0c, q1c,
                                                        bs8, cqp_av, off_a, off_b)
                        pl[crows, cx - 1] = np0
                        pl[crows, cx] = nq0

            # ---- horizontal edges (top to bottom) ----
            for e in range(4):
                if e == 0 and mby == 0:
                    continue
                bs = compute_bs(syn, mbx, mby, False, e)
                if not bs.any():
                    continue
                nb_qp = qp_mb[mb - mbw] if e == 0 else qp_mb[mb]
                qp_av = (qp_mb[mb] + nb_qp + 1) >> 1
                yy = y0 + 4 * e
                colr = slice(x0, x0 + 16)
                rows8 = [y[yy - 4 + i, colr] for i in range(8)]
                bs16 = np.repeat(bs, 4)
                res = _filter_luma_lines(*rows8, bs16, qp_av, off_a, off_b)
                for i, arr in enumerate(res):
                    y[yy - 3 + i, colr] = arr
                if e in (0, 2):
                    cqp_av = (qpc_mb[mb] + (qpc_mb[mb - mbw] if e == 0 else qpc_mb[mb]) + 1) >> 1
                    cy = cy0 + 2 * e
                    ccol = slice(cx0, cx0 + 8)
                    bs8 = np.repeat(bs, 2)
                    for pl in (u, v):
                        p1c, p0c = pl[cy - 2, ccol], pl[cy - 1, ccol]
                        q0c, q1c = pl[cy, ccol], pl[cy + 1, ccol]
                        np0, nq0 = _filter_chroma_lines(p1c, p0c, q0c, q1c,
                                                        bs8, cqp_av, off_a, off_b)
                        pl[cy - 1, ccol] = np0
                        pl[cy, ccol] = nq0

    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)
