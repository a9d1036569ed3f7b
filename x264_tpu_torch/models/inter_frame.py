"""P-frame encoding: batched full-search ME + motion compensation +
residual path, with the normative sequential part (skip classification,
MVP/mvd) as a host scan.

Capability parity: encoder/me.c (ESA full search is the TPU-native choice:
batched exhaustive SAD maps to the vector units; x264's DIA/HEX/UMH exist
to save CPU cycles, not quality), encoder/analyse.c inter 16x16 path,
encoder/macroblock.c P-MB encode.

This is the NumPy reference tier; models/inter_jax.py mirrors it on device.

Copied from x264_tpu/models/inter_frame.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.tables import chroma_qp
from x264_tpu_torch.models import mvpred
from x264_tpu_torch.models.intra_frame import encode_chroma_mb, zigzag
from x264_tpu_torch.models.syntax import (MB_I16, MB_P16, MB_PSKIP,
                                    FrameSyntax, empty_syntax)
from x264_tpu_torch.ops.reference import mc, quant, transform
from x264_tpu_torch.utils.yuv import expand_border

PAD = 32  # luma search+interp padding (PADH/PADV analog, common/frame.h:32)

# x264 lambda table shape: lambda = 0.85 * 2^((qp-12)/3)
def me_lambda(qp: int) -> int:
    """LAMBDA2 law (0.85 * 2^((qp-12)/3), reference x264_lambda2_tab):
    the RD slope — correct for trellis / SSD+rate decisions ONLY."""
    return max(1, round(0.85 * 2.0 ** ((qp - 12) / 3.0)))


def sad_lambda(qp: int) -> int:
    """SATD-domain lambda (reference common/tables.c x264_lambda_tab =
    round(2^((qp-12)/6))): the multiplier for BIT costs added to
    SAD/SATD terms — mv bits, intra mode bits, mb_type costs.  Using
    me_lambda (the λ² law) here overweights bits ~3-4x and biases every
    analysis decision toward cheap-but-poor predictions."""
    return max(1, round(2.0 ** ((qp - 12) / 6.0)))


def mv_bits(d: int) -> int:
    """Bits of se(d) exp-Golomb."""
    k = 2 * abs(d) - (1 if d > 0 else 0)
    return 2 * int(k + 1).bit_length() - 1


_MVBITS_CACHE: dict[int, np.ndarray] = {}


def mv_bits_arr(max_abs: int) -> np.ndarray:
    """Lookup d -> bits for d in [-max_abs, max_abs] (index d + max_abs)."""
    if max_abs not in _MVBITS_CACHE:
        _MVBITS_CACHE[max_abs] = np.array(
            [mv_bits(d) for d in range(-max_abs, max_abs + 1)], np.int64)
    return _MVBITS_CACHE[max_abs]


def full_search_16x16(src_y: np.ndarray, ref_pad: np.ndarray, me_range: int,
                      lam: int):
    """Exhaustive fullpel search over +-me_range for every MB.

    src_y: (H, W) padded-to-MB source. ref_pad: (H+2PAD, W+2PAD).
    Returns mv (N, 2) in qpel units and sad (N,)."""
    h, w = src_y.shape
    mbw, mbh = w // 16, h // 16
    n = mbw * mbh
    r = me_range
    src = src_y.astype(np.int64)

    def mb_sums(x):
        return x.reshape(mbh, 16, mbw, 16).sum((1, 3)).reshape(n)

    bits = mv_bits_arr(4 * r)
    best = np.full(n, 1 << 60, np.int64)
    best_mv = np.zeros((n, 2), np.int32)
    for dy in range(-r, r + 1):
        cost_y = lam * bits[4 * dy + 4 * r]
        for dx in range(-r, r + 1):
            shifted = ref_pad[PAD + dy: PAD + dy + h, PAD + dx: PAD + dx + w]
            sad = mb_sums(np.abs(src - shifted))
            cost = sad + cost_y + lam * bits[4 * dx + 4 * r]
            better = cost < best
            best = np.where(better, cost, best)
            best_mv[better] = (4 * dx, 4 * dy)
    return best_mv, best


def subpel_refine(src_mbs, planes4, mv0, lam, me_range: int, steps: int,
                  mbw: int, mbh: int):
    """NumPy mirror of ops/device/me.subpel_refine: exhaustive SATD over
    the +-3 qpel window (identical candidate order and tie-breaking)."""
    from x264_tpu_torch.ops.me import subpel_candidates
    from x264_tpu_torch.ops.reference.mc import QPEL_TWO_SAMPLE_TBL
    from x264_tpu_torch.ops.reference.pixel import satd

    n = mbw * mbh
    off = 4 * me_range + 4
    bits = mv_bits_arr(off)

    mby = np.arange(n) // mbw
    mbx = np.arange(n) % mbw
    y0 = PAD + mby * 16 + (mv0[:, 1] >> 2) - 1
    x0 = PAD + mbx * 16 + (mv0[:, 0] >> 2) - 1
    r18 = np.arange(18)
    yi = y0[:, None, None] + r18[None, :, None]
    xi = x0[:, None, None] + r18[None, None, :]
    win = planes4[:, yi, xi]                    # (4, N, 18, 18)

    best = None
    best_mv = mv0.astype(np.int64)
    for (dy, dx) in subpel_candidates(steps):
        fy, fx = dy & 3, dx & 3
        iy, ix = dy >> 2, dx >> 2
        p1, dy1, dx1, p2, dy2, dx2 = (int(t) for t in
                                      QPEL_TWO_SAMPLE_TBL[fx, fy])
        s1 = win[p1, :, 1 + iy + dy1:17 + iy + dy1,
                 1 + ix + dx1:17 + ix + dx1]
        s2 = win[p2, :, 1 + iy + dy2:17 + iy + dy2,
                 1 + ix + dx2:17 + ix + dx2]
        pred = (s1 + s2 + 1) >> 1
        cand = mv0.astype(np.int64) + np.array([dx, dy])
        c = (satd(src_mbs, pred)
             + lam * (bits[cand[:, 0] + off] + bits[cand[:, 1] + off]))
        if best is None:
            best, best_mv = c, cand
        else:
            better = c < best
            best = np.where(better, c, best)
            best_mv = np.where(better[:, None], cand, best_mv)
    return best_mv.astype(np.int32), best


def intra_cost_estimate(y: np.ndarray, mbw: int, mbh: int) -> np.ndarray:
    """Source-edge I16x16 SATD estimate per MB (scenecut; mirrors the
    device version in inter_device.p_frame_pipeline bit-exactly)."""
    from x264_tpu_torch.ops.reference import pixel as rpixel
    from x264_tpu_torch.ops.reference import predict as rpredict

    n = mbw * mbh
    mby = np.arange(n) // mbw
    mbx = np.arange(n) % mbw
    yp_ = np.pad(y.astype(np.int64), ((1, 0), (1, 0)), mode="edge")
    r16 = np.arange(16)
    top = yp_[(mby * 16)[:, None], (mbx * 16 + 1)[:, None] + r16[None, :]]
    left = yp_[(mby * 16 + 1)[:, None] + r16[None, :], (mbx * 16)[:, None]]
    tl = yp_[mby * 16, mbx * 16]
    at = mby > 0
    al = mbx > 0
    preds = rpredict.predict_16x16_all(top, left, tl, at, al)
    avail = rpredict.i16x16_mode_avail(at, al, at & al)
    src = (y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
           .reshape(n, 16, 16).astype(np.int64))
    costs = np.where(avail, rpixel.satd(src[:, None], preds), 1 << 30)
    return costs.min(axis=1).astype(np.int64)


def mc_luma_16x16(ref_pad: np.ndarray, mv: np.ndarray, mbw: int, mbh: int):
    """Fullpel-grid gather of 16x16 predictions for all MBs (mv qpel,
    multiples of 4 in the fullpel round-1 path)."""
    n = mbw * mbh
    preds = np.zeros((n, 16, 16), np.int64)
    for i in range(n):
        mby, mbx = divmod(i, mbw)
        y0 = PAD + mby * 16 + (int(mv[i, 1]) >> 2)
        x0 = PAD + mbx * 16 + (int(mv[i, 0]) >> 2)
        preds[i] = ref_pad[y0:y0 + 16, x0:x0 + 16]
    return preds


_DS4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int64)


def decimate_score_np(zz: np.ndarray) -> int:
    """Scalar JVT-B118 decimation score (reference common/quant.c:326):
    walk the zigzag levels from the top; |level|>1 scores 9, each
    |level|==1 adds _DS4[zero-run below it]."""
    idx = len(zz) - 1
    while idx >= 0 and zz[idx] == 0:
        idx -= 1
    score = 0
    while idx >= 0:
        if abs(int(zz[idx])) > 1:
            return 9
        idx -= 1
        run = 0
        while idx >= 0 and zz[idx] == 0:
            idx -= 1
            run += 1
        score += int(_DS4[min(run, 15)])
    return score


def encode_p_luma_mb(src: np.ndarray, pred: np.ndarray, qp: int):
    """Inter luma residual path: 4x4 DCT/quant, quadrant cbp, JVT-B118
    decimation (quadrant score < 4 or MB total < 6 zeroes the levels —
    reference encoder/macroblock.c:900-918).
    Returns (recon, ac_zz(16,16), nnz(16,), cbp_luma)."""
    res = src.astype(np.int64) - pred.astype(np.int64)
    blocks = transform.mb_luma_to_blocks(res)
    coefs = transform.dct4x4(blocks)
    lv = quant.quant4x4(coefs, qp, intra=False)
    quad_r = (np.arange(16) // 4 // 2) * 2 + (np.arange(16) % 4) // 2
    sc = np.array([decimate_score_np(z) for z in zigzag(lv)], np.int64)
    sc8 = np.array([sc[quad_r == q].sum() for q in range(4)])
    keep8 = (sc8 >= 4) & (sc8.sum() >= 6)
    lv = lv * keep8[quad_r][:, None, None]
    nnz = np.count_nonzero(lv.reshape(16, 16), axis=1).astype(np.int32)
    # quadrant of raster block r: (y4>=2)*2 + (x4>=2)
    quad = (np.arange(16) // 4 // 2) * 2 + (np.arange(16) % 4) // 2
    cbp = 0
    for q in range(4):
        if nnz[quad == q].any():
            cbp |= 1 << q
    ac_zz = zigzag(lv)
    deq = quant.dequant4x4(lv, qp)
    res_rec = transform.idct4x4(deq)
    recon = np.clip(pred.astype(np.int64) + transform.blocks_to_mb_luma(res_rec),
                    0, 255).astype(np.uint8)
    return recon, ac_zz.astype(np.int32), nnz, cbp


def encode_pframe(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  ref, qp, params, lam=None):
    """ref: ReconFrame with .y/.u/.v (padded planes). Returns
    (recon_y, recon_u, recon_v, FrameSyntax)."""
    h, w = y.shape
    mbw, mbh = w // 16, h // 16
    n = mbw * mbh

    ref_y_pad = expand_border(ref.y, PAD)
    ref_u_pad = expand_border(ref.u, PAD // 2)
    ref_v_pad = expand_border(ref.v, PAD // 2)

    qp_mb = np.broadcast_to(np.atleast_1d(qp).astype(np.int64), (n,))
    base_qp = int(qp_mb[0]) if lam is None else None
    lam = sad_lambda(base_qp) if lam is None else lam
    mv, mb_cost = full_search_16x16(y, ref_y_pad, params.me_range, lam)

    if params.subpel > 0:
        from x264_tpu_torch.ops.reference.mc import mc_luma_qpel_batched
        planes4 = np.stack(mc.hpel_planes(ref_y_pad))
        src_mbs = (y.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
                    .reshape(n, 16, 16).astype(np.int64))
        mv, mb_cost = subpel_refine(src_mbs, planes4, mv, lam,
                                    params.me_range, params.subpel,
                                    mbw, mbh)
        preds = mc_luma_qpel_batched(planes4, mv, mbw, mbh, PAD)
    else:
        preds = mc_luma_16x16(ref_y_pad, mv, mbw, mbh)

    syn = empty_syntax(mbw, mbh)
    syn.qp[:] = qp_mb
    syn.mv[:] = mv
    syn.ref[:] = 0
    syn.mb_cost = np.asarray(mb_cost, np.int64)
    syn.icost = intra_cost_estimate(y, mbw, mbh)

    ry = np.zeros_like(y)
    ru = np.zeros_like(u)
    rv = np.zeros_like(v)

    # batched-ish per-MB residual pass (the JAX tier batches this for real)
    cbp_l = np.zeros(n, np.int32)
    cbp_c = np.zeros(n, np.int32)
    for i in range(n):
        mby, mbx = divmod(i, mbw)
        y0, x0 = mby * 16, mbx * 16
        src = y[y0:y0 + 16, x0:x0 + 16]
        qp_i = int(qp_mb[i])
        qpc_i = chroma_qp(qp_i, params.chroma_qp_offset)
        recon, ac_zz, nnz, cl = encode_p_luma_mb(src, preds[i], qp_i)
        ry[y0:y0 + 16, x0:x0 + 16] = recon
        syn.luma_ac[i] = ac_zz
        syn.luma_nnz[i] = nnz
        cbp_l[i] = cl

        # chroma: prediction via normative 1/8-pel bilinear at the luma mv
        cy0, cx0 = mby * 8, mbx * 8
        cpred_u = mc.chroma_mc(ref_u_pad, int(mv[i, 0]), int(mv[i, 1]),
                               PAD // 2 + cy0, PAD // 2 + cx0, 8, 8)
        cpred_v = mc.chroma_mc(ref_v_pad, int(mv[i, 0]), int(mv[i, 1]),
                               PAD // 2 + cy0, PAD // 2 + cx0, 8, 8)
        csrc = [u[cy0:cy0 + 8, cx0:cx0 + 8], v[cy0:cy0 + 8, cx0:cx0 + 8]]
        crecons, cdc, cac, cnnz, cc = encode_chroma_mb(
            csrc, [cpred_u, cpred_v], qpc_i, intra=False)
        ru[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[0]
        rv[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[1]
        syn.chroma_dc[i] = cdc
        syn.chroma_ac[i] = cac
        syn.chroma_nnz[i] = cnnz
        cbp_c[i] = cc

    syn.cbp_luma[:] = cbp_l
    syn.cbp_chroma[:] = cbp_c

    # ---- intra-in-P fixup: SAME policy as the device tier
    # (inter_device.p_frame_pipeline) so the bitstreams stay identical:
    # source-edge estimate decides, parallel isolation (conflict pairs
    # L/R, U/D, UL/DR) guarantees intra MBs predict only from inter
    # recon, batched-math mode choice from the pure-inter recon plane ----
    from x264_tpu_torch.models.intra_frame import encode_i16x16_mb
    from x264_tpu_torch.ops.reference import pixel as rpixel
    from x264_tpu_torch.ops.reference import predict as rpredict

    cand = ((syn.icost + 8 * lam) < syn.mb_cost).reshape(mbh, mbw)

    def _sh(g, dy, dx):
        out = np.zeros_like(g)
        ys = slice(max(dy, 0), mbh + min(dy, 0))
        xs = slice(max(dx, 0), mbw + min(dx, 0))
        yd = slice(max(-dy, 0), mbh + min(-dy, 0))
        xd = slice(max(-dx, 0), mbw + min(-dx, 0))
        out[yd, xd] = g[ys, xs]
        return out

    iso = (cand & ~_sh(cand, 0, -1) & ~_sh(cand, 0, 1)
           & ~_sh(cand, -1, 0) & ~_sh(cand, 1, 0)
           & ~_sh(cand, -1, -1) & ~_sh(cand, 1, 1))
    # conflict-free lattice inside dense clusters (see inter_device)
    latt = ((np.arange(mbw)[None, :] + 2 * np.arange(mbh)[:, None])
            % 4) == 0
    keep = (iso | (cand & latt)).reshape(-1)
    intra_mb = np.zeros(n, bool)
    for i in np.nonzero(keep)[0]:
        mby, mbx = divmod(int(i), mbw)
        y0, x0 = mby * 16, mbx * 16
        at, al = mby > 0, mbx > 0
        top = (ry[y0 - 1, x0:x0 + 16].astype(np.int64) if at
               else np.zeros(16, np.int64))
        lft = (ry[y0:y0 + 16, x0 - 1].astype(np.int64) if al
               else np.zeros(16, np.int64))
        tl = int(ry[y0 - 1, x0 - 1]) if (at and al) else 0
        preds = rpredict.predict_16x16_all(
            top[None], lft[None], np.array([tl], np.int64),
            np.array([at]), np.array([al]))[0]
        avail = rpredict.i16x16_mode_avail(
            np.array([at]), np.array([al]), np.array([at and al]))[0]
        src = y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)
        costs = np.where(avail, rpixel.satd(src[None, None],
                                            preds[None])[0], 1 << 30)
        mode = int(np.argmin(costs))
        qp_i = int(qp_mb[i])
        recon, dc_zz, ac_zz, nnz, cl = encode_i16x16_mb(
            src, preds[mode], qp_i)
        ry[y0:y0 + 16, x0:x0 + 16] = recon
        syn.luma_dc[i] = dc_zz
        syn.luma_ac[i] = ac_zz
        syn.luma_nnz[i] = nnz
        cbp_l[i] = cl

        cy0, cx0 = mby * 8, mbx * 8
        ctop_u = (ru[cy0 - 1, cx0:cx0 + 8].astype(np.int64) if at
                  else np.zeros(8, np.int64))
        ctop_v = (rv[cy0 - 1, cx0:cx0 + 8].astype(np.int64) if at
                  else np.zeros(8, np.int64))
        clft_u = (ru[cy0:cy0 + 8, cx0 - 1].astype(np.int64) if al
                  else np.zeros(8, np.int64))
        clft_v = (rv[cy0:cy0 + 8, cx0 - 1].astype(np.int64) if al
                  else np.zeros(8, np.int64))
        ctl_u = int(ru[cy0 - 1, cx0 - 1]) if (at and al) else 0
        ctl_v = int(rv[cy0 - 1, cx0 - 1]) if (at and al) else 0
        cpreds_u = rpredict.predict_chroma_all(
            ctop_u[None], clft_u[None], np.array([ctl_u], np.int64),
            np.array([at]), np.array([al]))[0]
        cpreds_v = rpredict.predict_chroma_all(
            ctop_v[None], clft_v[None], np.array([ctl_v], np.int64),
            np.array([at]), np.array([al]))[0]
        cavail = rpredict.chroma_mode_avail(
            np.array([at]), np.array([al]), np.array([at and al]))[0]
        csrc_u = u[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int64)
        csrc_v = v[cy0:cy0 + 8, cx0:cx0 + 8].astype(np.int64)
        ccosts = np.where(
            cavail,
            rpixel.satd(csrc_u[None, None], cpreds_u[None])[0]
            + rpixel.satd(csrc_v[None, None], cpreds_v[None])[0], 1 << 30)
        cmode = int(np.argmin(ccosts))
        qpc_i = chroma_qp(qp_i, params.chroma_qp_offset)
        crecons, cdc, cac, cnnz, cc = encode_chroma_mb(
            [csrc_u, csrc_v], [cpreds_u[cmode], cpreds_v[cmode]],
            qpc_i, intra=True)
        ru[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[0]
        rv[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[1]
        syn.chroma_dc[i] = cdc
        syn.chroma_ac[i] = cac
        syn.chroma_nnz[i] = cnnz
        cbp_c[i] = cc

        intra_mb[i] = True
        syn.i16_mode[i] = mode
        syn.chroma_mode[i] = cmode
        syn.mb_cost[i] = int(costs[mode])

    syn.cbp_luma[:] = cbp_l
    syn.cbp_chroma[:] = cbp_c

    # ---- sequential host scan: skip classification + normative mvd ----
    mv_dec = np.zeros((n, 2), np.int32)   # decoded-state mvs
    ref_dec = np.full(n, -1, np.int32)
    for i in range(n):
        if intra_mb[i]:
            syn.mb_class[i] = MB_I16
            mv_dec[i] = 0
            ref_dec[i] = -1
            continue
        mby, mbx = divmod(i, mbw)
        skip_mv = mvpred.pskip_mv(mv_dec, ref_dec, mbx, mby, mbw)
        if (cbp_l[i] == 0 and cbp_c[i] == 0
                and mv[i, 0] == skip_mv[0] and mv[i, 1] == skip_mv[1]):
            syn.mb_class[i] = MB_PSKIP
            mv_dec[i] = skip_mv
            ref_dec[i] = 0
            continue
        mvp = mvpred.predict_mv_16x16(mv_dec, ref_dec, mbx, mby, mbw, 0)
        syn.mb_class[i] = MB_P16
        syn.mvd[i] = mv[i] - mvp
        mv_dec[i] = mv[i]
        ref_dec[i] = 0

    return ry, ru, rv, syn
