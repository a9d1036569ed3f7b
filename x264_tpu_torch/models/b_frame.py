"""B-frame core: bi-predictive 16x16 encoding with temporal direct mode
(port of x264_tpu/models/b_frame_device.py: ``b_frame_core``,
``b_pair_core`` and ``_b_body`` on the single-reference-per-list path,
CABAC or CAVLC, with the adaptive 8x8 transform (CABAC only, as in the
reference) and trellis when asked, and the col_ref gate on direct when
the anchors use several references).

Temporal direct (8.4.1.2.3) derives every MB's direct mvs from the
colocated quadrant of the future anchor's motion field, so the whole B
frame is one batch over all MBs: fullpel ME per list (kernel
``kernels/esa16``), subpel refinement (none at ``subpel`` 0), direct /
L0 / L1 / bi predictions
and the SATD + lambda-bits mode decision, the inter residual, the
intra-in-B I16x16 escape, the per-list MVPs and the CABAC blob or the
CAVLC packed words.  The
slice signals direct_spatial_mv_pred_flag = 0.

Parity anchors: reference encoder/analyse.c B paths, common/mvpred.c
direct derivation."""

from __future__ import annotations

import torch

from x264_tpu_torch.models.inter import _neigh, select_transform_8x8
from x264_tpu_torch.models.intra import pick_mode, qp_per_mb
from x264_tpu_torch.models.residual import (encode_chroma, encode_i16_luma,
                                            encode_p_luma, trellis_args)
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.ops.cavlc import cavlc_blob, residual_slots
from x264_tpu_torch.ops.entropy_pack import cabac_blob
from x264_tpu_torch.ops.header import (B_BI, B_DIRECT, B_L0, B_L1,
                                       header_slots_b, mvp_for_list, shifted)
from x264_tpu_torch.ops.mc import (hpel_planes, mc_chroma_uv_quad,
                                   mc_luma_qpel, mc_luma_qpel_quad, pad_edge)
from x264_tpu_torch.ops.me import full_search_16x16, subpel_refine
from x264_tpu_torch.state import PAD, tables

_I32 = torch.int32
_BIG = 1 << 30


def _anchors(l0_y, l0_u, l0_v, l1_y, l1_u, l1_v):
    """The padded anchor planes (PAD luma, PAD//2 chroma) and the luma
    half-pel planes, made once per anchor pair."""
    l0y, l1y = pad_edge(l0_y, PAD), pad_edge(l1_y, PAD)
    return dict(l0y=l0y, l1y=l1y, planes0=hpel_planes(l0y),
                planes1=hpel_planes(l1y),
                l0u=pad_edge(l0_u, PAD // 2), l0v=pad_edge(l0_v, PAD // 2),
                l1u=pad_edge(l1_u, PAD // 2), l1v=pad_edge(l1_v, PAD // 2))


def b_frame_core(y, u, v, l0_y, l0_u, l0_v, l1_y, l1_u, l1_v, col_mv,
                 col_intra, dist_scale: int, qp, lam: int, mbw: int,
                 mbh: int, me_range: int, cqp_off: int, lv_cap: int = 0,
                 subpel: int = 2, decimate: bool = True,
                 t8_mode: bool = False, trellis_tbl=None, col_ref=None,
                 n_words: int = 0):
    """Encode one B frame.  y/u/v uint8 source planes; l0_* / l1_* the
    past and future anchors' recon planes; col_mv (N,4,2) the future
    anchor's quadrant motion field, col_intra (N,) bool its intra MBs;
    dist_scale the temporal-direct DistScaleFactor (8.4.1.2.3); qp int;
    lam int; t8_mode: the adaptive 8x8 transform; trellis_tbl: the
    ``ops/trellis.frame_trellis`` bundle or None; col_ref (N,4) the
    future anchor's quadrant ref_idx or None; n_words > 0 codes CAVLC
    into that many words per MB (``host_blob`` = words, nbits, mb_class,
    mb_cost), else lv_cap sizes the CABAC blob.  With multi-reference
    anchors a colocated quadrant that referenced an older anchor
    (ref_idx > 0) would point temporal direct outside the B slice's
    one-entry list0, so such MBs never choose direct.  Returns the
    per-MB syntax tensors, the pre-deblock recon planes and
    ``host_blob``."""
    a = _anchors(l0_y, l0_u, l0_v, l1_y, l1_u, l1_v)
    mv0, c0 = full_search_16x16(y, a["l0y"], lam, me_range, mbw, mbh)
    mv1, c1 = full_search_16x16(y, a["l1y"], lam, me_range, mbw, mbh)
    return _b_body(y, u, v, a, col_mv, col_intra, dist_scale, qp, lam,
                   mv0, c0, mv1, c1, mbw=mbw, mbh=mbh, me_range=me_range,
                   cqp_off=cqp_off, lv_cap=lv_cap, subpel=subpel,
                   decimate=decimate, t8_mode=t8_mode,
                   trellis_tbl=trellis_tbl, col_ref=col_ref,
                   n_words=n_words)


def b_pair_core(ys, us, vs, l0_y, l0_u, l0_v, l1_y, l1_u, l1_v, col_mv,
                col_intra, dist_scales, qps, lam: int, mbw: int, mbh: int,
                me_range: int, cqp_off: int, lv_cap: int = 0,
                subpel: int = 2, decimate: bool = True,
                t8_mode: bool = False, trellis_tbl=None, col_ref=None,
                n_words: int = 0):
    """Both B frames of a mini-GOP: ys/us/vs the two frames' planes,
    dist_scales/qps their two values, lam and the trellis bundle
    shared.  The padded anchors
    and half-pel planes are made once; the four fullpel searches run in
    the reference's order (B1-L0, B1-L1, B2-L0, B2-L1); then the body
    per frame.  Returns the two frames' output dicts; each equals
    ``b_frame_core`` on that frame with the same lam."""
    a = _anchors(l0_y, l0_u, l0_v, l1_y, l1_u, l1_v)
    fp = [full_search_16x16(ys[i], ref, lam, me_range, mbw, mbh)
          for i in range(2) for ref in (a["l0y"], a["l1y"])]
    return [_b_body(ys[i], us[i], vs[i], a, col_mv, col_intra,
                    dist_scales[i], qps[i], lam, *fp[2 * i], *fp[2 * i + 1],
                    mbw=mbw, mbh=mbh, me_range=me_range, cqp_off=cqp_off,
                    lv_cap=lv_cap, subpel=subpel, decimate=decimate,
                    t8_mode=t8_mode, trellis_tbl=trellis_tbl,
                    col_ref=col_ref, n_words=n_words)
            for i in range(2)]


def _b_body(y, u, v, a, col_mv, col_intra, dist_scale: int, qp, lam: int,
            mv0_fp, cost0_fp, mv1_fp, cost1_fp, mbw: int, mbh: int,
            me_range: int, cqp_off: int, lv_cap: int, subpel: int,
            decimate: bool, t8_mode: bool, trellis_tbl, col_ref=None,
            n_words: int = 0):
    """One B frame from the shared anchor work ``a`` and the frame's
    fullpel ME results."""
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    src_mbs = T.plane_to_mbs(y.to(_I32), mbh, mbw, 16)

    # ---- temporal direct mvs (8.4.1.2.3), per quadrant ----
    mvcol = torch.where(col_intra[:, None, None], 0, col_mv.to(_I32))
    dmv0 = (dist_scale * mvcol + 128) >> 8
    dmv1 = dmv0 - mvcol
    # clamp into the reachable window (interpolation padding)
    lim = 4 * (me_range + 3)
    dmv0, dmv1 = dmv0.clamp(-lim, lim), dmv1.clamp(-lim, lim)

    def me(ref_pad, planes, mv, cost):
        if subpel > 0:
            return subpel_refine(src_mbs, ref_pad, mv, lam, me_range, subpel,
                                 mbw, mbh, return_pred=True)
        # fullpel only: the search's mv and cost, the block at the mv
        return mv, cost, mc_luma_qpel(planes, mv, mbw, mbh, PAD)

    mv0, cost0, pred0 = me(a["l0y"], a["planes0"], mv0_fp, cost0_fp)
    mv1, cost1, pred1 = me(a["l1y"], a["planes1"], mv1_fp, cost1_fp)
    pred_bi = (pred0 + pred1 + 1) >> 1
    pred_dir = (mc_luma_qpel_quad(a["planes0"], dmv0, mbw, mbh, PAD)
                + mc_luma_qpel_quad(a["planes1"], dmv1, mbw, mbh, PAD)
                + 1) >> 1

    # mode decision (SATD + mv bits + ue(mb_type) bits, analyse.c B path);
    # argmin takes the first least cost in the order direct, L0, L1, bi
    cost_dir = P.satd(src_mbs, pred_dir) + lam * 1
    if col_ref is not None:
        # multi-reference anchors: direct is barred where a colocated
        # quadrant referenced an older anchor (see b_frame_core)
        dir_ok = (col_ref.to(_I32) == 0).all(dim=1)
        cost_dir = torch.where(dir_ok, cost_dir, 1 << 29)
    cost_bi = (P.satd(src_mbs, pred_bi) + (cost0 - P.satd(src_mbs, pred0))
               + (cost1 - P.satd(src_mbs, pred1)) + lam * 5)
    costs = torch.stack([cost_dir, cost0 + lam * 3, cost1 + lam * 3,
                         cost_bi])
    bmode = torch.argmin(costs, dim=0).to(_I32)

    is_dir = bmode == B_DIRECT
    use0 = (bmode == B_L0) | (bmode == B_BI)
    use1 = (bmode == B_L1) | (bmode == B_BI)
    # quadrant-grain final motion: explicit modes broadcast their one mv
    fmv0 = torch.where(use0[:, None, None], mv0[:, None].expand(n, 4, 2),
                       dmv0)
    fmv1 = torch.where(use1[:, None, None], mv1[:, None].expand(n, 4, 2),
                       dmv1)
    any0, any1 = use0 | is_dir, use1 | is_dir
    pred = torch.where(is_dir[:, None, None], pred_dir,
           torch.where((bmode == B_L0)[:, None, None], pred0,
           torch.where((bmode == B_L1)[:, None, None], pred1, pred_bi)))

    tr4, tr8, tr16, trc = trellis_args(trellis_tbl)
    recon_y_mbs, ac_zz, nnz, cbp_l = encode_p_luma(src_mbs, pred, qp,
                                                   trellis=tr4,
                                                   decimate=decimate)
    nnz_deblock = nnz
    t8 = torch.zeros(n, dtype=torch.bool, device=dev)
    if t8_mode and not n_words:
        # the P core's true-cost transform size (reference analyse.c
        # x264_mb_analyse_transform for B slices), CABAC only as there:
        # the CAVLC B header writes the flag as 0
        (t8, recon_y_mbs, ac_zz, nnz, nnz_deblock,
         cbp_l) = select_transform_8x8(src_mbs, pred, qp, lam, recon_y_mbs,
                                       ac_zz, nnz, cbp_l, trellis8=tr8,
                                       decimate=decimate)

    # chroma: per-list MC at the final mvs, averaged per mode
    cu0, cv0 = mc_chroma_uv_quad(a["l0u"], a["l0v"], fmv0, mbw, mbh,
                                 PAD // 2)
    cu1, cv1 = mc_chroma_uv_quad(a["l1u"], a["l1v"], fmv1, mbw, mbh,
                                 PAD // 2)
    both = (any0 & any1)[:, None, None]
    one0 = any0[:, None, None]
    cpred_u = torch.where(both, (cu0 + cu1 + 1) >> 1,
                          torch.where(one0, cu0, cu1))
    cpred_v = torch.where(both, (cv0 + cv1 + 1) >> 1,
                          torch.where(one0, cv0, cv1))
    src_u = T.plane_to_mbs(u.to(_I32), mbh, mbw, 8)
    src_v = T.plane_to_mbs(v.to(_I32), mbh, mbw, 8)
    ru_mbs, rv_mbs, cdc, cac, cnnz, cbp_c = encode_chroma(
        src_u, src_v, cpred_u, cpred_v, qpc, intra=False, decimate=decimate,
        trellis=trc)

    # ---- intra-in-B: the I16x16 escape (analyse.c:3180-3259's intra
    # probe in B).  A source-edge cost estimate picks candidates, the
    # isolation lattice keeps those whose prediction reads no other
    # candidate's recon, and the kept MBs predict from the pure-inter
    # recon.  The reference runs the fix-up under lax.cond only when an
    # MB is kept; computing it always selects the same values (the masks
    # are all false otherwise) and needs no device-to-host sync. ----
    mb = torch.arange(n, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    yp_ = pad_edge(y.to(_I32), 1)[:-1, :-1]
    r16 = torch.arange(16, device=dev)
    stop = yp_[(mby * 16)[:, None], (mbx * 16 + 1)[:, None] + r16[None, :]]
    sleft = yp_[(mby * 16 + 1)[:, None] + r16[None, :], (mbx * 16)[:, None]]
    stl = yp_[mby * 16, mbx * 16]
    at, al = mby > 0, mbx > 0
    iavail = PR.i16x16_mode_avail(at, al, at & al)
    _, icost_src, _ = pick_mode(
        src_mbs, PR.predict_16x16_all(stop, sleft, stl, at, al), iavail)
    cand = (icost_src + 8 * lam) < costs.min(dim=0).values
    cg = cand.reshape(mbh, mbw)
    iso = cg.clone()
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, 1)):
        iso &= ~shifted(cg, dy, dx, False)[0]
    xxg = torch.arange(mbw, device=dev)[None, :]
    yyg = torch.arange(mbh, device=dev)[:, None]
    latt = ((xxg + 2 * yyg) % 4) == 0
    intra_mask = (iso | (cg & latt)).reshape(n)

    ry_pl = T.mbs_to_plane(recon_y_mbs, mbh, mbw, 16)
    ru_pl = T.mbs_to_plane(ru_mbs, mbh, mbw, 8)
    rv_pl = T.mbs_to_plane(rv_mbs, mbh, mbw, 8)
    itop, ileft, itl = _neigh(ry_pl, 16, mbw, mbh)
    imode, _, ipred = pick_mode(
        src_mbs, PR.predict_16x16_all(itop, ileft, itl, at, al), iavail)
    irec, idc, iac, innz, icbp_l = encode_i16_luma(src_mbs, ipred, qp,
                                                   trellis=tr16)
    ctop_u, cleft_u, ctl_u = _neigh(ru_pl, 8, mbw, mbh)
    ctop_v, cleft_v, ctl_v = _neigh(rv_pl, 8, mbw, mbh)
    cpreds_u = PR.predict_chroma_all(ctop_u, cleft_u, ctl_u, at, al)
    cpreds_v = PR.predict_chroma_all(ctop_v, cleft_v, ctl_v, at, al)
    ccosts = torch.where(PR.chroma_mode_avail(at, al, at & al),
                         P.satd(src_u[:, None], cpreds_u)
                         + P.satd(src_v[:, None], cpreds_v), _BIG)
    cmode = torch.argmin(ccosts, dim=1)
    icr_u, icr_v, icdc, icac, icnnz, icbp_c = encode_chroma(
        src_u, src_v, cpreds_u[mb, cmode], cpreds_v[mb, cmode], qpc,
        intra=True, trellis=trc)

    mk1 = intra_mask[:, None]
    mk2 = intra_mask[:, None, None]
    mk3 = intra_mask[:, None, None, None]
    luma_dc = torch.where(mk1, idc, 0)
    ac_zz = torch.where(mk2, iac, ac_zz)
    nnz = torch.where(mk1, innz, nnz)
    cbp_l = torch.where(intra_mask, icbp_l, cbp_l)
    cdc = torch.where(mk2, icdc, cdc)
    cac = torch.where(mk3, icac, cac)
    cnnz = torch.where(mk2, icnnz, cnnz)
    cbp_c = torch.where(intra_mask, icbp_c, cbp_c)
    i16_mode = torch.where(intra_mask, imode, 0)
    chroma_mode = torch.where(intra_mask, cmode.to(_I32), 0)
    recon_y_mbs = torch.where(mk2, irec, recon_y_mbs)
    ru_mbs = torch.where(mk2, icr_u, ru_mbs)
    rv_mbs = torch.where(mk2, icr_v, rv_mbs)
    nnz_deblock = torch.where(mk1, nnz, nnz_deblock)
    t8 = t8 & ~intra_mask & (cbp_l > 0)

    # intra MBs leave the inter signalling entirely
    use0, use1 = use0 & ~intra_mask, use1 & ~intra_mask
    any0, any1 = any0 & ~intra_mask, any1 & ~intra_mask

    # ---- mvd against the per-list median MVP; skip = direct, no
    # residual.  The MVP reads the neighbours' quadrant mvs, so direct
    # neighbours contribute their own quadrant. ----
    mvd0 = torch.where(use0[:, None], mv0 - mvp_for_list(fmv0, any0, mbw,
                                                         mbh), 0)
    mvd1 = torch.where(use1[:, None], mv1 - mvp_for_list(fmv1, any1, mbw,
                                                         mbh), 0)
    is_skip = is_dir & (cbp_l == 0) & (cbp_c == 0) & ~intra_mask
    # 0 = intra (I16), 2 = coded inter, 3 = skip
    mb_class = torch.where(intra_mask, 0,
                           torch.where(is_skip, 3, 2)).to(_I32)
    mb_cost = torch.minimum(cost0, cost1)
    out = dict(
        mb_class=mb_class, bmode=bmode, mv0=fmv0, mv1=fmv1, any0=any0,
        any1=any1, mvd0=mvd0.to(_I32), mvd1=mvd1.to(_I32),
        i16_mode=i16_mode, chroma_mode=chroma_mode, luma_dc=luma_dc,
        luma_ac=ac_zz, chroma_dc=cdc, chroma_ac=cac, chroma_nnz=cnnz,
        luma_nnz=nnz, nnz_deblock=nnz_deblock, t8=t8, cbp_luma=cbp_l,
        cbp_chroma=cbp_c, qp_mb=qp, mb_cost=mb_cost,
        recon_y=T.mbs_to_plane(recon_y_mbs, mbh, mbw, 16).to(torch.uint8),
        recon_u=T.mbs_to_plane(ru_mbs, mbh, mbw, 8).to(torch.uint8),
        recon_v=T.mbs_to_plane(rv_mbs, mbh, mbw, 8).to(torch.uint8))
    if not n_words:
        out["host_blob"] = cabac_blob(
            luma_dc, ac_zz, cdc, cac, mb_class, out["mvd0"], i16_mode,
            chroma_mode, cbp_l, cbp_c, qp, mb_cost,
            torch.zeros(n, dtype=_I32, device=dev), K=lv_cap, bmode=bmode,
            mvd1=out["mvd1"], t8=t8)
        return out
    res_vals, res_lens = residual_slots(luma_dc, ac_zz, nnz, cdc, cac, cnnz,
                                        cbp_l, cbp_c, intra_mask, mbw, mbh)
    hv, hl = header_slots_b(bmode, is_skip, out["mvd0"], out["mvd1"], cbp_l,
                            cbp_c, qp, t8_mode=t8_mode, intra=intra_mask,
                            i16_mode=i16_mode, chroma_mode=chroma_mode)
    out["host_blob"] = cavlc_blob(hv, hl, res_vals, res_lens, n_words,
                                  (mb_class, mb_cost))
    return out
