"""P-frame core: the whole per-frame pixel pipeline — exhaustive fullpel
ME on each list0 reference, subpel refinement, explicit weighted
prediction, luma/chroma MC, residual (the adaptive 8x8 transform and
trellis when asked), reconstruction, intra-in-P, P_Skip/MVP
classification and the CABAC blob or the CAVLC packed words — over all
MBs at once, and the periodic-intra-refresh bar when asked (port of
x264_tpu/models/inter_device.py: ``p_frame_pipeline`` with one or more
references, with or without weights, P16x16 only or with P8x8
partitions, ``p_entropy_tail``, ``p_frame_core`` and the band entry of
a multi-slice frame, ``p_band_core``; the bar is
``kernels/pir_column``).  The reference runs the
partition path as two device programs to dodge a TPU miscompile; here it
is one eager pass."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from x264_tpu_torch.kernels.pir_column import pir_column_pass
from x264_tpu_torch.models.intra import pick_mode, qp_per_mb
from x264_tpu_torch.models.residual import (encode_chroma, encode_i16_luma,
                                            encode_p_luma, encode_p_luma_t8,
                                            trellis_args)
from x264_tpu_torch.models.syntax import MB_P16, empty_syntax
from x264_tpu_torch.models.weightp import apply_weights
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.ops.cavlc import cavlc_blob, residual_slots
from x264_tpu_torch.ops.entropy_pack import cabac_blob
from x264_tpu_torch.ops.header import (MB_PSKIP_D, classify_p,
                                       classify_p_parts, header_slots,
                                       header_slots_parts, shifted)
from x264_tpu_torch.ops.mc import (mc_chroma_uv, mc_chroma_uv_quad,
                                  mc_luma_fullpel, mc_luma_qpel, pad_edge)
from x264_tpu_torch.ops.me import full_search_16x16, subpel_refine
from x264_tpu_torch.ops.me_parts import (choose_shape, full_search_parts,
                                         subpel_refine_parts)
from x264_tpu_torch.state import PAD, sad_lambda, tables

_I32 = torch.int32
_BIG = 1 << 30


def _te_ref_bits(num_ref: int) -> np.ndarray:
    """te() bit count per ref_idx (CAVLC cost model for ref selection);
    copied from x264_tpu/models/inter_device.py."""
    if num_ref <= 1:
        return np.zeros(1, np.int32)
    if num_ref == 2:
        return np.ones(2, np.int32)
    return np.array([2 * int(k + 1).bit_length() - 1
                     for k in range(num_ref)], np.int32)


def _neigh(plane, s: int, mbw: int, mbh: int):
    """(top (N,s), left (N,s), topleft (N,)) of every sxs tile from
    strided slices of the zero-padded plane."""
    n = mbw * mbh
    tp = F.pad(plane, (0, 0, 1, 0))[0::s][:mbh]
    lp = F.pad(plane, (1, 0, 0, 0))[:, 0::s][:, :mbw]
    tlv = F.pad(plane, (1, 0, 1, 0))[0::s, 0::s][:mbh, :mbw]
    return (tp.reshape(n, s),
            lp.reshape(mbh, s, mbw).permute(0, 2, 1).reshape(n, s),
            tlv.reshape(n))


def _cavlc_bits_proxy(ac):
    """Per-MB CAVLC rate estimate over (N, B, 16) zigzag levels: sum of
    (2*bit_length(|l|) + 1) per nonzero level — the exp-golombish cost
    the transform-size decision trades against SSD (the non-RDO analog
    of reference encoder/analyse.c x264_mb_analyse_transform)."""
    a = ac.to(_I32).abs()
    nbits = torch.zeros_like(a)
    for k in range(14):                      # levels fit in 14 bits
        nbits += (a >= (1 << k)).to(_I32)
    return (2 * nbits + (a > 0).to(_I32)).sum((-1, -2), dtype=_I32)


def select_transform_8x8(src_mbs, pred, qp, lam: int, recon4, ac4, nnz4,
                         cbp4, trellis8=None, decimate: bool = True):
    """Per-MB adaptive transform size: encode the 8x8 alternative and pick
    by SSD + lambda2*rate (lambda2 = max(lam*lam*9//10, 1) on the core's
    SAD lambda).  Returns (t8 (N,) bool, recon, ac_zz, nnz, nnz_deblock,
    cbp_luma)."""
    rec8, ac8, nnz8, nnzdb8, cbp8 = encode_p_luma_t8(
        src_mbs, pred, qp, trellis=trellis8, decimate=decimate)
    lam2 = max(lam * lam * 9 // 10, 1)
    cost4 = P.ssd(src_mbs, recon4) + lam2 * _cavlc_bits_proxy(ac4)
    cost8 = P.ssd(src_mbs, rec8) + lam2 * _cavlc_bits_proxy(ac8)
    sel8 = cost8 < cost4
    # an all-zero 8x8 winner is emitted as a zero-residual 4x4 MB (the
    # flag is only written when cbp_luma > 0 and is inferred 0 otherwise)
    t8 = sel8 & (cbp8 > 0)
    m1, m2 = sel8[:, None], sel8[:, None, None]
    return (t8, torch.where(m2, rec8, recon4), torch.where(m2, ac8, ac4),
            torch.where(m1, nnz8, nnz4), torch.where(m1, nnzdb8, nnz4),
            torch.where(sel8, cbp8, cbp4))


def p_frame_pipeline(y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp,
                     lam: int, mbw: int, mbh: int, me_range: int,
                     cqp_off: int, subpel: int, lv_cap: int = 0,
                     parts: bool = False, decimate: bool = True,
                     t8: bool = False, trellis_tbl=None, wts=None,
                     n_words: int = 0, pir_ncols: int = 0, pir_col=None,
                     pir_bound=None, res_slots: bool = False):
    """P-frame pipeline on pre-padded reference planes (PAD luma, PAD//2
    chroma): one reference (H, W) or stacked (K, H, W) in list0 order,
    most recent first.  y/u/v uint8 source planes; qp int or per-MB (N,);
    lam int; subpel 0 keeps the fullpel search's mvs and costs (P16x16
    only), 1-2 refine them to half- or quarter-pel; parts: P8x8
    partitions (16x16/16x8/8x16/8x8 per MB); t8: the
    adaptive 8x8 transform; trellis_tbl: the ``ops/trellis.frame_trellis``
    bundle or None; wts: (K, 2) int32 [weight, offset] per reference
    (``models/weightp``) or None; n_words > 0 codes CAVLC into that many
    words per MB (``host_blob`` = words, nbits, mb_class, mb_cost,
    icost), else lv_cap > 0 sizes the CABAC blob, else (the host-syntax
    path) there is no blob, and with ``res_slots`` the CAVLC residual
    slot grids ``res_vals`` and ``res_lens`` come back.  pir_ncols > 0
    codes the periodic-intra-refresh bar (reference
    encoder/encoder.c:3626): the
    pir_ncols MB columns from pir_col on as I16x16, after the intra-in-P
    fix-up; MBs left of the bar predict only from the reference's
    refreshed region, left of pir_bound (px), through a clamp of their
    mvx (encoder/analyse.c:340), and the bar and the MBs right of it take
    no intra-in-P.  Returns the per-MB syntax tensors (ref_mb each MB's
    list0 ref_idx), pre-deblock recon planes and ``host_blob``; with
    partitions also shape, mv8, ref8 and mvd_part."""
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    src_mbs = T.plane_to_mbs(y.to(_I32), mbh, mbw, 16)
    if ref_y_pad.dim() == 2:
        ref_y_pad, ref_u_pad, ref_v_pad = (ref_y_pad[None], ref_u_pad[None],
                                           ref_v_pad[None])
    n_refs = ref_y_pad.shape[0]
    refbits = _te_ref_bits(n_refs)
    # one reference: its plane, as before; several: the stack and each
    # MB's ref_idx
    multi = n_refs > 1

    def stack_or_one(planes):
        return planes if multi else planes[0]

    ref = torch.zeros(n, dtype=_I32, device=dev)
    pir = pir_ncols > 0
    mbx_of = torch.arange(n, dtype=_I32, device=dev) % mbw

    def pir_clamp_mvx(mvx, x0_px, width: int):
        """Clamp the qpel mvx of the units left of the bar whose left edge
        is x0_px and width ``width`` px, so that their interpolation
        window (the taps and the subpel margin, 8 px) stays left of
        pir_bound."""
        maxq = 4 * (pir_bound - x0_px - width - 8)
        lim = (mbx_of < pir_col).reshape((n,) + (1,) * (mvx.dim() - 1))
        return torch.where(lim, torch.minimum(mvx, maxq), mvx)

    if parts:
        # one exhaustive pass per reference gives all nine unit argmins;
        # a later reference takes an MB only on a strictly lower 16x16
        # unit cost (plus its te() bits), and then brings all nine units;
        # the shape is decided at fullpel and the subpel refine runs at
        # quadrant granularity with partition-pooled costs (me_parts.py)
        units = best16 = None
        for k in range(n_refs):
            u_k = full_search_parts(y, ref_y_pad[k], lam, me_range, mbw, mbh)
            c16_k = u_k["cost_f"] + lam * int(refbits[k])
            if units is None:
                units, best16 = u_k, c16_k
                continue
            better = c16_k < best16
            best16 = torch.where(better, c16_k, best16)
            ref = torch.where(better, k, ref)
            units = {key: torch.where(
                better.reshape((n,) + (1,) * (u_k[key].dim() - 1)),
                u_k[key], units[key]) for key in units}
        shape, mv8, _ = choose_shape(units, lam)
        if pir:
            qx_px = mbx_of[:, None] * 16 + torch.tensor(
                [0, 8, 0, 8], dtype=_I32, device=dev)[None, :]
            mv8 = torch.stack([pir_clamp_mvx(mv8[..., 0], qx_px, 8),
                               mv8[..., 1]], dim=-1)
        mv8, part_costs, pred = subpel_refine_parts(
            src_mbs, mv8, shape, lam, me_range, subpel, mbw, mbh,
            stack_or_one(ref_y_pad), ref_idx=ref if multi else None)
        mb_cost = part_costs.sum(1, dtype=_I32)
        mv = mv8[:, 0]
    else:
        # fullpel search per reference; each MB takes the least cost plus
        # its ref's te() bits, a later ref only when strictly lower
        mv = best = None
        for k in range(n_refs):
            mv_k, cost_k = full_search_16x16(y, ref_y_pad[k], lam, me_range,
                                             mbw, mbh)
            cost_k = cost_k + lam * int(refbits[k])
            if mv is None:
                mv, best = mv_k, cost_k
                continue
            better = cost_k < best
            best = torch.where(better, cost_k, best)
            mv = torch.where(better[:, None], mv_k, mv)
            ref = torch.where(better, k, ref)
        if pir:
            mv = torch.stack([pir_clamp_mvx(mv[:, 0], mbx_of * 16, 16),
                              mv[:, 1]], dim=1)
        if subpel > 0:
            mv, mb_cost, pred = subpel_refine(
                src_mbs, stack_or_one(ref_y_pad), mv, lam, me_range, subpel,
                mbw, mbh, return_pred=True, ref_idx=ref if multi else None)
        elif not multi:
            # fullpel only: the search's cost, the block at the mv
            mb_cost = best
            pred = mc_luma_fullpel(ref_y_pad[0], mv, mbw, mbh, PAD)
        else:
            # fullpel from each MB's reference: the stacked planes as the
            # four half-pel planes of each reference (the reference's
            # broadcast), gathered at each MB's ref_idx
            mb_cost = best
            pred = mc_luma_qpel(
                ref_y_pad.to(_I32)[:, None].expand(-1, 4, -1, -1), mv, mbw,
                mbh, PAD, ref_idx=ref)
    if wts is not None:
        # explicit weighted prediction (8.4.2.3.3: interpolate, then
        # weight); the search stayed unweighted.  P_Skip MBs use this
        # prediction too.
        pred = apply_weights(pred, wts, ref)
    tr4, tr8, tr16, trc = trellis_args(trellis_tbl)
    recon_y_mbs, ac_zz, nnz, cbp_l = encode_p_luma(src_mbs, pred, qp,
                                                   trellis=tr4,
                                                   decimate=decimate)
    nnz_deblock = nnz
    t8_flag = torch.zeros(n, dtype=torch.bool, device=dev)
    if t8:
        (t8_flag, recon_y_mbs, ac_zz, nnz, nnz_deblock,
         cbp_l) = select_transform_8x8(src_mbs, pred, qp, lam, recon_y_mbs,
                                       ac_zz, nnz, cbp_l, trellis8=tr8,
                                       decimate=decimate)

    if parts:
        pred_u, pred_v = mc_chroma_uv_quad(
            stack_or_one(ref_u_pad), stack_or_one(ref_v_pad), mv8, mbw, mbh,
            PAD // 2, ref_idx=ref if multi else None)
    else:
        pred_u, pred_v = mc_chroma_uv(
            stack_or_one(ref_u_pad), stack_or_one(ref_v_pad), mv, mbw, mbh,
            PAD // 2, ref_idx=ref if multi else None)
    src_u = T.plane_to_mbs(u.to(_I32), mbh, mbw, 8)
    src_v = T.plane_to_mbs(v.to(_I32), mbh, mbw, 8)
    ru_mbs, rv_mbs, cdc, cac, cnnz, cbp_c = encode_chroma(
        src_u, src_v, pred_u, pred_v, qpc, intra=False, decimate=decimate,
        trellis=trc)

    # source-edge intra cost estimate (scenecut + the intra-in-P
    # decision): source pixels as neighbours, so it is fully parallel
    mb = torch.arange(n, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    yp_ = pad_edge(y.to(_I32), 1)[:-1, :-1]
    r16 = torch.arange(16, device=dev)
    top = yp_[(mby * 16)[:, None], (mbx * 16 + 1)[:, None] + r16[None, :]]
    left = yp_[(mby * 16 + 1)[:, None] + r16[None, :], (mbx * 16)[:, None]]
    tl = yp_[mby * 16, mbx * 16]
    at, al = mby > 0, mbx > 0
    _, icost, _ = pick_mode(src_mbs, PR.predict_16x16_all(top, left, tl,
                                                          at, al),
                            PR.i16x16_mode_avail(at, al, at & al))

    # intra-in-P (I16x16 MBs in P slices): a candidate is kept when no
    # neighbour it would predict from is also intra (isolation), or on a
    # conflict-free lattice inside candidate clusters; every kept MB then
    # predicts from the pure-inter recon planes
    cand = (icost + 8 * lam) < mb_cost
    if pir:
        # the fix-up predicts from the recon before the bar, the decoder
        # from the bar's: keep the bar and the MBs right of it (whose
        # left and top-left neighbours are bar MBs) out
        in_bar = (mbx_of >= pir_col) & (mbx_of < pir_col + pir_ncols)
        cand = cand & ~in_bar & (mbx_of != pir_col + pir_ncols)
    cg = cand.reshape(mbh, mbw)
    iso = cg.clone()
    for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0), (-1, -1), (1, 1)):
        iso &= ~shifted(cg, dy, dx, False)[0]
    xxg = torch.arange(mbw, device=dev)[None, :]
    yyg = torch.arange(mbh, device=dev)[:, None]
    latt = ((xxg + 2 * yyg) % 4) == 0
    intra_mask = (iso | (cg & latt)).reshape(n)

    # the reference runs this fixup under lax.cond only when some MB is
    # kept; computing it always selects the same values (the masks are
    # all false otherwise) and needs no device-to-host sync
    ry_pl = T.mbs_to_plane(recon_y_mbs, mbh, mbw, 16)
    ru_pl = T.mbs_to_plane(ru_mbs, mbh, mbw, 8)
    rv_pl = T.mbs_to_plane(rv_mbs, mbh, mbw, 8)
    itop, ileft, itl = _neigh(ry_pl, 16, mbw, mbh)
    imode, icost_fix, ipred = pick_mode(
        src_mbs, PR.predict_16x16_all(itop, ileft, itl, at, al),
        PR.i16x16_mode_avail(at, al, at & al))
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
    nnz, nnz_deblock = (torch.where(mk1, innz, nnz),
                        torch.where(mk1, innz, nnz_deblock))
    cbp_l = torch.where(intra_mask, icbp_l, cbp_l)
    cdc = torch.where(mk2, icdc, cdc)
    cac = torch.where(mk3, icac, cac)
    cnnz = torch.where(mk2, icnnz, cnnz)
    cbp_c = torch.where(intra_mask, icbp_c, cbp_c)
    i16_mode = torch.where(intra_mask, imode, 0)
    chroma_mode = torch.where(intra_mask, cmode.to(_I32), 0)
    mb_cost = torch.where(intra_mask, icost_fix, mb_cost)
    recon_y_mbs = torch.where(mk2, irec, recon_y_mbs)
    ru_mbs = torch.where(mk2, icr_u, ru_mbs)
    rv_mbs = torch.where(mk2, icr_v, rv_mbs)
    t8_flag = t8_flag & ~intra_mask & (cbp_l > 0)
    ry_out = T.mbs_to_plane(recon_y_mbs, mbh, mbw, 16)
    ru_out = T.mbs_to_plane(ru_mbs, mbh, mbw, 8)
    rv_out = T.mbs_to_plane(rv_mbs, mbh, mbw, 8)
    if pir:
        acc = dict(luma_dc=luma_dc, luma_ac=ac_zz, luma_nnz=nnz,
                   nnz_deblock=nnz_deblock, cbp_luma=cbp_l, chroma_dc=cdc,
                   chroma_ac=cac, chroma_nnz=cnnz, cbp_chroma=cbp_c,
                   i16_mode=i16_mode, chroma_mode=chroma_mode,
                   mb_cost=mb_cost, intra_mask=intra_mask, t8=t8_flag)
        acc = {k: t.contiguous() for k, t in acc.items()}
        ry_out, ru_out, rv_out, acc = pir_column_pass(
            y, u, v, ry_out.contiguous(), ru_out.contiguous(),
            rv_out.contiguous(), acc, qp, qpc, int(pir_col), mbw, mbh,
            pir_ncols)
        (luma_dc, ac_zz, nnz, nnz_deblock, cbp_l, cdc, cac, cnnz, cbp_c,
         i16_mode, chroma_mode, mb_cost, intra_mask, t8_flag) = (
            acc[k] for k in ("luma_dc", "luma_ac", "luma_nnz",
                             "nnz_deblock", "cbp_luma", "chroma_dc",
                             "chroma_ac", "chroma_nnz", "cbp_chroma",
                             "i16_mode", "chroma_mode", "mb_cost",
                             "intra_mask", "t8"))

    # classification + entropy blob (p_entropy_tail's CABAC branch)
    if parts:
        mb_class, mvd_part, _ = classify_p_parts(
            mv8, ref[:, None].expand(n, 4), shape, cbp_l, cbp_c, mbw, mbh,
            intra=intra_mask)
        mvd = mvd_part[:, 0]
        shape = torch.where(intra_mask | (mb_class == MB_PSKIP_D), 0, shape)
    else:
        mb_class, mvd = classify_p(mv, cbp_l, cbp_c, mbw, mbh,
                                   ref=ref if multi else None,
                                   intra=intra_mask)
    ref = torch.where(mb_class == MB_PSKIP_D, 0, ref)
    out = dict(
        mb_cost=mb_cost, qp_mb=qp, icost=icost, mv=mv, ref_mb=ref,
        i16_mode=i16_mode, chroma_mode=chroma_mode, luma_dc=luma_dc,
        luma_ac=ac_zz, luma_nnz=nnz, nnz_deblock=nnz_deblock,
        t8=t8_flag, cbp_luma=cbp_l,
        chroma_dc=cdc, chroma_ac=cac, chroma_nnz=cnnz, cbp_chroma=cbp_c,
        recon_y=ry_out.to(torch.uint8), recon_u=ru_out.to(torch.uint8),
        recon_v=rv_out.to(torch.uint8),
        mb_class=mb_class, mvd=mvd)
    blob_parts = {}
    if parts:
        # quadrant-granular motion for the deblock strengths (intra MBs'
        # mvs are never consulted: the intra bS rules win)
        ref8 = ref[:, None].expand(n, 4)
        out.update(shape=shape, mv8=mv8, ref8=ref8, mvd_part=mvd_part)
        blob_parts = dict(shape=shape, mvd_part=mvd_part, ref_part=ref8)
    if n_words or res_slots:
        res_vals, res_lens = residual_slots(luma_dc, ac_zz, nnz, cdc, cac,
                                            cnnz, cbp_l, cbp_c, intra_mask,
                                            mbw, mbh)
    if not n_words:
        if res_slots:
            out["res_vals"], out["res_lens"] = res_vals, res_lens
        if lv_cap:
            out["host_blob"] = cabac_blob(
                luma_dc, ac_zz, cdc, cac, mb_class, mvd, i16_mode,
                chroma_mode, cbp_l, cbp_c, qp, mb_cost, icost, K=lv_cap,
                t8=t8_flag, ref=ref if multi else None, **blob_parts)
        return out
    # CAVLC (p_entropy_tail's CAVLC branch): slot grids and per-MB packing
    # on the device; the host only merges the N packed strings
    t8_hdr = t8_flag if t8 else None
    if parts:
        hv, hl = header_slots_parts(mb_class, shape, i16_mode, chroma_mode,
                                    mvd_part, ref8, cbp_l, cbp_c, qp,
                                    num_ref=n_refs, t8=t8_hdr)
    else:
        hv, hl = header_slots(mb_class, i16_mode, chroma_mode, mvd, cbp_l,
                              cbp_c, qp, is_p_slice=True, ref=ref,
                              num_ref=n_refs, t8=t8_hdr)
    out["host_blob"] = cavlc_blob(hv, hl, res_vals, res_lens, n_words,
                                  (mb_class, mb_cost, icost))
    return out


def p_frame_core(y, u, v, ref_y, ref_u, ref_v, qp, lam: int, mbw: int,
                 mbh: int, me_range: int, cqp_off: int, subpel: int,
                 lv_cap: int = 0, parts: bool = False, decimate: bool = True,
                 t8: bool = False, trellis_tbl=None, wts=None,
                 n_words: int = 0, pir_ncols: int = 0, pir_col=None,
                 pir_bound=None, res_slots: bool = False):
    """Single-chip entry: edge-pad the reference planes (PAD luma, PAD//2
    chroma), one reference (H, W) or stacked (K, H, W) in list0 order,
    then run ``p_frame_pipeline``."""
    return p_frame_pipeline(y, u, v, pad_edge(ref_y, PAD),
                            pad_edge(ref_u, PAD // 2),
                            pad_edge(ref_v, PAD // 2), qp, lam, mbw, mbh,
                            me_range, cqp_off, subpel, lv_cap,
                            parts=parts, decimate=decimate, t8=t8,
                            trellis_tbl=trellis_tbl, wts=wts,
                            n_words=n_words, pir_ncols=pir_ncols,
                            pir_col=pir_col, pir_bound=pir_bound,
                            res_slots=res_slots)


# the fields of a core's output that a host-syntax writer or the deblock
# reads (the reference's encode_pframe_device copies these)
_P_SYNTAX = ("qp_mb", "mb_cost", "icost", "mv", "i16_mode", "chroma_mode",
             "luma_dc", "luma_ac", "luma_nnz", "cbp_luma", "chroma_dc",
             "chroma_ac", "chroma_nnz", "cbp_chroma", "mb_class", "mvd")


def encode_pframe_device(y, u, v, ref, qp, params, lam=None,
                         cavlc: bool = False):
    """The host-syntax path's P frame (the counterpart of
    x264_tpu/models/inter_device.py ``encode_pframe_device``):
    ``p_frame_core`` at its defaults (P16x16, one reference ``ref``, a
    ``ReconFrame`` on the device, no 8x8 transform, no weights, no
    refresh bar) and no blob; under CAVLC (``cavlc``) the residual slot
    grids come back too (the ``cavlc_blocks`` kernel).  y/u/v uint8
    planes on the device; qp scalar or per-MB array.  Returns the
    pre-deblock recon planes on the device and the ``FrameSyntax`` on the
    host; the core's ``mb_class`` and ``mvd`` are final."""
    h, w = y.shape
    mbw, mbh = w // 16, h // 16
    if lam is None:
        lam = sad_lambda(int(np.atleast_1d(qp)[0]))
    out = p_frame_core(y, u, v, ref.y, ref.u, ref.v,
                       torch.as_tensor(np.asarray(qp, np.int32),
                                       device=y.device), int(lam),
                       mbw=mbw, mbh=mbh, me_range=params.me_range,
                       cqp_off=params.chroma_qp_offset,
                       subpel=params.subpel, decimate=params.dct_decimate,
                       res_slots=cavlc)
    o = {k: out[k].cpu().numpy()
         for k in _P_SYNTAX + (("res_vals", "res_lens") if cavlc else ())}

    syn = empty_syntax(mbw, mbh)
    syn.qp[:] = o["qp_mb"]
    syn.mb_cost = o["mb_cost"].astype(np.int64)
    syn.icost = o["icost"].astype(np.int64)
    syn.mv[:] = o["mv"]
    syn.ref[:] = 0
    for k in ("i16_mode", "chroma_mode", "luma_dc", "luma_ac", "luma_nnz",
              "cbp_luma", "chroma_dc", "chroma_ac", "chroma_nnz",
              "cbp_chroma"):
        getattr(syn, k)[:] = o[k]
    if cavlc:
        syn.res_vals = o["res_vals"]
        syn.res_lens = o["res_lens"]
    # the pipeline classified on the device (incl. intra-in-P neighbour
    # rules)
    syn.mb_class[:] = o["mb_class"]
    syn.mvd[:] = np.where((o["mb_class"] == MB_P16)[:, None], o["mvd"], 0)
    return out["recon_y"], out["recon_u"], out["recon_v"], syn


# the band entry of a multi-slice frame: the same pipeline on a band's
# source planes and the band's rows of the padded references (its MB rows
# and PAD, or PAD//2, rows of the neighbouring bands' pixels on each
# side), as the reference's p_band_core (inter_device.py:663)
p_band_core = p_frame_pipeline
