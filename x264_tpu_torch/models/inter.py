"""P-frame core: the whole per-frame pixel pipeline — exhaustive fullpel
ME, subpel refinement, luma/chroma MC, residual, reconstruction,
intra-in-P, P_Skip/MVP classification and the CABAC blob — over all MBs
at once (port of x264_tpu/models/inter_device.py: ``p_frame_pipeline``
on the single-reference, P16x16, no-PIR, no-weights path, the CABAC
branch of ``p_entropy_tail`` and ``p_frame_core``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from x264_tpu.models.inter_frame import PAD
from x264_tpu_torch.models.intra import pick_mode, qp_per_mb
from x264_tpu_torch.models.residual import (encode_chroma, encode_i16_luma,
                                            encode_p_luma)
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.ops.entropy_pack import cabac_blob
from x264_tpu_torch.ops.header import MB_PSKIP_D, shifted, classify_p
from x264_tpu_torch.ops.mc import mc_chroma_uv, pad_edge
from x264_tpu_torch.ops.me import full_search_16x16, subpel_refine
from x264_tpu_torch.state import tables

_I32 = torch.int32
_BIG = 1 << 30


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


def p_frame_pipeline(y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp,
                     lam: int, mbw: int, mbh: int, me_range: int,
                     cqp_off: int, subpel: int, lv_cap: int,
                     decimate: bool = True):
    """P-frame pipeline on pre-padded reference planes (PAD luma, PAD//2
    chroma).  y/u/v uint8 source planes; qp int or per-MB (N,); lam int.
    Returns the per-MB syntax tensors, pre-deblock recon planes and the
    CABAC ``host_blob``."""
    if subpel < 1:
        raise NotImplementedError("the fullpel-only P path (subpel=0) is "
                                  "not ported")
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    src_mbs = T.plane_to_mbs(y.to(_I32), mbh, mbw, 16)

    mv, _ = full_search_16x16(y, ref_y_pad, lam, me_range, mbw, mbh)
    ref = torch.zeros(n, dtype=_I32, device=dev)
    mv, mb_cost, pred = subpel_refine(src_mbs, ref_y_pad, mv, lam,
                                      me_range, subpel, mbw, mbh,
                                      return_pred=True)
    recon_y_mbs, ac_zz, nnz, cbp_l = encode_p_luma(src_mbs, pred, qp,
                                                   decimate=decimate)
    nnz_deblock = nnz

    pred_u, pred_v = mc_chroma_uv(ref_u_pad, ref_v_pad, mv, mbw, mbh,
                                  PAD // 2)
    src_u = T.plane_to_mbs(u.to(_I32), mbh, mbw, 8)
    src_v = T.plane_to_mbs(v.to(_I32), mbh, mbw, 8)
    ru_mbs, rv_mbs, cdc, cac, cnnz, cbp_c = encode_chroma(
        src_u, src_v, pred_u, pred_v, qpc, intra=False, decimate=decimate)

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
    cg = ((icost + 8 * lam) < mb_cost).reshape(mbh, mbw)
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
    irec, idc, iac, innz, icbp_l = encode_i16_luma(src_mbs, ipred, qp)
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
        intra=True)

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

    # classification + entropy blob (p_entropy_tail's CABAC branch)
    mb_class, mvd = classify_p(mv, cbp_l, cbp_c, mbw, mbh,
                               intra=intra_mask)
    ref = torch.where(mb_class == MB_PSKIP_D, 0, ref)
    return dict(
        mb_cost=mb_cost, qp_mb=qp, icost=icost, mv=mv, ref_mb=ref,
        i16_mode=i16_mode, chroma_mode=chroma_mode, luma_dc=luma_dc,
        luma_ac=ac_zz, luma_nnz=nnz, nnz_deblock=nnz_deblock,
        t8=torch.zeros(n, dtype=torch.bool, device=dev), cbp_luma=cbp_l,
        chroma_dc=cdc, chroma_ac=cac, chroma_nnz=cnnz, cbp_chroma=cbp_c,
        recon_y=T.mbs_to_plane(recon_y_mbs, mbh, mbw, 16).to(torch.uint8),
        recon_u=T.mbs_to_plane(ru_mbs, mbh, mbw, 8).to(torch.uint8),
        recon_v=T.mbs_to_plane(rv_mbs, mbh, mbw, 8).to(torch.uint8),
        mb_class=mb_class, mvd=mvd,
        host_blob=cabac_blob(luma_dc, ac_zz, cdc, cac, mb_class, mvd,
                             i16_mode, chroma_mode, cbp_l, cbp_c, qp,
                             mb_cost, icost, K=lv_cap))


def p_frame_core(y, u, v, ref_y, ref_u, ref_v, qp, lam: int, mbw: int,
                 mbh: int, me_range: int, cqp_off: int, subpel: int,
                 lv_cap: int, decimate: bool = True):
    """Single-reference entry: edge-pad the reference planes (PAD luma,
    PAD//2 chroma), then run ``p_frame_pipeline``."""
    return p_frame_pipeline(y, u, v, pad_edge(ref_y, PAD),
                            pad_edge(ref_u, PAD // 2),
                            pad_edge(ref_v, PAD // 2), qp, lam, mbw, mbh,
                            me_range, cqp_off, subpel, lv_cap,
                            decimate=decimate)
