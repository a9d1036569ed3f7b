"""I-frame core: wavefront-batched I16x16 + chroma encoding with the
CABAC blob (port of x264_tpu/models/intra_device.py::i_frame_core, CABAC
branch, no trellis).

Intra prediction reads reconstructed neighbours, so MBs on anti-diagonal
d = mbx + mby depend only on earlier diagonals.  The reference scans the
mbw+mbh-1 diagonals with ``lax.scan``; here a Python loop walks them and
encodes each diagonal's MBs as one batch."""

from __future__ import annotations

import torch

from x264_tpu_torch.models.residual import encode_chroma, encode_i16_luma
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops.entropy_pack import cabac_blob
from x264_tpu_torch.ops.header import MB_I16_D
from x264_tpu_torch.state import tables

_I32 = torch.int32
_BIG = 1 << 30


def qp_per_mb(qp, n: int, device):
    """A scalar or per-MB QP as an (n,) int32 tensor."""
    return torch.as_tensor(qp, dtype=_I32, device=device).reshape(-1) \
        .expand(n).contiguous()


def pick_mode(src, preds, avail):
    """SATD mode decision: (mode (M,), cost (M,), pred (M,s,s)); the
    first cheapest available mode wins, as with ``jnp.argmin``."""
    costs = torch.where(avail, P.satd(src[:, None], preds), _BIG)
    mode = torch.argmin(costs, dim=1)
    cost = costs.gather(1, mode[:, None])[:, 0]
    pred = preds[torch.arange(preds.shape[0], device=preds.device), mode]
    return mode.to(_I32), cost.to(_I32), pred


def i_frame_core(y, u, v, qp, mbw: int, mbh: int, cqp_off: int,
                 lv_cap: int):
    """All-device I-frame pipeline.  y/u/v uint8 planes (16mbh x 16mbw);
    qp int or per-MB (N,).  Returns the per-MB syntax tensors (raster MB
    order), the pre-deblock recon planes and ``host_blob``."""
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    ysrc, usrc, vsrc = y.to(_I32), u.to(_I32), v.to(_I32)
    r16 = torch.arange(16, device=dev)
    r8 = torch.arange(8, device=dev)

    acc = dict(
        i16_mode=torch.zeros(n, dtype=_I32, device=dev),
        chroma_mode=torch.zeros(n, dtype=_I32, device=dev),
        cbp_luma=torch.zeros(n, dtype=_I32, device=dev),
        cbp_chroma=torch.zeros(n, dtype=_I32, device=dev),
        luma_dc=torch.zeros((n, 16), dtype=_I32, device=dev),
        luma_ac=torch.zeros((n, 16, 16), dtype=_I32, device=dev),
        luma_nnz=torch.zeros((n, 16), dtype=_I32, device=dev),
        chroma_dc=torch.zeros((n, 2, 4), dtype=_I32, device=dev),
        chroma_ac=torch.zeros((n, 2, 4, 16), dtype=_I32, device=dev),
        chroma_nnz=torch.zeros((n, 2, 4), dtype=_I32, device=dev),
        mb_cost=torch.zeros(n, dtype=_I32, device=dev),
    )
    ry = torch.zeros_like(ysrc)
    ru = torch.zeros_like(usrc)
    rv = torch.zeros_like(vsrc)

    def edges(plane, y0, x0, s):
        """(top (M,s), left (M,s), topleft (M,)) at clamped coordinates;
        unavailable edges hold garbage that the availability masks
        exclude, as in the reference."""
        ytop = (y0 - 1).clamp(min=0)
        xleft = (x0 - 1).clamp(min=0)
        rs = torch.arange(s, device=dev)
        top = plane[ytop[:, None], x0[:, None] + rs]
        left = plane[y0[:, None] + rs, xleft[:, None]]
        return top, left, plane[ytop, xleft]

    def blocks(plane, y0, x0, s):
        rs = torch.arange(s, device=dev)
        return plane[(y0[:, None] + rs)[:, :, None],
                     (x0[:, None] + rs)[:, None, :]]

    for d in range(mbw + mbh - 1):
        xs = torch.arange(max(0, d - (mbh - 1)), min(d, mbw - 1) + 1,
                          device=dev)
        ys = d - xs
        at, al = ys > 0, xs > 0
        atl = at & al
        mb = ys * mbw + xs

        y0, x0 = ys * 16, xs * 16
        top, left, tl = edges(ry, y0, x0, 16)
        src = blocks(ysrc, y0, x0, 16)
        mode, mode_cost, pred = pick_mode(
            src, PR.predict_16x16_all(top, left, tl, at, al),
            PR.i16x16_mode_avail(at, al, atl))
        recon, dc_zz, ac_zz, nnz, cbp_l = encode_i16_luma(src, pred, qp[mb])

        cy0, cx0 = ys * 8, xs * 8
        ctop_u, cleft_u, ctl_u = edges(ru, cy0, cx0, 8)
        ctop_v, cleft_v, ctl_v = edges(rv, cy0, cx0, 8)
        csrc_u = blocks(usrc, cy0, cx0, 8)
        csrc_v = blocks(vsrc, cy0, cx0, 8)
        cpreds_u = PR.predict_chroma_all(ctop_u, cleft_u, ctl_u, at, al)
        cpreds_v = PR.predict_chroma_all(ctop_v, cleft_v, ctl_v, at, al)
        ccosts = torch.where(PR.chroma_mode_avail(at, al, atl),
                             P.satd(csrc_u[:, None], cpreds_u)
                             + P.satd(csrc_v[:, None], cpreds_v), _BIG)
        cmode = torch.argmin(ccosts, dim=1)
        lanes = torch.arange(xs.shape[0], device=dev)
        cr_u, cr_v, cdc, cac, cnnz, cbp_c = encode_chroma(
            csrc_u, csrc_v, cpreds_u[lanes, cmode], cpreds_v[lanes, cmode],
            qpc[mb], intra=True)

        yy = (y0[:, None] + r16)[:, :, None]
        ry[yy, (x0[:, None] + r16)[:, None, :]] = recon
        cyy = (cy0[:, None] + r8)[:, :, None]
        cxx = (cx0[:, None] + r8)[:, None, :]
        ru[cyy, cxx] = cr_u
        rv[cyy, cxx] = cr_v

        for key, val in (("i16_mode", mode), ("chroma_mode", cmode),
                         ("cbp_luma", cbp_l), ("cbp_chroma", cbp_c),
                         ("luma_dc", dc_zz), ("luma_ac", ac_zz),
                         ("luma_nnz", nnz), ("chroma_dc", cdc),
                         ("chroma_ac", cac), ("chroma_nnz", cnnz),
                         ("mb_cost", mode_cost)):
            acc[key][mb] = val.to(_I32)

    out = dict(acc)
    mb_class = torch.full((n,), MB_I16_D, dtype=_I32, device=dev)
    out["mb_class"] = mb_class
    out["host_blob"] = cabac_blob(
        acc["luma_dc"], acc["luma_ac"], acc["chroma_dc"], acc["chroma_ac"],
        mb_class, torch.zeros((n, 2), dtype=_I32, device=dev),
        acc["i16_mode"], acc["chroma_mode"], acc["cbp_luma"],
        acc["cbp_chroma"], qp, acc["mb_cost"],
        torch.zeros(n, dtype=_I32, device=dev), K=lv_cap)
    out["recon_y"] = ry.to(torch.uint8)
    out["recon_u"] = ru.to(torch.uint8)
    out["recon_v"] = rv.to(torch.uint8)
    out["qp_mb"] = qp
    return out
