"""P16x16 skip / MV-prediction classification (port of
x264_tpu/ops/device/header.py::classify_p for one reference; parity:
reference common/mvpred.c x264_mb_predict_mv / x264_mb_predict_mv_pskip).
"""

from __future__ import annotations

import torch

MB_P16_D, MB_PSKIP_D = 2, 3   # match models.syntax MB_P16 / MB_PSKIP
MB_I16_D = 0

_I32 = torch.int32


def shifted(g, dy: int, dx: int, fill):
    """g (mbh, mbw, ...) moved so out[y, x] = g[y+dy, x+dx] where that
    lies in the frame, ``fill`` elsewhere; plus the availability mask."""
    mbh, mbw = g.shape[0], g.shape[1]
    out = torch.full_like(g, fill)
    av = torch.zeros((mbh, mbw), dtype=torch.bool, device=g.device)
    ys = slice(max(dy, 0), mbh + min(dy, 0))
    xs = slice(max(dx, 0), mbw + min(dx, 0))
    yd = slice(max(-dy, 0), mbh + min(-dy, 0))
    xd = slice(max(-dx, 0), mbw + min(-dx, 0))
    out[yd, xd] = g[ys, xs]
    av[yd, xd] = True
    return out, av


def classify_p(mv, cbp_luma, cbp_chroma, mbw: int, mbh: int, intra=None):
    """P16x16 skip/MVP classification (8.4.1), fully parallel: every
    decoded mv equals the chosen one, so MVP and P_Skip of all MBs are
    functions of the mv field.  mv (N,2) int32 qpel; intra (N,) bool or
    None — intra MBs contribute (mv 0, ref -1) to their neighbours
    (8.4.1.3.2) and are classed MB_I16_D.  Returns (mb_class (N,),
    mvd (N,2)), int32."""
    m = mv.to(_I32).reshape(mbh, mbw, 2)
    r = torch.zeros((mbh, mbw), dtype=_I32, device=mv.device)
    if intra is not None:
        ig = intra.reshape(mbh, mbw)
        m = torch.where(ig[..., None], 0, m)
        r = torch.where(ig, -1, r)

    mva, av_a = shifted(m, 0, -1, 0)
    ra, _ = shifted(r, 0, -1, -1)
    mvb, av_b = shifted(m, -1, 0, 0)
    rb, _ = shifted(r, -1, 0, -1)
    mvc, av_c = shifted(m, -1, 1, 0)
    rc, _ = shifted(r, -1, 1, -1)
    mvd_, av_d = shifted(m, -1, -1, 0)
    rd, _ = shifted(r, -1, -1, -1)
    use_d = ~av_c
    mvc = torch.where(use_d[..., None], mvd_, mvc)
    rc = torch.where(use_d, rd, rc)
    av_c = torch.where(use_d, av_d, av_c)

    za = mva * av_a[..., None]
    zb = mvb * av_b[..., None]
    zc = mvc * av_c[..., None]
    med = torch.sort(torch.stack([za, zb, zc]), dim=0).values[1]
    only_a = av_a & ~av_b & ~av_c

    def mvp_for(cur_ref):
        """Median MVP for reference index cur_ref (8.4.1.3)."""
        sa, sb, sc = ra == cur_ref, rb == cur_ref, rc == cur_ref
        one = (sa.to(_I32) + sb.to(_I32) + sc.to(_I32)) == 1
        one_mv = (mva * sa[..., None] + mvb * sb[..., None]
                  + mvc * sc[..., None])
        return torch.where(only_a[..., None], mva,
                           torch.where(one[..., None], one_mv, med))

    mvp = mvp_for(r)
    mvp0 = mvp_for(torch.zeros_like(r))

    yy = torch.arange(mbh, device=mv.device)[:, None]
    xx = torch.arange(mbw, device=mv.device)[None, :]
    edge = (yy == 0) | (xx == 0)
    a_zero = av_a & (ra == 0) & (mva == 0).all(-1)
    b_zero = av_b & (rb == 0) & (mvb == 0).all(-1)
    skip_mv = torch.where((edge | a_zero | b_zero)[..., None], 0, mvp0)

    flat_mv = m.reshape(-1, 2)
    is_skip = ((cbp_luma == 0) & (cbp_chroma == 0)
               & (r.reshape(-1) == 0)
               & (flat_mv == skip_mv.reshape(-1, 2)).all(1))
    mb_class = torch.where(is_skip, MB_PSKIP_D, MB_P16_D).to(_I32)
    if intra is not None:
        mb_class = torch.where(intra, MB_I16_D, mb_class).to(_I32)
    mvd = torch.where(is_skip[:, None], 0, flat_mv - mvp.reshape(-1, 2))
    return mb_class, mvd.to(_I32)
