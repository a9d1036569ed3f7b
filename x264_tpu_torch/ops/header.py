"""P skip / MV-prediction classification (port of
x264_tpu/ops/device/header.py: ``classify_p`` for P16x16 MBs and
``classify_p_parts`` for partitioned MBs, each with per-MB refs;
parity: reference common/mvpred.c x264_mb_predict_mv /
x264_mb_predict_mv_pskip)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def classify_p(mv, cbp_luma, cbp_chroma, mbw: int, mbh: int, ref=None,
               intra=None):
    """P16x16 skip/MVP classification (8.4.1), fully parallel: every
    decoded (mv, ref) equals the chosen one, so MVP and P_Skip of all
    MBs are functions of the mv and ref fields.  mv (N,2) int32 qpel;
    ref (N,) list0 ref_idx or None (all 0): each MB's MVP counts the
    neighbours with its own ref, P_Skip needs ref 0; intra (N,) bool or
    None — intra MBs contribute (mv 0, ref -1) to their neighbours
    (8.4.1.3.2) and are classed MB_I16_D.  Returns (mb_class (N,),
    mvd (N,2)), int32."""
    m = mv.to(_I32).reshape(mbh, mbw, 2)
    r = (torch.zeros((mbh, mbw), dtype=_I32, device=mv.device)
         if ref is None else ref.to(_I32).reshape(mbh, mbw))
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


# (shape, part) -> (lbx, lby, pw, ph) in 4x4-block units (7.4.5.2 order)
_PART_GEOM = {
    (0, 0): (0, 0, 4, 4),
    (1, 0): (0, 0, 4, 2), (1, 1): (0, 2, 4, 2),
    (2, 0): (0, 0, 2, 4), (2, 1): (2, 0, 2, 4),
    (3, 0): (0, 0, 2, 2), (3, 1): (2, 0, 2, 2),
    (3, 2): (0, 2, 2, 2), (3, 3): (2, 2, 2, 2),
}
# (shape, part) -> first member quad
_FIRST_Q = {(0, 0): 0, (1, 0): 0, (1, 1): 2, (2, 0): 0, (2, 1): 1,
            (3, 0): 0, (3, 1): 1, (3, 2): 2, (3, 3): 3}


def classify_p_parts(mv8, ref8, shape, cbp_luma, cbp_chroma, mbw: int,
                     mbh: int, intra=None):
    """Partition-aware P classification: P_Skip + normative per-partition
    MVP/mvd (8.4.1.3), fully parallel (port of
    x264_tpu/ops/device/header.py::classify_p_parts).  Every decoded 4x4
    block's (mv, ref) equals the encoder's chosen value, so partition MVPs
    are functions of the chosen 4x4-grain field; decode-order
    availability (e.g. the C neighbour of a 16x8 bottom partition lies in
    the not-yet-decoded right MB) is static per (shape, part).

    mv8 (N,4,2) per-quadrant chosen mvs (q = 2*qy+qx); ref8 (N,4);
    shape (N,) in {0:16x16, 1:16x8, 2:8x16, 3:8x8}; intra (N,) bool or
    None.  Returns (mb_class (N,), mvd_part (N,4,2) partition-slot
    order, is_skip (N,))."""
    n = mbw * mbh
    h4, w4 = 4 * mbh, 4 * mbw
    dev = mv8.device
    mv8 = mv8.to(_I32)
    ref8 = ref8.to(_I32)
    # 4x4-grain chosen grids (quad -> 2x2 blocks)
    mvq = mv8.reshape(mbh, mbw, 2, 2, 2)       # (my, mx, qy, qx, 2)
    mv4 = (mvq.repeat_interleave(2, 2).repeat_interleave(2, 3)
           .permute(0, 2, 1, 3, 4).reshape(h4, w4, 2))
    refq = ref8.reshape(mbh, mbw, 2, 2)
    ref4 = (refq.repeat_interleave(2, 2).repeat_interleave(2, 3)
            .permute(0, 2, 1, 3).reshape(h4, w4))
    if intra is not None:
        ig = (intra.reshape(mbh, mbw).repeat_interleave(4, 0)
              .repeat_interleave(4, 1))
        mv4 = torch.where(ig[..., None], 0, mv4)
        ref4 = torch.where(ig, -1, ref4)

    # pad 4 blocks on every side so any (oy, ox) in [-1, 4] resolves
    mv4p = F.pad(mv4, (0, 0, 4, 4, 4, 4))
    ref4p = F.pad(ref4, (4, 4, 4, 4), value=-1)

    def samp(oy: int, ox: int):
        """Grid values at (4*my + oy, 4*mx + ox) for all MBs -> flat
        (mv (N,2), ref (N,))."""
        def pick(a):
            return a[oy + 4::4][:mbh, ox + 4::4][:, :mbw]
        return pick(mv4p).reshape(n, 2), pick(ref4p).reshape(n)

    mb = torch.arange(n, device=dev)
    mbyv, mbxv = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    true = torch.ones(n, dtype=torch.bool, device=dev)
    at = mbyv > 0
    al = mbxv > 0
    ar = mbxv < (mbw - 1)

    def neigh(oy, ox, avail):
        mv, rf = samp(oy, ox)
        mv = torch.where(avail[:, None], mv, 0)
        rf = torch.where(avail, rf, -1)
        return mv, rf, avail

    def median3(a, b, c):
        return torch.maximum(torch.minimum(a, b),
                             torch.minimum(torch.maximum(a, b), c))

    def mvp_of(A, B, C, cur_ref, directional=None):
        """8.4.1.3 / 8.4.1.3.1 from neighbour triples (mv, ref, avail)."""
        mva, ra, av_a = A
        mvb, rb, av_b = B
        mvc, rc, av_c = C
        sa, sb, sc = ra == cur_ref, rb == cur_ref, rc == cur_ref
        one = (sa.to(_I32) + sb.to(_I32) + sc.to(_I32)) == 1
        one_mv = (mva * sa[:, None] + mvb * sb[:, None]
                  + mvc * sc[:, None])
        med = median3(mva, mvb, mvc)
        only_a = av_a & ~av_b & ~av_c
        mvp = torch.where(only_a[:, None], mva,
                          torch.where(one[:, None], one_mv, med))
        if directional is not None:
            dmv, dref = directional
            mvp = torch.where((dref == cur_ref)[:, None], dmv, mvp)
        return mvp

    # per-combo MVPs; combo key (shape, part)
    mvp_combo = {}
    skip_parts = {}
    for (sh, p), (lbx, lby, pw, ph) in _PART_GEOM.items():
        A = neigh(lby, lbx - 1, true if lbx > 0 else al)
        B = neigh(lby - 1, lbx, true if lby > 0 else at)
        # C availability / D substitution (static decode-order rules)
        cy, cx = lby - 1, lbx + pw
        if (sh, p) in ((1, 1), (3, 3)):
            c_av = torch.zeros(n, dtype=torch.bool, device=dev)
        elif cy >= 0 and cx < 4:
            c_av = true                          # same MB, earlier part
        elif cy < 0 and cx >= 4:
            c_av = at & ar                       # above-right MB
        elif cy < 0:
            c_av = at                            # above MB
        else:
            c_av = true
        dy_, dx_ = lby - 1, lbx - 1
        if dy_ >= 0 and dx_ >= 0:
            d_av = true                          # same MB, earlier part
        elif dy_ >= 0:
            d_av = al                            # left MB
        elif dx_ >= 0:
            d_av = at                            # above MB
        else:
            d_av = at & al                       # above-left MB
        Cmv, Cr = samp(cy, cx)
        Dmv, Dr = samp(dy_, dx_)
        use_d = ~c_av
        Cn = (torch.where(use_d[:, None],
                          torch.where(d_av[:, None], Dmv, 0),
                          torch.where(c_av[:, None], Cmv, 0)),
              torch.where(use_d, torch.where(d_av, Dr, -1),
                          torch.where(c_av, Cr, -1)),
              torch.where(use_d, d_av, c_av))

        q = (lby // 2) * 2 + (lbx // 2)
        cur_ref = ref8[:, q]
        directional = None
        if sh == 1:
            directional = (B[0], B[1]) if p == 0 else (A[0], A[1])
        elif sh == 2:
            directional = (A[0], A[1]) if p == 0 else (Cn[0], Cn[1])
        mvp_combo[(sh, p)] = mvp_of(A, B, Cn, cur_ref, directional)
        if (sh, p) == (0, 0):
            # P_Skip pieces (8.4.1.1): zero-mv A/B shortcut + ref-0 MVP
            mvp0 = mvp_of(A, B, Cn, torch.zeros(n, dtype=_I32, device=dev))
            a_zero = A[2] & (A[1] == 0) & (A[0] == 0).all(-1)
            b_zero = B[2] & (B[1] == 0) & (B[0] == 0).all(-1)
            edge = ~at | ~al
            skip_parts = dict(mvp0=mvp0, zero=edge | a_zero | b_zero)

    skip_mv = torch.where(skip_parts["zero"][:, None], 0,
                          skip_parts["mvp0"])
    is_skip = ((shape == 0) & (cbp_luma == 0) & (cbp_chroma == 0)
               & (ref8[:, 0] == 0) & (mv8[:, 0] == skip_mv).all(-1))
    if intra is not None:
        is_skip = is_skip & ~intra

    # mvd per partition slot, selected by the MB's shape
    mvd_part = torch.zeros((n, 4, 2), dtype=_I32, device=dev)
    for (sh, p), mvp in mvp_combo.items():
        sel = shape == sh
        mvd_part[:, p] = torch.where(sel[:, None],
                                     mv8[:, _FIRST_Q[(sh, p)]] - mvp,
                                     mvd_part[:, p])
    mvd_part = torch.where(is_skip[:, None, None], 0, mvd_part)
    if intra is not None:
        mvd_part = torch.where(intra[:, None, None], 0, mvd_part)

    mb_class = torch.where(is_skip, MB_PSKIP_D, MB_P16_D).to(_I32)
    if intra is not None:
        mb_class = torch.where(intra, MB_I16_D, mb_class).to(_I32)
    return mb_class, mvd_part.to(_I32), is_skip


# B-frame 16x16 modes (x264_tpu/ops/device/header.py; the CAVLC mb_type
# values)
B_DIRECT, B_L0, B_L1, B_BI = 0, 1, 2, 3


def mvp_for_list(mv, used, mbw: int, mbh: int):
    """Median MVP over the neighbours that use this list (ref 0), 8.4.1.3
    (port of x264_tpu/ops/device/header.py ``mvp_for_list``).  mv (N,2)
    per MB, or (N,4,2) per quadrant (direct MBs under quadrant temporal
    direct); used (N,) bool.  Returns mvp (N,2) int32.

    With quadrant input the neighbouring 4x4 block of the current 16x16
    partition lies in one quadrant of the neighbour MB (6.4.11.7): A =
    the left MB's top-right quadrant, B = the top MB's bottom-left, C =
    the top-right MB's bottom-left, D = the top-left MB's bottom-right."""
    if mv.dim() == 2:
        mv = mv[:, None, :].expand(mv.shape[0], 4, 2)
    m4 = mv.to(_I32).reshape(mbh, mbw, 4, 2)
    u = used.reshape(mbh, mbw)

    def neigh(dy, dx, q):
        mvn, av = shifted(m4[:, :, q], dy, dx, 0)
        return mvn, shifted(u, dy, dx, False)[0], av

    mva, ua, av_a = neigh(0, -1, 1)
    mvb, ub, av_b = neigh(-1, 0, 2)
    mvc, uc, av_c = neigh(-1, 1, 2)
    mvd_, ud_, av_d = neigh(-1, -1, 3)
    use_d = ~av_c
    mvc = torch.where(use_d[..., None], mvd_, mvc)
    uc = torch.where(use_d, ud_, uc)
    av_c = torch.where(use_d, av_d, av_c)

    ua, ub, uc = ua & av_a, ub & av_b, uc & av_c
    # 8.4.1.3.2: a neighbour that does not use this list contributes mv 0
    za, zb, zc = mva * ua[..., None], mvb * ub[..., None], mvc * uc[..., None]
    med = torch.maximum(torch.minimum(za, zb),
                        torch.minimum(torch.maximum(za, zb), zc))
    only_a = av_a & ~av_b & ~av_c
    one = (ua.to(_I32) + ub.to(_I32) + uc.to(_I32)) == 1
    mvp = torch.where(only_a[..., None], za,
                      torch.where(one[..., None], za + zb + zc, med))
    return mvp.reshape(-1, 2).to(_I32)
