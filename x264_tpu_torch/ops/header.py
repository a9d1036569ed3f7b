"""P skip / MV-prediction classification and the CAVLC MB headers (port
of x264_tpu/ops/device/header.py: ``classify_p`` for P16x16 MBs and
``classify_p_parts`` for partitioned MBs, each with per-MB refs, the
per-list ``mvp_for_list`` of B frames, and the header code writers
``header_slots``, ``header_slots_parts`` and ``header_slots_b``;
parity: reference common/mvpred.c x264_mb_predict_mv /
x264_mb_predict_mv_pskip, encoder/cavlc.c)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from x264_tpu_torch.bitstream.tables import CBP_TO_GOLOMB

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


# ---- CAVLC MB headers (port of x264_tpu/ops/device/header.py:
# bit_length, ue_codes, se_codes, header_slots, header_slots_parts,
# header_slots_b; parity: reference encoder/cavlc.c MB header writing) --

HEADER_SLOTS = 9
HEADER_SLOTS_PARTS = 22
HEADER_SLOTS_B = 10


@functools.lru_cache(maxsize=8)
def _consts(device: str) -> dict:
    """The header writers' tables on ``device``, uploaded once (an I
    core's CUDA graph captures no host-to-device copy)."""
    return dict(cbp=torch.as_tensor(CBP_TO_GOLOMB.astype(np.int32),
                                    device=device),
                nparts=torch.tensor([1, 2, 2, 4], dtype=_I32,
                                    device=device))


def _cbp_codes(cbp_c, cbp_l):
    """ue(coded_block_pattern) of inter MBs (Table 9-4's mapping)."""
    cbp = _consts(str(cbp_l.device))["cbp"]
    return ue_codes(cbp[0, ((cbp_c << 4) | cbp_l).long()])


def bit_length(x):
    """Exact bit_length for 0 <= x < 2^16 via comparisons."""
    x = x.to(_I32)
    out = torch.zeros_like(x)
    for k in range(16):
        out = out + (x >= (1 << k)).to(_I32)
    return out


def ue_codes(v):
    vv = v.to(_I32) + 1
    return vv, 2 * bit_length(vv) - 1


def se_codes(v):
    v = v.to(_I32)
    return ue_codes(torch.where(v > 0, 2 * v - 1, -2 * v))


def _skip_run_codes(coded):
    """ue(mb_skip_run) before each coded MB: the distance to the previous
    coded MB less one (a running max of coded MB indices)."""
    n = coded.shape[0]
    idx = torch.arange(n, dtype=_I32, device=coded.device)
    run_max = torch.cummax(torch.where(coded, idx, -1), dim=0).values
    prev_coded = F.pad(run_max[:-1], (1, 0), value=-1)
    v, ln = ue_codes(idx - prev_coded - 1)
    return v, torch.where(coded, ln, 0)


def _qp_delta_codes(emits, qp_mb):
    """se(mb_qp_delta), chained over the MBs that carry one."""
    n = emits.shape[0]
    qp = qp_mb.to(_I32)
    ordn = torch.cumsum(emits.to(_I32), dim=0) - 1
    qp_compact = torch.zeros(n + 1, dtype=_I32, device=qp.device).scatter_(
        0, torch.where(emits, ordn, n).long(), qp)[:n]
    prev_qp = torch.where(ordn > 0, qp_compact[(ordn - 1).clamp(min=0)],
                          qp[0])
    delta = qp - prev_qp
    delta = torch.where(delta > 25, delta - 52,
                        torch.where(delta < -26, delta + 52, delta))
    v, ln = se_codes(delta)
    return v, torch.where(emits, ln, 0)


def _ref_codes(ref, num_ref: int):
    """te(ref_idx): one inverted bit at num_ref 2, ue() beyond."""
    r = ref.to(_I32)
    if num_ref == 2:
        return 1 - r, torch.ones_like(r)
    return ue_codes(r)


def _stack(hv, hl):
    return (torch.stack(hv, dim=1).to(_I32),
            torch.stack(hl, dim=1).to(_I32))


def header_slots(mb_class, i16_mode, chroma_mode, mvd, cbp_luma, cbp_chroma,
                 qp_mb, is_p_slice: bool, ref=None, num_ref: int = 1,
                 t8=None):
    """Per-MB header codes [skip_run, mb_type, chroma_mode, ref_idx,
    mvd_x, mvd_y, cbp, transform_size_8x8_flag, qp_delta] -> (hvals,
    hlens) (N,9) int32 (I16/P16/PSKIP classes).  ref_idx is te()-coded:
    absent at num_ref 1, a single !ref bit at num_ref 2, ue(ref) beyond.
    t8 (N,) bool or None: the flag bit is written for inter MBs with
    CodedBlockPatternLuma > 0 (7.3.5)."""
    n = mb_class.shape[0]
    dev = mb_class.device
    skip = mb_class == MB_PSKIP_D
    coded = ~skip
    intra = mb_class == MB_I16_D
    p16 = mb_class == MB_P16_D
    cbp_l = cbp_luma.to(_I32)
    cbp_c = cbp_chroma.to(_I32)
    zero = torch.zeros(n, dtype=_I32, device=dev)
    hv = [zero] * HEADER_SLOTS
    hl = [zero] * HEADER_SLOTS

    if is_p_slice:
        hv[0], hl[0] = _skip_run_codes(coded)

    mb_type = torch.where(intra, 1 + i16_mode.to(_I32) + 4 * cbp_c
                          + 12 * (cbp_l != 0), 0)
    if is_p_slice:
        mb_type = mb_type + 5 * intra
    v, ln = ue_codes(mb_type)
    hv[1], hl[1] = v, torch.where(coded, ln, 0)

    v, ln = ue_codes(chroma_mode)
    hv[2], hl[2] = torch.where(intra, v, 0), torch.where(intra, ln, 0)

    if num_ref > 1 and ref is not None:
        v, ln = _ref_codes(ref, num_ref)
        hv[3], hl[3] = torch.where(p16, v, 0), torch.where(p16, ln, 0)

    for c in range(2):
        v, ln = se_codes(mvd[:, c])
        hv[4 + c] = torch.where(p16, v, 0)
        hl[4 + c] = torch.where(p16, ln, 0)

    v, ln = _cbp_codes(cbp_c, cbp_l)
    hv[6], hl[6] = torch.where(p16, v, 0), torch.where(p16, ln, 0)

    if t8 is not None:
        on = p16 & (cbp_l > 0)
        hv[7] = torch.where(on, t8.to(_I32), 0)
        hl[7] = on.to(_I32)

    emits = coded & ((cbp_l != 0) | (cbp_c != 0) | intra)
    hv[8], hl[8] = _qp_delta_codes(emits, qp_mb)
    return _stack(hv, hl)


def header_slots_parts(mb_class, shape, i16_mode, chroma_mode, mvd_part,
                       ref_part, cbp_luma, cbp_chroma, qp_mb,
                       num_ref: int = 1, t8=None):
    """Per-MB CAVLC header codes for partitioned P slices (7.3.5/7.3.5.1
    emission order): [skip_run, mb_type, chroma_mode, sub_mb_type x4,
    ref x4, (mvd_x, mvd_y) x4, cbp, t8_flag, qp_delta] -> (N, 22).
    shape (N,) 0..3 (the inter mb_type ue value; P_8x8ref0 when every
    quadrant is on ref 0, x264's cavlc.c rule); mvd_part (N,4,2) in
    partition-slot order; ref_part (N,4).  Slots a shape does not use get
    length 0.  Parity: reference encoder/cavlc.c cavlc_mb_header_p."""
    n = mb_class.shape[0]
    dev = mb_class.device
    skip = mb_class == MB_PSKIP_D
    coded = ~skip
    intra = mb_class == MB_I16_D
    p_inter = coded & ~intra
    cbp_l = cbp_luma.to(_I32)
    cbp_c = cbp_chroma.to(_I32)
    nparts = _consts(str(dev))["nparts"][shape.long()]
    zero = torch.zeros(n, dtype=_I32, device=dev)
    hv = [zero] * HEADER_SLOTS_PARTS
    hl = [zero] * HEADER_SLOTS_PARTS

    hv[0], hl[0] = _skip_run_codes(coded)

    use_ref0 = (shape == 3) & (ref_part == 0).all(-1)
    mb_type = torch.where(
        intra, 5 + 1 + i16_mode.to(_I32) + 4 * cbp_c + 12 * (cbp_l != 0),
        torch.where(use_ref0, 4, shape.to(_I32)))
    v, ln = ue_codes(mb_type)
    hv[1], hl[1] = v, torch.where(coded, ln, 0)

    v, ln = ue_codes(chroma_mode)
    hv[2], hl[2] = torch.where(intra, v, 0), torch.where(intra, ln, 0)

    # sub_mb_type: P_L0_8x8 only -> ue(0), a single "1" bit, x4
    is8 = (p_inter & (shape == 3)).to(_I32)
    for k in range(4):
        hv[3 + k], hl[3 + k] = is8, is8

    if num_ref > 1:
        write_ref = p_inter & ~use_ref0
        for k in range(4):
            live = write_ref & (k < nparts)
            v, ln = _ref_codes(ref_part[:, k], num_ref)
            hv[7 + k] = torch.where(live, v, 0)
            hl[7 + k] = torch.where(live, ln, 0)

    for k in range(4):
        live = p_inter & (k < nparts)
        for c in range(2):
            v, ln = se_codes(mvd_part[:, k, c])
            hv[11 + 2 * k + c] = torch.where(live, v, 0)
            hl[11 + 2 * k + c] = torch.where(live, ln, 0)

    v, ln = _cbp_codes(cbp_c, cbp_l)
    hv[19], hl[19] = torch.where(p_inter, v, 0), torch.where(p_inter, ln, 0)

    if t8 is not None:
        on = p_inter & (cbp_l > 0)
        hv[20] = torch.where(on, t8.to(_I32), 0)
        hl[20] = on.to(_I32)

    emits = coded & ((cbp_l != 0) | (cbp_c != 0) | intra)
    hv[21], hl[21] = _qp_delta_codes(emits, qp_mb)
    return _stack(hv, hl)


def header_slots_b(bmode, is_skip, mvd0, mvd1, cbp_luma, cbp_chroma, qp_mb,
                   t8_mode: bool = False, intra=None, i16_mode=None,
                   chroma_mode=None):
    """Per-MB B-slice header codes (one ref per list, 16x16 partitions):
    [skip_run, mb_type, chroma_mode, mvd0x, mvd0y, mvd1x, mvd1y, cbp,
    transform_size_8x8_flag, qp_delta] -> (N,10) int32.  bmode (N,) in
    {B_DIRECT, B_L0, B_L1, B_BI}; is_skip (N,) bool (direct, no
    residual); intra (N,) bool or None: I_16x16 escapes (mb_type 23 +
    the I-slice code, then intra_chroma_pred_mode; no cbp element, no
    mvds).  t8_mode: the PPS advertises transform_8x8_mode, so every
    coded-luma inter MB carries the flag bit, written 0 (B MBs use the
    4x4 transform with CAVLC, as in the reference)."""
    n = bmode.shape[0]
    dev = bmode.device
    coded = ~is_skip
    if intra is None:
        intra = torch.zeros(n, dtype=torch.bool, device=dev)
    inter = coded & ~intra
    cbp_l = cbp_luma.to(_I32)
    cbp_c = cbp_chroma.to(_I32)
    zero = torch.zeros(n, dtype=_I32, device=dev)
    hv = [zero] * HEADER_SLOTS_B
    hl = [zero] * HEADER_SLOTS_B
    if t8_mode:
        hl[8] = (inter & (cbp_l > 0)).to(_I32)

    hv[0], hl[0] = _skip_run_codes(coded)

    mb_type = bmode.to(_I32)
    if i16_mode is not None:
        mb_type = torch.where(intra, 23 + 1 + i16_mode.to(_I32) + 4 * cbp_c
                              + 12 * (cbp_l != 0), mb_type)
    v, ln = ue_codes(mb_type)
    hv[1], hl[1] = v, torch.where(coded, ln, 0)

    if chroma_mode is not None:
        v, ln = ue_codes(chroma_mode)
        hv[2], hl[2] = torch.where(intra, v, 0), torch.where(intra, ln, 0)

    use0 = inter & ((bmode == B_L0) | (bmode == B_BI))
    use1 = inter & ((bmode == B_L1) | (bmode == B_BI))
    for c in range(2):
        v, ln = se_codes(mvd0[:, c])
        hv[3 + c], hl[3 + c] = (torch.where(use0, v, 0),
                                torch.where(use0, ln, 0))
        v, ln = se_codes(mvd1[:, c])
        hv[5 + c], hl[5 + c] = (torch.where(use1, v, 0),
                                torch.where(use1, ln, 0))

    v, ln = _cbp_codes(cbp_c, cbp_l)
    hv[7], hl[7] = v, torch.where(inter, ln, 0)

    emits = coded & ((cbp_l != 0) | (cbp_c != 0) | intra)
    hv[9], hl[9] = _qp_delta_codes(emits, qp_mb)
    return _stack(hv, hl)
