"""In-loop deblocking (spec 8.7; port of x264_tpu/ops/device/deblock.py
for I and P frames, per-MB or per-quadrant motion, and B frames; parity:
reference common/deblock.c).

Boundary strengths are a pure function of (MB class, nnz, mv, ref) and
are computed for every edge at once (``bs_grids``, ``bs_grids_b``); the
pixel filter has
the MB wavefront dependency and runs in ``kernels/deblock`` (one CUDA
kernel for Y, Cb and Cr on the card, the plain diagonal-batched twin on
the CPU).  The edge arithmetic below is shared by that twin and mirrors
the reference's ``_luma_filter_params`` / ``_chroma_filter_params``."""

from __future__ import annotations

import torch

from x264_tpu_torch.state import tables

_I32 = torch.int32


def _rep4(g):
    """(mbh, mbw, ...) -> (4mbh, 4mbw, ...): each MB value over its 4x4
    grid of 4x4 blocks."""
    return g.repeat_interleave(4, 0).repeat_interleave(4, 1)


def _shift_in(g, axis: int):
    """Neighbour grid: out[..i..] = g[..i-1..] along ``axis``, 0 at i=0."""
    out = torch.zeros_like(g)
    if axis == 1:
        out[:, 1:] = g[:, :-1]
    else:
        out[1:] = g[:-1]
    return out


def _no_t8_inner(bs, t8, axis: int, mbw: int, mbh: int):
    """Zero the inner 4x4 edges (odd edge columns or rows) of the MBs
    coded with the 8x8 transform: only edges 0 and 2 exist there (8.7)."""
    if t8 is None:
        return bs
    pos = torch.arange(bs.shape[axis], device=bs.device)
    odd = (pos % 2 == 1)[None, :] if axis == 1 else (pos % 2 == 1)[:, None]
    return torch.where(_rep4(t8.reshape(mbh, mbw)) & odd, 0, bs)


def bs_grids(mb_intra, luma_nnz, mv, ref, mbw: int, mbh: int, t8=None):
    """Boundary strengths for every 4-px edge.

    mb_intra (N,) bool; luma_nnz (N,16) raster-block; mv (N,2) per MB or
    (N,4,2) per quadrant (partitioned P frames: internal 8x8 edges then
    get the mv-discontinuity bS=1 rule, 8.7.2.1); ref (N,) or (N,4);
    t8 (N,) bool or None: MBs coded with the 8x8 transform do not filter
    their interior 4x4 luma edges.  Returns (bs_v, bs_h) (4*mbh, 4*mbw)
    int32: bs_v[gy,gx] = strength of the vertical edge left of block
    (gy,gx); frame-boundary edges are 0."""
    gh, gw = 4 * mbh, 4 * mbw
    nnz = (luma_nnz.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3)
           .reshape(gh, gw))
    intra_g = _rep4(mb_intra.reshape(mbh, mbw))
    if mv.dim() == 3:        # quadrant-granular (q = 2*qy + qx)
        mv_g = (mv.reshape(mbh, mbw, 2, 2, 2).repeat_interleave(2, 2)
                .repeat_interleave(2, 3).permute(0, 2, 1, 3, 4)
                .reshape(gh, gw, 2))
        ref_g = (ref.reshape(mbh, mbw, 2, 2).repeat_interleave(2, 2)
                 .repeat_interleave(2, 3).permute(0, 2, 1, 3)
                 .reshape(gh, gw))
    else:
        mv_g = _rep4(mv.reshape(mbh, mbw, 2))
        ref_g = _rep4(ref.reshape(mbh, mbw))
    col = torch.arange(gw, device=mv.device)[None, :]
    row = torch.arange(gh, device=mv.device)[:, None]

    def one_dir(axis):
        p_nnz, p_intra = _shift_in(nnz, axis), _shift_in(intra_g, axis)
        p_mv, p_ref = _shift_in(mv_g, axis), _shift_in(ref_g, axis)
        pos = col if axis == 1 else row
        mb_edge = (pos % 4) == 0
        exists = pos > 0
        nz = (nnz > 0) | (p_nnz > 0)
        mvdiff = ((ref_g != p_ref)
                  | ((mv_g[..., 0] - p_mv[..., 0]).abs() >= 4)
                  | ((mv_g[..., 1] - p_mv[..., 1]).abs() >= 4))
        bs = torch.where(mb_edge & (intra_g | p_intra), 4,
             torch.where(intra_g, 3,
             torch.where(nz, 2, torch.where(mvdiff, 1, 0))))
        bs = _no_t8_inner(bs, t8, axis, mbw, mbh)
        return torch.where(exists, bs, 0).to(_I32)

    return one_dir(1), one_dir(0)


def bs_grids_b(luma_nnz, mv0, mv1, any0, any1, mbw: int, mbh: int,
               intra=None, t8=None):
    """Boundary strengths of a B frame (8.7.2.1's B rules; port of
    x264_tpu/ops/device/deblock.py ``bs_grids_b``).  B MBs use one
    reference per list and L0 != L1, so an MB's reference set is its
    (uses L0, uses L1) pair.  mv0/mv1 (N,2) or (N,4,2) per quadrant;
    any0/any1 (N,) bool; intra (N,) bool or None: I16x16 escape MBs, bS 4
    on their MB edges and 3 inside; t8 as in ``bs_grids``.  Returns
    (bs_v, bs_h) as ``bs_grids`` does."""
    gh, gw = 4 * mbh, 4 * mbw
    nnz = (luma_nnz.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3)
           .reshape(gh, gw))

    def rep_mv(x):
        """(N,2) or (N,4,2) -> per-4x4-block (gh, gw, 2)."""
        if x.dim() == 2:
            return _rep4(x.reshape(mbh, mbw, 2))
        return (x.reshape(mbh, mbw, 2, 2, 2).repeat_interleave(2, 2)
                .repeat_interleave(2, 3).permute(0, 2, 1, 3, 4)
                .reshape(gh, gw, 2))

    m0, m1 = rep_mv(mv0), rep_mv(mv1)
    a0 = _rep4(any0.reshape(mbh, mbw).to(_I32))
    a1 = _rep4(any1.reshape(mbh, mbw).to(_I32))
    ig = None if intra is None else _rep4(intra.reshape(mbh, mbw))
    col = torch.arange(gw, device=nnz.device)[None, :]
    row = torch.arange(gh, device=nnz.device)[:, None]

    def one_dir(axis):
        pos = col if axis == 1 else row
        exists = pos > 0
        mb_edge = (pos % 4) == 0
        nz = (nnz > 0) | (_shift_in(nnz, axis) > 0)
        set_diff = (a0 != _shift_in(a0, axis)) | (a1 != _shift_in(a1, axis))
        d0 = ((m0 - _shift_in(m0, axis)).abs() >= 4).any(-1) & (a0 > 0)
        d1 = ((m1 - _shift_in(m1, axis)).abs() >= 4).any(-1) & (a1 > 0)
        bs = torch.where(nz, 2, torch.where(set_diff | d0 | d1, 1, 0))
        if ig is not None:
            bs = torch.where(mb_edge & (ig | _shift_in(ig, axis)), 4,
                             torch.where(ig, 3, bs))
        bs = _no_t8_inner(bs, t8, axis, mbw, mbh)
        return torch.where(exists, bs, 0).to(_I32)

    return one_dir(1), one_dir(0)


def edge_tables(bs, qp_av, off_a: int, off_b: int):
    """(on, bs4, alpha, beta, tc0) per edge line from bS and averaged QP."""
    tb = tables(bs.device)
    idx_a = (qp_av + off_a).clamp(0, 51).long()
    idx_b = (qp_av + off_b).clamp(0, 51).long()
    return (bs > 0, bs == 4, tb.alpha[idx_a], tb.beta[idx_b],
            tb.tc0[idx_a, bs.clamp(1, 3).long() - 1])


def luma_filter_params(p3, p2, p1, p0, q0, q1, q2, q3,
                       on, bs4, alpha, beta, tc0):
    """Normative luma edge filter (8.7.2.2/.3) on per-line parameters:
    on = bs>0, bs4 = bs==4, alpha/beta/tc0 table values.  Returns the
    new (p2, p1, p0, q0, q1, q2)."""
    filt = on & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    tc = tc0 + ap.to(_I32) + aq.to(_I32)
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = (p0 + delta).clamp(0, 255)
    q0_n = (q0 - delta).clamp(0, 255)
    p1_n = torch.where(ap, p1 + torch.clamp(
        (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0), p1)
    q1_n = torch.where(aq, q1 + torch.clamp(
        (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0), q1)

    strong = (p0 - q0).abs() < ((alpha >> 2) + 2)
    sp = ap & strong
    sq = aq & strong
    p0_s = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
    p1_s = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2_s = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0_s = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
    q1_s = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2_s = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    return (torch.where(filt & bs4, p2_s, p2),
            torch.where(filt, torch.where(bs4, p1_s, p1_n), p1),
            torch.where(filt, torch.where(bs4, p0_s, p0_n), p0),
            torch.where(filt, torch.where(bs4, q0_s, q0_n), q0),
            torch.where(filt, torch.where(bs4, q1_s, q1_n), q1),
            torch.where(filt & bs4, q2_s, q2))


def chroma_filter_params(p1, p0, q0, q1, on, bs4, alpha, beta, tc0):
    """Normative chroma edge filter (8.7.2.2/.3), parameter form.
    Returns the new (p0, q0)."""
    filt = (on & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = tc0 + 1
    delta = torch.clamp((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    p0_n = (p0 + delta).clamp(0, 255)
    q0_n = (q0 - delta).clamp(0, 255)
    p0_s = (2 * p1 + p0 + q1 + 2) >> 2
    q0_s = (2 * q1 + q0 + p1 + 2) >> 2
    return (torch.where(filt, torch.where(bs4, p0_s, p0_n), p0),
            torch.where(filt, torch.where(bs4, q0_s, q0_n), q0))


def deblock_prep(mb_class, cbp_luma, cbp_chroma, luma_nnz, mv, ref, qp_mb,
                 mbw: int, mbh: int, cqp_off: int = 0, t8=None):
    """The decoder-visible QP chain (7.4.5: an MB that emits no residual
    carries the previous QP), the chroma QP lookup and the strengths (t8
    as in ``bs_grids``).  Returns (bs_v, bs_h, qp_mb (N,), qpc_mb
    (N,))."""
    n = mbw * mbh
    dev = mb_class.device
    qp_mb = torch.as_tensor(qp_mb, dtype=_I32, device=dev).reshape(-1) \
        .expand(n)
    emits = (mb_class != 3) & ((cbp_luma != 0) | (cbp_chroma != 0)
                               | (mb_class == 0))
    idx = torch.where(emits, torch.arange(n, device=dev), -1)
    last = torch.cummax(idx, 0).values
    qp_mb = torch.where(last >= 0, qp_mb[last.clamp(min=0)], qp_mb[0])
    qpc_mb = tables(dev).chroma_qp[(qp_mb + cqp_off).clamp(0, 51).long()]
    bs_v, bs_h = bs_grids(mb_class <= 1, luma_nnz, mv, ref, mbw, mbh, t8=t8)
    return bs_v, bs_h, qp_mb, qpc_mb


def deblock_frame(y, u, v, mb_class, cbp_luma, cbp_chroma, luma_nnz, mv,
                  ref, qp_mb, off_a: int, off_b: int, mbw: int, mbh: int,
                  cqp_off: int = 0, t8=None):
    """Anchor deblock: QP chain, chroma QP, strengths (t8: the MBs coded
    with the 8x8 transform, or None) and the filter.  Returns new
    (y, u, v) uint8 planes; the inputs are left as they are."""
    from x264_tpu_torch.kernels.deblock import deblock_filter
    bs_v, bs_h, qp, qpc = deblock_prep(mb_class, cbp_luma, cbp_chroma,
                                       luma_nnz, mv, ref, qp_mb, mbw, mbh,
                                       cqp_off, t8=t8)
    return deblock_filter(y, u, v, bs_v, bs_h, qp, qpc, off_a, off_b,
                          mbw, mbh)


def deblock_frame_b(y, u, v, luma_nnz, mv0, mv1, any0, any1, qp: int,
                    off_a: int, off_b: int, mbw: int, mbh: int,
                    cqp_off: int = 0, intra=None, t8=None):
    """B-frame deblock (port of x264_tpu/ops/device/deblock.py
    ``deblock_frame_b``): the frame QP on every MB, the chroma QP lookup,
    the two-list strengths (t8 as in ``bs_grids``) and the filter
    (``kernels/deblock``).  Returns new (y, u, v) uint8 planes."""
    from x264_tpu_torch.kernels.deblock import deblock_filter
    n = mbw * mbh
    dev = y.device
    qp_mb = torch.full((n,), int(qp), dtype=_I32, device=dev)
    qpc_mb = tables(dev).chroma_qp[(qp_mb + cqp_off).clamp(0, 51).long()]
    bs_v, bs_h = bs_grids_b(luma_nnz, mv0, mv1, any0, any1, mbw, mbh,
                            intra=intra, t8=t8)
    return deblock_filter(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a, off_b,
                          mbw, mbh)


def deblock_core(y, u, v, mb_intra, luma_nnz, mv, ref, qp_mb, qpc_mb,
                 off_a: int, off_b: int, mbw: int, mbh: int):
    """The host-syntax path's deblock (port of x264_tpu/ops/device/
    deblock.py ``deblock_core``): the strengths from a FrameSyntax's
    intra MBs, luma nnz and 16x16 mvs and refs, and the filter, at the
    decoder-visible QPs and chroma QPs the caller gives (N,) int32 tensors
    all.  Returns new (y, u, v) uint8 planes."""
    from x264_tpu_torch.kernels.deblock import deblock_filter
    bs_v, bs_h = bs_grids(mb_intra, luma_nnz, mv, ref, mbw, mbh)
    return deblock_filter(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a, off_b,
                          mbw, mbh)
