"""Motion compensation (port of x264_tpu/ops/device/mc.py's half-pel
planes, fullpel luma MC, quarter-pel luma MC per MB and per quadrant, and
chroma MC; parity: reference
common/mc.c): the 6-tap half-pel planes, every quarter-pel sample as the
rounded mean of two plane samples, and the normative 1/8-pel bilinear
chroma interpolation, as index gathers over edge-padded planes."""

from __future__ import annotations

import functools

import torch

from x264_tpu_torch.state import QPEL_TWO_SAMPLE_TBL

_I32 = torch.int32


def pad_edge(plane, pad: int):
    """Edge-replicate ``pad`` samples on every side of the last two dims
    (``jnp.pad(mode="edge")``); works for every dtype on every device."""
    h, w = plane.shape[-2], plane.shape[-1]
    ri = torch.arange(-pad, h + pad, device=plane.device).clamp(0, h - 1)
    ci = torch.arange(-pad, w + pad, device=plane.device).clamp(0, w - 1)
    return plane[..., ri[:, None], ci[None, :]]


def filt6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def hpel_planes(plane):
    """(H, W) int -> (4, H, W) int32 stacked [fp, hh, hv, hc]
    (bit-exact port of ops/reference/mc.hpel_planes with pad=4)."""
    pad = 4
    p = pad_edge(plane.to(_I32), pad)

    bh_full = filt6(p[:, :-5], p[:, 1:-4], p[:, 2:-3],
                    p[:, 3:-2], p[:, 4:-1], p[:, 5:])
    bh = bh_full[:, pad - 2: bh_full.shape[1] - pad + 3]
    hh = ((bh[pad:-pad, :] + 16) >> 5).clamp(0, 255)

    bv_full = filt6(p[:-5, :], p[1:-4, :], p[2:-3, :],
                    p[3:-2, :], p[4:-1, :], p[5:, :])
    bv = bv_full[pad - 2: bv_full.shape[0] - pad + 3, :]
    hv = ((bv[:, pad:-pad] + 16) >> 5).clamp(0, 255)

    cc = filt6(bh[:-5, :], bh[1:-4, :], bh[2:-3, :],
               bh[3:-2, :], bh[4:-1, :], bh[5:, :])
    cc = cc[pad - 2: cc.shape[0] - pad + 3, :]
    hc = ((cc + 512) >> 10).clamp(0, 255)
    return torch.stack([plane.to(_I32), hh, hv, hc])


def _chroma_windows(planes, mv, mbw: int, mbh: int, pad_c: int,
                    ref_idx=None):
    """(P, Hc, Wc) stacked padded planes -> (P, N, 9, 9) int32 windows at
    each MB's integer chroma position, plus the (N,1,1) fractions; with
    ref_idx (N,), planes (P, K, Hc, Wc) and each MB reads its own
    reference."""
    n = mbw * mbh
    dev = mv.device
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    y0 = pad_c + mby * 8 + (mv[:, 1] >> 3)
    x0 = pad_c + mbx * 8 + (mv[:, 0] >> 3)
    r9 = torch.arange(9, dtype=_I32, device=dev)
    yi = (y0[:, None, None] + r9[None, :, None]).long()
    xi = (x0[:, None, None] + r9[None, None, :]).long()
    a = (planes[:, yi, xi] if ref_idx is None
         else planes[:, ref_idx.long()[:, None, None], yi, xi]).to(_I32)
    return a, (mv[:, 0] & 7)[:, None, None], (mv[:, 1] & 7)[:, None, None]


def _bilinear(a, fx, fy):
    p00, p01 = a[..., :8, :8], a[..., :8, 1:]
    p10, p11 = a[..., 1:, :8], a[..., 1:, 1:]
    return ((8 - fx) * (8 - fy) * p00 + fx * (8 - fy) * p01
            + (8 - fx) * fy * p10 + fx * fy * p11 + 32) >> 6


def mc_chroma(ref_c_pad, mv, mbw: int, mbh: int, pad_c: int):
    """Normative 1/8-pel bilinear chroma interpolation (8.4.2.2.2) for all
    MBs at once; mv is the *luma* qpel mv (N,2).  Returns (N,8,8) int32."""
    a, fx, fy = _chroma_windows(ref_c_pad[None], mv, mbw, mbh, pad_c)
    return _bilinear(a[0], fx, fy)


def mc_chroma_uv(ref_u_pad, ref_v_pad, mv, mbw: int, mbh: int,
                 pad_c: int, ref_idx=None):
    """Both chroma planes from one window gather; ref_*_pad (Hc, Wc), or
    stacked (K, Hc, Wc) with ref_idx (N,) each MB's reference.  Returns
    (pred_u, pred_v), each (N,8,8) int32; bit-identical to two mc_chroma
    calls."""
    a, fx, fy = _chroma_windows(torch.stack([ref_u_pad, ref_v_pad]), mv,
                                mbw, mbh, pad_c, ref_idx)
    pred = _bilinear(a, fx[None], fy[None])
    return pred[0], pred[1]


def mc_chroma_uv_quad(ref_u_pad, ref_v_pad, mv8, mbw: int, mbh: int,
                      pad_c: int, ref_idx=None):
    """Per-quadrant chroma MC (port of x264_tpu/ops/device/mc.py
    ``mc_chroma_uv_quad``): mv8 (N,4,2) luma qpel mvs (quadrant q =
    2*qy + qx) -> each 4x4 chroma block interpolated at its own mv
    (8.4.2.2.2, the partitioned-MB case); ref_*_pad (Hc, Wc), or stacked
    (K, Hc, Wc) with ref_idx (N,) each MB's reference, shared by its
    quadrants.  Returns (pred_u, pred_v) (N,8,8) int32; equals
    mc_chroma_uv when all quads share one mv."""
    n = mbw * mbh
    m = 4 * n
    dev = mv8.device
    mvf = mv8.reshape(m, 2)
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    qy = torch.tensor([0, 0, 1, 1], dtype=_I32, device=dev)
    qx = torch.tensor([0, 1, 0, 1], dtype=_I32, device=dev)
    cy = (mby[:, None] * 8 + qy[None, :] * 4).reshape(m)
    cx = (mbx[:, None] * 8 + qx[None, :] * 4).reshape(m)
    y0 = pad_c + cy + (mvf[:, 1] >> 3)
    x0 = pad_c + cx + (mvf[:, 0] >> 3)
    r5 = torch.arange(5, dtype=_I32, device=dev)
    yi = (y0[:, None, None] + r5[None, :, None]).long()
    xi = (x0[:, None, None] + r5[None, None, :]).long()
    uv = torch.stack([ref_u_pad, ref_v_pad])
    if ref_idx is None:
        a = uv[:, yi, xi].to(_I32)                         # (2, M, 5, 5)
    else:
        rix = ref_idx.long().repeat_interleave(4)
        a = uv[:, rix[:, None, None], yi, xi].to(_I32)
    fx = (mvf[:, 0] & 7)[None, :, None, None]
    fy = (mvf[:, 1] & 7)[None, :, None, None]
    p00, p01 = a[:, :, :4, :4], a[:, :, :4, 1:]
    p10, p11 = a[:, :, 1:, :4], a[:, :, 1:, 1:]
    pred = ((8 - fx) * (8 - fy) * p00 + fx * (8 - fy) * p01
            + (8 - fx) * fy * p10 + fx * fy * p11 + 32) >> 6
    pred = (pred.reshape(2, n, 2, 2, 4, 4).permute(0, 1, 2, 4, 3, 5)
            .reshape(2, n, 8, 8))
    return pred[0], pred[1]


@functools.lru_cache(maxsize=None)
def _qpel_table(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(QPEL_TWO_SAMPLE_TBL, dtype=torch.long,
                           device=device)


def mc_luma_fullpel(ref_pad, mv, mbw: int, mbh: int, pad: int):
    """Fullpel luma MC (port of x264_tpu/ops/device/mc.py
    ``mc_luma_fullpel``): each MB's 16x16 block of the padded reference at
    its mv (N,2), qpel units that are multiples of 4.  Returns (N,16,16)
    int32."""
    n = mbw * mbh
    dev = mv.device
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    r16 = torch.arange(16, dtype=_I32, device=dev)
    y0 = pad + mby * 16 + (mv[:, 1] >> 2)
    x0 = pad + mbx * 16 + (mv[:, 0] >> 2)
    yi = (y0[:, None, None] + r16[None, :, None]).long()
    xi = (x0[:, None, None] + r16[None, None, :]).long()
    return ref_pad[yi, xi].to(_I32)


def mc_luma_qpel(planes4, mv, mbw: int, mbh: int, pad: int, ref_idx=None):
    """Quarter-pel luma MC of one mv per MB (port of
    x264_tpu/ops/device/mc.py ``mc_luma_qpel``): planes4 (4, Hp, Wp)
    [fp, hh, hv, hc] from ``hpel_planes`` of the reference padded by
    ``pad``, or stacked (K, 4, Hp, Wp) with ref_idx (N,) each MB's
    reference; mv (N,2) qpel.  Each sample is (S1 + S2 + 1) >> 1 over the
    two plane samples QPEL_TWO_SAMPLE_TBL names, gathered straight from
    the planes (the reference's one-hot ``wingather`` windows hold the
    same samples).  Returns (N,16,16) int32."""
    n = mbw * mbh
    dev = mv.device
    hp, wp = planes4.shape[-2], planes4.shape[-1]
    mv = mv.to(_I32)
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    y0 = pad + mby * 16 + (mv[:, 1] >> 2)
    x0 = pad + mbx * 16 + (mv[:, 0] >> 2)
    tbl = _qpel_table(dev)[(mv[:, 0] & 3).long(), (mv[:, 1] & 3).long()]
    r16 = torch.arange(16, dtype=_I32, device=dev)

    def sample(p, dy, dx):
        yi = ((y0 + dy)[:, None, None] + r16[None, :, None]).clamp(0, hp - 1)
        xi = ((x0 + dx)[:, None, None] + r16[None, None, :]).clamp(0, wp - 1)
        ix = (p[:, None, None], yi.long(), xi.long())
        if ref_idx is not None:
            ix = (ref_idx.long()[:, None, None],) + ix
        return planes4[ix].to(_I32)

    return (sample(tbl[:, 0], tbl[:, 1], tbl[:, 2])
            + sample(tbl[:, 3], tbl[:, 4], tbl[:, 5]) + 1) >> 1


def mc_luma_qpel_quad(planes4, mv8, mbw: int, mbh: int, pad: int):
    """Quarter-pel luma MC per 8x8 quadrant (port of
    x264_tpu/ops/device/mc.py ``mc_luma_qpel_quad``): planes4 (4, Hp, Wp)
    [fp, hh, hv, hc] from ``hpel_planes`` of the reference padded by
    ``pad``; mv8 (N,4,2) qpel mvs (quadrant q = 2*qy + qx).  Each sample
    is (S1 + S2 + 1) >> 1 over the two plane samples QPEL_TWO_SAMPLE_TBL
    names, gathered straight from the planes (the reference gathers 10x10
    windows through its one-hot ``wingather``; the samples are the same).
    Positions past the padded planes read their edge, as a decoder does.
    Returns (N,16,16) int32."""
    n = mbw * mbh
    m = 4 * n
    dev = mv8.device
    hp, wp = planes4.shape[-2], planes4.shape[-1]
    mvf = mv8.reshape(m, 2).to(_I32)
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    qy = torch.tensor([0, 0, 1, 1], dtype=_I32, device=dev)
    qx = torch.tensor([0, 1, 0, 1], dtype=_I32, device=dev)
    y0 = pad + (mby[:, None] * 16 + qy[None, :] * 8).reshape(m) \
        + (mvf[:, 1] >> 2)
    x0 = pad + (mbx[:, None] * 16 + qx[None, :] * 8).reshape(m) \
        + (mvf[:, 0] >> 2)
    tbl = _qpel_table(dev)[(mvf[:, 0] & 3).long(), (mvf[:, 1] & 3).long()]
    r8 = torch.arange(8, dtype=_I32, device=dev)

    def sample(p, dy, dx):
        yi = ((y0 + dy)[:, None, None] + r8[None, :, None]).clamp(0, hp - 1)
        xi = ((x0 + dx)[:, None, None] + r8[None, None, :]).clamp(0, wp - 1)
        return planes4[p[:, None, None], yi.long(), xi.long()].to(_I32)

    pred = (sample(tbl[:, 0], tbl[:, 1], tbl[:, 2])
            + sample(tbl[:, 3], tbl[:, 4], tbl[:, 5]) + 1) >> 1
    return (pred.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n, 16, 16))
