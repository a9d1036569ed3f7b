"""Motion compensation (port of x264_tpu/ops/device/mc.py's half-pel
planes and chroma MC; parity: reference common/mc.c): the 6-tap half-pel
planes and the normative 1/8-pel bilinear chroma interpolation, as
index gathers over edge-padded planes."""

from __future__ import annotations

import torch

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


def _chroma_windows(planes, mv, mbw: int, mbh: int, pad_c: int):
    """(P, Hc, Wc) stacked padded planes -> (P, N, 9, 9) int32 windows at
    each MB's integer chroma position, plus the (N,1,1) fractions."""
    n = mbw * mbh
    dev = mv.device
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    y0 = pad_c + mby * 8 + (mv[:, 1] >> 3)
    x0 = pad_c + mbx * 8 + (mv[:, 0] >> 3)
    r9 = torch.arange(9, dtype=_I32, device=dev)
    yi = (y0[:, None, None] + r9[None, :, None]).long()
    xi = (x0[:, None, None] + r9[None, None, :]).long()
    a = planes[:, yi, xi].to(_I32)
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
                 pad_c: int):
    """Both chroma planes from one window gather.  Returns (pred_u,
    pred_v), each (N,8,8) int32; bit-identical to two mc_chroma calls."""
    a, fx, fy = _chroma_windows(torch.stack([ref_u_pad, ref_v_pad]), mv,
                                mbw, mbh, pad_c)
    pred = _bilinear(a, fx[None], fy[None])
    return pred[0], pred[1]
