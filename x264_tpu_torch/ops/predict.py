"""Intra 16x16 and chroma prediction, all modes at once (port of the I16
and chroma half of x264_tpu/ops/device/predict.py; parity: reference
common/predict.c).  Edge vectors come from the wavefront driver; each
function emits every mode so mode decision is a batched argmin."""

from __future__ import annotations

import torch

_I32 = torch.int32


def _dc(at, al, st, sl, both_add, both_sh, one_add, one_sh):
    return torch.where(at & al, (st + sl + both_add) >> both_sh,
           torch.where(at, (st + one_add) >> one_sh,
           torch.where(al, (sl + one_add) >> one_sh,
                       torch.full_like(st, 128))))


def _gradient(edge, tl, half: int):
    """sum_{x=1..half} x * (edge[half-1+x] - edge[half-1-x]) with
    edge[-1] = topleft (the plane-mode H / V gradient)."""
    ext = torch.cat([tl[:, None], edge], dim=1)          # index + 1
    xp = torch.arange(1, half + 1, dtype=_I32, device=edge.device)
    idx = torch.arange(half, device=edge.device)
    return (xp[None, :] * (ext[:, half + 1 + idx] - ext[:, half - 1 - idx])
            ).sum(1, dtype=_I32)


def predict_16x16_all(top, left, topleft, avail_top, avail_left):
    """top (N,16), left (N,16), topleft (N,), avail_* (N,) bool
    -> (N, 4, 16, 16) int32 [V, H, DC, Plane]."""
    n = top.shape[0]
    t = top.to(_I32)
    l = left.to(_I32)
    tl = topleft.to(_I32)
    at = avail_top.bool()
    al = avail_left.bool()

    v = t[:, None, :].expand(n, 16, 16)
    h = l[:, :, None].expand(n, 16, 16)
    dc_val = _dc(at, al, t.sum(1, dtype=_I32), l.sum(1, dtype=_I32),
                 16, 5, 8, 4)
    dc = dc_val[:, None, None].expand(n, 16, 16)

    b = (5 * _gradient(t, tl, 8) + 32) >> 6
    c = (5 * _gradient(l, tl, 8) + 32) >> 6
    a = 16 * (l[:, 15] + t[:, 15])
    xg = torch.arange(16, dtype=_I32, device=top.device)
    plane = ((a[:, None, None]
              + b[:, None, None] * (xg[None, None, :] - 7)
              + c[:, None, None] * (xg[None, :, None] - 7) + 16) >> 5
             ).clamp(0, 255)
    return torch.stack([v, h, dc, plane], dim=1)


def predict_chroma_all(top, left, topleft, avail_top, avail_left):
    """top (N,8), left (N,8) -> (N, 4, 8, 8) [DC, H, V, Plane]."""
    n = top.shape[0]
    t = top.to(_I32)
    l = left.to(_I32)
    tl = topleft.to(_I32)
    at = avail_top.bool()
    al = avail_left.bool()

    st0, st1 = t[:, :4].sum(1, dtype=_I32), t[:, 4:].sum(1, dtype=_I32)
    sl0, sl1 = l[:, :4].sum(1, dtype=_I32), l[:, 4:].sum(1, dtype=_I32)
    k128 = torch.full_like(st0, 128)
    q00 = _dc(at, al, st0, sl0, 4, 3, 2, 2)
    q11 = _dc(at, al, st1, sl1, 4, 3, 2, 2)
    q10 = torch.where(at, (st1 + 2) >> 2,
                      torch.where(al, (sl0 + 2) >> 2, k128))
    q01 = torch.where(al, (sl1 + 2) >> 2,
                      torch.where(at, (st0 + 2) >> 2, k128))

    yy = torch.arange(8, device=top.device)[None, :, None]
    xx = torch.arange(8, device=top.device)[None, None, :]
    dc = torch.where((yy < 4) & (xx < 4), q00[:, None, None],
         torch.where((yy < 4) & (xx >= 4), q10[:, None, None],
         torch.where((yy >= 4) & (xx < 4), q01[:, None, None],
                     q11[:, None, None])))

    h = l[:, :, None].expand(n, 8, 8)
    v = t[:, None, :].expand(n, 8, 8)
    a = 16 * (l[:, 7] + t[:, 7])
    b = (17 * _gradient(t, tl, 4) + 16) >> 5
    c = (17 * _gradient(l, tl, 4) + 16) >> 5
    xg = torch.arange(8, dtype=_I32, device=top.device)
    plane = ((a[:, None, None]
              + b[:, None, None] * (xg[None, None, :] - 3)
              + c[:, None, None] * (xg[None, :, None] - 3) + 16) >> 5
             ).clamp(0, 255)
    return torch.stack([dc, h, v, plane], dim=1)


def i16x16_mode_avail(at, al, atl):
    """(N,) bools -> (N,4) mode mask [V, H, DC, Plane]."""
    return torch.stack([at, al, torch.ones_like(at), at & al & atl], dim=-1)


def chroma_mode_avail(at, al, atl):
    """(N,) bools -> (N,4) mode mask [DC, H, V, Plane]."""
    return torch.stack([torch.ones_like(at), al, at, at & al & atl], dim=-1)
