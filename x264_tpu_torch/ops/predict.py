"""Intra prediction, all modes at once (port of
x264_tpu/ops/device/predict.py: I16x16, chroma, I4x4 and I8x8 with the
8.3.2.2.1 filtered edges; parity: reference common/predict.c).  Edge
vectors come from the wavefront driver; each function emits every mode
so mode decision is a batched argmin."""

from __future__ import annotations

import functools

import numpy as np
import torch

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _const(device: str, raw: bytes, dtype: str, shape: tuple):
    return torch.from_numpy(np.frombuffer(raw, dtype).reshape(shape).copy()) \
        .to(device)


def _static(a, device):
    """A static numpy array (an index grid or a mask) as a tensor on
    ``device``, made once per device and array."""
    a = np.ascontiguousarray(a)
    return _const(str(device), a.tobytes(), a.dtype.str, a.shape)


def _take(edge, idx):
    """edge (N, k) at the static (s, s) grid idx of edge positions, -1 for
    the corner held at edge[:, 0] -> (N, s, s) (the reference's T()/L())."""
    s = idx.shape[0]
    i = _static((np.asarray(idx) + 1).reshape(-1).astype(np.int64),
                edge.device)
    return edge[:, i].reshape(-1, s, s)


def _sel(mask, a, b):
    """torch.where with a static numpy mask."""
    return torch.where(_static(np.asarray(mask), a.device), a, b)


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


def predict_4x4_all(top8, left, topleft, avail_top, avail_left, avail_tr):
    """I4x4, all 9 modes (8.3.1.2): top8 (N,8) = p[0..7,-1] (the top-right
    half replaced by p[3,-1] when !avail_tr, 8.3.1.2.1), left (N,4),
    topleft (N,) -> (N, 9, 4, 4) int32 [V, H, DC, DDL, DDR, VR, HD, VL,
    HU]."""
    n = top8.shape[0]
    t = top8.to(_I32)
    t = torch.cat([t[:, :4], torch.where(avail_tr[:, None].bool(), t[:, 4:],
                                         t[:, 3:4])], dim=1)
    l = left.to(_I32)
    tl = topleft.to(_I32)
    at = avail_top.bool()
    al = avail_left.bool()
    y, x = np.mgrid[0:4, 0:4]
    tt = torch.cat([tl[:, None], t], dim=1)          # (N, 9), index + 1
    ll = torch.cat([tl[:, None], l], dim=1)          # (N, 5)

    def T(idx):
        return _take(tt, idx)

    def L(idx):
        return _take(ll, idx)

    def full(v):
        return v[:, None, None].expand(n, 4, 4)

    m0 = t[:, None, :4].expand(n, 4, 4)
    m1 = l[:, :, None].expand(n, 4, 4)
    m2 = full(_dc(at, al, t[:, :4].sum(1, dtype=_I32), l.sum(1, dtype=_I32),
                  4, 3, 2, 2))

    s = x + y
    ddl = (T(s.clip(max=5)) + 2 * T((s + 1).clip(max=6))
           + T((s + 2).clip(max=7)) + 2) >> 2
    m3 = _sel((x == 3) & (y == 3), full((t[:, 6] + 3 * t[:, 7] + 2) >> 2),
              ddl)

    z = x - y
    ddr_t = (T((z - 2).clip(-1)) + 2 * T((z - 1).clip(-1))
             + T(z.clip(-1)) + 2) >> 2
    w = y - x
    ddr_l = (L((w - 2).clip(-1)) + 2 * L((w - 1).clip(-1))
             + L(w.clip(-1)) + 2) >> 2
    diag = full((t[:, 0] + 2 * tl + l[:, 0] + 2) >> 2)
    m4 = _sel(z > 0, ddr_t, _sel(z < 0, ddr_l, diag))

    zvr = 2 * x - y
    i = x - (y >> 1)
    vr_even = (T((i - 1).clip(-1)) + T(i.clip(-1)) + 1) >> 1
    vr_odd = (T((i - 2).clip(-1)) + 2 * T((i - 1).clip(-1))
              + T(i.clip(-1)) + 2) >> 2
    vr_m1 = full((l[:, 0] + 2 * tl + t[:, 0] + 2) >> 2)
    vr_lo = (L((y - 1).clip(-1)) + 2 * L((y - 2).clip(-1))
             + L((y - 3).clip(-1)) + 2) >> 2
    m5 = _sel(zvr >= 0, _sel(zvr % 2 == 0, vr_even, vr_odd),
              _sel(zvr == -1, vr_m1, vr_lo))

    zhd = 2 * y - x
    j = y - (x >> 1)
    hd_even = (L((j - 1).clip(-1)) + L(j.clip(-1)) + 1) >> 1
    hd_odd = (L((j - 2).clip(-1)) + 2 * L((j - 1).clip(-1))
              + L(j.clip(-1)) + 2) >> 2
    hd_lo = (T((x - 1).clip(-1)) + 2 * T((x - 2).clip(-1))
             + T((x - 3).clip(-1)) + 2) >> 2
    m6 = _sel(zhd >= 0, _sel(zhd % 2 == 0, hd_even, hd_odd),
              _sel(zhd == -1, vr_m1, hd_lo))

    k = x + (y >> 1)
    vl_even = (T(k) + T((k + 1).clip(max=7)) + 1) >> 1
    vl_odd = (T(k) + 2 * T((k + 1).clip(max=7))
              + T((k + 2).clip(max=7)) + 2) >> 2
    m7 = _sel(y % 2 == 0, vl_even, vl_odd)

    zhu = x + 2 * y
    m = y + (x >> 1)
    hu_even = (L(m.clip(max=3)) + L((m + 1).clip(max=3)) + 1) >> 1
    hu_odd = (L(m.clip(max=3)) + 2 * L((m + 1).clip(max=3))
              + L((m + 2).clip(max=3)) + 2) >> 2
    m8 = _sel(zhu > 5, full(l[:, 3]),
              _sel(zhu == 5, full((l[:, 2] + 3 * l[:, 3] + 2) >> 2),
                   _sel(zhu % 2 == 0, hu_even, hu_odd)))
    return torch.stack([m0, m1, m2, m3, m4, m5, m6, m7, m8], dim=1)


def i4x4_mode_avail(at, al, atl):
    """(N,) bools -> (N,9) [V, H, DC, DDL, DDR, VR, HD, VL, HU]."""
    full = at & al & atl
    return torch.stack([at, al, torch.ones_like(at), at, full, full, full,
                        at, al], dim=-1)


def predict_8x8_all(top16, left8, topleft, avail_top, avail_left,
                    avail_tl, avail_tr):
    """All 9 Intra_8x8 modes from raw edges, the 8.3.2.2.1 low-pass
    filter applied here: top16 (N,16) p[0..15,-1] (the top-right half
    replaced by p[7,-1] when !avail_tr), left8 (N,8), topleft (N,) ->
    (N, 9, 8, 8) int32, order [V, H, DC, DDL, DDR, VR, HD, VL, HU]."""
    n = top16.shape[0]
    t = top16.to(_I32)
    l8 = left8.to(_I32)
    tl = topleft.to(_I32)
    at, al = avail_top.bool(), avail_left.bool()
    atl, atr = avail_tl.bool(), avail_tr.bool()

    t = torch.where(atr[:, None], t,
                    torch.cat([t[:, :8], t[:, 7:8].expand(n, 8)], dim=1))
    ft0 = torch.where(atl, (tl + 2 * t[:, 0] + t[:, 1] + 2) >> 2,
                      (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    ftm = (t[:, 0:14] + 2 * t[:, 1:15] + t[:, 2:16] + 2) >> 2
    ft15 = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    fl0 = torch.where(atl, (tl + 2 * l8[:, 0] + l8[:, 1] + 2) >> 2,
                      (3 * l8[:, 0] + l8[:, 1] + 2) >> 2)
    flm = (l8[:, 0:6] + 2 * l8[:, 1:7] + l8[:, 2:8] + 2) >> 2
    fl7 = (l8[:, 6] + 3 * l8[:, 7] + 2) >> 2
    ftl = torch.where(at & al, (t[:, 0] + 2 * tl + l8[:, 0] + 2) >> 2,
          torch.where(at, (3 * tl + t[:, 0] + 2) >> 2,
          torch.where(al, (3 * tl + l8[:, 0] + 2) >> 2, tl)))
    t = torch.cat([ft0[:, None], ftm, ft15[:, None]], dim=1)
    l8 = torch.cat([fl0[:, None], flm, fl7[:, None]], dim=1)
    tl = ftl

    yg, xg = np.mgrid[0:8, 0:8]
    tt = torch.cat([tl[:, None], t], dim=1)          # (N, 17)
    ll = torch.cat([tl[:, None], l8], dim=1)         # (N, 9)

    def T(idx):
        return _take(tt, idx)

    def L(idx):
        return _take(ll, idx)

    def full(v):
        return v[:, None, None].expand(n, 8, 8)

    v = t[:, None, :8].expand(n, 8, 8)
    hm = l8[:, :, None].expand(n, 8, 8)
    dc = full(_dc(at, al, t[:, :8].sum(1, dtype=_I32),
                  l8.sum(1, dtype=_I32), 8, 4, 4, 3))

    s = xg + yg
    ddl = (T(s) + 2 * T((s + 1).clip(max=15)) + T((s + 2).clip(max=15))
           + 2) >> 2
    ddl = _sel((xg == 7) & (yg == 7), full((t[:, 14] + 3 * t[:, 15] + 2)
                                           >> 2), ddl)

    z = xg - yg
    ddr_t = (T((z - 2).clip(-1)) + 2 * T((z - 1).clip(-1)) + T(z.clip(-1))
             + 2) >> 2
    w = yg - xg
    ddr_l = (L((w - 2).clip(-1)) + 2 * L((w - 1).clip(-1)) + L(w.clip(-1))
             + 2) >> 2
    diag = full((t[:, 0] + 2 * tl + l8[:, 0] + 2) >> 2)
    ddr = _sel(z > 0, ddr_t, _sel(z < 0, ddr_l, diag))

    zvr = 2 * xg - yg
    i = xg - (yg >> 1)
    vr_even = (T((i - 1).clip(-1)) + T(i.clip(-1)) + 1) >> 1
    vr_odd = (T((i - 2).clip(-1)) + 2 * T((i - 1).clip(-1)) + T(i.clip(-1))
              + 2) >> 2
    vr_m1 = full((l8[:, 0] + 2 * tl + t[:, 0] + 2) >> 2)
    q = yg - 2 * xg
    vr_lo = (L((q - 1).clip(-1)) + 2 * L((q - 2).clip(-1))
             + L((q - 3).clip(-1)) + 2) >> 2
    vr = _sel(zvr >= 0, _sel(zvr % 2 == 0, vr_even, vr_odd),
              _sel(zvr == -1, vr_m1, vr_lo))

    zhd = 2 * yg - xg
    j = yg - (xg >> 1)
    hd_even = (L((j - 1).clip(-1)) + L(j.clip(-1)) + 1) >> 1
    hd_odd = (L((j - 2).clip(-1)) + 2 * L((j - 1).clip(-1)) + L(j.clip(-1))
              + 2) >> 2
    r = xg - 2 * yg
    hd_lo = (T((r - 1).clip(-1)) + 2 * T((r - 2).clip(-1))
             + T((r - 3).clip(-1)) + 2) >> 2
    hd = _sel(zhd >= 0, _sel(zhd % 2 == 0, hd_even, hd_odd),
              _sel(zhd == -1, vr_m1, hd_lo))

    k = xg + (yg >> 1)
    vl_even = (T(k) + T((k + 1).clip(max=15)) + 1) >> 1
    vl_odd = (T(k) + 2 * T((k + 1).clip(max=15)) + T((k + 2).clip(max=15))
              + 2) >> 2
    vl = _sel(yg % 2 == 0, vl_even, vl_odd)

    zhu = xg + 2 * yg
    m = yg + (xg >> 1)
    hu_even = (L(m.clip(max=7)) + L((m + 1).clip(max=7)) + 1) >> 1
    hu_odd = (L(m.clip(max=7)) + 2 * L((m + 1).clip(max=7))
              + L((m + 2).clip(max=7)) + 2) >> 2
    hu = _sel(zhu > 13, full(l8[:, 7]),
              _sel(zhu == 13, full((l8[:, 6] + 3 * l8[:, 7] + 2) >> 2),
                   _sel(zhu % 2 == 0, hu_even, hu_odd)))
    return torch.stack([v, hm, dc, ddl, ddr, vr, hd, vl, hu], dim=1)


def i8x8_mode_avail(at, al, atl):
    """Same lattice as I4x4 (edge filtering covers substitution)."""
    return i4x4_mode_avail(at, al, atl)
