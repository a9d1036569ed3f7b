"""Intra prediction reference kernels (spec 8.3; parity with reference
common/predict.c).

TPU-first layout: every function is batched over N blocks/MBs and generates
*all* prediction modes at once — (N, n_modes, S, S) — so mode decision is a
vectorized cost argmin.  Unavailable-mode masking is the caller's job (via
the availability flags), matching how the reference gates mode lists.

Mode index conventions (these are the normative code numbers):
  I16x16 : 0=V, 1=H, 2=DC, 3=Plane
  Chroma : 0=DC, 1=H, 2=V, 3=Plane
  I4x4   : 0=V, 1=H, 2=DC, 3=DDL, 4=DDR, 5=VR, 6=HD, 7=VL, 8=HU

Copied from x264_tpu/ops/reference/predict.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np


def _clip8(x):
    return np.clip(x, 0, 255)


# -----------------------------------------------------------------------------
# I16x16 (8.3.3)
# -----------------------------------------------------------------------------

def predict_16x16_all(top: np.ndarray, left: np.ndarray, topleft: np.ndarray,
                      avail_top: np.ndarray, avail_left: np.ndarray) -> np.ndarray:
    """top (N,16), left (N,16), topleft (N,), avail_* (N,) bool
    -> (N, 4, 16, 16) int32 predictions."""
    n = top.shape[0]
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    tl = topleft.astype(np.int64)
    at = avail_top.astype(bool)
    al = avail_left.astype(bool)

    v = np.broadcast_to(t[:, None, :], (n, 16, 16))
    h = np.broadcast_to(l[:, :, None], (n, 16, 16))

    st, sl = t.sum(1), l.sum(1)
    dc_val = np.where(at & al, (st + sl + 16) >> 5,
             np.where(at, (st + 8) >> 4,
             np.where(al, (sl + 8) >> 4, 128)))
    dc = np.broadcast_to(dc_val[:, None, None], (n, 16, 16))

    # plane (8.3.3.4)
    xp = np.arange(8, dtype=np.int64) + 1                  # 1..8
    tt = np.concatenate([tl[:, None], t], axis=1)          # tt[k] = p[k-1,-1]
    ll = np.concatenate([tl[:, None], l], axis=1)
    hgrad = (xp[None, :] * (tt[:, 9 + np.arange(8)] - tt[:, 7 - np.arange(8)])).sum(1)
    vgrad = (xp[None, :] * (ll[:, 9 + np.arange(8)] - ll[:, 7 - np.arange(8)])).sum(1)
    b = (5 * hgrad + 32) >> 6
    c = (5 * vgrad + 32) >> 6
    a = 16 * (l[:, 15] + t[:, 15])
    xg = np.arange(16, dtype=np.int64)
    plane = _clip8((a[:, None, None]
                    + b[:, None, None] * (xg[None, None, :] - 7)
                    + c[:, None, None] * (xg[None, :, None] - 7) + 16) >> 5)

    return np.stack([v, h, dc, plane], axis=1).astype(np.int32)


# -----------------------------------------------------------------------------
# Chroma 8x8 (8.3.4), 4:2:0
# -----------------------------------------------------------------------------

def predict_chroma_all(top: np.ndarray, left: np.ndarray, topleft: np.ndarray,
                       avail_top: np.ndarray, avail_left: np.ndarray) -> np.ndarray:
    """top (N,8), left (N,8) -> (N, 4, 8, 8)."""
    n = top.shape[0]
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    tl = topleft.astype(np.int64)
    at = avail_top.astype(bool)
    al = avail_left.astype(bool)

    st0, st1 = t[:, :4].sum(1), t[:, 4:].sum(1)
    sl0, sl1 = l[:, :4].sum(1), l[:, 4:].sum(1)

    def _quad(sum_t, sum_l, corner_both):
        if corner_both:
            return np.where(at & al, (sum_t + sum_l + 4) >> 3,
                   np.where(at, (sum_t + 2) >> 2,
                   np.where(al, (sum_l + 2) >> 2, 128)))
        return None

    q00 = _quad(st0, sl0, True)
    q11 = _quad(st1, sl1, True)
    q10 = np.where(at, (st1 + 2) >> 2, np.where(al, (sl0 + 2) >> 2, 128))  # x>=4,y<4
    q01 = np.where(al, (sl1 + 2) >> 2, np.where(at, (st0 + 2) >> 2, 128))  # x<4,y>=4

    dc = np.empty((n, 8, 8), dtype=np.int64)
    dc[:, :4, :4] = q00[:, None, None]
    dc[:, :4, 4:] = q10[:, None, None]
    dc[:, 4:, :4] = q01[:, None, None]
    dc[:, 4:, 4:] = q11[:, None, None]

    h = np.broadcast_to(l[:, :, None], (n, 8, 8))
    v = np.broadcast_to(t[:, None, :], (n, 8, 8))

    xp = np.arange(4, dtype=np.int64) + 1
    tt = np.concatenate([tl[:, None], t], axis=1)
    ll = np.concatenate([tl[:, None], l], axis=1)
    hgrad = (xp[None, :] * (tt[:, 5 + np.arange(4)] - tt[:, 3 - np.arange(4)])).sum(1)
    vgrad = (xp[None, :] * (ll[:, 5 + np.arange(4)] - ll[:, 3 - np.arange(4)])).sum(1)
    a = 16 * (l[:, 7] + t[:, 7])
    b = (17 * hgrad + 16) >> 5
    c = (17 * vgrad + 16) >> 5
    xg = np.arange(8, dtype=np.int64)
    plane = _clip8((a[:, None, None]
                    + b[:, None, None] * (xg[None, None, :] - 3)
                    + c[:, None, None] * (xg[None, :, None] - 3) + 16) >> 5)

    return np.stack([dc, h, v, plane], axis=1).astype(np.int32)


# -----------------------------------------------------------------------------
# I4x4 (8.3.1.2) — all 9 modes
# -----------------------------------------------------------------------------

def predict_4x4_all(top8: np.ndarray, left: np.ndarray, topleft: np.ndarray,
                    avail_top: np.ndarray, avail_left: np.ndarray,
                    avail_tr: np.ndarray) -> np.ndarray:
    """top8 (N,8) = p[0..7,-1] (top-right half may be garbage when !avail_tr:
    normative substitution with p[3,-1] is applied here), left (N,4), topleft
    (N,).  -> (N, 9, 4, 4) int32."""
    n = top8.shape[0]
    t = top8.astype(np.int64).copy()
    # normative top-right substitution (8.3.1.2.1)
    t[:, 4:] = np.where(avail_tr[:, None].astype(bool), t[:, 4:], t[:, 3:4])
    l = left.astype(np.int64)
    tl = topleft.astype(np.int64)
    at = avail_top.astype(bool)
    al = avail_left.astype(bool)

    y, x = np.mgrid[0:4, 0:4]
    y = y[None]  # (1,4,4)
    x = x[None]

    # padded edge vectors: TT[:, k+1] = p[k,-1] (k=-1..7), LL[:, k+1] = p[-1,k]
    tt = np.concatenate([tl[:, None], t], axis=1)          # (N, 9)
    ll = np.concatenate([tl[:, None], l], axis=1)          # (N, 5)

    def T(idx):  # idx (1,4,4) with values in -1..7
        return np.take_along_axis(
            tt[:, :, None], (idx + 1).reshape(1, 16, 1).repeat(n, 0), axis=1
        ).reshape(n, 4, 4)

    def L(idx):  # values in -1..3
        return np.take_along_axis(
            ll[:, :, None], (idx + 1).reshape(1, 16, 1).repeat(n, 0), axis=1
        ).reshape(n, 4, 4)

    out = np.zeros((n, 9, 4, 4), dtype=np.int64)

    # 0: V, 1: H
    out[:, 0] = np.broadcast_to(t[:, None, :4], (n, 4, 4))
    out[:, 1] = np.broadcast_to(l[:, :, None], (n, 4, 4))

    # 2: DC
    st, sl = t[:, :4].sum(1), l.sum(1)
    dc = np.where(at & al, (st + sl + 4) >> 3,
         np.where(at, (st + 2) >> 2,
         np.where(al, (sl + 2) >> 2, 128)))
    out[:, 2] = dc[:, None, None]

    # 3: DDL
    s = x + y
    ddl = (T(s.clip(max=5)) + 2 * T((s + 1).clip(max=6)) + T((s + 2).clip(max=7)) + 2) >> 2
    corner = (t[:, 6] + 3 * t[:, 7] + 2) >> 2
    out[:, 3] = np.where((x == 3) & (y == 3), corner[:, None, None], ddl)

    # 4: DDR
    z = x - y
    ddr_t = (T((z - 2).clip(-1)) + 2 * T((z - 1).clip(-1)) + T(z.clip(-1)) + 2) >> 2
    w = y - x
    ddr_l = (L((w - 2).clip(-1)) + 2 * L((w - 1).clip(-1)) + L(w.clip(-1)) + 2) >> 2
    diag = (t[:, 0] + 2 * tl + l[:, 0] + 2) >> 2
    out[:, 4] = np.where(z > 0, ddr_t, np.where(z < 0, ddr_l, diag[:, None, None]))

    # 5: VR
    zvr = 2 * x - y
    i = x - (y >> 1)
    vr_even = (T((i - 1).clip(-1)) + T(i.clip(-1)) + 1) >> 1
    vr_odd = (T((i - 2).clip(-1)) + 2 * T((i - 1).clip(-1)) + T(i.clip(-1)) + 2) >> 2
    vr_m1 = ((l[:, 0] + 2 * tl + t[:, 0] + 2) >> 2)[:, None, None]
    vr_lo = (L((y - 1).clip(-1)) + 2 * L((y - 2).clip(-1)) + L((y - 3).clip(-1)) + 2) >> 2
    out[:, 5] = np.where(zvr >= 0, np.where(zvr % 2 == 0, vr_even, vr_odd),
                         np.where(zvr == -1, vr_m1, vr_lo))

    # 6: HD
    zhd = 2 * y - x
    j = y - (x >> 1)
    hd_even = (L((j - 1).clip(-1)) + L(j.clip(-1)) + 1) >> 1
    hd_odd = (L((j - 2).clip(-1)) + 2 * L((j - 1).clip(-1)) + L(j.clip(-1)) + 2) >> 2
    hd_m1 = vr_m1
    hd_lo = (T((x - 1).clip(-1)) + 2 * T((x - 2).clip(-1)) + T((x - 3).clip(-1)) + 2) >> 2
    out[:, 6] = np.where(zhd >= 0, np.where(zhd % 2 == 0, hd_even, hd_odd),
                         np.where(zhd == -1, hd_m1, hd_lo))

    # 7: VL
    k = x + (y >> 1)
    vl_even = (T(k) + T((k + 1).clip(max=7)) + 1) >> 1
    vl_odd = (T(k) + 2 * T((k + 1).clip(max=7)) + T((k + 2).clip(max=7)) + 2) >> 2
    out[:, 7] = np.where(y % 2 == 0, vl_even, vl_odd)

    # 8: HU
    zhu = x + 2 * y
    m = y + (x >> 1)
    hu_even = (L(m.clip(max=3)) + L((m + 1).clip(max=3)) + 1) >> 1
    hu_odd = (L(m.clip(max=3)) + 2 * L((m + 1).clip(max=3)) + L((m + 2).clip(max=3)) + 2) >> 2
    hu_5 = ((l[:, 2] + 3 * l[:, 3] + 2) >> 2)[:, None, None]
    hu_hi = l[:, 3][:, None, None] * np.ones_like(x)
    out[:, 8] = np.where(zhu > 5, hu_hi,
                np.where(zhu == 5, hu_5,
                np.where(zhu % 2 == 0, hu_even, hu_odd)))

    return out.astype(np.int32)


# mode availability masks given neighbor availability
# [V, H, DC, DDL, DDR, VR, HD, VL, HU]
def i4x4_mode_avail(avail_top, avail_left, avail_topleft):
    at = np.asarray(avail_top, dtype=bool)
    al = np.asarray(avail_left, dtype=bool)
    atl = np.asarray(avail_topleft, dtype=bool)
    always = np.ones_like(at)
    full = at & al & atl
    return np.stack([at, al, always, at, full, full, full, at, al], axis=-1)


def i16x16_mode_avail(avail_top, avail_left, avail_topleft):
    at = np.asarray(avail_top, dtype=bool)
    al = np.asarray(avail_left, dtype=bool)
    atl = np.asarray(avail_topleft, dtype=bool)
    always = np.ones_like(at)
    return np.stack([at, al, always, at & al & atl], axis=-1)


def chroma_mode_avail(avail_top, avail_left, avail_topleft):
    at = np.asarray(avail_top, dtype=bool)
    al = np.asarray(avail_left, dtype=bool)
    atl = np.asarray(avail_topleft, dtype=bool)
    always = np.ones_like(at)
    return np.stack([always, al, at, at & al & atl], axis=-1)


# -----------------------------------------------------------------------------
# I8x8 (8.3.2) — reference-sample filtering + all 9 modes
# -----------------------------------------------------------------------------

def filter_8x8_edges(top16, left8, topleft, avail_top, avail_left,
                     avail_tl, avail_tr):
    """8.3.2.2.1 reference sample filtering for Intra_8x8.

    top16 (N,16) = p[0..15,-1] raw (the top-right half may be garbage
    when !avail_tr — the normative substitution with p[7,-1] is applied
    here BEFORE filtering); left8 (N,8) = p[-1,0..7]; topleft (N,).
    Returns (ft (N,16), fl (N,8), ftl (N,)) filtered samples.
    Capability anchor: reference common/predict.c:585 predict_8x8_filter."""
    t = top16.astype(np.int64).copy()
    l8 = left8.astype(np.int64)
    tl = topleft.astype(np.int64)
    at = np.asarray(avail_top, bool)
    al = np.asarray(avail_left, bool)
    atl = np.asarray(avail_tl, bool)
    atr = np.asarray(avail_tr, bool)

    t[:, 8:] = np.where(atr[:, None], t[:, 8:], t[:, 7:8])

    ft = np.empty_like(t)
    ft[:, 0] = np.where(atl, (tl + 2 * t[:, 0] + t[:, 1] + 2) >> 2,
                        (3 * t[:, 0] + t[:, 1] + 2) >> 2)
    ft[:, 1:15] = (t[:, 0:14] + 2 * t[:, 1:15] + t[:, 2:16] + 2) >> 2
    ft[:, 15] = (t[:, 14] + 3 * t[:, 15] + 2) >> 2

    fl = np.empty_like(l8)
    fl[:, 0] = np.where(atl, (tl + 2 * l8[:, 0] + l8[:, 1] + 2) >> 2,
                        (3 * l8[:, 0] + l8[:, 1] + 2) >> 2)
    fl[:, 1:7] = (l8[:, 0:6] + 2 * l8[:, 1:7] + l8[:, 2:8] + 2) >> 2
    fl[:, 7] = (l8[:, 6] + 3 * l8[:, 7] + 2) >> 2

    ftl = np.where(at & al, (t[:, 0] + 2 * tl + l8[:, 0] + 2) >> 2,
          np.where(at, (3 * tl + t[:, 0] + 2) >> 2,
          np.where(al, (3 * tl + l8[:, 0] + 2) >> 2, tl)))
    return ft, fl, ftl


def predict_8x8_all(top16, left8, topleft, avail_top, avail_left,
                    avail_tl, avail_tr):
    """All 9 Intra_8x8 modes (8.3.2.2.2-.10) from RAW edges — filtering
    (8.3.2.2.1) is applied internally.  -> (N, 9, 8, 8) int32.
    Mode order matches I4x4: [V,H,DC,DDL,DDR,VR,HD,VL,HU]."""
    n = top16.shape[0]
    t, l8, tl = filter_8x8_edges(top16, left8, topleft, avail_top,
                                 avail_left, avail_tl, avail_tr)
    at = np.asarray(avail_top, bool)
    al = np.asarray(avail_left, bool)

    y, x = np.mgrid[0:8, 0:8]
    y = y[None]
    x = x[None]

    tt = np.concatenate([tl[:, None], t], axis=1)          # (N,17) idx -1..15
    ll = np.concatenate([tl[:, None], l8], axis=1)         # (N,9)  idx -1..7

    def T(idx):  # values in -1..15
        return np.take_along_axis(
            tt[:, :, None], (idx + 1).reshape(1, 64, 1).repeat(n, 0), axis=1
        ).reshape(n, 8, 8)

    def L(idx):  # values in -1..7
        return np.take_along_axis(
            ll[:, :, None], (idx + 1).reshape(1, 64, 1).repeat(n, 0), axis=1
        ).reshape(n, 8, 8)

    out = np.zeros((n, 9, 8, 8), dtype=np.int64)

    # 0: V, 1: H
    out[:, 0] = np.broadcast_to(t[:, None, :8], (n, 8, 8))
    out[:, 1] = np.broadcast_to(l8[:, :, None], (n, 8, 8))

    # 2: DC (8.3.2.2.5)
    st, sl = t[:, :8].sum(1), l8.sum(1)
    dc = np.where(at & al, (st + sl + 8) >> 4,
         np.where(at, (st + 4) >> 3,
         np.where(al, (sl + 4) >> 3, 128)))
    out[:, 2] = dc[:, None, None]

    # 3: DDL (8.3.2.2.4)
    s = x + y
    ddl = (T(s) + 2 * T((s + 1).clip(max=15)) + T((s + 2).clip(max=15)) + 2) >> 2
    corner = (t[:, 14] + 3 * t[:, 15] + 2) >> 2
    out[:, 3] = np.where((x == 7) & (y == 7), corner[:, None, None], ddl)

    # 4: DDR (8.3.2.2.6... spec 8.3.2.2.6 is VR; DDR is 8.3.2.2.5's sibling)
    z = x - y
    ddr_t = (T((z - 2).clip(-1)) + 2 * T((z - 1).clip(-1)) + T(z.clip(-1)) + 2) >> 2
    w = y - x
    ddr_l = (L((w - 2).clip(-1)) + 2 * L((w - 1).clip(-1)) + L(w.clip(-1)) + 2) >> 2
    diag = (t[:, 0] + 2 * tl + l8[:, 0] + 2) >> 2
    out[:, 4] = np.where(z > 0, ddr_t, np.where(z < 0, ddr_l, diag[:, None, None]))

    # 5: VR
    zvr = 2 * x - y
    i = x - (y >> 1)
    vr_even = (T((i - 1).clip(-1)) + T(i.clip(-1)) + 1) >> 1
    vr_odd = (T((i - 2).clip(-1)) + 2 * T((i - 1).clip(-1)) + T(i.clip(-1)) + 2) >> 2
    vr_m1 = ((l8[:, 0] + 2 * tl + t[:, 0] + 2) >> 2)[:, None, None]
    # zVR < -1: p[-1, y-2x-1..-3] (general form; x can exceed 0 at 8x8)
    q = y - 2 * x
    vr_lo = (L((q - 1).clip(-1)) + 2 * L((q - 2).clip(-1)) + L((q - 3).clip(-1)) + 2) >> 2
    out[:, 5] = np.where(zvr >= 0, np.where(zvr % 2 == 0, vr_even, vr_odd),
                         np.where(zvr == -1, vr_m1, vr_lo))

    # 6: HD
    zhd = 2 * y - x
    j = y - (x >> 1)
    hd_even = (L((j - 1).clip(-1)) + L(j.clip(-1)) + 1) >> 1
    hd_odd = (L((j - 2).clip(-1)) + 2 * L((j - 1).clip(-1)) + L(j.clip(-1)) + 2) >> 2
    hd_m1 = vr_m1
    r = x - 2 * y
    hd_lo = (T((r - 1).clip(-1)) + 2 * T((r - 2).clip(-1)) + T((r - 3).clip(-1)) + 2) >> 2
    out[:, 6] = np.where(zhd >= 0, np.where(zhd % 2 == 0, hd_even, hd_odd),
                         np.where(zhd == -1, hd_m1, hd_lo))

    # 7: VL
    k = x + (y >> 1)
    vl_even = (T(k) + T((k + 1).clip(max=15)) + 1) >> 1
    vl_odd = (T(k) + 2 * T((k + 1).clip(max=15)) + T((k + 2).clip(max=15)) + 2) >> 2
    out[:, 7] = np.where(y % 2 == 0, vl_even, vl_odd)

    # 8: HU
    zhu = x + 2 * y
    m = y + (x >> 1)
    hu_even = (L(m.clip(max=7)) + L((m + 1).clip(max=7)) + 1) >> 1
    hu_odd = (L(m.clip(max=7)) + 2 * L((m + 1).clip(max=7)) + L((m + 2).clip(max=7)) + 2) >> 2
    hu_13 = ((l8[:, 6] + 3 * l8[:, 7] + 2) >> 2)[:, None, None]
    hu_hi = l8[:, 7][:, None, None] * np.ones_like(x)
    out[:, 8] = np.where(zhu > 13, hu_hi,
                np.where(zhu == 13, hu_13,
                np.where(zhu % 2 == 0, hu_even, hu_odd)))

    return out.astype(np.int32)


def i8x8_mode_avail(avail_top, avail_left, avail_topleft):
    """Same availability lattice as I4x4 (the 8x8 edge filter handles
    substitution; mode gating matches predict.c's i8x8 dispatch)."""
    return i4x4_mode_avail(avail_top, avail_left, avail_topleft)
