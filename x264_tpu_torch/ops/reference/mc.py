"""Motion compensation reference kernels (parity with reference common/mc.c):
half-pel 6-tap interpolation planes, quarter-pel sampling, lowres pyramid.

The TPU-first design precomputes the 3 half-pel planes per reconstructed
frame (exactly like x264's hpel_filter over the whole frame) so qpel motion
compensation is pure gathers + pairwise averages.

Copied from x264_tpu/ops/reference/mc.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

# H.264 6-tap filter (8.4.2.2.1): (1, -5, 20, 20, -5, 1)


def _filt6(v0, v1, v2, v3, v4, v5):
    return v0 - 5 * v1 + 20 * v2 + 20 * v3 - 5 * v4 + v5


def hpel_planes(plane: np.ndarray, pad: int = 4):
    """Compute the 3 half-pel planes (h, v, c) for a full-pel plane.

    Input must already be edge-padded by the caller if values at the border
    matter; this routine pads internally by edge replication (normative
    clamping at picture edges reduces to edge replication on padded planes).

    Returns (fp, hh, hv, hc) all same shape as input, int32 0..255:
      hh[y,x] ~ position (x+0.5, y);  hv ~ (x, y+0.5);  hc ~ (x+0.5, y+0.5).
    """
    p = np.pad(plane.astype(np.int64), pad, mode="edge")

    # horizontal half-pel: b = round((E-5F+20G+20H-5I+J)/32), at (x+0.5, y)
    bh_full = _filt6(p[:, :-5], p[:, 1:-4], p[:, 2:-3], p[:, 3:-2], p[:, 4:-1], p[:, 5:])
    # value at x+0.5 uses taps x-2..x+3 -> slice offset pad-2
    # half-pel at x+0.5 uses taps x-2..x+3 -> slice offset pad-2
    bh = bh_full[:, pad - 2: bh_full.shape[1] - pad + 3]
    hh = np.clip((bh[pad:-pad, :] + 16) >> 5, 0, 255)

    # vertical half-pel
    bv_full = _filt6(p[:-5, :], p[1:-4, :], p[2:-3, :], p[3:-2, :], p[4:-1, :], p[5:, :])
    bv = bv_full[pad - 2: bv_full.shape[0] - pad + 3, :]
    hv = np.clip((bv[:, pad:-pad] + 16) >> 5, 0, 255)

    # center half-pel: 6-tap vertically over the horizontal intermediate (b)
    # intermediate bh_full rows cover original padded rows; apply vertical
    # filter to bh (un-normalized horizontal results)
    bcol = bh  # (padded_h, w) un-normalized, needs /32 twice at the end
    cc = _filt6(bcol[:-5, :], bcol[1:-4, :], bcol[2:-3, :], bcol[3:-2, :],
                bcol[4:-1, :], bcol[5:, :])
    cc = cc[pad - 2: cc.shape[0] - pad + 3, :]
    hc = np.clip((cc + 512) >> 10, 0, 255)

    return (plane.astype(np.int32), hh.astype(np.int32),
            hv.astype(np.int32), hc.astype(np.int32))


def qpel_sample(fp, hh, hv, hc, mv_x: int, mv_y: int, y0: int, x0: int,
                h: int, w: int) -> np.ndarray:
    """Sample a h*w block at quarter-pel mv from the 4 planes.

    Planes must be edge-padded enough that (y0 + mv_y/4, x0 + mv_x/4) plus
    the block extent stays in range.  Follows 8.4.2.2.2: quarter positions
    average the two nearest full/half-pel samples.
    """
    ix, iy = mv_x >> 2, mv_y >> 2
    fx, fy = mv_x & 3, mv_y & 3
    ys, xs = y0 + iy, x0 + ix

    def grab(plane, dy=0, dx=0):
        return plane[ys + dy: ys + dy + h, xs + dx: xs + dx + w].astype(np.int64)

    # the 16 qpel positions in terms of (fx, fy)
    if fx == 0 and fy == 0:
        return grab(fp).astype(np.int32)
    if fy == 0:
        if fx == 2:
            return grab(hh).astype(np.int32)
        base = grab(fp) if fx == 1 else grab(fp, 0, 1)
        return ((base + grab(hh) + 1) >> 1).astype(np.int32)
    if fx == 0:
        if fy == 2:
            return grab(hv).astype(np.int32)
        base = grab(fp) if fy == 1 else grab(fp, 1, 0)
        return ((base + grab(hv) + 1) >> 1).astype(np.int32)
    if fx == 2 and fy == 2:
        return grab(hc).astype(np.int32)
    if fx == 2:  # fy odd: average c with h-plane row
        other = grab(hh) if fy == 1 else grab(hh, 1, 0)
        return ((grab(hc) + other + 1) >> 1).astype(np.int32)
    if fy == 2:  # fx odd
        other = grab(hv) if fx == 1 else grab(hv, 0, 1)
        return ((grab(hc) + other + 1) >> 1).astype(np.int32)
    # both odd: average nearest h and v half-pel samples
    hplane = grab(hh) if fy == 1 else grab(hh, 1, 0)
    vplane = grab(hv) if fx == 1 else grab(hv, 0, 1)
    return ((hplane + vplane + 1) >> 1).astype(np.int32)


def chroma_mc(plane: np.ndarray, mv_x: int, mv_y: int, y0: int, x0: int,
              h: int, w: int) -> np.ndarray:
    """Normative 1/8-pel bilinear chroma interpolation (8.4.2.2.2).
    mv is the *luma* mv; chroma fraction = mv & 7 on the half-res grid."""
    ix, iy = mv_x >> 3, mv_y >> 3
    fx, fy = mv_x & 7, mv_y & 7
    ys, xs = y0 + iy, x0 + ix
    a = plane[ys: ys + h + 1, xs: xs + w + 1].astype(np.int64)
    p00, p01 = a[:h, :w], a[:h, 1:w + 1]
    p10, p11 = a[1:h + 1, :w], a[1:h + 1, 1:w + 1]
    v = ((8 - fx) * (8 - fy) * p00 + fx * (8 - fy) * p01
         + (8 - fx) * fy * p10 + fx * fy * p11 + 32) >> 6
    return v.astype(np.int32)


def lowres_downsample(plane: np.ndarray) -> np.ndarray:
    """Half-res lowres plane for lookahead (parity with frame_init_lowres_core,
    common/mc.c:458): 2x2 average with rounding."""
    p = plane.astype(np.int64)
    h, w = p.shape
    h2, w2 = h // 2, w // 2
    q = p[:h2 * 2, :w2 * 2].reshape(h2, 2, w2, 2)
    return ((q.sum((1, 3)) + 2) >> 2).astype(plane.dtype)


# -----------------------------------------------------------------------------
# Branchless qpel formulation shared with the device tier: every quarter-pel
# position equals (S1 + S2 + 1) >> 1 over two plane samples (exact positions
# repeat the same sample, and (2a+1)>>1 == a).  Entry [fx, fy] is
# (p1, dy1, dx1, p2, dy2, dx2) with planes [fp, hh, hv, hc] = 0..3.
# -----------------------------------------------------------------------------
QPEL_TWO_SAMPLE_TBL = np.zeros((4, 4, 6), np.int32)
for _fx in range(4):
    for _fy in range(4):
        _FP, _HH, _HV, _HC = 0, 1, 2, 3
        if _fx == 0 and _fy == 0:
            _e = (_FP, 0, 0, _FP, 0, 0)
        elif _fy == 0:
            _e = ((_HH, 0, 0, _HH, 0, 0) if _fx == 2 else
                  (_FP, 0, 0, _HH, 0, 0) if _fx == 1 else
                  (_FP, 0, 1, _HH, 0, 0))
        elif _fx == 0:
            _e = ((_HV, 0, 0, _HV, 0, 0) if _fy == 2 else
                  (_FP, 0, 0, _HV, 0, 0) if _fy == 1 else
                  (_FP, 1, 0, _HV, 0, 0))
        elif _fx == 2 and _fy == 2:
            _e = (_HC, 0, 0, _HC, 0, 0)
        elif _fx == 2:
            _e = (_HC, 0, 0, _HH, 1 if _fy == 3 else 0, 0)
        elif _fy == 2:
            _e = (_HC, 0, 0, _HV, 0, 1 if _fx == 3 else 0)
        else:
            _e = (_HH, 1 if _fy == 3 else 0, 0,
                  _HV, 0, 1 if _fx == 3 else 0)
        QPEL_TWO_SAMPLE_TBL[_fx, _fy] = _e


def mc_luma_qpel_batched(planes4: np.ndarray, mv: np.ndarray,
                         mbw: int, mbh: int, pad: int) -> np.ndarray:
    """NumPy mirror of the device mc_luma_qpel: (4,Hp,Wp) stacked planes
    (np.stack(hpel_planes(ref_pad))), mv (N,2) qpel -> (N,16,16) int32."""
    n = mbw * mbh
    mby = np.arange(n) // mbw
    mbx = np.arange(n) % mbw
    ix, iy = mv[:, 0] >> 2, mv[:, 1] >> 2
    fx, fy = mv[:, 0] & 3, mv[:, 1] & 3
    y0 = pad + mby * 16 + iy
    x0 = pad + mbx * 16 + ix
    tbl = QPEL_TWO_SAMPLE_TBL[fx, fy]
    r16 = np.arange(16)

    def grab(p_idx, dy, dx):
        yi = (y0 + dy)[:, None, None] + r16[None, :, None]
        xi = (x0 + dx)[:, None, None] + r16[None, None, :]
        return planes4[p_idx[:, None, None], yi, xi]

    s1 = grab(tbl[:, 0], tbl[:, 1], tbl[:, 2])
    s2 = grab(tbl[:, 3], tbl[:, 4], tbl[:, 5])
    return ((s1 + s2 + 1) >> 1).astype(np.int32)
