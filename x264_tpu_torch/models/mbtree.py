"""Macroblock-tree: temporal QP propagation over the lookahead window.

Copied whole from x264_tpu/models/mbtree.py (host NumPy).

Parity anchor: reference encoder/slicetype.c macroblock_tree /
macroblock_tree_propagate / macroblock_tree_finish (:1091/:1051/:1029)
and mc.c mbtree_propagate_cost.  The idea: macroblocks that future
frames keep referencing deserve lower QP.  Walking the lookahead window
backward, each lowres MB hands `(intra + carried) * (intra - inter) /
intra` down to the reference MBs its motion vector overlaps (bilinear
area weights); the finish step turns the accumulated amount into
qp_offset = -strength * log2((intra + propagate) / intra), with
strength = 5 * (1 - qcomp) like x264.

TPU-first split: the per-frame lowres ME costs/mvs come from the device
kernels (via models/lookahead.py); the backward walk itself is a tiny
O(frames * lowres-MBs) scatter that runs in NumPy — at half resolution
with 8x8 blocks a 1080p frame is ~8k cells, far below device dispatch
granularity.  Grain: 8x8 lowres blocks = 16x16 source px = exactly one
real MB per cell, the same grain as x264's half-res 8x8 lowres
(slicetype.c works on frame->lowres with 8x8 blocks).  The legacy 16px
grain (bs=16) remains for the coarse scenecut path.
"""

from __future__ import annotations

import numpy as np

_QCOMP = 0.6


def propagate(ics, pcs, mvs, mbw: int, mbh: int, bs: int = 16):
    """Backward propagation over the window.

    ics: list of (N,) lowres intra cost estimates, oldest first (index 0
    is the frame about to be encoded); pcs[i], mvs[i]: inter cost and mv
    (qpel, lowres) of frame i predicted from frame i-1 (pcs[0]/mvs[0]
    unused).  bs: lowres block size in px (8 = x264 grain).  Returns the
    accumulated propagate_in for frame 0 (N,)."""
    n = mbw * mbh
    k = len(ics)
    prop = np.zeros(n, np.float64)
    for i in range(k - 1, 0, -1):
        ic = np.maximum(ics[i].astype(np.float64), 1.0)
        pc = np.minimum(pcs[i].astype(np.float64), ic)
        amount = (ic + prop) * (ic - pc) / ic
        prop = _splat(amount, mvs[i], mbw, mbh, bs)
    return prop


def _splat(amount, mv, mbw: int, mbh: int, bs: int = 16):
    """Distribute per-block amounts into the reference frame's block
    grid at the mv-displaced position with bilinear area weights
    (mbtree_propagate_cost analog)."""
    n = mbw * mbh
    idx = np.arange(n)
    x0 = (idx % mbw) * bs + (mv[:, 0] >> 2)      # fullpel lowres coords
    y0 = (idx // mbw) * bs + (mv[:, 1] >> 2)
    bx, fx = np.divmod(x0, bs)
    by, fy = np.divmod(y0, bs)
    out = np.zeros((mbh + 2, mbw + 2), np.float64)   # 1-cell borders
    area = float(bs * bs)
    w00 = (bs - fx) * (bs - fy) / area
    w01 = fx * (bs - fy) / area
    w10 = (bs - fx) * fy / area
    w11 = fx * fy / area
    bxc = np.clip(bx + 1, 0, mbw)
    byc = np.clip(by + 1, 0, mbh)
    for (dy, dx, w) in ((0, 0, w00), (0, 1, w01), (1, 0, w10), (1, 1, w11)):
        np.add.at(out, (byc + dy, bxc + dx), amount * w)
    return out[1:mbh + 1, 1:mbw + 1].reshape(n)


def finish(ic, prop, strength=None):
    """qp offsets (negative where the future references this content)."""
    if strength is None:
        strength = 5.0 * (1.0 - _QCOMP)
    ic = np.maximum(ic.astype(np.float64), 1.0)
    return -strength * np.log2((ic + prop) / ic)


def expand_offsets(off_lr, mbw_lr, mbh_lr, mbw, mbh):
    """Lowres 16px-grid offsets -> fullres MB grid (each lowres MB covers
    a 2x2 group of real MBs; edge MBs reuse the nearest group)."""
    g = off_lr.reshape(mbh_lr, mbw_lr)
    g = np.repeat(np.repeat(g, 2, 0), 2, 1)
    gy = np.minimum(np.arange(mbh), g.shape[0] - 1)
    gx = np.minimum(np.arange(mbw), g.shape[1] - 1)
    return g[np.ix_(gy, gx)].reshape(mbh * mbw)


def expand_offsets8(off_lr, nbw, nbh, mbw, mbh):
    """8px-lowres-grid offsets -> fullres MB grid.  One lowres 8x8 block
    is exactly one source MB (half-res x 8px = 16px); edge MBs beyond
    the cropped lowres grid reuse the nearest cell."""
    g = off_lr.reshape(nbh, nbw)
    gy = np.minimum(np.arange(mbh), nbh - 1)
    gx = np.minimum(np.arange(mbw), nbw - 1)
    return g[np.ix_(gy, gx)].reshape(mbh * mbw)
