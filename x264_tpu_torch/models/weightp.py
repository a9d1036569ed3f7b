"""Explicit weighted prediction for P slices (--weightp): the host
analysis and the device step (port of x264_tpu/models/weightp.py).

``LOG2_DENOM``, ``NEUTRAL``, ``weight_cost``, ``_mc_pairs`` and
``analyse_weights`` are copied verbatim from the reference (host NumPy
over *source* luma planes, so the per-frame weight decision never waits
on the device).  ``apply_weights`` is the 8.4.2.3.3 weighting of the
interpolated luma prediction on torch tensors (the reference's
``apply_weights_jnp``): the P core applies it after subpel, before the
residual; the search stays unweighted.  Chroma is signalled unweighted.
"""

from __future__ import annotations

import numpy as np

LOG2_DENOM = 6
NEUTRAL = (1 << LOG2_DENOM, 0)


def weight_cost(cur, ref, w: int, off: int) -> int:
    """Subsampled SAD of cur vs weighted ref (analysis metric only)."""
    pred = np.clip(((ref * w + 32) >> LOG2_DENOM) + off, 0, 255)
    return int(np.abs(cur - pred).sum())


def _mc_pairs(cur: np.ndarray, ref: np.ndarray, b: int = 16,
              rad: int = 8, grid: int = 10):
    """Host sparse full-res full-pel ME: a grid x grid sample of bxb
    blocks of cur, each matched (SAD) against ref within +-rad.
    Returns (cur_blocks, mc_ref_blocks) as (n, b*b) int32 — the
    motion-compensated pair basis the weight decision is validated on
    (the role slicetype.c's lookahead mvs play for
    x264_weights_analyse).  Full resolution matters: integer-pel pans
    are exactly compensable here, exactly as the encoder's own ME will
    compensate them, so the weighted-vs-unweighted comparison isn't
    polluted by interpolation error (a downsampled basis turns integer
    pans into fractional ones and buries small fades)."""
    from numpy.lib.stride_tricks import sliding_window_view
    hh, ww = cur.shape
    if hh < b + 2 or ww < b + 2:
        c = cur.astype(np.int32).reshape(1, -1)
        return c, ref.astype(np.int32).reshape(1, -1)
    gy = np.linspace(0, hh - b, min(grid, hh - b + 1)).astype(np.int64)
    gx = np.linspace(0, ww - b, min(grid, ww - b + 1)).astype(np.int64)
    y0 = np.repeat(gy, len(gx))
    x0 = np.tile(gx, len(gy))
    ci = cur.astype(np.int32)
    cb = np.stack([ci[y:y + b, x:x + b].reshape(-1)
                   for y, x in zip(y0, x0)])
    rp = np.pad(ref.astype(np.int32), rad, mode="edge")
    win = sliding_window_view(rp, (b, b))          # (H+2rad-b+1, ..., b, b)
    best_sad = None
    best = None
    for dy in range(-rad, rad + 1):
        for dx in range(-rad, rad + 1):
            rb = win[y0 + rad + dy, x0 + rad + dx].reshape(len(y0), b * b)
            sad = np.abs(cb - rb).sum(axis=1)
            if best_sad is None:
                best_sad, best = sad, rb
            else:
                m = sad < best_sad
                best_sad = np.where(m, sad, best_sad)
                best = np.where(m[:, None], rb, best)
    return cb, best


def analyse_weights(cur_y: np.ndarray, ref_srcs) -> list:
    """Pick (weight, offset) per list0 reference from SOURCE luma planes.

    cur_y: current source luma (H, W) uint8; ref_srcs: list of source
    luma planes in list0 order.  Returns [(w, off), ...] — NEUTRAL when
    weighting doesn't clearly pay (the reference's acceptance rule is
    also improvement-thresholded, slicetype.c:440).

    Like the reference (whose weight_cost scores candidates against the
    lookahead's MOTION-COMPENSATED lowres plane, slicetype.c:284-512),
    candidates are validated on mc'd lowres pairs — a plain cur-vs-ref
    SAD would let any pan mask a fade.  The lowres ME runs on the host
    (vectorized over all blocks), so the decision costs no device
    round-trip."""
    cl = cur_y[::4, ::4].astype(np.int64)
    vc = float(cl.var())
    mc = float(cl.mean())
    out = []
    for rv in ref_srcs:
        rl = rv[::4, ::4].astype(np.int64)
        cb, rb = _mc_pairs(cur_y, rv)
        base = float(np.abs(cb - rb).sum())
        vr = float(rl.var())
        mr = float(rl.mean())
        guess_w = (1 << LOG2_DENOM) if vr <= 0 else int(
            round((1 << LOG2_DENOM) * np.sqrt(max(vc, 0.0) / vr)))
        guess_w = int(np.clip(guess_w, 0, 127))
        best = (base, *NEUTRAL)
        for w in range(max(0, guess_w - 1), min(128, guess_w + 2)):
            off0 = int(round(mc - w * mr / (1 << LOG2_DENOM)))
            for off in (off0 - 1, off0, off0 + 1):
                if not -128 <= off <= 127:
                    continue
                pred = np.clip(((rb * w + 32) >> LOG2_DENOM) + off, 0, 255)
                sad = float(np.abs(cb - pred).sum())
                if sad < best[0]:
                    best = (sad, w, off)
        sad, w, off = best
        # accept only a clear win (> ~3% mc'd SAD reduction), like the
        # reference's fraction-of-cost threshold
        if (w, off) == NEUTRAL or sad >= base - base / 32:
            w, off = NEUTRAL
        out.append((w, off))
    return out


def apply_weights(pred, wts, ref_idx):
    """8.4.2.3.3 explicit weighting of interpolated luma: pred (N,16,16)
    int32; wts (K,2) int32 [weight, offset] per list0 reference; ref_idx
    (N,) the chosen reference.  ((pred*w + 32) >> 6) + off, clamped to
    [0, 255], all in int32."""
    w = wts[ref_idx.long(), 0][:, None, None]
    off = wts[ref_idx.long(), 1][:, None, None]
    return (((pred * w + (1 << (LOG2_DENOM - 1))) >> LOG2_DENOM)
            + off).clamp(0, 255)
