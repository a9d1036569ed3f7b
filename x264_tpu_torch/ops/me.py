"""Motion estimation (port of x264_tpu/ops/device/me.py): the exhaustive
fullpel 16x16 search (kernel ``kernels/esa16``) and the SATD subpel
refinement on its direct-gather branch (me.py:135-146, ``ref_pad=``):
each MB's 23x23 fullpel window is gathered and the 6-tap half-pel chain
runs inside it.  The reference's P core takes the one-hot window gather
(``wingather``) instead; the two branches are bit-exact
(tests/test_device_parity.py)."""

from __future__ import annotations

import torch

from x264_tpu.models.inter_frame import PAD
from x264_tpu.ops.reference.mc import QPEL_TWO_SAMPLE_TBL
from x264_tpu_torch.kernels.esa16 import full_search_16x16  # noqa: F401
from x264_tpu_torch.ops.mc import filt6
from x264_tpu_torch.ops.pixel import satd
from x264_tpu_torch.state import mv_bits

_I32 = torch.int32


def subpel_candidates(steps: int):
    """Candidate qpel deltas around the fullpel best: center first (wins
    ties), then raster order.  steps=1: half-pel grid (+-2), steps>=2:
    full quarter-pel +-3 grid."""
    s = 2 if steps == 1 else 1
    r = 2 if steps == 1 else 3
    return [(0, 0)] + [(dy, dx)
                       for dy in range(-r, r + 1, s)
                       for dx in range(-r, r + 1, s)
                       if not (dy == 0 and dx == 0)]


def hpel_windows(g):
    """Per-MB half-pel windows from fullpel windows g (N,23,23) int32
    whose [0,0] sits at plane position (y0-2, x0-2).  Returns
    (4, N, 18, 18) [fp, hh, hv, hc], bit-exact with gathering the same
    windows from mc.hpel_planes."""
    bh = filt6(g[:, :, 0:18], g[:, :, 1:19], g[:, :, 2:20],
               g[:, :, 3:21], g[:, :, 4:22], g[:, :, 5:23])   # (N,23,18)
    hh = ((bh[:, 2:20, :] + 16) >> 5).clamp(0, 255)
    bv = filt6(g[:, 0:18, :], g[:, 1:19, :], g[:, 2:20, :],
               g[:, 3:21, :], g[:, 4:22, :], g[:, 5:23, :])   # (N,18,23)
    hv = ((bv[:, :, 2:20] + 16) >> 5).clamp(0, 255)
    cc = filt6(bh[:, 0:18], bh[:, 1:19], bh[:, 2:20],
               bh[:, 3:21], bh[:, 4:22], bh[:, 5:23])         # (N,18,18)
    hc = ((cc + 512) >> 10).clamp(0, 255)
    return torch.stack([g[:, 2:20, 2:20], hh, hv, hc])


def subpel_refine(src_mbs, ref_pad, mv0, lam: int, me_range: int,
                  steps: int, mbw: int, mbh: int, return_pred=False):
    """SATD subpel refinement, exhaustive over the qpel window of the
    fullpel best (parity intent: reference encoder/me.c refine_subpel).

    src_mbs (N,16,16); ref_pad (H+2PAD, W+2PAD) the padded reference
    luma; mv0 (N,2) fullpel-aligned qpel mvs.  Returns (mv (N,2), cost
    (N,)) and, with return_pred, the winner's (N,16,16) prediction."""
    n = mbw * mbh
    dev = src_mbs.device
    off = 4 * me_range + 4
    bits = mv_bits(dev, off)

    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    y0 = PAD + mby * 16 + (mv0[:, 1] >> 2) - 1
    x0 = PAD + mbx * 16 + (mv0[:, 0] >> 2) - 1
    r23 = torch.arange(23, dtype=_I32, device=dev)
    yi = ((y0 - 2)[:, None, None] + r23[None, :, None]).long()
    xi = ((x0 - 2)[:, None, None] + r23[None, None, :]).long()
    win = hpel_windows(ref_pad[yi, xi].to(_I32))          # (4, N, 18, 18)

    # candidates in chunks of 7 stacked into one batched SATD, as in the
    # reference: argmin takes the first min within a chunk, strict <
    # keeps the earlier chunk, so ties go to the earlier candidate
    cands = subpel_candidates(steps)
    chunk_len = 7
    best = best_mv = best_pred = None
    for ci in range(0, len(cands), chunk_len):
        chunk = cands[ci:ci + chunk_len]
        preds, mvs = [], []
        for (dy, dx) in chunk:
            fy, fx = dy & 3, dx & 3
            iy, ix = dy >> 2, dx >> 2
            p1, dy1, dx1, p2, dy2, dx2 = (int(t) for t in
                                          QPEL_TWO_SAMPLE_TBL[fx, fy])
            s1 = win[p1, :, 1 + iy + dy1:17 + iy + dy1,
                     1 + ix + dx1:17 + ix + dx1]
            s2 = win[p2, :, 1 + iy + dy2:17 + iy + dy2,
                     1 + ix + dx2:17 + ix + dx2]
            preds.append((s1 + s2 + 1) >> 1)
            mvs.append(mv0 + torch.tensor([dx, dy], dtype=_I32, device=dev))
        m = len(chunk)
        predm = torch.stack(preds)                          # (m, N, 16, 16)
        mvm = torch.stack(mvs)                              # (m, N, 2)
        bitc = bits[mvm[..., 0] + off] + bits[mvm[..., 1] + off]
        src_rep = src_mbs[None].expand(m, n, 16, 16).reshape(m * n, 16, 16)
        c = (satd(src_rep, predm.reshape(m * n, 16, 16)).reshape(m, n)
             + lam * bitc)                                  # (m, N)
        idx = torch.argmin(c, dim=0)                        # first min wins
        cmin = c.gather(0, idx[None])[0]
        mvc = mvm.gather(0, idx[None, :, None].expand(1, n, 2))[0]
        predc = (predm.gather(0, idx[None, :, None, None].expand(
            1, n, 16, 16))[0] if return_pred else None)
        if best is None:
            best, best_mv, best_pred = cmin, mvc, predc
        else:
            better = cmin < best
            best = torch.where(better, cmin, best)
            best_mv = torch.where(better[:, None], mvc, best_mv)
            if return_pred:
                best_pred = torch.where(better[:, None, None], predc,
                                        best_pred)
    if return_pred:
        return best_mv, best, best_pred
    return best_mv, best
