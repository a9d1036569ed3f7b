"""Partition motion estimation: 16x16 / 16x8 / 8x16 / 8x8 (port of
x264_tpu/ops/device/me_parts.py on its direct-gather branch).

The fullpel SAD of every shape decomposes into the four 8x8 quadrant SADs
at the same displacement, so one exhaustive pass (kernel
``kernels/esa_parts``) gives all nine unit argmins; ``choose_shape``
decides each MB's shape from the unit costs, and ``subpel_refine_parts``
refines at quadrant granularity with the candidate costs pooled per
partition.

Quadrant indexing everywhere: q = 2*qy + qx (raster: TL, TR, BL, BR).
PART_OF_QUAD[shape][q] maps quadrants to partition slots; partitions are
numbered in spec decode order (7.4.5.2).
"""

from __future__ import annotations

import numpy as np
import torch

from x264_tpu_torch.kernels.esa_parts import full_search_parts  # noqa: F401
from x264_tpu_torch.ops.mc import filt6
from x264_tpu_torch.ops.me import subpel_candidates
from x264_tpu_torch.ops.pixel import satd
from x264_tpu_torch.state import PAD, QPEL_TWO_SAMPLE_TBL, mv_bits_table

# ---- copied from x264_tpu/ops/device/me_parts.py ----
# shapes 0-3 are 16x16, 16x8, 8x16, 8x8 (the CAVLC P mb_type values)
# quad -> partition slot, per shape
PART_OF_QUAD = np.array([[0, 0, 0, 0],
                         [0, 0, 1, 1],
                         [0, 1, 0, 1],
                         [0, 1, 2, 3]], np.int32)
# partition slot -> first member quad (representative), per shape
FIRST_QUAD = np.array([[0, 0, 0, 0],
                       [0, 2, 0, 0],
                       [0, 1, 0, 0],
                       [0, 1, 2, 3]], np.int32)
N_PARTS = np.array([1, 2, 2, 4], np.int32)

# per-shape header-bit estimates (CAVLC-ish: mb_type ue + sub_mb_type):
# ue(0)=1, ue(1)=ue(2)=3, ue(3)=5 + 4x sub_mb_type "1" bits
SHAPE_BITS = np.array([1, 3, 3, 9], np.int32)
# ----

_I32 = torch.int32
_BIG = 1 << 30


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.long, device=device)


def choose_shape(units, lam: int):
    """Per-MB partition-shape decision from fullpel unit costs:
    cost(shape) = sum of member unit costs + lam * SHAPE_BITS[shape],
    the first least cost winning.  Returns (shape (N,), mv8 (N,4,2)
    fullpel qpel mvs per quadrant, cost (N,)), int32."""
    sb = SHAPE_BITS
    costs = torch.stack([
        units["cost_f"] + lam * int(sb[0]),
        units["cost_h"].sum(1, dtype=_I32) + lam * int(sb[1]),
        units["cost_v"].sum(1, dtype=_I32) + lam * int(sb[2]),
        units["cost_q"].sum(1, dtype=_I32) + lam * int(sb[3]),
    ], dim=1).to(_I32)                                     # (N, 4)
    shape = torch.argmin(costs, dim=1)                     # first min wins
    cost = costs.gather(1, shape[:, None])[:, 0]

    # per-quadrant mv for each shape, then select by the chosen shape
    dev = costs.device
    mvq_by_shape = torch.stack([
        units["mv_f"][:, None].expand_as(units["mv_q"]),
        units["mv_h"][:, _t([0, 0, 1, 1], dev)],
        units["mv_v"][:, _t([0, 1, 0, 1], dev)],
        units["mv_q"],
    ], dim=1)                                              # (N, 4, 4, 2)
    n = costs.shape[0]
    mv8 = mvq_by_shape.gather(
        1, shape[:, None, None, None].expand(n, 1, 4, 2))[:, 0]
    return shape.to(_I32), mv8.to(_I32), cost


def _hpel_windows10(g):
    """Per-unit half-pel 10x10 windows from fullpel windows g (M,15,15)
    int32 whose [0,0] sits at (y0-2, x0-2): the 8x8-block analog of
    ``me.hpel_windows`` (same 6-tap chain).  Returns (4, M, 10, 10)."""
    bh = filt6(g[:, :, 0:10], g[:, :, 1:11], g[:, :, 2:12],
               g[:, :, 3:13], g[:, :, 4:14], g[:, :, 5:15])   # (M,15,10)
    hh = ((bh[:, 2:12, :] + 16) >> 5).clamp(0, 255)
    bv = filt6(g[:, 0:10, :], g[:, 1:11, :], g[:, 2:12, :],
               g[:, 3:13, :], g[:, 4:14, :], g[:, 5:15, :])   # (M,10,15)
    hv = ((bv[:, :, 2:12] + 16) >> 5).clamp(0, 255)
    cc = filt6(bh[:, 0:10], bh[:, 1:11], bh[:, 2:12],
               bh[:, 3:13], bh[:, 4:14], bh[:, 5:15])         # (M,10,10)
    hc = ((cc + 512) >> 10).clamp(0, 255)
    return torch.stack([g[:, 2:12, 2:12], hh, hv, hc])


def subpel_refine_parts(src_mbs, mv8, shape, lam: int, me_range: int,
                        steps: int, mbw: int, mbh: int, ref_pad,
                        ref_idx=None):
    """SATD subpel refinement at quadrant granularity with candidate costs
    pooled per partition: every quadrant evaluates the same qpel deltas
    around its partition's shared fullpel mv, the per-delta SATDs are
    summed onto partition slots, each partition takes its first least
    cost, and the winning delta goes back to its member quadrants.

    src_mbs (N,16,16) int32; mv8 (N,4,2) fullpel qpel; shape (N,);
    ref_pad (H+2PAD, W+2PAD) the padded reference luma, or stacked
    (K, H+2PAD, W+2PAD) with ref_idx (N,) each MB's reference, shared by
    its four quadrants.  Returns (mv8',
    cost (N,4) per-partition-slot costs, pred (N,16,16) the winning
    prediction)."""
    n = mbw * mbh
    m = 4 * n
    dev = src_mbs.device
    off = 4 * me_range + 4
    bits = mv_bits_table(dev, off)

    # unit geometry: unit u = 4*mb + q
    mb = torch.arange(n, dtype=_I32, device=dev)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    qy = torch.tensor([0, 0, 1, 1], dtype=_I32, device=dev)
    qx = torch.tensor([0, 1, 0, 1], dtype=_I32, device=dev)
    uy = (mby[:, None] * 16 + qy[None, :] * 8).reshape(m)
    ux = (mbx[:, None] * 16 + qx[None, :] * 8).reshape(m)
    mvq = mv8.reshape(m, 2)
    y0 = PAD + uy + (mvq[:, 1] >> 2) - 1
    x0 = PAD + ux + (mvq[:, 0] >> 2) - 1

    src_q = (src_mbs.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4)
             .reshape(m, 8, 8))
    r15 = torch.arange(15, dtype=_I32, device=dev)
    # the window stays on the padded plane: the search never picks a
    # block wholly in the replicated border, since a nearer one has the
    # same SAD at fewer mv bits (tests/test_torch_bframes.py holds it at
    # me_range 29-32); the clamp only keeps the gather in bounds
    yi = ((y0 - 2)[:, None, None] + r15[None, :, None]).clamp(
        0, ref_pad.shape[-2] - 1).long()
    xi = ((x0 - 2)[:, None, None] + r15[None, None, :]).clamp(
        0, ref_pad.shape[-1] - 1).long()
    if ref_pad.dim() == 2:
        g = ref_pad[yi, xi]
    else:
        rix = ref_idx.long().repeat_interleave(4)
        g = ref_pad[rix[:, None, None], yi, xi]
    win = _hpel_windows10(g.to(_I32))                      # (4, M, 10, 10)

    # partition pooling from the chosen shape
    shape_l = shape.long()
    pq = _t(PART_OF_QUAD, dev)[shape_l]                    # (N, 4)
    slot = torch.arange(4, device=dev)
    pool = pq[:, :, None] == slot[None, None, :]           # (N, q, p)
    # first-member mask: quad q carries its partition's mv-bit cost
    fq = _t(FIRST_QUAD, dev)[shape_l]                      # (N, 4) slots
    is_first = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    is_first[torch.arange(n, device=dev)[:, None], fq] = True
    nparts = _t(N_PARTS, dev)[shape_l]                     # (N,)
    slot_live = slot[None, :] < nparts[:, None]            # (N, 4)

    cands = subpel_candidates(steps)
    chunk_len = 7
    best = best_d = best_pred = None
    for ci in range(0, len(cands), chunk_len):
        chunk = cands[ci:ci + chunk_len]
        preds, bitc = [], []
        for (dy, dx) in chunk:
            fy, fx = dy & 3, dx & 3
            iy, ix = dy >> 2, dx >> 2
            p1, dy1, dx1, p2, dy2, dx2 = (int(t) for t in
                                          QPEL_TWO_SAMPLE_TBL[fx, fy])
            s1 = win[p1, :, 1 + iy + dy1:9 + iy + dy1,
                     1 + ix + dx1:9 + ix + dx1]
            s2 = win[p2, :, 1 + iy + dy2:9 + iy + dy2,
                     1 + ix + dx2:9 + ix + dx2]
            preds.append((s1 + s2 + 1) >> 1)
            bitc.append(bits[(mvq[:, 0] + dx + off).long()]
                        + bits[(mvq[:, 1] + dy + off).long()])
        nc = len(chunk)
        ds = torch.tensor([[dx, dy] for (dy, dx) in chunk], dtype=_I32,
                          device=dev)                      # (c, 2)
        predm = torch.stack(preds)                         # (c, M, 8, 8)
        src_rep = src_q[None].expand(nc, m, 8, 8).reshape(nc * m, 8, 8)
        sc = satd(src_rep, predm.reshape(nc * m, 8, 8)).reshape(nc, n, 4)
        bc = torch.stack(bitc).reshape(nc, n, 4)
        # per-quad contribution: SATD always, mv bits only on the
        # partition's first member quad
        contrib = sc + lam * torch.where(is_first[None], bc, 0)
        # pool onto partition slots (c, N, p): the reference's one-hot
        # einsum as a sum over the four quadrants (integer products do
        # not run on the card)
        cp = sum(torch.where(pool[None, :, q, :], contrib[:, :, q, None], 0)
                 for q in range(4)).to(_I32)
        cp = torch.where(slot_live[None], cp, _BIG)
        idx = torch.argmin(cp, dim=0)                      # (N, p) first min
        cmin = cp.gather(0, idx[None])[0]
        dsel = ds[idx]                                     # (N, p, 2)
        # quadrant-level winning pred for this chunk: quad q follows its
        # partition slot's choice
        qidx = idx.gather(1, pq)                           # (N, 4)
        predq = predm.reshape(nc, n, 4, 8, 8).gather(
            0, qidx[None, :, :, None, None].expand(1, n, 4, 8, 8))[0]
        if best is None:
            best, best_d, best_pred = cmin, dsel, predq
        else:
            better = cmin < best                           # (N, p)
            best = torch.where(better, cmin, best)
            best_d = torch.where(better[..., None], dsel, best_d)
            bq = better.gather(1, pq)                      # (N, 4)
            best_pred = torch.where(bq[..., None, None], predq, best_pred)
    # broadcast slot deltas back to quadrants
    dq = best_d.gather(1, pq[..., None].expand(n, 4, 2))   # (N, 4, 2)
    mv8p = mv8 + dq
    pred = (best_pred.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4)
            .reshape(n, 16, 16))
    return mv8p.to(_I32), torch.where(slot_live, best, 0).to(_I32), pred
