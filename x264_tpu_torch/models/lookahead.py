"""Lookahead: the lowres frame-cost model, adaptive B placement (b_adapt=1),
the lowres scenecut's intra estimate and MB-tree's per-block statistics
(port of x264_tpu/models/lookahead.py and of
x264_tpu/models/inter_frame.py::intra_cost_estimate).

Parity anchor: reference encoder/slicetype.c — slicetype_frame_cost and
the b_adapt=1 decision loop of slicetype_analyse.  Every search is the
exhaustive fullpel search at range 8 and the fixed lambda
``sad_lambda(24)`` on half-resolution luma planes cropped to whole 16-px
lowres MBs: ``kernels/esa16`` once per frame pair of a plan (and once
per frame for the scenecut), ``kernels/esa_parts`` once per frame for
MB-tree's 8x8 lowres blocks.  The planes live on the encoder's device;
the decisions are the reference's host arithmetic on int64 costs.

Decision rule (b_adapt=1 analog): for queued frames f_1..f_k after the
last anchor A, pick the largest m < k such that every f_j (j <= m) is
no more expensive as a B — cost min(ME(f_j|A), ME(f_j|f_{m+1})) — than
as a P continuing the chain (ME(f_j|f_{j-1})); f_{m+1} becomes the P
anchor.  Ties favour B (a static scene runs at maximum B density)."""

from __future__ import annotations

import numpy as np
import torch

from x264_tpu_torch.kernels.esa16 import full_search_16x16
from x264_tpu_torch.kernels.esa_parts import full_search_parts
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops.mc import pad_edge
from x264_tpu_torch.state import PAD, sad_lambda

_I32 = torch.int32
_LOOKAHEAD_QP = 24          # fixed decision lambda (policy)
_RANGE = 8                  # the lowres search range


def lowres_plane(y):
    """Half-res luma (frame_init_lowres_core analog: 2x2 rounded mean) of
    a uint8 (H, W) tensor, cropped to a whole number of 16px lowres MBs;
    contiguous uint8 on y's device."""
    h2, w2 = y.shape[0] // 2, y.shape[1] // 2
    q = y[:h2 * 2, :w2 * 2].to(_I32).reshape(h2, 2, w2, 2)
    lr = ((q.sum((1, 3), dtype=_I32) + 2) >> 2).to(torch.uint8)
    mh, mw = (h2 // 16) * 16, (w2 // 16) * 16
    return lr[:mh, :mw].contiguous()


def intra_cost_estimate(y, mbw: int, mbh: int):
    """Source-edge I16x16 SATD estimate per MB of a uint8 (16mbh, 16mbw)
    tensor (the lowres scenecut's intra side): source pixels as
    neighbours, every MB at once.  Returns (N,) int64."""
    n = mbw * mbh
    mb = torch.arange(n, device=y.device)
    mby, mbx = torch.div(mb, mbw, rounding_mode="floor"), mb % mbw
    yp_ = pad_edge(y.to(_I32), 1)[:-1, :-1]
    r16 = torch.arange(16, device=y.device)
    top = yp_[(mby * 16)[:, None], (mbx * 16 + 1)[:, None] + r16[None, :]]
    left = yp_[(mby * 16 + 1)[:, None] + r16[None, :], (mbx * 16)[:, None]]
    tl = yp_[mby * 16, mbx * 16]
    at, al = mby > 0, mbx > 0
    preds = PR.predict_16x16_all(top, left, tl, at, al)
    avail = PR.i16x16_mode_avail(at, al, at & al)
    src = (y.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3)
           .reshape(n, 16, 16).to(_I32))
    costs = torch.where(avail, P.satd(src[:, None], preds), 1 << 30)
    return costs.min(1).values.to(torch.int64)


def lowres_search(src, ref, mbw: int, mbh: int):
    """esa16 of the lowres plane ``src`` against ``ref`` (edge-padded by
    PAD) at the lookahead's range and lambda -> per-MB cost (N,) int32."""
    return full_search_16x16(src, pad_edge(ref, PAD),
                             sad_lambda(_LOOKAHEAD_QP), _RANGE, mbw, mbh)[1]


def _pair_costs(stack, pairs, mbw: int, mbh: int):
    """stack (F, h, w) lowres frames; pairs: tuple of (src, ref) indices.
    Returns (len(pairs), N) int32 per-MB lowres ME costs — per-MB so B
    costs can take the per-block best direction, exactly like
    slicetype_frame_cost's per-8x8 list min.  One esa16 launch per
    pair."""
    return torch.stack([lowres_search(stack[a], stack[b], mbw, mbh)
                        for (a, b) in pairs])


def _intra8(lr, mbw: int, mbh: int):
    """Per-8x8-block lowres intra SAD estimate (DC/H/V from decoded-order
    edges of the SOURCE lowres plane) — the slicetype_frame_cost lowres
    intra analog at x264's grain (8x8 on half-res).  SAD (not SATD) so
    the scale matches the lowres inter costs from the SAD ME kernel."""
    nbh, nbw = 2 * mbh, 2 * mbw
    dev = lr.device
    q = lr.to(_I32)[:mbh * 16, :mbw * 16]
    blocks = q.reshape(nbh, 8, nbw, 8).permute(0, 2, 1, 3)
    pad = pad_edge(q, 1)[:-1, :-1]
    tops = pad[0:nbh * 8:8, 1:1 + nbw * 8].reshape(nbh, nbw, 8)
    lefts = pad[1:1 + nbh * 8, 0:nbw * 8:8].reshape(nbh, 8, nbw
                                                    ).permute(0, 2, 1)
    at = (torch.arange(nbh, device=dev) > 0)[:, None]
    al = (torch.arange(nbw, device=dev) > 0)[None, :]
    st, sl = tops.sum(-1, dtype=_I32), lefts.sum(-1, dtype=_I32)
    dc = torch.where(at & al, (st + sl + 8) >> 4,
         torch.where(at, (st + 4) >> 3,
         torch.where(al, (sl + 4) >> 3, 128)))
    big = 1 << 28
    sad_dc = (blocks - dc[..., None, None]).abs().sum((-1, -2), dtype=_I32)
    sad_v = (blocks - tops[:, :, None, :]).abs().sum((-1, -2), dtype=_I32)
    sad_h = (blocks - lefts[:, :, :, None]).abs().sum((-1, -2), dtype=_I32)
    cost = torch.minimum(sad_dc, torch.minimum(
        torch.where(at, sad_v, big), torch.where(al, sad_h, big)))
    return cost.reshape(-1)


def _inter8(lr, prev_lr, mbw: int, mbh: int):
    """Per-8x8-block lowres inter cost + mv vs the previous lowres frame
    (quadrant outputs of the partition ME kernel = 8x8 lowres blocks)."""
    r = full_search_parts(lr, pad_edge(prev_lr, PAD),
                          sad_lambda(_LOOKAHEAD_QP), _RANGE, mbw, mbh)
    # quadrant order (TL, TR, BL, BR) -> (2*mbh, 2*mbw) 8-block grid
    cq = r["cost_q"].reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3)
    mq = r["mv_q"].reshape(mbh, mbw, 2, 2, 2).permute(0, 2, 1, 3, 4)
    n8 = 4 * mbh * mbw
    return cq.reshape(n8), mq.reshape(n8, 2)


def lowres_stats8(lr, prev_lr, mbw: int, mbh: int):
    """(intra_cost, inter_cost, mv) at 8x8 lowres grain; inter parts are
    None for the first frame of a chain."""
    ic = _intra8(lr, mbw=mbw, mbh=mbh)
    if prev_lr is None:
        return ic, None, None
    pc, mv = _inter8(lr, prev_lr, mbw=mbw, mbh=mbh)
    return ic, pc, mv


class Lookahead:
    """Holds the last anchor's lowres plane and plans mini-GOP cuts; the
    planes go to ``device`` (numpy source planes are uploaded)."""

    def __init__(self, params, device):
        self.p = params
        self.device = torch.device(device)
        self.prev_anchor = None        # lowres of the last encoded anchor

    def _lowres(self, y):
        return lowres_plane(torch.from_numpy(np.ascontiguousarray(y))
                            .to(self.device))

    def push_anchor(self, y):
        self.prev_anchor = self._lowres(y)

    def plan(self, ys) -> int:
        """ys: padded source luma planes queued since the last anchor.
        Returns m = number of leading B frames (0..len-1); queue index m
        becomes the P anchor."""
        k = len(ys)
        if self.prev_anchor is None:
            return 0
        if k < 2:
            return k - 1
        lrs = [self.prev_anchor] + [self._lowres(y) for y in ys]
        h, w = lrs[0].shape
        mbw, mbh = w // 16, h // 16
        if mbw < 1 or mbh < 1:
            return k - 1
        stack = torch.stack(lrs)       # 0 = prev anchor, 1..k = queue
        pairs = []
        for j in range(1, k + 1):
            pairs.append((j, j - 1))                 # P-chain cost
        for j in range(2, k + 1):
            pairs.append((j, 0))                     # vs previous anchor
        for m in range(1, k):
            for j in range(1, m + 1):
                pairs.append((j, m + 1))             # vs candidate anchor
        c = _pair_costs(stack, tuple(pairs), mbw=mbw, mbh=mbh
                        ).cpu().numpy().astype(np.int64)
        cp = {j: c[j - 1] for j in range(1, k + 1)}      # per-MB arrays
        ca = {1: cp[1]}
        ca.update({j: c[k + j - 2] for j in range(2, k + 1)})
        idx = 2 * k - 1
        cb_back = {}
        for m in range(1, k):
            for j in range(1, m + 1):
                cb_back[(j, m)] = c[idx]
                idx += 1
        for m in range(k - 1, 0, -1):  # prefer the longest B run
            if all(int(np.minimum(ca[j], cb_back[(j, m)]).sum())
                   <= int(cp[j].sum())
                   for j in range(1, m + 1)):
                return m
        return 0
