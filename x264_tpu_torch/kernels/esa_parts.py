"""Exhaustive fullpel partition search, all nine units at once: the
wrapper of the CUDA kernel ``csrc/esa_parts.cu`` (the search of
``csrc/esa_core.cuh`` with nine units) and its plain PyTorch twin.

Replaces x264_tpu/ops/device/me_parts_pallas.py::full_search_parts_pallas;
the plain twin copies the loop of
x264_tpu/ops/device/me_parts.py::full_search_parts_xla.  Units: the four
8x8 quadrants (q = 2*qy + qx), the two 16x8 halves (top, bottom), the two
8x16 halves (left, right) and the 16x16 block.  Each unit's cost is its
SAD plus lam * (bits(4dx) + bits(4dy)); ties go to the first candidate in
(dy, dx) raster order, so the 16x16 unit equals ``esa16``'s result."""

from __future__ import annotations

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.esa16 import _check_args, esa_launcher
from x264_tpu_torch.state import PAD, mv_bits_table

_I32 = torch.int32

# output key -> shape after the leading N (the kernel's output order)
UNITS = (("cost_q", (4,)), ("mv_q", (4, 2)), ("cost_h", (2,)),
         ("mv_h", (2, 2)), ("cost_v", (2,)), ("mv_v", (2, 2)),
         ("cost_f", ()), ("mv_f", (2,)))
OUT_SHAPES = tuple(s for _, s in UNITS)


def _quad_sads(ad, mbw: int, mbh: int):
    """|src - shifted| (H, W) -> per-quadrant SAD (N, 4), q = 2*qy + qx."""
    s8 = ad.reshape(mbh, 2, 8, mbw, 2, 8).sum((2, 5), dtype=_I32)
    return s8.permute(0, 2, 1, 3).reshape(mbw * mbh, 4)


def full_search_parts_plain(src_y, ref_pad, lam: int, me_range: int,
                            mbw: int, mbh: int):
    """Plain twin of ``me_parts.full_search_parts_xla``: the same (dy, dx)
    raster loop with strict-< updates per unit."""
    _check_args(src_y, ref_pad, me_range, mbw, mbh, "full_search_parts")
    r = me_range
    h, w = 16 * mbh, 16 * mbw
    n = mbw * mbh
    dev = src_y.device
    src = src_y.to(_I32)
    ref = ref_pad.to(_I32)
    bits = mv_bits_table(dev, 4 * r)
    big = 1 << 30
    bq = torch.full((n, 4), big, dtype=_I32, device=dev)
    bh = torch.full((n, 2), big, dtype=_I32, device=dev)
    bv = torch.full((n, 2), big, dtype=_I32, device=dev)
    bf = torch.full((n,), big, dtype=_I32, device=dev)
    mq = torch.zeros((n, 4, 2), dtype=_I32, device=dev)
    mh = torch.zeros((n, 2, 2), dtype=_I32, device=dev)
    mv_ = torch.zeros((n, 2, 2), dtype=_I32, device=dev)
    mf = torch.zeros((n, 2), dtype=_I32, device=dev)
    d = torch.arange(-4 * r, 4 * r + 1, 4, dtype=_I32, device=dev)
    cands = torch.stack(torch.meshgrid(d, d, indexing="xy"), -1)  # [dy, dx]

    for dy in range(-r, r + 1):
        band = ref[PAD + dy:PAD + dy + h]
        cost_y = lam * bits[4 * dy + 4 * r]
        for dx in range(-r, r + 1):
            shifted = band[:, PAD + dx:PAD + dx + w]
            q = _quad_sads((src - shifted).abs(), mbw, mbh)    # (N, 4)
            bb = cost_y + lam * bits[4 * dx + 4 * r]
            cand = cands[dy + r, dx + r]

            cq = q + bb
            bet = cq < bq
            bq = torch.where(bet, cq, bq)
            mq = torch.where(bet[..., None], cand, mq)

            ch = torch.stack([q[:, 0] + q[:, 1], q[:, 2] + q[:, 3]], 1) + bb
            bet = ch < bh
            bh = torch.where(bet, ch, bh)
            mh = torch.where(bet[..., None], cand, mh)

            cv = torch.stack([q[:, 0] + q[:, 2], q[:, 1] + q[:, 3]], 1) + bb
            bet = cv < bv
            bv = torch.where(bet, cv, bv)
            mv_ = torch.where(bet[..., None], cand, mv_)

            cf = q.sum(1, dtype=_I32) + bb
            bet = cf < bf
            bf = torch.where(bet, cf, bf)
            mf = torch.where(bet[:, None], cand, mf)
    return dict(cost_q=bq, mv_q=mq, cost_h=bh, mv_h=mh, cost_v=bv, mv_v=mv_,
                cost_f=bf, mv_f=mf)


def full_search_parts(src_y, ref_pad, lam: int, me_range: int, mbw: int,
                      mbh: int):
    """src_y (H, W) uint8, ref_pad (H+2PAD, W+2PAD) uint8, lam int.
    Returns the dict of the nine units' costs and qpel mvs (int32, keys
    as in ``UNITS``).  CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    lam = int(lam)
    if src_y.device.type == "cpu":
        return full_search_parts_plain(src_y, ref_pad, lam, me_range, mbw,
                                       mbh)
    launch, outs = esa_launcher("esa_parts", OUT_SHAPES, src_y, ref_pad,
                                lam, me_range, mbw, mbh)
    launch()
    LAUNCHES["esa_parts"] += 1
    return dict(zip((k for k, _ in UNITS), outs))
