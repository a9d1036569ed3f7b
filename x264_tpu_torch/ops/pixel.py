"""Pixel metrics batched over leading dims (port of
x264_tpu/ops/device/pixel.py: SAD and the x264 >>1 SATD convention).
Integer results are int32, as in the reference."""

from __future__ import annotations

import torch

_I32 = torch.int32


def sad(a, b):
    return (a.to(_I32) - b.to(_I32)).abs().sum((-1, -2), dtype=_I32)


def hadamard4(x, dim_a: int = -2, dim_b: int = -1):
    """H4 @ x @ H4^T over two axes of 4, as butterflies (integer matrix
    products do not run on the card; the sums are exact either way)."""
    def along(v, dim):
        x0, x1, x2, x3 = v.unbind(dim)
        s01, d01 = x0 + x1, x0 - x1
        s23, d23 = x2 + x3, x2 - x3
        return torch.stack([s01 + s23, s01 - s23, d01 - d23, d01 + d23],
                           dim)
    return along(along(x, dim_a), dim_b)


def satd(a, b):
    """SATD over (..., h, w), h/w multiples of 4: sum of 4x4 Hadamard
    SATDs (x264 satd_MxN composition), final >>1."""
    h, w = a.shape[-2], a.shape[-1]
    d = a.to(_I32) - b.to(_I32)
    d = d.reshape(*d.shape[:-2], h // 4, 4, w // 4, 4)
    t = hadamard4(d, -3, -1).abs().sum((-3, -1), dtype=_I32)
    return t.sum((-1, -2), dtype=_I32) >> 1


def ssd(a, b):
    d = a.to(_I32) - b.to(_I32)
    return (d * d).sum((-1, -2), dtype=_I32)
