"""Quality metrics: PSNR + SSIM (parity: reference common/pixel.c
ssim_4x4x2_core/ssim_end4 — same 4x4-grid SSIM variant x264 reports, and
the PSNR accumulation of encoder/encoder.c fdec_filter_row).

Copied from x264_tpu/utils/metrics.py; the port keeps its own copy."""

from __future__ import annotations

import math

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    mse = float((d * d).mean())
    return 99.99 if mse == 0 else 10 * math.log10(255.0 * 255.0 / mse)


def ssim(a: np.ndarray, b: np.ndarray) -> float:
    """x264-style SSIM: statistics on a 4x4 grid (offset by 2 px like
    x264's +2 alignment), Gaussian weighting omitted — matches the value
    x264 logs, not the original paper's windowed SSIM."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    h, w = a.shape
    a = a[2:h - 2 - (h - 4) % 4, 2:w - 2 - (w - 4) % 4]
    b = b[2:a.shape[0] + 2, 2:a.shape[1] + 2]
    hh, ww = a.shape

    def blocks(x):
        return (x.reshape(hh // 4, 4, ww // 4, 4)
                .transpose(0, 2, 1, 3).reshape(-1, 16))

    ba, bb = blocks(a), blocks(b)
    # 2x2 groups of 4x4 blocks (ssim_end4 uses sums over 4 blocks)
    sa = ba.sum(1)
    sb = bb.sum(1)
    saa = (ba * ba).sum(1)
    sbb = (bb * bb).sum(1)
    sab = (ba * bb).sum(1)
    gh, gw = hh // 4, ww // 4

    def quad(x):
        g = x.reshape(gh, gw)
        return (g[:-1, :-1] + g[:-1, 1:] + g[1:, :-1] + g[1:, 1:]).reshape(-1)

    n = 64.0
    sa4, sb4 = quad(sa), quad(sb)
    saa4, sbb4, sab4 = quad(saa), quad(sbb), quad(sab)
    c1 = (0.01 * 255) ** 2 * n * n
    c2 = (0.03 * 255) ** 2 * n * n
    cov = sab4 * n - sa4 * sb4
    va = saa4 * n - sa4 * sa4
    vb = sbb4 * n - sb4 * sb4
    s = (((2 * sa4 * sb4 + c1) * (2 * cov + c2))
         / ((sa4 * sa4 + sb4 * sb4 + c1) * (va + vb + c2)))
    return float(s.mean())
