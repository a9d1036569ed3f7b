"""Pixel metric reference kernels (parity with reference common/pixel.c:
SAD/SSD/SATD/VAR at the block sizes the analysis uses).  Batched: inputs are
(..., h, w) arrays; metrics reduce the trailing two dims.

Copied from x264_tpu/ops/reference/pixel.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

_H4 = np.array([
    [1, 1, 1, 1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
], dtype=np.int64)


def sad(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int64) - b.astype(np.int64)).sum((-1, -2))


def ssd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a.astype(np.int64) - b.astype(np.int64)
    return (d * d).sum((-1, -2))


def _hadamard4(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,...jk,lk->...il", _H4, x, _H4)


def satd4x4(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Sum of absolute Hadamard-transformed differences of one 4x4 block
    (x264 convention: >> 1 at the end)."""
    d = a.astype(np.int64) - b.astype(np.int64)
    return np.abs(_hadamard4(d)).sum((-1, -2)) >> 1


def satd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SATD over (..., h, w) with h,w multiples of 4 — sum of 4x4 SATDs
    (matches x264's satd_MxN composition of satd_4x4)."""
    h, w = a.shape[-2], a.shape[-1]
    d = a.astype(np.int64) - b.astype(np.int64)
    d = d.reshape(*d.shape[:-2], h // 4, 4, w // 4, 4)
    d = np.moveaxis(d, -2, -3)  # (..., h/4, w/4, 4, 4)
    t = np.abs(_hadamard4(d)).sum((-1, -2))
    return t.sum((-1, -2)) >> 1


def var(a: np.ndarray) -> np.ndarray:
    """Population variance * n^2 trick not needed; returns (sum, ssq)-based
    integer variance like x264's var (used by AQ)."""
    x = a.astype(np.int64)
    n = x.shape[-1] * x.shape[-2]
    s = x.sum((-1, -2))
    sq = (x * x).sum((-1, -2))
    return sq - (s * s) // n
