"""Bit-exact NumPy reference transforms (H.264 8.5; capability parity with
reference common/dct.c).  All functions are batched over leading dims: inputs
are (..., 4, 4) (or (..., 2, 2) for chroma DC) int32/int64 arrays.

Encoder-side forward transforms follow the standard JM/x264 integer design;
decoder-side inverse transforms are normative (these must match what any
conforming decoder computes, which the cv2/ffmpeg conformance gate checks).

Copied from x264_tpu/ops/reference/transform.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

# forward core transform matrix (8.5.12 companion)
_CF = np.array([
    [1, 1, 1, 1],
    [2, 1, -1, -2],
    [1, -1, -1, 1],
    [1, -2, 2, -1],
], dtype=np.int64)

# Hadamard for luma DC (8.5.10) and its own inverse (up to scale 4)
_H4 = np.array([
    [1, 1, 1, 1],
    [1, 1, -1, -1],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
], dtype=np.int64)

_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)


def dct4x4(residual: np.ndarray) -> np.ndarray:
    """Forward 4x4 core transform: Cf . X . Cf^T (batched)."""
    x = residual.astype(np.int64)
    return np.einsum("ij,...jk,lk->...il", _CF, x, _CF)


def idct4x4(d: np.ndarray) -> np.ndarray:
    """Normative inverse 4x4 transform (8.5.12.2) on dequantized coefs.
    Returns residual (..., 4, 4) after the final (x + 32) >> 6."""
    d = d.astype(np.int64)
    # horizontal (rows of each 4x4: operate on last axis)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-1)
    # vertical (second-to-last axis)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=-2)
    return (h + 32) >> 6


def hadamard4x4_fwd(dc: np.ndarray) -> np.ndarray:
    """Encoder luma-DC Hadamard: (H . DC . H^T) >> 1 (JM/x264 convention,
    paired with the qbits+1 DC quantizer)."""
    y = np.einsum("ij,...jk,lk->...il", _H4, dc.astype(np.int64), _H4)
    return (y + 1) >> 1


def hadamard4x4_inv(c: np.ndarray) -> np.ndarray:
    """Normative inverse luma-DC transform f = H . c . H^T (8.5.10)."""
    return np.einsum("ij,...jk,lk->...il", _H4, c.astype(np.int64), _H4)


def hadamard2x2(dc: np.ndarray) -> np.ndarray:
    """Chroma DC 2x2 transform — self-inverse up to scale (8.5.11)."""
    return np.einsum("ij,...jk,lk->...il", _H2, dc.astype(np.int64), _H2)


# -----------------------------------------------------------------------------
# 8x8 transform (High profile; capability parity with reference
# common/dct.c sub8x8_dct8/add8x8_idct8).  The 1-D butterflies use >>1
# floor shifts, so they are expressed directly (not as matrices).
# -----------------------------------------------------------------------------

def _dct8_1d(s, axis):
    """Standard High-profile forward 8-point transform along `axis`."""
    s = np.moveaxis(s.astype(np.int64), axis, -1)
    d = [s[..., k] for k in range(8)]
    s07, s16, s25, s34 = d[0] + d[7], d[1] + d[6], d[2] + d[5], d[3] + d[4]
    a0, a1 = s07 + s34, s16 + s25
    a2, a3 = s07 - s34, s16 - s25
    d07, d16, d25, d34 = d[0] - d[7], d[1] - d[6], d[2] - d[5], d[3] - d[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    out = np.stack([
        a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
        a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7], axis=-1)
    return np.moveaxis(out, -1, axis)


def _idct8_1d(s, axis):
    """Normative inverse 8-point transform (8.5.12.3) along `axis`."""
    s = np.moveaxis(s.astype(np.int64), axis, -1)
    d = [s[..., k] for k in range(8)]
    e0 = d[0] + d[4]
    e2 = d[0] - d[4]
    e4 = (d[2] >> 1) - d[6]
    e6 = d[2] + (d[6] >> 1)
    e1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    e3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    e5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    e7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    f0, f2, f4, f6 = e0 + e6, e2 + e4, e2 - e4, e0 - e6
    f1 = e1 + (e7 >> 2)
    f3 = e3 + (e5 >> 2)
    f5 = (e3 >> 2) - e5
    f7 = e7 - (e1 >> 2)
    out = np.stack([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                    f6 - f1, f4 - f3, f2 - f5, f0 - f7], axis=-1)
    return np.moveaxis(out, -1, axis)


def dct8x8(residual: np.ndarray) -> np.ndarray:
    """Forward 8x8 transform on (..., 8, 8) residual: vertical then
    horizontal 1-D passes (the x264/JM ordering)."""
    return _dct8_1d(_dct8_1d(residual, -2), -1)


def idct8x8(d: np.ndarray) -> np.ndarray:
    """Normative inverse 8x8 transform (8.5.12.3): horizontal then
    vertical 1-D passes, final (x + 32) >> 6."""
    return (_idct8_1d(_idct8_1d(d, -1), -2) + 32) >> 6


def mb_luma_to_blocks8(mb: np.ndarray) -> np.ndarray:
    """(..., 16, 16) MB -> (..., 4, 8, 8) raster 8x8 quadrants."""
    sh = mb.shape[:-2]
    return (mb.reshape(*sh, 2, 8, 2, 8)
              .transpose(*range(len(sh)), -4, -2, -3, -1)
              .reshape(*sh, 4, 8, 8))


def blocks8_to_mb_luma(blocks: np.ndarray) -> np.ndarray:
    sh = blocks.shape[:-3]
    return (blocks.reshape(*sh, 2, 2, 8, 8)
                  .transpose(*range(len(sh)), -4, -2, -3, -1)
                  .reshape(*sh, 16, 16))


# -----------------------------------------------------------------------------
# Block (de)interleave helpers: frame planes <-> (..., nBlocks, 4, 4)
# -----------------------------------------------------------------------------

def plane_to_blocks4(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H//4 * W//4, 4, 4) in raster block order."""
    h, w = plane.shape
    return (plane.reshape(h // 4, 4, w // 4, 4)
                 .transpose(0, 2, 1, 3)
                 .reshape(-1, 4, 4))


def blocks4_to_plane(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    return (blocks.reshape(h // 4, w // 4, 4, 4)
                  .transpose(0, 2, 1, 3)
                  .reshape(h, w))


def mb_luma_to_blocks(mb: np.ndarray) -> np.ndarray:
    """(..., 16, 16) MB -> (..., 16, 4, 4) 4x4 blocks in *raster* order
    (block index b = 4*(y4) + x4)."""
    sh = mb.shape[:-2]
    return (mb.reshape(*sh, 4, 4, 4, 4)
              .transpose(*range(len(sh)), -4, -2, -3, -1)
              .reshape(*sh, 16, 4, 4))


def blocks_to_mb_luma(blocks: np.ndarray) -> np.ndarray:
    """Inverse of mb_luma_to_blocks."""
    sh = blocks.shape[:-3]
    return (blocks.reshape(*sh, 4, 4, 4, 4)
                  .transpose(*range(len(sh)), -4, -2, -3, -1)
                  .reshape(*sh, 16, 16))


# H.264 coded order of the 16 luma 4x4 blocks within a MB (zigzag of 8x8
# quadrants, each quadrant in 2x2 sub-raster): raster index of coded block k.
LUMA4x4_CODED_ORDER = np.array(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], dtype=np.int32)
# inverse permutation: coded position of raster block r
LUMA4x4_RASTER_TO_CODED = np.argsort(LUMA4x4_CODED_ORDER).astype(np.int32)
