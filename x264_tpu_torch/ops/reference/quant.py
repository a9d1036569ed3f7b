"""Quantization reference kernels (encoder-side standard design, decoder-side
normative — spec 8.5.9-8.5.11; capability parity with reference
common/quant.c).  Batched over leading dims.

Copied from x264_tpu/ops/reference/quant.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.state import DEQUANT4, DEQUANT8, QUANT4_MF, QUANT8_MF


def quant_params(qp: int, intra: bool):
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    return qbits, f


def quant4x4(coefs: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Deadzone quant of (..., 4, 4) transform coefs."""
    qbits, f = quant_params(qp, intra)
    mf = QUANT4_MF[qp % 6].astype(np.int64)
    c = coefs.astype(np.int64)
    level = (np.abs(c) * mf + f) >> qbits
    return np.where(c < 0, -level, level)


def dequant4x4(levels: np.ndarray, qp: int) -> np.ndarray:
    """Normative dequant: d = (c * LevelScale4x4) << (qp/6)."""
    v = DEQUANT4[qp % 6].astype(np.int64)
    return (levels.astype(np.int64) * v) << (qp // 6)


def quant8x8(coefs: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Deadzone quant of (..., 8, 8) coefs (qbits = 16 + qp/6; parity:
    reference common/quant.c quant_8x8)."""
    qbits = 16 + qp // 6
    f = (1 << qbits) // 3 if intra else (1 << qbits) // 6
    mf = QUANT8_MF[qp % 6].astype(np.int64)
    c = coefs.astype(np.int64)
    level = (np.abs(c) * mf + f) >> qbits
    return np.where(c < 0, -level, level)


def dequant8x8(levels: np.ndarray, qp: int) -> np.ndarray:
    """Normative 8x8 dequant (8.5.13.1): LevelScale8x8 includes the flat
    weightScale 16; shift regime splits at qp 36."""
    ls16 = DEQUANT8[qp % 6].astype(np.int64) * 16
    lv = levels.astype(np.int64)
    q6 = qp // 6
    if q6 >= 6:
        return (lv * ls16) << (q6 - 6)
    return (lv * ls16 + (1 << (5 - q6))) >> (6 - q6)


def quant_dc4(coefs: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Luma DC quant (paired with hadamard4x4_fwd's >>1): qbits+1, deadzone 2f."""
    qbits, f = quant_params(qp, intra)
    mf = int(QUANT4_MF[qp % 6, 0, 0])
    c = coefs.astype(np.int64)
    level = (np.abs(c) * mf + 2 * f) >> (qbits + 1)
    return np.where(c < 0, -level, level)


def dequant_dc4(f_had: np.ndarray, qp: int) -> np.ndarray:
    """Normative luma-DC scaling (8.5.10) applied to the inverse-Hadamard
    output f: returns the DC values to place into the 4x4 dequant blocks.
    LevelScale includes the flat scaling-list weight 16 (weightScale=16)."""
    ls16 = int(DEQUANT4[qp % 6, 0, 0]) * 16
    f_had = f_had.astype(np.int64)
    q6 = qp // 6
    if qp >= 36:
        return (f_had * ls16) << (q6 - 6)
    return (f_had * ls16 + (1 << (5 - q6))) >> (6 - q6)


def quant_dc2(coefs: np.ndarray, qp: int, intra: bool) -> np.ndarray:
    """Chroma DC 2x2 quant: qbits+1, deadzone 2f (paired with unshifted
    2x2 Hadamard)."""
    qbits, f = quant_params(qp, intra)
    mf = int(QUANT4_MF[qp % 6, 0, 0])
    c = coefs.astype(np.int64)
    level = (np.abs(c) * mf + 2 * f) >> (qbits + 1)
    return np.where(c < 0, -level, level)


def dequant_dc2(f_had: np.ndarray, qp: int) -> np.ndarray:
    """Normative chroma-DC scaling (8.5.11): ((f * LS) << (qp/6)) >> 5,
    with LS = 16 * normAdjust (flat weightScale)."""
    ls16 = int(DEQUANT4[qp % 6, 0, 0]) * 16
    return ((f_had.astype(np.int64) * ls16) << (qp // 6)) >> 5
