"""Constant tables and reference-output conversion.

An encoder has no weights: its state is a handful of integer tables and
the decoded picture buffer.  The NumPy tables below are copied, code and
all, from the reference modules named above each of them (never
retyped), so the port and the reference read the same numbers; the
torch tables are built from them once per device.

``to_port`` turns reference outputs (numpy planes, core output dicts)
into port tensors; the tests use it to feed one reference frame to both
encoders' P cores.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

# ---- x264_tpu/bitstream/tables.py ----
# Scan orders (8.5.6).  ZIGZAG_4x4[k] = raster index of k-th coefficient.
ZIGZAG_4x4 = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15],
                      dtype=np.int32)
ZIGZAG_8x8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# Quantization (8.5.9).  Position classes within a 4x4 block:
#   class 0: (0,0),(0,2),(2,0),(2,2);  class 1: (1,1),(1,3),(3,1),(3,3);
#   class 2: the rest.
# DEQUANT4_SCALE = LevelScale4x4 (decoder-normative);
# QUANT4_MF      = standard JM companion MF such that MF*V ~= 2^21 * PF^2.
_POS_CLASS_4x4 = np.array([
    [0, 2, 0, 2],
    [2, 1, 2, 1],
    [0, 2, 0, 2],
    [2, 1, 2, 1],
], dtype=np.int32)

_DEQUANT_CLASS = np.array([  # [qp%6][class]
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

_QUANT_MF_CLASS = np.array([  # [qp%6][class]
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

DEQUANT4 = _DEQUANT_CLASS[:, _POS_CLASS_4x4]   # (6, 4, 4)
QUANT4_MF = _QUANT_MF_CLASS[:, _POS_CLASS_4x4]  # (6, 4, 4)

# 8x8 transform scale tables (8.5.9 LevelScale8x8) — used when the High-profile
# 8x8 transform lands.  [qp%6][class8] with the 6-class position layout.
_POS_CLASS_8x8 = np.zeros((8, 8), dtype=np.int32)
for _i in range(8):
    for _j in range(8):
        if _i % 4 == 0 and _j % 4 == 0:
            _POS_CLASS_8x8[_i, _j] = 0
        elif _i % 2 == 1 and _j % 2 == 1:
            _POS_CLASS_8x8[_i, _j] = 1
        elif _i % 4 == 2 and _j % 4 == 2:
            _POS_CLASS_8x8[_i, _j] = 2
        elif _i % 4 == 0 and _j % 2 == 1 or _i % 2 == 1 and _j % 4 == 0:
            _POS_CLASS_8x8[_i, _j] = 3
        elif _i % 4 == 0 and _j % 4 == 2 or _i % 4 == 2 and _j % 4 == 0:
            _POS_CLASS_8x8[_i, _j] = 4
        else:
            _POS_CLASS_8x8[_i, _j] = 5

_DEQUANT8_CLASS = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], dtype=np.int32)
DEQUANT8 = _DEQUANT8_CLASS[:, _POS_CLASS_8x8]   # (6, 8, 8)

# Encoder-side MF companion for the 8x8 quantizer (standard JM values,
# same role as QUANT4_MF; position classes shared with DEQUANT8).
_QUANT8_MF_CLASS = np.array([
    [13107, 11428, 20972, 12222, 16777, 15481],
    [11916, 10826, 19174, 11058, 14980, 14290],
    [10082, 8943, 15978, 9675, 12710, 11985],
    [9362, 8228, 14913, 8931, 11984, 11259],
    [8192, 7346, 13159, 7740, 10486, 9777],
    [7282, 6428, 11570, 6830, 9118, 8640],
], dtype=np.int32)
QUANT8_MF = _QUANT8_MF_CLASS[:, _POS_CLASS_8x8]  # (6, 8, 8)

# Chroma QP mapping (Table 8-15): QPc as a function of clipped qPi.
_CHROMA_QP_TAIL = np.array(
    [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
     38, 38, 38, 39, 39, 39, 39], dtype=np.int32)
CHROMA_QP_TABLE = np.concatenate([np.arange(30, dtype=np.int32), _CHROMA_QP_TAIL])

# ---- x264_tpu/models/inter_frame.py ----
PAD = 32  # luma search+interp padding (PADH/PADV analog, common/frame.h:32)


def sad_lambda(qp: int) -> int:
    """SATD-domain lambda (reference common/tables.c x264_lambda_tab =
    round(2^((qp-12)/6))): the multiplier for BIT costs added to
    SAD/SATD terms — mv bits, intra mode bits, mb_type costs.  Using
    me_lambda (the λ² law) here overweights bits ~3-4x and biases every
    analysis decision toward cheap-but-poor predictions."""
    return max(1, round(2.0 ** ((qp - 12) / 6.0)))


def me_lambda(qp: int) -> int:
    """LAMBDA2 law (0.85 * 2^((qp-12)/3), reference x264_lambda2_tab):
    the RD slope — correct for trellis / SSD+rate decisions ONLY."""
    return max(1, round(0.85 * 2.0 ** ((qp - 12) / 3.0)))


def mv_bits(d: int) -> int:
    """Bits of se(d) exp-Golomb."""
    k = 2 * abs(d) - (1 if d > 0 else 0)
    return 2 * int(k + 1).bit_length() - 1


_MVBITS_CACHE: dict[int, np.ndarray] = {}


def mv_bits_arr(max_abs: int) -> np.ndarray:
    """Lookup d -> bits for d in [-max_abs, max_abs] (index d + max_abs)."""
    if max_abs not in _MVBITS_CACHE:
        _MVBITS_CACHE[max_abs] = np.array(
            [mv_bits(d) for d in range(-max_abs, max_abs + 1)], np.int64)
    return _MVBITS_CACHE[max_abs]


# ---- x264_tpu/ops/reference/deblock.py ----
ALPHA = np.array([0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22,
                             25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
                             101, 113, 127, 144, 162, 182, 203, 226, 255, 255],
                 dtype=np.int64)
BETA = np.array([0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                            9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
                            15, 16, 16, 17, 17, 18, 18], dtype=np.int64)
# TC0[qp][bs-1] for bs in 1..3
TC0 = np.zeros((52, 3), dtype=np.int64)
_tc0_rows = (
    [(0, 0, 0)] * 17 + [(0, 0, 1)] * 4 + [(0, 1, 1)] * 2 + [(1, 1, 1)] * 4 +
    [(1, 1, 2)] * 4 + [(1, 2, 3)] * 2 + [(2, 2, 3)] + [(2, 2, 4)] +
    [(2, 3, 4)] * 2 + [(3, 3, 5)] + [(3, 4, 6)] * 2 + [(4, 5, 7)] +
    [(4, 5, 8)] + [(4, 6, 9)] + [(5, 7, 10)] + [(6, 8, 11)] + [(6, 8, 13)] +
    [(7, 10, 14)] + [(8, 11, 16)] + [(9, 12, 18)] + [(10, 13, 20)] +
    [(11, 15, 23)] + [(13, 17, 25)]
)
for _q, _row in enumerate(_tc0_rows):
    TC0[_q] = _row


# ---- x264_tpu/ops/reference/mc.py ----
# Branchless qpel formulation shared with the device tier: every quarter-pel
# position equals (S1 + S2 + 1) >> 1 over two plane samples (exact positions
# repeat the same sample, and (2a+1)>>1 == a).  Entry [fx, fy] is
# (p1, dy1, dx1, p2, dy2, dx2) with planes [fp, hh, hv, hc] = 0..3.
QPEL_TWO_SAMPLE_TBL = np.zeros((4, 4, 6), np.int32)
for _fx in range(4):
    for _fy in range(4):
        _FP, _HH, _HV, _HC = 0, 1, 2, 3
        if _fx == 0 and _fy == 0:
            _e = (_FP, 0, 0, _FP, 0, 0)
        elif _fy == 0:
            _e = ((_HH, 0, 0, _HH, 0, 0) if _fx == 2 else
                  (_FP, 0, 0, _HH, 0, 0) if _fx == 1 else
                  (_FP, 0, 1, _HH, 0, 0))
        elif _fx == 0:
            _e = ((_HV, 0, 0, _HV, 0, 0) if _fy == 2 else
                  (_FP, 0, 0, _HV, 0, 0) if _fy == 1 else
                  (_FP, 1, 0, _HV, 0, 0))
        elif _fx == 2 and _fy == 2:
            _e = (_HC, 0, 0, _HC, 0, 0)
        elif _fx == 2:
            _e = (_HC, 0, 0, _HH, 1 if _fy == 3 else 0, 0)
        elif _fy == 2:
            _e = (_HC, 0, 0, _HV, 0, 1 if _fx == 3 else 0)
        else:
            _e = (_HH, 1 if _fy == 3 else 0, 0,
                  _HV, 0, 1 if _fx == 3 else 0)
        QPEL_TWO_SAMPLE_TBL[_fx, _fy] = _e


# JVT-B118 decimation run scores (reference common/tables.c
# x264_decimate_table4/8), as x264_tpu/models/residual_device.py holds them
_DS4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int32)
_DS8 = np.array([3, 3, 3, 3] + [2] * 8 + [1] * 12 + [0] * 40, np.int32)


@dataclass(frozen=True)
class Tables:
    quant4_mf: torch.Tensor     # (6, 4, 4)
    dequant4: torch.Tensor      # (6, 4, 4)
    zigzag4: torch.Tensor       # (16,) raster index of each scan position
    unzigzag4: torch.Tensor     # (16,)
    quant8_mf: torch.Tensor     # (6, 8, 8)
    dequant8: torch.Tensor      # (6, 8, 8)
    zigzag8: torch.Tensor       # (64,)
    unzigzag8: torch.Tensor     # (64,)
    chroma_qp: torch.Tensor     # (52,)
    decimate4: torch.Tensor     # (16,)
    decimate8: torch.Tensor     # (64,)
    alpha: torch.Tensor         # (52,)
    beta: torch.Tensor          # (52,)
    tc0: torch.Tensor           # (52, 3)


def _i32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.int32)),
                           device=device)


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> Tables:
    """The constant tables on ``device`` (built once per device)."""
    return Tables(
        quant4_mf=_i32(QUANT4_MF, device),
        dequant4=_i32(DEQUANT4, device),
        zigzag4=_i32(ZIGZAG_4x4, device).long(),
        unzigzag4=_i32(np.argsort(ZIGZAG_4x4), device).long(),
        quant8_mf=_i32(QUANT8_MF, device),
        dequant8=_i32(DEQUANT8, device),
        zigzag8=_i32(ZIGZAG_8x8, device).long(),
        unzigzag8=_i32(np.argsort(ZIGZAG_8x8), device).long(),
        chroma_qp=_i32(CHROMA_QP_TABLE, device),
        decimate4=_i32(_DS4, device),
        decimate8=_i32(_DS8, device),
        alpha=_i32(ALPHA, device),
        beta=_i32(BETA, device),
        tc0=_i32(TC0, device),
    )


@functools.lru_cache(maxsize=None)
def mv_bits_table(device: torch.device, max_abs: int) -> torch.Tensor:
    """``mv_bits_arr(max_abs)`` as int32 on ``device`` (index d + max_abs)."""
    return _i32(mv_bits_arr(max_abs), device)


def to_port(x, device):
    """Reference output -> port tensors on ``device``: a numpy (or
    array-like) value becomes a tensor of the same dtype, a dict or list
    is converted element by element, ``None`` stays ``None``."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_port(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v, device) for v in x)
    return torch.as_tensor(np.array(x), device=device)
