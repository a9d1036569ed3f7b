"""Constant tables and reference-output conversion.

An encoder has no weights: its state is a handful of integer tables and
the decoded picture buffer.  Every table is built here, on a given
device, from the framework-free NumPy modules of ``x264_tpu`` (never
retyped), so the port and the reference read the same numbers.

``to_port`` turns reference outputs (numpy planes, core output dicts)
into port tensors; the tests use it to feed one reference frame to both
encoders' P cores.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from x264_tpu.bitstream.tables import (CHROMA_QP_TABLE, DEQUANT4, QUANT4_MF,
                                       ZIGZAG_4x4)
from x264_tpu.models.inter_frame import mv_bits_arr
from x264_tpu.ops.reference.deblock import ALPHA, BETA, TC0

# JVT-B118 decimation run scores (reference common/tables.c
# x264_decimate_table4), as x264_tpu/models/residual_device.py holds them
_DS4 = np.array([3, 2, 2, 1, 1, 1] + [0] * 10, np.int32)


@dataclass(frozen=True)
class Tables:
    quant4_mf: torch.Tensor     # (6, 4, 4)
    dequant4: torch.Tensor      # (6, 4, 4)
    zigzag4: torch.Tensor       # (16,) raster index of each scan position
    unzigzag4: torch.Tensor     # (16,)
    chroma_qp: torch.Tensor     # (52,)
    decimate4: torch.Tensor     # (16,)
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
        chroma_qp=_i32(CHROMA_QP_TABLE, device),
        decimate4=_i32(_DS4, device),
        alpha=_i32(ALPHA, device),
        beta=_i32(BETA, device),
        tc0=_i32(TC0, device),
    )


@functools.lru_cache(maxsize=None)
def mv_bits(device: torch.device, max_abs: int) -> torch.Tensor:
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
