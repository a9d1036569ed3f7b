"""CAVLC block coding: the wrapper of the CUDA kernel
``csrc/cavlc_blocks.cu`` (a thread per block) and the code tables it and
its plain twin (``ops/cavlc.code_blocks_plain``) read.

Replaces x264_tpu/ops/device/cavlc.py::code_blocks, which the reference
runs as XLA (no Pallas kernel).  ``ops/cavlc.code_blocks`` picks the
twin for CPU tensors and this wrapper for CUDA tensors."""

from __future__ import annotations

import functools

import numpy as np
import torch

from x264_tpu_torch.bitstream.tables import (COEFF_TOKEN_LEN,
                                             COEFF_TOKEN_VAL, RUN_BEFORE_LEN,
                                             RUN_BEFORE_VAL, TOTAL_ZEROS_LEN,
                                             TOTAL_ZEROS_VAL, TZ_2x2_LEN,
                                             TZ_2x2_VAL, TZ_2x4_LEN,
                                             TZ_2x4_VAL)
from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library

_I32 = torch.int32
BLOCK_SLOTS = 36


def _fused(val, ln) -> np.ndarray:
    """A table flattened and fused to val | len << 16, so a lookup is one
    index (the reference's form)."""
    return (val.astype(np.int32) | (ln.astype(np.int32) << 16)).reshape(-1)


# name -> fused table, in the kernel's table-block order
TABLES = {
    "CT": _fused(COEFF_TOKEN_VAL, COEFF_TOKEN_LEN),
    "TZ": _fused(TOTAL_ZEROS_VAL, TOTAL_ZEROS_LEN),
    "TZ2": _fused(TZ_2x2_VAL, TZ_2x2_LEN),
    "TZ24": _fused(TZ_2x4_VAL, TZ_2x4_LEN),
    "RB": _fused(RUN_BEFORE_VAL, RUN_BEFORE_LEN),
}


@functools.lru_cache(maxsize=8)
def tables_on(device: str) -> dict:
    """The fused tables as int32 tensors on ``device``, and their
    concatenation ``block`` (the kernel's table block)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in TABLES.items()}
    out["block"] = torch.cat([out[k] for k in TABLES]).contiguous()
    return out


def work(nblocks: int) -> int:
    """Bytes of one call: levels, blen, nC and the gate read once, vals
    and lens written once."""
    return nblocks * (16 * 4 + 4 + 4 + 1 + 2 * BLOCK_SLOTS * 4)


def code_blocks_(coefs, blen, nC, gate=None):
    """Launch the kernel on CUDA tensors: (B, 16) int32 zigzag levels,
    (B,) blen and nC, (B,) bool gate or None -> (vals, lens) (B, 36)
    int32; a block whose gate is False gets every length 0."""
    if coefs.dim() != 2 or coefs.shape[1] != 16:
        raise ValueError(f"cavlc_blocks: coefs {tuple(coefs.shape)} must "
                         "be (B, 16)")
    nb = coefs.shape[0]
    dev = coefs.device
    if blen.shape != (nb,) or nC.shape != (nb,) or (
            gate is not None and gate.shape != (nb,)):
        raise ValueError("cavlc_blocks: blen, nC and gate must be (B,)")
    if any(t.device != dev for t in (blen, nC) + (
            () if gate is None else (gate,))):
        raise ValueError("cavlc_blocks: inputs on different devices")
    lib = library()
    tab = tables_on(str(dev))["block"]
    if tab.numel() != lib.cavlc_table_len():
        raise ValueError(f"cavlc_blocks: table block of {tab.numel()} "
                         f"words, the kernel reads {lib.cavlc_table_len()}")
    c = coefs.to(_I32).contiguous()
    bl = blen.to(_I32).contiguous()
    nc = nC.to(_I32).contiguous()
    g = None if gate is None else gate.to(torch.uint8).contiguous()
    vals = torch.empty((nb, BLOCK_SLOTS), dtype=_I32, device=dev)
    lens = torch.empty((nb, BLOCK_SLOTS), dtype=_I32, device=dev)
    check(lib.cavlc_blocks_launch(
        c.data_ptr(), bl.data_ptr(), nc.data_ptr(),
        None if g is None else g.data_ptr(), tab.data_ptr(),
        vals.data_ptr(), lens.data_ptr(), nb,
        torch.cuda.current_stream(dev).cuda_stream), "cavlc_blocks")
    LAUNCHES["cavlc_blocks"] += 1
    return vals, lens
