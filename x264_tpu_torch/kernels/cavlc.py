"""CAVLC residual coding: the wrapper of the CUDA kernel
``csrc/cavlc_blocks.cu`` (a warp an MB, a lane a block, on the frame
cores' fields in place) and the code tables it and its plain twin
(``ops/cavlc.block_inputs`` + ``ops/cavlc.code_blocks_plain``) read.

Replaces x264_tpu/ops/device/cavlc.py::residual_slots, which the
reference runs as XLA (no Pallas kernel).  ``ops/cavlc.residual_slots``
picks the twin for CPU tensors and this wrapper for CUDA tensors."""

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
from x264_tpu_torch.kernels.build import check, check_tensors, library

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


BLOCKS_PER_MB = 27
MB_SLOTS = BLOCKS_PER_MB * BLOCK_SLOTS
TABLE_LEN = sum(len(v) for v in TABLES.values())


@functools.lru_cache(maxsize=8)
def tables_on(device: str) -> dict:
    """The fused tables as int32 tensors on ``device``, and their
    concatenation ``block`` padded with zeros to a whole number of 16-byte
    chunks (the kernel's table block, which it copies 16 bytes at a
    time)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in TABLES.items()}
    pad = torch.zeros(-TABLE_LEN % 4, dtype=_I32, device=device)
    out["block"] = torch.cat([out[k] for k in TABLES] + [pad]).contiguous()
    return out


def work(n_mb: int) -> int:
    """Bytes of one call on n_mb MBs: the levels (luma DC 16, luma AC
    256, chroma DC 8, chroma AC 128 words), the counts (16 + 8 words),
    cbp_luma, cbp_chroma and is_i16 read once; vals and lens written
    once."""
    return n_mb * (4 * (16 + 256 + 8 + 128 + 16 + 8 + 2) + 1
                   + 2 * 4 * MB_SLOTS)


@functools.lru_cache(maxsize=8)
def _device_ctx(device: str):
    """(library, table block) of a device, resolved once: the kernel's
    table length is held to the block's here, not on every call."""
    lib = library()
    tab = tables_on(device)["block"]
    if lib.cavlc_table_len() != TABLE_LEN or tab.numel() % 4:
        raise ValueError(f"cavlc_blocks: table block of {TABLE_LEN} words, "
                         f"the kernel reads {lib.cavlc_table_len()}")
    return lib, tab


# argument -> (shape after N, dtype, 16-byte aligned): what the kernel
# reads (the levels by 16-byte copies)
_FIELDS = (("luma_dc", (16,), _I32, True),
           ("luma_ac", (16, 16), _I32, True),
           ("luma_nnz", (16,), _I32, False),
           ("chroma_dc", (2, 4), _I32, True),
           ("chroma_ac", (2, 4, 16), _I32, True),
           ("chroma_nnz", (2, 4), _I32, False),
           ("cbp_luma", (), _I32, False), ("cbp_chroma", (), _I32, False),
           ("is_i16", (), torch.bool, False))


def residual_slots_(luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac,
                    chroma_nnz, cbp_luma, cbp_chroma, is_i16, mbw: int,
                    mbh: int):
    """Launch the kernel on a frame's CUDA fields (shapes and dtypes as
    ``_FIELDS``, N = mbw * mbh) -> (vals, lens) (N, 972) int32 in
    emission order, the lengths of an uncoded block zeroed."""
    args = (luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac, chroma_nnz,
            cbp_luma, cbp_chroma, is_i16)
    dev = luma_dc.device
    if dev.type != "cuda" or mbw < 1 or mbh < 1:
        raise ValueError(f"cavlc_blocks: a {mbw}x{mbh} frame on {dev}")
    n = mbw * mbh
    check_tensors("cavlc_blocks", dev,
                  [(name, t, (n, *shape), dtype, al)
                   for t, (name, shape, dtype, al) in zip(args, _FIELDS)])
    lib, tab = _device_ctx(str(dev))
    vals, lens = torch.empty((2, n, MB_SLOTS), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = lib.cavlc_mb_launch(
            *(t.data_ptr() for t in args), tab.data_ptr(), vals.data_ptr(),
            lens.data_ptr(), mbw, mbh,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "cavlc_blocks")
    LAUNCHES["cavlc_blocks"] += 1
    return vals, lens
