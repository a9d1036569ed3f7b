"""The periodic-intra-refresh bar of a P frame: the wrapper of the CUDA
kernel ``csrc/pir_column.cu`` (one launch per P frame, one CUDA block
that codes the bar as a wavefront over its anti-diagonals, a warp an
MB), its plain twin ``pir_column_pass_plain`` and the work it does, for
its bound.

Replaces x264_tpu/models/inter_device.py::_pir_column_pass, which the
reference runs as XLA (a ``lax.scan`` over the MB rows; no Pallas
kernel).  The bar is ``ncols`` MB columns from ``pir_col`` on, coded as
I16x16 with chroma from top to bottom, the columns of a row left to
right; columns at or past ``mbw`` are skipped (the reference masks
them).  Each MB predicts from the live recon planes, so a bar MB sees
the bar MBs above it and to its left.  It takes the first cheapest of
the four I16x16 modes and of the four chroma modes by SATD, and codes
its residual with the deadzone quantiser (no trellis, as the
reference).

Both versions update, in place: the int32 recon planes ``ry``, ``ru``,
``rv`` and, at each bar MB, the per-MB fields of ``acc`` (``FIELDS``):
the I16 DC and AC zigzag levels and their counts, the chroma levels and
counts, both cbps, both modes, ``mb_cost`` (the luma SATD of the chosen
mode), ``intra_mask`` set and ``t8`` cleared."""

from __future__ import annotations

import functools

import numpy as np
import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.models.intra import (_block_index, _blocks, _chroma,
                                         _edges, pick_mode)
from x264_tpu_torch.models.residual import encode_i16_luma
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.state import DEQUANT4, QUANT4_MF, ZIGZAG_4x4

_I32 = torch.int32
# the per-MB fields and their per-MB shapes, in the kernel's argument
# order (csrc/pir_column.cu)
_FIELDS = (("luma_dc", (16,)), ("luma_ac", (16, 16)), ("luma_nnz", (16,)),
           ("nnz_deblock", (16,)), ("cbp_luma", ()), ("chroma_dc", (2, 4)),
           ("chroma_ac", (2, 4, 16)), ("chroma_nnz", (2, 4)),
           ("cbp_chroma", ()), ("i16_mode", ()), ("chroma_mode", ()),
           ("mb_cost", ()), ("intra_mask", ()), ("t8", ()))
FIELDS = tuple(name for name, _ in _FIELDS)
_BOOL_FIELDS = ("intra_mask", "t8")

# int32 operations per MB, counted from the arithmetic of one bar MB:
# four 16x16 predictions and SATDs (a difference, 8 butterfly adds and an
# absolute value a pixel), the 4x4 transform, quant, dequant and inverse
# of the 256 pixels (~40 a pixel) and the 16-point DC Hadamards; the same
# for the 2 x 64 chroma pixels
OPS_MB = 4 * 256 * 12 + 256 * 40 + 2 * 64 * (4 * 12 + 40) + 200


def bar_mbs(pir_col: int, ncols: int, mbw: int, mbh: int) -> int:
    """The MBs a bar codes: its columns inside the frame, every row."""
    return max(0, min(ncols, mbw - pir_col)) * mbh


def work(n_mb: int) -> tuple:
    """(bytes, int32 operations) of a bar of n_mb MBs: per MB the source
    MB read once (384 bytes), its recon written once and its edges read
    (int32, 384 + 51 words) and its fields written once (476 words)."""
    words = sum(int(np.prod(s)) if s else 1 for _, s in _FIELDS)
    return n_mb * (384 + 4 * (384 + 51) + 4 * words), n_mb * OPS_MB


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> torch.Tensor:
    """The kernel's constant block: the 4x4 zigzag, then the 4x4 quant and
    dequant tables by qp % 6 (raster positions)."""
    host = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in
                           (ZIGZAG_4x4, QUANT4_MF, DEQUANT4)])
    return torch.from_numpy(host).to(device)


def pir_column_pass_plain(y, u, v, ry, ru, rv, acc: dict, qp, qpc,
                          pir_col: int, mbw: int, mbh: int, ncols: int):
    """Plain twin of the bar, one MB at a time in the reference's order.
    y/u/v: uint8 source planes; ry/ru/rv: int32 recon planes; qp, qpc:
    (N,) int32 luma and chroma QPs; acc: the per-MB fields.  Returns
    (ry, ru, rv, acc), updated in place."""
    dev = y.device
    ysrc, usrc, vsrc = y.to(_I32), u.to(_I32), v.to(_I32)
    for r in range(mbh):
        for ci in range(ncols):
            c = pir_col + ci
            if c >= mbw:
                continue
            # one MB of the I16 wavefront (models/intra.i_frame_core's
            # step), without trellis
            ys = torch.tensor([r], device=dev)
            xs = torch.tensor([c], device=dev)
            at, al = ys > 0, xs > 0
            y0, x0 = 16 * ys, 16 * xs
            mb = r * mbw + c
            top, left, tl = _edges(ry, y0, x0, 16)
            src = _blocks(ysrc, y0, x0, 16)
            mode, cost, pred = pick_mode(
                src, PR.predict_16x16_all(top, left, tl, at, al),
                PR.i16x16_mode_avail(at, al, at & al))
            rec, dc_zz, ac_zz, nnz, cbp_l = encode_i16_luma(
                src, pred, qp[mb:mb + 1])
            cmode, cdc, cac, cnnz, cbp_c = _chroma(
                ru, rv, usrc, vsrc, ys, xs, qpc[mb:mb + 1], None)
            ry[_block_index(y0, x0, 16)] = rec
            for key, val in (("luma_dc", dc_zz), ("luma_ac", ac_zz),
                             ("luma_nnz", nnz), ("nnz_deblock", nnz),
                             ("cbp_luma", cbp_l), ("chroma_dc", cdc),
                             ("chroma_ac", cac), ("chroma_nnz", cnnz),
                             ("cbp_chroma", cbp_c), ("i16_mode", mode),
                             ("chroma_mode", cmode), ("mb_cost", cost)):
                acc[key][mb] = val[0]
            acc["intra_mask"][mb] = True
            acc["t8"][mb] = False
    return ry, ru, rv, acc


def pir_column_pass_(y, u, v, ry, ru, rv, acc: dict, qp, qpc, pir_col: int,
                     mbw: int, mbh: int, ncols: int):
    """Launch the kernel on CUDA tensors (as ``pir_column_pass_plain``;
    every tensor contiguous, the fields int32 but ``intra_mask`` and
    ``t8``, which are bool).  The planes and the AC levels must start on
    16-byte boundaries (``u`` and ``v`` on 8-byte ones), as whole
    allocations and MB-padded frames of a batch do: the kernel copies and
    stores them 16 bytes at a time, and its launcher refuses them
    otherwise (RuntimeError)."""
    dev = ry.device
    n = mbw * mbh
    want = [("y", y, torch.uint8, (16 * mbh, 16 * mbw)),
            ("u", u, torch.uint8, (8 * mbh, 8 * mbw)),
            ("v", v, torch.uint8, (8 * mbh, 8 * mbw)),
            ("ry", ry, _I32, (16 * mbh, 16 * mbw)),
            ("ru", ru, _I32, (8 * mbh, 8 * mbw)),
            ("rv", rv, _I32, (8 * mbh, 8 * mbw)),
            ("qp", qp, _I32, (n,)), ("qpc", qpc, _I32, (n,))]
    want += [(k, acc[k], torch.bool if k in _BOOL_FIELDS else _I32,
              (n, *s)) for k, s in _FIELDS]
    for name, t, dtype, shape in want:
        if not torch.is_tensor(t) or t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"pir_column: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {dev}")
    if not 0 <= pir_col < mbw or ncols < 1:
        raise ValueError(f"pir_column: bar at column {pir_col}, {ncols} "
                         f"wide, outside a frame {mbw} MBs wide")
    ptrs = [t.data_ptr() for _, t, _, _ in want]
    ptrs.append(_tables(str(dev)).data_ptr())
    with torch.cuda.device(dev):
        err = library().pir_column_launch(
            *ptrs, pir_col, ncols, mbw, mbh,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "pir_column")
    LAUNCHES["pir_column"] += 1
    return ry, ru, rv, acc


def geometry(pir_col: int, ncols: int, mbw: int, mbh: int) -> tuple:
    """(MB warps, dynamic shared memory bytes, wavefront steps) of the
    kernel's launch for a bar, from the kernel library (card only)."""
    import ctypes
    out = (ctypes.c_int * 3)()
    check(library().pir_column_geom(pir_col, ncols, mbw, mbh,
                                    ctypes.addressof(out)), "pir_column")
    return tuple(out)


def pir_column_pass(y, u, v, ry, ru, rv, acc: dict, qp, qpc, pir_col: int,
                    mbw: int, mbh: int, ncols: int):
    """The refresh bar: the kernel on CUDA tensors, the plain twin on CPU
    tensors."""
    if ry.device.type == "cpu":
        return pir_column_pass_plain(y, u, v, ry, ru, rv, acc, qp, qpc,
                                     pir_col, mbw, mbh, ncols)
    if ry.device.type != "cuda":
        raise ValueError(f"pir_column_pass: no kernel for {ry.device}")
    return pir_column_pass_(y, u, v, ry, ru, rv, acc, qp, qpc, pir_col,
                            mbw, mbh, ncols)
