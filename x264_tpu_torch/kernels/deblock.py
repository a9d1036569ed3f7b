"""In-loop deblocking filter: the wrapper of the CUDA kernel
``csrc/deblock.cu`` (one launch per frame for Y, Cb and Cr) and its plain
PyTorch twin.

Replaces x264_tpu/ops/device/deblock_pallas.py::deblock_filter_pallas
(its luma and chroma kernels); the plain twin computes what
x264_tpu/ops/device/deblock.py::_deblock_filter computes, filtering each
knight diagonal t = mbx + 2*mby as one batch of MBs with ``filter_mbs``,
which also filters one MB's vertical or horizontal edges at a time in any
order the kernel's wait rule allows (tests/test_torch_deblock.py)."""

from __future__ import annotations

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.ops.deblock import (chroma_filter_params, edge_tables,
                                        luma_filter_params)
from x264_tpu_torch.state import tables

_I32 = torch.int32


def _diagonal(t: int, mbw: int, mbh: int, device):
    """(mby, mbx) int64 of the MBs on knight step t = mbx + 2*mby."""
    lo = max(0, -(-(t - (mbw - 1)) // 2))
    hi = min(mbh - 1, t // 2)
    mby = torch.arange(lo, hi + 1, device=device)
    return mby, t - 2 * mby


def _qp_av(qp, mb, nb_mb, e: int):
    """(qp_c + qp_neighbour + 1) >> 1 per MB, the neighbour being the left
    (vertical) or top (horizontal) MB for edge 0 and the MB itself else."""
    nb = qp[nb_mb] if e == 0 else qp[mb]
    return ((qp[mb] + nb + 1) >> 1)[:, None]


def padded_planes(y, u, v):
    """int32 copies of the planes with a zero margin on the top and left
    (4 px luma, 2 px chroma; Cb and Cr stacked), which keeps every border
    edge's taps in range: border edges have bS 0 and change nothing."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    yp = torch.zeros((16 * mbh + 4, 16 * mbw + 4), dtype=_I32,
                     device=y.device)
    yp[4:, 4:] = y
    cp = torch.zeros((2, 8 * mbh + 2, 8 * mbw + 2), dtype=_I32,
                     device=y.device)
    cp[0, 2:, 2:] = u
    cp[1, 2:, 2:] = v
    return yp, cp


def unpadded_planes(yp, cp):
    """The (y, u, v) uint8 planes of ``padded_planes``' layout."""
    return (yp[4:, 4:].to(torch.uint8), cp[0, 2:, 2:].to(torch.uint8),
            cp[1, 2:, 2:].to(torch.uint8))


def filter_mbs(yp, cp, vertical: bool, mby, mbx, bs_v, bs_h, qp_mb,
               qpc_mb, off_a: int, off_b: int, mbw: int):
    """Filter the vertical (or horizontal) edges of the MBs (mby, mbx)
    (int64, any batch of MBs that touch disjoint pixels, such as a knight
    diagonal or one MB) in place in the padded planes: luma edges 0-3 over
    the 16 lines of every MB, chroma edges 0 and 2, Cb and Cr together.
    An MB's vertical edges come before its horizontal ones."""
    dev = yp.device
    mb = mby * mbw + mbx
    # the left / top MB for edge 0; a border MB's own (its edge has bS 0)
    nb = torch.where(mbx > 0, mb - 1, mb) if vertical else \
        torch.where(mby > 0, mb - mbw, mb)
    qp_mb, qpc_mb = qp_mb.to(_I32), qpc_mb.to(_I32)

    r16 = torch.arange(16, device=dev)
    tap = torch.arange(-4, 4, device=dev)
    if vertical:
        rows = 4 + 16 * mby[:, None] + r16                   # (M,16)
        for e in range(4):
            cols = (4 + 16 * mbx + 4 * e)[:, None] + tap     # (M,8)
            win = yp[rows[:, :, None], cols[:, None, :]]     # (M,16,8)
            bs = bs_v[4 * mby[:, None] + r16 // 4, (4 * mbx + e)[:, None]]
            res = luma_filter_params(
                *win.unbind(-1),
                *edge_tables(bs, _qp_av(qp_mb, mb, nb, e), off_a, off_b))
            yp[rows[:, :, None], cols[:, None, 1:7]] = torch.stack(res, -1)
    else:
        cols = 4 + 16 * mbx[:, None] + r16                   # (M,16)
        for e in range(4):
            rws = (4 + 16 * mby + 4 * e)[:, None] + tap      # (M,8)
            win = yp[rws[:, :, None], cols[:, None, :]]      # (M,8,16)
            bs = bs_h[(4 * mby + e)[:, None], 4 * mbx[:, None] + r16 // 4]
            res = luma_filter_params(
                *win.unbind(1),
                *edge_tables(bs, _qp_av(qp_mb, mb, nb, e), off_a, off_b))
            yp[rws[:, 1:7, None], cols[:, None, :]] = torch.stack(res, 1)

    r8 = torch.arange(8, device=dev)
    tap = torch.arange(-2, 2, device=dev)
    if vertical:
        rows = 2 + 8 * mby[:, None] + r8                     # (M,8)
        for e in (0, 2):
            cols = (2 + 8 * mbx + 2 * e)[:, None] + tap      # (M,4)
            win = cp[:, rows[:, :, None], cols[:, None, :]]  # (2,M,8,4)
            bs = bs_v[4 * mby[:, None] + r8 // 2, (4 * mbx + e)[:, None]]
            res = chroma_filter_params(
                *win.unbind(-1),
                *edge_tables(bs, _qp_av(qpc_mb, mb, nb, e), off_a, off_b))
            cp[:, rows[:, :, None], cols[:, None, 1:3]] = torch.stack(res,
                                                                      -1)
    else:
        cols = 2 + 8 * mbx[:, None] + r8                     # (M,8)
        for e in (0, 2):
            rws = (2 + 8 * mby + 2 * e)[:, None] + tap       # (M,4)
            win = cp[:, rws[:, :, None], cols[:, None, :]]   # (2,M,4,8)
            bs = bs_h[(4 * mby + e)[:, None], 4 * mbx[:, None] + r8 // 2]
            res = chroma_filter_params(
                *win.unbind(2),
                *edge_tables(bs, _qp_av(qpc_mb, mb, nb, e), off_a, off_b))
            cp[:, rws[:, 1:3, None], cols[:, None, :]] = torch.stack(res, 2)


def deblock_filter_plain(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a: int,
                         off_b: int, mbw: int, mbh: int):
    """Plain twin of the deblock kernel: each knight diagonal as one batch
    of MBs (they touch disjoint pixels and read only pixels that earlier
    diagonals finished).  Returns new (y, u, v) uint8."""
    yp, cp = padded_planes(y, u, v)
    for t in range(mbw + 2 * mbh - 2):
        mby, mbx = _diagonal(t, mbw, mbh, y.device)
        if len(mby) == 0:       # a one-MB-wide frame's odd steps
            continue
        for vertical in (True, False):
            filter_mbs(yp, cp, vertical, mby, mbx, bs_v, bs_h, qp_mb,
                       qpc_mb, off_a, off_b, mbw)
    return unpadded_planes(yp, cp)


def _check_planes(planes, bs_v, bs_h, qps, mbw: int, mbh: int, s: int):
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"deblock kernels: tensors on {dev}; the kernels "
                         "need a CUDA device")
    for p in planes:
        if p.device != dev or p.dtype != torch.uint8 or \
                tuple(p.shape) != (s * mbh, s * mbw) or \
                not p.is_contiguous():
            raise ValueError(f"deblock: planes must be contiguous uint8 "
                             f"({s * mbh}, {s * mbw}) on one device")
    for g in (bs_v, bs_h):
        if g.device != dev or g.dtype != _I32 or \
                tuple(g.shape) != (4 * mbh, 4 * mbw) or not g.is_contiguous():
            raise ValueError("deblock: bS grids must be contiguous int32 "
                             f"({4 * mbh}, {4 * mbw}) on {dev}")
    if qps.device != dev or qps.dtype != _I32 or \
            tuple(qps.shape) != (mbw * mbh,) or not qps.is_contiguous():
        raise ValueError(f"deblock: per-MB QPs must be contiguous int32 "
                         f"({mbw * mbh},) on {dev}")


def deblock_(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a: int, off_b: int,
             mbw: int, mbh: int):
    """The kernel: filter the three planes in place on the card, in one
    launch (plus the zeroing of its row ticket and progress counters)."""
    _check_planes([y], bs_v, bs_h, qp_mb, mbw, mbh, 16)
    _check_planes([u, v], bs_v, bs_h, qpc_mb, mbw, mbh, 8)
    if bs_v.data_ptr() % 16 or any(p.data_ptr() % 4 for p in (y, u, v)):
        raise ValueError("deblock: the kernel loads bS rows as int4 and "
                         "pixels as words: bs_v must be 16-byte aligned "
                         "and the planes 4-byte aligned")
    sync = torch.zeros(mbh + 1, dtype=_I32, device=y.device)
    tb = tables(y.device)
    with torch.cuda.device(y.device):
        err = library().deblock_launch(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), bs_v.data_ptr(),
            bs_h.data_ptr(), qp_mb.data_ptr(), qpc_mb.data_ptr(),
            tb.alpha.data_ptr(), tb.beta.data_ptr(), tb.tc0.data_ptr(),
            sync.data_ptr(), mbw, mbh, int(off_a), int(off_b),
            torch.cuda.current_stream(y.device).cuda_stream)
    check(err, "deblock")
    LAUNCHES["deblock"] += 1


def deblock_filter(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a: int,
                   off_b: int, mbw: int, mbh: int):
    """Filter the recon planes; returns new (y, u, v) uint8 planes.  CPU
    tensors take the plain twin; CUDA tensors run the kernel on copies."""
    if y.device.type == "cpu":
        return deblock_filter_plain(y, u, v, bs_v, bs_h, qp_mb, qpc_mb,
                                    off_a, off_b, mbw, mbh)
    if y.device.type != "cuda":
        raise ValueError(f"deblock_filter: no kernel for {y.device}")
    y, u, v = y.contiguous().clone(), u.contiguous().clone(), \
        v.contiguous().clone()
    deblock_(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a, off_b, mbw, mbh)
    return y, u, v
