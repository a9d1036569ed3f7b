"""In-loop deblocking filter: the wrappers of the CUDA kernels
``csrc/deblock.cu`` (K3 luma, K4 chroma) and their plain PyTorch twin.

Replaces x264_tpu/ops/device/deblock_pallas.py::deblock_filter_pallas;
the plain twin computes what x264_tpu/ops/device/deblock.py::
_deblock_filter computes, filtering each knight diagonal t = mbx + 2*mby
as one batch of MBs (they touch disjoint pixels and read only pixels
that earlier diagonals finished)."""

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


def _steps(mbw: int, mbh: int, device):
    """Per knight step: (mby, mbx, mb, left MB, top MB) of its MBs; the
    left/top of a border MB is the MB itself (its edge has bS 0)."""
    for t in range(mbw + 2 * mbh - 2):
        mby, mbx = _diagonal(t, mbw, mbh, device)
        mb = mby * mbw + mbx
        yield (mby, mbx, mb, torch.where(mbx > 0, mb - 1, mb),
               torch.where(mby > 0, mb - mbw, mb))


def deblock_luma_plain(y, bs_v, bs_h, qp_mb, off_a: int, off_b: int,
                       mbw: int, mbh: int):
    """Plain twin of K3: 4 vertical, then 4 horizontal edges per MB over
    the 16 lines of every MB of each knight step.  Returns a new plane."""
    dev = y.device
    # 4 px of zero margin on the top and left keep every border edge's
    # taps in range; border edges have bS 0 and change nothing
    yp = torch.zeros((16 * mbh + 4, 16 * mbw + 4), dtype=_I32, device=dev)
    yp[4:, 4:] = y
    qp_mb = qp_mb.to(_I32)
    r16 = torch.arange(16, device=dev)
    tap = torch.arange(-4, 4, device=dev)
    for mby, mbx, mb, left, top in _steps(mbw, mbh, dev):
        rows = 4 + 16 * mby[:, None] + r16                   # (M,16)
        for e in range(4):
            cols = (4 + 16 * mbx + 4 * e)[:, None] + tap     # (M,8)
            win = yp[rows[:, :, None], cols[:, None, :]]     # (M,16,8)
            bs = bs_v[4 * mby[:, None] + r16 // 4, (4 * mbx + e)[:, None]]
            res = luma_filter_params(
                *win.unbind(-1),
                *edge_tables(bs, _qp_av(qp_mb, mb, left, e), off_a, off_b))
            yp[rows[:, :, None], cols[:, None, 1:7]] = torch.stack(res, -1)
        cols = 4 + 16 * mbx[:, None] + r16                   # (M,16)
        for e in range(4):
            rws = (4 + 16 * mby + 4 * e)[:, None] + tap      # (M,8)
            win = yp[rws[:, :, None], cols[:, None, :]]      # (M,8,16)
            bs = bs_h[(4 * mby + e)[:, None], 4 * mbx[:, None] + r16 // 4]
            res = luma_filter_params(
                *win.unbind(1),
                *edge_tables(bs, _qp_av(qp_mb, mb, top, e), off_a, off_b))
            yp[rws[:, 1:7, None], cols[:, None, :]] = torch.stack(res, 1)
    return yp[4:, 4:].to(torch.uint8)


def deblock_chroma_plain(u, v, bs_v, bs_h, qpc_mb, off_a: int, off_b: int,
                         mbw: int, mbh: int):
    """Plain twin of K4: edges 0 and 2 per direction, Cb and Cr together.
    Returns new (u, v) planes."""
    dev = u.device
    cp = torch.zeros((2, 8 * mbh + 2, 8 * mbw + 2), dtype=_I32, device=dev)
    cp[0, 2:, 2:] = u
    cp[1, 2:, 2:] = v
    qpc_mb = qpc_mb.to(_I32)
    r8 = torch.arange(8, device=dev)
    tap = torch.arange(-2, 2, device=dev)
    for mby, mbx, mb, left, top in _steps(mbw, mbh, dev):
        rows = 2 + 8 * mby[:, None] + r8                     # (M,8)
        for e in (0, 2):
            cols = (2 + 8 * mbx + 2 * e)[:, None] + tap      # (M,4)
            win = cp[:, rows[:, :, None], cols[:, None, :]]  # (2,M,8,4)
            bs = bs_v[4 * mby[:, None] + r8 // 2, (4 * mbx + e)[:, None]]
            res = chroma_filter_params(
                *win.unbind(-1),
                *edge_tables(bs, _qp_av(qpc_mb, mb, left, e), off_a, off_b))
            cp[:, rows[:, :, None], cols[:, None, 1:3]] = torch.stack(res,
                                                                      -1)
        cols = 2 + 8 * mbx[:, None] + r8                     # (M,8)
        for e in (0, 2):
            rws = (2 + 8 * mby + 2 * e)[:, None] + tap       # (M,4)
            win = cp[:, rws[:, :, None], cols[:, None, :]]   # (2,M,4,8)
            bs = bs_h[(4 * mby + e)[:, None], 4 * mbx[:, None] + r8 // 2]
            res = chroma_filter_params(
                *win.unbind(2),
                *edge_tables(bs, _qp_av(qpc_mb, mb, top, e), off_a, off_b))
            cp[:, rws[:, 1:3, None], cols[:, None, :]] = torch.stack(res, 2)
    return cp[0, 2:, 2:].to(torch.uint8), cp[1, 2:, 2:].to(torch.uint8)


def deblock_filter_plain(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a: int,
                         off_b: int, mbw: int, mbh: int):
    """Plain twin of the deblock kernels.  Returns new (y, u, v) uint8."""
    return (deblock_luma_plain(y, bs_v, bs_h, qp_mb, off_a, off_b, mbw,
                               mbh),
            *deblock_chroma_plain(u, v, bs_v, bs_h, qpc_mb, off_a, off_b,
                                  mbw, mbh))


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


def deblock_luma_(y, bs_v, bs_h, qp_mb, off_a: int, off_b: int, mbw: int,
                  mbh: int):
    """Kernel K3: filter the luma plane in place on the card."""
    _check_planes([y], bs_v, bs_h, qp_mb, mbw, mbh, 16)
    tb = tables(y.device)
    with torch.cuda.device(y.device):
        err = library().deblock_luma_launch(
            y.data_ptr(), bs_v.data_ptr(), bs_h.data_ptr(), qp_mb.data_ptr(),
            tb.alpha.data_ptr(), tb.beta.data_ptr(), tb.tc0.data_ptr(),
            mbw, mbh, int(off_a), int(off_b),
            torch.cuda.current_stream(y.device).cuda_stream)
    check(err, "deblock_luma")
    LAUNCHES["deblock_luma"] += 1


def deblock_chroma_(u, v, bs_v, bs_h, qpc_mb, off_a: int, off_b: int,
                    mbw: int, mbh: int):
    """Kernel K4: filter both chroma planes in place on the card."""
    _check_planes([u, v], bs_v, bs_h, qpc_mb, mbw, mbh, 8)
    tb = tables(u.device)
    with torch.cuda.device(u.device):
        err = library().deblock_chroma_launch(
            u.data_ptr(), v.data_ptr(), bs_v.data_ptr(), bs_h.data_ptr(),
            qpc_mb.data_ptr(), tb.alpha.data_ptr(), tb.beta.data_ptr(),
            tb.tc0.data_ptr(), mbw, mbh, int(off_a), int(off_b),
            torch.cuda.current_stream(u.device).cuda_stream)
    check(err, "deblock_chroma")
    LAUNCHES["deblock_chroma"] += 1


def deblock_filter(y, u, v, bs_v, bs_h, qp_mb, qpc_mb, off_a: int,
                   off_b: int, mbw: int, mbh: int):
    """Filter the recon planes; returns new (y, u, v) uint8 planes.  CPU
    tensors take the plain twin; CUDA tensors run K3 and K4 on copies."""
    if y.device.type == "cpu":
        return deblock_filter_plain(y, u, v, bs_v, bs_h, qp_mb, qpc_mb,
                                    off_a, off_b, mbw, mbh)
    if y.device.type != "cuda":
        raise ValueError(f"deblock_filter: no kernel for {y.device}")
    y, u, v = y.contiguous().clone(), u.contiguous().clone(), \
        v.contiguous().clone()
    deblock_luma_(y, bs_v, bs_h, qp_mb, off_a, off_b, mbw, mbh)
    deblock_chroma_(u, v, bs_v, bs_h, qpc_mb, off_a, off_b, mbw, mbh)
    return y, u, v
