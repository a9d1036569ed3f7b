"""Exhaustive fullpel 16x16 motion search: the wrapper of the CUDA kernel
``csrc/esa16.cu`` and its plain PyTorch twin.

Replaces x264_tpu/ops/device/me_pallas.py::full_search_pallas; the plain
twin copies the loop of x264_tpu/ops/device/me.py::_full_search_xla."""

from __future__ import annotations

import torch

from x264_tpu.models.inter_frame import PAD
from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.state import mv_bits

_I32 = torch.int32


def _check_args(src_y, ref_pad, me_range: int, mbw: int, mbh: int):
    if me_range > PAD:
        # the search window's dx/dy slices assume |d| <= PAD
        raise ValueError(f"me_range {me_range} exceeds the reference "
                         f"padding {PAD}")
    h, w = 16 * mbh, 16 * mbw
    if tuple(src_y.shape) != (h, w) or \
            tuple(ref_pad.shape) != (h + 2 * PAD, w + 2 * PAD):
        raise ValueError(f"full_search_16x16: src {tuple(src_y.shape)} / "
                         f"ref {tuple(ref_pad.shape)} do not fit "
                         f"{mbw}x{mbh} MBs with padding {PAD}")


def full_search_16x16_plain(src_y, ref_pad, lam: int, me_range: int,
                            mbw: int, mbh: int):
    """Plain twin of ``me._full_search_xla``: the same (dy, dx) raster
    loop with strict-< updates, so ties go to the first candidate."""
    _check_args(src_y, ref_pad, me_range, mbw, mbh)
    r = me_range
    h, w = 16 * mbh, 16 * mbw
    n = mbw * mbh
    dev = src_y.device
    src = src_y.to(_I32)
    ref = ref_pad.to(_I32)
    bits = mv_bits(dev, 4 * r)
    best = torch.full((n,), 1 << 30, dtype=_I32, device=dev)
    best_mv = torch.zeros((n, 2), dtype=_I32, device=dev)
    d = torch.arange(-4 * r, 4 * r + 1, 4, dtype=_I32, device=dev)
    cands = torch.stack(torch.meshgrid(d, d, indexing="xy"), -1)  # [dy, dx]
    for dy in range(-r, r + 1):
        band = ref[PAD + dy:PAD + dy + h]
        cost_y = lam * bits[4 * dy + 4 * r]
        for dx in range(-r, r + 1):
            shifted = band[:, PAD + dx:PAD + dx + w]
            sad = ((src - shifted).abs().reshape(mbh, 16, mbw, 16)
                   .sum((1, 3), dtype=_I32).reshape(n))
            cost = sad + cost_y + lam * bits[4 * dx + 4 * r]
            better = cost < best
            best = torch.where(better, cost, best)
            best_mv = torch.where(better[:, None], cands[dy + r, dx + r],
                                  best_mv)
    return best_mv, best


def full_search_16x16(src_y, ref_pad, lam: int, me_range: int, mbw: int,
                      mbh: int):
    """src_y (H, W) uint8, ref_pad (H+2PAD, W+2PAD) uint8, lam int.
    Returns (mv (N,2) int32 qpel, cost (N,) int32).  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    lam = int(lam)
    if src_y.device.type == "cpu":
        return full_search_16x16_plain(src_y, ref_pad, lam, me_range, mbw,
                                       mbh)
    _check_args(src_y, ref_pad, me_range, mbw, mbh)
    dev = src_y.device
    if dev.type != "cuda" or ref_pad.device != dev:
        raise ValueError(f"full_search_16x16: tensors on {dev} and "
                         f"{ref_pad.device}; the kernel needs one CUDA "
                         "device")
    if src_y.dtype != torch.uint8 or ref_pad.dtype != torch.uint8 or \
            not (src_y.is_contiguous() and ref_pad.is_contiguous()):
        raise ValueError("full_search_16x16: planes must be contiguous "
                         "uint8")
    n = mbw * mbh
    bits = mv_bits(dev, 4 * me_range)
    mv = torch.empty((n, 2), dtype=_I32, device=dev)
    cost = torch.empty((n,), dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = library().esa16_launch(
            src_y.data_ptr(), ref_pad.data_ptr(), bits.data_ptr(),
            mv.data_ptr(), cost.data_ptr(), mbw, mbh, me_range, lam, PAD,
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "esa16")
    LAUNCHES["esa16"] += 1
    return mv, cost
