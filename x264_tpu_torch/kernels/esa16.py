"""Exhaustive fullpel 16x16 motion search: the wrapper of the CUDA kernel
``csrc/esa16.cu`` (the search of ``csrc/esa_core.cuh`` with one unit), the
range check of its 32-bit argmin key, and its plain PyTorch twin.

Replaces x264_tpu/ops/device/me_pallas.py::full_search_pallas; the plain
twin copies the loop of x264_tpu/ops/device/me.py::_full_search_xla."""

from __future__ import annotations

import functools

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.state import PAD, mv_bits_arr, mv_bits_table

_I32 = torch.int32

# The kernels' argmin key (csrc/esa_core.cuh): (cost << 13) | c, unsigned
# 32 bits, c = dy_idx * (2r+1) + dx_idx the raster candidate; its least
# value is the least cost, ties to the first candidate.
KEY_CAND_BITS = 13
KEY_COST_BITS = 32 - KEY_CAND_BITS
SAD_MAX = 256 * 255          # the 16x16 block's largest SAD

OUT_SHAPES = ((2,), ())      # mv, cost: each after the leading N


def pack_key(cost, cand):
    """The kernels' key of a cost and a raster candidate."""
    return (cost << KEY_CAND_BITS) | cand


def unpack_key(key):
    """key -> (cost, raster candidate)."""
    return key >> KEY_CAND_BITS, key & ((1 << KEY_CAND_BITS) - 1)


def check_key_range(lam: int, me_range: int) -> None:
    """Raise ValueError unless every candidate index and every cost of a
    search at this range and lambda fit the kernels' 32-bit key.  The
    kernels give a candidate of a tile past the range the cost SAD +
    2^19 - 1 - SAD_MAX, so a real cost must stay below 2^19 - SAD_MAX."""
    span = 2 * me_range + 1
    if span * span > 1 << KEY_CAND_BITS:
        raise ValueError(f"me_range {me_range}: {span * span} candidates "
                         f"exceed the key's {KEY_CAND_BITS} bits")
    worst = SAD_MAX + lam * 2 * int(mv_bits_arr(4 * me_range).max())
    if lam < 0 or worst + SAD_MAX >= 1 << KEY_COST_BITS:
        raise ValueError(f"lambda {lam} at me_range {me_range}: costs up to "
                         f"{worst} do not fit the key's {KEY_COST_BITS} "
                         f"bits beside a masked SAD of up to {SAD_MAX}")


def _check_args(src_y, ref_pad, me_range: int, mbw: int, mbh: int,
                name: str = "full_search_16x16"):
    if me_range > PAD:
        # the search window's dx/dy slices assume |d| <= PAD
        raise ValueError(f"me_range {me_range} exceeds the reference "
                         f"padding {PAD}")
    h, w = 16 * mbh, 16 * mbw
    if tuple(src_y.shape) != (h, w) or \
            tuple(ref_pad.shape) != (h + 2 * PAD, w + 2 * PAD):
        raise ValueError(f"{name}: src {tuple(src_y.shape)} / "
                         f"ref {tuple(ref_pad.shape)} do not fit "
                         f"{mbw}x{mbh} MBs with padding {PAD}")


def _check_kernel_args(src_y, ref_pad, lam: int, me_range: int, name: str):
    """What the CUDA kernels need beyond ``_check_args``: one CUDA device,
    contiguous uint8 planes on 16-byte boundaries (the window is staged by
    16-byte copies; both row strides are multiples of 16), and a key range
    that fits."""
    dev = src_y.device
    if dev.type != "cuda" or ref_pad.device != dev:
        raise ValueError(f"{name}: tensors on {dev} and {ref_pad.device}; "
                         "the kernel needs one CUDA device")
    if src_y.dtype != torch.uint8 or ref_pad.dtype != torch.uint8 or \
            not (src_y.is_contiguous() and ref_pad.is_contiguous()):
        raise ValueError(f"{name}: planes must be contiguous uint8")
    if src_y.data_ptr() % 16 or ref_pad.data_ptr() % 16:
        raise ValueError(f"{name}: planes must start on a 16-byte boundary")
    check_key_range(lam, me_range)


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
    bits = mv_bits_table(dev, 4 * r)
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


@functools.lru_cache(maxsize=None)
def _bits_on_card(device: torch.device, me_range: int) -> torch.Tensor:
    """The mv-bits table of a range on the card, made once: a fresh one
    per call is a copy from pageable host memory, which waits for the
    stream and so holds the host back until the last kernel ends."""
    return mv_bits_table(device, 4 * me_range)


def esa_launcher(kernel: str, shapes, src_y, ref_pad, lam: int,
                 me_range: int, mbw: int, mbh: int, lib=None):
    """Check a call of the ESA kernel ``kernel`` ("esa16" or "esa_parts")
    and allocate its int32 outputs, (N,) + each of ``shapes`` in the
    kernel's order.  Returns (launch, outputs): launch() runs the kernel of
    ``lib`` (the built library when None) into the outputs and raises if
    the launch fails.  The wrappers launch through it and count each of
    their launches; launch() counts nothing."""
    api = "full_search_16x16" if kernel == "esa16" else "full_search_parts"
    _check_args(src_y, ref_pad, me_range, mbw, mbh, api)
    _check_kernel_args(src_y, ref_pad, lam, me_range, api)
    dev = src_y.device
    bits = _bits_on_card(dev, me_range)
    outs = [torch.empty((mbw * mbh,) + tuple(s), dtype=_I32, device=dev)
            for s in shapes]
    fn = getattr(lib or library(), f"{kernel}_launch")
    args = (src_y.data_ptr(), ref_pad.data_ptr(), bits.data_ptr(),
            *(o.data_ptr() for o in outs), mbw, mbh, me_range, lam, PAD)

    def launch():
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        check(err, kernel)

    return launch, outs


def full_search_16x16(src_y, ref_pad, lam: int, me_range: int, mbw: int,
                      mbh: int):
    """src_y (H, W) uint8, ref_pad (H+2PAD, W+2PAD) uint8, lam int.
    Returns (mv (N,2) int32 qpel, cost (N,) int32).  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    lam = int(lam)
    if src_y.device.type == "cpu":
        return full_search_16x16_plain(src_y, ref_pad, lam, me_range, mbw,
                                       mbh)
    launch, (mv, cost) = esa_launcher("esa16", OUT_SHAPES, src_y, ref_pad,
                                      lam, me_range, mbw, mbh)
    launch()
    LAUNCHES["esa16"] += 1
    return mv, cost
