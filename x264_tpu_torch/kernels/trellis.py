"""Trellis quantisation: the wrapper of the CUDA kernel ``csrc/trellis.cu``
(the 9-state Viterbi and its backtrack, a thread per block for large
calls, 16 lanes per block for small ones, chosen by the launcher from
the block count) and the work it does, for its bound.

Replaces x264_tpu/ops/device/trellis.py::trellis_quant, which the
reference runs as XLA (no Pallas kernel); the plain twin is
``ops/trellis.trellis_quant_plain``."""

from __future__ import annotations

import functools

import numpy as np
import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.ops.trellis import (lambda_tables, position_gains,
                                        trellis_quant_plain)

NCS = (15, 16, 64)
# csrc/trellis.cu's layouts as trellis_launch_layout numbers them; the
# encoder's calls leave the choice to the launcher (trellis_auto_layout)
LAYOUTS = {"thread": 1, "lanes": 2}

# float operations of one Viterbi step of one block, an FMA counted as
# two: the fewest that give the step's levels, as csrc/trellis.cu's
# thread-per-block layout computes them (kCand: 36 moves, 27 comparisons).
# Per block: c, c/dq, +0.5 and (w*c)*c (5), each candidate level's error
# (FMA 2) and distortion (2), min(a, 15) - 2 of both (4): 17.  Per state:
# level 0 (2 adds), the entry term base_e (2) and its level-1 move (1),
# gt_base (1), lcg of both levels (FMA 2 + 2 adds each: 8) and their moves
# (2 each: 4): 18.  The first minimum of each target over its moves: 27.
FLOPS_PER_STEP = 17 + 18 * 9 + 27


def params_block(tbl, lam2f, nc: int, device) -> torch.Tensor:
    """The kernel's per-call parameter block (layout in csrc/trellis.cu),
    float32 on ``device``; cached by the tables' and lambda's bytes, so
    that the calls of a frame and of later frames at its QP neither
    rebuild nor upload it."""
    return _params_block(str(torch.device(device)), nc,
                         np.float32(lam2f).tobytes(),
                         tuple(np.asarray(a, np.float32).tobytes()
                               for a in tbl))


@functools.lru_cache(maxsize=256)
def _params_block(device: str, nc: int, lam: bytes, tbl: tuple):
    shapes = ((nc - 1, 2), (nc - 1, 2), (8, 2), (8, 2), (2,))
    tbl = [np.frombuffer(b, np.float32).reshape(sh)
           for b, sh in zip(tbl, shapes)]
    t = lambda_tables(tbl, np.frombuffer(lam, np.float32)[0], nc)
    k, w = position_gains(nc)
    host = np.concatenate([t["sig0"], t["fl"], t["fm"], t["lc1"], t["b0e1"],
                           t["gt1e0"], t["gt1e1"], t["fin"],
                           np.atleast_1d(t["byp"]), k, w]).astype(np.float32)
    return torch.from_numpy(host).to(device)


def work(nblocks: int, nc: int) -> tuple:
    """(bytes, float operations) of one call: coefficients and dq read
    once, levels written once; FLOPS_PER_STEP per block and position."""
    return 12 * nblocks * nc, FLOPS_PER_STEP * nblocks * nc


def trellis_quant_(coefs_zz, dq_zz, lam2f, tbl, nc: int):
    """Launch the kernel on CUDA tensors: (B, nc) int32 coefficients and
    float32 dq -> (B, nc) int32 signed levels, in the layout the launcher
    picks from B.  tbl: the cost tables, or their parameter block already
    on the card (``params_block``; a CUDA graph's own buffer,
    ``models/graph.py``)."""
    return _launch(coefs_zz, dq_zz, lam2f, tbl, nc, None)


def _trellis_quant_layout(coefs_zz, dq_zz, lam2f, tbl, nc: int,
                          layout: str):
    """``trellis_quant_`` in a forced layout, a key of ``LAYOUTS``: the
    card's tests and chip_smoke.py hold both layouts to the twin."""
    return _launch(coefs_zz, dq_zz, lam2f, tbl, nc, LAYOUTS[layout])


def _launch(coefs_zz, dq_zz, lam2f, tbl, nc: int, layout):
    if nc not in NCS:
        raise ValueError(f"trellis: nc {nc} not in {NCS}")
    if coefs_zz.dim() != 2 or coefs_zz.shape[1] != nc \
            or dq_zz.shape != coefs_zz.shape:
        raise ValueError(f"trellis: coefs {tuple(coefs_zz.shape)} and dq "
                         f"{tuple(dq_zz.shape)} must both be (B, {nc})")
    dev = coefs_zz.device
    if dq_zz.device != dev:
        raise ValueError("trellis: coefs and dq on different devices")
    c = coefs_zz.to(torch.int32).contiguous()
    dq = dq_zz.to(torch.float32).contiguous()
    params = tbl if torch.is_tensor(tbl) else params_block(tbl, lam2f, nc,
                                                           dev)
    out = torch.empty_like(c)
    args = (c.data_ptr(), dq.data_ptr(), params.data_ptr(), out.data_ptr(),
            c.shape[0], nc)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.trellis_launch(*args, stream) if layout is None else \
            lib.trellis_launch_layout(*args, layout, stream)
    check(err, "trellis")
    LAUNCHES["trellis"] += 1
    return out


def trellis_quant(coefs_zz, dq_zz, lam2f, tbl, nc: int):
    """RD-optimal signed levels of (B, nc) zigzag coefficients: the
    kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if coefs_zz.device.type == "cpu":
        return trellis_quant_plain(coefs_zz, dq_zz, lam2f, tbl, nc)
    if coefs_zz.device.type != "cuda":
        raise ValueError(f"trellis_quant: no kernel for {coefs_zz.device}")
    return trellis_quant_(coefs_zz, dq_zz, lam2f, tbl, nc)
