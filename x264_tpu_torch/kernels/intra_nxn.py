"""The I4x4 and I8x8 candidates of one knight step of the I-frame wavefront:
the wrapper of the CUDA kernel ``csrc/intra_nxn.cu`` (one launch per step,
a block per MB, lanes over pixels: the I4x4 chain in one warp, two 4x4
blocks of a sub-step at a time, and the I8x8 chain in a second warp),
its plain twin ``nxn_candidates_plain`` and the work it does, for its
bound.

Replaces the NxN block loops of
x264_tpu/models/intra_device.py::i4_frame_core (I4x4 :360-445, I8x8
:447-554), which the reference runs as XLA inside its ``lax.scan`` (no
Pallas kernel).

Step d holds the MBs (d - 2y, y), y = jmin .. jmin + count - 1
(``knight_lanes``).  Both versions write each MB's I4x4 trial recon into
the int32 recon plane and its 16 modes into the mode grid, in place (the
core lets the I16 or I8x8 winner overwrite them), and return per MB:
modes4 (D,16), acs4 (D,16,16) zigzag levels, nnzs4 (D,16), cost4,
ssd4, rb4 (D,) and, with t8_mode, i8tile (D,16,16), modes8 (D,4), lv64s
(D,4,64) zigzag levels, cost8t, ssd8, rb8 (D,); None for the I8x8
fields without it."""

from __future__ import annotations

import functools

import numpy as np
import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.build import check, library
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.state import (DEQUANT4, DEQUANT8, QUANT4_MF, QUANT8_MF,
                                  ZIGZAG_4x4, ZIGZAG_8x8)

_I32 = torch.int32
_BIG = 1 << 30
# the kernel's per-MB output row (csrc/intra_nxn.cu's o* offsets); the
# last six fields are the I8x8 candidate's
_ROW = (("modes4", (16,)), ("acs4", (16, 16)), ("nnzs4", (16,)),
        ("cost4", ()), ("ssd4", ()), ("rb4", ()), ("i8tile", (16, 16)),
        ("modes8", (4,)), ("lv64s", (4, 64)), ("cost8t", ()), ("ssd8", ()),
        ("rb8", ()))
FIELDS = tuple(name for name, _ in _ROW)
OUT_WORDS = sum(int(np.prod(s)) for _, s in _ROW)

# Knight-order sub-steps of the 16 4x4 blocks inside an MB, s = x4 + 2*y4:
# the reference's order (intra_device.py:234); every block's left, top and
# top-right neighbours come earlier.  csrc/intra_nxn.cu's kSubsteps holds
# the same table (tests/test_torch_kernel_layouts.py)
_SUBSTEPS = [[(0, 0)], [(1, 0)], [(2, 0), (0, 1)], [(3, 0), (1, 1)],
             [(2, 1), (0, 2)], [(3, 1), (1, 2)], [(2, 2), (0, 3)],
             [(3, 2), (1, 3)], [(2, 3)], [(3, 3)]]


def _z4(x4: int, y4: int) -> int:
    """z-scan index of 4x4 block (x4, y4) (6.4.3)."""
    return 8 * (y4 >> 1) + 4 * (x4 >> 1) + 2 * (y4 & 1) + (x4 & 1)


# integer operations per MB of csrc/intra_nxn.cu, the bound's count: per
# 4x4 block, nine modes of 16 predictions (~6 each), 16 differences, a
# 4x4 Hadamard (64) and 32 for the absolute sum (9 x 208), the transform,
# quant, dequant and inverse (~200); per 8x8 block nine modes of 64
# predictions, differences and four Hadamards (9 x 960), the filter (~80)
# and the 8x8 transforms, quant and dequant (~1500)
OPS_I4_MB = 16 * (9 * 208 + 200)
OPS_I8_MB = 4 * (9 * 960 + 80 + 1500)


def knight_lanes(d: int, mbw: int, mbh: int) -> tuple:
    """(jmin, count) of knight step d: its MBs are (d - 2y, y) for y in
    jmin .. jmin + count - 1."""
    jmin = max(0, (d - mbw + 2) // 2)
    return jmin, min(mbh - 1, d // 2) - jmin + 1


def rate_proxy(lv):
    """(M, ...) levels -> (M,) int32 rate proxy of the size arbitration
    (intra_device.py:350): per level 2 x its bit length (at most 14),
    plus 1 when nonzero."""
    a = lv.reshape(lv.shape[0], -1).to(_I32).abs()
    thr = 1 << torch.arange(14, dtype=_I32, device=lv.device)
    nbits = (a[..., None] >= thr).sum(-1, dtype=_I32)
    return (2 * nbits + (a > 0).to(_I32)).sum(-1, dtype=_I32)


def work(n_mb: int, t8_mode: bool) -> tuple:
    """(bytes, int32 operations) of the candidates of n_mb MBs: per MB the
    source MB and its edges read once, the trial recon, the 16 modes and
    the output row written once."""
    nbytes = n_mb * 4 * (256 + 41 + 8 + 256 + 16
                         + (OUT_WORDS if t8_mode else 291))
    return nbytes, n_mb * (OPS_I4_MB + (OPS_I8_MB if t8_mode else 0))


@functools.lru_cache(maxsize=None)
def _tables(device: str) -> torch.Tensor:
    """The kernel's constant block (layout in csrc/intra_nxn.cu): the 4x4
    and 8x8 quant and dequant tables by qp % 6, then both zigzags."""
    host = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in
                           (QUANT4_MF, DEQUANT4, QUANT8_MF, DEQUANT8,
                            ZIGZAG_4x4, ZIGZAG_8x8)])
    return torch.from_numpy(host).to(device)


def _lanes(d: int, mbw: int, mbh: int, device):
    jmin, count = knight_lanes(d, mbw, mbh)
    ys = torch.arange(jmin, jmin + count, device=device)
    return d - 2 * ys, ys


def nxn_candidates_plain(ry, grid, ysrc, qp, lam, d: int, mbw: int,
                         mbh: int, t8_mode: bool) -> dict:
    """The plain twin: the reference's block loops batched over the step's
    MBs (I4x4 in ``_SUBSTEPS`` order, then I8x8).  ry, ysrc (16mbh, 16mbw)
    int32, grid (4mbh, 4mbw) int32, qp (mbw*mbh,) int32, lam an int or a
    0-d int32 tensor."""
    dev = ry.device
    xs, ys = _lanes(d, mbw, mbh, dev)
    n = xs.shape[0]
    qp_l = qp[ys * mbw + xs]
    lam = torch.as_tensor(lam, dtype=_I32, device=dev)
    at, al = ys > 0, xs > 0
    valid = torch.ones_like(at)
    notlast = xs < mbw - 1
    y0, x0 = ys * 16, xs * 16
    w16 = 16 * mbw
    lanes = torch.arange(n, device=dev)
    r4, r16 = torch.arange(4, device=dev), torch.arange(16, device=dev)
    src = ysrc[(y0[:, None] + r16)[:, :, None], (x0[:, None] + r16)[:, None, :]]
    modes9 = torch.arange(9, device=dev)

    def row(y, x, s):
        return ry[y[:, None], x[:, None] + torch.arange(s, device=dev)]

    def col(y, x, s):
        return ry[y[:, None] + torch.arange(s, device=dev), x[:, None]]

    def choose(preds, av, srcb, pmode):
        """First minimum of SATD + lam * mode bits over the available
        modes -> (mode, cost, its prediction, its mode bits)."""
        mbits = torch.where(modes9[None] == pmode[:, None], 1, 4).to(_I32)
        c = torch.where(av, P.satd(srcb[:, None], preds) + lam * mbits, _BIG)
        m = torch.argmin(c, dim=1)
        return (m, c[lanes, m].to(_I32), preds[lanes, m], mbits[lanes, m])

    out = dict(modes4=torch.zeros((n, 16), dtype=_I32, device=dev),
               acs4=torch.zeros((n, 16, 16), dtype=_I32, device=dev),
               nnzs4=torch.zeros((n, 16), dtype=_I32, device=dev))
    cost4 = 24 * lam.expand(n)
    ssd4 = torch.zeros(n, dtype=_I32, device=dev)
    rb4 = torch.full((n,), 24, dtype=_I32, device=dev)
    for blocks in _SUBSTEPS:
        for (x4, y4) in blocks:
            r = 4 * y4 + x4
            by, bx = y0 + 4 * y4, x0 + 4 * x4
            a4 = valid if y4 > 0 else at
            l4 = valid if x4 > 0 else al
            tl4 = (valid if y4 > 0 and x4 > 0 else al if y4 > 0
                   else at if x4 > 0 else at & al)
            if y4 == 0:
                tr4 = at if x4 < 3 else at & notlast
            else:
                tr4 = valid if x4 < 3 and _z4(x4 + 1, y4 - 1) < _z4(x4, y4) \
                    else ~valid
            byt, bxl = (by - 1).clamp(min=0), (bx - 1).clamp(min=0)
            top8 = torch.cat([row(byt, bx, 4),
                              row(byt, (bx + 4).clamp(max=w16 - 4), 4)], 1)
            p4 = PR.predict_4x4_all(top8, col(by, bxl, 4), ry[byt, bxl], a4,
                                    l4, tr4)
            gy, gx = ys * 4 + y4, xs * 4 + x4
            lm = torch.where(gx > 0, grid[gy, (gx - 1).clamp(min=0)], -1)
            tm = torch.where(gy > 0, grid[(gy - 1).clamp(min=0), gx], -1)
            pmode = torch.where((lm < 0) | (tm < 0), 2, torch.minimum(lm, tm))
            src4 = src[:, 4 * y4:4 * y4 + 4, 4 * x4:4 * x4 + 4]
            m4, bc4, psel, mb4 = choose(p4, PR.i4x4_mode_avail(a4, l4, tl4),
                                        src4, pmode)
            lv = T.quant4x4(T.dct4x4(src4 - psel), qp_l, intra=True)
            rec4 = (psel + T.idct4x4(T.dequant4x4(lv, qp_l))).clamp(0, 255)
            sb = src4 - rec4
            ssd4 = ssd4 + (sb * sb).sum((1, 2), dtype=_I32)
            rb4 = rb4 + rate_proxy(lv) + mb4
            ry[(by[:, None] + r4)[:, :, None],
               (bx[:, None] + r4)[:, None, :]] = rec4
            grid[gy, gx] = m4.to(_I32)
            cost4 = cost4 + bc4
            out["modes4"][:, r] = m4.to(_I32)
            out["acs4"][:, r] = T.zigzag(lv)
            out["nnzs4"][:, r] = (lv != 0).sum((1, 2), dtype=_I32)
    out.update(cost4=cost4, ssd4=ssd4, rb4=rb4)
    for k in FIELDS[6:]:
        out[k] = None
    if not t8_mode:
        return out

    i8tile = torch.zeros((n, 16, 16), dtype=_I32, device=dev)
    modes8 = torch.zeros((n, 4), dtype=_I32, device=dev)
    lv64s = torch.zeros((n, 4, 64), dtype=_I32, device=dev)
    cost8 = 24 * lam.expand(n)
    ssd8 = torch.zeros(n, dtype=_I32, device=dev)
    rb8 = torch.full((n,), 24, dtype=_I32, device=dev)
    for b8 in range(4):
        x8, y8 = b8 & 1, b8 >> 1
        by, bx = y0 + 8 * y8, x0 + 8 * x8
        a_t, a_l, a_tl, a_tr = ((at, al, at & al, at),
                                (at, valid, at, at & notlast),
                                (valid, al, al, valid),
                                (valid, valid, valid, ~valid))[b8]
        if y8 == 0:
            byt = (by - 1).clamp(min=0)
            top16 = torch.cat([row(byt, bx, 8),
                               row(byt, (bx + 8).clamp(max=w16 - 8), 8)], 1)
            tl8 = ry[byt, (bx - 1).clamp(min=0)]
        elif x8 == 0:
            top16 = i8tile[:, 7, :]
            tl8 = ry[(by - 1).clamp(min=0), (x0 - 1).clamp(min=0)]
        else:
            top16 = i8tile[:, 7, 8:16].repeat(1, 2)
            tl8 = i8tile[:, 7, 7]
        left8 = col(by, (bx - 1).clamp(min=0), 8) if x8 == 0 \
            else i8tile[:, 8 * y8:8 * y8 + 8, 7]
        preds8 = PR.predict_8x8_all(top16, left8, tl8, a_t, a_l, a_tl, a_tr)
        gy8, gx8 = ys * 4 + 2 * y8, xs * 4 + 2 * x8
        left_g = torch.where(gx8 > 0, grid[gy8, (gx8 - 1).clamp(min=0)], -1)
        top_g = torch.where(gy8 > 0, grid[(gy8 - 1).clamp(min=0), gx8], -1)
        lm8, tm8 = ((left_g, top_g), (modes8[:, 0], top_g),
                    (left_g, modes8[:, 0]), (modes8[:, 2], modes8[:, 1]))[b8]
        pmode8 = torch.where((lm8 < 0) | (tm8 < 0), 2,
                             torch.minimum(lm8, tm8))
        src8 = src[:, 8 * y8:8 * y8 + 8, 8 * x8:8 * x8 + 8]
        m8, bc8, psel8, mb8 = choose(preds8,
                                     PR.i8x8_mode_avail(a_t, a_l, a_tl),
                                     src8, pmode8)
        lv8 = T.quant8x8(T.dct8x8(src8 - psel8), qp_l, intra=True)
        rec8 = (psel8 + T.idct8x8(T.dequant8x8(lv8, qp_l))).clamp(0, 255)
        sb8 = src8 - rec8
        ssd8 = ssd8 + (sb8 * sb8).sum((1, 2), dtype=_I32)
        rb8 = rb8 + rate_proxy(lv8) + mb8
        i8tile[:, 8 * y8:8 * y8 + 8, 8 * x8:8 * x8 + 8] = rec8
        lv64s[:, b8] = T.zigzag8(lv8)
        modes8[:, b8] = m8.to(_I32)
        cost8 = cost8 + bc8
    out.update(i8tile=i8tile, modes8=modes8, lv64s=lv64s, cost8t=cost8,
               ssd8=ssd8, rb8=rb8)
    return out


def nxn_candidates_(ry, grid, ysrc, qp, lam, d: int, mbw: int, mbh: int,
                    t8_mode: bool) -> dict:
    """Launch the kernel for knight step d on CUDA tensors (shapes as in
    ``nxn_candidates_plain``; lam a (1,) int32 tensor on the card)."""
    dev = ry.device
    for name, t, shape in (("ry", ry, (16 * mbh, 16 * mbw)),
                           ("ysrc", ysrc, (16 * mbh, 16 * mbw)),
                           ("grid", grid, (4 * mbh, 4 * mbw)),
                           ("qp", qp, (mbw * mbh,)), ("lam", lam, (1,))):
        if not torch.is_tensor(t) or t.device != dev or t.dtype != _I32 \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"intra_nxn: {name} must be a contiguous int32 "
                             f"tensor of shape {shape} on {dev}")
    if not 0 <= d < mbw + 2 * mbh - 2:
        raise ValueError(f"intra_nxn: step {d} outside the frame")
    jmin, count = knight_lanes(d, mbw, mbh)
    out = torch.empty((count, OUT_WORDS), dtype=_I32, device=dev)
    tab = _tables(str(dev))
    with torch.cuda.device(dev):
        err = library().intra_nxn_launch(
            ry.data_ptr(), grid.data_ptr(), ysrc.data_ptr(), qp.data_ptr(),
            lam.data_ptr(), tab.data_ptr(), out.data_ptr(), d, jmin, count,
            mbw, mbh, int(t8_mode),
            torch.cuda.current_stream(dev).cuda_stream)
    check(err, "intra_nxn")
    LAUNCHES["intra_nxn"] += 1
    res, o = {}, 0
    for name, shape in _ROW:
        w = int(np.prod(shape))
        res[name] = out[:, o:o + w].reshape(count, *shape)
        o += w
    if not t8_mode:
        for k in FIELDS[6:]:
            res[k] = None
    return res


def nxn_candidates(ry, grid, ysrc, qp, lam, d: int, mbw: int, mbh: int,
                   t8_mode: bool) -> dict:
    """The NxN candidates of knight step d: the kernel on CUDA tensors, the
    plain twin on CPU tensors."""
    if ry.device.type == "cpu":
        return nxn_candidates_plain(ry, grid, ysrc, qp, lam, d, mbw, mbh,
                                    t8_mode)
    if ry.device.type != "cuda":
        raise ValueError(f"nxn_candidates: no kernel for {ry.device}")
    return nxn_candidates_(ry, grid, ysrc, qp, lam, d, mbw, mbh, t8_mode)
