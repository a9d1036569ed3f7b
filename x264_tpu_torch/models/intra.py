"""I-frame cores: the I16x16 wavefront with the CABAC blob or the CAVLC
packed words (port of x264_tpu/models/intra_device.py::i_frame_core) and
the I16x16 / I4x4 / I8x8 wavefront with the CABAC blob
(``i4_frame_core``), with trellis on the I16 AC and chroma AC levels
when asked.

Intra prediction reads reconstructed neighbours.  With I16x16 only, MBs
on anti-diagonal d = mbx + mby depend only on earlier diagonals; I4x4
also reads the above-right MB's bottom row, so its wavefront runs in
knight order d = mbx + 2*mby.  The reference scans the steps with
``lax.scan``; here a Python loop walks them and encodes each step's MBs
as one batch (on the card ``models/graph.py`` replays the loop as one
CUDA graph)."""

from __future__ import annotations

import numpy as np
import torch

from x264_tpu_torch.kernels.intra_nxn import (knight_lanes, nxn_candidates,
                                              rate_proxy)
from x264_tpu_torch.models.graph import run_core
from x264_tpu_torch.models.residual import (encode_chroma, encode_i16_luma,
                                            trellis_args)
from x264_tpu_torch.models.syntax import MB_I4, MB_I16, empty_syntax
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops.cavlc import cavlc_blob, residual_slots
from x264_tpu_torch.ops.entropy_pack import cabac_blob
from x264_tpu_torch.ops.header import MB_I16_D, header_slots
from x264_tpu_torch.state import tables

_I32 = torch.int32
_BIG = 1 << 30


def qp_per_mb(qp, n: int, device):
    """A scalar or per-MB QP as an (n,) int32 tensor.  A scalar is filled
    on the device: a tensor made from host data is a copy from pageable
    memory, which holds the host until the device's stream has drained."""
    if not torch.is_tensor(qp) and np.ndim(qp) == 0:
        return torch.full((n,), int(qp), dtype=_I32, device=device)
    return torch.as_tensor(qp, dtype=_I32, device=device).reshape(-1) \
        .expand(n).contiguous()


def pick_mode(src, preds, avail):
    """SATD mode decision: (mode (M,), cost (M,), pred (M,s,s)); the
    first cheapest available mode wins, as with ``jnp.argmin``."""
    costs = torch.where(avail, P.satd(src[:, None], preds), _BIG)
    mode = torch.argmin(costs, dim=1)
    cost = costs.gather(1, mode[:, None])[:, 0]
    pred = preds[torch.arange(preds.shape[0], device=preds.device), mode]
    return mode.to(_I32), cost.to(_I32), pred


def _edges(plane, y0, x0, s):
    """(top (M,s), left (M,s), topleft (M,)) at clamped coordinates;
    unavailable edges hold garbage that the availability masks exclude,
    as in the reference."""
    ytop = (y0 - 1).clamp(min=0)
    xleft = (x0 - 1).clamp(min=0)
    rs = torch.arange(s, device=plane.device)
    top = plane[ytop[:, None], x0[:, None] + rs]
    left = plane[y0[:, None] + rs, xleft[:, None]]
    return top, left, plane[ytop, xleft]


def _block_index(y0, x0, s):
    rs = torch.arange(s, device=y0.device)
    return (y0[:, None] + rs)[:, :, None], (x0[:, None] + rs)[:, None, :]


def _blocks(plane, y0, x0, s):
    return plane[_block_index(y0, x0, s)]


def _chroma(ru, rv, usrc, vsrc, ys, xs, qpc_l, trc):
    """Chroma of one wavefront step: mode decision, residual, and the
    recon written into ru/rv in place.  Returns (mode, dc, ac, nnz,
    cbp)."""
    at, al = ys > 0, xs > 0
    cy0, cx0 = ys * 8, xs * 8
    ctop_u, cleft_u, ctl_u = _edges(ru, cy0, cx0, 8)
    ctop_v, cleft_v, ctl_v = _edges(rv, cy0, cx0, 8)
    csrc_u = _blocks(usrc, cy0, cx0, 8)
    csrc_v = _blocks(vsrc, cy0, cx0, 8)
    cpreds_u = PR.predict_chroma_all(ctop_u, cleft_u, ctl_u, at, al)
    cpreds_v = PR.predict_chroma_all(ctop_v, cleft_v, ctl_v, at, al)
    ccosts = torch.where(PR.chroma_mode_avail(at, al, at & al),
                         P.satd(csrc_u[:, None], cpreds_u)
                         + P.satd(csrc_v[:, None], cpreds_v), _BIG)
    cmode = torch.argmin(ccosts, dim=1)
    lanes = torch.arange(xs.shape[0], device=xs.device)
    cr_u, cr_v, cdc, cac, cnnz, cbp_c = encode_chroma(
        csrc_u, csrc_v, cpreds_u[lanes, cmode], cpreds_v[lanes, cmode],
        qpc_l, intra=True, trellis=trc)
    idx = _block_index(cy0, cx0, 8)
    ru[idx] = cr_u
    rv[idx] = cr_v
    return cmode.to(_I32), cdc, cac, cnnz, cbp_c


def i_frame_core(y, u, v, qp, mbw: int, mbh: int, cqp_off: int,
                 lv_cap: int = 0, trellis_tbl=None, n_words: int = 0,
                 res_slots: bool = False):
    """All-device I-frame pipeline.  y/u/v uint8 planes (16mbh x 16mbw);
    qp int or per-MB (N,); trellis_tbl: the ``ops/trellis.frame_trellis``
    bundle (I16 AC, cat 1, and chroma AC, cat 4: x264's trellis=1 intra
    scope) or None.  The entropy budget: ``n_words`` > 0 codes CAVLC
    into that many words per MB (``host_blob`` = words, nbits, mb_class,
    mb_cost), else ``lv_cap`` > 0 sizes the CABAC blob, else (the
    host-syntax path) there is no blob, and with ``res_slots`` the CAVLC
    residual slot grids ``res_vals`` and ``res_lens`` come back instead.
    Returns the per-MB syntax tensors (raster MB order), the pre-deblock
    recon planes and ``host_blob``."""
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    ysrc, usrc, vsrc = y.to(_I32), u.to(_I32), v.to(_I32)
    _, _, tr16, trc = trellis_args(trellis_tbl)

    acc = dict(
        i16_mode=torch.zeros(n, dtype=_I32, device=dev),
        chroma_mode=torch.zeros(n, dtype=_I32, device=dev),
        cbp_luma=torch.zeros(n, dtype=_I32, device=dev),
        cbp_chroma=torch.zeros(n, dtype=_I32, device=dev),
        luma_dc=torch.zeros((n, 16), dtype=_I32, device=dev),
        luma_ac=torch.zeros((n, 16, 16), dtype=_I32, device=dev),
        luma_nnz=torch.zeros((n, 16), dtype=_I32, device=dev),
        chroma_dc=torch.zeros((n, 2, 4), dtype=_I32, device=dev),
        chroma_ac=torch.zeros((n, 2, 4, 16), dtype=_I32, device=dev),
        chroma_nnz=torch.zeros((n, 2, 4), dtype=_I32, device=dev),
        mb_cost=torch.zeros(n, dtype=_I32, device=dev),
    )
    ry = torch.zeros_like(ysrc)
    ru = torch.zeros_like(usrc)
    rv = torch.zeros_like(vsrc)

    for d in range(mbw + mbh - 1):
        xs = torch.arange(max(0, d - (mbh - 1)), min(d, mbw - 1) + 1,
                          device=dev)
        ys = d - xs
        at, al = ys > 0, xs > 0
        atl = at & al
        mb = ys * mbw + xs

        y0, x0 = ys * 16, xs * 16
        top, left, tl = _edges(ry, y0, x0, 16)
        src = _blocks(ysrc, y0, x0, 16)
        mode, mode_cost, pred = pick_mode(
            src, PR.predict_16x16_all(top, left, tl, at, al),
            PR.i16x16_mode_avail(at, al, atl))
        recon, dc_zz, ac_zz, nnz, cbp_l = encode_i16_luma(src, pred, qp[mb],
                                                          trellis=tr16)
        cmode, cdc, cac, cnnz, cbp_c = _chroma(ru, rv, usrc, vsrc, ys, xs,
                                               qpc[mb], trc)
        ry[_block_index(y0, x0, 16)] = recon

        for key, val in (("i16_mode", mode), ("chroma_mode", cmode),
                         ("cbp_luma", cbp_l), ("cbp_chroma", cbp_c),
                         ("luma_dc", dc_zz), ("luma_ac", ac_zz),
                         ("luma_nnz", nnz), ("chroma_dc", cdc),
                         ("chroma_ac", cac), ("chroma_nnz", cnnz),
                         ("mb_cost", mode_cost)):
            acc[key][mb] = val.to(_I32)

    out = dict(acc)
    mb_class = torch.full((n,), MB_I16_D, dtype=_I32, device=dev)
    out["mb_class"] = mb_class
    zeros2 = torch.zeros((n, 2), dtype=_I32, device=dev)
    if n_words or res_slots:
        res_vals, res_lens = residual_slots(
            acc["luma_dc"], acc["luma_ac"], acc["luma_nnz"],
            acc["chroma_dc"], acc["chroma_ac"], acc["chroma_nnz"],
            acc["cbp_luma"], acc["cbp_chroma"],
            torch.ones(n, dtype=torch.bool, device=dev), mbw, mbh)
    if n_words:
        # CAVLC: the whole slice body coded and packed per MB on the device
        hv, hl = header_slots(mb_class, acc["i16_mode"], acc["chroma_mode"],
                              zeros2, acc["cbp_luma"], acc["cbp_chroma"], qp,
                              is_p_slice=False)
        out["host_blob"] = cavlc_blob(hv, hl, res_vals, res_lens, n_words,
                                      (mb_class, acc["mb_cost"]))
    elif res_slots:
        out["res_vals"], out["res_lens"] = res_vals, res_lens
    elif lv_cap:
        out["host_blob"] = cabac_blob(
            acc["luma_dc"], acc["luma_ac"], acc["chroma_dc"],
            acc["chroma_ac"], mb_class, zeros2, acc["i16_mode"],
            acc["chroma_mode"], acc["cbp_luma"], acc["cbp_chroma"], qp,
            acc["mb_cost"], torch.zeros(n, dtype=_I32, device=dev),
            K=lv_cap)
    out["recon_y"] = ry.to(torch.uint8)
    out["recon_u"] = ru.to(torch.uint8)
    out["recon_v"] = rv.to(torch.uint8)
    out["qp_mb"] = qp
    return out


def i4_frame_core(y, u, v, qp, lam, mbw: int, mbh: int, cqp_off: int,
                  lv_cap: int, t8_mode: bool = False, trellis_tbl=None):
    """The I-frame pipeline with the per-MB I16x16 / I4x4 / I8x8 choice
    (port of x264_tpu/models/intra_device.py::i4_frame_core, CABAC
    branch).  y/u/v uint8 planes (16mbh x 16mbw); qp int or per-MB (N,);
    lam the SATD-domain lambda, an int or a 0-d int32 tensor (on the card
    the graph's input buffer); t8_mode: the I8x8 candidate; trellis_tbl
    as for ``i_frame_core`` (I16 AC and chroma AC only); ``lv_cap`` 0
    (the host-syntax path): no blob.

    Each of the mbw + 2*mbh - 2 knight steps runs the I16 candidate, the
    NxN candidates (``kernels/intra_nxn.nxn_candidates``: one kernel
    launch on the card), the true-cost arbitration J = SSD + lam2 * rate
    proxy, the winner's recon and modes into the recon plane and mode
    grid, and the chroma.  The per-MB syntax of every step is scattered
    into raster order once, after the loop.  Returns the per-MB syntax
    tensors, the pre-deblock recon planes and ``host_blob``."""
    n = mbw * mbh
    dev = y.device
    qp = qp_per_mb(qp, n, dev)
    qpc = tables(dev).chroma_qp[(qp + cqp_off).clamp(0, 51).long()]
    lam = torch.as_tensor(lam, dtype=_I32, device=dev).reshape(1)
    lam2 = (lam * lam * 9 // 10).clamp(min=1)
    ysrc, usrc, vsrc = y.to(_I32), u.to(_I32), v.to(_I32)
    _, _, tr16, trc = trellis_args(trellis_tbl)
    ry = torch.zeros_like(ysrc)
    ru = torch.zeros_like(usrc)
    rv = torch.zeros_like(vsrc)
    # per-4x4-block chosen modes (the predIntra4x4PredMode chain): -1
    # outside the frame, 2 for the blocks of I16x16 MBs
    grid = torch.full((4 * mbh, 4 * mbw), -1, dtype=_I32, device=dev)
    r4 = torch.arange(4, device=dev)

    steps = []
    for d in range(mbw + 2 * mbh - 2):
        jmin, count = knight_lanes(d, mbw, mbh)
        if not count:
            continue            # one MB wide: odd steps hold no MB
        ys = torch.arange(jmin, jmin + count, device=dev)
        xs = d - 2 * ys
        at, al = ys > 0, xs > 0
        mb = ys * mbw + xs
        y0, x0 = ys * 16, xs * 16
        top, left, tl = _edges(ry, y0, x0, 16)
        src = _blocks(ysrc, y0, x0, 16)
        mode16, cost16, pred16 = pick_mode(
            src, PR.predict_16x16_all(top, left, tl, at, al),
            PR.i16x16_mode_avail(at, al, at & al))
        rec16, dc_zz, ac16, nnz16, cbp16 = encode_i16_luma(
            src, pred16, qp[mb], trellis=tr16)
        j16 = P.ssd(src, rec16) + lam2 * (rate_proxy(dc_zz)
                                          + rate_proxy(ac16) + 8)

        c = nxn_candidates(ry, grid, ysrc, qp, lam, d, mbw, mbh, t8_mode)
        j4 = c["ssd4"] + lam2 * c["rb4"]
        sel4 = j4 < j16
        idx = _block_index(y0, x0, 16)
        mbrec = torch.where(sel4[:, None, None], ry[idx], rec16)
        cells = torch.where(sel4[:, None], c["modes4"], 2)
        if t8_mode:
            j8 = c["ssd8"] + lam2 * c["rb8"]
            sel8 = j8 < torch.minimum(j4, j16)
            sel4 = sel4 & ~sel8
            mbrec = torch.where(sel8[:, None, None], c["i8tile"], mbrec)
            # 8.3.2.1: an I8x8 block's mode stands for its four 4x4 cells
            cells8 = c["modes8"].reshape(count, 2, 1, 2, 1) \
                .expand(count, 2, 2, 2, 2).reshape(count, 16)
            cells = torch.where(sel8[:, None], cells8, cells)
        # the I4x4 trial stays where I4x4 won; I16x16 and I8x8 winners
        # overwrite it and its modes
        ry[idx] = mbrec
        grid[(4 * ys[:, None, None] + r4[:, None]),
             (4 * xs[:, None, None] + r4)] = cells.reshape(count, 4, 4)

        cmode, cdc, cac, cnnz, cbp_c = _chroma(ru, rv, usrc, vsrc, ys, xs,
                                               qpc[mb], trc)
        steps.append(dict(
            mb=mb, mode16=mode16, cost16=cost16, dc16=dc_zz, ac16=ac16,
            nnz16=nnz16, cbp16=cbp16, sel4=sel4, modes4=c["modes4"],
            acs4=c["acs4"], nnzs4=c["nnzs4"], cost4=c["cost4"],
            chroma_mode=cmode, chroma_dc=cdc, chroma_ac=cac,
            chroma_nnz=cnnz, cbp_chroma=cbp_c,
            **({} if not t8_mode else dict(
                sel8=sel8, modes8=c["modes8"], lv64s=c["lv64s"],
                cost8=c["cost8t"]))))

    # every step's fields in knight order, then one scatter per field
    s = {k: torch.cat([st[k] for st in steps]) for k in steps[0]}
    bits4 = 1 << torch.arange(4, dtype=_I32, device=dev)
    quad_nz = (s["nnzs4"].reshape(n, 2, 2, 2, 2) > 0).any(4).any(2)
    modes_n = s["modes4"]
    ac_n, nnz_n, cost_n = s["acs4"], s["nnzs4"], s["cost4"]
    cbp_n = (quad_nz.reshape(n, 4).to(_I32) * bits4).sum(1, dtype=_I32)
    sel8 = torch.zeros_like(s["sel4"])
    if t8_mode:
        sel8 = s["sel8"]
        lv64s = s["lv64s"]
        # the CAVLC-interleave cell layout of encode_p_luma_t8: cell i4 of
        # quadrant q8 holds zigzag-64 positions 4*k + i4, cells in raster
        # order (residual._R2C as a permutation of axes)
        cells = lv64s.reshape(n, 2, 2, 16, 4).transpose(3, 4) \
            .reshape(n, 2, 2, 2, 2, 16).permute(0, 1, 3, 2, 4, 5) \
            .reshape(n, 16, 16)
        cbp8 = (((lv64s != 0).any(2)).to(_I32) * bits4).sum(1, dtype=_I32)
        modes8 = torch.cat([s["modes8"], torch.zeros_like(s["modes4"][:, 4:])],
                           1)
        modes_n = torch.where(sel8[:, None], modes8, modes_n)
        ac_n = torch.where(sel8[:, None, None], cells, ac_n)
        nnz_n = torch.where(sel8[:, None], (cells != 0).sum(2, dtype=_I32),
                            nnz_n)
        cbp_n = torch.where(sel8, cbp8, cbp_n)
        cost_n = torch.where(sel8, s["cost8"], cost_n)
    nxn = s["sel4"] | sel8
    fields = dict(
        mb_class=nxn.to(_I32),
        i16_mode=torch.where(nxn, 0, s["mode16"]),
        i4_modes=torch.where(nxn[:, None], modes_n, -1),
        chroma_mode=s["chroma_mode"],
        cbp_luma=torch.where(nxn, cbp_n, s["cbp16"]),
        cbp_chroma=s["cbp_chroma"],
        luma_dc=torch.where(nxn[:, None], 0, s["dc16"]),
        luma_ac=torch.where(nxn[:, None, None], ac_n, s["ac16"]),
        luma_nnz=torch.where(nxn[:, None], nnz_n, s["nnz16"]),
        chroma_dc=s["chroma_dc"], chroma_ac=s["chroma_ac"],
        chroma_nnz=s["chroma_nnz"],
        mb_cost=torch.where(nxn, cost_n, s["cost16"]),
        t8=sel8)
    out = {}
    for k, val in fields.items():
        t = torch.empty((n, *val.shape[1:]), dtype=val.dtype, device=dev)
        t[s["mb"]] = val
        out[k] = t.to(_I32) if k != "t8" else t
    if lv_cap:
        out["host_blob"] = cabac_blob(
            out["luma_dc"], out["luma_ac"], out["chroma_dc"],
            out["chroma_ac"], out["mb_class"],
            torch.zeros((n, 2), dtype=_I32, device=dev),
            out["i16_mode"], out["chroma_mode"], out["cbp_luma"],
            out["cbp_chroma"], qp, out["mb_cost"],
            torch.zeros(n, dtype=_I32, device=dev), K=lv_cap,
            t8=out["t8"] if t8_mode else None, i4_modes=out["i4_modes"])
    out["recon_y"] = ry.to(torch.uint8)
    out["recon_u"] = ru.to(torch.uint8)
    out["recon_v"] = rv.to(torch.uint8)
    out["qp_mb"] = qp
    return out


# the fields of a core's output that a host-syntax writer or the deblock
# reads (the reference's encode_iframe_device copies these)
_I_SYNTAX = ("i16_mode", "chroma_mode", "cbp_luma", "cbp_chroma", "luma_dc",
             "luma_ac", "luma_nnz", "chroma_dc", "chroma_ac", "chroma_nnz")


def encode_iframe_device(y, u, v, qp, chroma_qp_offset: int = 0,
                         i4x4: bool = False, lam: int = 0,
                         cavlc: bool = False):
    """The host-syntax path's I frame (the counterpart of
    x264_tpu/models/intra_device.py ``encode_iframe_device``): with
    ``i4x4`` the I16x16 / I4x4 choice (``i4_frame_core`` at lambda
    ``lam``, no trellis, no 8x8 transform), else the I16 core, with the
    CAVLC residual slot grids under CAVLC (``cavlc``; the
    ``cavlc_blocks`` kernel); no blob either way.  On the card the core
    is a CUDA graph replay (``models/graph.run_core``), its key its own.
    y/u/v uint8 planes on the device; qp scalar or per-MB array.
    Returns the pre-deblock recon planes on the device and the
    ``FrameSyntax`` on the host."""
    h, w = y.shape
    mbw, mbh = w // 16, h // 16
    qp_t = torch.as_tensor(np.asarray(qp, np.int32), device=y.device)
    kw = dict(mbw=mbw, mbh=mbh, cqp_off=chroma_qp_offset)
    if i4x4:
        core, args = i4_frame_core, (y, u, v, qp_t, int(lam))
        kw["lv_cap"] = 0
        keys = _I_SYNTAX + ("mb_class", "i4_modes")
    else:
        core, args = i_frame_core, (y, u, v, qp_t)
        kw["res_slots"] = cavlc
        keys = _I_SYNTAX + (("res_vals", "res_lens") if cavlc else ())
    out = run_core(core, *args, **kw) if y.device.type == "cuda" \
        else core(*args, **kw)
    o = {k: out[k].cpu().numpy() for k in keys + ("mb_cost", "qp_mb")}

    syn = empty_syntax(mbw, mbh)
    if i4x4:
        syn.mb_class[:] = np.where(o["mb_class"] == 1, MB_I4, MB_I16)
        syn.i4_modes[:] = o["i4_modes"]
    else:
        syn.mb_class[:] = MB_I16
        if cavlc:
            syn.res_vals = o["res_vals"]
            syn.res_lens = o["res_lens"]
    for k in _I_SYNTAX:
        getattr(syn, k)[:] = o[k]
    syn.mb_cost = o["mb_cost"].astype(np.int64)
    syn.qp[:] = o["qp_mb"]
    return out["recon_y"], out["recon_u"], out["recon_v"], syn
