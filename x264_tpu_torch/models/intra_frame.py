"""I-frame encoding: mode decision, transform/quant, reconstruction.

This module is the bit-exact NumPy pipeline (the "C reference" tier).  The
mode decision/transform math is written in batched style so the JAX
wavefront version (models/intra_jax.py) mirrors it 1:1; here the MB scan is
serial because intra prediction consumes reconstructed neighbors (the
wavefront batching is the TPU optimization, same dataflow).

Capability parity: encoder/analyse.c mb_analyse_intra (I16x16 + chroma +
I4x4), encoder/macroblock.c x264_mb_encode_i16x16 / i4x4.

Copied from x264_tpu/models/intra_frame.py but for its import lines: the
port's NumPy tier (``backend="reference"``); tests/test_torch_host.py
holds the copy.
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.tables import chroma_qp
from x264_tpu_torch.models.syntax import MB_I4, MB_I16, FrameSyntax, empty_syntax
from x264_tpu_torch.ops.reference import pixel, predict, quant, transform
from x264_tpu_torch.state import ZIGZAG_4x4

ZZ = ZIGZAG_4x4


def zigzag(blocks4: np.ndarray) -> np.ndarray:
    """(..., 4, 4) -> (..., 16) zigzag order."""
    return blocks4.reshape(*blocks4.shape[:-2], 16)[..., ZZ]


def unzigzag(scan: np.ndarray) -> np.ndarray:
    out = np.zeros_like(scan)
    out[..., ZZ] = scan
    return out.reshape(*scan.shape[:-1], 4, 4)


def encode_i16x16_mb(src: np.ndarray, pred: np.ndarray, qp: int):
    """Given chosen 16x16 prediction, run the I16x16 residual path.
    Returns (recon, dc_zz(16,), ac_zz(16,16) raster-block order,
    nnz(16,), cbp_luma)."""
    res = src.astype(np.int64) - pred.astype(np.int64)
    blocks = transform.mb_luma_to_blocks(res)          # (16,4,4) raster
    coefs = transform.dct4x4(blocks)

    # DC path
    dc = coefs[:, 0, 0].reshape(4, 4)
    fdc = transform.hadamard4x4_fwd(dc)
    dc_lv = quant.quant_dc4(fdc, qp, intra=True)
    dc_zz = zigzag(dc_lv)
    fi = transform.hadamard4x4_inv(dc_lv)
    dc_deq = quant.dequant_dc4(fi, qp).reshape(16)

    # AC path
    ac_lv = quant.quant4x4(coefs, qp, intra=True)
    ac_lv[:, 0, 0] = 0
    nnz = np.count_nonzero(ac_lv.reshape(16, 16), axis=1).astype(np.int32)
    cbp_luma = 15 if nnz.any() else 0
    if cbp_luma == 0:
        ac_lv[:] = 0
        nnz[:] = 0
    ac_zz = zigzag(ac_lv)

    # reconstruct
    deq = quant.dequant4x4(ac_lv, qp)
    deq[:, 0, 0] = dc_deq
    res_rec = transform.idct4x4(deq)
    recon = np.clip(pred.astype(np.int64) + transform.blocks_to_mb_luma(res_rec),
                    0, 255).astype(np.uint8)
    return recon, dc_zz.astype(np.int32), ac_zz.astype(np.int32), nnz, cbp_luma


def encode_chroma_mb(srcs, preds, qp_c: int, intra: bool):
    """srcs/preds: [(8,8) u, (8,8) v].  Returns (recons, dc(2,4), ac(2,4,16),
    nnz(2,4), cbp_chroma)."""
    dcs = np.zeros((2, 4), np.int64)
    acs = np.zeros((2, 4, 16), np.int64)
    deqs = []
    for pl in range(2):
        res = srcs[pl].astype(np.int64) - preds[pl].astype(np.int64)
        blocks = (res.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4))
        coefs = transform.dct4x4(blocks)
        dc = coefs[:, 0, 0].reshape(2, 2)
        fdc = transform.hadamard2x2(dc)
        dc_lv = quant.quant_dc2(fdc, qp_c, intra)
        dcs[pl] = dc_lv.reshape(4)           # raster scan of 2x2
        ac_lv = quant.quant4x4(coefs, qp_c, intra)
        ac_lv[:, 0, 0] = 0
        acs[pl] = zigzag(ac_lv)
        deqs.append((coefs, dc_lv, ac_lv))

    if not intra:
        # chroma AC decimation, threshold 7 (reference
        # encoder/macroblock.c:347-431): zero all chroma AC when the
        # total decimate_score15 over the 8 AC blocks is small
        from x264_tpu_torch.models.inter_frame import decimate_score_np
        sc = sum(decimate_score_np(acs[pl, k, 1:])
                 for pl in range(2) for k in range(4))
        if sc < 7:
            acs[:] = 0
            for pl in range(2):
                deqs[pl][2][:] = 0      # ac_lv
    any_ac = acs.any()
    any_dc = dcs.any()
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)

    recons = []
    nnz = np.zeros((2, 4), np.int32)
    for pl in range(2):
        coefs, dc_lv, ac_lv = deqs[pl]
        if cbp_chroma < 2:
            ac_lv = np.zeros_like(ac_lv)
            acs[pl] = 0
        if cbp_chroma == 0:
            dc_lv = np.zeros_like(dc_lv)
            dcs[pl] = 0
        nnz[pl] = np.count_nonzero(acs[pl], axis=1)
        fi = transform.hadamard2x2(dc_lv)
        dc_deq = quant.dequant_dc2(fi, qp_c).reshape(4)
        deq = quant.dequant4x4(ac_lv, qp_c)
        deq[:, 0, 0] = dc_deq
        res_rec = transform.idct4x4(deq)
        plane = (res_rec.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8))
        recons.append(np.clip(preds[pl].astype(np.int64) + plane, 0, 255).astype(np.uint8))
    return recons, dcs.astype(np.int32), acs.astype(np.int32), nnz, cbp_chroma


# z-scan index of each raster 4x4 block (y4*4+x4) — decode order within
# an MB (spec 6.4.3); top-right sample availability follows THIS order,
# not raster order (8.3.1.2.1)
_ZSCAN4 = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])


def _z_of(x4: int, y4: int) -> int:
    return 8 * (y4 >> 1) + 4 * (x4 >> 1) + 2 * (y4 & 1) + (x4 & 1)


def _tr_avail(x4: int, y4: int, mby: int, mbx: int, mbw: int) -> bool:
    """Top-right sample availability for 4x4 block (x4,y4) (8.3.1.2.1):
    the block holding p[4..7,-1] must be decoded EARLIER in z-scan."""
    if y4 == 0:
        if x4 < 3:
            return mby > 0
        return mby > 0 and mbx < mbw - 1
    if x4 == 3:
        return False
    return _z_of(x4 + 1, y4 - 1) < _z_of(x4, y4)


def encode_i4x4_mb(src: np.ndarray, ry: np.ndarray, mode_grid: np.ndarray,
                   y0: int, x0: int, mby: int, mbx: int, mbw: int,
                   qp: int, lam: int):
    """I4x4 candidate for one MB: sequential z-respecting block loop with
    recon feedback (reference encoder/analyse.c mb_analyse_intra's i4x4
    path + encoder/macroblock.c x264_mb_encode_i4x4).  WRITES the luma
    recon into ry[y0:y0+16, x0:x0+16] and the chosen modes into mode_grid
    (caller overwrites both if I16x16 wins the mb_type decision).
    Returns (modes(16,) raster, ac_zz(16,16), nnz(16,), cbp_luma, cost,
    ssd, rate): cost is the SATD+mode-bit accumulation (mb_cost
    bookkeeping), ssd/rate feed the round-5 true-cost I16-vs-NxN
    arbitration (recon SSD / rate proxy incl. the 24-bit header const
    and the te() mode bits)."""
    h_img, w_img = ry.shape
    modes = np.zeros(16, np.int32)
    ac_zz = np.zeros((16, 16), np.int32)
    nnz = np.zeros(16, np.int32)
    cost = 24 * lam          # x264's i4x4 header-overhead constant
    ssd_sum = 0
    rate_sum = 24
    for r in range(16):      # raster order satisfies left/top recon deps
        y4, x4 = divmod(r, 4)
        by, bx = y0 + 4 * y4, x0 + 4 * x4
        at = by > 0
        al = bx > 0
        atl = at and al
        atr = _tr_avail(x4, y4, mby, mbx, mbw)
        top8 = np.zeros((1, 8), np.uint8)
        if at:
            xe = min(bx + 8, w_img)
            top8[0, :xe - bx] = ry[by - 1, bx:xe]
        left = (ry[by:by + 4, bx - 1][None] if al
                else np.zeros((1, 4), np.uint8))
        tl = (ry[by - 1, bx - 1][None] if atl
              else np.zeros((1,), np.uint8))
        preds = predict.predict_4x4_all(
            top8, left, tl, np.array([at]), np.array([al]),
            np.array([atr]))[0]                          # (9,4,4)
        avail = predict.i4x4_mode_avail(
            np.array([at]), np.array([al]), np.array([atl]))[0]
        gy, gx = mby * 4 + y4, mbx * 4 + x4
        lm = mode_grid[gy, gx - 1] if gx > 0 else -1
        tm = mode_grid[gy - 1, gx] if gy > 0 else -1
        pmode = 2 if (lm < 0 or tm < 0) else min(int(lm), int(tm))
        sblk = src[4 * y4:4 * y4 + 4, 4 * x4:4 * x4 + 4]
        costs = pixel.satd4x4(np.broadcast_to(sblk, (9, 4, 4)), preds)
        mbits = np.where(np.arange(9) == pmode, 1, 4)
        costs = np.where(avail, costs + lam * mbits, 1 << 30)
        mode = int(np.argmin(costs))
        modes[r] = mode
        mode_grid[gy, gx] = mode
        cost += int(costs[mode])
        # residual: full 4x4 DCT/quant (all 16 coeffs; no DC split)
        res = sblk.astype(np.int64) - preds[mode].astype(np.int64)
        lv = quant.quant4x4(transform.dct4x4(res[None]), qp, intra=True)[0]
        nnz[r] = np.count_nonzero(lv)
        ac_zz[r] = zigzag(lv[None])[0]
        rec = transform.idct4x4(quant.dequant4x4(lv[None], qp))[0]
        rec4 = np.clip(preds[mode].astype(np.int64) + rec, 0, 255)
        ry[by:by + 4, bx:bx + 4] = rec4.astype(np.uint8)
        d = sblk.astype(np.int64) - rec4
        ssd_sum += int((d * d).sum())
        rate_sum += int(_rate_proxy(lv)) + int(mbits[mode])
    cbp_l = 0
    for q8 in range(4):
        qy, qx = divmod(q8, 2)
        blks = [(2 * qy + dy) * 4 + (2 * qx + dx)
                for dy in range(2) for dx in range(2)]
        if nnz[blks].any():
            cbp_l |= 1 << q8
    return modes, ac_zz, nnz, cbp_l, cost, ssd_sum, rate_sum


def _rate_proxy(lv) -> int:
    """Exp-golombish level-rate proxy: sum(2*bitlen(|l|)+1) over the
    nonzeros, bitlen capped at 14 — MUST match intra_device's
    _rate_proxy to the bit (tier parity)."""
    a = np.abs(np.asarray(lv).astype(np.int64)).reshape(-1)
    nb = np.zeros_like(a)
    for k in range(14):
        nb += (a >= (1 << k)).astype(np.int64)
    return int((2 * nb + (a > 0)).sum())


def encode_iframe(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                  qp, chroma_qp_offset: int = 0, i4x4: bool = False,
                  lam: int = 0):
    """Encode one I frame (planes already padded to MB multiples).
    qp: scalar or per-MB (N,) array.  Returns
    (recon_y, recon_u, recon_v, FrameSyntax)."""
    h, w = y.shape
    mbw, mbh = w // 16, h // 16
    syn = empty_syntax(mbw, mbh)
    qp_mb = np.broadcast_to(np.atleast_1d(qp).astype(np.int64),
                            (mbw * mbh,))
    syn.qp[:] = qp_mb
    syn.mb_cost = np.zeros(mbw * mbh, np.int64)

    ry = np.zeros_like(y)
    ru = np.zeros_like(u)
    rv = np.zeros_like(v)
    # per-4x4-block chosen-mode grid for predIntra4x4PredMode chaining:
    # -1 = unavailable, 2 = block of a non-I4x4 MB (predicts as DC)
    mode_grid = np.full((4 * mbh, 4 * mbw), -1, np.int32)

    for mb in range(mbw * mbh):
        mby, mbx = divmod(mb, mbw)
        y0, x0 = mby * 16, mbx * 16
        at = np.array([mby > 0])
        al = np.array([mbx > 0])

        # --- luma I16x16 ---
        top = ry[y0 - 1, x0:x0 + 16][None] if mby > 0 else np.zeros((1, 16), np.uint8)
        left = ry[y0:y0 + 16, x0 - 1][None] if mbx > 0 else np.zeros((1, 16), np.uint8)
        tl = (ry[y0 - 1, x0 - 1][None] if (mby > 0 and mbx > 0)
              else np.zeros((1,), np.uint8))
        preds = predict.predict_16x16_all(top, left, tl, at, al)[0]
        avail = predict.i16x16_mode_avail(at, al, at & al)[0]
        src = y[y0:y0 + 16, x0:x0 + 16]
        costs = pixel.satd(np.broadcast_to(src, (4, 16, 16)), preds)
        costs = np.where(avail, costs, 1 << 30)
        mode = int(np.argmin(costs))
        qp_i = int(qp_mb[mb])
        qpc = chroma_qp(qp_i, chroma_qp_offset)
        cost16 = int(costs[mode])

        # I16 candidate is always encoded (its recon SSD + rate feed
        # the round-5 true-cost arbitration, mirroring intra_device)
        recon, dc_zz, ac_zz, nnz, cbp_l = encode_i16x16_mb(
            src, preds[mode], qp_i)
        use_i4 = False
        if i4x4:
            lam2 = max(lam * lam * 9 // 10, 1)
            j16 = (int(((src.astype(np.int64) - recon) ** 2).sum())
                   + lam2 * (int(_rate_proxy(dc_zz))
                             + int(_rate_proxy(ac_zz)) + 8))
            (i4_modes, i4_ac, i4_nnz, i4_cbp, cost4, i4_ssd,
             i4_rate) = encode_i4x4_mb(
                src, ry, mode_grid, y0, x0, mby, mbx, mbw, qp_i, lam)
            j4 = i4_ssd + lam2 * i4_rate
            use_i4 = j4 < j16
        syn.mb_cost[mb] = cost4 if use_i4 else cost16
        if not use_i4:
            ry[y0:y0 + 16, x0:x0 + 16] = recon
            mode_grid[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2

        # --- chroma ---
        cy0, cx0 = mby * 8, mbx * 8
        ctop = [pl[cy0 - 1, cx0:cx0 + 8][None] if mby > 0 else np.zeros((1, 8), np.uint8)
                for pl in (ru, rv)]
        cleft = [pl[cy0:cy0 + 8, cx0 - 1][None] if mbx > 0 else np.zeros((1, 8), np.uint8)
                 for pl in (ru, rv)]
        ctl = [pl[cy0 - 1, cx0 - 1][None] if (mby > 0 and mbx > 0) else np.zeros((1,), np.uint8)
               for pl in (ru, rv)]
        cpreds = [predict.predict_chroma_all(ctop[i], cleft[i], ctl[i], at, al)[0]
                  for i in range(2)]
        cavail = predict.chroma_mode_avail(at, al, at & al)[0]
        csrc = [u[cy0:cy0 + 8, cx0:cx0 + 8], v[cy0:cy0 + 8, cx0:cx0 + 8]]
        ccosts = (pixel.satd(np.broadcast_to(csrc[0], (4, 8, 8)), cpreds[0])
                  + pixel.satd(np.broadcast_to(csrc[1], (4, 8, 8)), cpreds[1]))
        ccosts = np.where(cavail, ccosts, 1 << 30)
        cmode = int(np.argmin(ccosts))

        crecons, cdc, cac, cnnz, cbp_c = encode_chroma_mb(
            csrc, [cpreds[0][cmode], cpreds[1][cmode]], qpc, intra=True)
        ru[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[0]
        rv[cy0:cy0 + 8, cx0:cx0 + 8] = crecons[1]

        # --- record syntax ---
        if use_i4:
            syn.mb_class[mb] = MB_I4
            syn.i4_modes[mb] = i4_modes
            syn.cbp_luma[mb] = i4_cbp
            syn.luma_ac[mb] = i4_ac
            syn.luma_nnz[mb] = i4_nnz
        else:
            syn.mb_class[mb] = MB_I16
            syn.i16_mode[mb] = mode
            syn.cbp_luma[mb] = cbp_l
            syn.luma_dc[mb] = dc_zz
            syn.luma_ac[mb] = ac_zz
            syn.luma_nnz[mb] = nnz
        syn.chroma_mode[mb] = cmode
        syn.cbp_chroma[mb] = cbp_c
        syn.chroma_dc[mb] = cdc
        syn.chroma_ac[mb] = cac
        syn.chroma_nnz[mb] = cnnz

    return ry, ru, rv, syn
