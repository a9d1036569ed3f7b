"""Batched residual paths shared by the I and P cores (port of
x264_tpu/models/residual_device.py without trellis and without the 8x8
transform): transform, quantize and reconstruct every MB at once.

Parity anchors: reference encoder/macroblock.c x264_mb_encode_i16x16 and
the inter residual path of x264_macroblock_encode."""

from __future__ import annotations

import torch

from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.state import tables

_I32 = torch.int32


def decimate_score(zz):
    """Batched JVT-B118 decimation score of 4x4 scans (reference
    common/quant.c:326 decimate_score_internal): zz (..., nc) zigzag
    levels -> (...,) int32.  Any |level| > 1 scores 9 (keep); each
    |level|==1 adds table[run], run = zero gap below it in scan order."""
    tbl = tables(zz.device).decimate4
    a = zz.to(_I32).abs()
    nz = a > 0
    big = (a > 1).any(dim=-1)
    j = torch.arange(zz.shape[-1], dtype=_I32, device=zz.device)
    idxs = torch.where(nz, j, torch.full_like(a, -1))
    prev = torch.cummax(idxs, dim=-1).values
    prev = torch.cat([torch.full_like(prev[..., :1], -1), prev[..., :-1]],
                     dim=-1)
    run = (j - prev - 1).clamp(0, tbl.shape[0] - 1)
    sc = torch.where(nz, tbl[run], 0).sum(dim=-1, dtype=_I32)
    return torch.where(big, 9, sc)


def quadrant_sums(x):
    """(N,16) per raster 4x4 block -> (N,4) per 8x8 quadrant (2*qy+qx)."""
    n = x.shape[0]
    return x.reshape(n, 2, 2, 2, 2).sum((2, 4), dtype=_I32).reshape(n, 4)


def _qp_mb(qp, extra_dims: int):
    """Normalize qp (int or per-MB (N,) tensor) for per-block broadcast
    with ``extra_dims`` block axes between the MB axis and the (4,4)
    tail."""
    if not torch.is_tensor(qp) or qp.dim() == 0:
        return qp
    return qp.reshape(qp.shape[0], *([1] * extra_dims))


def _count_nonzero(x, dim):
    return (x != 0).sum(dim, dtype=_I32)


def encode_i16_luma(src, pred, qp):
    """src/pred (N,16,16); qp int or per-MB (N,) ->
    (recon, dc_zz (N,16), ac_zz (N,16,16), nnz (N,16), cbp_luma (N,))."""
    res = src.to(_I32) - pred.to(_I32)
    coefs = T.dct4x4(T.mb_luma_to_blocks(res))          # (N,16,4,4)
    qp1 = _qp_mb(qp, 1)
    qp0 = _qp_mb(qp, 0)

    dc = coefs[:, :, 0, 0].reshape(-1, 4, 4)
    dc_lv = T.quant_dc4(T.hadamard4x4_fwd(dc), qp0, intra=True)
    dc_zz = T.zigzag(dc_lv)
    dc_deq = T.dequant_dc4(T.hadamard4x4_inv(dc_lv), qp0).reshape(-1, 16)

    ac_lv = T.quant4x4(coefs, qp1, intra=True)
    ac_lv[:, :, 0, 0] = 0
    nnz = _count_nonzero(ac_lv.reshape(-1, 16, 16), 2)
    cbp_luma = torch.where(nnz.any(dim=1), 15, 0).to(_I32)
    ac_zz = T.zigzag(ac_lv)

    deq = T.dequant4x4(ac_lv, qp1)
    deq[:, :, 0, 0] = dc_deq
    res_rec = T.idct4x4(deq)
    recon = (pred.to(_I32) + T.blocks_to_mb_luma(res_rec)).clamp(0, 255)
    return recon, dc_zz, ac_zz, nnz, cbp_luma


def encode_p_luma(src, pred, qp, decimate: bool = True):
    """Inter luma residual: (N,16,16) -> (recon, ac_zz, nnz, cbp_luma) with
    per-8x8-quadrant cbp bits.  decimate: JVT-B118 coefficient decimation
    (reference encoder/macroblock.c:900-918): per 8x8 quadrant, zero it
    when its score < 4; zero the whole MB when the total score < 6."""
    res = src.to(_I32) - pred.to(_I32)
    coefs = T.dct4x4(T.mb_luma_to_blocks(res))
    qp1 = _qp_mb(qp, 1)
    lv = T.quant4x4(coefs, qp1, intra=False)
    if decimate:
        sc8 = quadrant_sums(decimate_score(T.zigzag(lv)))     # (N,4)
        keep8 = (sc8 >= 4) & (sc8.sum(dim=1, keepdim=True) >= 6)
        keep = keep8.reshape(-1, 2, 1, 2, 1).expand(-1, 2, 2, 2, 2) \
            .reshape(-1, 16)                                  # (N,16)
        lv = lv * keep[:, :, None, None].to(lv.dtype)
    nnz = _count_nonzero(lv.reshape(-1, 16, 16), 2)
    quad_counts = quadrant_sums((nnz > 0).to(_I32))           # (N,4)
    bits = 1 << torch.arange(4, dtype=_I32, device=src.device)
    cbp = ((quad_counts > 0).to(_I32) * bits[None, :]).sum(1, dtype=_I32)
    ac_zz = T.zigzag(lv)
    res_rec = T.idct4x4(T.dequant4x4(lv, qp1))
    recon = (pred.to(_I32) + T.blocks_to_mb_luma(res_rec)).clamp(0, 255)
    return recon, ac_zz, nnz, cbp


def _chroma_blocks(res):
    """(N,8,8) -> (N,4,4,4) raster 4x4 blocks."""
    n = res.shape[0]
    return res.reshape(n, 2, 4, 2, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 4, 4, 4)


def _chroma_plane(blocks):
    n = blocks.shape[0]
    return blocks.reshape(n, 2, 2, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        n, 8, 8)


def encode_chroma(src_u, src_v, pred_u, pred_v, qp_c, intra: bool,
                  decimate: bool = True):
    """(N,8,8) x4 -> (recon_u, recon_v, dc (N,2,4), ac (N,2,4,16),
    nnz (N,2,4), cbp_chroma (N,)).  Joint U+V cbp per MB (normative)."""
    n = src_u.shape[0]
    srcs = torch.stack([src_u, src_v], dim=1).to(_I32)        # (N,2,8,8)
    preds = torch.stack([pred_u, pred_v], dim=1).to(_I32)
    blocks = _chroma_blocks((srcs - preds).reshape(n * 2, 8, 8)) \
        .reshape(n, 2, 4, 4, 4)
    coefs = T.dct4x4(blocks)
    qp2 = _qp_mb(qp_c, 2)
    qp1 = _qp_mb(qp_c, 1)

    dc = coefs[:, :, :, 0, 0].reshape(n, 2, 2, 2)
    dc_lv = T.quant_dc2(T.hadamard2x2(dc), qp1, intra)
    dcs = dc_lv.reshape(n, 2, 4)

    ac_lv = T.quant4x4(coefs, qp2, intra)
    ac_lv[:, :, :, 0, 0] = 0
    acs = T.zigzag(ac_lv)                                     # (N,2,4,16)
    if not intra and decimate:
        # chroma AC decimation (reference encoder/macroblock.c:347-431):
        # total score of the 8 AC blocks < 7 zeroes all chroma AC
        sc = decimate_score(acs[..., 1:]).sum(dim=(1, 2), dtype=_I32)
        keep = (sc >= 7)[:, None, None, None]
        acs = acs * keep.to(acs.dtype)
        ac_lv = ac_lv * keep[..., None].to(ac_lv.dtype)
    nnz = _count_nonzero(acs, 3)

    any_ac = (acs != 0).any(dim=3).any(dim=2).any(dim=1)
    any_dc = (dcs != 0).any(dim=2).any(dim=1)
    cbp_chroma = torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(_I32)

    dc_deq = T.dequant_dc2(T.hadamard2x2(dc_lv), qp1).reshape(n, 2, 4)
    deq = T.dequant4x4(ac_lv, qp2)
    deq[:, :, :, 0, 0] = dc_deq
    res_rec = T.idct4x4(deq)
    planes = _chroma_plane(res_rec.reshape(n * 2, 4, 4, 4)).reshape(
        n, 2, 8, 8)
    recons = (preds + planes).clamp(0, 255)
    return recons[:, 0], recons[:, 1], dcs, acs, nnz, cbp_chroma
