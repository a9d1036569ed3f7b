"""Batched residual paths shared by the I, P and B cores (port of
x264_tpu/models/residual_device.py): transform, quantize (deadzone or
trellis) and reconstruct every MB at once, with the 4x4 or the 8x8
transform.

Parity anchors: reference encoder/macroblock.c x264_mb_encode_i16x16 and
the inter residual path of x264_macroblock_encode.  ``trellis`` is None
(deadzone quant) or (cost tables, lam2f) for RD-optimal levels from
``kernels/trellis.trellis_quant``."""

from __future__ import annotations

import torch

from x264_tpu_torch.kernels.trellis import trellis_quant
from x264_tpu_torch.ops import transform as T
from x264_tpu_torch.ops.trellis import dq1_4x4, dq1_8x8
from x264_tpu_torch.state import tables

_I32 = torch.int32


def decimate_score(zz, nc: int = 16):
    """Batched JVT-B118 decimation score (reference common/quant.c:326
    decimate_score_internal): zz (..., nc) zigzag levels -> (...,) int32;
    the 4x4 run table, or the 8x8 one for nc 64.  Any |level| > 1 scores
    9 (keep); each |level|==1 adds table[run], run = zero gap below it in
    scan order."""
    tbl = tables(zz.device).decimate8 if nc == 64 \
        else tables(zz.device).decimate4
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


def trellis_args(trellis_tbl):
    """The frame_trellis bundle -> (tr4, tr8, tr16, trc): the (tables,
    lam2f) pairs of the 4x4, 8x8, I16-AC and chroma-AC residuals, or
    Nones without trellis."""
    if trellis_tbl is None:
        return None, None, None, None
    tbl4, tbl8, lam2f, tbl16, tblc = trellis_tbl
    return ((tbl4, lam2f), None if tbl8 is None else (tbl8, lam2f),
            (tbl16, lam2f), (tblc, lam2f))


def _qp_blocks(qp, n: int, per_mb: int, device):
    """qp (int or per-MB (N,)) -> (N * per_mb,) int32, one per block."""
    return torch.as_tensor(qp, dtype=_I32, device=device).reshape(-1) \
        .expand(n).repeat_interleave(per_mb)


def _trellis_ac(czz, qpb, trellis):
    """Trellis levels of the AC positions 1..15 of (B, 16) zigzag scans,
    DC left 0 (the DC goes through the Hadamard path)."""
    tbl, lam2f = trellis
    lz = trellis_quant(czz[:, 1:], dq1_4x4(qpb)[:, 1:], lam2f, tbl, 15)
    return torch.cat([torch.zeros_like(lz[:, :1]), lz], dim=1)


def encode_i16_luma(src, pred, qp, trellis=None):
    """src/pred (N,16,16); qp int or per-MB (N,) ->
    (recon, dc_zz (N,16), ac_zz (N,16,16), nnz (N,16), cbp_luma (N,)).
    With trellis the AC levels (cat 1) are RD-optimal; the DC Hadamard
    path stays deadzone."""
    n = src.shape[0]
    res = src.to(_I32) - pred.to(_I32)
    coefs = T.dct4x4(T.mb_luma_to_blocks(res))          # (N,16,4,4)
    qp1 = _qp_mb(qp, 1)
    qp0 = _qp_mb(qp, 0)

    dc = coefs[:, :, 0, 0].reshape(-1, 4, 4)
    dc_lv = T.quant_dc4(T.hadamard4x4_fwd(dc), qp0, intra=True)
    dc_zz = T.zigzag(dc_lv)
    dc_deq = T.dequant_dc4(T.hadamard4x4_inv(dc_lv), qp0).reshape(-1, 16)

    if trellis is not None:
        czz = T.zigzag(coefs).reshape(n * 16, 16)
        zz = _trellis_ac(czz, _qp_blocks(qp, n, 16, src.device), trellis)
        ac_lv = T.unzigzag(zz.reshape(n, 16, 16))
    else:
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


def encode_p_luma(src, pred, qp, trellis=None, decimate: bool = True):
    """Inter luma residual: (N,16,16) -> (recon, ac_zz, nnz, cbp_luma) with
    per-8x8-quadrant cbp bits; trellis: RD-optimal levels (cat 2).
    decimate: JVT-B118 coefficient decimation (reference
    encoder/macroblock.c:900-918), after trellis: per 8x8 quadrant, zero
    it when its score < 4; zero the whole MB when the total score < 6."""
    n = src.shape[0]
    res = src.to(_I32) - pred.to(_I32)
    coefs = T.dct4x4(T.mb_luma_to_blocks(res))
    qp1 = _qp_mb(qp, 1)
    if trellis is not None:
        tbl4, lam2f = trellis
        qpb = _qp_blocks(qp, n, 16, src.device)
        czz = T.zigzag(coefs).reshape(n * 16, 16)
        lzz = trellis_quant(czz, dq1_4x4(qpb), lam2f, tbl4, 16)
        lv = T.unzigzag(lzz.reshape(n, 16, 16))
    else:
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


# raster 4x4 index -> coded (zigzag-of-quadrant) index: the inverse of
# the coded -> raster permutation _C2R (x264_tpu/ops/device/cavlc.py)
_C2R = [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15]
_R2C = sorted(range(16), key=_C2R.__getitem__)


def encode_p_luma_t8(src, pred, qp, trellis=None, decimate: bool = True):
    """Inter luma residual with the High-profile 8x8 transform
    (transform_size_8x8_flag=1; parity anchor: reference common/dct.c
    sub8x8_dct8 + encoder/macroblock.c's 8x8 branch); trellis: RD-optimal
    levels (cat 5).

    Returns (recon (N,16,16), ac_zz (N,16,16), nnz (N,16), nnz_deblock
    (N,16), cbp_luma (N,)).  ac_zz/nnz use the CAVLC interleave (8.5.6 run
    inverse): coded 4x4 block i4 of quadrant q8 holds zigzag-64 positions
    4*k+i4, laid out raster-block-major like the 4x4 path.  nnz_deblock
    replicates each 8x8 block's coded state to its 4 cells (8.7's bS
    nonzero check is per containing transform block)."""
    n = src.shape[0]
    res = src.to(_I32) - pred.to(_I32)
    coefs = T.dct8x8(T.mb_luma_to_blocks8(res))               # (N,4,8,8)
    qp1 = _qp_mb(qp, 1)
    if trellis is not None:
        tbl8, lam2f = trellis
        qpb = _qp_blocks(qp, n, 4, src.device)
        czz = T.zigzag8(coefs).reshape(n * 4, 64)
        lv64 = trellis_quant(czz, dq1_8x8(qpb), lam2f, tbl8, 64) \
            .reshape(n, 4, 64)
        lv8 = T.unzigzag8(lv64)
    else:
        lv8 = T.quant8x8(coefs, qp1, intra=False)
        lv64 = T.zigzag8(lv8)                                # (N,4,64)

    # JVT-B118 decimation on the 8x8 quadrants (reference
    # encoder/macroblock.c:821-836); x264 skips it under trellis+CABAC
    # ("8x8 trellis is inherently optimal decimation"), as here
    if decimate and trellis is None:
        sc8 = decimate_score(lv64, 64)                       # (N,4)
        keep8 = (sc8 >= 4) & (sc8.sum(dim=1, keepdim=True) >= 6)
        lv64 = lv64 * keep8[:, :, None].to(lv64.dtype)
        lv8 = lv8 * keep8[:, :, None, None].to(lv8.dtype)

    # CAVLC interleave: (N,4,64) -> (N, q8, k, i4) -> coded (N,16,16)
    inter = lv64.reshape(n, 4, 16, 4).permute(0, 1, 3, 2)   # (N,q8,i4,16)
    ac_zz = inter.reshape(n, 16, 16)[:, _R2C, :]
    nnz = _count_nonzero(ac_zz, 2)

    nz8 = _count_nonzero(lv64, 2)                            # (N,4)
    bits = 1 << torch.arange(4, dtype=_I32, device=src.device)
    cbp = ((nz8 > 0).to(_I32) * bits[None, :]).sum(1, dtype=_I32)
    # quadrant of each raster 4x4 cell: replicate the 8x8 count
    nnz_deblock = nz8.reshape(n, 2, 1, 2, 1).expand(n, 2, 2, 2, 2) \
        .reshape(n, 16)

    res_rec = T.idct8x8(T.dequant8x8(lv8, qp1))
    recon = (pred.to(_I32) + T.blocks8_to_mb_luma(res_rec)).clamp(0, 255)
    return recon, ac_zz, nnz, nnz_deblock, cbp


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
                  decimate: bool = True, trellis=None):
    """(N,8,8) x4 -> (recon_u, recon_v, dc (N,2,4), ac (N,2,4,16),
    nnz (N,2,4), cbp_chroma (N,)).  Joint U+V cbp per MB (normative).
    With trellis the AC levels (cat 4) are RD-optimal; the DC Hadamard
    path stays deadzone."""
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

    if trellis is not None:
        czz = T.zigzag(coefs).reshape(n * 8, 16)
        zz = _trellis_ac(czz, _qp_blocks(qp_c, n, 8, src_u.device), trellis)
        ac_lv = T.unzigzag(zz.reshape(n, 2, 4, 16))
    else:
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
