"""Integer 4x4 and 8x8 transforms, quantization and layout helpers (port
of x264_tpu/ops/device/transform.py; parity anchors: reference
common/dct.c, common/quant.c).  Batched over leading dims, int32
throughout.  QP is a Python int or an int tensor broadcast against the
blocks' leading dims, exactly as in the reference."""

from __future__ import annotations

import torch

from x264_tpu_torch.ops.pixel import hadamard4
from x264_tpu_torch.state import tables

_I32 = torch.int32


def _qp_tensor(qp, device):
    return torch.as_tensor(qp, dtype=_I32, device=device)


def _bcast(x):
    """Align a per-block scalar derived from qp against (..., 4, 4) data."""
    return x[..., None, None]


def _along(v, dim, rows):
    """Apply an integer butterfly ``rows(x0, x1, ...)`` along ``dim``."""
    return torch.stack(rows(*v.unbind(dim)), dim)


def _cf_rows(x0, x1, x2, x3):
    s03, d03 = x0 + x3, x0 - x3
    s12, d12 = x1 + x2, x1 - x2
    return [s03 + s12, 2 * d03 + d12, s03 - s12, d03 - 2 * d12]


def dct4x4(residual):
    """Forward 4x4 core transform Cf.X.Cf^T.  |res|<=255 -> |coef|<=9180."""
    x = residual.to(_I32)
    return _along(_along(x, -2, _cf_rows), -1, _cf_rows)


def idct4x4(d):
    """Normative inverse transform (8.5.12.2) incl. final (x+32)>>6."""
    d = d.to(_I32)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h = torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)
    return (h + 32) >> 6


def _dct8_rows(*d):
    """Standard High-profile forward 8-point transform of the eight
    slices ``d`` (bit-exact twin of the reference's ``_dct8_1d``)."""
    s07, s16, s25, s34 = d[0] + d[7], d[1] + d[6], d[2] + d[5], d[3] + d[4]
    a0, a1 = s07 + s34, s16 + s25
    a2, a3 = s07 - s34, s16 - s25
    d07, d16, d25, d34 = d[0] - d[7], d[1] - d[6], d[2] - d[5], d[3] - d[4]
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    return [a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
            a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7]


def _idct8_rows(*d):
    """Normative inverse 8-point transform (8.5.12.3) of the eight
    slices ``d``."""
    e0 = d[0] + d[4]
    e2 = d[0] - d[4]
    e4 = (d[2] >> 1) - d[6]
    e6 = d[2] + (d[6] >> 1)
    e1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    e3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    e5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    e7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    f0, f2, f4, f6 = e0 + e6, e2 + e4, e2 - e4, e0 - e6
    f1 = e1 + (e7 >> 2)
    f3 = e3 + (e5 >> 2)
    f5 = (e3 >> 2) - e5
    f7 = e7 - (e1 >> 2)
    return [f0 + f7, f2 + f5, f4 + f3, f6 + f1,
            f6 - f1, f4 - f3, f2 - f5, f0 - f7]


def dct8x8(residual):
    """Forward 8x8 transform on (..., 8, 8): vertical then horizontal
    (x264/JM ordering).  |res|<=255 -> |coef| <= 64*255 = 16320."""
    x = residual.to(_I32)
    return _along(_along(x, -2, _dct8_rows), -1, _dct8_rows)


def idct8x8(d):
    """Normative inverse 8x8 (8.5.12.3): horizontal, vertical, (+32)>>6."""
    x = d.to(_I32)
    return (_along(_along(x, -1, _idct8_rows), -2, _idct8_rows) + 32) >> 6


def hadamard4x4_fwd(dc):
    return (hadamard4(dc.to(_I32)) + 1) >> 1


def hadamard4x4_inv(c):
    return hadamard4(c.to(_I32))


def hadamard2x2(dc):
    x = dc.to(_I32)
    a, b = x[..., 0, :] + x[..., 1, :], x[..., 0, :] - x[..., 1, :]
    y = torch.stack([a, b], dim=-2)
    return torch.stack([y[..., 0] + y[..., 1], y[..., 0] - y[..., 1]],
                       dim=-1)


def _qparams(qp, intra: bool):
    qbits = 15 + torch.div(qp, 6, rounding_mode="floor")
    one = torch.ones_like(qbits)
    f = torch.div(one << qbits, 3 if intra else 6, rounding_mode="floor")
    return qbits, f


def _sign_apply(c, level):
    return torch.where(c < 0, -level, level)


def quant4x4(coefs, qp, intra: bool):
    """Deadzone quant; max |coef|*mf = 9180*13107 < 2^31."""
    qp = _qp_tensor(qp, coefs.device)
    qbits, f = _qparams(qp, intra)
    mf = tables(coefs.device).quant4_mf[qp % 6]
    c = coefs.to(_I32)
    level = (c.abs() * mf + _bcast(f)) >> _bcast(qbits)
    return _sign_apply(c, level)


def dequant4x4(levels, qp):
    qp = _qp_tensor(qp, levels.device)
    v = tables(levels.device).dequant4[qp % 6]
    return (levels.to(_I32) * v) << _bcast(
        torch.div(qp, 6, rounding_mode="floor"))


def quant8x8(coefs, qp, intra: bool):
    """Deadzone 8x8 quant (qbits = 16 + qp/6); max |coef|*mf =
    16320*20972 < 2^31."""
    qp = _qp_tensor(qp, coefs.device)
    qbits = 16 + torch.div(qp, 6, rounding_mode="floor")
    f = torch.div(torch.ones_like(qbits) << qbits, 3 if intra else 6,
                  rounding_mode="floor")
    mf = tables(coefs.device).quant8_mf[qp % 6]
    c = coefs.to(_I32)
    level = (c.abs() * mf + _bcast(f)) >> _bcast(qbits)
    return _sign_apply(c, level)


def dequant8x8(levels, qp):
    """Normative 8x8 dequant (8.5.13.1), both shift regimes selected
    elementwise (LevelScale8x8 = 16 * normAdjust, flat weightScale)."""
    qp = _qp_tensor(qp, levels.device)
    ls16 = tables(levels.device).dequant8[qp % 6] * 16
    lv = levels.to(_I32)
    q6 = _bcast(torch.div(qp, 6, rounding_mode="floor"))
    hi = (lv * ls16) << (q6 - 6).clamp(min=0)
    lo = (lv * ls16 + (torch.ones_like(q6) << (5 - q6).clamp(min=0))) \
        >> (6 - q6).clamp(min=0)
    return torch.where(q6 >= 6, hi, lo)


def _dc_quant(coefs, qp, intra: bool):
    """Shared DC quant of quant_dc4 / quant_dc2: qbits+1, deadzone 2f."""
    qp = _qp_tensor(qp, coefs.device)
    qbits, f = _qparams(qp, intra)
    mf = tables(coefs.device).quant4_mf[qp % 6, 0, 0]
    c = coefs.to(_I32)
    level = (c.abs() * _bcast(mf) + 2 * _bcast(f)) >> _bcast(qbits + 1)
    return _sign_apply(c, level)


def quant_dc4(coefs, qp, intra: bool = True):
    """Luma DC quant (pairs with hadamard4x4_fwd's >>1).
    |fdc| <= (255*16*16)>>1 = 32640; 32640*13107 < 2^31."""
    return _dc_quant(coefs, qp, intra)


def quant_dc2(coefs, qp, intra: bool):
    return _dc_quant(coefs, qp, intra)


def dequant_dc4(f_had, qp):
    """Normative luma-DC scaling (8.5.10); both qp-regime branches computed
    with clamped shifts and selected elementwise."""
    qp = _qp_tensor(qp, f_had.device)
    ls16 = _bcast(tables(f_had.device).dequant4[qp % 6, 0, 0] * 16)
    f_had = f_had.to(_I32)
    q6 = _bcast(torch.div(qp, 6, rounding_mode="floor"))
    hi = (f_had * ls16) << (q6 - 6).clamp(min=0)
    lo = (f_had * ls16 + (torch.ones_like(q6) << (5 - q6).clamp(min=0))) \
        >> (6 - q6).clamp(min=0)
    return torch.where(_bcast(qp) >= 36, hi, lo)


def dequant_dc2(f_had, qp):
    qp = _qp_tensor(qp, f_had.device)
    ls16 = _bcast(tables(f_had.device).dequant4[qp % 6, 0, 0] * 16)
    return ((f_had.to(_I32) * ls16)
            << _bcast(torch.div(qp, 6, rounding_mode="floor"))) >> 5


# -- layout helpers -----------------------------------------------------------

def zigzag(blocks4):
    """(..., 4, 4) -> (..., 16) in zigzag order."""
    flat = blocks4.reshape(*blocks4.shape[:-2], 16)
    return flat[..., tables(blocks4.device).zigzag4]


def unzigzag(scan):
    return scan[..., tables(scan.device).unzigzag4].reshape(
        *scan.shape[:-1], 4, 4)


def zigzag8(blocks8):
    """(..., 8, 8) -> (..., 64) in 8x8 zigzag order."""
    flat = blocks8.reshape(*blocks8.shape[:-2], 64)
    return flat[..., tables(blocks8.device).zigzag8]


def unzigzag8(scan):
    return scan[..., tables(scan.device).unzigzag8].reshape(
        *scan.shape[:-1], 8, 8)


def mb_luma_to_blocks(mb):
    """(..., 16, 16) -> (..., 16, 4, 4) raster 4x4 blocks."""
    sh = mb.shape[:-2]
    nd = len(sh)
    return (mb.reshape(*sh, 4, 4, 4, 4)
              .permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
              .reshape(*sh, 16, 4, 4))


def blocks_to_mb_luma(blocks):
    sh = blocks.shape[:-3]
    nd = len(sh)
    return (blocks.reshape(*sh, 4, 4, 4, 4)
                  .permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
                  .reshape(*sh, 16, 16))


def mb_luma_to_blocks8(mb):
    """(..., 16, 16) -> (..., 4, 8, 8) raster 8x8 quadrants."""
    sh = mb.shape[:-2]
    nd = len(sh)
    return (mb.reshape(*sh, 2, 8, 2, 8)
              .permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
              .reshape(*sh, 4, 8, 8))


def blocks8_to_mb_luma(blocks):
    sh = blocks.shape[:-3]
    nd = len(sh)
    return (blocks.reshape(*sh, 2, 2, 8, 8)
                  .permute(*range(nd), nd, nd + 2, nd + 1, nd + 3)
                  .reshape(*sh, 16, 16))


def plane_to_mbs(plane, mbh: int, mbw: int, s: int = 16):
    """(H, W) -> (mbh*mbw, s, s) raster MB order."""
    return (plane.reshape(mbh, s, mbw, s).permute(0, 2, 1, 3)
                 .reshape(mbh * mbw, s, s))


def mbs_to_plane(mbs, mbh: int, mbw: int, s: int = 16):
    return (mbs.reshape(mbh, mbw, s, s).permute(0, 2, 1, 3)
               .reshape(mbh * s, mbw * s))
