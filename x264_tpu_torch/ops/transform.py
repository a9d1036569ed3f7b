"""Integer 4x4 transforms, quantization and layout helpers (port of the
4x4 half of x264_tpu/ops/device/transform.py; parity anchors: reference
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
    """Apply a 4-point integer butterfly ``rows(x0, x1, x2, x3)`` along
    ``dim``."""
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


def plane_to_mbs(plane, mbh: int, mbw: int, s: int = 16):
    """(H, W) -> (mbh*mbw, s, s) raster MB order."""
    return (plane.reshape(mbh, s, mbw, s).permute(0, 2, 1, 3)
                 .reshape(mbh * mbw, s, s))


def mbs_to_plane(mbs, mbh: int, mbw: int, s: int = 16):
    return (mbs.reshape(mbh, mbw, s, s).permute(0, 2, 1, 3)
               .reshape(mbh * s, mbw * s))
