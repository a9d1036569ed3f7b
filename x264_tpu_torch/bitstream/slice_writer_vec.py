"""Vectorized slice_data() serialization — the whole-frame counterpart of
slice_writer.py (same syntax, spec 7.3.4; parity: reference
encoder/cavlc.c x264_macroblock_write_cavlc).

Two sources for the residual (value, length) slot grids:
  - device: the JAX pipeline already emitted them (ops/device/cavlc.py,
    carried in FrameSyntax.res_vals/res_lens) — host work is just the
    7 header slots + concatenate + pack;
  - host fallback: computed here with cavlc_vec (NumPy), bit-identical.

Falls back to the scalar writer when features it doesn't cover yet appear
(I4x4 MBs).

Copied from x264_tpu/bitstream/slice_writer_vec.py but for its import lines (the port's
host layer; tests/test_torch_host.py holds the copy).
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.bits import BitWriter
from x264_tpu_torch.bitstream.cavlc_vec import (
    BLOCK_SLOTS,
    code_blocks,
    se_codes,
    ue_codes,
)
from x264_tpu_torch.bitstream.tables import CBP_TO_GOLOMB
from x264_tpu_torch.models.syntax import MB_I4, MB_I16, MB_P16, MB_PSKIP, FrameSyntax
from x264_tpu_torch.bitstream.slice_writer import (
    LUMA_CODED2RASTER,
    SLICE_I,
    SLICE_P,
    write_slice_data as write_slice_data_scalar,
)

_I64 = np.int64


def _nc_from_grid(grid: np.ndarray) -> np.ndarray:
    """Vectorized CAVLC nC (9.2.1): mean of available left/top neighbors."""
    gh, gw = grid.shape
    left = np.zeros_like(grid)
    left[:, 1:] = grid[:, :-1]
    top = np.zeros_like(grid)
    top[1:, :] = grid[:-1, :]
    has_l = np.zeros((gh, gw), bool)
    has_l[:, 1:] = True
    has_t = np.zeros((gh, gw), bool)
    has_t[1:, :] = True
    both = (left + top + 1) >> 1
    return np.where(has_l & has_t, both,
           np.where(has_l, left, np.where(has_t, top, 0))).astype(_I64)


def _mb_view(grid: np.ndarray, mbh: int, mbw: int, s: int) -> np.ndarray:
    return (grid.reshape(mbh, s, mbw, s).transpose(0, 2, 1, 3)
                .reshape(mbh * mbw, s * s))


def header_slots(syn: FrameSyntax, slice_type: int):
    """The 7 per-MB header codes: [skip_run, mb_type, chroma_mode, mvd_x,
    mvd_y, cbp, qp_delta].  Returns (hvals, hlens) (N,7) int64."""
    cls = syn.mb_class.astype(_I64)
    n = len(cls)
    skip = cls == MB_PSKIP
    coded = ~skip
    intra = cls == MB_I16
    p16 = cls == MB_P16
    cbp_l = syn.cbp_luma.astype(_I64)
    cbp_c = syn.cbp_chroma.astype(_I64)

    hvals = np.zeros((n, 7), _I64)
    hlens = np.zeros((n, 7), _I64)

    if slice_type == SLICE_P:
        coded_idx = np.nonzero(coded)[0]
        prev = np.concatenate(([-1], coded_idx[:-1]))
        v, ln = ue_codes(coded_idx - prev - 1)
        hvals[coded_idx, 0] = v
        hlens[coded_idx, 0] = ln

    mb_type = np.where(intra,
                       1 + syn.i16_mode.astype(_I64) + 4 * cbp_c
                       + 12 * (cbp_l != 0), 0)
    if slice_type == SLICE_P:
        mb_type = mb_type + 5 * intra
    v, ln = ue_codes(mb_type)
    hvals[:, 1] = v
    hlens[:, 1] = np.where(coded, ln, 0)

    v, ln = ue_codes(syn.chroma_mode.astype(_I64))
    hvals[:, 2] = np.where(intra, v, 0)
    hlens[:, 2] = np.where(intra, ln, 0)

    for c in range(2):
        v, ln = se_codes(syn.mvd[:, c].astype(_I64))
        hvals[:, 3 + c] = np.where(p16, v, 0)
        hlens[:, 3 + c] = np.where(p16, ln, 0)

    v, ln = ue_codes(CBP_TO_GOLOMB[0, ((cbp_c << 4) | cbp_l)].astype(_I64))
    hvals[:, 5] = np.where(p16, v, 0)
    hlens[:, 5] = np.where(p16, ln, 0)

    emits_qp = coded & ((cbp_l != 0) | (cbp_c != 0) | intra)
    qp = syn.qp.astype(_I64)
    em_idx = np.nonzero(emits_qp)[0]
    prev_qp = np.concatenate(([qp[0]], qp[em_idx][:-1]))
    delta = qp[em_idx] - prev_qp
    delta = np.where(delta > 25, delta - 52,
                     np.where(delta < -26, delta + 52, delta))
    v, ln = se_codes(delta)
    hvals[em_idx, 6] = v
    hlens[em_idx, 6] = ln
    return hvals, hlens


def residual_slots_np(syn: FrameSyntax):
    """NumPy fallback for the device residual slot grids
    (ops/device/cavlc.residual_slots): (N, 27*36) (vals, lens)."""
    cls = syn.mb_class.astype(_I64)
    mbw, mbh = syn.mb_width, syn.mb_height
    n = mbw * mbh
    coded = cls != MB_PSKIP
    intra = cls == MB_I16
    cbp_l = syn.cbp_luma.astype(_I64)
    cbp_c = syn.cbp_chroma.astype(_I64)

    nc_y_mb = _mb_view(_nc_from_grid(syn.luma_nnz_grid().astype(_I64)),
                       mbh, mbw, 4)

    dc_vals, dc_lens = code_blocks(syn.luma_dc.astype(_I64),
                                   np.full(n, 16, _I64), nc_y_mb[:, 0])
    dc_lens = np.where(intra[:, None], dc_lens, 0)

    c2r = LUMA_CODED2RASTER
    ac = syn.luma_ac.astype(_I64)[:, c2r, :]
    is_i16 = intra[:, None, None]
    luma_coefs = np.zeros((n, 16, 16), _I64)
    luma_coefs[:, :, :15] = np.where(is_i16, ac[:, :, 1:], ac[:, :, :15])
    luma_coefs[:, :, 15] = np.where(intra[:, None], 0, ac[:, :, 15])
    blen_l = np.broadcast_to(np.where(intra, 15, 16)[:, None], (n, 16))
    quad = np.arange(16) // 4
    blk_on = coded[:, None] & ((cbp_l[:, None] >> quad[None, :]) & 1).astype(bool)
    lv, ll = code_blocks(luma_coefs.reshape(n * 16, 16),
                         blen_l.reshape(n * 16), nc_y_mb[:, c2r].reshape(n * 16))
    ll = np.where(blk_on.reshape(n * 16)[:, None], ll, 0)

    cdc_coefs = np.zeros((n * 2, 16), _I64)
    cdc_coefs[:, :4] = syn.chroma_dc.astype(_I64).reshape(n * 2, 4)
    cdv, cdl = code_blocks(cdc_coefs, np.full(n * 2, 4, _I64),
                           np.full(n * 2, -1, _I64))
    cdl = np.where(np.repeat(coded & (cbp_c > 0), 2)[:, None], cdl, 0)

    nc_c_mb = np.stack(
        [_mb_view(_nc_from_grid(syn.chroma_nnz_grid(pl).astype(_I64)),
                  mbh, mbw, 2) for pl in range(2)], axis=1)     # (N,2,4)
    cac_coefs = np.zeros((n * 8, 16), _I64)
    cac_coefs[:, :15] = syn.chroma_ac.astype(_I64)[..., 1:].reshape(n * 8, 15)
    cav, cal = code_blocks(cac_coefs, np.full(n * 8, 15, _I64),
                           nc_c_mb.reshape(n * 8))
    cal = np.where(np.repeat(coded & (cbp_c == 2), 8)[:, None], cal, 0)

    vals = np.concatenate([
        dc_vals, lv.reshape(n, 16 * BLOCK_SLOTS),
        cdv.reshape(n, 2 * BLOCK_SLOTS), cav.reshape(n, 8 * BLOCK_SLOTS)],
        axis=1)
    lens = np.concatenate([
        dc_lens, ll.reshape(n, 16 * BLOCK_SLOTS),
        cdl.reshape(n, 2 * BLOCK_SLOTS), cal.reshape(n, 8 * BLOCK_SLOTS)],
        axis=1)
    return vals, lens


def write_slice_data_vec(bs: BitWriter, syn: FrameSyntax,
                         slice_type: int) -> None:
    cls = syn.mb_class.astype(_I64)
    if np.any(cls == MB_I4):
        write_slice_data_scalar(bs, syn, slice_type)
        return
    n = len(cls)
    coded = cls != MB_PSKIP

    hvals, hlens = header_slots(syn, slice_type)
    rv = getattr(syn, "res_vals", None)
    if rv is not None:
        rvals = np.asarray(syn.res_vals).astype(_I64)
        rlens = np.asarray(syn.res_lens).astype(_I64)
        # device grids don't know about skip (host decides it later); a
        # skip MB has cbp 0 + zero coefs so only its "coded_block_count 0"
        # coeff_tokens could differ — but those are gated by cbp already,
        # so lens are 0 for skip MBs by construction.
    else:
        rvals, rlens = residual_slots_np(syn)

    all_vals = np.concatenate([hvals, rvals], axis=1).reshape(-1)
    all_lens = np.concatenate([hlens, rlens], axis=1).reshape(-1)
    live = all_lens > 0
    bs.put_many(all_lens[live], all_vals[live])

    if slice_type == SLICE_P:
        trailing = int(n - 1 - (np.nonzero(coded)[0][-1] if coded.any() else -1))
        if trailing:
            bs.ue(trailing)
