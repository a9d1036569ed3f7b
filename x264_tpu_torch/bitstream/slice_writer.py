"""Slice-data serialization (CAVLC mode): turns a FrameSyntax into
slice_data() bits (spec 7.3.4/7.4.5; parity with reference encoder/cavlc.c
x264_macroblock_write_cavlc).

This is the scalar correctness-first implementation; the vectorized
whole-frame path (precomputing all VLC codes as arrays) replaces the inner
loops once conformance is locked.

Copied from x264_tpu/bitstream/slice_writer.py but for its import lines (the port's
host layer; tests/test_torch_host.py holds the copy).
"""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.bitstream.bits import BitWriter
from x264_tpu_torch.bitstream.cavlc import write_residual_block
from x264_tpu_torch.bitstream.tables import CBP_TO_GOLOMB
from x264_tpu_torch.models.syntax import MB_I4, MB_I16, MB_P16, MB_PSKIP, FrameSyntax

SLICE_P, SLICE_B, SLICE_I = 0, 1, 2

# coded (zigzag-of-quadrant) order of luma 4x4 blocks -> raster index
LUMA_CODED2RASTER = np.array([0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15])


def _nc(nnz_grid: np.ndarray, gy: int, gx: int) -> int:
    """CAVLC nC from neighbor total_coeffs (9.2.1): mean of available A/B."""
    a_avail = gx > 0
    b_avail = gy > 0
    if a_avail and b_avail:
        return (int(nnz_grid[gy, gx - 1]) + int(nnz_grid[gy - 1, gx]) + 1) >> 1
    if a_avail:
        return int(nnz_grid[gy, gx - 1])
    if b_avail:
        return int(nnz_grid[gy - 1, gx])
    return 0


def write_slice_data(bs: BitWriter, syn: FrameSyntax, slice_type: int) -> None:
    mbw, mbh = syn.mb_width, syn.mb_height
    nnz_y = syn.luma_nnz_grid()
    nnz_c = [syn.chroma_nnz_grid(0), syn.chroma_nnz_grid(1)]
    last_qp = int(syn.qp[0])  # slice_qp from header == qp of first MB by design

    skip_run = 0
    for mb in range(mbw * mbh):
        mby, mbx = divmod(mb, mbw)
        cls = int(syn.mb_class[mb])

        if cls == MB_PSKIP:
            skip_run += 1
            continue
        if slice_type == SLICE_P:
            bs.ue(skip_run)
            skip_run = 0

        intra = cls in (MB_I16, MB_I4)
        cbp_l = int(syn.cbp_luma[mb])
        cbp_c = int(syn.cbp_chroma[mb])

        # ---- mb_type ----
        if cls == MB_I4:
            mb_type = 0
        elif cls == MB_I16:
            mb_type = 1 + int(syn.i16_mode[mb]) + 4 * cbp_c + 12 * (cbp_l != 0)
        elif cls == MB_P16:
            mb_type = 0
        else:
            raise AssertionError(cls)
        if slice_type == SLICE_P and intra:
            mb_type += 5
        bs.ue(mb_type)

        # ---- prediction ----
        if cls == MB_I4:
            for k in range(16):
                r = int(LUMA_CODED2RASTER[k])
                mode = int(syn.i4_modes[mb, r])
                pred = _predicted_i4_mode(syn, mb, r, mbw, mbh)
                if mode == pred:
                    bs.put1(1)
                else:
                    bs.put1(0)
                    bs.put(3, mode if mode < pred else mode - 1)
        if intra:
            bs.ue(int(syn.chroma_mode[mb]))
        elif cls == MB_P16:
            # ref_idx_l0: coded as te() — only when >1 active refs (handled by
            # caller fixing num_ref=1 for now)
            bs.se(int(syn.mvd[mb, 0]))
            bs.se(int(syn.mvd[mb, 1]))

        # ---- cbp ----
        if cls != MB_I16:
            bs.ue(int(CBP_TO_GOLOMB[1 if intra else 0, (cbp_c << 4) | cbp_l]))

        # ---- mb_qp_delta ----
        if cbp_l or cbp_c or cls == MB_I16:
            qp = int(syn.qp[mb])
            delta = qp - last_qp
            if delta > 25:
                delta -= 52
            elif delta < -26:
                delta += 52
            bs.se(delta)
            last_qp = qp

        # ---- residuals ----
        gy0, gx0 = mby * 4, mbx * 4
        if cls == MB_I16:
            nc = _nc(nnz_y, gy0, gx0)
            write_residual_block(bs, syn.luma_dc[mb], nc, 16)
        if cbp_l:
            max_c = 15 if cls == MB_I16 else 16
            for k in range(16):
                r = int(LUMA_CODED2RASTER[k])
                if not (cbp_l & (1 << (k // 4))):
                    continue
                y4, x4 = divmod(r, 4)
                nc = _nc(nnz_y, gy0 + y4, gx0 + x4)
                coefs = syn.luma_ac[mb, r, 16 - max_c:]
                write_residual_block(bs, coefs, nc, max_c)
        if cbp_c:
            for pl in range(2):
                write_residual_block(bs, syn.chroma_dc[mb, pl], -1, 4)
        if cbp_c == 2:
            cy0, cx0 = mby * 2, mbx * 2
            for pl in range(2):
                for k in range(4):
                    y2, x2 = divmod(k, 2)
                    nc = _nc(nnz_c[pl], cy0 + y2, cx0 + x2)
                    write_residual_block(bs, syn.chroma_ac[mb, pl, k, 1:], nc, 15)

    if slice_type == SLICE_P and skip_run:
        bs.ue(skip_run)


def _predicted_i4_mode(syn: FrameSyntax, mb: int, r: int, mbw: int, mbh: int) -> int:
    """predIntra4x4PredMode (8.3.1.1): min(left, top) mode, 2 (DC) if a
    neighbor is unavailable or not 4x4-intra-coded."""
    mby, mbx = divmod(mb, mbw)
    y4, x4 = divmod(r, 4)
    gy, gx = mby * 4 + y4, mbx * 4 + x4

    def mode_at(gyy, gxx):
        if gyy < 0 or gxx < 0:
            return -1  # unavailable
        mbi = (gyy // 4) * mbw + (gxx // 4)
        cls = int(syn.mb_class[mbi])
        if cls == MB_I4:
            return int(syn.i4_modes[mbi, (gyy % 4) * 4 + (gxx % 4)])
        if cls == MB_I16:
            return 2  # non-4x4 intra MBs predict as DC
        return 2 if cls in (MB_P16, MB_PSKIP) else -1

    left = mode_at(gy, gx - 1)
    top = mode_at(gy - 1, gx)
    if left < 0 or top < 0:
        return 2
    return min(left, top)
