"""FrameSyntax: the device->host interface of the TPU-first design.

The device pipeline emits per-MB tensors (modes, mvs, cbp, zigzagged
coefficient levels, nnz); the host entropy layer serializes them.  This is
the structural replacement for x264's per-MB `h->mb.cache` handoff between
analysis and entropy (reference common/macroblock.c cache_load/save).

Copied from x264_tpu/models/syntax.py but for its import lines (the port's
host layer; tests/test_torch_host.py holds the copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# mb_class values
MB_I16, MB_I4, MB_P16, MB_PSKIP = 0, 1, 2, 3


@dataclass
class FrameSyntax:
    mb_width: int
    mb_height: int
    mb_class: np.ndarray          # (N,) int32
    qp: np.ndarray                # (N,) int32 per-MB luma QP
    # intra
    i16_mode: np.ndarray          # (N,) 0..3
    chroma_mode: np.ndarray       # (N,) 0..3
    i4_modes: np.ndarray | None = None   # (N,16) raster order, -1 if unused
    # inter
    mv: np.ndarray | None = None         # (N,2) chosen mv (qpel), [x, y]
    mvd: np.ndarray | None = None        # (N,2) mv - mvp (qpel)
    ref: np.ndarray | None = None        # (N,)
    # residual levels, zigzag order
    cbp_luma: np.ndarray = None          # (N,)
    cbp_chroma: np.ndarray = None        # (N,)
    luma_dc: np.ndarray = None           # (N,16) I16x16 DC, zigzag of DC grid
    luma_ac: np.ndarray = None           # (N,16,16) per 4x4 raster block
    chroma_dc: np.ndarray = None         # (N,2,4) raster 2x2 scan
    chroma_ac: np.ndarray = None         # (N,2,4,16) per 4x4 raster block
    # nnz for CAVLC context (raster block order within MB)
    luma_nnz: np.ndarray = None          # (N,16)
    chroma_nnz: np.ndarray = None        # (N,2,4)
    # device-computed CAVLC residual slot grids (ops/device/cavlc.py):
    # (N, 27*36) value/length pairs; None -> host computes them
    res_vals: np.ndarray | None = None
    res_lens: np.ndarray | None = None
    # per-MB prediction cost (SATD+lambda*mvbits) for rate control
    mb_cost: np.ndarray | None = None
    # per-MB source-edge intra cost estimate (scenecut)
    icost: np.ndarray | None = None

    @property
    def n_mbs(self) -> int:
        return self.mb_width * self.mb_height

    def luma_nnz_grid(self) -> np.ndarray:
        """(4*mb_h, 4*mb_w) global grid of per-4x4 total_coeff."""
        g = self.luma_nnz.reshape(self.mb_height, self.mb_width, 4, 4)
        return g.transpose(0, 2, 1, 3).reshape(4 * self.mb_height, 4 * self.mb_width)

    def chroma_nnz_grid(self, plane: int) -> np.ndarray:
        g = self.chroma_nnz[:, plane].reshape(self.mb_height, self.mb_width, 2, 2)
        return g.transpose(0, 2, 1, 3).reshape(2 * self.mb_height, 2 * self.mb_width)


def effective_qp(qp_mb: np.ndarray, mb_class: np.ndarray,
                 cbp_luma: np.ndarray, cbp_chroma: np.ndarray,
                 slice_qp: int) -> np.ndarray:
    """Decoder-visible per-MB QP_Y (7.4.5): mb_qp_delta is only present
    when the MB has coded residual, so QP carries over otherwise — the
    deblocking filter MUST use this chain, not the encoder's intent."""
    emits = (mb_class != MB_PSKIP) & (
        (cbp_luma != 0) | (cbp_chroma != 0) | (mb_class == MB_I16))
    idx = np.where(emits, np.arange(len(qp_mb)), -1)
    last = np.maximum.accumulate(idx)
    return np.where(last >= 0, qp_mb[np.maximum(last, 0)],
                    slice_qp).astype(qp_mb.dtype)


def empty_syntax(mb_width: int, mb_height: int) -> FrameSyntax:
    n = mb_width * mb_height
    return FrameSyntax(
        mb_width=mb_width,
        mb_height=mb_height,
        mb_class=np.zeros(n, np.int32),
        qp=np.zeros(n, np.int32),
        i16_mode=np.zeros(n, np.int32),
        chroma_mode=np.zeros(n, np.int32),
        i4_modes=np.full((n, 16), -1, np.int32),
        mv=np.zeros((n, 2), np.int32),
        mvd=np.zeros((n, 2), np.int32),
        ref=np.zeros(n, np.int32),
        cbp_luma=np.zeros(n, np.int32),
        cbp_chroma=np.zeros(n, np.int32),
        luma_dc=np.zeros((n, 16), np.int32),
        luma_ac=np.zeros((n, 16, 16), np.int32),
        chroma_dc=np.zeros((n, 2, 4), np.int32),
        chroma_ac=np.zeros((n, 2, 4, 16), np.int32),
        luma_nnz=np.zeros((n, 16), np.int32),
        chroma_nnz=np.zeros((n, 2, 4), np.int32),
    )
