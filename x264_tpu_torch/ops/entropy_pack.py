"""Compact syntax blob for the host CABAC coder (port of
x264_tpu/ops/device/entropy_pack.py for I and single-reference P16
frames).  ``native/cabac.c`` reads the blob, so it must come out as the
same int32 words.

Layout (one flat int32 array): per MB a row of ``blob_stride()`` words —
the 408-bit significance bitmap in 13 words, the exclusive prefix of the
MB's nonzero count, then the fields mb_class, mvd_x, mvd_y, i16_mode,
chroma_mode, cbp_luma, cbp_chroma, qp, nnz_total, mb_cost, icost, ref,
t8 — followed by the frame-global stream of nonzero levels as int16
pairs (lo | hi << 16), n*K levels, zero-filled or cut at that cap."""

from __future__ import annotations

import numpy as np
import torch

from x264_tpu.bitstream import cabac_host

N_VALS = 408        # luma_dc 16 | luma_ac 16x16 | chroma_dc 2x4 | ac 2x4x16
N_BITMAP = 13
FIELDS_P = 13

_I32 = torch.int32


def blob_stride() -> int:
    return N_BITMAP + 1 + FIELDS_P


def _wrap_i32(x):
    """int64 values of 32-bit words -> int32 with two's-complement wrap
    (what JAX's int32 shifts produce)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(_I32)


def cabac_blob(luma_dc, luma_ac, chroma_dc, chroma_ac, mb_class, mvd,
               i16_mode, chroma_mode, cbp_luma, cbp_chroma, qp, mb_cost,
               icost, K: int):
    """All inputs per-MB int32 tensors; K even.  Returns the flat int32
    blob: n*stride row words + n*K/2 stream words."""
    n = mb_class.shape[0]
    dev = mb_class.device
    flat = torch.cat([luma_dc.reshape(n, 16), luma_ac.reshape(n, 256),
                      chroma_dc.reshape(n, 8), chroma_ac.reshape(n, 128)],
                     dim=1).to(_I32)                         # (N, 408)
    mask = flat != 0

    j = torch.arange(N_VALS, device=dev)
    bits = mask.to(torch.int64) << (j % 32)
    bits = torch.cat([bits, bits.new_zeros(n, 32 * N_BITMAP - N_VALS)], 1)
    # disjoint bit positions within a word: the sum is the or
    bitmap = _wrap_i32(bits.reshape(n, N_BITMAP, 32).sum(2))

    nnz_mb = mask.sum(1, dtype=_I32)
    prefix = torch.cumsum(nnz_mb, 0, dtype=_I32) - nnz_mb   # exclusive

    # frame-global stable compaction of the nonzeros into n*K slots;
    # zeros and overflow land in a dump slot past the end
    cap = n * K
    fmask = mask.reshape(-1)
    pos = torch.cumsum(fmask, 0) - 1
    keep = fmask & (pos < cap)
    pos = torch.where(keep, pos, cap)
    vals = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    vals.scatter_(0, pos, flat.reshape(-1).to(torch.int64) * keep)
    lv16 = vals[:cap] & 0xffff
    stream = _wrap_i32(lv16[0::2] | (lv16[1::2] << 16))      # (n*K/2,)

    zeros = torch.zeros(n, dtype=_I32, device=dev)
    fields = [prefix, mb_class, mvd[:, 0], mvd[:, 1], i16_mode,
              chroma_mode, cbp_luma, cbp_chroma, qp, nnz_mb, mb_cost,
              icost, zeros, zeros]             # ref 0, then t8 0 (last)
    rows = torch.cat([bitmap] + [f.to(_I32)[:, None] for f in fields],
                     dim=1)
    return torch.cat([rows.reshape(-1), stream])


def write_slice_cabac(blob: np.ndarray, mbw: int, mbh: int, slice_kind: int,
                      slice_qp: int, K: int):
    """CABAC-code one slice from the host copy of the blob with
    ``native/cabac.c`` (the reference's
    ``cabac_host.write_slice_cabac_packed`` for I/P16 slices, whose
    stride lookup imports a JAX module).  slice_kind 0 = I, 1 = P.
    Returns the slice_data() payload bytes."""
    n = mbw * mbh
    cap = 1024 + n * 512
    out = np.zeros(cap, np.uint8)
    blob = np.ascontiguousarray(blob.reshape(-1).astype(np.int32,
                                                        copy=False))
    sz = cabac_host._lib().encode_slice_cabac_packed(
        mbw, mbh, slice_kind, int(slice_qp), 0, blob, K, blob_stride(),
        0, 1, 0, 0, out, cap, None)
    if sz < 0:
        raise OverflowError("CABAC level cap or buffer overflow")
    return out[:sz].tobytes()
