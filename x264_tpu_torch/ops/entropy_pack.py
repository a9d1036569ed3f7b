"""Compact syntax blob for the host CABAC coder (port of
x264_tpu/ops/device/entropy_pack.py for I frames, I16x16 or I_NxN,
P frames on one or more references, with or without P partitions, and B
frames),
and the host coder itself:
the C source ``native/cabac.c`` (a copy of x264_tpu/native/cabac.c),
built with gcc at first use and called through ctypes, from the blob
(``write_slice_cabac``) or, on the host-syntax path, from a
``FrameSyntax`` (``write_slice_cabac_syn``).  The coder reads
the blob, so it must come out as the same int32 words as the
reference's.

Layout (one flat int32 array): per MB a row of ``blob_stride(b, parts)``
words — the 408-bit significance bitmap in 13 words, the exclusive
prefix of the MB's nonzero count, then the fields mb_class, mvd_x,
mvd_y, i16_mode, chroma_mode, cbp_luma, cbp_chroma, qp, nnz_total,
mb_cost, icost, in B slices bmode, mvd1_x, mvd1_y, then ref, t8,
with partitions shape, the mvds of partition slots 1-3 (x, y) and
their refs, and with I_NxN the 16 prediction modes as nibbles in two
words — followed by the frame-global stream of nonzero levels as
int16 pairs (lo | hi << 16), n*K levels, zero-filled or cut at that
cap."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np
import torch

N_VALS = 408        # luma_dc 16 | luma_ac 16x16 | chroma_dc 2x4 | ac 2x4x16
N_BITMAP = 13
FIELDS_P = 13
FIELDS_B = 16       # FIELDS_P + bmode, mvd1_x, mvd1_y
FIELDS_PARTS = 10   # shape, mvd slots 1-3 (x, y), ref slots 1-3
FIELDS_I4 = 2       # I_NxN pred modes, raster blocks 0-7 and 8-15

_I32 = torch.int32

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(_PKG, "native")
BUILD = os.path.join(_PKG, "build")
_LIB = None


def _lib() -> ctypes.CDLL:
    """The host CABAC coder, built from ``native/cabac.c`` on first use
    into ``build/`` (the library's name carries a hash of the sources, so
    an edited source is rebuilt); an flock keeps parallel processes from
    racing the build."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = os.path.join(NATIVE, "cabac.c")
    digest = hashlib.sha256()
    for name in ("cabac.c", "cabac_tables.h"):
        with open(os.path.join(NATIVE, name), "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, f"libx264tpu_cabac_{digest.hexdigest()[:16]}.so")
    with open(os.path.join(BUILD, "cabac.lock"), "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = so + ".tmp"
            subprocess.run(["gcc", "-O2", "-shared", "-fPIC", src, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    # the FrameSyntax entry (the host-syntax path, ``write_slice_cabac_syn``)
    lib.encode_slice_cabac.restype = ctypes.c_long
    lib.encode_slice_cabac.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p,
        i16p, i16p, i16p, i16p,
        i32p, i32p, ctypes.c_void_p,   # t8: NULL = 8x8 mode off
        ctypes.c_void_p,               # i4m: NULL = no I4x4 MBs
        ctypes.c_void_p, ctypes.c_int,  # ref (NULL=single), num_ref
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        # shape/mvdp/refp: NULL = 16x16-only frame
        u8p, ctypes.c_long,
        ctypes.c_void_p,                # state_out (1024) or NULL
    ]
    lib.encode_slice_cabac_packed.restype = ctypes.c_long
    lib.encode_slice_cabac_packed.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        i32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,                   # parts (P partition fields)
        ctypes.c_int,                   # i4 (I_NxN pred-mode fields)
        u8p, ctypes.c_long,
        ctypes.c_void_p,                # state_out (1024) or NULL
    ]
    _LIB = lib
    return lib


def blob_stride(b: bool = False, parts: bool = False,
                i4: bool = False) -> int:
    return N_BITMAP + 1 + (FIELDS_B if b else FIELDS_P) \
        + (FIELDS_PARTS if parts else 0) + (FIELDS_I4 if i4 else 0)


def _wrap_i32(x):
    """int64 values of 32-bit words -> int32 with two's-complement wrap
    (what JAX's int32 shifts produce)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(_I32)


def cabac_blob(luma_dc, luma_ac, chroma_dc, chroma_ac, mb_class, mvd,
               i16_mode, chroma_mode, cbp_luma, cbp_chroma, qp, mb_cost,
               icost, K: int, bmode=None, mvd1=None, t8=None, ref=None,
               shape=None, mvd_part=None, ref_part=None, i4_modes=None):
    """All inputs per-MB int32 tensors; K even.  In a B slice, bmode (N,)
    and mvd1 (N,2) (list 1's mvd) add the three B fields; ref (N,) is
    the list0 ref_idx (zeros when None) and t8 (N,) the transform flag
    (zeros when None).  With partitions, shape (N,),
    mvd_part (N,4,2) and ref_part (N,4) add the 10 partition fields;
    i4_modes (N,16) adds the two I_NxN mode words (4-bit nibbles, raster
    blocks; -1, the value of non-I_NxN MBs, packs as 0).  Returns the flat int32 blob: n*stride row words + n*K/2 stream
    words."""
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
              icost]
    if bmode is not None:
        fields += [bmode, mvd1[:, 0], mvd1[:, 1]]
    # list 0 ref_idx, then transform_size_8x8_flag always last
    fields += [zeros if ref is None else ref, zeros if t8 is None else t8]
    if shape is not None:
        # P partitions: shape code, mvd of partition slots 1-3 (slot 0
        # travels in the base mvd fields), refs of slots 1-3
        fields += [shape,
                   mvd_part[:, 1, 0], mvd_part[:, 1, 1],
                   mvd_part[:, 2, 0], mvd_part[:, 2, 1],
                   mvd_part[:, 3, 0], mvd_part[:, 3, 1],
                   ref_part[:, 1], ref_part[:, 2], ref_part[:, 3]]
    if i4_modes is not None:
        # mode 8 in the top nibble passes bit 31: the words wrap as the
        # reference's int32 sums do
        nib = i4_modes.to(torch.int64).clamp(0, 15)
        sh4 = 4 * torch.arange(8, device=dev)
        fields += [_wrap_i32((nib[:, :8] << sh4).sum(1)),
                   _wrap_i32((nib[:, 8:] << sh4).sum(1))]
    rows = torch.cat([bitmap] + [f.to(_I32)[:, None] for f in fields],
                     dim=1)
    return torch.cat([rows.reshape(-1), stream])


def write_slice_cabac(blob: np.ndarray, mbw: int, mbh: int, slice_kind: int,
                      slice_qp: int, K: int, parts: bool = False,
                      t8_mode: bool = False, i4: bool = False,
                      num_ref: int = 1):
    """CABAC-code one slice from the host copy of the blob with
    ``native/cabac.c`` (the reference's
    ``cabac_host.write_slice_cabac_packed``).  slice_kind 0 = I, 1 = P,
    2 = B (the blob then carries the B fields); parts: the blob carries
    the partition fields (P slices with p8x8); i4: the blob carries the
    I_NxN mode words (I slices with i4x4); t8_mode: the PPS
    transform_8x8_mode_flag (codes each MB's transform_size_8x8_flag and
    its 8x8 blocks); num_ref: the active list0 size of a P slice (above
    1 the coder writes each MB's ref_idx_l0, te() over that size).
    Returns the slice_data() payload bytes."""
    n = mbw * mbh
    cap = 1024 + n * 512
    out = np.zeros(cap, np.uint8)
    blob = np.ascontiguousarray(blob.reshape(-1).astype(np.int32,
                                                        copy=False))
    sz = _lib().encode_slice_cabac_packed(
        mbw, mbh, slice_kind, int(slice_qp), 0, blob, K,
        blob_stride(slice_kind == 2, parts, i4),
        int(t8_mode), int(num_ref), int(parts), int(i4), out, cap, None)
    if sz < 0:
        raise OverflowError("CABAC level cap or buffer overflow")
    return out[:sz].tobytes()


def write_slice_cabac_syn(syn, slice_type: int, slice_qp: int,
                          init_idc: int = 0, bmode=None, mvd1=None,
                          t8=None) -> bytes:
    """Encode slice_data() with CABAC from a FrameSyntax.  Returns the
    byte-aligned payload (starts after cabac_alignment_one_bit, ends with
    the rbsp stop bit).  For B slices pass bmode (N,) and mvd1 (N,2).
    A copy of x264_tpu/bitstream/cabac_host.py ``write_slice_cabac``."""
    from x264_tpu_torch.bitstream.slice_writer import SLICE_B, SLICE_P

    n = syn.n_mbs
    cap = 1024 + n * 512
    out = np.zeros(cap, np.uint8)
    c = np.ascontiguousarray
    kind = (2 if slice_type == SLICE_B
            else 1 if slice_type == SLICE_P else 0)
    if bmode is None:
        bmode = np.zeros(n, np.int32)
    if mvd1 is None:
        mvd1 = np.zeros((n, 2), np.int32)
    t8_arr = (None if t8 is None
              else np.ascontiguousarray(np.asarray(t8).astype(np.int32)))

    sz = _lib().encode_slice_cabac(
        syn.mb_width, syn.mb_height, kind,
        int(slice_qp), init_idc,
        c(syn.mb_class.astype(np.int32)),
        c(syn.i16_mode.astype(np.int32)),
        c(syn.chroma_mode.astype(np.int32)),
        c(syn.mvd.astype(np.int32)),
        c(syn.cbp_luma.astype(np.int32)),
        c(syn.cbp_chroma.astype(np.int32)),
        c(syn.qp.astype(np.int32)),
        c(syn.luma_dc.astype(np.int16)),
        c(syn.luma_ac.astype(np.int16)),
        c(syn.chroma_dc.astype(np.int16)),
        c(syn.chroma_ac.astype(np.int16)),
        c(np.asarray(bmode).astype(np.int32)),
        c(np.asarray(mvd1).astype(np.int32)),
        None if t8_arr is None else t8_arr.ctypes.data_as(ctypes.c_void_p),
        (None if syn.i4_modes is None else
         np.ascontiguousarray(syn.i4_modes.astype(np.int32))
         .ctypes.data_as(ctypes.c_void_p)),
        None, 1, None, None, None,
        out, cap, None)
    if sz < 0:
        raise RuntimeError("CABAC buffer overflow")
    return out[:sz].tobytes()
