"""CAVLC residual coding on the device: per-block (value, length) slot
grids, so the host only appends packed bitstrings (port of
x264_tpu/ops/device/cavlc.py; parity: reference encoder/cavlc.c
block_residual_write_cavlc).

Slot layout per block (36 slots): [0] coeff_token, [1:4] trailing-one
signs, [4:20] level codes (prefix and suffix in one token), [20]
total_zeros, [21:36] run_before.  ``residual_slots`` runs the CUDA
kernel ``csrc/cavlc_blocks.cu`` on the cores' CUDA fields in place
(``kernels/cavlc.py``) and, on CPU tensors, its plain twin:
``block_inputs`` then ``code_blocks_plain``.  ``cavlc_blob`` packs the
slots per MB (``csrc/bitpack.cu``, ``kernels/bitpack.py``)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from x264_tpu_torch.kernels import cavlc as KC
from x264_tpu_torch.kernels.bitpack import pack_blob

_I32 = torch.int32
BLOCK_SLOTS = KC.BLOCK_SLOTS
BLOCKS_PER_MB = 27      # luma DC, 16 luma AC, 2 chroma DC, 8 chroma AC

# coded (zigzag-of-quadrant) order of luma 4x4 blocks -> raster index
_C2R = (0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15)


def _level_codes(lc, sl):
    """Fused unary-prefix + suffix level code (the reference's
    ``_level_codes``)."""
    mask = (1 << sl) - 1
    prefix = lc >> sl.clamp(min=1)
    lc_esc = torch.where(sl == 0, lc - 15, lc)
    lcr = lc_esc - (15 << sl)

    cond_a = (sl == 0) & (lc < 14)
    cond_b = (sl == 0) & (lc >= 14) & (lc < 30)
    cond_c = (sl > 0) & (prefix < 15)
    cond_d = lcr < 4096

    val = torch.where(cond_a, 1,
          torch.where(cond_b, (1 << 4) | (lc - 14),
          torch.where(cond_c, (1 << sl) | (lc & mask),
          torch.where(cond_d, (1 << 12) | lcr.clamp(min=0),
                      (1 << 13) | (lcr - 4096).clamp(min=0)))))
    ln = torch.where(cond_a, lc + 1,
         torch.where(cond_b, 19,
         torch.where(cond_c, prefix + 1 + sl,
         torch.where(cond_d, 28, 30))))
    return val.to(_I32), ln.to(_I32)


def code_blocks_plain(coefs, blen, nC):
    """coefs (B,16) int32 zigzag left-aligned per block length; blen (B,);
    nC (B,) (-1/-2 chroma DC, else >= 0).  Returns (vals, lens) (B,36)
    int32, the reference's ``code_blocks`` op for op (its one-hot matmuls
    are a gather and a scatter here).  Uncoded blocks are masked by the
    caller."""
    B, L = coefs.shape
    dev = coefs.device
    tab = KC.tables_on(str(dev))
    coefs = coefs.to(_I32)
    blen = blen.to(_I32)
    nC = nC.to(_I32)
    j = torch.arange(L, dtype=_I32, device=dev)

    # reversal: rev[b,k] = coefs[b, blen-1-k] (0 past the block)
    src = blen[:, None] - 1 - j[None, :]
    inb = (src >= 0) & (src < L)
    rev = torch.where(inb, coefs.gather(1, src.clamp(0, L - 1).long()), 0)

    nzmask = rev != 0
    total = nzmask.sum(1).to(_I32)
    # compaction of nonzeros to the front, order preserved: each nonzero
    # goes to its rank among the nonzeros, the zeros to a dump column
    rank = torch.cumsum(nzmask.to(_I32), dim=1) - 1
    dst = torch.where(nzmask, rank, L).long()
    seq = torch.zeros((B, L + 1), dtype=_I32, device=dev).scatter_(
        1, dst, rev)[:, :L]
    pos_zig_nz = torch.zeros((B, L + 1), dtype=_I32, device=dev).scatter_(
        1, dst, src + 1)[:, :L] - 1
    pos_zig = torch.where(j[None, :] < total[:, None], pos_zig_nz, 0)

    in_range = j[None, :] < total[:, None]
    abs1 = in_range & (seq.abs() == 1)
    t1 = (abs1[:, 0].to(_I32) + (abs1[:, 0] & abs1[:, 1]).to(_I32)
          + (abs1[:, 0] & abs1[:, 1] & abs1[:, 2]).to(_I32))

    vals = [None] * BLOCK_SLOTS
    lens = [None] * BLOCK_SLOTS

    t = torch.where(nC == -1, 4,
        torch.where(nC == -2, 5,
        torch.where(nC < 2, 0,
        torch.where(nC < 4, 1,
        torch.where(nC < 8, 2, 3)))))
    some = total > 0
    ct = tab["CT"][((t * 17 + total) * 4 + t1).long()]
    vals[0] = ct & 0xFFFF
    lens[0] = ct >> 16

    for k in range(3):
        on = (k < t1) & some
        vals[1 + k] = torch.where(on & (seq[:, k] < 0), 1, 0).to(_I32)
        lens[1 + k] = on.to(_I32)

    sl = torch.where((total > 10) & (t1 < 3), 1, 0).to(_I32)
    for k in range(L):
        active = (k >= t1) & (k < total)
        lvl = seq[:, k]
        lc = torch.where(lvl > 0, 2 * lvl - 2, -2 * lvl - 1)
        lc = torch.where((k == t1) & (t1 < 3), lc - 2, lc)
        v, ln = _level_codes(lc, sl)
        vals[4 + k] = torch.where(active, v, 0)
        lens[4 + k] = torch.where(active, ln, 0)
        sl_n = sl.clamp(min=1)
        sl_n = torch.where((lvl.abs() > (3 << (sl_n - 1))) & (sl_n < 6),
                           sl_n + 1, sl_n)
        sl = torch.where(active, sl_n, sl)

    tz = pos_zig[:, 0] + 1 - total
    on = some & (total < blen)
    tzw = torch.where(
        nC == -1,
        tab["TZ2"][((total - 1).clamp(0, 2) * 4 + tz.clamp(0, 3)).long()],
        torch.where(
            nC == -2,
            tab["TZ24"][((total - 1).clamp(0, 6) * 8
                         + tz.clamp(0, 7)).long()],
            tab["TZ"][((total - 1).clamp(0, 14) * 16
                       + tz.clamp(0, 15)).long()]))
    vals[20] = torch.where(on, tzw & 0xFFFF, 0)
    lens[20] = torch.where(on, tzw >> 16, 0)

    zeros_left = torch.where(some, tz, 0)
    prev_pos = pos_zig[:, 0]
    for k in range(1, L):
        active = (k < total) & (zeros_left > 0)
        run = (prev_pos - pos_zig[:, k] - 1).clamp(0, 14)
        ri = (zeros_left.clamp(max=7) - 1).clamp(0, 6)
        rb = tab["RB"][(ri * 15 + run).long()]
        vals[20 + k] = torch.where(active, rb & 0xFFFF, 0)
        lens[20 + k] = torch.where(active, rb >> 16, 0)
        zeros_left = torch.where(active, zeros_left - run, zeros_left)
        prev_pos = torch.where(k < total, pos_zig[:, k], prev_pos)

    return (torch.stack(vals, dim=1).to(_I32),
            torch.stack(lens, dim=1).to(_I32))


def code_blocks(coefs, blen, nC, gate=None):
    """(vals, lens) (B,36) of (B,16) blocks, the lengths of a block whose
    gate is False zeroed: ``code_blocks_plain`` and the gate, the second
    half of ``residual_slots_plain`` (the kernel codes whole MBs from the
    cores' fields, through ``residual_slots``)."""
    vals, lens = code_blocks_plain(coefs, blen, nC)
    if gate is not None:
        lens = torch.where(gate[:, None], lens, 0)
    return vals, lens


@functools.lru_cache(maxsize=8)
def _c2r(device: str) -> torch.Tensor:
    """_C2R on ``device``, uploaded once (an I core's CUDA graph captures
    no host-to-device copy)."""
    return torch.tensor(_C2R, device=device)


def _nc_from_grid(grid):
    """Vectorized CAVLC nC (9.2.1) over a total_coeff grid (GH, GW)."""
    gh, gw = grid.shape
    left = F.pad(grid[:, :-1], (1, 0))
    top = F.pad(grid[:-1, :], (0, 0, 1, 0))
    col = torch.arange(gw, device=grid.device)[None, :]
    row = torch.arange(gh, device=grid.device)[:, None]
    has_l = (col > 0).expand(gh, gw)
    has_t = (row > 0).expand(gh, gw)
    both = (left + top + 1) >> 1
    return torch.where(has_l & has_t, both,
           torch.where(has_l, left,
           torch.where(has_t, top, 0))).to(_I32)


def _grid_to_mb(grid, mbh: int, mbw: int, s: int):
    return (grid.reshape(mbh, s, mbw, s).permute(0, 2, 1, 3)
            .reshape(mbh * mbw, s * s))


def block_inputs(luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac,
                 chroma_nnz, cbp_luma, cbp_chroma, is_i16, mbw: int,
                 mbh: int):
    """The inputs of ``code_blocks`` for a frame's 27 blocks per MB in
    emission order [luma DC | 16 luma AC coded-order | 2 chroma DC | 8
    chroma AC]: (coefs (N*27, 16), blen, nC, gate (N*27,)).  luma_dc
    (N,16) zigzag; luma_ac (N,16,16) raster-block-major zigzag; chroma_dc
    (N,2,4); chroma_ac (N,2,4,16); *_nnz the per-block nonzero counts;
    is_i16 (N,) bool."""
    n = mbw * mbh
    dev = luma_dc.device
    c2r = _c2r(str(dev))

    nnz_y = (luma_nnz.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3)
             .reshape(4 * mbh, 4 * mbw))
    nc_y_mb = _grid_to_mb(_nc_from_grid(nnz_y), mbh, mbw, 4)  # (N,16) raster

    # luma AC in coded order
    ac = luma_ac[:, c2r, :].to(_I32)
    i16b = is_i16[:, None, None]
    l_coefs = torch.cat(
        [torch.where(i16b, ac[:, :, 1:], ac[:, :, :15]),
         torch.where(is_i16[:, None], 0, ac[:, :, 15])[:, :, None]], dim=2)
    quad = torch.arange(16, dtype=_I32, device=dev) // 4
    blk_on = ((cbp_luma.to(_I32)[:, None] >> quad[None, :]) & 1).bool()

    nc_c = torch.stack([
        _grid_to_mb(_nc_from_grid(
            chroma_nnz[:, pl].reshape(mbh, mbw, 2, 2).permute(0, 2, 1, 3)
            .reshape(2 * mbh, 2 * mbw)), mbh, mbw, 2)
        for pl in range(2)], dim=1)                              # (N,2,4)

    coefs = torch.cat([
        luma_dc.to(_I32)[:, None, :],
        l_coefs,
        F.pad(chroma_dc.to(_I32).reshape(n, 2, 4), (0, 12)),
        F.pad(chroma_ac[..., 1:].to(_I32).reshape(n, 8, 15), (0, 1))],
        dim=1)                                                   # (N,27,16)

    def full(k, v):
        return torch.full((n, k), v, dtype=_I32, device=dev)
    blen = torch.cat([
        full(1, 16),
        torch.where(is_i16, 15, 16).to(_I32)[:, None].expand(n, 16),
        full(2, 4), full(8, 15)], dim=1)
    nC = torch.cat([nc_y_mb[:, :1], nc_y_mb[:, c2r], full(2, -1),
                    nc_c.reshape(n, 8)], dim=1)
    cbp_c = cbp_chroma.to(_I32)
    gate = torch.cat([
        is_i16[:, None],
        blk_on,
        (cbp_c > 0)[:, None].expand(n, 2),
        (cbp_c == 2)[:, None].expand(n, 8)], dim=1)
    return (coefs.reshape(n * BLOCKS_PER_MB, 16), blen.reshape(-1),
            nC.reshape(-1), gate.reshape(-1))


def residual_slots_plain(luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac,
                         chroma_nnz, cbp_luma, cbp_chroma, is_i16, mbw: int,
                         mbh: int):
    """The plain twin of the kernel's residual slots, on any device:
    ``block_inputs`` and ``code_blocks_plain`` over all 27 blocks per MB,
    the lengths of an uncoded block zeroed -> (vals, lens) (N, 27*36)."""
    n = mbw * mbh
    coefs, blen, nC, gate = block_inputs(
        luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac, chroma_nnz,
        cbp_luma, cbp_chroma, is_i16, mbw, mbh)
    vals, lens = code_blocks(coefs, blen, nC, gate)
    return (vals.reshape(n, BLOCKS_PER_MB * BLOCK_SLOTS),
            lens.reshape(n, BLOCKS_PER_MB * BLOCK_SLOTS))


def residual_slots(luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac,
                   chroma_nnz, cbp_luma, cbp_chroma, is_i16, mbw: int,
                   mbh: int):
    """The full residual slot grids of a frame (arguments as
    ``block_inputs``) -> (vals, lens) (N, 27*36) int32 in emission order:
    on CUDA tensors one launch of the kernel on the fields as they are,
    on CPU tensors the plain twin ``residual_slots_plain``."""
    args = (luma_dc, luma_ac, luma_nnz, chroma_dc, chroma_ac, chroma_nnz,
            cbp_luma, cbp_chroma, is_i16, mbw, mbh)
    if luma_dc.device.type == "cuda":
        return KC.residual_slots_(*args)
    if luma_dc.device.type != "cpu":
        raise ValueError(f"residual_slots: no kernel for {luma_dc.device}")
    return residual_slots_plain(*args)


def cavlc_blob(hv, hl, res_vals, res_lens, n_words: int, fields):
    """The CAVLC host blob: each MB's header and residual tokens packed
    into n_words words (kernel ``csrc/bitpack.cu``, the two grids read
    where they lie), then nbits and the per-MB ``fields`` (mb_class,
    mb_cost, ...) -> (N, n_words + 1 + len(fields)) int32, the
    reference's layout.  ``kernels/bitpack.place`` places its MBs'
    strings in the slice payload."""
    return pack_blob(hv, hl, res_vals, res_lens, n_words,
                     [f.to(_I32) for f in fields])
