"""RD-optimal quantization (trellis): the host cost tables and the plain
PyTorch twin of the batched 9-state Viterbi (port of
x264_tpu/ops/device/trellis.py; parity anchor: reference encoder/rdo.c
quant_trellis_cabac).

States: 8 CABAC level-context nodes (the (numEq1, numGt1) chain as the
entropy coder walks it, native/cabac.c lvl_trans) plus an "unstarted"
state (no nonzero chosen yet, i.e. positions past the last significant
coefficient, where no flags are coded).  Bit costs come from the
normative context-initialisation probabilities at the slice QP
(bitstream/cabac_init.py) in 1/256-bit units; distortion is the
transform-domain SSD weighted by the inverse basis, so a path's cost is
pixel SSD + lambda2 * bits.

The host tables below are copied, code and all, from the reference
(``tables_from_states`` is left out: the encoder always passes
``states=None``).  ``trellis_quant_plain`` follows the reference's
``trellis_quant`` step for step and rounds where XLA's CPU code for it
rounds: XLA contracts a product into an add (one rounding, an FMA) where
the product has that add as its only use inside one fused loop, and
nowhere else.  For the Viterbi that is three sites, emulated exactly by
``fma32``: the level error of every step but the first,
``c - a*dq`` = fma(-a, dq, c); the first step's, which XLA fuses with
the target ``|coef| * k`` and so rounds the other product,
fma(|coef|, k, -(a*dq)); and the level-bin count of ``lcg``,
fma(min(a, 15) - 2, gt1[s], b0[s]).  Every other product, such as the
per-block distortions ``(w*e)*e`` that nine states share, rounds on its
own.  The escape length ``floor(log2(a - 14))`` is an exact integer bit
length: XLA's ``log2`` is not exact at powers of two, but its first
miss (a - 14 = 8192) is past the largest level the seed quantiser
gives (3264, an 8x8 DC at QP 0)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from x264_tpu_torch.bitstream.cabac_init import (CTX_INIT_I, CTX_INIT_PB,
                                                 LAST8X8_MAP, SIG8X8_MAP)
from x264_tpu_torch.state import (DEQUANT4, DEQUANT8, QUANT4_MF, QUANT8_MF,
                                  ZIGZAG_4x4, ZIGZAG_8x8)

# ---- x264_tpu/ops/device/trellis.py ----
# dequant-of-level-1 per zigzag position, (6, nc) — 4x4 exact; 8x8 is the
# float linearisation of the two-regime normative dequant (8.5.13.1),
# which only feeds the distortion model, not the reconstruction
DEQ4_ZZ = DEQUANT4.reshape(6, 16)[:, ZIGZAG_4x4].astype(np.float32)
DEQ8_ZZ = (DEQUANT8.reshape(6, 64)[:, ZIGZAG_8x8].astype(np.float32))

# quant->dequant roundtrip gain per position: the H.264 tables fold the
# transform orthonormalisation into mf/V, so the dequant domain is the
# DCT domain SCALED by k = mf*V/2^qbits (~{4.0, 2.56, 3.2} per parity
# class, qp-independent by table design).  The trellis target is c*k.
K4_ZZ = ((QUANT4_MF[0].reshape(16).astype(np.float64)
          * DEQUANT4[0].reshape(16)) / 2 ** 15
         )[ZIGZAG_4x4].astype(np.float32)
K8_ZZ = ((QUANT8_MF[0].reshape(64).astype(np.float64)
          * DEQUANT8[0].reshape(64) * 16) / 2 ** 22
         )[ZIGZAG_8x8].astype(np.float32)

# CABAC state probability model: pLPS(state) = 0.5 * ALPHA^state — the
# design rule of the normative rangeTabLPS (9.3.3.2.1.1).
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63)

# level-context walk, identical to the entropy coder (native/cabac.c)
LVL1_CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0])          # bin0 ctxIdxInc
LVLGT1_CTX = np.array([5, 5, 5, 5, 6, 7, 8, 9])        # bins>0 ctxIdxInc
TRANS_EQ1 = np.array([1, 2, 3, 3, 4, 5, 6, 7])         # after |level|==1
TRANS_GT1 = np.array([4, 4, 4, 4, 5, 6, 7, 7])         # after |level|>1


def _ctx_bits(qp: int, slice_type: str, idx) -> np.ndarray:
    """(..., 2) f32: cost (1/256 bits) of coding bin 0 / bin 1 in ctx idx,
    at the ctx-init operating point for slice qp (9.3.1.1)."""
    init = CTX_INIT_I if slice_type == "I" else CTX_INIT_PB[0]
    idx = np.asarray(idx)
    m = init[idx, 0].astype(np.int64)
    n = init[idx, 1].astype(np.int64)
    pre = np.clip(((m * np.clip(qp, 0, 51)) >> 4) + n, 1, 126)
    state = np.where(pre <= 63, 63 - pre, pre - 64)
    mps1 = pre > 63
    plps = 0.5 * _ALPHA ** state
    p1 = np.where(mps1, 1.0 - plps, plps)
    return (np.stack([-np.log2(1.0 - p1), -np.log2(p1)], axis=-1)
            * 256.0).astype(np.float32)


def _basis_weights_1d(inv1d, n):
    """||inverse basis vector||^2 per coefficient, from a float twin of
    the normative inverse transform (shifts become exact halves)."""
    eye = np.eye(n, dtype=np.float64)
    out = np.array([inv1d(eye[k]) for k in range(n)])
    return (out * out).sum(axis=1)


def _idct4_1d_f(d):
    e0, e1 = d[0] + d[2], d[0] - d[2]
    e2, e3 = d[1] / 2 - d[3], d[1] + d[3] / 2
    return np.array([e0 + e3, e1 + e2, e1 - e2, e0 - e3])


def _idct8_1d_f(d):
    e0, e2 = d[0] + d[4], d[0] - d[4]
    e4, e6 = d[2] / 2 - d[6], d[2] + d[6] / 2
    e1 = -d[3] + d[5] - d[7] - d[7] / 2
    e3 = d[1] + d[7] - d[3] - d[3] / 2
    e5 = -d[1] + d[7] + d[5] + d[5] / 2
    e7 = d[3] + d[5] + d[1] + d[1] / 2
    f0, f2, f4, f6 = e0 + e6, e2 + e4, e2 - e4, e0 - e6
    f1, f3 = e1 + e7 / 4, e3 + e5 / 4
    f5, f7 = e3 / 4 - e5, e7 - e1 / 4
    return np.array([f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                     f6 - f1, f4 - f3, f2 - f5, f0 - f7])


@functools.lru_cache(maxsize=None)
def _w_zz(nc: int) -> np.ndarray:
    """Pixel-SSD weight of a transform-domain coefficient error at each
    zigzag position: ||inv basis||^2 / 64^2 (the inverse ends with >>6)."""
    if nc == 16:
        w1 = _basis_weights_1d(_idct4_1d_f, 4)
        w2 = np.outer(w1, w1).reshape(16) / 4096.0
        return w2[ZIGZAG_4x4].astype(np.float32)
    w1 = _basis_weights_1d(_idct8_1d_f, 8)
    w2 = np.outer(w1, w1).reshape(64) / 4096.0
    return w2[ZIGZAG_8x8].astype(np.float32)


def trellis_tables(slice_qp: int, slice_type: str, cat: int) -> dict:
    """Host-side cost tables for one frame: sig/last per scan position,
    level-bin costs per node, cbf costs.  ctx layout matches
    native/cabac.c (SIG_OFF/LAST_OFF/LVL_OFF/CBF_OFF and the 8x8 maps)."""
    if cat == 5:
        sig = _ctx_bits(slice_qp, slice_type, 402 + SIG8X8_MAP)   # (63,2)
        last = _ctx_bits(slice_qp, slice_type, 417 + LAST8X8_MAP)
        lvl_off = 426
        # no coded_block_flag for cat5 (cbp covers it): charge one bit
        # as the cbp-delta proxy for a nonzero 8x8
        cbf = np.array([0.0, 256.0], np.float32)
    else:
        off = {0: 0, 1: 15, 2: 29, 3: 44, 4: 47}[cat]
        npos = {0: 16, 1: 15, 2: 16, 3: 4, 4: 15}[cat] - 1
        sig = _ctx_bits(slice_qp, slice_type,
                        105 + off + np.arange(npos))
        last = _ctx_bits(slice_qp, slice_type,
                         166 + off + np.arange(npos))
        lvl_off = 227 + {0: 0, 1: 10, 2: 20, 3: 30, 4: 39}[cat]
        cbf = _ctx_bits(slice_qp, slice_type, 85 + 4 * cat)[()]
    b0 = _ctx_bits(slice_qp, slice_type, lvl_off + LVL1_CTX)      # (8,2)
    gt1 = _ctx_bits(slice_qp, slice_type, lvl_off + LVLGT1_CTX)   # (8,2)
    return dict(sig=sig, last=last, b0=b0, gt1=gt1,
                cbf=np.asarray(cbf, np.float32).reshape(2),
                w=_w_zz(16 if cat != 5 else 64))


@functools.lru_cache(maxsize=64)
def tables_tuple(slice_qp: int, slice_type: str, cat: int) -> tuple:
    """(sig, last, b0, gt1, cbf) f32 arrays for trellis_quant — cached
    per (qp, type, cat) so repeated frames reuse the same host arrays."""
    t = trellis_tables(slice_qp, slice_type, cat)
    return (t["sig"], t["last"], t["b0"], t["gt1"], t["cbf"])


def frame_trellis(slice_qp: int, slice_type: str, lam: int,
                  t8: bool) -> tuple:
    """The (tbl4, tbl8, lam2f, tbl_i16ac, tbl_cac) bundle the frame
    cores take.  lam2f = lambda2/256 (bit costs are 1/256-bit units);
    lam is me_lambda, already the lambda2 law, scaled by the reference's
    round-5 calibration 0.35 (the ctx-init tables overprice bits).
    tbl_i16ac (cat 1) covers Intra16x16 AC blocks, tbl_cac (cat 4) the
    chroma AC blocks."""
    lam = lam * 0.35
    tbl4 = tables_tuple(slice_qp, slice_type, 2)
    tbl8 = tables_tuple(slice_qp, slice_type, 5) if t8 else None
    lam2f = np.float32(max(float(lam), 1.0) / 256.0)
    return (tbl4, tbl8, lam2f, tables_tuple(slice_qp, slice_type, 1),
            tables_tuple(slice_qp, slice_type, 4))


# ---- the Viterbi ----

@functools.lru_cache(maxsize=None)
def _deq_table(nc: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(DEQ8_ZZ if nc == 64 else DEQ4_ZZ, device=device)


def _dq1(qp_blk, nc: int):
    q = torch.as_tensor(qp_blk).to(torch.int32)
    # 2^(q//6) (8x8: 2^(q//6 - 2)) as an exact float, the reference's exp2
    # of an integer
    scale = (torch.ones_like(q) << torch.div(q, 6, rounding_mode="floor")
             ).to(torch.float32) / (4.0 if nc == 64 else 1.0)
    return _deq_table(nc, q.device)[(q % 6).long()] * scale[:, None]


def dq1_4x4(qp_blk):
    """(B,) per-block qp -> (B, 16) f32 dequant scale of level 1 in
    zigzag order (matches dequant4x4: v * 2^(qp//6))."""
    return _dq1(qp_blk, 16)


def dq1_8x8(qp_blk):
    """(B,) -> (B, 64) f32: DEQUANT8*16 * 2^(qp//6 - 6) (8.5.13.1
    linearised)."""
    return _dq1(qp_blk, 64)


BIG = np.float32(1e30)     # an unreachable cost (the reference's, not inf)
N_STATES = 9               # 0..7 = level nodes, 8 = unstarted


def _groups():
    """The 45 (move, source) transitions grouped by target state, padded
    with a dummy column 45 (cost BIG): (IDX, SRCG, KINDG), each (9, G).
    Moves: level 0 (keep the state), a1 == 1, a1 > 1, a2 == 1, a2 > 1;
    kind 0 -> level 0, 1 -> a1, 2 -> a2; the unstarted source enters
    through node 0's contexts."""
    te, tg = [int(x) for x in TRANS_EQ1], [int(x) for x in TRANS_GT1]
    moves = [list(range(8)) + [8], te + [te[0]], tg + [tg[0]],
             te + [te[0]], tg + [tg[0]]]
    tgt45 = np.array([moves[m][s] for m in range(5) for s in range(9)])
    src45 = np.tile(np.arange(9), 5)
    kind45 = np.repeat([0, 1, 1, 2, 2], 9)
    groups = [[i for i in range(45) if tgt45[i] == t] for t in range(9)]
    g = max(len(x) for x in groups)
    idx = np.full((9, g), 45, np.int64)
    for t, cols in enumerate(groups):
        idx[t, :len(cols)] = cols
    real = idx < 45
    srcg = np.where(real, src45[np.minimum(idx, 44)], 8).astype(np.int32)
    kindg = np.where(real, kind45[np.minimum(idx, 44)], 0).astype(np.int32)
    return idx, srcg, kindg


GROUP_IDX, GROUP_SRC, GROUP_KIND = _groups()


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once, from float64: the product is
    exact there, and the sum is rounded to odd (TwoSum's error decides
    the last bit) so that its rounding to float32 is the correct one.
    IEEE arithmetic only, so the CPU and CUDA give the same bits."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def escape_exp(a):
    """floor(log2(a - 14)) for integer levels a >= 15, as an exact bit
    length: the exponent of the level's Exp-Golomb suffix."""
    x = (a - 14).clamp(min=1)
    n = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        big = x >= (1 << sh)
        n = n + torch.where(big, sh, 0)
        x = torch.where(big, x >> sh, x)
    return n


def _fma_np(a, b, c):
    """float32 fma(a, b, c) of numpy float32 arrays (see ``fma32``)."""
    return fma32(*(torch.from_numpy(np.ascontiguousarray(x, np.float32))
                   for x in np.broadcast_arrays(a, b, c))).numpy()


def lambda_tables(tbl, lam2f, nc: int) -> dict:
    """The reference's per-call folding of lambda into the bit costs, in
    float32 (numpy rounds each product and sum once, as XLA does):
    per-position significance costs and flags, per-state level-bin
    costs (column 8 = the unstarted state, through node 0's contexts)
    and the final coded_block_flag costs.  For the 8x8 scan (nc 64, a
    scan XLA runs as a loop) XLA fuses ``last * lam`` into the flag
    sums, which then round once."""
    sig, last, b0, gt1, cbf = (np.asarray(t, np.float32) for t in tbl)
    lam = np.float32(lam2f)
    sig_l = sig * lam
    if nc == 64:
        fl = _fma_np(last[:, 1], lam, sig_l[:, 1])
        fm = _fma_np(last[:, 0], lam, sig_l[:, 1])
    else:
        fl = sig_l[:, 1] + last[:, 1] * lam
        fm = sig_l[:, 1] + last[:, 0] * lam
    b0, gt1, cbf = b0 * lam, gt1 * lam, cbf * lam
    byp = np.float32(256.0) * lam                 # one bypass bin
    ext = lambda v: np.concatenate([v, v[:1]])    # noqa: E731
    return dict(
        sig0=sig_l[:, 0], fl=fl, fm=fm,
        lc1=ext(b0[:, 0]) + byp, b0e1=ext(b0[:, 1]), gt1e0=ext(gt1[:, 0]),
        gt1e1=ext(gt1[:, 1]), byp=byp,
        fin=np.concatenate([np.full(8, cbf[1]), [cbf[0]]]).astype(
            np.float32))


def position_gains(nc: int):
    """(k, w) per scan position: the quant round-trip gain and the
    pixel-SSD weight (nc 15: zigzag positions 1..15 of a 4x4 block)."""
    if nc == 64:
        return K8_ZZ, _w_zz(64)
    if nc == 16:
        return K4_ZZ, _w_zz(16)
    return K4_ZZ[1:], _w_zz(16)[1:]


def trellis_quant_plain(coefs_zz, dq_zz, lam2f, tbl, nc: int):
    """RD-optimal levels for (B, nc) zigzag DCT coefficients: the plain
    twin of the reference's ``trellis_quant`` and of the CUDA kernel
    (``viterbi_plain``'s levels)."""
    return viterbi_plain(coefs_zz, dq_zz, lam2f, tbl, nc)[0]


def viterbi_plain(coefs_zz, dq_zz, lam2f, tbl, nc: int):
    """The Viterbi of ``trellis_quant_plain``: (levels, final costs).

    coefs_zz: (B, nc) int32 signed transform coefficients.
    dq_zz:    (B, nc) f32 dequant-of-level-1 per position (dq1_4x4 /
              dq1_8x8; folds the per-block qp).
    lam2f:    lambda2 / 256 (bits are 1/256 units), float32.
    tbl:      (sig (nc-1,2), last (nc-1,2), b0 (8,2), gt1 (8,2), cbf (2,))
              f32 arrays from trellis_tables.
    nc:       16 (luma 4x4, cat 2), 64 (8x8, cat 5), or 15 (AC-only cats
              1/4: zigzag positions 1..15 of a 4x4 block).
    Returns (B, nc) int32 signed levels and the (B, 9) float32 cost of
    the best path ending in each state, coded_block_flag included."""
    dev = coefs_zz.device
    f32 = torch.float32
    t = {k: torch.as_tensor(v, device=dev) for k, v in
         lambda_tables(tbl, lam2f, nc).items()}
    k_np, w_np = position_gains(nc)
    k = torch.as_tensor(k_np, device=dev)
    coefs = coefs_zz.to(torch.int32)
    cabs = coefs.abs().to(f32)
    absc = cabs * k
    dqf = dq_zz.to(f32)
    lr_all = torch.floor(absc / dqf + 0.5).to(torch.int32)
    B = coefs.shape[0]
    big = torch.tensor(float(BIG), dtype=f32, device=dev)
    started = torch.arange(9, device=dev) < 8
    cost = torch.where(started, big, torch.zeros((), dtype=f32,
                                                 device=dev)).expand(B, 9)
    idx = torch.as_tensor(GROUP_IDX, device=dev)
    srcg = torch.as_tensor(GROUP_SRC, device=dev).long()
    kindg = torch.as_tensor(GROUP_KIND, device=dev)
    pad = torch.full((B, 1), float(BIG), dtype=f32, device=dev)
    targets = torch.arange(9, device=dev)[None, :]
    lvl_recs, src_recs = [], []
    for step in range(nc):
        p = nc - 1 - step
        c, dq, lr = absc[:, p], dqf[:, p], lr_all[:, p]
        wp = torch.tensor(float(w_np[p]), dtype=f32, device=dev)
        if step == 0:
            # significance inferred (no flags), no started source yet
            flv = torch.where(started, big, 0.0)
            sig0 = torch.zeros((), dtype=f32, device=dev)
        else:
            flv = torch.where(started, t["fm"][p], t["fl"][p])
            sig0 = torch.where(started, t["sig0"][p], 0.0)
        a1 = lr
        a2 = (lr - 1).clamp(min=0)
        moves = [(cost + (wp * c * c)[:, None]) + sig0]
        base_e = cost + (flv + t["lc1"])
        gt_base = cost + flv
        for a in (a1, a2):
            af = a.to(f32)
            if step == 0:
                e = fma32(cabs[:, p], k[p].expand(B), -(af * dq))
            else:
                e = fma32(-af, dq, c)
            da = (wp * e * e)[:, None]
            esc = 2.0 * escape_exp(a).to(f32) + 1.0
            eg0 = torch.where((a >= 15)[:, None], (t["byp"] * esc)[:, None],
                              t["gt1e0"])
            mm2 = (torch.minimum(af, torch.tensor(15.0, device=dev))
                   + -2.0)[:, None]
            lcg = (fma32(mm2.expand(B, 9), t["gt1e1"].expand(B, 9),
                         t["b0e1"].expand(B, 9)) + eg0) + t["byp"]
            moves.append(torch.where((a == 1)[:, None], base_e + da, big))
            moves.append(torch.where((a > 1)[:, None], (gt_base + lcg) + da,
                                     big))
        # column order: level 0, a1 == 1, a1 > 1, a2 == 1, a2 > 1, dummy
        grouped = torch.cat(moves + [pad], dim=1)[:, idx]        # (B,9,G)
        kk = torch.argmin(grouped, dim=2)                        # first min
        cost = torch.gather(grouped, 2, kk[:, :, None])[:, :, 0]
        kind = kindg[targets, kk]
        src_recs.append(srcg[targets, kk])
        lvl_recs.append(torch.where(kind == 1, a1[:, None],
                                    torch.where(kind == 2, a2[:, None], 0)))
    # coded_block_flag decides all-zero (unstarted) vs any-nonzero
    fin = cost + t["fin"]
    state = torch.argmin(fin, dim=1)
    lv = torch.empty((B, nc), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    for step in range(nc - 1, -1, -1):
        lv[:, nc - 1 - step] = lvl_recs[step][rows, state]
        state = src_recs[step][rows, state]
    return torch.where(coefs < 0, -lv, lv), fin
