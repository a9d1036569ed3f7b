"""Trellis quantisation and the 8x8 transform in the port against
x264_tpu, on seeded numpy inputs with tolerance 0 (integer arithmetic,
and float32 arithmetic that must round where XLA's rounds):

- ``trellis_quant_plain`` against ``trellis.trellis_quant`` under
  ``jax.jit`` with the tables, lam2f and QP traced, as the cores call it:
  the levels, and the final path cost of every state bit for bit (from a
  copy of the reference function that also returns them), at every QP
  0-51 for nc 16, 64 and 15 with I, P and B tables;
- the escape term over the levels where XLA's log2 is exact, and the
  bound that keeps every reachable level inside it;
- the 8x8 transform functions, ``encode_p_luma_t8``,
  ``select_transform_8x8``, the t8-aware ``bs_grids`` / ``bs_grids_b``;
- the I, P16, P8x8 cores and a B pair with the 8x8 transform and
  trellis, every output field and the CABAC blob;
- ``frame_trellis``'s bundle, and the kernel source's transition groups
  against the plain twin's."""

import inspect
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu.models import (b_frame_device, inter_device,  # noqa: E402
                             intra_device, residual_device)
from x264_tpu.models.inter_frame import me_lambda  # noqa: E402
from x264_tpu.ops.device import deblock as d_db  # noqa: E402
from x264_tpu.ops.device import transform as d_tf  # noqa: E402
from x264_tpu.ops.device import trellis as d_tr  # noqa: E402
from x264_tpu_torch.models import (b_frame, inter, intra,  # noqa: E402
                                   residual)
from x264_tpu_torch.ops import deblock as t_db  # noqa: E402
from x264_tpu_torch.ops import transform as t_tf  # noqa: E402
from x264_tpu_torch.ops import trellis as t_tr  # noqa: E402
from x264_tpu_torch import state  # noqa: E402
from x264_tpu_torch.state import sad_lambda, to_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBW, MBH, LV_CAP = 6, 4, 96
BLOCKS = 1000


def T(a):
    return torch.as_tensor(np.array(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=msg)


# ---- the Viterbi ----

def _ref_with_costs():
    """The reference's trellis_quant, returning its final per-state
    costs (cbf included) beside the levels: the same function, one more
    output."""
    src = inspect.getsource(d_tr.trellis_quant)
    ret = "    return jnp.where(coefs_zz < 0, -lv, lv).astype(jnp.int32)"
    assert src.count(ret) == 1
    ns = dict(d_tr.__dict__)
    exec(src.replace(ret, ret + ", fin"), ns)
    return ns["trellis_quant"]


_JIT = {}


def _ref_jit(nc: int):
    """jit of the reference as the cores call it: qp, lam2f and the
    tables traced, dq made from the per-block qp inside."""
    if nc not in _JIT:
        tq = _ref_with_costs()

        def f(c, qp, lam2f, tbl):
            dq = d_tr.dq1_8x8(qp) if nc == 64 else d_tr.dq1_4x4(qp)
            return tq(c, dq[:, 1:] if nc == 15 else dq, lam2f, tbl, nc)
        _JIT[nc] = jax.jit(f)
    return _JIT[nc]


def _coefs(nc: int, n: int, rng):
    """Zigzag coefficients of transformed residual blocks whose
    amplitudes run from noise to full scale."""
    amp = rng.choice([1, 2, 4, 8, 16, 40, 100, 255], size=(n, 1, 1))
    s = 8 if nc == 64 else 4
    res = np.clip(np.round(rng.standard_normal((n, s, s)) * amp), -255,
                  255).astype(np.int32)
    if nc == 64:
        return np.asarray(d_tf.zigzag8(d_tf.dct8x8(res)))
    z = np.asarray(d_tf.zigzag(d_tf.dct4x4(res)))
    return np.ascontiguousarray(z[:, 1:]) if nc == 15 else z


@pytest.mark.parametrize("stype", ["I", "P", "B"])
@pytest.mark.parametrize("nc,cat", [(16, 2), (64, 5), (15, 1), (15, 4)])
def test_trellis_twin_matches_reference_every_qp(nc, cat, stype):
    fn = _ref_jit(nc)
    for qp in range(52):
        rng = np.random.default_rng(1000 * nc + 10 * cat + qp)
        c = _coefs(nc, BLOCKS, rng)
        qpb = np.clip(qp + rng.integers(-1, 2, BLOCKS), 0, 51).astype(
            np.int32)
        tbl = d_tr.tables_tuple(qp, stype, cat)
        lam2f = d_tr.frame_trellis(qp, stype, me_lambda(qp), True)[2]
        lv_r, fin_r = (np.asarray(a) for a in fn(c, qpb, lam2f, tbl))
        dq = (t_tr.dq1_8x8 if nc == 64 else t_tr.dq1_4x4)(T(qpb))
        lv_p, fin_p = t_tr.viterbi_plain(
            T(c), dq[:, 1:] if nc == 15 else dq, lam2f, tbl, nc)
        _eq(lv_p, lv_r, f"levels, qp {qp}")
        _eq(fin_p.numpy().view(np.int32), fin_r.view(np.int32),
            f"final costs, qp {qp}")
        assert t_tr.trellis_quant_plain(
            T(c), dq[:, 1:] if nc == 15 else dq, lam2f, tbl, nc).equal(lv_p)
        if qp in (0, 26):
            assert (lv_r != 0).any()


@pytest.mark.parametrize("nc", [16, 64])
def test_dq1_matches_reference(nc):
    q = np.arange(52, dtype=np.int32)
    f_r, f_p = ((d_tr.dq1_8x8, t_tr.dq1_8x8) if nc == 64
                else (d_tr.dq1_4x4, t_tr.dq1_4x4))
    _eq(f_p(T(q)), np.asarray(jax.jit(f_r)(q)))


def test_escape_term_matches_reference():
    """byp * (2 floor(log2(a - 14)) + 1) for every level a from 15 to
    8205: the port's exact bit length equals XLA's floor of log2 there.
    At a - 14 = 8192 XLA's log2 falls below 13; the largest level the
    seed quantiser can give (|coef| at its bound times the largest
    k / dq, at QP 0) stays below that."""
    a = np.arange(15, 8206, dtype=np.int32)
    byp = np.float32(256.0) * np.float32(0.37)

    def ref(a):
        af = a.astype(jnp.float32)
        return byp * (2.0 * jnp.floor(jnp.log2(jnp.maximum(af - 14.0, 1.0)))
                      + 1.0)
    want = np.asarray(jax.jit(ref)(a))
    got = (byp * (2.0 * t_tr.escape_exp(T(a)).to(torch.float32) + 1.0))
    _eq(got.numpy().view(np.int32), want.view(np.int32))
    # the reachable levels end below 8206: 16320 (8x8) and 9180 (4x4)
    # are the transforms' largest coefficients (ops/transform.py)
    reach = 0.0
    for k, dq, cmax in ((t_tr.K8_ZZ, t_tr.dq1_8x8(T([0]))[0], 16320),
                        (t_tr.K4_ZZ, t_tr.dq1_4x4(T([0]))[0], 9180)):
        reach = max(reach, float((cmax * k / dq.numpy()).max()) + 0.5)
    assert reach < 8206, reach


def test_kernel_groups_mirror_the_twin():
    """csrc/trellis.cu's transition groups (kGroupLen, kGroupCol) equal
    the plain twin's GROUP_IDX, dummy column aside."""
    src = open(os.path.join(REPO, "x264_tpu_torch", "csrc",
                            "trellis.cu")).read()
    lens = [int(x) for x in re.search(
        r"kGroupLen\[9\] = \{([^}]*)\}", src).group(1).split(",")]
    body = re.search(r"kGroupCol\[9\]\[kGroupMax\] = \{(.*?)\n  \};", src,
                     re.S).group(1)
    rows = [[int(x) for x in r.split(",") if x.strip()]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert len(rows) == 9
    for t in range(9):
        real = [int(x) for x in t_tr.GROUP_IDX[t] if x < 45]
        assert rows[t] == real and lens[t] == len(real), t
    assert t_tr.GROUP_IDX.shape[1] == int(re.search(
        r"kGroupMax = (\d+)", src).group(1))


@pytest.mark.parametrize("t8", [False, True])
@pytest.mark.parametrize("stype,qp", [("I", 0), ("P", 26), ("B", 51)])
def test_frame_trellis_bundle_matches_reference(stype, qp, t8):
    got = t_tr.frame_trellis(qp, stype, state.me_lambda(qp), t8)
    want = d_tr.frame_trellis(qp, stype, me_lambda(qp), t8)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        elif isinstance(w, tuple):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                _eq(a, b)
        else:
            assert np.float32(g) == np.float32(w)
    for cat in (0, 1, 2, 3, 4, 5):
        for k, v in d_tr.trellis_tables(qp, stype, cat).items():
            _eq(t_tr.trellis_tables(qp, stype, cat)[k], v, k)
    for nc in (16, 64):
        _eq(t_tr._w_zz(nc), d_tr._w_zz(nc))
    for name in ("DEQ4_ZZ", "DEQ8_ZZ", "K4_ZZ", "K8_ZZ", "LVL1_CTX",
                 "LVLGT1_CTX", "TRANS_EQ1", "TRANS_GT1"):
        _eq(getattr(t_tr, name), getattr(d_tr, name), name)


# ---- the 8x8 transform and the residual ----

def test_transform_8x8_matches_reference(rng):
    res = rng.integers(-255, 256, (40, 4, 8, 8)).astype(np.int32)
    c = np.asarray(d_tf.dct8x8(res))
    _eq(t_tf.dct8x8(T(res)), c)
    assert np.abs(c).max() <= 16320
    qpv = rng.integers(0, 52, (40, 1)).astype(np.int32)
    for qp in [0, 5, 17, 26, 35, 36, 41, 51, qpv]:
        qt = T(qp) if isinstance(qp, np.ndarray) else qp
        for intra_ in (False, True):
            lv = np.asarray(d_tf.quant8x8(c, qp, intra_))
            _eq(t_tf.quant8x8(T(c), qt, intra_), lv)
        d = np.asarray(d_tf.dequant8x8(lv, qp))
        _eq(t_tf.dequant8x8(T(lv), qt), d)
        _eq(t_tf.idct8x8(T(d)), np.asarray(d_tf.idct8x8(d)))
    z = np.asarray(d_tf.zigzag8(c))
    _eq(t_tf.zigzag8(T(c)), z)
    _eq(t_tf.unzigzag8(T(z)), np.asarray(d_tf.unzigzag8(z)))
    mb = rng.integers(0, 256, (7, 16, 16)).astype(np.int32)
    b8 = np.asarray(d_tf.mb_luma_to_blocks8(mb))
    _eq(t_tf.mb_luma_to_blocks8(T(mb)), b8)
    _eq(t_tf.blocks8_to_mb_luma(T(b8)), np.asarray(
        d_tf.blocks8_to_mb_luma(b8)))


def _src_pred(rng, n=24, amp=24):
    src = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    pred = np.clip(src + rng.integers(-amp, amp + 1, src.shape)
                   * rng.integers(0, 2, (n, 1, 1)), 0, 255).astype(np.int32)
    return src, pred


def _tr_pair(qp, stype, cat):
    tbl = d_tr.tables_tuple(qp, stype, cat)
    lam2f = d_tr.frame_trellis(qp, stype, me_lambda(qp), True)[2]
    return tbl, lam2f


@pytest.mark.parametrize("trellis,decimate", [(False, True), (False, False),
                                              (True, True), (True, False)])
def test_encode_p_luma_t8_matches_reference(rng, trellis, decimate):
    src, pred = _src_pred(rng)
    for qp in (12, 30):
        tr = _tr_pair(qp, "P", 5) if trellis else None
        ref = jax.jit(lambda s, p, q, t: residual_device.encode_p_luma_t8(
            s, p, q, trellis=t, decimate=decimate))(src, pred, np.int32(qp),
                                                     tr)
        port = residual.encode_p_luma_t8(T(src), T(pred), qp, trellis=tr,
                                         decimate=decimate)
        for k, (p, r) in enumerate(zip(port, ref)):
            _eq(p, r, f"output {k}, qp {qp}")
        assert (np.asarray(ref[4]) > 0).any()


@pytest.mark.parametrize("trellis", [False, True])
def test_select_transform_8x8_matches_reference(rng, trellis):
    src, pred = _src_pred(rng, n=40)
    qp = 24
    lam = sad_lambda(qp)
    tr4 = _tr_pair(qp, "P", 2) if trellis else None
    tr8 = _tr_pair(qp, "P", 5) if trellis else None
    r4 = residual_device.encode_p_luma(src, pred, np.int32(qp), trellis=tr4)
    ref = inter_device.select_transform_8x8(src, pred, np.int32(qp),
                                            np.int32(lam), *r4,
                                            trellis8=tr8)
    p4 = residual.encode_p_luma(T(src), T(pred), qp, trellis=tr4)
    port = inter.select_transform_8x8(T(src), T(pred), qp, lam, *p4,
                                      trellis8=tr8)
    for k, (p, r) in enumerate(zip(port, ref)):
        _eq(p, r, f"output {k}")
    t8 = np.asarray(ref[0])
    assert t8.any() and not t8.all()


def test_bs_grids_with_t8_match_reference(rng):
    n = MBW * MBH
    intra_ = rng.random(n) < 0.2
    nnz = rng.integers(0, 3, (n, 16)).astype(np.int32)
    mv = rng.integers(-9, 10, (n, 4, 2)).astype(np.int32)
    ref8 = np.zeros((n, 4), np.int32)
    t8 = (rng.random(n) < 0.5) & ~intra_
    want = d_db.bs_grids(jnp.asarray(intra_), nnz, mv, ref8, MBW, MBH,
                         t8=jnp.asarray(t8))
    got = t_db.bs_grids(T(intra_), T(nnz), T(mv), T(ref8), MBW, MBH,
                        t8=T(t8))
    for g, w in zip(got, want):
        _eq(g, w)
    mv1 = rng.integers(-9, 10, (n, 4, 2)).astype(np.int32)
    any0, any1 = rng.random(n) < 0.7, rng.random(n) < 0.6
    want = d_db.bs_grids_b(nnz, mv, mv1, jnp.asarray(any0),
                           jnp.asarray(any1), MBW, MBH,
                           intra=jnp.asarray(intra_), t8=jnp.asarray(t8))
    got = t_db.bs_grids_b(T(nnz), T(mv), T(mv1), T(any0), T(any1), MBW,
                          MBH, intra=T(intra_), t8=T(t8))
    for g, w in zip(got, want):
        _eq(g, w)
    # the inner edges of t8 MBs are off, and some were on without t8
    plain = t_db.bs_grids(T(intra_), T(nnz), T(mv), T(ref8), MBW, MBH)
    assert (plain[0] != got[0]).any()


# ---- the cores ----

def _frames(n=4, seed=11):
    """Soft texture panning (3, 2) px per frame, with a gradient patch
    from frame 1 on, at 96x64."""
    rng = np.random.default_rng(seed)
    h, w = 16 * MBH, 16 * MBW
    big = rng.integers(0, 256, (h + 40, w + 40)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    out = []
    for t in range(n):
        y = big[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        if t >= 1:
            yy, xx = np.mgrid[0:24, 0:40]
            y[16:40, 16:56] = 40 + 4 * yy + 3 * xx
        out.append(tuple(np.ascontiguousarray(p.astype(np.uint8)) for p in (
            y, big[t:t + h // 2, t:t + w // 2] // 2 + 40,
            255 - big[t + 1:t + 1 + h // 2, t:t + w // 2])))
    return out


def _cmp_out(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k in ref:
        _eq(port[k].to(torch.int64), np.asarray(ref[k]).astype(np.int64), k)


def _bundle(qp, stype):
    ref = d_tr.frame_trellis(qp, stype, me_lambda(qp), True)
    port = t_tr.frame_trellis(qp, stype, state.me_lambda(qp), True)
    return ref, port


@pytest.mark.parametrize("qp", [8, 30])
def test_i_core_with_trellis_matches_reference(qp):
    f0 = _frames(1)[0]
    rb, pb = _bundle(qp, "I")
    ref = intra_device.i_frame_core(*map(jnp.asarray, f0), np.int32(qp),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    entropy="cabac", lv_cap=LV_CAP,
                                    trellis_tbl=rb)
    port = intra.i_frame_core(*map(T, f0), qp, mbw=MBW, mbh=MBH, cqp_off=0,
                              lv_cap=LV_CAP, trellis_tbl=pb)
    _cmp_out(port, ref)


@pytest.mark.parametrize("parts", [False, True])
def test_p_core_with_t8_trellis_matches_reference(parts):
    fr = _frames(2)
    qp = 26
    rb, pb = _bundle(qp, "P")
    rec = intra_device.i_frame_core(*map(jnp.asarray, fr[0]), np.int32(qp),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    entropy="cabac", lv_cap=LV_CAP)
    planes = [np.asarray(rec[k]) for k in ("recon_y", "recon_u", "recon_v")]
    lam = sad_lambda(qp)
    ref = inter_device.p_frame_core(
        *map(jnp.asarray, fr[1]), *map(jnp.asarray, planes), np.int32(qp),
        np.int32(lam), mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=2,
        t8=True, trellis_tbl=rb, parts=parts, entropy="cabac",
        lv_cap=LV_CAP)
    port = inter.p_frame_core(*map(T, fr[1]), *to_port(planes, "cpu"), qp,
                              lam, mbw=MBW, mbh=MBH, me_range=8, cqp_off=0,
                              subpel=2, lv_cap=LV_CAP, parts=parts, t8=True,
                              trellis_tbl=pb)
    _cmp_out(port, ref)
    assert port["t8"].any() and (port["mb_class"] == 0).any()


def test_b_pair_core_with_t8_trellis_matches_reference():
    fr = _frames(4)
    n = MBW * MBH
    rng = np.random.default_rng(5)
    col_mv = np.broadcast_to(np.array([24, 16], np.int32), (n, 4, 2)).copy()
    col_mv[::5] += rng.integers(-6, 7, (len(col_mv[::5]), 4, 2)).astype(
        np.int32)
    col_intra = rng.random(n) < 0.15
    qps, dsfs = [26, 28], [85, 171]
    rb, pb = _bundle(qps[0], "B")
    kw = dict(mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=2)
    bs = (fr[1], fr[3])
    port = b_frame.b_pair_core(*[[T(f[c]) for f in bs] for c in range(3)],
                               *map(T, fr[0] + fr[2]), T(col_mv),
                               T(col_intra), dsfs, qps, sad_lambda(qps[0]),
                               lv_cap=LV_CAP, t8_mode=True, trellis_tbl=pb,
                               **kw)
    ref = b_frame_device.b_pair_core(
        *[jnp.asarray(np.stack([f[c] for f in bs])) for c in range(3)],
        *map(jnp.asarray, fr[0] + fr[2]), jnp.asarray(col_mv),
        jnp.asarray(col_intra), np.asarray(dsfs, np.int32),
        np.asarray(qps, np.int32), np.int32(sad_lambda(qps[0])),
        t8_mode=True, trellis_tbl=rb, entropy="cabac", lv_cap=LV_CAP, **kw)
    for i in range(2):
        _cmp_out(port[i], {k: np.asarray(v)[i] for k, v in ref.items()})
    assert any(p["t8"].any() for p in port)
