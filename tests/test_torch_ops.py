"""The port's primitive ops against their JAX counterparts in x264_tpu:
pixel, transform, predict, mc, residual, header and the CABAC blob.
Same seeded numpy inputs through both; tolerance 0 (integer arithmetic
throughout)."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu.ops.device import entropy_pack as d_ep  # noqa: E402
from x264_tpu.ops.device import header as d_hdr  # noqa: E402
from x264_tpu.ops.device import mc as d_mc  # noqa: E402
from x264_tpu.ops.device import pixel as d_pixel  # noqa: E402
from x264_tpu.ops.device import predict as d_pred  # noqa: E402
from x264_tpu.ops.device import transform as d_tr  # noqa: E402
from x264_tpu.models import residual_device as d_res  # noqa: E402
from x264_tpu_torch.models import residual as t_res  # noqa: E402
from x264_tpu_torch.ops import entropy_pack as t_ep  # noqa: E402
from x264_tpu_torch.ops import header as t_hdr  # noqa: E402
from x264_tpu_torch.ops import mc as t_mc  # noqa: E402
from x264_tpu_torch.ops import pixel as t_pixel  # noqa: E402
from x264_tpu_torch.ops import predict as t_pred  # noqa: E402
from x264_tpu_torch.ops import transform as t_tr  # noqa: E402

QPS = [0, 26, 51]


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(fn, **static):
    """The reference function jitted with its static arguments bound (one
    compiled program instead of op-by-op dispatch)."""
    return jax.jit(functools.partial(fn, **static))


def _eq(port, ref):
    p = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    np.testing.assert_array_equal(p, r)


def _eq_all(ports, refs):
    assert len(ports) == len(refs)
    for p, r in zip(ports, refs):
        _eq(p, r)


def test_sad_satd(rng):
    a = rng.integers(0, 256, (6, 3, 16, 16)).astype(np.uint8)
    b = rng.integers(0, 256, (6, 3, 16, 16)).astype(np.uint8)
    _eq(t_pixel.sad(T(a), T(b)), J(d_pixel.sad)(a, b))
    _eq(t_pixel.satd(T(a), T(b)),
        J(d_pixel.satd)(a, b))
    c = rng.integers(0, 256, (5, 8, 8)).astype(np.int32)
    _eq(t_pixel.satd(T(c), T(c[::-1].copy())),
        J(d_pixel.satd)(c, c[::-1]))


def test_dct_idct_hadamard(rng):
    res = rng.integers(-255, 256, (40, 4, 4)).astype(np.int32)
    _eq(t_tr.dct4x4(T(res)), d_tr.dct4x4(jnp.asarray(res)))
    coefs = rng.integers(-2048, 2048, (40, 4, 4)).astype(np.int32)
    _eq(t_tr.idct4x4(T(coefs)), d_tr.idct4x4(jnp.asarray(coefs)))
    dc = rng.integers(-4080, 4081, (20, 4, 4)).astype(np.int32)
    _eq(t_tr.hadamard4x4_fwd(T(dc)), d_tr.hadamard4x4_fwd(jnp.asarray(dc)))
    _eq(t_tr.hadamard4x4_inv(T(dc)), d_tr.hadamard4x4_inv(jnp.asarray(dc)))
    c2 = rng.integers(-4080, 4081, (20, 2, 2)).astype(np.int32)
    _eq(t_tr.hadamard2x2(T(c2)), d_tr.hadamard2x2(jnp.asarray(c2)))


@pytest.mark.parametrize("qp", QPS)
def test_quant_dequant(rng, qp):
    coefs = rng.integers(-9180, 9181, (12, 16, 4, 4)).astype(np.int32)
    qp_mb = rng.integers(max(0, qp - 3), min(51, qp + 3) + 1,
                         (12, 1)).astype(np.int32)
    for q in (np.int32(qp), qp_mb):
        for intra in (True, False):
            lv = t_tr.quant4x4(T(coefs), T(q), intra)
            _eq(lv, J(d_tr.quant4x4, intra=intra)(coefs, q))
            _eq(t_tr.dequant4x4(lv, T(q)),
                J(d_tr.dequant4x4)(lv.numpy(), q))
    dc = rng.integers(-32640, 32641, (12, 4, 4)).astype(np.int32)
    q0 = qp_mb[:, 0]
    for q in (np.int32(qp), q0):
        lv = t_tr.quant_dc4(T(dc), T(q))
        _eq(lv, J(d_tr.quant_dc4)(dc, q))
        _eq(t_tr.dequant_dc4(lv, T(q)),
            J(d_tr.dequant_dc4)(lv.numpy(), q))
    dc2 = rng.integers(-8160, 8161, (12, 2, 2)).astype(np.int32)
    for q in (np.int32(qp), q0):
        for intra in (True, False):
            lv = t_tr.quant_dc2(T(dc2), T(q), intra)
            _eq(lv, J(d_tr.quant_dc2, intra=intra)(dc2, q))
            _eq(t_tr.dequant_dc2(lv, T(q)),
                J(d_tr.dequant_dc2)(lv.numpy(), q))


def test_layout_helpers(rng):
    b = rng.integers(-99, 99, (7, 4, 4)).astype(np.int32)
    _eq(t_tr.zigzag(T(b)), d_tr.zigzag(jnp.asarray(b)))
    s = rng.integers(-99, 99, (7, 16)).astype(np.int32)
    _eq(t_tr.unzigzag(T(s)), d_tr.unzigzag(jnp.asarray(s)))
    mb = rng.integers(0, 256, (3, 16, 16)).astype(np.int32)
    blocks = t_tr.mb_luma_to_blocks(T(mb))
    _eq(blocks, d_tr.mb_luma_to_blocks(jnp.asarray(mb)))
    _eq(t_tr.blocks_to_mb_luma(blocks), mb)
    plane = rng.integers(0, 256, (48, 80)).astype(np.int32)
    for s_ in (16, 8):
        mbh, mbw = 48 // s_, 80 // s_
        mbs = t_tr.plane_to_mbs(T(plane), mbh, mbw, s_)
        _eq(mbs, d_tr.plane_to_mbs(jnp.asarray(plane), mbh, mbw, s_))
        _eq(t_tr.mbs_to_plane(mbs, mbh, mbw, s_), plane)


def _edges(rng, n, s):
    top = rng.integers(0, 256, (n, s)).astype(np.uint8)
    left = rng.integers(0, 256, (n, s)).astype(np.uint8)
    tl = rng.integers(0, 256, n).astype(np.uint8)
    at = rng.random(n) < 0.7
    al = rng.random(n) < 0.7
    return top, left, tl, at, al


def test_predict_16x16_and_chroma(rng):
    for s, t_fn, d_fn in ((16, t_pred.predict_16x16_all,
                           d_pred.predict_16x16_all),
                          (8, t_pred.predict_chroma_all,
                           d_pred.predict_chroma_all)):
        args = _edges(rng, 24, s)
        _eq(t_fn(*map(T, args)), J(d_fn)(*args))
    at, al, atl = (rng.random(24) < 0.5 for _ in range(3))
    _eq(t_pred.i16x16_mode_avail(T(at), T(al), T(atl)),
        d_pred.i16x16_mode_avail(jnp.asarray(at), jnp.asarray(al),
                                 jnp.asarray(atl)))
    _eq(t_pred.chroma_mode_avail(T(at), T(al), T(atl)),
        d_pred.chroma_mode_avail(jnp.asarray(at), jnp.asarray(al),
                                 jnp.asarray(atl)))


def test_hpel_planes_and_chroma_mc(rng):
    plane = rng.integers(0, 256, (40, 56)).astype(np.uint8)
    _eq(t_mc.hpel_planes(T(plane)), J(d_mc.hpel_planes)(plane))
    _eq(t_mc.pad_edge(T(plane), 5),
        jnp.pad(jnp.asarray(plane), 5, mode="edge"))
    mbw, mbh, pad_c = 4, 3, 16
    ru = rng.integers(0, 256, (8 * mbh + 2 * pad_c, 8 * mbw + 2 * pad_c)
                      ).astype(np.uint8)
    rv = rng.integers(0, 256, ru.shape).astype(np.uint8)
    mv = rng.integers(-60, 61, (mbw * mbh, 2)).astype(np.int32)
    _eq_all(t_mc.mc_chroma_uv(T(ru), T(rv), T(mv), mbw, mbh, pad_c),
            J(d_mc.mc_chroma_uv, mbw=mbw, mbh=mbh, pad_c=pad_c)(
                ru, rv, mv))
    _eq(t_mc.mc_chroma(T(ru), T(mv), mbw, mbh, pad_c),
        J(d_mc.mc_chroma, mbw=mbw, mbh=mbh, pad_c=pad_c)(ru, mv))


def _src_pred(rng, n, s, spread):
    src = rng.integers(0, 256, (n, s, s)).astype(np.uint8)
    pred = np.clip(src.astype(np.int32)
                   + rng.integers(-spread, spread + 1, src.shape), 0, 255)
    return src, pred.astype(np.int32)


@pytest.mark.parametrize("qp", QPS)
def test_residual_paths(rng, qp):
    n = 10
    qp_mb = np.clip(qp + rng.integers(-2, 3, n), 0, 51).astype(np.int32)
    src, pred = _src_pred(rng, n, 16, 12)
    for q in (np.int32(qp), qp_mb):
        _eq_all(t_res.encode_i16_luma(T(src), T(pred), T(q)),
                J(d_res.encode_i16_luma)(src, pred, q))
        for dec in (True, False):
            _eq_all(t_res.encode_p_luma(T(src), T(pred), T(q), decimate=dec),
                    J(d_res.encode_p_luma, decimate=dec)(src, pred, q))
    su, pu = _src_pred(rng, n, 8, 10)
    sv, pv = _src_pred(rng, n, 8, 10)
    for q in (np.int32(qp), qp_mb):
        for intra in (True, False):
            _eq_all(t_res.encode_chroma(T(su), T(sv), T(pu), T(pv), T(q),
                                        intra),
                    J(d_res.encode_chroma, intra=intra)(su, sv, pu, pv, q))


def test_decimate_score(rng):
    zz = (rng.integers(-2, 3, (300, 16))
          * (rng.random((300, 16)) < 0.25)).astype(np.int32)
    _eq(t_res.decimate_score(T(zz)), J(d_res.decimate_score, nc=16)(zz))
    _eq(t_res.decimate_score(T(zz[:, 1:])),
        J(d_res.decimate_score, nc=16)(zz[:, 1:]))


def test_classify_p(rng):
    mbw, mbh = 7, 5
    n = mbw * mbh
    for trial in range(4):
        mv = (rng.integers(-3, 4, (n, 2)) * 4).astype(np.int32)
        mv[rng.random(n) < 0.4] = 0
        cbp_l = (rng.integers(0, 16, n) * (rng.random(n) < 0.3)
                 ).astype(np.int32)
        cbp_c = (rng.integers(0, 3, n) * (rng.random(n) < 0.3)
                 ).astype(np.int32)
        intra = None if trial == 0 else rng.random(n) < 0.15
        _eq_all(t_hdr.classify_p(T(mv), T(cbp_l), T(cbp_c), mbw, mbh,
                                 intra=None if intra is None else T(intra)),
                J(d_hdr.classify_p, mbw=mbw, mbh=mbh)(
                    mv, cbp_l, cbp_c,
                    intra=None if intra is None else jnp.asarray(intra)))


@pytest.mark.parametrize("K", [4, 96])
def test_cabac_blob(rng, K):
    """Same int32 words as the reference: bit 31 of the bitmap words and
    negative levels in the high half of a stream word wrap as in JAX; K=4
    cuts the level stream at its cap."""
    n = 12

    def sparse(shape, density, lim=3000):
        return (rng.integers(-lim, lim + 1, shape)
                * (rng.random(shape) < density)).astype(np.int32)

    args = [sparse((n, 16), .5), sparse((n, 16, 16), .3),
            sparse((n, 2, 4), .5), sparse((n, 2, 4, 16), .3)]
    args[3][:, 1, 3, 15] = -7       # value 407: bit 23 of the last word
    args[1][:, 15, 15] = -1         # value 271: bit 31 of word 8
    fields = [rng.integers(0, 4, n), rng.integers(-40, 41, (n, 2)),
              rng.integers(0, 4, n), rng.integers(0, 4, n),
              rng.integers(0, 16, n), rng.integers(0, 3, n),
              rng.integers(0, 52, n), rng.integers(0, 5000, n),
              rng.integers(0, 5000, n)]
    fields = [f.astype(np.int32) for f in fields]
    port = t_ep.cabac_blob(*map(T, args + fields), K=K)
    ref = J(d_ep.cabac_blob, K=K)(*args, *fields)
    _eq(port, ref)
    assert port.dtype == torch.int32
    assert t_ep.blob_stride() == d_ep.blob_stride()
