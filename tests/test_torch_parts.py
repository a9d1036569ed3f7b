"""P8x8 partitions in the port against x264_tpu: the ESA-partitions
kernel's plain twin against ``me_parts.full_search_parts_xla`` (the XLA
twin of the Pallas kernel), ``choose_shape``, ``subpel_refine_parts``,
``mc_chroma_uv_quad``, ``classify_p_parts``, ``bs_grids`` with quadrant
mvs, the P8x8 core's outputs and blob, and end-to-end P8x8 streams,
byte-identical to ``x264_tpu.api.Encoder`` and decoded bit-exact by
tools/avdec (libavcodec).  Same seeded numpy inputs; tolerance 0 (integer
arithmetic throughout); me_range <= 8 wherever the JAX partition search
runs, to keep its CPU loop short."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _stream_bases import ODD  # noqa: E402
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import inter_device, intra_device  # noqa: E402
from x264_tpu.ops.device import deblock as d_db  # noqa: E402
from x264_tpu.ops.device import header as d_hdr  # noqa: E402
from x264_tpu.ops.device import mc as d_mc  # noqa: E402
from x264_tpu.ops.device import me_parts as d_mp  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from tests.test_parts_e2e import split_motion_frames  # noqa: E402
import x264_tpu_torch  # noqa: E402
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.kernels import esa_parts  # noqa: E402
from x264_tpu_torch.models import inter  # noqa: E402
from x264_tpu_torch.ops import deblock as t_db  # noqa: E402
from x264_tpu_torch.ops import header as t_hdr  # noqa: E402
from x264_tpu_torch.ops import mc as t_mc  # noqa: E402
from x264_tpu_torch.ops import me_parts as t_mp  # noqa: E402
from x264_tpu_torch.state import PAD, sad_lambda, to_port  # noqa: E402


def T(a):
    return torch.as_tensor(np.asarray(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=msg)


def _search_inputs(rng, mbw, mbh):
    h, w = mbh * 16, mbw * 16
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    big = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.int32)
    big[PAD - 3:PAD - 3 + h, PAD + 5:PAD + 5 + w] = src
    ref = np.clip(big + rng.integers(-6, 7, big.shape), 0, 255
                  ).astype(np.uint8)
    return src, ref


@pytest.mark.parametrize("mbw,mbh,me_range,lam,flat",
                         [(6, 4, 8, 14, False), (5, 3, 4, 4, False),
                          (3, 2, 4, 0, True)])
def test_full_search_parts_plain_matches_xla(rng, mbw, mbh, me_range, lam,
                                             flat):
    src, ref = _search_inputs(rng, mbw, mbh)
    if flat:
        # every candidate's SAD is 0 and lam is 0: all nine units tie
        # everywhere, and the first candidate, (-r, -r), must win
        src[:] = 90
        ref[:] = 90
    want = d_mp.full_search_parts_xla(jnp.asarray(src), jnp.asarray(ref),
                                      np.int32(lam), me_range=me_range,
                                      mbw=mbw, mbh=mbh)
    before = x264_tpu_torch.launch_counts()["esa_parts"]
    # the wrapper takes the plain twin for CPU tensors and counts nothing
    got = t_mp.full_search_parts(T(src), T(ref), lam, me_range, mbw, mbh)
    assert x264_tpu_torch.launch_counts()["esa_parts"] == before
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.int32, k
        _eq(got[k], want[k], k)
    if flat:
        assert (got["mv_f"].numpy() == -4 * me_range).all()
    with pytest.raises(ValueError):
        esa_parts.full_search_parts(T(src), T(ref), lam, PAD + 1, mbw, mbh)


@pytest.mark.parametrize("lam", [0, 2])
def test_choose_shape_matches_reference(rng, lam):
    n = 40
    # small costs so that shapes tie often: the first least cost wins
    units = dict(cost_q=rng.integers(0, 6, (n, 4)),
                 cost_h=rng.integers(0, 10, (n, 2)),
                 cost_v=rng.integers(0, 10, (n, 2)),
                 cost_f=rng.integers(0, 20, n),
                 mv_q=rng.integers(-32, 33, (n, 4, 2)),
                 mv_h=rng.integers(-32, 33, (n, 2, 2)),
                 mv_v=rng.integers(-32, 33, (n, 2, 2)),
                 mv_f=rng.integers(-32, 33, (n, 2)))
    units = {k: v.astype(np.int32) for k, v in units.items()}
    want = d_mp.choose_shape({k: jnp.asarray(v) for k, v in units.items()},
                             np.int32(lam))
    got = t_mp.choose_shape({k: T(v) for k, v in units.items()}, lam)
    for g, w in zip(got, want):
        _eq(g, w)
    assert len(set(got[0].tolist())) >= 3


@pytest.mark.parametrize("steps", [1, 2])
def test_subpel_refine_parts_matches_reference(rng, steps):
    mbw, mbh, mer = 5, 3, 8
    n, h, w = mbw * mbh, mbh * 16, mbw * 16
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ref = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.uint8)
    src_mbs = (src.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
               .reshape(n, 16, 16).astype(np.int32))
    mv8 = (rng.integers(-mer, mer + 1, (n, 4, 2)) * 4).astype(np.int32)
    shape = rng.integers(0, 4, n).astype(np.int32)
    want = d_mp.subpel_refine_parts(
        jnp.asarray(src_mbs), jnp.asarray(mv8), jnp.asarray(shape),
        np.int32(9), mer, steps, mbw, mbh, ref_pad=jnp.asarray(ref))
    got = t_mp.subpel_refine_parts(T(src_mbs), T(mv8), T(shape), 9, mer,
                                   steps, mbw, mbh, T(ref))
    for g, w, k in zip(got, want, ("mv8", "cost", "pred")):
        assert g.dtype == torch.int32, k
        _eq(g, w, k)


def test_mc_chroma_uv_quad_matches_reference(rng):
    mbw, mbh, pc = 4, 3, PAD // 2
    n = mbw * mbh
    u = rng.integers(0, 256, (8 * mbh + 2 * pc, 8 * mbw + 2 * pc))
    v = rng.integers(0, 256, u.shape)
    u, v = u.astype(np.uint8), v.astype(np.uint8)
    mv8 = rng.integers(-60, 61, (n, 4, 2)).astype(np.int32)
    want = d_mc.mc_chroma_uv_quad(jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(mv8), mbw, mbh, pc)
    got = t_mc.mc_chroma_uv_quad(T(u), T(v), T(mv8), mbw, mbh, pc)
    for g, w in zip(got, want):
        _eq(g, w)
    # one mv per MB: the per-MB chroma MC
    mv = mv8[:, 0]
    same = t_mc.mc_chroma_uv_quad(T(u), T(v), T(np.repeat(mv[:, None], 4, 1)),
                                  mbw, mbh, pc)
    for a, b in zip(same, t_mc.mc_chroma_uv(T(u), T(v), T(mv), mbw, mbh,
                                            pc)):
        assert torch.equal(a, b)


def test_classify_p_parts_matches_reference(rng):
    mbw, mbh = 7, 5
    n = mbw * mbh
    # few distinct mvs and many zeros, so that MVPs, P_Skip and the
    # directional predictors all come into play
    mv8 = (rng.integers(-1, 2, (n, 4, 2)) * 4).astype(np.int32)
    mv8[rng.random(n) < 0.3] = 0
    shape = rng.integers(0, 4, n).astype(np.int32)
    shape[rng.random(n) < 0.3] = 0
    mv8[shape == 0] = mv8[shape == 0][:, :1]
    cbp_l = (rng.integers(0, 16, n) * (rng.random(n) < .4)).astype(np.int32)
    cbp_c = (rng.integers(0, 3, n) * (rng.random(n) < .4)).astype(np.int32)
    intra = rng.random(n) < 0.15
    ref8 = np.zeros((n, 4), np.int32)
    want = d_hdr.classify_p_parts(jnp.asarray(mv8), jnp.asarray(ref8),
                                  jnp.asarray(shape), jnp.asarray(cbp_l),
                                  jnp.asarray(cbp_c), mbw, mbh,
                                  intra=jnp.asarray(intra))
    got = t_hdr.classify_p_parts(T(mv8), T(ref8), T(shape), T(cbp_l),
                                 T(cbp_c), mbw, mbh, intra=T(intra))
    for g, w in zip(got, want):
        _eq(g, w)
    assert (got[0] == t_hdr.MB_PSKIP_D).any()


def test_bs_grids_with_quadrant_mvs(rng):
    mbw, mbh = 5, 4
    n = mbw * mbh
    intra = rng.random(n) < 0.2
    nnz = (rng.random((n, 16)) < 0.3).astype(np.int32)
    mv8 = rng.integers(-8, 9, (n, 4, 2)).astype(np.int32)
    ref8 = np.zeros((n, 4), np.int32)
    want = d_db.bs_grids(jnp.asarray(intra), jnp.asarray(nnz),
                         jnp.asarray(mv8), jnp.asarray(ref8), mbw, mbh)
    got = t_db.bs_grids(T(intra), T(nnz), T(mv8), T(ref8), mbw, mbh)
    for g, w in zip(got, want):
        _eq(g, w)
    # the internal 8x8 edges carry the mv-discontinuity rule
    assert (got[0].numpy()[:, 2::4] == 1).any()


@pytest.mark.parametrize("qp", [18, 30])
def test_p8x8_frame_core(qp):
    mbw, mbh = 6, 4
    frames = split_motion_frames(16 * mbw, 16 * mbh, 2)
    f0 = [np.asarray(p) for p in (frames[0].y, frames[0].u, frames[0].v)]
    f1 = [np.asarray(p) for p in (frames[1].y, frames[1].u, frames[1].v)]
    rec = intra_device.i_frame_core(*map(jnp.asarray, f0), np.int32(qp),
                                    mbw=mbw, mbh=mbh, cqp_off=0,
                                    entropy="cabac", lv_cap=96)
    ref_planes = [np.asarray(rec[k]) for k in ("recon_y", "recon_u",
                                                "recon_v")]
    lam = sad_lambda(qp)
    want = inter_device.p_frame_core(
        *map(jnp.asarray, f1), *map(jnp.asarray, ref_planes), np.int32(qp),
        np.int32(lam), mbw=mbw, mbh=mbh, me_range=8, cqp_off=0, subpel=2,
        entropy="cabac", lv_cap=96, parts=True)
    got = inter.p_frame_core(*map(torch.from_numpy, f1),
                             *to_port(ref_planes, "cpu"), qp, lam, mbw=mbw,
                             mbh=mbh, me_range=8, cqp_off=0, subpel=2,
                             lv_cap=96, parts=True)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        _eq(got[k], want[k], k)
    assert {1, 2} <= set(got["shape"].tolist())


def _encode(enc, frames):
    recons, shapes = [], []
    enc.recon_hook = lambda d, rec: recons.append(rec)
    run = enc._run_core

    def spy(*a, **kw):
        out, st = run(*a, **kw)
        if "shape" in out:
            shapes.append(out["shape"].numpy())
        return out, st

    enc._run_core = spy
    stream = b"".join(enc.encode(f) for f in frames) + enc.flush()
    return stream, recons, shapes


@pytest.mark.parametrize("w,h,qp,n", [(96, 64, 0, 3), (96, 64, 26, 4),
                                      (96, 64, 51, 3), (*ODD, 26, 3)])
def test_p8x8_stream_matches_reference_and_decodes(w, h, qp, n):
    frames = split_motion_frames(w, h, n)
    kw = dict(width=w, height=h, qp=qp, keyint_max=250, deblock=True,
              me_range=8, subpel=2, p8x8=True, cabac=True, bframes=0,
              scenecut_threshold=0)
    stream, recons, shapes = _encode(Encoder(EncoderParams(**kw),
                                             device="cpu"), frames)
    ref = RefEncoder(RefParams(**kw))
    assert stream == b"".join(ref.encode(f) for f in frames) + ref.flush()
    dec = decode_annexb(stream, w, h)
    assert len(dec) == len(frames) == len(recons)
    for rec, planes in zip(recons, dec):
        for p_rec, p_dec in zip((rec.y, rec.u, rec.v), planes):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec)
    used = set(np.concatenate(shapes).tolist())
    assert len(shapes) == n - 1
    if qp < 51:
        assert {1, 2, 3} <= used, used      # the partitions are chosen
