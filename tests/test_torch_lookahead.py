"""The lookahead in the port against x264_tpu: ``lowres_plane``,
``intra_cost_estimate``, ``_pair_costs`` and ``Lookahead.plan`` (a static
scene, a hard cut, a pan), ``_intra8``, ``_inter8`` and
``lowres_stats8``, and the lowres scenecut's decision, on seeded numpy
inputs with tolerance 0 (integer arithmetic throughout; the float64 host
code of AQ and MB-tree is copied).  Then streams byte-identical to
``x264_tpu.api.Encoder`` and decoded bit-exact by tools/avdec
(libavcodec), keyed by display index: AQ modes 1-3 under CQP, AQ on
every core (the I4 core, P8x8 with the 8x8 transform and trellis, a B
pair, a single B, CAVLC), the scenecut with B frames, ``b_adapt=1`` at
bframes 2 and 3, CRF + MB-tree at bframes 0 and 2, and the medium and
slower presets under CRF with AQ, MB-tree and ``b_adapt``."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu import params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import inter_frame as r_inter  # noqa: E402
from x264_tpu.models import lookahead as r_la  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import params as t_params  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.models import lookahead as t_la  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 160, 96


def T(a):
    return torch.as_tensor(np.array(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=msg)


def _scene(rng, t, phase=0, w=W, h=H, speed=4):
    """tests/test_lookahead.py's moving sine field with noise; another
    ``phase`` is another scene, ``speed`` the pan in px per frame."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 70 * np.sin((xx + speed * t + 50 * phase)
                           / (13.0 + 7 * phase))
         * np.cos((yy - 2 * t) / 19.0)).astype(np.uint8)
    return y + rng.integers(0, 4, (h, w)).astype(np.uint8)


# ---- streams ----

def _clip(n, w, h, cut=None, seed=3):
    """A moving sine field with noise, 45-degree stripes at 4-px grain in
    the top-left (I4x4 wins there), flat and busy areas (AQ's energies
    spread), moving chroma; from frame ``cut`` on, a still noise scene
    (tests/test_lookahead.py's scenecut content)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    other = rng.integers(100, 255, (h, w))
    frames = []
    for t in range(n):
        y = _scene(rng, t, 0, w, h)
        if cut is not None and t >= cut:
            y = other
        y[:16, :32] = np.where(((xx[:16, :32] + yy[:16, :32] + t) // 3) % 2,
                               200, 40)
        y[h - 16:, w - 32:] = 90
        u = (128 + 40 * np.sin((xx[::2, ::2] + t) / 23.0)).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[::2, ::2] - t) / 29.0)).astype(np.uint8)
        frames.append((y.astype(np.uint8), u, v))
    return frames


_BASE = dict(width=96, height=64, qp=26, me_range=8, subpel=2, cabac=True,
             deblock=True, bframes=0, ref_frames=1, keyint_max=250,
             scenecut_threshold=0)
_CRF = dict(rc_method=r_params.RC_CRF, crf=30.0)

# name -> (settings, frames, scene cut, base: None for _BASE, else a
# preset's name); B frames decode to their recon (full_recon is on)
STREAMS = {
    # the two presets take the longest: the first and the last, so that
    # xdist hands them out early and, likely, to two workers
    "medium": (dict(keyint_min=4), 14, 9, "medium"),
    "aq1_cqp": (dict(aq_mode=1), 4, None, None),
    "aq2_cqp": (dict(aq_mode=2), 4, None, None),
    "aq3_cqp": (dict(aq_mode=3, aq_strength=1.4), 4, None, None),
    "aq_i4": (dict(aq_mode=1, i4x4=True, transform_8x8=True, trellis=1),
              2, None, None),
    "aq_p8x8_t8_trellis": (dict(aq_mode=1, p8x8=True, transform_8x8=True,
                                trellis=1), 3, None, None),
    "aq_b_pair": (dict(aq_mode=1, bframes=2), 4, None, None),
    "aq_b_single": (dict(aq_mode=1, bframes=1, p8x8=True), 3, None, None),
    "aq_cavlc": (dict(aq_mode=1, cabac=False, p8x8=True, bframes=2), 5,
                 None, None),
    "scenecut_b": (dict(bframes=2, scenecut_threshold=40, keyint_min=1), 9,
                   5, None),
    "b_adapt_2": (dict(bframes=2, b_adapt=1), 9, 5, None),
    "b_adapt_3": (dict(bframes=3, b_adapt=1), 9, 5, None),
    "mbtree_b0": (dict(mbtree=True, rc_lookahead=4, **_CRF), 8, None, None),
    "mbtree_b2": (dict(mbtree=True, rc_lookahead=3, bframes=2, **_CRF), 9,
                  None, None),
    "slower": (dict(keyint_min=4), 12, 8, "slower"),
}


def _params(P, kw, preset):
    if preset is None:
        return P.EncoderParams(**dict(_BASE, **kw))
    # the preset at CRF 23 with AQ, MB-tree and adaptive B placement
    return P.param_default_preset(preset).clone(
        width=_BASE["width"], height=_BASE["height"], rc_method=P.RC_CRF,
        crf=23.0, aq_mode=1, mbtree=True, b_adapt=1, **kw)


@pytest.mark.parametrize("name", list(STREAMS))
def test_lookahead_streams_match_reference_and_decode(name):
    """The port's stream equals the reference's, with the same frame
    types and QPs, and avdec decodes it to the port's recon of every
    frame (keyed by display index)."""
    kw, n, cut, preset = STREAMS[name]
    tp, rp = _params(t_params, kw, preset), _params(r_params, kw, preset)
    frames = _clip(n, tp.width, tp.height, cut)
    port = Encoder(tp, device="cpu")
    recons = {}
    port.recon_hook = recons.__setitem__
    stream = b"".join(port.encode(Frame420(*f)) for f in frames) \
        + port.flush()
    ref = RefEncoder(rp)
    ref_stream = b"".join(ref.encode(RefFrame(*f)) for f in frames) \
        + ref.flush()
    types = [s.frame_type for s in port.stats]
    assert stream == ref_stream, types
    assert [(s.frame_type, s.qp) for s in port.stats] == \
        [(s.frame_type, s.qp) for s in ref.stats]
    dec = decode_annexb(stream, tp.width, tp.height)
    assert len(dec) == n == len(recons)
    for d, planes in enumerate(dec):
        for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                planes):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec,
                                          err_msg=f"{name}: display {d}")
    if cut is not None and (kw.get("scenecut_threshold") or preset):
        assert "IDR" in types[1:], types


# ---- the lowres functions ----

@pytest.mark.parametrize("h,w", [(64, 64), (97, 133), (50, 70)])
def test_lowres_plane_matches_reference(rng, h, w):
    y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    port = t_la.lowres_plane(T(y))
    assert port.is_contiguous() and port.dtype == torch.uint8
    _eq(port, r_la.lowres_plane(jnp.asarray(y)))


@pytest.mark.parametrize("content", ["noise", "scene"])
def test_intra_cost_estimate_matches_reference(rng, content):
    mbw, mbh = 5, 3
    y = (rng.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.uint8)
         if content == "noise" else _scene(rng, 3, w=80, h=48))
    port = t_la.intra_cost_estimate(T(y), mbw, mbh)
    assert port.dtype == torch.int64
    _eq(port, r_inter.intra_cost_estimate(y, mbw, mbh))


def _queue(rng, case):
    """(anchor, three queued frames) of a static scene, a hard cut to
    noise, or a fast pan."""
    if case == "static":
        fr = [_scene(rng, t) for t in range(4)]
    elif case == "cut":
        fr = [_scene(rng, 0), _scene(rng, 1)] + [
            rng.integers(0, 256, (H, W)).astype(np.uint8) for _ in range(2)]
    else:
        fr = [_scene(rng, t, speed=13) for t in range(4)]
    return fr[0], fr[1:]


@pytest.mark.parametrize("case", ["static", "cut", "pan"])
def test_pair_costs_match_reference(rng, case):
    anchor, q = _queue(rng, case)
    lrs = [r_la.lowres_plane(jnp.asarray(y)) for y in [anchor] + q]
    h, w = lrs[0].shape
    pairs = ((1, 0), (2, 1), (3, 2), (2, 0), (3, 0), (1, 2), (1, 3), (2, 3))
    ref = r_la._pair_costs(jnp.stack(lrs), pairs, mbw=w // 16, mbh=h // 16)
    port = t_la._pair_costs(torch.stack([t_la.lowres_plane(T(y))
                                         for y in [anchor] + q]),
                            pairs, w // 16, h // 16)
    _eq(port, ref)


@pytest.mark.parametrize("case", ["static", "cut", "pan"])
def test_plan_matches_reference(rng, case):
    anchor, q = _queue(rng, case)
    ms = []
    for la in (t_la.Lookahead(t_params.EncoderParams(bframes=3), "cpu"),
               r_la.Lookahead(r_params.EncoderParams(bframes=3))):
        assert la.plan(q) == 0          # no anchor yet
        la.push_anchor(anchor)
        ms.append([la.plan(q[:k]) for k in (1, 2, 3)])
    assert ms[0] == ms[1]
    if case == "static":
        assert ms[0] == [0, 1, 2]       # a static scene: the most B frames


@pytest.mark.parametrize("mbw,mbh", [(5, 3), (2, 1)])
def test_intra8_matches_reference(rng, mbw, mbh):
    lr = rng.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.uint8)
    lr[:, :8] = lr[:, 8:16]                    # a block H and V predict
    _eq(t_la._intra8(T(lr), mbw, mbh),
        r_la._intra8(jnp.asarray(lr), mbw=mbw, mbh=mbh))


@pytest.mark.parametrize("speed", [4, 13])
def test_inter8_matches_reference(rng, speed):
    a, b = (r_la.lowres_plane(jnp.asarray(_scene(rng, t, speed=speed)))
            for t in (0, 1))
    mbw, mbh = a.shape[1] // 16, a.shape[0] // 16
    pc, mv = t_la._inter8(T(b), T(a), mbw, mbh)
    rpc, rmv = r_la._inter8(b, a, mbw=mbw, mbh=mbh)
    _eq(pc, rpc)
    _eq(mv, rmv)
    assert (mv != 0).any()


@pytest.mark.parametrize("first", [True, False])
def test_lowres_stats8_matches_reference(rng, first):
    a, b = (_scene(rng, t) for t in (0, 1))
    lr = r_la.lowres_plane(jnp.asarray(b))
    prev = None if first else r_la.lowres_plane(jnp.asarray(a))
    mbw, mbh = lr.shape[1] // 16, lr.shape[0] // 16
    port = t_la.lowres_stats8(T(lr), None if first else T(prev), mbw, mbh)
    ref = r_la.lowres_stats8(lr, prev, mbw, mbh)
    assert [p is None for p in port] == [r is None for r in ref] \
        == [False] + 2 * [first]
    for p, r in zip(port, ref):
        if r is not None:
            _eq(p, r)


@pytest.mark.parametrize("cut", [True, False])
def test_lowres_scenecut_decision_matches_reference(rng, cut):
    """The pre-encode lowres scene test over ten frames (the second scene
    from frame 5 when ``cut``): the same decision per frame."""
    a = rng.integers(0, 140, (H, W)).astype(np.uint8)
    b = rng.integers(100, 255, (H, W)).astype(np.uint8)
    c = np.full((H // 2, W // 2), 110, np.uint8)
    seq = [b if cut and i >= 5 else a for i in range(10)]
    decisions = []
    for E, F, P, kw in ((Encoder, Frame420, t_params, dict(device="cpu")),
                        (RefEncoder, RefFrame, r_params, {})):
        enc = E(P.EncoderParams(width=W, height=H, bframes=2, cabac=True,
                                scenecut_threshold=40, keyint_min=1), **kw)
        decisions.append([enc._lowres_scenecut(F(y, c, c), d)
                          for d, y in enumerate(seq)])
    assert decisions[0] == decisions[1]
    assert decisions[0] == [cut and d == 5 for d in range(10)]
