"""B frames in the port against x264_tpu: ``mvp_for_list``,
``mc_luma_qpel_quad`` (the reference's runs its one-hot window gather on
the CPU), ``bs_grids_b``, the B fields of ``cabac_blob``, the B cores
(``b_frame_core``, ``b_pair_core``: every output field and the blob), and
B-GOP streams byte-identical to ``x264_tpu.api.Encoder`` and decoded
bit-exact by tools/avdec (libavcodec), keyed by display index.  Also the
access-unit log, a conformance run across the POC LSB wrap, the settings
still closed, the me_range edge of the reference's 80-row band gather,
and subpel windows that never leave the padded plane.  Seeded numpy inputs; tolerance 0 (integer arithmetic
throughout).  The stream cases are grouped so that the cases that share
the reference's compiled programs run in one test (one worker)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _stream_bases import ODD  # noqa: E402
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import b_frame_device  # noqa: E402
from x264_tpu.ops.device import deblock as d_db  # noqa: E402
from x264_tpu.ops.device import entropy_pack as d_ep  # noqa: E402
from x264_tpu.ops.device import header as d_hdr  # noqa: E402
from x264_tpu.ops.device import mc as d_mc  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.models import b_frame  # noqa: E402
from x264_tpu_torch.ops import deblock as t_db  # noqa: E402
from x264_tpu_torch.ops import entropy_pack as t_ep  # noqa: E402
from x264_tpu_torch.ops import header as t_hdr  # noqa: E402
from x264_tpu_torch.ops import mc as t_mc  # noqa: E402
from x264_tpu_torch.params import RC_ABR  # noqa: E402
from x264_tpu_torch.state import PAD, sad_lambda  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 96, 64


def T(a):
    return torch.as_tensor(np.asarray(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref),
                                  err_msg=msg)


@pytest.mark.parametrize("quad", [False, True])
def test_mvp_for_list_matches_reference(rng, quad):
    mbw, mbh = 7, 5
    n = mbw * mbh
    shape = (n, 4, 2) if quad else (n, 2)
    mv = rng.integers(-60, 61, shape).astype(np.int32)
    used = rng.random(n) < 0.6
    _eq(t_hdr.mvp_for_list(T(mv), T(used), mbw, mbh),
        d_hdr.mvp_for_list(jnp.asarray(mv), jnp.asarray(used), mbw, mbh))


def test_mc_luma_qpel_quad_matches_reference(rng):
    """Quadrant mvs across the whole band-safe range (|mv| up to 31.75
    px), fractional positions included."""
    mbw, mbh = 5, 4
    n = mbw * mbh
    plane = rng.integers(0, 256, (16 * mbh, 16 * mbw)).astype(np.uint8)
    pad = np.pad(plane, PAD, mode="edge")
    mv8 = rng.integers(-127, 128, (n, 4, 2)).astype(np.int32)
    port = t_mc.mc_luma_qpel_quad(t_mc.hpel_planes(T(pad)), T(mv8), mbw,
                                  mbh, PAD)
    ref = d_mc.mc_luma_qpel_quad(d_mc.hpel_planes(jnp.asarray(pad)),
                                 jnp.asarray(mv8), mbw, mbh, PAD)
    _eq(port, ref)


@pytest.mark.parametrize("with_intra", [False, True])
def test_bs_grids_b_matches_reference(rng, with_intra):
    mbw, mbh = 6, 4
    n = mbw * mbh
    nnz = (rng.random((n, 16)) < 0.3).astype(np.int32)
    mv0 = rng.integers(-9, 10, (n, 4, 2)).astype(np.int32)
    mv1 = rng.integers(-9, 10, (n, 2)).astype(np.int32)
    any0, any1 = rng.random(n) < 0.7, rng.random(n) < 0.5
    intra = (rng.random(n) < 0.25) if with_intra else None
    port = t_db.bs_grids_b(T(nnz), T(mv0), T(mv1), T(any0), T(any1), mbw,
                           mbh, intra=None if intra is None else T(intra))
    ref = d_db.bs_grids_b(jnp.asarray(nnz), jnp.asarray(mv0),
                          jnp.asarray(mv1), jnp.asarray(any0),
                          jnp.asarray(any1), mbw, mbh,
                          intra=None if intra is None else jnp.asarray(intra))
    for p, r in zip(port, ref):
        _eq(p, r)
    assert all(int((p == v).sum()) for p in port for v in (1, 2)) and \
        (not with_intra or int((port[0] == 4).sum()))


def test_cabac_blob_b_fields_match_reference(rng):
    n, K = 12, 8

    def sparse(shape, density):
        return (rng.integers(-300, 301, shape)
                * (rng.random(shape) < density)).astype(np.int32)

    args = [sparse((n, 16), .5), sparse((n, 16, 16), .2),
            sparse((n, 2, 4), .5), sparse((n, 2, 4, 16), .2)]
    ints = [rng.integers(0, 4, n), rng.integers(-40, 41, (n, 2)),
            rng.integers(0, 4, n), rng.integers(0, 4, n),
            rng.integers(0, 16, n), rng.integers(0, 3, n),
            rng.integers(0, 52, n), rng.integers(0, 5000, n),
            np.zeros(n)]
    ints = [f.astype(np.int32) for f in ints]
    bmode = rng.integers(0, 4, n).astype(np.int32)
    mvd1 = rng.integers(-40, 41, (n, 2)).astype(np.int32)
    t8 = np.zeros(n, bool)
    port = t_ep.cabac_blob(*map(T, args + ints), K=K, bmode=T(bmode),
                           mvd1=T(mvd1), t8=T(t8))
    ref = d_ep.cabac_blob(*map(jnp.asarray, args + ints), K=K,
                          bmode=jnp.asarray(bmode), mvd1=jnp.asarray(mvd1),
                          t8=jnp.asarray(t8))
    _eq(port, ref)
    assert t_ep.blob_stride(True) == d_ep.blob_stride(True)
    assert t_ep.blob_stride(True, True) == d_ep.blob_stride(True, True)


def _motion_frames(n, seed=3):
    """Soft texture panning 3 px right and 2 px down per frame, with a
    gradient patch in frame 1 that only intra predicts well."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 40, W + 40)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for t in range(n):
        y = big[2 * t:2 * t + H, 3 * t:3 * t + W].copy()
        if t == 1:
            yy, xx = np.mgrid[0:24, 0:40]
            y[16:40, 16:56] = 40 + 4 * yy + 3 * xx
        frames.append(tuple(np.ascontiguousarray(p.astype(np.uint8)) for p in
                            (y, big[t:t + H // 2, t:t + W // 2] // 2 + 40,
                             255 - big[t + 1:t + 1 + H // 2,
                                       t:t + W // 2])))
    return frames


@pytest.fixture(scope="module")
def b_core_case():
    """Anchors f0 (L0) and f2 (L1), B frames f1 and f3, the colocated
    field the true anchor motion (so direct wins) with noise on every
    fifth MB, and some colocated intra MBs."""
    fr = _motion_frames(4)
    n = (W // 16) * (H // 16)
    rng = np.random.default_rng(5)
    col_mv = np.broadcast_to(np.array([24, 16], np.int32), (n, 4, 2)).copy()
    col_mv[::5] += rng.integers(-6, 7, (len(col_mv[::5]), 4, 2)) \
        .astype(np.int32)
    col_intra = rng.random(n) < 0.15
    return fr, col_mv, col_intra


def _check_b_out(port, ref):
    assert set(port) == set(ref)
    for k in ref:
        _eq(port[k].to(torch.int64), np.asarray(ref[k]).astype(np.int64), k)


def test_b_frame_core_matches_reference(b_core_case):
    fr, col_mv, col_intra = b_core_case
    qp = 26
    kw = dict(mbw=W // 16, mbh=H // 16, me_range=8, cqp_off=0, subpel=2)
    port = b_frame.b_frame_core(*map(T, fr[1] + fr[0] + fr[2]), T(col_mv),
                                T(col_intra), 128, qp, sad_lambda(qp),
                                lv_cap=96, **kw)
    ref = b_frame_device.b_frame_core(
        *map(jnp.asarray, fr[1] + fr[0] + fr[2]), jnp.asarray(col_mv),
        jnp.asarray(col_intra), np.int32(128), np.int32(qp),
        np.int32(sad_lambda(qp)), entropy="cabac", lv_cap=96, **kw)
    _check_b_out(port, ref)
    # the case reaches every B mode and the intra escape
    assert set(port["bmode"].tolist()) == {0, 1, 2, 3}
    assert int((port["mb_class"] == 0).sum()) > 0


def test_b_pair_core_matches_reference(b_core_case):
    fr, col_mv, col_intra = b_core_case
    qps, dsfs = [26, 28], [85, 171]
    kw = dict(mbw=W // 16, mbh=H // 16, me_range=8, cqp_off=0, subpel=2)
    bs = (fr[1], fr[3])
    port = b_frame.b_pair_core(*[[T(f[c]) for f in bs] for c in range(3)],
                               *map(T, fr[0] + fr[2]), T(col_mv),
                               T(col_intra), dsfs, qps, sad_lambda(qps[0]),
                               lv_cap=96, **kw)
    ref = b_frame_device.b_pair_core(
        *[jnp.asarray(np.stack([f[c] for f in bs])) for c in range(3)],
        *map(jnp.asarray, fr[0] + fr[2]), jnp.asarray(col_mv),
        jnp.asarray(col_intra), np.asarray(dsfs, np.int32),
        np.asarray(qps, np.int32), np.int32(sad_lambda(qps[0])),
        entropy="cabac", lv_cap=96, **kw)
    for i in range(2):
        _check_b_out(port[i], {k: np.asarray(v)[i] for k, v in ref.items()})


# ---- streams ----

def _sine_frames(n, w=W, h=H, seed=0x264, flash_at=None):
    """tests/test_bframes.py's moving sine content; flash_at: a frame with
    a noise patch that neither anchor predicts (intra-in-B)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (120 + 70 * np.sin((xx + 5 * t) / 13.0)
             * np.cos((yy - 3 * t) / 19.0)).astype(np.uint8)
        y += rng.integers(0, 5, (h, w)).astype(np.uint8)
        if t == flash_at:
            y[16:48, 16:80] = rng.integers(0, 256, (32, 64))
        u = (128 + 40 * np.sin((xx[::2, ::2] + 5 * t) / 23.0)
             ).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[::2, ::2] + 7 * t) / 29.0)
             ).astype(np.uint8)
        frames.append(Frame420(y, u, v))
    return frames


def _params(ref=False, **kw):
    base = dict(width=W, height=H, qp=26, me_range=8, subpel=2, cabac=True,
                deblock=True, bframes=2, ref_frames=1, keyint_max=250,
                scenecut_threshold=0, backend="device")
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


def _encode(enc, frames):
    """Stream, recons keyed by display index, and for the port the
    mb_class of every B frame by display index."""
    recons, classes = {}, {}
    enc.recon_hook = recons.__setitem__
    fin = enc._finalize_b

    def spy(job):
        classes[job["disp"]] = job["out"]["mb_class"].numpy()
        return fin(job)

    if isinstance(enc, Encoder):
        enc._finalize_b = spy
    stream = b"".join(enc.encode(f) for f in frames) + enc.flush()
    return stream, recons, enc, classes


# name -> (settings, frames, flash frame); grouped so that one test
# encodes the cases that share the reference's compiled programs
STREAM_CASES = {
    "pair": {
        "bframes2": (dict(), 8, None),
        "full_recon_off": (dict(full_recon=False), 8, None),
        "p8x8": (dict(p8x8=True), 8, None),
        "qp51": (dict(qp=51), 6, None),
        "abr": (dict(rc_method=RC_ABR, bitrate=300), 8, None),
        # a noise flash at a B position (tests/test_bframes.py:_run_flash)
        "flash": (dict(), 8, 4),
    },
    "single": {
        "bframes1": (dict(bframes=1), 8, None),
        "bframes3": (dict(bframes=3), 9, None),
        "keyint6": (dict(keyint_max=6), 11, None),
    },
    "qp0": {"qp0": (dict(qp=0), 6, None)},
    # an odd size: cropped right and bottom, padded MBs in every core
    "odd": {"odd": (dict(width=ODD[0], height=ODD[1]), 4, None)},
}


def _check_decode(stream, recons, w, h, n, frames=None):
    dec = decode_annexb(stream, w, h)
    assert len(dec) == n == len(recons)
    for d in frames if frames is not None else range(n):
        for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                dec[d]):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec,
                                          err_msg=f"display {d}")


@pytest.mark.parametrize("group", list(STREAM_CASES))
def test_b_streams_match_reference_and_decode(group):
    """Per case: the port's stream equals the reference's, so do the
    access-unit logs (pts/dts), and avdec decodes the stream to the
    port's recon of every frame (with full_recon off, of the anchors:
    B recon is then left undeblocked, and the stream is the full_recon
    one)."""
    streams = {}
    for name, (kw, n, flash_at) in STREAM_CASES[group].items():
        frames = _sine_frames(n, kw.get("width", W), kw.get("height", H),
                              flash_at=flash_at)
        port = Encoder(_params(**kw), device="cpu")
        stream, recons, enc, classes = _encode(port, frames)
        ref = RefEncoder(_params(ref=True, **kw))
        assert stream == _encode(ref, frames)[0], name
        assert enc.drain_au_meta() == ref.drain_au_meta(), name
        streams[name] = stream
        types = [s.frame_type for s in enc.stats]
        assert "B" in types and types.count("IDR") == (
            2 if name == "keyint6" else 1), name
        p = port.p
        if name == "full_recon_off":
            assert stream == streams["bframes2"]
            _check_decode(stream, recons, p.width, p.height, n,
                          frames=[d for d in range(n) if d % 3 == 0])
        else:
            _check_decode(stream, recons, p.width, p.height, n)
        if flash_at is not None:
            assert (classes[flash_at] == 0).any(), \
                "the flash B frame coded no intra MB"


def test_poc_lsb_wrap_decodes():
    """135 frames at 32x32 with bframes=1 cross the POC LSB wrap (the
    reference's test_poc_lsb_wrap): temporal direct must use unwrapped
    POCs, and every frame decodes bit-exact."""
    frames = _sine_frames(135, 32, 32)
    stream, recons, enc, _ = _encode(
        Encoder(_params(width=32, height=32, qp=30, bframes=1),
                device="cpu"), frames)
    assert [s.frame_type for s in enc.stats].count("B") > 60
    _check_decode(stream, recons, 32, 32, len(frames))


def test_closed_b_settings_raise():
    for kw in (dict(me_range=32), dict(me_range=32, p8x8=True),
               dict(bframes=0, me_range=32)):
        with pytest.raises(NotImplementedError):
            Encoder(_params(**kw), device="cpu")
    for kw in (dict(b_adapt=1), dict(scenecut_threshold=40),
               dict(mbtree=True), dict(aq_mode=1),
               dict(mbtree=True, rc_method=RC_ABR, bitrate=500, b_adapt=1)):
        Encoder(_params(**kw), device="cpu")
    Encoder(_params(transform_8x8=True, trellis=1), device="cpu")
    Encoder(_params(weightp=1, ref_frames=2), device="cpu")
    Encoder(_params(bframes=0, me_range=32, p8x8=True), device="cpu")
    Encoder(_params(me_range=31), device="cpu")


# ---- the edge of the reference's band gather ----

def _edge_frames(step, n=4, w=W, h=H):
    """A contrasty soft texture moving ``step`` px per frame down and
    right (negative: up and left), so fullpel mvs sit at the range's
    edge and subpel windows reach past it."""
    rng = np.random.default_rng(1)
    s = abs(step) * n + 8
    big = rng.integers(0, 256, (h + s, w + s)).astype(np.int32)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    big = np.clip((big - 128) * 4 + 128, 0, 255).astype(np.uint8)
    frames = []
    for t in range(n):
        o = 4 + step * t if step > 0 else s - 4 + step * t
        frames.append(Frame420(*(np.ascontiguousarray(p) for p in (
            big[o:o + h, o:o + w], big[o:o + h:2, o:o + w:2] // 2 + 60,
            big[o + 1:o + h:2, o:o + w:2] // 2 + 50))))
    return frames


def test_b_stream_at_band_edge_matches_reference():
    """me_range 31, the largest the port runs with B frames, with motion
    of 32 px per frame both ways: the fullpel mvs reach the range's edge
    and the subpel and direct windows come closest to the edges of the
    reference's 80-row band without leaving it, so the streams agree
    (me_range 29 and 30 give smaller windows).  Then with P8x8 anchors,
    whose subpel windows the reference gathers from the whole padded
    plane (test_subpel_windows_stay_on_the_padded_plane)."""
    for kw in (dict(me_range=31, bframes=1),
               dict(me_range=31, bframes=1, p8x8=True)):
        _check_edge_streams(kw)


def _check_edge_streams(kw):
    for step in (32, -32):
        frames = _edge_frames(step)
        stream, recons, _, _ = _encode(Encoder(_params(**kw), device="cpu"),
                                       frames)
        assert stream == _encode(RefEncoder(_params(ref=True, **kw)),
                                 frames)[0], (kw, step)
        _check_decode(stream, recons, W, H, len(frames))


def test_p8x8_stream_at_range_32_matches_reference():
    """P8x8 with bframes=0 at me_range 32, the widest range the port runs,
    with motion of 32 px per frame both ways: the streams agree and
    decode bit-exact."""
    _check_edge_streams(dict(me_range=32, bframes=0, p8x8=True))


def test_reference_band_gather_fails_at_range_32():
    """At me_range 32 a fullpel mv of -32 starts the reference's subpel
    window one row above its band: the reference codes a stream that does
    not decode to its own recon, so the port refuses the range for P16
    and B frames (ROADMAP C)."""
    frames = _edge_frames(33)
    stream, recons, _, _ = _encode(
        RefEncoder(_params(ref=True, me_range=32, bframes=0)), frames)
    dec = decode_annexb(stream, W, H)
    assert any(not np.array_equal(np.asarray(recons[d].y)[:H, :W],
                                  dec[d][0]) for d in range(len(frames)))
    with pytest.raises(NotImplementedError):
        Encoder(_params(me_range=32, bframes=0), device="cpu")


def _scroll_pair(s, w=W, h=H):
    """A reference texture and the frame it becomes scrolled ``s`` px down
    and right (negative: up and left), the rows and columns that come in
    read from the reference's replicated border: the edge MBs' exact
    match then lies wholly in that border, as tempting as a far block at
    the frame's edge can be."""
    rng = np.random.default_rng(1)
    big = rng.integers(0, 256, (h, w)).astype(np.int32)
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
               + np.roll(big, (1, 1), (0, 1))) // 4
    ref = np.clip((big - 128) * 4 + 128, 0, 255).astype(np.uint8)
    pad = np.pad(ref, PAD, mode="edge")
    cur = pad[PAD - s:PAD - s + h, PAD - s:PAD - s + w].copy()
    return T(cur), T(pad)


@pytest.mark.parametrize("me_range", [29, 30, 31, 32])
def test_subpel_windows_stay_on_the_padded_plane(me_range):
    """The reference's P8x8 subpel refine (its CPU path) indexes the
    padded plane directly, where a row above or a column left of it
    wraps to the far side; the port's windows clamp there instead.  Both
    agree because no window reaches past the plane: the search never
    picks a block wholly in the replicated border, since a nearer one has
    the same SAD at fewer mv bits.  Held for both searches (esa_parts
    with its shape choice, and esa16 for P16 and B) and both directions
    of motion; the middle MBs do take mvs at the range's edge."""
    from x264_tpu_torch.kernels.esa16 import full_search_16x16
    from x264_tpu_torch.kernels.esa_parts import full_search_parts
    from x264_tpu_torch.ops.me_parts import choose_shape
    mbw, mbh = W // 16, H // 16
    lam = sad_lambda(26)
    mb = np.arange(mbw * mbh)
    for s in (me_range, -me_range):
        cur, pad = _scroll_pair(s)
        shape, mv8, _ = choose_shape(
            full_search_parts(cur, pad, lam, me_range, mbw, mbh), lam)
        mv16, _ = full_search_16x16(cur, pad, lam, me_range, mbw, mbh)
        # (unit top-left, fullpel mv, window size) as ops/me_parts.py and
        # ops/me.py gather them: from top-left + mv - 3, 15 and 23 wide
        q = np.array([[0, 0], [0, 8], [8, 0], [8, 8]])
        org8 = (np.stack([mb // mbw, mb % mbw], 1)[:, None] * 16
                + q[None]).reshape(-1, 2)
        org16 = np.stack([mb // mbw, mb % mbw], 1) * 16
        for org, mv, size in ((org8, mv8.numpy().reshape(-1, 2), 15),
                              (org16, mv16.numpy(), 23)):
            start = PAD + org + (mv[:, ::-1] >> 2) - 3       # (y, x)
            assert start.min() >= 0, (s, size)
            assert (start + size <= np.array(pad.shape)).all(), (s, size)
            assert np.abs(mv >> 2).max() == me_range, (s, size)
