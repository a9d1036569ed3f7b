"""Multi-slice frames, the fullpel-only search and the CLI of the port
against x264_tpu: ``mc_luma_fullpel`` and the single-mv ``mc_luma_qpel``
(on one plane and on stacked references), the P core at ``subpel`` 0 on
one and two references with CABAC and CAVLC, the B pair core at
``subpel`` 0, ``p_band_core`` on a middle band whose motion reaches into
the neighbouring bands, every output field equal; then streams
byte-identical to ``x264_tpu.api.Encoder`` and decoded bit-exact by
tools/avdec (libavcodec): 96x64 at 2, 3 (bands of 2, 1 and 1 MB rows) and
8 slices (clamped to 4 one-row bands) under CQP, CRF, ABR with VBV,
two-pass ABR and ``encode_pipelined``, ``threads`` 4 (the reference's
band mesh), a band re-run at the ladder's second rung with each coder,
and x264's ``ultrafast`` preset on one slice, with B frames and with tune
zerolatency on 4 slices; the reference's AQ with slices, whose streams
do not decode to its recon (ROADMAP C, fault 4), and the port's refusal
of it; and the port's CLI against the reference's on one y4m: the
.264, .mp4 and .mkv bytes and a two-pass run with slices, and its
refusals.  Seeded numpy inputs; tolerance 0 throughout.

The streams of one family share the reference's compiled programs, so a
family is one test: split over xdist workers, each would compile them
again.  For the same reason the reference's fault and the CLI run in
the CABAC family's test, whose streams use superfast's analysis."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

# a compile cache per xdist worker: the shared one has crashed a worker
os.environ.setdefault("X264_TPU_JAX_CACHE", os.path.join(
    tempfile.gettempdir(),
    f"x264_tpu_jax_{os.environ.get('PYTEST_XDIST_WORKER', 'main')}"))
jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from x264_tpu import cli as r_cli  # noqa: E402
from x264_tpu import params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import b_frame_device, inter_device  # noqa: E402
from x264_tpu.ops.device import mc as d_mc  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import cli as t_cli  # noqa: E402
from x264_tpu_torch import params as t_params  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.models import b_frame, inter, intra  # noqa: E402
from x264_tpu_torch.ops import mc as t_mc  # noqa: E402
from x264_tpu_torch.ops.header import B_BI, B_L0  # noqa: E402
from x264_tpu_torch.state import PAD, sad_lambda, to_port  # noqa: E402
from x264_tpu_torch.utils.y4m import write_y4m  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 96, 64
MBW, MBH = W // 16, H // 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.as_tensor(np.array(a))


def _eq_fields(port, ref):
    """Every field of the port's output equals the reference's."""
    assert "host_blob" in port and set(port) <= set(ref)
    for k in port:
        np.testing.assert_array_equal(
            port[k].to(torch.int64).numpy(),
            np.asarray(ref[k]).astype(np.int64), err_msg=k)


# ---- motion compensation ----

def test_mc_luma_fullpel_and_qpel_match_reference(rng):
    """Fullpel gathers at random fullpel mvs; quarter-pel gathers of one
    mv per MB at random qpel mvs (|mv| up to 24 px, every fraction) on
    one reference's half-pel planes and on three stacked, each MB at its
    own ref_idx."""
    n = MBW * MBH
    planes = [rng.integers(0, 256, (H, W)).astype(np.uint8)
              for _ in range(3)]
    pads = [np.pad(p, PAD, mode="edge") for p in planes]
    mv_fp = (4 * rng.integers(-24, 25, (n, 2))).astype(np.int32)
    np.testing.assert_array_equal(
        t_mc.mc_luma_fullpel(T(pads[0]), T(mv_fp), MBW, MBH, PAD).numpy(),
        np.asarray(d_mc.mc_luma_fullpel(jnp.asarray(pads[0]),
                                        jnp.asarray(mv_fp), MBW, MBH, PAD)))
    mv = rng.integers(-96, 97, (n, 2)).astype(np.int32)
    ref_idx = rng.integers(0, 3, n).astype(np.int32)
    p4 = [t_mc.hpel_planes(T(p)) for p in pads]
    r4 = [d_mc.hpel_planes(jnp.asarray(p)) for p in pads]
    np.testing.assert_array_equal(
        t_mc.mc_luma_qpel(p4[0], T(mv), MBW, MBH, PAD).numpy(),
        np.asarray(d_mc.mc_luma_qpel(r4[0], jnp.asarray(mv), MBW, MBH,
                                     PAD)))
    np.testing.assert_array_equal(
        t_mc.mc_luma_qpel(torch.stack(p4), T(mv), MBW, MBH, PAD,
                          ref_idx=T(ref_idx)).numpy(),
        np.asarray(d_mc.mc_luma_qpel(jnp.stack(r4), jnp.asarray(mv), MBW,
                                     MBH, PAD,
                                     ref_idx=jnp.asarray(ref_idx))))
    # a fullpel mv through the quarter-pel gather is the fullpel block
    np.testing.assert_array_equal(
        t_mc.mc_luma_qpel(p4[0], T(mv_fp), MBW, MBH, PAD).numpy(),
        t_mc.mc_luma_fullpel(T(pads[0]), T(mv_fp), MBW, MBH, PAD).numpy())


# ---- the cores ----

def _pan(n, seed=3, dx=3, dy=2, h=H, w=W):
    """Soft texture panning ``dx`` px right and ``dy`` px down per frame,
    with a gradient patch in frame 1 that only intra predicts well."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 60, w + 60)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    frames = []
    for t in range(n):
        y0, x0 = 30 + dy * t, 30 + dx * t
        y = big[y0:y0 + h, x0:x0 + w].copy()
        if t == 1:
            yy, xx = np.mgrid[0:24, 0:40]
            y[16:40, 16:56] = 40 + 4 * yy + 3 * xx
        frames.append(tuple(np.ascontiguousarray(p.astype(np.uint8)) for p in
                            (y, big[t:t + h // 2, t:t + w // 2] // 2 + 40,
                             255 - big[t + 1:t + 1 + h // 2,
                                       t:t + w // 2])))
    return frames


def _i_recon(f):
    """The I16 core's recon planes of a frame (the port's core, equal to
    the reference's: test_torch_cores.py), the references of the P and B
    cores below."""
    out = intra.i_frame_core(*map(T, f), 26, mbw=MBW, mbh=MBH, cqp_off=0,
                             lv_cap=96)
    return [out[k].numpy() for k in ("recon_y", "recon_u", "recon_v")]


@pytest.fixture(scope="module")
def pan_case():
    """Three frames of the pan and the I-core recons of the first two,
    the references of the third."""
    fr = _pan(3)
    return fr, [_i_recon(fr[0]), _i_recon(fr[1])]


@pytest.mark.parametrize("refs,cabac", [(1, True), (1, False), (2, True),
                                        (2, False)])
def test_p_core_fullpel_matches_reference(pan_case, refs, cabac):
    """The P core at subpel 0 on one reference (the fullpel gather) and
    on two (the quarter-pel gather at each MB's ref_idx), each coder:
    every field equals the reference core's; the mvs are fullpel and, on
    two references, some MBs take the older one."""
    fr, recons = pan_case
    qp = 26
    planes = [np.stack([recons[1][c], recons[0][c]]) if refs == 2
              else recons[1][c] for c in range(3)]
    kw = dict(mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=0)
    ekw = dict(entropy="cabac", lv_cap=96) if cabac else dict(n_words=64)
    ref = inter_device.p_frame_core(
        *map(jnp.asarray, fr[2]), *map(jnp.asarray, planes), np.int32(qp),
        np.int32(sad_lambda(qp)), **kw, **ekw)
    ekw.pop("entropy", None)
    port = inter.p_frame_core(*map(T, fr[2]), *to_port(planes, "cpu"), qp,
                              sad_lambda(qp), **kw, **ekw)
    _eq_fields(port, ref)
    assert not (port["mv"] & 3).any()
    if refs == 2:
        assert int((port["ref_mb"] > 0).sum()) > 0


def test_b_pair_core_fullpel_matches_reference(pan_case):
    """Both B frames of a pair at subpel 0 between two anchors: every
    field of each equals the reference pair core's."""
    fr, recons = pan_case
    bfr = _pan(5, seed=4)
    n = MBW * MBH
    rng = np.random.default_rng(5)
    col_mv = np.broadcast_to(np.array([12, 8], np.int32), (n, 4, 2)).copy()
    col_mv[::5] += rng.integers(-6, 7, (len(col_mv[::5]), 4, 2)) \
        .astype(np.int32)
    col_intra = rng.random(n) < 0.15
    qps, dsfs = [26, 28], [85, 171]
    kw = dict(mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=0)
    bs = (bfr[1], bfr[3])
    anchors = recons[0] + recons[1]
    port = b_frame.b_pair_core(*[[T(f[c]) for f in bs] for c in range(3)],
                               *map(T, anchors), T(col_mv), T(col_intra),
                               dsfs, qps, sad_lambda(qps[0]), n_words=64,
                               **kw)
    ref = b_frame_device.b_pair_core(
        *[jnp.asarray(np.stack([f[c] for f in bs])) for c in range(3)],
        *map(jnp.asarray, anchors), jnp.asarray(col_mv),
        jnp.asarray(col_intra), np.asarray(dsfs, np.int32),
        np.asarray(qps, np.int32), np.int32(sad_lambda(qps[0])),
        entropy="cavlc", n_words=64, **kw)
    for i in range(2):
        _eq_fields(port[i], {k: np.asarray(v)[i] for k, v in ref.items()})
        # the explicit L0 and bi MBs take the search's fullpel mvs
        expl = (port[i]["bmode"] == B_L0) | (port[i]["bmode"] == B_BI)
        assert bool(expl.any()) and not (port[i]["mv0"][expl] & 3).any()


def test_p_band_core_matches_reference():
    """The middle band (MB rows 1-2) of a 96x64 frame whose content moves
    7 px up and 2 px right, on the band's rows of the padded reference:
    every field equals the reference's ``p_band_core``, and MBs of the
    band's bottom row take mvs whose blocks read rows of the band below
    (real pixels there, not replicated ones)."""
    fr = _pan(2, seed=6, dx=-2, dy=7)
    rec = _i_recon(fr[0])
    y0, bh = 1, 2
    pads = [np.pad(rec[0], PAD, mode="edge"),
            np.pad(rec[1], PAD // 2, mode="edge"),
            np.pad(rec[2], PAD // 2, mode="edge")]
    bands = [pads[0][16 * y0:16 * (y0 + bh) + 2 * PAD],
             pads[1][8 * y0:8 * (y0 + bh) + PAD],
             pads[2][8 * y0:8 * (y0 + bh) + PAD]]
    src = [fr[1][0][16 * y0:16 * (y0 + bh)],
           fr[1][1][8 * y0:8 * (y0 + bh)], fr[1][2][8 * y0:8 * (y0 + bh)]]
    qp = np.arange(26, 26 + MBW * bh, dtype=np.int32) % 6 + 24
    kw = dict(mbw=MBW, mbh=bh, me_range=8, cqp_off=0, subpel=1)
    ref = inter_device.p_band_core(
        *map(jnp.asarray, src), *map(jnp.asarray, bands), jnp.asarray(qp),
        np.int32(sad_lambda(26)), entropy="cabac", lv_cap=96, **kw)
    port = inter.p_band_core(*map(T, src), *map(T, bands), T(qp),
                             sad_lambda(26), lv_cap=96, **kw)
    _eq_fields(port, ref)
    mvy = port["mv"][:, 1].reshape(bh, MBW)
    inter_mb = (port["mb_class"] != 0).reshape(bh, MBW)
    # the content moved up: the blocks come from 7 rows below, so the
    # band's bottom MBs read the band below
    assert bool(((mvy[bh - 1] > 0) & inter_mb[bh - 1]).any())
    assert int(mvy.max()) >= 4 * 6


# ---- streams ----

def _clip(n, w=W, h=H, seed=5):
    """A pan over a sine field with a little noise and moving chroma."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = np.clip(120 + 70 * np.sin((xx + 5 * t) / 9.0)
                    * np.cos((yy - 3 * t) / 11.0)
                    + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin((xx[::2, ::2] + t) / 23.0)).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[::2, ::2] - t) / 29.0)).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _noise(n, w=W, h=H, seed=9):
    """Uniform noise: at a low QP every band's blob passes the first rung
    of the entropy ladder."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, s).astype(np.uint8)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


def _sliced(P, **kw):
    """The superfast preset's analysis (range 8, subpel 1) at QP 26, so
    that the CLI's runs reuse the reference's compiled programs."""
    base = dict(width=W, height=H, qp=26, me_range=8, subpel=1,
                cabac=True, keyint_max=250, fps_num=25)
    base.update(kw)
    return P.EncoderParams(**base)


def _ultrafast(P, tune=None, **kw):
    base = dict(width=W, height=H, rc_method=P.RC_CRF, crf=23.0,
                fps_num=25)
    base.update(kw)
    return P.param_default_preset("ultrafast", tune=tune).clone(**base)


def _encode(side, params, frames, mode="encode"):
    """Encode ``frames`` on one side (the port on the CPU or the
    reference).  Returns the stream, the stats, the band re-runs (band,
    rung), the stats file written at close (when asked) and, for the
    port, its recons by display index and the final recon."""
    enc = (Encoder(params, device="cpu") if side == "port"
           else RefEncoder(params))
    fr_t = Frame420 if side == "port" else RefFrame
    reruns = []
    rerun = enc._rerun_band

    def spy(job, b, n_words):
        reruns.append((b, n_words))
        return rerun(job, b, n_words)

    enc._rerun_band = spy
    recons = {}
    enc.recon_hook = recons.__setitem__
    stream = b""
    for f in frames:
        stream += (enc.encode_pipelined(fr_t(*f)) if mode == "pipelined"
                   else enc.encode(fr_t(*f)))
    stream += enc.flush()
    enc.close()
    stats = None
    if params.stats_write:
        with open(params.stats_write) as f:
            stats = f.read()
    return dict(stream=stream, reruns=reruns, recons=recons,
                stats=[(s.frame_type, s.qp, s.bits) for s in enc.stats],
                statsfile=stats, last=enc.last_recon, enc=enc)


def _two_pass(P, path, **kw):
    """Pass 1 writes ``path``, pass 2 reads it."""
    def make(which):
        return _sliced(P, rc_method=P.RC_ABR, bitrate=100, **kw,
                       **({"stats_write": path} if which == 1
                          else {"stats_read": path}))
    return make


# family -> stream -> (params maker, frames, encode mode, checks); the
# params maker takes the package's params module and a scratch path
FAMILIES = {
    # CABAC: 2 slices (bands of 2 MB rows), 3 (2, 1, 1) and 8 (clamped to
    # 4 one-row bands); CQP, CRF, ABR under VBV, two-pass and
    # encode_pipelined; CRF with mbtree asked for (off with slices); a noisy
    # clip at QP 20 re-runs bands at rung 408
    "cabac": {
        "cqp_2": (lambda P, d: _sliced(P, slices=2), "clip", "encode",
                  dict(nal=2)),
        "crf_3": (lambda P, d: _sliced(P, slices=3, rc_method=P.RC_CRF,
                                       crf=26.0), "clip", "encode",
                  dict(nal=3)),
        "vbv_8": (lambda P, d: _sliced(
            P, slices=8, rc_method=P.RC_ABR, bitrate=80, vbv_maxrate=80,
            vbv_bufsize=20), "clip", "encode", dict(nal=4)),
        "pass1_3": (lambda P, d: _two_pass(P, d + "_cabac.log",
                                           slices=3)(1), "clip", "encode",
                    dict(nal=3, stats=True)),
        "pass2_3": (lambda P, d: _two_pass(P, d + "_cabac.log",
                                           slices=3)(2), "clip", "encode",
                    dict(nal=3)),
        "pipelined_2": (lambda P, d: _sliced(P, slices=2), "clip",
                        "pipelined", dict(nal=2)),
        "crf_mbtree_2": (lambda P, d: _sliced(
            P, slices=2, rc_method=P.RC_CRF, crf=23.0, mbtree=True),
            "clip", "encode", dict(nal=2)),
        "rerun_2": (lambda P, d: _sliced(P, slices=2, qp=20), "noise",
                    "encode", dict(nal=2, rerun=408)),
    },
    # the same with CAVLC, threads 4 on 4 slices (the reference codes the
    # P frames on its band mesh), and a re-run at 416 words at QP 12
    "cavlc": {
        "cqp_2": (lambda P, d: _sliced(P, slices=2, cabac=False), "clip",
                  "encode", dict(nal=2)),
        "crf_3": (lambda P, d: _sliced(P, slices=3, cabac=False,
                                       rc_method=P.RC_CRF, crf=26.0),
                  "clip", "encode", dict(nal=3)),
        "vbv_8": (lambda P, d: _sliced(
            P, slices=8, cabac=False, rc_method=P.RC_ABR, bitrate=80,
            vbv_maxrate=80, vbv_bufsize=20), "clip", "encode", dict(nal=4)),
        "pass1_3": (lambda P, d: _two_pass(P, d + "_cavlc.log", slices=3,
                                           cabac=False)(1), "clip",
                    "encode", dict(nal=3, stats=True)),
        "pass2_3": (lambda P, d: _two_pass(P, d + "_cavlc.log", slices=3,
                                           cabac=False)(2), "clip",
                    "encode", dict(nal=3)),
        "pipelined_2": (lambda P, d: _sliced(P, slices=2, cabac=False),
                        "clip", "pipelined", dict(nal=2)),
        "threads_4": (lambda P, d: _sliced(P, slices=4, threads=4,
                                           cabac=False), "clip", "encode",
                      dict(nal=4)),
        "rerun_2": (lambda P, d: _sliced(P, slices=2, cabac=False, qp=12),
                    "noise", "encode", dict(nal=2, rerun=416)),
    },
    # x264's ultrafast preset (fullpel only, CAVLC, no deblock) at CRF 23
    "ultrafast": {
        "one_slice": (lambda P, d: _ultrafast(P), "clip", "encode",
                      dict(nal=1)),
        "bframes_2": (lambda P, d: _ultrafast(P, bframes=2), "clip",
                      "encode", dict(nal=1, b=True)),
        "zerolatency_4": (lambda P, d: _ultrafast(P, tune="zerolatency",
                                                  slices=4), "clip",
                          "encode", dict(nal=4)),
    },
}
N_FRAMES = {"clip": 5, "noise": 3}


def _slice_nals(stream):
    """The first_mb of every slice NAL (types 1 and 5), by frame."""
    from x264_tpu.bitstream.bits import BitReader
    from x264_tpu.bitstream.nal import split_annexb, unescape_rbsp
    frames = []
    for nal in split_annexb(stream):
        if nal[0] & 31 in (1, 5):
            first_mb = BitReader(unescape_rbsp(nal[1:])).ue()
            if first_mb == 0:
                frames.append([])
            frames[-1].append(first_mb)
    return frames


def _aq_rows(n, seed=1):
    """MB rows that alternate between a textured field and a flat ramp
    (AQ gives them QPs far apart), and a strip of fresh noise each frame:
    the MBs at a band's start are skipped or carry no residual, so they
    take their QP from the QP chain."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    base = np.where((yy // 16) % 2 == 0,
                    np.clip(128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0),
                            0, 255), 100.0 + xx % 3)
    frames = []
    for _ in range(n):
        y = base.copy()
        y[:, 40:60] = np.clip(base[:, 40:60] + rng.normal(0, 20, (H, 20)),
                              0, 255)
        frames.append((y.astype(np.uint8),
                       np.full((H // 2, W // 2), 128, np.uint8),
                       np.full((H // 2, W // 2), 128, np.uint8)))
    return frames


def _check_reference_aq_fault():
    """Fault 4, the reference's own (ROADMAP C): it deblocks a multi-slice
    frame along one QP chain over the whole frame, so an MB at a band's
    start that carries its QP takes the band above's, where the decoder
    takes the slice QP.  With AQ's per-MB QPs its stream then does not
    decode to its own recon (on one slice it does: test_torch_lookahead.py's
    AQ streams); the port refuses AQ with slices
    (``test_port_refuses_aq_with_slices``)."""
    frames = _aq_rows(3)
    enc = RefEncoder(_sliced(r_params, slices=3, qp=30, aq_mode=1,
                             aq_strength=2.0))
    recons = {}
    enc.recon_hook = recons.__setitem__
    stream = b"".join(enc.encode(RefFrame(*f)) for f in frames)
    dec = decode_annexb(stream, W, H)
    assert np.array_equal(np.asarray(recons[0].y)[:H, :W], dec[0][0])
    assert not np.array_equal(np.asarray(recons[1].y)[:H, :W], dec[1][0])


def _check_cli(tmp_path):
    """The port's CLI (--device cpu) and the reference's on one y4m:
    equal .264, .mp4 and .mkv bytes (superfast on 3 slices at QP 26), a
    two-pass ABR run whose passes and stats files are equal, and
    ``python -m x264_tpu_torch`` the same bytes as ``cli.main``."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, [RefFrame(*f) for f in _clip(4)], (25, 1))
    base = ["--preset", "superfast", "--slices", "3", "--quiet", src]

    def run(side, out, *extra):
        main = t_cli.main if side == "port" else r_cli.main
        dev = ["--device", "cpu"] if side == "port" else []
        assert main([*base, "-o", out, *extra, *dev]) == 0
        with open(out, "rb") as f:
            return f.read()

    for ext in ("264", "mp4", "mkv"):
        outs = [run(s, str(tmp_path / f"{s}.{ext}"), "--qp", "26")
                for s in ("port", "ref")]
        assert outs[0] == outs[1] and len(outs[0]) > 500, ext
    for p in (1, 2):
        outs, stats = [], []
        for s in ("port", "ref"):
            log = str(tmp_path / f"{s}.log")
            outs.append(run(s, str(tmp_path / f"{s}_pass{p}.264"),
                            "--bitrate", "100", "--pass", str(p), "--stats",
                            log))
            with open(log) as f:
                stats.append(f.read())
        assert outs[0] == outs[1], f"pass {p}"
        assert stats[0] == stats[1] and stats[0], f"pass {p}"
    out = str(tmp_path / "module.264")
    r = subprocess.run([sys.executable, "-m", "x264_tpu_torch", "--device",
                        "cpu", *base, "-o", out, "--qp", "26"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    with open(out, "rb") as f, open(str(tmp_path / "ref.264"), "rb") as g:
        assert f.read() == g.read()


# checks that run inside a family's test, on the reference's programs
# that its streams compiled
FAMILY_EXTRAS = {"cabac": (lambda tmp: _check_reference_aq_fault(),
                           _check_cli)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sliced_streams_match_reference_and_decode(family, tmp_path):
    """For every stream of the family: the bytes, frame types, QPs and
    sizes, the band re-runs and, in a first pass, the stats file equal
    the reference's; the frames hold the expected slices (first MBs at
    the band starts); avdec decodes the stream to the port's recon of
    every frame (the final recon with ``encode_pipelined``).  Then the
    family's extra checks, which reuse its compiled programs: with the
    CABAC family, the reference's AQ fault with slices and the CLI
    against the reference's."""
    content = {"clip": _clip(N_FRAMES["clip"]),
               "noise": _noise(N_FRAMES["noise"])}
    for name, (make, clip, mode, checks) in FAMILIES[family].items():
        frames = content[clip]
        d = str(tmp_path / "stats")
        port = _encode("port", make(t_params, d + "_port"), frames, mode)
        ref = _encode("ref", make(r_params, d + "_ref"), frames, mode)
        assert port["stats"] == ref["stats"], name
        assert port["stream"] == ref["stream"], name
        assert port["reruns"] == ref["reruns"], name
        assert port["statsfile"] == ref["statsfile"], name
        if checks.get("stats"):
            assert port["statsfile"], name
        n = len(frames)
        nals = _slice_nals(port["stream"])
        assert len(nals) == n, name
        assert all(len(f) == checks["nal"] for f in nals), (name, nals)
        if checks["nal"] == 3:
            assert nals[0] == [0, 2 * MBW, 3 * MBW], nals
        if "rerun" in checks:
            assert port["reruns"] and \
                {r for _, r in port["reruns"]} == {checks["rerun"]}, name
        if checks.get("b"):
            assert "B" in [s[0] for s in port["stats"]], name
        dec = decode_annexb(port["stream"], W, H)
        assert len(dec) == n, name
        if mode == "pipelined":
            np.testing.assert_array_equal(port["last"].y[:H, :W].numpy(),
                                          dec[-1][0], err_msg=name)
            continue
        for i, planes in enumerate(dec):
            r = port["recons"][i]
            for p_rec, p_dec in zip((r.y, r.u, r.v), planes):
                hh, ww = p_dec.shape
                np.testing.assert_array_equal(
                    p_rec[:hh, :ww].numpy(), p_dec,
                    err_msg=f"{name}: display {i}")
    for extra in FAMILY_EXTRAS.get(family, ()):
        extra(tmp_path)


def test_port_refuses_aq_with_slices():
    """AQ with slices raises, at open and at reconfig (ROADMAP C, fault 4:
    the reference's streams stop decoding to its recon; the CABAC family
    test shows it), as do the CLI's refused options, through
    _check_params with its message."""
    with pytest.raises(NotImplementedError, match="aq_mode"):
        Encoder(_sliced(t_params, slices=3, aq_mode=1), device="cpu")
    enc = Encoder(_sliced(t_params, slices=3), device="cpu")
    with pytest.raises(NotImplementedError, match="aq_mode"):
        enc.reconfig(aq_mode=1)
    Encoder(_sliced(t_params, slices=1, aq_mode=1), device="cpu")


def test_mbtree_is_off_with_slices():
    """MB-tree runs only on one slice, as in the reference (its
    ``_mbtree_on`` reads ``slices``); the sliced streams under CRF with
    ``mbtree`` on are the reference's (the "crf_mbtree_2" stream)."""
    for slices, on in ((1, True), (2, False)):
        kw = dict(slices=slices, rc_method=t_params.RC_CRF, mbtree=True)
        assert Encoder(_sliced(t_params, **kw),
                       device="cpu")._mbtree_on() == on
        assert RefEncoder(_sliced(r_params, **kw))._mbtree_on() == on


def test_cli_refuses_what_the_port_does_not_run(tmp_path):
    """An option the port does not run fails through _check_params with
    its message (the CLI's bytes against the reference's: the CABAC
    family test)."""
    src = str(tmp_path / "in.y4m")
    write_y4m(src, [RefFrame(*f) for f in _clip(1)], (25, 1))
    for opts, key in ((["--merange", "32"], "me_range"),
                      (["--slices", "2", "--aq-mode", "1"], "aq_mode"),
                      (["--p8x8", "--merange", "40"], "me_range")):
        with pytest.raises(NotImplementedError, match=key):
            t_cli.main(["--preset", "superfast", "--quiet", src, "-o",
                        str(tmp_path / "x.264"), "--device", "cpu", *opts])
