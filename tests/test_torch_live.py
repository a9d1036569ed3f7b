"""The live-streaming slice of the port against x264_tpu: the refresh bar's
plain twin against the reference's ``_pir_column_pass``, the P core with
the bar against the reference's, and streams byte-identical to
``x264_tpu.api.Encoder`` and decoded bit-exact by tools/avdec
(libavcodec): periodic intra refresh (CABAC with I4x4, the 8x8
transform and trellis; CAVLC P16), ``intra_refresh()`` with and without
it, ``invalidate_reference``, VBV with its frame re-encode (CABAC,
CAVLC, B frames with MB-tree, ``encode_pipelined``), NAL HRD timing
SEI, ``reconfig`` and ``delayed_frames``, and the headline preset
(medium, zerolatency, CRF 23, VBV, NAL HRD, intra refresh at keyint 60)
at 96x64.  Tolerance 0 throughout.

The streams of one family share the reference's compiled programs, so a
family is one test: split over xdist workers, each would compile them
again."""

import os
import re
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
from x264_tpu import params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.bitstream.tables import CHROMA_QP_TABLE  # noqa: E402
from x264_tpu.models import inter_device, intra_device  # noqa: E402
from x264_tpu.models.inter_frame import me_lambda, sad_lambda  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import params as t_params  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.kernels import pir_column as K  # noqa: E402
from x264_tpu_torch.models import inter  # noqa: E402
from x264_tpu_torch.state import to_port  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 96, 64


def T(a):
    return torch.as_tensor(np.array(a))


# ---- the refresh bar ----

def _bar_inputs(rng, mbw, mbh, qp_map):
    """Source planes, live recon planes (int32), QPs and per-MB fields
    holding junk the bar must overwrite at its MBs only."""
    h, w = 16 * mbh, 16 * mbw
    n = mbw * mbh
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(128 + 70 * np.sin(xx / 7.0 + yy / 11.0)
                + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)
    u = rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
    v = (255 - u[::-1]).astype(np.uint8)
    rec = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    qp = (rng.integers(12, 48, n) if qp_map else np.full(n, 26)) \
        .astype(np.int32)
    qpc = CHROMA_QP_TABLE[np.clip(qp + 2, 0, 51)].astype(np.int32)
    acc = {k: (rng.integers(0, 2, (n, *s)).astype(bool)
               if k in ("intra_mask", "t8")
               else rng.integers(-3, 4, (n, *s)).astype(np.int32))
           for k, s in K._FIELDS}
    return (y, u, v), rec, qp, qpc, acc


@pytest.mark.parametrize("col,ncols,qp_map", [
    (0, 1, False), (2, 1, True), (1, 3, True), (4, 3, True), (5, 3, False),
    (2, 6, True)])
def test_pir_column_plain_matches_reference(rng, col, ncols, qp_map):
    """One and three columns on 6 x 3 MBs, bars reaching past the right
    edge (masked columns), a per-MB QP map; and six columns on 8 x 4 MBs,
    a bar wider than the frame is tall (the kernel's wavefront then has
    diagonals of 4 MBs): the twin's planes and fields equal the
    reference's."""
    mbw, mbh = (8, 4) if ncols > 3 else (6, 3)
    src, rec, qp, qpc, acc = _bar_inputs(rng, mbw, mbh, qp_map)
    ref = inter_device._pir_column_pass(
        *map(jnp.asarray, src), *map(jnp.asarray, rec),
        {k: jnp.asarray(a) for k, a in acc.items()}, jnp.asarray(qp),
        jnp.asarray(qpc), jnp.asarray(col, jnp.int32), mbw, mbh, ncols)
    port = K.pir_column_pass(*map(T, src), *(T(r.copy()) for r in rec),
                             {k: T(a.copy()) for k, a in acc.items()},
                             T(qp), T(qpc), col, mbw, mbh, ncols)
    for name, p, r in zip(("ry", "ru", "rv"), port[:3], ref[:3]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r),
                                      err_msg=name)
    for k in K.FIELDS:
        np.testing.assert_array_equal(port[3][k].numpy(),
                                      np.asarray(ref[3][k]), err_msg=k)
    live = min(ncols, mbw - col) * mbh
    assert int(port[3]["intra_mask"].sum()) >= live
    assert K.bar_mbs(col, ncols, mbw, mbh) == live


MBW, MBH = 5, 3


def _pframes(rng):
    """A textured frame and the next one panned by (3, -5) px with a patch
    the reference lacks: the MBs left of the bar want mvx beyond the
    clamp, some MBs go intra-in-P."""
    h, w = 16 * MBH, 16 * MBW
    tex = rng.integers(0, 256, (h + 16, w + 16)).astype(np.int32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) // 3
    y0 = tex[8:8 + h, 8:8 + w].astype(np.uint8)
    y1 = tex[5:5 + h, 13:13 + w].astype(np.uint8).copy()
    yy, xx = np.mgrid[0:16, 0:16]
    y1[16:32, 48:64] = (40 + 6 * yy + 3 * xx).astype(np.uint8)
    u0 = tex[::2, ::2][:h // 2, :w // 2].astype(np.uint8)
    v0 = (255 - tex[1::2, 1::2][:h // 2, :w // 2]).astype(np.uint8)
    return (y0, u0, v0), (y1, np.roll(u0, 2, 1).copy(),
                          np.roll(v0, 1, 0).copy())


@pytest.mark.parametrize("parts,cabac", [(True, True), (False, False)])
def test_p_frame_core_with_pir_matches_reference(rng, parts, cabac):
    """The P core with a two-column bar at column 1 under a per-MB QP map,
    P8x8 with CABAC, the 8x8 transform and trellis, and P16 with CAVLC
    (P16 with CABAC runs in the headline streams): every field equals the
    reference core's, the bar is intra and the MBs left of it were held
    back by the mv clamp."""
    from x264_tpu.ops.device.trellis import frame_trellis as r_ft
    from x264_tpu_torch.ops.trellis import frame_trellis as t_ft
    f0, f1 = _pframes(rng)
    qp = rng.integers(22, 32, MBW * MBH).astype(np.int32)
    rec = intra_device.i_frame_core(*map(jnp.asarray, f0), np.int32(26),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    entropy="cabac", lv_cap=96)
    planes = [np.asarray(rec[k]) for k in ("recon_y", "recon_u", "recon_v")]
    lam = sad_lambda(26)
    tools = parts and cabac
    kw = dict(mbw=MBW, mbh=MBH, me_range=16, cqp_off=0, subpel=2,
              parts=parts, t8=tools, pir_ncols=2)
    ekw = dict(entropy="cabac", lv_cap=96) if cabac else dict(n_words=64)
    ref = inter_device.p_frame_core(
        *map(jnp.asarray, f1), *map(jnp.asarray, planes), jnp.asarray(qp),
        np.int32(lam), pir_col=np.int32(1), pir_bound=np.int32(16),
        trellis_tbl=r_ft(26, "P", me_lambda(26), True) if tools else None,
        **kw, **ekw)
    ekw.pop("entropy", None)
    port = inter.p_frame_core(
        *map(T, f1), *to_port(planes, "cpu"), T(qp), lam, pir_col=1,
        pir_bound=16,
        trellis_tbl=t_ft(26, "P", me_lambda(26), True) if tools else None,
        **kw, **ekw)
    assert "host_blob" in port and set(port) <= set(ref)
    for k in port:
        np.testing.assert_array_equal(
            port[k].to(torch.int64).numpy(),
            np.asarray(ref[k]).astype(np.int64), err_msg=k)
    cls = port["mb_class"].reshape(MBH, MBW)
    assert (cls[:, 1:3] == 0).all()
    # the pan wants mvx of about +20 qpel; left of the bar the clamp
    # holds the search start at -32 (P16) or 0 and -32 (quadrants) and
    # the subpel refine moves it a few qpel
    mvx = port["mv8"][..., 0] if parts else port["mv"][:, None, 0]
    assert int(mvx.reshape(MBH, MBW, -1)[:, 0].max()) <= 8


# ---- streams ----

def _clip(n, w=W, h=H, seed=5, cut=4):
    """A pan over a sine field with a little noise and moving chroma (P
    MBs with motion, some intra-in-P; an IDR at CRF 23 stays within the
    first CABAC rung); from frame ``cut`` on, another, busier scene (a P
    frame there costs more than a tight VBV buffer holds)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        f = 1.0 if t < cut else 0.45
        y = np.clip(120 + 70 * np.sin((xx + 5 * t) * f / 9.0)
                    * np.cos((yy - 3 * t) / (11.0 * f))
                    + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        u = (128 + 40 * np.sin((xx[::2, ::2] + t) / 23.0)).astype(np.uint8)
        v = (128 + 40 * np.cos((yy[::2, ::2] - t) / 29.0)).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _headline(P, **kw):
    """The live configuration at 96x64: medium with tune zerolatency
    (I4x4, the 8x8 transform, trellis, weightp=1, CABAC, no B frames, no
    lookahead) on P16 anchors (intra refresh with P8x8 is refused:
    ROADMAP C, fault 3), CRF 23, a VBV cap, NAL HRD and intra refresh at
    keyint 60."""
    base = dict(width=W, height=H, rc_method=P.RC_CRF, crf=23.0,
                vbv_maxrate=40, vbv_bufsize=8, nal_hrd=True,
                intra_refresh=True, keyint_max=60, fps_num=30, p8x8=False)
    base.update(kw)
    return P.param_default_preset("medium", tune="zerolatency").clone(
        **base)


def _cavlc(P, **kw):
    base = dict(width=W, height=H, qp=28, me_range=8, cabac=False,
                keyint_max=5, fps_num=25)
    base.update(kw)
    return P.EncoderParams(**base)


def _bframes(P, **kw):
    """B frames (bframes=2, CABAC, P16 anchors) at CRF 26 with MB-tree, a
    VBV cap and NAL HRD: VBV's B path, the medium preset's without its
    tools (test_torch_lookahead.py holds the whole preset; at CRF 26 every
    frame stays on the first CABAC rung)."""
    base = dict(width=W, height=H, cabac=True, bframes=2, me_range=8,
                rc_method=P.RC_CRF, crf=26.0, mbtree=True, rc_lookahead=3,
                vbv_maxrate=50, vbv_bufsize=10, nal_hrd=True, keyint_min=4,
                fps_num=25)
    base.update(kw)
    return P.EncoderParams(**base)


def _encode(side, params, frames, mode="encode", calls=None):
    """Encode ``frames`` on one side (the port on the CPU or the
    reference); ``calls`` maps a frame index to a function called on the
    encoder before that frame.  Returns the stream, the stats, the
    delayed-frame count after every call, the access-unit sizes, the VBV
    re-encodes and the encoder; for the port also its recons by display
    index and its final recon."""
    enc = (Encoder(params, device="cpu") if side == "port"
           else RefEncoder(params))
    fr_t = Frame420 if side == "port" else RefFrame
    retries = []
    reencode = enc._vbv_reencode

    def counted(job, nq):
        retries.append((job["ftype"], job["qp"], nq))
        return reencode(job, nq)

    enc._vbv_reencode = counted
    recons = {}
    enc.recon_hook = recons.__setitem__
    stream, delayed = b"", []
    for i, f in enumerate(frames):
        if calls and i in calls:
            calls[i](enc)
        stream += (enc.encode_pipelined(fr_t(*f)) if mode == "pipelined"
                   else enc.encode(fr_t(*f)))
        delayed.append(enc.delayed_frames())
    stream += enc.flush()
    delayed.append(enc.delayed_frames())
    return dict(stream=stream,
                stats=[(s.frame_type, s.qp, s.bits) for s in enc.stats],
                delayed=delayed, aus=[m["bytes"] for m in
                                      enc.drain_au_meta()],
                retries=retries, recons=recons, last=enc.last_recon,
                enc=enc)


def _refresh(enc):
    enc.intra_refresh()


def _invalidate(n):
    def call(enc):
        assert enc.invalidate_reference(n) == 1
    return call


def _reconfig(**kw):
    return lambda enc: enc.reconfig(**kw)


def _nal_types(stream):
    return [stream[m.end()] & 31
            for m in re.finditer(b"\x00\x00\x01", stream)]


def _sei_payload_types(stream):
    """The payload type of every SEI NAL (the first byte after its
    header)."""
    return [stream[m.end() + 1] for m in re.finditer(b"\x00\x00\x01",
                                                     stream)
            if stream[m.end()] & 31 == 6]


def _walk(run):
    """The decoder-buffer walk over the access units (refill at
    vbv_maxrate, then take the frame): no frame may underflow it."""
    rc, p = run["enc"].rc, run["enc"].p
    fill = rc.vbv_size * p.vbv_init
    for nb in run["aus"]:
        fill = min(fill + rc.vbv_max / rc.fps, rc.vbv_size)
        assert nb * 8 <= fill + 1e-6, (nb * 8, fill)
        fill -= nb * 8


def _check_sweeps(run, sweeps, bars):
    """One IDR and then P frames; ``sweeps`` recovery-point SEIs and at
    least ``bars`` P frames' worth of bar MBs."""
    types = [s[0] for s in run["stats"]]
    assert types[0] == "IDR" and set(types[1:]) == {"P"}, types
    assert _nal_types(run["stream"]).count(5) == 1
    assert _sei_payload_types(run["stream"]).count(6) == sweeps
    assert run["enc"]._agg["P"]["imb"] >= run["enc"].p.mb_height * bars


def _check_hrd(run):
    """A buffering-period SEI at every IDR, a pic-timing SEI per frame."""
    types = [s[0] for s in run["stats"]]
    sei = _sei_payload_types(run["stream"])
    assert sei.count(0) == types.count("IDR") and sei.count(1) == len(types)


# family -> stream -> (params maker, frames, encode mode, calls, checks):
# the streams of a family share the reference's compiled programs, so a
# family is one test; ``checks`` are run on the port's run beside the
# equality with the reference and the decode
FAMILIES = {
    # the headline preset; every stream starts a sweep at frame 1 (one
    # column a frame at keyint 60, so every P frame carries a bar and the
    # reference compiles one P program)
    "headline": {
        # the tight buffer re-encodes the IDR and the P frames after the
        # scene cut, bars and all
        "headline": (_headline, 6, "encode", {1: _refresh},
                     dict(sweeps=(1, 5), reencode=True, walk=True,
                          hrd=True)),
        # a restart mid-sweep, then invalidate_reference restarts it
        # again (with intra refresh it asks for a refresh, no IDR)
        "pir_restart": (_headline, 6, "encode",
                        {1: _refresh, 3: _refresh, 5: _invalidate(4)},
                        dict(sweeps=(3, 5))),
        # VBV under ABR with a tight buffer, and reconfig mid-stream
        "vbv_abr_reconfig": (lambda P: _headline(
            P, nal_hrd=False, rc_method=P.RC_ABR, bitrate=30,
            vbv_maxrate=30, vbv_bufsize=6), 5, "encode",
            {1: _refresh, 3: _reconfig(bitrate=40, deblock_alpha=2)},
            dict(reencode=True, walk=True)),
        "pipelined": (lambda P: _headline(P, rc_method=P.RC_ABR,
                                          bitrate=30, vbv_maxrate=30,
                                          vbv_bufsize=6),
                      5, "pipelined", {1: _refresh},
                      dict(reencode=True, walk=True, hrd=True)),
    },
    "cavlc": {
        # the sweep starts at the keyint boundary (frame 5) and restarts
        "pir": (lambda P: _cavlc(P, intra_refresh=True), 8, "encode",
                {6: _refresh}, dict(sweeps=(2, 3))),
        # without intra refresh: intra_refresh() forces an IDR, and so
        # does invalidate_reference
        "refresh_idr": (lambda P: _cavlc(P, keyint_max=250,
                                         scenecut_threshold=0),
                        5, "encode", {2: _refresh, 4: _invalidate(1)},
                        dict(idrs=[0, 2, 4])),
        "vbv": (lambda P: _cavlc(P, rc_method=P.RC_ABR, bitrate=30,
                                 vbv_maxrate=30, vbv_bufsize=6,
                                 nal_hrd=True, scenecut_threshold=0,
                                 keyint_max=250),
                6, "encode", None, dict(reencode=True, walk=True,
                                        hrd=True)),
        "reconfig_qp": (lambda P: _cavlc(P), 5, "encode",
                        {2: _reconfig(qp=40, deblock_alpha=2,
                                      deblock_beta=-2)},
                        dict(qps=[25, 28, 40, 40, 40])),
    },
    "bframes": {
        "vbv_mbtree_b": (_bframes, 8, "encode", None,
                         dict(hrd=True, b=True, reencode=True)),
    },
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_live_streams_match_reference_and_decode(family):
    """For every stream of the family: bytes, frame types, QPs and sizes,
    the delayed-frame count after every call and the VBV re-encodes equal
    the reference's; avdec decodes it to the port's recon of every frame
    (the final recon with ``encode_pipelined``, which fires no recon
    hook); and the stream's own checks hold (the refresh sweeps, a
    re-encode and the buffer walk, the HRD SEIs, the IDRs asked for, the
    reconfigured QPs)."""
    streams = FAMILIES[family]
    frames = _clip(max(v[1] for v in streams.values()))
    for name, (make, n, mode, calls, checks) in streams.items():
        port, ref = (_encode(side, make(P), frames[:n], mode, calls)
                     for side, P in (("port", t_params), ("ref", r_params)))
        assert port["stats"] == ref["stats"], name
        assert port["stream"] == ref["stream"], name
        assert port["delayed"] == ref["delayed"], name
        assert port["retries"] == ref["retries"], name
        w, h = port["enc"].p.width, port["enc"].p.height
        dec = decode_annexb(port["stream"], w, h)
        assert len(dec) == n == len(port["stats"]), name
        if mode == "pipelined":
            np.testing.assert_array_equal(port["last"].y[:h, :w].numpy(),
                                          dec[-1][0], err_msg=name)
            assert port["delayed"][:-1] == [1] * n, name
        else:
            for d, planes in enumerate(dec):
                r = port["recons"][d]
                for p_rec, p_dec in zip((r.y, r.u, r.v), planes):
                    hh, ww = p_dec.shape
                    np.testing.assert_array_equal(
                        p_rec[:hh, :ww].numpy(), p_dec,
                        err_msg=f"{name}: display {d}")
        if "sweeps" in checks:
            _check_sweeps(port, *checks["sweeps"])
        if checks.get("reencode"):
            assert port["retries"], f"{name}: no frame re-encoded"
        if checks.get("walk"):
            _walk(port)
        if checks.get("hrd"):
            _check_hrd(port)
        if "idrs" in checks:
            types = [s[0] for s in port["stats"]]
            assert [i for i, t in enumerate(types) if t == "IDR"] == \
                checks["idrs"], types
        if "qps" in checks:
            assert [s[1] for s in port["stats"]] == checks["qps"]
        if checks.get("b"):
            types = [s[0] for s in port["stats"]]
            assert "B" in types and max(port["delayed"]) >= 3, types


def test_reconfig_refuses_like_the_reference():
    """Structural keys raise ValueError on both sides; a value the port
    does not run raises NotImplementedError and leaves the encoder as it
    was."""
    port = Encoder(_cavlc(t_params), device="cpu")
    ref = RefEncoder(_cavlc(r_params))
    for kw in (dict(width=128), dict(cabac=True), dict(bframes=2)):
        for enc in (port, ref):
            with pytest.raises(ValueError):
                enc.reconfig(**kw)
    with pytest.raises(NotImplementedError):
        port.reconfig(me_range=32)
    assert port.p is port.rc.p and port.p.subpel == 2 \
        and port.p.me_range == 8
    # the fullpel-only search runs since it was ported
    port.reconfig(subpel=0)
    assert port.p is port.rc.p and port.p.subpel == 0


def test_live_settings_open_and_the_rest_still_refused():
    """VBV, NAL HRD and intra refresh open, and so do slices, subpel 0,
    I4x4 with CAVLC and the host-entropy backend (ported since); fault
    2's me_range, intra refresh with P8x8 partitions (fault 3) and the
    host-entropy backend with the 8x8 transform (fault 5) still
    raise."""
    Encoder(_headline(t_params), device="cpu")
    Encoder(_cavlc(t_params, intra_refresh=True, rc_method=t_params.RC_ABR,
                   bitrate=100, vbv_maxrate=100, vbv_bufsize=50,
                   nal_hrd=True), device="cpu")
    for kw in (dict(slices=2), dict(subpel=0), dict(i4x4=True, cabac=False),
               dict(backend="device_host_entropy")):
        Encoder(t_params.EncoderParams(width=W, height=H, **kw),
                device="cpu")
    for kw in (dict(backend="device_host_entropy", transform_8x8=True),
               dict(me_range=32, cabac=True),
               dict(intra_refresh=True, p8x8=True, cabac=True)):
        with pytest.raises(NotImplementedError):
            Encoder(t_params.EncoderParams(width=W, height=H, **kw),
                    device="cpu")
    with pytest.raises(NotImplementedError):
        Encoder(_headline(t_params, p8x8=True), device="cpu")
