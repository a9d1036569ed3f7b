"""The port's encoder (``x264_tpu_torch.api.Encoder``, device "cpu": the
kernels' plain twins) against ``x264_tpu.api.Encoder`` on the I/P CABAC
slice: byte-identical Annex-B streams at QP 0, 26 and 51 and at the odd
350x286 size, under ABR and CRF, and a real decoder (tools/avdec,
libavcodec) decoding the port's stream bit-exact to its reconstruction.
Each side gets its own package's ``EncoderParams`` with the same fields.
Also: the port runs with both JAX and x264_tpu blocked and starts no
thread."""

import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

# a compile cache per xdist worker: the shared one has crashed a worker
os.environ.setdefault("X264_TPU_JAX_CACHE", os.path.join(
    tempfile.gettempdir(),
    f"x264_tpu_jax_{os.environ.get('PYTEST_XDIST_WORKER', 'main')}"))
pytest.importorskip("jax")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.params import (RC_ABR, RC_CRF, EncoderParams,  # noqa: E402
                                   param_default_preset)
from x264_tpu_torch.state import PAD  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(w, h, n, seed=5):
    """Panning soft texture with a luma drift and a gradient patch that
    appears in frame 2 (P_Skip, P16 and intra-in-P all occur)."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h + 4 * n, w + 4 * n)).astype(np.int32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) // 4
    frames = []
    for t in range(n):
        y = np.clip(tex[2 * t:2 * t + h, 3 * t:3 * t + w] + t, 0, 255)
        if t >= 2:
            yy, xx = np.mgrid[0:16, 0:24]
            y[8:24, 16:40] = 30 + 5 * yy + 4 * xx
        u = tex[1::2, ::2][t:t + h // 2, t:t + w // 2]
        v = 255 - tex[::2, 1::2][t:t + h // 2, t:t + w // 2]
        frames.append(Frame420(y.astype(np.uint8), u.astype(np.uint8),
                               v.astype(np.uint8)))
    return frames


def _params(w, h, qp, ref=False, **kw):
    """The port's params, or with ref=True the reference's, same fields."""
    base = dict(width=w, height=h, qp=qp, me_range=16, subpel=2, cabac=True,
                deblock=True, bframes=0, ref_frames=1, keyint_max=250,
                scenecut_threshold=0, backend="device")
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


def _encode(enc, frames):
    recons = []
    enc.recon_hook = lambda d, rec: recons.append(rec)
    stream = b"".join(enc.encode(f) for f in frames) + enc.flush()
    return stream, recons


@pytest.mark.parametrize("w,h,qp", [(64, 48, 0), (64, 48, 26),
                                    (64, 48, 51), (350, 286, 26)])
def test_stream_matches_reference_and_decodes(w, h, qp):
    frames = _clip(w, h, 3)
    port_stream, recons = _encode(Encoder(_params(w, h, qp), device="cpu"),
                                  frames)
    ref_stream, _ = _encode(RefEncoder(_params(w, h, qp, ref=True)), frames)
    assert port_stream == ref_stream
    dec = decode_annexb(port_stream, w, h)
    assert len(dec) == len(frames) == len(recons)
    for rec, planes in zip(recons, dec):
        for p_rec, p_dec in zip((rec.y, rec.u, rec.v), planes):
            hh, ww = p_dec.shape
            assert torch.is_tensor(p_rec)
            np.testing.assert_array_equal(p_rec[:hh, :ww].cpu().numpy(),
                                          p_dec)


@pytest.mark.parametrize("rc", [dict(rc_method=RC_ABR, bitrate=300),
                                dict(rc_method=RC_CRF, crf=24.0)])
def test_rate_control_matches_reference(rc):
    """The port's copy of the ABR and CRF rate control picks the same
    frame QPs from the port's bit counts and costs as the reference's."""
    frames = _clip(64, 48, 4)
    assert _encode(Encoder(_params(64, 48, 26, **rc), device="cpu"),
                   frames)[0] == \
        _encode(RefEncoder(_params(64, 48, 26, ref=True, **rc)), frames)[0]


def test_scenecut_promotes_like_reference():
    """With scenecut on, a frame unlike its reference is re-encoded as
    an IDR by the post-encode rule, in the port as in the reference."""
    w, h = 64, 48
    frames = _clip(w, h, 2)
    rng = np.random.default_rng(11)
    frames.append(Frame420(rng.integers(0, 256, (h, w), dtype=np.uint8),
                           rng.integers(0, 256, (h // 2, w // 2),
                                        dtype=np.uint8),
                           rng.integers(0, 256, (h // 2, w // 2),
                                        dtype=np.uint8)))
    kw = dict(scenecut_threshold=40, keyint_min=1)
    port = Encoder(_params(w, h, 26, **kw), device="cpu")
    ref = RefEncoder(_params(w, h, 26, ref=True, **kw))
    assert _encode(port, frames)[0] == _encode(ref, frames)[0]
    assert [s.frame_type for s in port.stats] == ["IDR", "P", "IDR"]


def test_unported_settings_and_missing_card_raise():
    for kw in (dict(backend="device_host_entropy", transform_8x8=True),
               dict(backend="bogus"), dict(me_range=PAD + 1)):
        with pytest.raises(NotImplementedError):
            Encoder(_params(64, 48, 26, **kw), device="cpu")
    # the host-syntax path's settings run since it was ported
    for kw in (dict(i4x4=True, cabac=False), dict(backend="reference"),
               dict(backend="device_host_entropy")):
        Encoder(_params(64, 48, 26, **kw), device="cpu")
    # slices and the fullpel-only search (ultrafast) run since they were
    # ported
    Encoder(param_default_preset("ultrafast"), device="cpu")
    for kw in (dict(subpel=0), dict(slices=2), dict(slices=4, threads=4),
               dict(p8x8=True, ref_frames=2), dict(trellis=1, weightp=1),
               dict(p8x8=True, transform_8x8=True, i4x4=True, weightp=1),
               dict(p8x8=True, weightp=2, ref_frames=4), dict(cabac=False),
               dict(cabac=False, p8x8=True, transform_8x8=True, bframes=2),
               dict(bframes=2, b_adapt=1),
               dict(bframes=2, scenecut_threshold=40),
               dict(p8x8=True, aq_mode=1), dict(mbtree=True),
               dict(mbtree=True, rc_method=RC_CRF, bframes=2, b_adapt=1,
                    aq_mode=2, scenecut_threshold=40),
               dict(intra_refresh=True),
               dict(vbv_maxrate=500, vbv_bufsize=500,
                    rc_method=RC_ABR, bitrate=500, nal_hrd=True)):
        Encoder(_params(64, 48, 26, **kw), device="cpu")
    for preset in ("superfast", "veryfast", "faster", "fast", "medium",
                   "slow", "slower", "veryslow", "placebo"):
        Encoder(param_default_preset(preset).clone(
            rc_method=RC_CRF, aq_mode=1, mbtree=True, b_adapt=1),
            device="cpu")
    Encoder(param_default_preset("medium", tune="ssim"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Encoder(_params(64, 48, 26), device="cuda")


def test_port_runs_without_jax():
    """With ``jax`` and ``x264_tpu`` both blocked, the port imports, takes
    its own params and frames, encodes I/P16 and I/P8x8 frames, and a
    1080p encoder starts no thread."""
    code = textwrap.dedent("""
        import sys, threading
        sys.modules["jax"] = None
        sys.modules["x264_tpu"] = None
        import numpy as np
        import x264_tpu_torch
        from x264_tpu_torch.api import Encoder
        from x264_tpu_torch.params import EncoderParams
        from x264_tpu_torch.utils.yuv import Frame420
        Encoder(EncoderParams(width=1920, height=1080, cabac=True),
                device="cpu")
        assert threading.active_count() == 1
        rng = np.random.default_rng(1)
        base = rng.integers(0, 256, (40, 56), dtype=np.uint8)
        for p8x8 in (False, True):
            enc = Encoder(EncoderParams(width=48, height=32, cabac=True,
                                        me_range=4, p8x8=p8x8),
                          device="cpu")
            out = b"".join(enc.encode(Frame420(
                np.ascontiguousarray(base[t:t + 32, 2 * t:2 * t + 48]),
                rng.integers(0, 256, (16, 24), dtype=np.uint8),
                rng.integers(0, 256, (16, 24), dtype=np.uint8)))
                for t in range(3)) + enc.flush()
            assert out[:4] == b"\\x00\\x00\\x00\\x01"
            assert [s.frame_type for s in enc.stats] == ["IDR", "P", "P"]
        assert sys.modules["jax"] is None and sys.modules["x264_tpu"] is None
        assert not any(m.startswith("x264_tpu.") for m in sys.modules)
        assert threading.active_count() == 1
        print("OK", len(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


# settings the port accepts beyond the defaults, grouped so that each
# group's cases share the reference's compiled programs: each group runs
# I/P16 and I/B/P8x8 (bframes=2, full_recon on)
SETTINGS_GROUPS = {
    "subpel1_no_decimate": dict(subpel=1, dct_decimate=False),
    "chroma_qp_offset_deblock_offsets": dict(chroma_qp_offset=4,
                                             deblock_alpha=3,
                                             deblock_beta=-2),
    "deblock_off": dict(deblock=False),
}


@pytest.mark.parametrize("group", list(SETTINGS_GROUPS))
def test_open_settings_match_reference_and_decode(group):
    """subpel=1, dct_decimate=False, a chroma QP offset, deblock offsets
    and deblock off: the port's streams equal the reference's on I, P16,
    P8x8 and B frames, and avdec decodes them to the port's recon."""
    w, h = 64, 48
    for kw, n in ((dict(), 4), (dict(bframes=2, p8x8=True, me_range=8,
                                     full_recon=True), 7)):
        kw = dict(kw, **SETTINGS_GROUPS[group])
        frames = _clip(w, h, n)
        port = Encoder(_params(w, h, 26, **kw), device="cpu")
        recons = {}
        port.recon_hook = recons.__setitem__
        stream = b"".join(port.encode(f) for f in frames) + port.flush()
        assert stream == _encode(RefEncoder(_params(w, h, 26, ref=True,
                                                    **kw)), frames)[0], kw
        assert "B" in [s.frame_type for s in port.stats] or not kw.get(
            "bframes")
        dec = decode_annexb(stream, w, h)
        assert len(dec) == n == len(recons)
        for d, planes in enumerate(dec):
            for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                    planes):
                hh, ww = p_dec.shape
                np.testing.assert_array_equal(
                    p_rec[:hh, :ww].cpu().numpy(), p_dec,
                    err_msg=f"{group} {kw}: display {d}")
