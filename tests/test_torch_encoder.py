"""The port's encoder (``x264_tpu_torch.api.Encoder``, device "cpu": the
kernels' plain twins) against ``x264_tpu.api.Encoder`` on the I/P CABAC
slice: byte-identical Annex-B streams at QP 0, 26 and 51 and at the odd
350x286 size, under ABR and CRF, and a real decoder (tools/avdec,
libavcodec) decoding the port's stream bit-exact to its reconstruction.
Also: the port runs with JAX blocked and starts no warm-up thread."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.params import RC_ABR, RC_CRF, EncoderParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402

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


def _params(w, h, qp, **kw):
    base = dict(width=w, height=h, qp=qp, me_range=16, subpel=2, cabac=True,
                deblock=True, bframes=0, ref_frames=1, keyint_max=250,
                scenecut_threshold=0, backend="device")
    base.update(kw)
    return EncoderParams(**base)


def _encode(enc, frames):
    recons = []
    enc.recon_hook = lambda d, rec: recons.append(rec)
    stream = b"".join(enc.encode(f) for f in frames) + enc.flush()
    return stream, recons


@pytest.mark.parametrize("w,h,qp", [(64, 48, 0), (64, 48, 26),
                                    (64, 48, 51), (350, 286, 26)])
def test_stream_matches_reference_and_decodes(w, h, qp):
    frames = _clip(w, h, 3)
    p = _params(w, h, qp)
    port_stream, recons = _encode(Encoder(p, device="cpu"), frames)
    ref_stream, _ = _encode(RefEncoder(p), frames)
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
    """The inherited ABR and CRF rate control picks the same frame QPs
    from the port's bit counts and costs as from the reference's."""
    frames = _clip(64, 48, 4)
    p = _params(64, 48, 26, **rc)
    assert _encode(Encoder(p, device="cpu"), frames)[0] == \
        _encode(RefEncoder(p), frames)[0]


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
    p = _params(w, h, 26, scenecut_threshold=40, keyint_min=1)
    port = Encoder(p, device="cpu")
    ref = RefEncoder(p)
    assert _encode(port, frames)[0] == _encode(ref, frames)[0]
    assert [s.frame_type for s in port.stats] == ["IDR", "P", "IDR"]


def test_unported_settings_and_missing_card_raise():
    for kw in (dict(bframes=2), dict(cabac=False), dict(i4x4=True),
               dict(subpel=0), dict(backend="reference")):
        with pytest.raises(NotImplementedError):
            Encoder(_params(64, 48, 26, **kw), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Encoder(_params(64, 48, 26), device="cuda")


def test_port_runs_without_jax():
    """With ``jax`` blocked, the port imports, encodes three frames, and
    a 1080p encoder starts no warm-up thread (the base class would start
    one that encodes through JAX)."""
    code = textwrap.dedent("""
        import sys, threading
        sys.modules["jax"] = None
        import numpy as np
        import x264_tpu_torch
        from x264_tpu.params import EncoderParams
        from x264_tpu.utils.yuv import Frame420
        from x264_tpu_torch.api import Encoder
        big = Encoder(EncoderParams(width=1920, height=1080, cabac=True),
                      device="cpu")
        assert big._warm_thread is None, "warm-up thread started"
        assert threading.active_count() == 1
        rng = np.random.default_rng(1)
        enc = Encoder(EncoderParams(width=48, height=32, cabac=True),
                      device="cpu")
        out = b"".join(enc.encode(Frame420(
            rng.integers(0, 256, (32, 48), dtype=np.uint8),
            rng.integers(0, 256, (16, 24), dtype=np.uint8),
            rng.integers(0, 256, (16, 24), dtype=np.uint8)))
            for _ in range(3)) + enc.flush()
        assert out[:4] == b"\\x00\\x00\\x00\\x01" and len(enc.stats) == 3
        assert sys.modules["jax"] is None
        assert threading.active_count() == 1
        print("OK", len(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")
