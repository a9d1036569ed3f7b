"""Streams with the 8x8 transform and trellis: the port
(``Encoder(device="cpu")``, the kernels' plain twins) against
``x264_tpu.api.Encoder``, byte-identical, and tools/avdec (libavcodec)
decoding the port's stream bit-exact to its recon, keyed by display
index.  I/P16 at QP 0, 26 and 51, I/P8x8, bframes 1-3 with full_recon on
and off, the 8x8 transform alone and trellis alone, all at 64x48.  The
cases are grouped so that those that share the reference's compiled
programs (QP and the trellis tables are traced arguments; the tools,
partitions and B cores are not) run in one test."""

import os
import tempfile

import numpy as np
import pytest

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
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 64, 48
TOOLS = dict(transform_8x8=True, trellis=1)

# group -> [(name, settings, frames)]; one group shares its compiles
GROUPS = {
    "p16": [("qp26", dict(TOOLS), 4), ("qp0", dict(TOOLS, qp=0), 3),
            ("qp51", dict(TOOLS, qp=51), 3),
            ("trellis2", dict(TOOLS, trellis=2), 3)],
    "p8x8": [("p8x8", dict(TOOLS, p8x8=True), 4),
             ("p8x8_qp0", dict(TOOLS, p8x8=True, qp=0), 3)],
    "b_single": [("bframes1", dict(TOOLS, bframes=1), 5),
                 ("bframes3", dict(TOOLS, bframes=3), 6)],
    "b_pair": [("bframes2", dict(TOOLS, bframes=2, p8x8=True), 7),
               ("bframes2_recon_off", dict(TOOLS, bframes=2, p8x8=True,
                                           full_recon=False), 7)],
    "t8_only": [("t8", dict(transform_8x8=True), 4)],
    "trellis_only": [("trellis", dict(trellis=1), 4)],
}


def _frames(n, seed=5):
    """Soft texture panning (3, 2) px per frame with a luma drift, and a
    gradient patch from frame 2 on (intra MBs occur)."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (H + 4 * n, W + 4 * n)).astype(np.int32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) // 4
    out = []
    for t in range(n):
        y = np.clip(tex[2 * t:2 * t + H, 3 * t:3 * t + W] + t, 0, 255)
        if t >= 2:
            yy, xx = np.mgrid[0:16, 0:24]
            y[8:24, 16:40] = 30 + 5 * yy + 4 * xx
        u = tex[1::2, ::2][t:t + H // 2, t:t + W // 2]
        v = 255 - tex[::2, 1::2][t:t + H // 2, t:t + W // 2]
        out.append(Frame420(*(np.ascontiguousarray(p.astype(np.uint8))
                              for p in (y, u, v))))
    return out


def _params(ref=False, **kw):
    base = dict(width=W, height=H, qp=26, me_range=8, subpel=2, cabac=True,
                deblock=True, bframes=0, ref_frames=1, keyint_max=250,
                scenecut_threshold=0, backend="device")
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


def _encode(enc, frames):
    recons, t8 = {}, []
    enc.recon_hook = recons.__setitem__
    if isinstance(enc, Encoder):
        run_core = enc._run_core

        def spy(*a, **kw):
            out, st = run_core(*a, **kw)
            if "t8" in out:
                t8.append(bool(out["t8"].any()))
            return out, st
        enc._run_core = spy
    stream = b"".join(enc.encode(f) for f in frames) + enc.flush()
    return stream, recons, t8


@pytest.mark.parametrize("group", list(GROUPS))
def test_t8_trellis_streams_match_reference_and_decode(group):
    for name, kw, n in GROUPS[group]:
        frames = _frames(n)
        port = Encoder(_params(**kw), device="cpu")
        stream, recons, t8 = _encode(port, frames)
        assert stream == _encode(RefEncoder(_params(ref=True, **kw)),
                                 frames)[0], name
        if kw.get("transform_8x8") and kw.get("qp", 26) < 51:
            assert any(t8), f"{name}: no P MB chose the 8x8 transform"
        dec = decode_annexb(stream, W, H)
        assert len(dec) == n == len(recons), name
        # with full_recon off a B frame's recon is left undeblocked
        shown = [d for d in range(n) if d % (kw.get("bframes", 0) + 1) == 0
                 ] if kw.get("full_recon") is False else range(n)
        for d in shown:
            for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                    dec[d]):
                hh, ww = p_dec.shape
                np.testing.assert_array_equal(
                    p_rec[:hh, :ww].numpy(), p_dec,
                    err_msg=f"{name}: display {d}")
