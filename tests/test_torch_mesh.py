"""The band mesh (``parallel/sliced.py``, ``threads`` > 1) against
x264_tpu's: the port's ``build_sliced_p_step`` over the CPU device four
times against the reference's over its four virtual CPU devices
(tests/conftest.py) on a 96x64 P frame of four one-row bands, at
``subpel`` 0 and 2 with each coder, every output field equal; an encode
with ``threads=4`` on four slices that takes the mesh on every P frame
(a spy on the step), byte-identical to the reference's and decoded
bit-exact by tools/avdec, and a band re-run at the ladder's second rung
inside a mesh frame; ``make_band_mesh``'s order of cards and its refusal
of too few, and the encoder's choice of the loop then.  Seeded numpy
inputs; tolerance 0 throughout.

A case that compiles a program of the reference is a test of its own,
and the streams that share the reference's compiles are one test: split
over xdist workers, each would compile them again."""

import os
import tempfile

import numpy as np
import pytest
import torch

os.environ.setdefault("X264_TPU_JAX_CACHE", os.path.join(
    tempfile.gettempdir(),
    f"x264_tpu_jax_{os.environ.get('PYTEST_XDIST_WORKER', 'main')}"))
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from x264_tpu import params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import inter_device  # noqa: E402
from x264_tpu.parallel import sliced as r_sliced  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import params as t_params  # noqa: E402
from x264_tpu_torch.api import Encoder  # noqa: E402
from x264_tpu_torch.parallel import sliced  # noqa: E402
from x264_tpu_torch.state import PAD, sad_lambda  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 96, 64
MBW, MBH = W // 16, H // 16


def _frames(n, seed=5, dx=3, dy=5):
    """Texture panning ``dx`` px right and ``dy`` px down a frame, so that
    blocks come from the band above; with moving chroma."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (H + 80, W + 80)).astype(np.int32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) // 4
    out = []
    for t in range(n):
        y0, x0 = 40 - dy * t, 40 - dx * t
        y = big[y0:y0 + H, x0:x0 + W].astype(np.uint8)
        u = (big[t:t + H // 2, t:t + W // 2] // 2 + 40).astype(np.uint8)
        v = (255 - big[t + 1:t + 1 + H // 2, t:t + W // 2]).astype(np.uint8)
        out.append((y, u, v))
    return out


def _noise(n, seed=9):
    """Uniform noise: at QP 12 bands overflow the first rung of the CAVLC
    ladder."""
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 256, s).astype(np.uint8)
                  for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2)))
            for _ in range(n)]


# ---- the step ----

def _reference_bands(src, pads, qp, lam, kw):
    """The reference's band program (``inter_device.p_band_core``, the
    program its step runs on each device) on each one-row band's rows and
    halo window, every field concatenated band-major."""
    outs = []
    for b in range(MBH):
        win = sliced.band_window(src, pads, b, 1)
        outs.append(inter_device.p_band_core(
            *map(jnp.asarray, win), jnp.asarray(qp[b * MBW:(b + 1) * MBW]),
            np.int32(lam), mbw=MBW, mbh=1, **kw))
    return {k: np.concatenate([np.asarray(o[k]) for o in outs])
            for k in outs[0]}


@pytest.mark.parametrize("subpel,entropy", [(0, "cavlc"), (0, "cabac"),
                                            (2, "cavlc"), (2, "cabac")])
def test_step_matches_reference_step(subpel, entropy):
    """Four one-row bands of a P frame whose content moves 5 px down, at
    per-MB QPs: every field of the port's step (the CPU device four
    times) equals the reference's step over four devices with CAVLC.
    With CABAC the reference's step does not trace (its ``out_specs``
    give the flat CABAC blob two axes; its encoder takes the mesh only
    with CAVLC), so the port's is held to the reference's band program
    on each band, which is what that step runs on each device.  The
    bands' outputs, each on its own device, gathered, are the step's."""
    src, prev = _frames(2)[1], _frames(2)[0]
    pads = [np.pad(prev[0], PAD, mode="edge"),
            np.pad(prev[1], PAD // 2, mode="edge"),
            np.pad(prev[2], PAD // 2, mode="edge")]
    qp = (np.arange(MBW * MBH, dtype=np.int32) * 7) % 9 + 22
    lam = sad_lambda(26)
    kw = dict(me_range=8, cqp_off=0, n_words=64, subpel=subpel,
              entropy=entropy, lv_cap=96)
    r_step, r_info = r_sliced.build_sliced_p_step(
        r_sliced.make_band_mesh(4), mbw=MBW, mbh_per_band=1, **kw)
    r_args = [*map(jnp.asarray, src), *map(jnp.asarray, pads),
              jnp.asarray(qp), lam]
    if entropy == "cavlc":
        ref = r_step(*r_args)
    else:
        with pytest.raises(ValueError, match="host_blob"):
            r_step(*r_args)
        ref = _reference_bands(src, pads, qp, lam, kw)
    step, info = sliced.build_sliced_p_step(
        sliced.make_band_mesh(4, "cpu"), mbw=MBW, mbh_per_band=1, **kw)
    assert info == r_info == dict(mbh=MBH, mbw=MBW, n_band=4)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*src, *pads)]
    port = step(*args, torch.from_numpy(qp), lam)
    assert "host_blob" in port and set(port) <= set(ref)
    for k in port:
        np.testing.assert_array_equal(
            port[k].to(torch.int64).numpy(),
            np.asarray(ref[k]).astype(np.int64), err_msg=k)
    # the content moved down: the top MBs of a band read the band above
    mvy = port["mv"][:, 1].reshape(MBH, MBW)
    assert bool((mvy[1:] < 0).any())
    bands = step.bands(*args, torch.from_numpy(qp), lam)
    assert len(bands) == 4 and all(
        o["recon_y"].shape == (16, W) for o in bands)
    for k, t in sliced.gather(bands, port.keys(), "cpu").items():
        assert torch.equal(t, port[k]), k


# ---- streams ----

def _params(P, **kw):
    """superfast's analysis (range 8, subpel 1) with CAVLC at QP 26 on
    four slices."""
    base = dict(width=W, height=H, qp=26, me_range=8, subpel=1,
                cabac=False, slices=4, keyint_max=250, fps_num=25)
    base.update(kw)
    return P.EncoderParams(**base)


def _encode(side, params, frames):
    """The stream, the band re-runs (slice type, band, rung) and the
    recons by display index."""
    enc = (Encoder(params, device="cpu") if side == "port"
           else RefEncoder(params))
    fr = Frame420 if side == "port" else RefFrame
    reruns = []
    rerun = enc._rerun_band

    def rerun_spy(job, b, n_words):
        reruns.append((job["slice_type"], b, n_words))
        return rerun(job, b, n_words)

    enc._rerun_band = rerun_spy
    recons = {}
    enc.recon_hook = recons.__setitem__
    stream = b"".join(enc.encode(fr(*f)) for f in frames) + enc.flush()
    return dict(stream=stream, reruns=reruns, recons=recons,
                types=[s.frame_type for s in enc.stats])


@pytest.fixture
def step_calls(monkeypatch):
    """The devices of every call of a mesh step's ``bands``."""
    calls = []
    bands = sliced.SlicedPStep.bands

    def spy(self, *a):
        calls.append(self.devices)
        return bands(self, *a)

    monkeypatch.setattr(sliced.SlicedPStep, "bands", spy)
    return calls


def test_threads_encode_takes_the_mesh_and_matches_reference(step_calls):
    """``threads=4`` on four slices: every P frame runs the mesh step
    once over four devices and the stream equals the reference's
    ``threads=4`` stream (its shard_map mesh) and the port's band loop
    (``threads=1``), and avdec decodes it to the port's recon of every
    frame.  Then noise at QP 12: bands of mesh frames overflow the first
    rung and re-run at 416 words, the same re-runs as the reference."""
    frames = _frames(4)
    port = _encode("port", _params(t_params, threads=4), frames)
    assert step_calls == [[torch.device("cpu")] * 4] * 3
    ref = _encode("ref", _params(r_params, threads=4), frames)
    loop = _encode("port", _params(t_params), frames)
    assert len(step_calls) == 3
    assert port["types"] == ["IDR", "P", "P", "P"]
    assert port["stream"] == ref["stream"] == loop["stream"]
    dec = decode_annexb(port["stream"], W, H)
    assert len(dec) == len(frames)
    for i, planes in enumerate(dec):
        r = port["recons"][i]
        for p_rec, p_dec in zip((r.y, r.u, r.v), planes):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec,
                                          err_msg=f"display {i}")
    noise = _noise(3)
    port = _encode("port", _params(t_params, threads=4, qp=12), noise)
    assert len(step_calls) == 5
    ref = _encode("ref", _params(r_params, threads=4, qp=12), noise)
    assert port["stream"] == ref["stream"]
    assert port["reruns"] == ref["reruns"]
    p_reruns = {r for t, _, r in port["reruns"] if t == 0}
    assert p_reruns == {416}, port["reruns"]


# ---- the devices ----

def test_make_band_mesh_order_and_too_few_cards(monkeypatch):
    """On CUDA the encoder's card first, then the others in index order;
    too few cards raise, and the encoder then runs the band loop, as the
    reference does with fewer devices (the card count monkeypatched:
    nothing here touches a card).  On the CPU, the CPU device n times."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert sliced.make_band_mesh(3, "cuda:2") == [
        torch.device("cuda", i) for i in (2, 0, 1)]
    assert sliced.make_band_mesh(4, "cuda") == [
        torch.device("cuda", i) for i in range(4)]
    assert sliced.make_band_mesh(4, "cpu") == [torch.device("cpu")] * 4
    enc = Encoder(_params(t_params, threads=4), device="cpu")
    assert enc._mesh_on(False, 4, 0)
    # the reference's condition: no IDR, equal bands, one band or more
    assert not (enc._mesh_on(True, 4, 0) or enc._mesh_on(False, 4, 1)
                or enc._mesh_on(False, 1, 0))
    enc.device = torch.device("cuda")
    assert enc._mesh_on(False, 4, 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="need 4 CUDA devices, have 2"):
        sliced.make_band_mesh(4, "cuda")
    assert not enc._mesh_on(False, 4, 0) and enc._mesh_on(False, 2, 0)
    for kw in (dict(threads=1), dict(threads=4, cabac=True)):
        e = Encoder(_params(t_params, **kw), device="cpu")
        assert not e._mesh_on(False, 4, 0)
