"""The port's last entry points of ``x264_tpu/api.py`` against the
reference on the CPU, tolerance 0: ``encode_sequence`` byte for byte,
``Encoder.warm``'s signature and its answer where the reference starts no
warm-up, and ``Encoder._warm_twin``, which encodes both entropy rungs of
every frame core through a twin and leaves the real encoder's stream
as a fresh encoder's."""

import inspect
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _stream_bases import MID, ODD  # noqa: E402
from _test_clock import per_test_clock  # noqa: E402,F401
import x264_tpu.api as ref_api  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import api  # noqa: E402
from x264_tpu_torch.api import Encoder, encode_sequence  # noqa: E402
from x264_tpu_torch.params import EncoderParams  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

N_FRAMES = 6      # IDR, B B P, then P + B at flush with bframes=2


def _clip(w, h, n, seed=11):
    """A soft texture panning 3 px right and 2 down a frame."""
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 256, (h + 2 * n, w + 3 * n)).astype(np.int32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) // 4
    out = []
    for t in range(n):
        y = tex[2 * t:2 * t + h, 3 * t:3 * t + w]
        out.append((y.astype(np.uint8),
                    y[::2, ::2].astype(np.uint8),
                    (255 - y[1::2, 1::2]).astype(np.uint8)))
    return out


_BASE = dict(qp=26, subpel=2, deblock=True, ref_frames=1, keyint_max=250,
             scenecut_threshold=0, backend="device")
# the settings of other port test files, so that the reference's programs
# compiled for them serve here too: test_torch_encoder.py (CABAC),
# test_torch_bframes.py's full_recon_off case (CABAC, B frames) and
# test_torch_cavlc.py's p16, p16_odd and bframes groups (CAVLC)
CONFIGS = {
    "cabac": dict(width=MID[0], height=MID[1], me_range=16, cabac=True,
                  bframes=0),
    "cabac_b": dict(width=96, height=64, me_range=8, cabac=True, bframes=2,
                    full_recon=False),
    "cavlc": dict(width=MID[0], height=MID[1], me_range=8, cabac=False,
                  bframes=0),
    "cavlc_b": dict(width=MID[0], height=MID[1], me_range=8, cabac=False,
                    bframes=2, p8x8=True, full_recon=False),
    "cavlc_odd": dict(width=ODD[0], height=ODD[1], me_range=8, cabac=False,
                      bframes=0),
}


def _kw(name, **kw):
    return {**_BASE, **CONFIGS[name], **kw}


_REF: dict = {}


def _reference(name):
    """(each encode()'s bytes, flush()'s bytes) of the reference on
    _clip, once per worker and setting."""
    if name not in _REF:
        kw = _kw(name)
        enc = ref_api.Encoder(RefParams(**kw))
        parts = [enc.encode(RefFrame(*f))
                 for f in _clip(kw["width"], kw["height"], N_FRAMES)]
        _REF[name] = (parts, enc.flush())
    return _REF[name]


def _port_stream(enc):
    return b"".join(enc.encode(Frame420(*f)) for f in
                    _clip(enc.p.width, enc.p.height, N_FRAMES)) + enc.flush()


@pytest.mark.parametrize("name", ["cabac", "cavlc_odd"])
def test_encode_sequence_matches_reference(name):
    kw = _kw(name)
    frames = _clip(kw["width"], kw["height"], N_FRAMES)
    got = encode_sequence([Frame420(*f) for f in frames],
                          EncoderParams(**kw), device="cpu")
    want = ref_api.encode_sequence([RefFrame(*f) for f in frames],
                                   RefParams(**kw))
    assert got == want == b"".join(_reference(name)[0])
    assert "encode_sequence" in api.__all__


def test_encode_sequence_leaves_what_flush_would_write():
    """No flush(), as the reference's: with B frames the last mini-GOP
    stays behind."""
    kw = _kw("cavlc_b")
    frames = [Frame420(*f) for f in _clip(kw["width"], kw["height"],
                                          N_FRAMES)]
    parts, tail = _reference("cavlc_b")
    assert encode_sequence(frames, EncoderParams(**kw), device="cpu") \
        == b"".join(parts)
    assert tail


def test_warm_signature_is_the_references():
    assert inspect.signature(Encoder.warm) == \
        inspect.signature(ref_api.Encoder.warm)


def test_warm_on_the_cpu_is_false_and_changes_nothing():
    enc = Encoder(EncoderParams(**_kw("cabac")), device="cpu")
    assert enc.warm() is False
    assert enc.warm(3600, full=True) is False
    parts, tail = _reference("cabac")
    assert _port_stream(enc) == b"".join(parts) + tail


@pytest.mark.parametrize("change,warms", [
    ({}, True),
    (dict(slices=2), False),
    (dict(width=800, height=640), True),          # 2000 MBs
    (dict(width=784, height=640), False),         # 1960 MBs
    (dict(i4x4=True, cabac=False), False),        # the host-syntax path
    (dict(backend="device_host_entropy"), False),
    (dict(backend="reference"), False),
    (dict(i4x4=True, cabac=True, bframes=2), True),
])
def test_warm_runs_where_the_reference_starts_its_thread(change, warms):
    """x264_tpu/api.py:95-98: a device backend, not the host-syntax path,
    one slice, 2000 MBs or more; the port asks for a card besides.  The
    predicate is read with the encoder's device set to a card, which
    this host does not have."""
    kw = dict(_kw("cabac", width=1920, height=1080), **change)
    enc = Encoder(EncoderParams(**kw), device="cpu")
    assert enc._warm_on() is False
    enc.device = torch.device("cuda")
    assert enc._warm_on() is warms


_CORES = ("i_frame_core", "i4_frame_core", "p_frame_core", "b_frame_core",
          "b_pair_core")


@pytest.mark.parametrize("name", ["cabac", "cabac_b", "cavlc", "cavlc_b"])
def test_warm_twin_runs_both_rungs_and_leaves_the_stream(monkeypatch, name):
    seen = []
    for core in _CORES:
        def spy(*a, _core=getattr(api, core), _name=core, **kw):
            seen.append((_name, kw.get("lv_cap", kw.get("n_words"))))
            return _core(*a, **kw)
        monkeypatch.setattr(api, core, spy)
    p = EncoderParams(**_kw(name))
    enc = Encoder(p, device="cpu")
    enc._warm_twin()
    rungs = set(Encoder._RUNGS[p.cabac])
    want = {"i_frame_core": rungs, "p_frame_core": rungs}
    if p.bframes:
        want.update(b_pair_core=rungs, b_frame_core=rungs)
    got = {}
    for core, rung in seen:
        got.setdefault(core, set()).add(rung)
    assert got == want
    # nothing of the twin in the real encoder
    assert (enc.frame_idx, enc.dpb, enc.stats, enc._rung_floor) == \
        (0, [], [], 0)
    seen.clear()
    stream = _port_stream(enc)
    assert seen and stream == _port_stream(Encoder(p, device="cpu"))
    parts, tail = _reference(name)
    assert stream == b"".join(parts) + tail


def test_warm_twin_leaves_two_pass_state(tmp_path):
    """Under two-pass the twin reads the stats file at open and plans its
    own pass 2: the real encoder's plan and frame index stay as they were,
    the twin writes no file, and the stream is a fresh encoder's."""
    from x264_tpu_torch.params import RC_ABR
    stats = str(tmp_path / "pass1.log")
    kw = _kw("cabac", rc_method=RC_ABR, bitrate=300)
    first = Encoder(EncoderParams(**kw, stats_write=stats), device="cpu")
    _port_stream(first)
    first.close()
    written = open(stats).read()
    p = EncoderParams(**kw, stats_read=stats)
    enc = Encoder(p, device="cpu")
    plan = list(enc._pass2_qps)
    enc._warm_twin()
    assert (enc._pass2_qps, enc._enc_idx) == (plan, 0)
    assert sorted(os.listdir(tmp_path)) == ["pass1.log"]
    assert open(stats).read() == written
    assert _port_stream(enc) == _port_stream(Encoder(p, device="cpu"))
