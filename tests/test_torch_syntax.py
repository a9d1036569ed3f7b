"""The host-syntax path in the port against x264_tpu: the device cores'
syntax entries (``encode_iframe_device``, ``encode_pframe_device``)
field by field against the reference's, then streams byte-identical to
``x264_tpu.api.Encoder`` and decoded bit-exact by tools/avdec
(libavcodec) to the port's recon, keyed by display index: I4x4 with
CAVLC on an I/P GOP at QP 14, 26 and 40 and under AQ, the medium preset
with tune fastdecode at CRF 23 with B frames, AQ, MB-tree and
``b_adapt=1``, the ``device_host_entropy`` backend with CABAC and with
CAVLC on a cut that the syntax path's scenecut promotes to an IDR, and
with B frames, and the ``reference`` backend (the NumPy tier) with
I4x4 under each coder.  Also fault 5 (ROADMAP C): the reference's
host-entropy backend with the 8x8 transform writes streams that do not
decode to its recon, and the port refuses it; fault 6: the syntax
path's scenecut promoting a mini-GOP's anchor after its B frames were
queued, which the port refuses where it happens; and
``encode_pipelined``
with I4x4 + CAVLC and with the host-entropy backend, which the
reference codes on its fast path.  Tolerance 0 throughout."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu import params as r_params  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import inter_device, intra_device  # noqa: E402
from x264_tpu.models.inter_frame import sad_lambda  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu.utils.yuv import Frame420 as RefFrame  # noqa: E402
from x264_tpu_torch import params as t_params  # noqa: E402
from x264_tpu_torch.api import Encoder, ReconFrame  # noqa: E402
from x264_tpu_torch.models.inter import encode_pframe_device  # noqa: E402
from x264_tpu_torch.models.intra import encode_iframe_device  # noqa: E402
from x264_tpu_torch.models.syntax import MB_I4  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = 96, 64


def _clip(n, w=W, h=H, cut=None):
    """A pan over texture where each intra class wins somewhere (a sine
    field with noise, 45-degree stripes of 3-px grain on a third of the
    MBs, which pick I4x4, ramps on a fifth); from frame ``cut`` on a
    still noise scene that inter prediction cannot follow."""
    rng = np.random.default_rng(15)
    yy, xx = np.mgrid[0:h + 2 * n, 0:w + 3 * n]
    y = 120 + 70 * np.sin(xx / 11) * np.cos(yy / 8) \
        + rng.integers(0, 9, yy.shape)
    mbx, mby = xx // 16, yy // 16
    y = np.where((mbx + mby) % 3 == 0,
                 np.where(((xx + yy) // 3) % 2 == 0, 40, 210), y)
    y = np.where((mbx + 2 * mby) % 5 == 1, 60 + xx // 4, y)
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 7)).astype(np.uint8)
    v = (128 + 40 * np.cos(yy[::2, ::2] / 5)).astype(np.uint8)
    noise = [rng.integers(0, 256, s, dtype=np.uint8)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    frames = []
    for t in range(n):
        if cut is not None and t >= cut:
            frames.append(tuple(noise))
            continue
        frames.append(tuple(np.ascontiguousarray(p) for p in (
            y[t:t + h, 2 * t:2 * t + w], u[t:t + h // 2, t:t + w // 2],
            v[:h // 2, t:t + w // 2])))
    return frames


_BASE = dict(width=W, height=H, qp=26, me_range=8, subpel=2, cabac=False,
             i4x4=True, deblock=True, bframes=0, keyint_max=250,
             scenecut_threshold=0)


def _encode(P, E, F, p, frames, pipelined=False, classes=None):
    """(encoder, stream, recons by display index); ``classes`` receives
    the mb_class of each frame the port's host writers code."""
    enc = E(P.EncoderParams(**p) if isinstance(p, dict) else p)
    recons = {}
    enc.recon_hook = recons.__setitem__
    if classes is not None:
        write = enc._syn_slice

        def spy(syn, *a):
            classes.append(syn.mb_class.copy())
            return write(syn, *a)
        enc._syn_slice = spy
    if not pipelined:
        stream = b"".join(enc.encode(F(*f)) for f in frames) + enc.flush()
        return enc, stream, recons
    # encode_pipelined fires no recon hook: each call's frame is the
    # newest reference once the call returns (no B frames)
    stream = b""
    for d, f in enumerate(frames):
        stream += enc.encode_pipelined(F(*f))
        recons[d] = enc.dpb[0]
    return enc, stream + enc.flush(), recons


def _port_and_ref(p, frames, pipelined=False, classes=None):
    """(port encoder, port stream, port recons by display index,
    reference encoder, reference stream) of params ``p``: a dict of
    fields, or (port params, reference params)."""
    tp, rp = (p, p) if isinstance(p, dict) else p
    port, stream, recons = _encode(
        t_params, lambda q: Encoder(q, device="cpu"), Frame420, tp, frames,
        pipelined, classes)
    ref, ref_stream, _ = _encode(r_params, RefEncoder, RefFrame, rp, frames,
                                 pipelined)
    return port, stream, recons, ref, ref_stream


def _decodes_to(stream, recons, w, h, label):
    dec = decode_annexb(stream, w, h)
    assert len(dec) == len(recons), label
    for d, planes in enumerate(dec):
        for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                planes):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec,
                                          err_msg=f"{label}: display {d}")


def _check(p, frames, label, w=W, h=H, classes=None):
    port, stream, recons, ref, ref_stream = _port_and_ref(p, frames,
                                                          classes=classes)
    types = [s.frame_type for s in port.stats]
    assert stream == ref_stream, (label, types)
    assert [(s.frame_type, s.qp) for s in port.stats] == \
        [(s.frame_type, s.qp) for s in ref.stats]
    _decodes_to(stream, recons, w, h, label)
    return port, types


# ---- the device cores' syntax entries ----

_SYN_FIELDS = ("mb_class", "qp", "i16_mode", "i4_modes", "chroma_mode",
               "mv", "mvd", "ref", "cbp_luma", "cbp_chroma", "luma_dc",
               "luma_ac", "chroma_dc", "chroma_ac", "luma_nnz",
               "chroma_nnz", "res_vals", "res_lens", "mb_cost", "icost")


def _same_syntax(port, ref):
    for k in _SYN_FIELDS:
        a, b = getattr(port, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)


@pytest.mark.parametrize("entry", ["i16", "i4", "p16"])
def test_syntax_entries_match_reference(entry):
    """encode_iframe_device (the I16 core with the CAVLC slot grids, the
    I4x4 core) and encode_pframe_device (P16 with the slot grids) against
    the reference's entries: the recon planes and every field a writer
    or the deblock reads."""
    frames = _clip(2)
    qp = 40 if entry == "p16" else 26     # P_Skip MBs at 40
    T = [torch.from_numpy(p) for p in frames[0]]
    if entry == "p16":
        ref_rec = intra_device.encode_iframe_device(*frames[0], qp)
        ref_out = inter_device.encode_pframe_device(
            *frames[1], ReconFrame(*ref_rec[:3]),
            qp, r_params.EncoderParams(**_BASE), lam=sad_lambda(qp))
        port = encode_pframe_device(
            *[torch.from_numpy(p) for p in frames[1]],
            ReconFrame(*(torch.from_numpy(np.array(p))
                         for p in ref_rec[:3])),
            qp, t_params.EncoderParams(**_BASE), lam=sad_lambda(qp),
            cavlc=True)
        assert (port[3].mb_class == 2).any() and \
            (port[3].mb_class == 3).any()
    else:
        i4 = entry == "i4"
        ref_out = intra_device.encode_iframe_device(
            *frames[0], qp, 0, i4x4=i4, lam=sad_lambda(qp))
        port = encode_iframe_device(*T, qp, 0, i4x4=i4, lam=sad_lambda(qp),
                                    cavlc=True)
        if i4:
            assert (port[3].mb_class == MB_I4).any()
    for a, b in zip(port[:3], ref_out[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _same_syntax(port[3], ref_out[3])


# ---- streams ----

STREAMS = {
    # I4x4 with CAVLC on an I/P GOP
    "i4_cavlc_qp14": (dict(qp=14), 4, None),
    "i4_cavlc_qp26": (dict(qp=26), 4, None),
    "i4_cavlc_qp40": (dict(qp=40), 4, None),
    # at range 16, where tests/test_e2e.py compiles the CAVLC P core
    "i4_cavlc_aq": (dict(qp=26, aq_mode=1, me_range=16), 4, None),
    # the host-entropy backend: the syntax path's scenecut promotes the
    # cut's P frame to an IDR (keyint_min 2), under each coder
    "host_entropy_cabac_cut": (dict(backend="device_host_entropy",
                                    cabac=True, scenecut_threshold=40,
                                    keyint_min=2), 5, 3),
    "host_entropy_cavlc_cut": (dict(backend="device_host_entropy",
                                    i4x4=False, scenecut_threshold=40,
                                    keyint_min=2), 5, 3),
    # the host-entropy backend with B frames (the anchors through the
    # host writers, each B frame on its own core)
    "host_entropy_cabac_b": (dict(backend="device_host_entropy",
                                  cabac=True, bframes=2), 7, None),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_syntax_streams_match_reference_and_decode(name):
    """The port's stream equals the reference's, with the same frame
    types and QPs, and avdec decodes it to the port's recon."""
    kw, n, cut = STREAMS[name]
    classes = []
    port, types = _check(dict(_BASE, **kw), _clip(n, cut=cut), name,
                         classes=classes)
    if cut is not None:
        assert types[cut] == "IDR" and types.count("IDR") == 2, types
    # the I4x4 choice ran: the first IDR holds I4x4 MBs
    assert (classes[0] == MB_I4).any() == kw.get("i4x4", True)


def test_fastdecode_preset_matches_reference_and_decodes():
    """x264's medium preset with tune fastdecode (CAVLC, I4x4, no
    deblock, P16 anchors, B frames, the preset's range 16) at CRF 23
    with AQ, MB-tree and b_adapt=1: the port's stream equals the
    reference's and decodes to its recon."""
    def params(P):
        return P.param_default_preset("medium", "fastdecode").clone(
            width=W, height=H, rc_method=P.RC_CRF, crf=23.0, aq_mode=1,
            mbtree=True, b_adapt=1, keyint_min=3)
    tp, rp = params(t_params), params(r_params)
    assert not tp.cabac and tp.i4x4 and not tp.deblock and tp.bframes
    port, types = _check((tp, rp), _clip(8), "fastdecode")
    assert "B" in types, types


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
def test_reference_backend_matches_reference_and_decodes(cabac):
    """backend="reference": the NumPy tier's I4x4 IDR and P frames, the
    DPB on the encoder's device."""
    kw = dict(_BASE, width=64, height=48, backend="reference", cabac=cabac)
    port, types = _check(kw, _clip(3, 64, 48), "reference", 64, 48)
    assert types == ["IDR", "P", "P"]
    assert isinstance(port.dpb[0].y, torch.Tensor)


def test_host_entropy_t8_fails_to_decode_in_reference():
    """Fault 5: with the host-entropy backend and the 8x8 transform the
    reference's PPS turns the 8x8 mode on but its host-syntax writers
    code no transform_size_8x8_flag, so its stream does not decode to
    its recon; the port refuses the setting."""
    kw = dict(_BASE, backend="device_host_entropy", cabac=True,
              transform_8x8=True)
    frames = _clip(3)
    ref, stream, recons = _encode(r_params, RefEncoder, RefFrame, kw,
                                  frames)
    dec = decode_annexb(stream, W, H)
    assert not (len(dec) == len(recons) and all(
        np.array_equal(np.asarray(recons[d].y)[:H, :W], dec[d][0])
        for d in recons))
    with pytest.raises(NotImplementedError, match="transform_8x8"):
        Encoder(t_params.EncoderParams(**kw), device="cpu")
    kw.pop("backend")
    Encoder(t_params.EncoderParams(**kw), device="cpu")


def test_promoted_anchor_before_b_frames_fails_to_decode_in_reference():
    """Fault 6: the syntax path's scenecut runs after an anchor's encode;
    when it promotes the anchor of a mini-GOP whose B frames are queued
    (a flash in a fade at keyint_min 3, which the lowres scenecut lets
    through), those B frames predict from a picture the IDR drops, so
    the reference's stream does not decode to its recon.  The port
    raises where the reference would write them."""
    from chip_smoke import fade_clip

    def params(P):
        return P.param_default_preset("medium", "fastdecode").clone(
            width=W, height=H, rc_method=P.RC_CRF, crf=23.0, aq_mode=1,
            mbtree=True, b_adapt=1, keyint_min=3)
    frames = fade_clip(W, H, 7, pan=(1, 1))
    ref, stream, recons = _encode(r_params, RefEncoder, RefFrame,
                                  params(r_params), frames)
    types = [s.frame_type for s in ref.stats]
    assert types.count("IDR") > 1 and "B" in types, types
    dec = decode_annexb(stream, W, H)
    assert not (len(dec) == len(recons) and all(
        np.array_equal(np.asarray(recons[d].y)[:H, :W], dec[d][0])
        for d in recons))
    with pytest.raises(NotImplementedError, match="fault 6"):
        _encode(t_params, lambda q: Encoder(q, device="cpu"), Frame420,
                params(t_params), frames)


@pytest.mark.parametrize("kw", [dict(), dict(backend="device_host_entropy",
                                             cabac=True)],
                         ids=["i4_cavlc", "host_entropy"])
def test_pipelined_matches_reference_and_decodes(kw):
    """encode_pipelined runs the reference's fast path for I4x4 + CAVLC
    (its IDRs I16) and for the host-entropy backend: the same bytes, and
    they decode to the port's recon."""
    frames = _clip(4)
    port, stream, recons, ref, ref_stream = _port_and_ref(
        dict(_BASE, **kw), frames, pipelined=True)
    assert stream == ref_stream
    _decodes_to(stream, recons, W, H, str(kw))
