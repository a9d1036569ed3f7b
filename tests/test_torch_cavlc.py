"""CAVLC on the device in the port against x264_tpu, on the CPU with
tolerance 0 (all integer arithmetic):

- ``code_blocks_plain`` (the twin of the CUDA kernel
  ``csrc/cavlc_blocks.cu``) against ``ops/device/cavlc.code_blocks`` on
  random blocks: every block length (4, 15, 16), nC -2, -1 and 0-16,
  runs of trailing ones, and levels that reach both escape lengths (28
  and 30 bits);
- ``pack_tokens_plain`` (the twin of ``csrc/bitpack.cu``) against
  ``ops/device/bitpack.pack_tokens``, with MBs past the word budget;
- on a 96x64 frame's core outputs (the reference's I16, P16, P8x8 on two
  weighted references with the 8x8 transform, and B cores, all CAVLC):
  ``residual_slots``, the header writers (``header_slots``,
  ``header_slots_parts``, ``header_slots_b``) and the port's core on the
  same inputs, ``host_blob`` included;
- streams byte-identical to the reference and decoded by tools/avdec
  (libavcodec) bit-exact to the port's recon, at 96x64 and the odd 90x58
  (cropped, on 96x64's programs):
  I/P16 at QP 0, 26 and 51; I/P8x8 with the 8x8 transform and weightp=1
  on two references; I/B/P8x8 with bframes=2, full_recon off and on (the
  second with the 8x8 transform, which B frames do not select with
  CAVLC); ABR; and a ladder overflow (QP 0 on noise re-runs at the
  second rung);
- I4x4 with CAVLC opens (the host-syntax path), and with P8x8 still
  raises ``NotImplementedError``.

Each test holds the cases that share the reference's compiled programs."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from _stream_bases import MID, ODD  # noqa: E402
from _test_clock import per_test_clock  # noqa: E402,F401
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import b_frame_device, inter_device  # noqa: E402
from x264_tpu.models import intra_device  # noqa: E402
from x264_tpu.models.inter_frame import sad_lambda  # noqa: E402
from x264_tpu.ops.device import bitpack as r_bitpack  # noqa: E402
from x264_tpu.ops.device import cavlc as r_cavlc  # noqa: E402
from x264_tpu.ops.device import header as r_header  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from chip_smoke import fade_clip, split_motion_clip  # noqa: E402
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.kernels import bitpack  # noqa: E402
from x264_tpu_torch.models import b_frame, inter, intra  # noqa: E402
from x264_tpu_torch.ops import cavlc, header  # noqa: E402
from x264_tpu_torch.params import RC_ABR  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

W, H = MID
MBW, MBH = W // 16, H // 16
N_WORDS = 64          # the encoder's first CAVLC rung


def T(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=msg)


# ---- the block coder ----

def _blocks(levels: str, b: int = 4096, seed: int = 10):
    """Random zigzag blocks: lengths 4/15/16 (nC -1 or -2 on length 4, as
    chroma DC, else 0-16), a density per block, magnitudes by ``levels``
    (all +-1, small, large, or large enough for both level escapes)."""
    rng = np.random.default_rng(seed)
    blen = rng.choice([4, 15, 16], b).astype(np.int32)
    nc = rng.integers(0, 17, b).astype(np.int32)
    dc = blen == 4
    nc[dc] = rng.choice([-1, -2], int(dc.sum()))
    mag = {"ones": np.ones((b, 16), np.int64),
           "small": rng.integers(1, 4, (b, 16)),
           "large": rng.integers(1, 60, (b, 16)),
           "escape": rng.integers(1, 9000, (b, 16))}[levels]
    live = rng.random((b, 16)) < rng.random((b, 1))
    coefs = np.where(live, rng.choice([-1, 1], (b, 16)) * mag, 0)
    coefs[np.arange(16)[None, :] >= blen[:, None]] = 0
    return coefs.astype(np.int32), blen, nc


@pytest.mark.parametrize("levels", ["ones", "small", "large", "escape"])
def test_code_blocks_plain_matches_reference(levels):
    coefs, blen, nc = _blocks(levels)
    rv, rl = r_cavlc.code_blocks(jnp.asarray(coefs), jnp.asarray(blen),
                                 jnp.asarray(nc))
    pv, pl = cavlc.code_blocks_plain(T(coefs), T(blen), T(nc))
    _eq(pv, rv, "vals")
    _eq(pl, rl, "lens")
    # the cases reach what they are for
    assert set(nc.tolist()) == set(range(-2, 17))
    pl = pl.numpy()
    if levels == "ones":
        assert (pl[:, 3] == 1).any()           # three trailing ones
    if levels == "escape":
        assert (pl == 28).any() and (pl == 30).any()
    # the CPU wrapper: the twin, lengths of gated-off blocks zeroed
    gate = np.arange(len(blen)) % 3 != 0
    gv, gl = cavlc.code_blocks(T(coefs), T(blen), T(nc), T(gate))
    _eq(gv, rv)
    _eq(gl, np.where(gate[:, None], np.asarray(rl), 0))


# ---- the bit packer ----

@pytest.mark.parametrize("n_words", [4, 64, 416])
def test_pack_tokens_plain_matches_reference(n_words):
    """981 slots per MB (a P16 MB's: 9 header slots, 27 blocks x 36),
    tokens of 1-30 bits whose values fit them, MB densities from sparse
    to past 64 words."""
    rng = np.random.default_rng(20 + n_words)
    n, s = 48, 981
    lens = rng.integers(1, 31, (n, s))
    dens = 0.02 + 0.48 * rng.random((n, 1))
    lens = np.where(rng.random((n, s)) < dens, lens, 0)
    vals = rng.integers(0, 1 << 30, (n, s)) & ((1 << lens) - 1)
    vals, lens = vals.astype(np.int32), lens.astype(np.int32)
    rw, rn = r_bitpack.pack_tokens(jnp.asarray(vals), jnp.asarray(lens),
                                   n_words)
    pw, pn = bitpack.pack_tokens(T(vals), T(lens), n_words)
    _eq(pw, np.asarray(rw).view(np.int32), "words")
    _eq(pn, rn, "nbits")
    over = int((np.asarray(rn) > 32 * n_words).sum())
    assert over == n if n_words == 4 else (0 < over < n if n_words == 64
                                           else over == 0), over


@pytest.mark.parametrize("n_words", [1, 64, 416])
def test_cavlc_blob_matches_reference_pack_and_merge(n_words):
    """``cavlc_blob`` and ``bitpack.place`` on the CPU (the twins of
    csrc/bitpack.cu): the blob equals the reference's pack_tokens over the
    header and residual grids side by side, then nbits and the fields (the
    reference cores' blob layout); the payload equals the reference's host
    merge
    (x264_tpu/bitstream/slice_assemble.merge_mb_strings) of those words
    over the whole merged length, zeros after it, on frames of 1, 7 and
    24 MBs with an empty row; MBs past the budget keep
    their first words and true nbits in the blob."""
    from x264_tpu.bitstream.slice_assemble import merge_mb_strings
    rng = np.random.default_rng(40 + n_words)
    for trial, (n, h) in enumerate(((1, 9), (24, 22), (7, 10), (24, 9))):
        lens = rng.integers(1, 31, (n, h + 972))
        lens = np.where(rng.random(lens.shape) < rng.random((n, 1)) * 0.3,
                        lens, 0)
        if trial % 2:     # fit the budget, so the merge is the payload
            lens = np.where(np.cumsum(lens, 1) <= 32 * n_words, lens, 0)
        lens[n // 2] = 0                              # an empty row
        vals = rng.integers(0, 1 << 30, lens.shape) & ((1 << lens) - 1)
        vals, lens = vals.astype(np.int32), lens.astype(np.int32)
        fields = [rng.integers(-5, 9, n).astype(np.int32) for _ in range(3)]
        blob = cavlc.cavlc_blob(T(vals[:, :h]), T(lens[:, :h]),
                                T(vals[:, h:]), T(lens[:, h:]), n_words,
                                [T(f) for f in fields])
        pay = bitpack.place(blob, n_words)
        rw, rn = r_bitpack.pack_tokens(jnp.asarray(vals), jnp.asarray(lens),
                                       n_words)
        rw = np.asarray(rw).view(np.int32)
        _eq(blob, np.concatenate([rw, np.asarray(rn)[:, None]]
                                 + [f[:, None] for f in fields], 1), "blob")
        assert pay.shape == (n * n_words + 1,)
        if trial % 2:
            ref, total = merge_mb_strings(rw.view(np.uint32), np.asarray(rn))
            got = pay.numpy().view(np.uint32)
            m = min(len(ref), len(got))
            _eq(got[:m], ref[:m], "payload")
            assert not got[m:].any() and not ref[m:].any()
            assert total == int(lens.sum())


def test_residual_slots_random_fields_match_reference():
    """``residual_slots`` on the CPU (the twin of csrc/cavlc_blocks.cu) on
    random fields against the reference's: frames of 1x1, 5x2 and 6x4 MBs,
    I16 and other MBs, every cbp, counts 0-16 across MB borders, levels
    past both escapes."""
    rng = np.random.default_rng(77)
    for trial, (mbw, mbh) in enumerate(((1, 1), (6, 4), (5, 2), (6, 4))):
        n = mbw * mbh

        def lv(shape):
            mag = rng.integers(1, (2, 4, 60, 9000)[trial % 4], shape)
            live = rng.random(shape) < rng.random(shape[:-1] + (1,))
            return np.where(live, rng.choice([-1, 1], shape) * mag, 0
                            ).astype(np.int32)
        args = [lv((n, 16)), lv((n, 16, 16)),
                rng.integers(0, 17, (n, 16)).astype(np.int32),
                lv((n, 2, 4)), lv((n, 2, 4, 16)),
                rng.integers(0, 16, (n, 2, 4)).astype(np.int32),
                rng.integers(0, 16, n).astype(np.int32),
                rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.5]
        rv, rl = r_cavlc.residual_slots(*map(jnp.asarray, args), mbw, mbh)
        pv, pl = cavlc.residual_slots(*map(T, args), mbw, mbh)
        _eq(pv, rv, f"vals {trial}")
        _eq(pl, rl, f"lens {trial}")


# ---- the slots and the cores on a 96x64 frame ----

def _frames():
    """Three 96x64 frames with motion at 8-px grain (so partitions are
    chosen), the second with a gradient patch that only intra predicts
    well."""
    fr = [[np.array(p) for p in f] for f in split_motion_clip(W, H, 3)]
    yy, xx = np.mgrid[0:16, 0:32]
    fr[1][0][16:32, 32:64] = (40 + 6 * yy + 3 * xx).astype(np.uint8)
    return [tuple(f) for f in fr]


def _slots_vs_reference(ref):
    """residual_slots on the reference core's fields against the
    reference's function on the same fields."""
    n = MBW * MBH
    is_i16 = np.asarray(ref["mb_class"]) == 0
    keys = ("luma_dc", "luma_ac", "luma_nnz", "chroma_dc", "chroma_ac",
            "chroma_nnz", "cbp_luma", "cbp_chroma")
    rv, rl = r_cavlc.residual_slots(*(ref[k] for k in keys),
                                    jnp.asarray(is_i16), MBW, MBH)
    pv, pl = cavlc.residual_slots(*(T(ref[k]) for k in keys), T(is_i16),
                                  MBW, MBH)
    assert pv.shape == (n, 27 * 36)
    _eq(pv, rv, "res_vals")
    _eq(pl, rl, "res_lens")
    if "res_lens" in ref:
        _eq(pl, ref["res_lens"], "core res_lens")


def _cores_agree(port, ref):
    """Every field the port's core returns equals the reference core's."""
    assert "host_blob" in port and set(port) <= set(ref), \
        set(port) - set(ref)
    for k in port:
        _eq(port[k].to(torch.int64), np.asarray(ref[k]).astype(np.int64), k)


def _case_i16(fr):
    qp = 26
    ref = intra_device.i_frame_core(*map(jnp.asarray, fr[0]), np.int32(qp),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    n_words=N_WORDS)
    _slots_vs_reference(ref)
    f = {k: ref[k] for k in ("mb_class", "i16_mode", "chroma_mode",
                             "cbp_luma", "cbp_chroma", "qp_mb")}
    args = (f["mb_class"], f["i16_mode"], f["chroma_mode"],
            np.zeros((MBW * MBH, 2), np.int32), f["cbp_luma"],
            f["cbp_chroma"], f["qp_mb"])
    _eq(header.header_slots(*map(T, args), is_p_slice=False)[0],
        r_header.header_slots(*map(jnp.asarray, args), is_p_slice=False)[0])
    port = intra.i_frame_core(*map(T, fr[0]), qp, mbw=MBW, mbh=MBH,
                              cqp_off=0, n_words=N_WORDS)
    _cores_agree(port, ref)


def _p_case(fr, parts: bool):
    """P16 on one reference, or P8x8 with the 8x8 transform on two
    references with a non-neutral weight on the second."""
    qp, lam = 26, sad_lambda(26)
    if parts:
        refs = [np.stack([fr[0][c], fr[2][c]]) for c in range(3)]
        wts = np.array([[64, 0], [58, 3]], np.int32)
        kw = dict(parts=True, t8=True)
    else:
        refs, wts, kw = list(fr[0]), None, {}
    ref = inter_device.p_frame_core(
        *map(jnp.asarray, fr[1]), *map(jnp.asarray, refs), np.int32(qp),
        np.int32(lam), mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=2,
        n_words=N_WORDS, wts=None if wts is None else jnp.asarray(wts), **kw)
    _slots_vs_reference(ref)
    t8 = ref["t8"] if parts else None
    if parts:
        args = (ref["mb_class"], ref["shape"], ref["i16_mode"],
                ref["chroma_mode"], ref["mvd_part"], ref["ref8"],
                ref["cbp_luma"], ref["cbp_chroma"], ref["qp_mb"])
        want = r_header.header_slots_parts(*args, num_ref=2, t8=t8)
        got = header.header_slots_parts(*map(T, args), num_ref=2, t8=T(t8))
        assert int(np.asarray(ref["shape"]).max()) > 0
    else:
        args = (ref["mb_class"], ref["i16_mode"], ref["chroma_mode"],
                ref["mvd"], ref["cbp_luma"], ref["cbp_chroma"], ref["qp_mb"])
        want = r_header.header_slots(*args, is_p_slice=True,
                                     ref=ref["ref_mb"], num_ref=1)
        got = header.header_slots(*map(T, args), is_p_slice=True,
                                  ref=T(ref["ref_mb"]), num_ref=1)
    _eq(got[0], want[0], "hvals")
    _eq(got[1], want[1], "hlens")
    port = inter.p_frame_core(*map(T, fr[1]), *map(T, refs), qp, lam,
                              mbw=MBW, mbh=MBH, me_range=8, cqp_off=0,
                              subpel=2, n_words=N_WORDS,
                              wts=None if wts is None else T(wts), **kw)
    _cores_agree(port, ref)
    classes = set(port["mb_class"].tolist())
    assert {0, 2} <= classes, classes      # intra-in-P and inter MBs


def _case_b(fr):
    """A B frame between f0 and f2 with t8_mode on: with CAVLC no MB
    takes the 8x8 transform and the header writes every flag as 0."""
    qp, lam = 26, sad_lambda(26)
    n = MBW * MBH
    rng = np.random.default_rng(5)
    col_mv = np.broadcast_to(np.array([12, 8], np.int32), (n, 4, 2)).copy()
    col_intra = rng.random(n) < 0.15
    ref = b_frame_device.b_frame_core(
        *map(jnp.asarray, fr[1] + fr[0] + fr[2]), jnp.asarray(col_mv),
        jnp.asarray(col_intra), np.int32(128), np.int32(qp), np.int32(lam),
        mbw=MBW, mbh=MBH, me_range=8, cqp_off=0, subpel=2,
        n_words=N_WORDS, t8_mode=True)
    _slots_vs_reference(ref)
    mb_class = np.asarray(ref["mb_class"])
    args = (ref["bmode"], mb_class == 3, ref["mvd0"], ref["mvd1"],
            ref["cbp_luma"], ref["cbp_chroma"], ref["qp_mb"])
    extra = (mb_class == 0, ref["i16_mode"], ref["chroma_mode"])
    want = r_header.header_slots_b(*map(jnp.asarray, args), t8_mode=True,
                                   intra=jnp.asarray(extra[0]),
                                   i16_mode=extra[1], chroma_mode=extra[2])
    got = header.header_slots_b(*map(T, args), t8_mode=True,
                                intra=T(extra[0]), i16_mode=T(extra[1]),
                                chroma_mode=T(extra[2]))
    _eq(got[0], want[0], "hvals")
    _eq(got[1], want[1], "hlens")
    assert int(got[1][:, 8].sum()) > 0 and not got[0][:, 8].any()
    port = b_frame.b_frame_core(*map(T, fr[1] + fr[0] + fr[2]), T(col_mv),
                                T(col_intra), 128, qp, lam, mbw=MBW,
                                mbh=MBH, me_range=8, cqp_off=0, subpel=2,
                                n_words=N_WORDS, t8_mode=True)
    _cores_agree(port, ref)
    assert not port["t8"].any()


CORE_CASES = {"i16": _case_i16,
              "p16": lambda fr: _p_case(fr, parts=False),
              "p8x8_t8_ref2": lambda fr: _p_case(fr, parts=True),
              "b_t8": _case_b}


@pytest.mark.parametrize("core", list(CORE_CASES))
def test_slots_and_core_match_reference(core):
    CORE_CASES[core](_frames())


# ---- streams ----

def _params(w, h, ref=False, **kw):
    base = dict(width=w, height=h, qp=26, me_range=8, subpel=2, cabac=False,
                deblock=True, bframes=0, keyint_max=250,
                scenecut_threshold=0, backend="device")
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


def _noise(w, h, n):
    rng = np.random.default_rng(9)
    return [(rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
            for _ in range(n)]


# group -> (width, height, [settings per stream], clip)
STREAM_GROUPS = {
    "p16_qps": (W, H, [dict(qp=q) for q in (0, 26, 51)],
                lambda w, h: split_motion_clip(w, h, 4)),
    "p8x8_t8_weightp_ref2": (W, H, [dict(p8x8=True, transform_8x8=True,
                                         weightp=1, ref_frames=2)],
                             lambda w, h: fade_clip(w, h, n=4)),
    "bframes": (W, H, [dict(bframes=2, p8x8=True, full_recon=False),
                       dict(bframes=2, p8x8=True, full_recon=True,
                            transform_8x8=True)],
                lambda w, h: split_motion_clip(w, h, 6)),
    "abr": (W, H, [dict(rc_method=RC_ABR, bitrate=400)],
            lambda w, h: split_motion_clip(w, h, 5)),
    "overflow": (W, H, [dict(qp=0)], lambda w, h: _noise(w, h, 3)),
    "p16_odd": (*ODD, [{}],
                    lambda w, h: split_motion_clip(w, h, 3)),
    "bframes_odd": (*ODD, [dict(bframes=2, p8x8=True,
                                        full_recon=True,
                                        transform_8x8=True, weightp=1,
                                        ref_frames=2)],
                        lambda w, h: fade_clip(w, h, n=4)),
}


@pytest.mark.parametrize("group", list(STREAM_GROUPS))
def test_cavlc_streams_match_reference_and_decode(group):
    w, h, settings, clip = STREAM_GROUPS[group]
    frames = [Frame420(*f) for f in clip(w, h)]
    for kw in settings:
        port = Encoder(_params(w, h, **kw), device="cpu")
        recons, anchors, budgets = {}, [], []
        port.recon_hook = recons.__setitem__
        submit, run_core = port._submit_anchor, port._run_core

        def anchor_spy(fr, disp, ftype):
            anchors.append(disp)
            return submit(fr, disp, ftype)

        def core_spy(*a, **k):
            budgets.append(a[7])
            return run_core(*a, **k)
        port._submit_anchor, port._run_core = anchor_spy, core_spy
        stream = b"".join(port.encode(f) for f in frames) + port.flush()
        ref = RefEncoder(_params(w, h, ref=True, **kw))
        want = b"".join(ref.encode(f) for f in frames) + ref.flush()
        assert stream == want, kw

        dec = decode_annexb(stream, w, h)
        assert len(dec) == len(frames) == len(recons)
        # with full_recon off a B frame's recon is not deblocked
        check = (range(len(frames)) if kw.get("full_recon", True)
                 or not kw.get("bframes") else anchors)
        for d in check:
            for p_rec, p_dec in zip((recons[d].y, recons[d].u,
                                     recons[d].v), dec[d]):
                hh, ww = p_dec.shape
                np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(),
                                              p_dec, err_msg=f"{kw} {d}")
        types = [s.frame_type for s in port.stats]
        if kw.get("bframes"):
            assert "B" in types, types
        if group == "overflow":
            # every frame overflowed 64 words per MB and was re-run at 416
            # (the IDR's re-run ratchets the floor, so the P frames start
            # there)
            assert budgets == [64, 416, 416, 416], budgets
            assert port._rung_floor == 416


def test_i4x4_with_cavlc_raises():
    """I4x4 with CAVLC runs on the host-syntax path
    (tests/test_torch_syntax.py); with P8x8 partitions the reference's
    validate() still refuses it, and so does the port's."""
    Encoder(_params(W, H, i4x4=True), device="cpu")
    with pytest.raises(NotImplementedError):
        Encoder(_params(W, H, i4x4=True, p8x8=True, bframes=2),
                device="cpu")
    Encoder(_params(W, H, i4x4=True, cabac=True), device="cpu")
