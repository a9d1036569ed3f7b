"""Weighted prediction and multi-reference P in the port against x264_tpu,
on the CPU with tolerance 0 (all integer arithmetic):

- the ops that take a per-MB reference, one parametrised test over
  shared inputs (64x48, three stacked references, random ref_idx):
  ``subpel_refine`` (against the reference's stacked-plane path, the
  one its P core runs) and ``subpel_refine_parts``, ``mc_chroma_uv`` and
  ``mc_chroma_uv_quad``, ``classify_p`` with refs and intra MBs, the
  CABAC blob's ref field, ``apply_weights`` against
  ``apply_weights_jnp``, the te() ref costs, and the slice header's
  pred_weight_table for neutral and non-neutral weights at K = 1-3;
- streams byte-identical to the reference and decoded by tools/avdec
  (libavcodec) bit-exact to the port's recon, on chip_smoke.py's
  ``fade_clip`` (tests/test_weightp.py's fading pan, whose left half
  flashes another texture now and then, so that the frame after a flash
  finds its match two frames back): (a) P16 with ref_frames=3 and
  weightp=1, (b) P8x8 with the 8x8 transform, trellis, ref_frames=2 and
  weightp=1, (c) bframes=2 on P8x8 anchors with ref_frames=2, (d)
  bframes=0 with a scene cut that scenecut promotes to an IDR,
  ref_frames=2 and weightp=1.  Each group also shows that its path ran:
  a non-neutral weight (a, b, d), an MB on ref_idx > 0 (a, b, c), B MBs
  whose direct mode col_ref barred (c), and the promoted IDR restarting
  the weights' source history (d).

Each stream group holds the cases that share the reference's compiled
programs."""

import functools
import os
import tempfile

import numpy as np
import pytest
import torch

# a compile cache per xdist worker: the shared one has crashed a worker
os.environ.setdefault("X264_TPU_JAX_CACHE", os.path.join(
    tempfile.gettempdir(),
    f"x264_tpu_jax_{os.environ.get('PYTEST_XDIST_WORKER', 'main')}"))
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
import x264_tpu.bitstream.bits as r_bits  # noqa: E402
import x264_tpu.bitstream.headers as r_headers  # noqa: E402
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import inter_device  # noqa: E402
from x264_tpu.models import weightp as r_wp  # noqa: E402
from x264_tpu.ops.device import entropy_pack as d_ep  # noqa: E402
from x264_tpu.ops.device import header as d_hdr  # noqa: E402
from x264_tpu.ops.device import mc as d_mc  # noqa: E402
from x264_tpu.ops.device import me as d_me  # noqa: E402
from x264_tpu.ops.device import me_parts as d_mp  # noqa: E402
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from chip_smoke import fade_clip  # noqa: E402
import x264_tpu_torch.api as t_api  # noqa: E402
import x264_tpu_torch.bitstream.bits as t_bits  # noqa: E402
import x264_tpu_torch.bitstream.headers as t_headers  # noqa: E402
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.models import inter  # noqa: E402
from x264_tpu_torch.models import weightp as t_wp  # noqa: E402
from x264_tpu_torch.ops import entropy_pack as t_ep  # noqa: E402
from x264_tpu_torch.ops import header as t_hdr  # noqa: E402
from x264_tpu_torch.ops import mc as t_mc  # noqa: E402
from x264_tpu_torch.ops import me as t_me  # noqa: E402
from x264_tpu_torch.ops import me_parts as t_mp  # noqa: E402
from x264_tpu_torch.ops.header import B_DIRECT  # noqa: E402
from x264_tpu_torch.state import PAD  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

MBW, MBH, K, MER = 4, 3, 3, 8
N = MBW * MBH


def T(a):
    return torch.as_tensor(np.asarray(a))


def J(fn, **static):
    """The reference function jitted with its static arguments bound (one
    compiled program instead of op-by-op dispatch)."""
    return jax.jit(functools.partial(fn, **static))


def _eq(port, ref, msg=""):
    p = port.numpy() if torch.is_tensor(port) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (msg, p.shape, r.shape)
    np.testing.assert_array_equal(p, r, err_msg=msg)


def _inputs():
    """The op cases' shared inputs: a 64x48 source, three stacked padded
    luma and chroma references, each MB's ref_idx (every value taken),
    fullpel mvs per MB and per quadrant, partition shapes, chroma mvs.
    The cases that need more draw it from a generator of their own, so
    that no input depends on the order the cases run in."""
    rng = np.random.default_rng(0x264)
    h, w = 16 * MBH, 16 * MBW
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ry = rng.integers(0, 256, (K, h + 2 * PAD, w + 2 * PAD)).astype(np.uint8)
    pc = PAD // 2
    ru = rng.integers(0, 256, (K, h // 2 + 2 * pc, w // 2 + 2 * pc))
    rv = rng.integers(0, 256, ru.shape)
    ref_idx = rng.permutation(np.arange(N) % K).astype(np.int32)
    mv = (rng.integers(-MER, MER + 1, (N, 2)) * 4).astype(np.int32)
    mv8 = (rng.integers(-MER, MER + 1, (N, 4, 2)) * 4).astype(np.int32)
    return dict(
        src=src, src_mbs=(src.reshape(MBH, 16, MBW, 16).transpose(0, 2, 1, 3)
                          .reshape(N, 16, 16).astype(np.int32)),
        ry=ry, ru=ru.astype(np.uint8), rv=rv.astype(np.uint8),
        ref_idx=ref_idx, mv=mv, mv8=mv8,
        shape=rng.integers(0, 4, N).astype(np.int32),
        cmv=rng.integers(-60, 61, (N, 2)).astype(np.int32),
        cmv8=rng.integers(-60, 61, (N, 4, 2)).astype(np.int32))


def _case_subpel_refine(d):
    planes = jnp.stack([d_mc.hpel_planes(jnp.asarray(d["ry"][k]))
                        for k in range(K)])
    for steps in (1, 2):
        want = J(d_me.subpel_refine, me_range=MER, steps=steps, mbw=MBW,
                 mbh=MBH, return_pred=True)(
            jnp.asarray(d["src_mbs"]), planes, jnp.asarray(d["mv"]),
            np.int32(9), ref_idx=jnp.asarray(d["ref_idx"]))
        got = t_me.subpel_refine(T(d["src_mbs"]), T(d["ry"]), T(d["mv"]), 9,
                                 MER, steps, MBW, MBH, return_pred=True,
                                 ref_idx=T(d["ref_idx"]))
        for g, w, k in zip(got, want, ("mv", "cost", "pred")):
            _eq(g, w, f"steps {steps} {k}")


def _case_subpel_refine_parts(d):
    for steps in (1, 2):
        want = J(d_mp.subpel_refine_parts, me_range=MER, steps=steps,
                 mbw=MBW, mbh=MBH)(
            jnp.asarray(d["src_mbs"]), jnp.asarray(d["mv8"]),
            jnp.asarray(d["shape"]), np.int32(9),
            ref_idx=jnp.asarray(d["ref_idx"]), ref_pad=jnp.asarray(d["ry"]))
        got = t_mp.subpel_refine_parts(
            T(d["src_mbs"]), T(d["mv8"]), T(d["shape"]), 9, MER, steps, MBW,
            MBH, T(d["ry"]), ref_idx=T(d["ref_idx"]))
        for g, w, k in zip(got, want, ("mv8", "cost", "pred")):
            _eq(g, w, f"steps {steps} {k}")


def _case_mc_chroma_uv(d):
    want = d_mc.mc_chroma_uv(jnp.asarray(d["ru"]), jnp.asarray(d["rv"]),
                             jnp.asarray(d["cmv"]), MBW, MBH, PAD // 2,
                             ref_idx=jnp.asarray(d["ref_idx"]))
    got = t_mc.mc_chroma_uv(T(d["ru"]), T(d["rv"]), T(d["cmv"]), MBW, MBH,
                            PAD // 2, ref_idx=T(d["ref_idx"]))
    for g, w in zip(got, want):
        _eq(g, w)


def _case_mc_chroma_uv_quad(d):
    want = d_mc.mc_chroma_uv_quad(jnp.asarray(d["ru"]), jnp.asarray(d["rv"]),
                                  jnp.asarray(d["cmv8"]), MBW, MBH, PAD // 2,
                                  ref_idx=jnp.asarray(d["ref_idx"]))
    got = t_mc.mc_chroma_uv_quad(T(d["ru"]), T(d["rv"]), T(d["cmv8"]), MBW,
                                 MBH, PAD // 2, ref_idx=T(d["ref_idx"]))
    for g, w in zip(got, want):
        _eq(g, w)


def _case_classify_p(d):
    """Few distinct mvs and refs, many zeros: the one-match rule, the
    median and P_Skip (which needs ref 0) all occur."""
    rng = np.random.default_rng(1)
    mbw, mbh = 7, 5
    n = mbw * mbh
    for trial in range(4):
        mv = (rng.integers(-1, 2, (n, 2)) * 4).astype(np.int32)
        mv[rng.random(n) < 0.4] = 0
        ref = (rng.integers(0, K, n) * (rng.random(n) < 0.5)).astype(np.int32)
        cbp_l = (rng.integers(0, 16, n) * (rng.random(n) < 0.3)
                 ).astype(np.int32)
        cbp_c = (rng.integers(0, 3, n) * (rng.random(n) < 0.3)
                 ).astype(np.int32)
        intra = None if trial == 0 else rng.random(n) < 0.15
        want = J(d_hdr.classify_p, mbw=mbw, mbh=mbh)(
            jnp.asarray(mv), jnp.asarray(cbp_l), jnp.asarray(cbp_c),
            ref=jnp.asarray(ref),
            intra=None if intra is None else jnp.asarray(intra))
        got = t_hdr.classify_p(T(mv), T(cbp_l), T(cbp_c), mbw, mbh,
                               ref=T(ref),
                               intra=None if intra is None else T(intra))
        for g, w in zip(got, want):
            _eq(g, w, f"trial {trial}")
        skip = got[0].numpy() == t_hdr.MB_PSKIP_D
        assert skip.any() and not (skip & (ref != 0)).any()


def _case_cabac_blob(d):
    rng = np.random.default_rng(2)

    def sparse(shape, density, lim=300):
        return (rng.integers(-lim, lim + 1, shape)
                * (rng.random(shape) < density)).astype(np.int32)

    args = [sparse((N, 16), .5), sparse((N, 16, 16), .3),
            sparse((N, 2, 4), .5), sparse((N, 2, 4, 16), .3)]
    fields = [rng.integers(0, 4, N), rng.integers(-40, 41, (N, 2)),
              rng.integers(0, 4, N), rng.integers(0, 4, N),
              rng.integers(0, 16, N), rng.integers(0, 3, N),
              rng.integers(0, 52, N), rng.integers(0, 5000, N),
              rng.integers(0, 5000, N)]
    fields = [f.astype(np.int32) for f in fields]
    t8 = rng.random(N) < 0.5
    ref8 = np.repeat(d["ref_idx"][:, None], 4, 1)
    mvd_part = rng.integers(-9, 10, (N, 4, 2)).astype(np.int32)
    for parts in (False, True):
        pk = (dict(shape=d["shape"], mvd_part=mvd_part, ref_part=ref8)
              if parts else {})
        want = J(d_ep.cabac_blob, K=96)(
            *map(jnp.asarray, args + fields), t8=jnp.asarray(t8),
            ref=jnp.asarray(d["ref_idx"]),
            **{k: jnp.asarray(v) for k, v in pk.items()})
        got = t_ep.cabac_blob(*map(T, args + fields), K=96, t8=T(t8),
                              ref=T(d["ref_idx"]),
                              **{k: T(v) for k, v in pk.items()})
        _eq(got, want, f"parts {parts}")
        st = t_ep.blob_stride(parts=parts)
        row_ref = got[:N * st].reshape(N, st)[:, 14 + 11]
        _eq(row_ref, d["ref_idx"], "the ref field")


def _case_apply_weights(d):
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 256, (N, 16, 16)).astype(np.int32)
    wts = np.array([[64, 0], [37, -20], [127, 90]], np.int32)
    want = r_wp.apply_weights_jnp(jnp.asarray(pred), jnp.asarray(wts),
                                  jnp.asarray(d["ref_idx"]))
    got = t_wp.apply_weights(T(pred), T(wts), T(d["ref_idx"]))
    _eq(got, want)
    assert got.dtype == torch.int32
    assert torch.equal(got[d["ref_idx"] == 0], T(pred[d["ref_idx"] == 0]))
    assert got.min() == 0 and got.max() == 255


def _case_te_ref_bits(d):
    for k in range(1, 6):
        _eq(inter._te_ref_bits(k), inter_device._te_ref_bits(k), f"K {k}")


def _case_pred_weight_table(d):
    """The P slice header (pred_weight_table in it) at K = 1-3 with
    neutral and non-neutral weights, and None (all neutral)."""
    kw = dict(width=64, height=48, cabac=True, weightp=1, ref_frames=3)
    tp = EncoderParams(**kw).validate()
    rp = RefParams(**kw).validate()
    tsps, rsps = t_headers.sps_from_params(tp), r_headers.sps_from_params(rp)
    tables = [None, [t_wp.NEUTRAL] * 3, [(37, -20), t_wp.NEUTRAL, (70, 3)],
              [(64, 5), (63, 0), (0, -128)]]
    for num_ref in (1, 2, 3):
        for weights in tables:
            out = []
            for bits, hdr, p, sps in ((t_bits, t_headers, tp, tsps),
                                      (r_bits, r_headers, rp, rsps)):
                bs = bits.BitWriter()
                hdr.write_slice_header(bs, p, sps, slice_type=hdr.SLICE_P,
                                       idr=False, frame_num=3, qp=26,
                                       num_ref=num_ref, poc_lsb=6,
                                       weights=weights)
                out.append((bs.bit_length, bs.to_rbsp()))
            assert out[0] == out[1], (num_ref, weights)


OP_CASES = {name[len("_case_"):]: fn for name, fn in globals().items()
            if name.startswith("_case_")}


@pytest.fixture(scope="module")
def op_inputs():
    return _inputs()


@pytest.mark.parametrize("case", list(OP_CASES))
def test_multiref_ops_match_reference(op_inputs, case):
    OP_CASES[case](op_inputs)


# ---- streams ----

def _params(ref=False, **kw):
    base = dict(width=64, height=48, qp=26, me_range=8, subpel=2, cabac=True,
                deblock=True, bframes=0, keyint_max=250, scenecut_threshold=0,
                backend="device", weightp=1)
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


TOOLS = dict(transform_8x8=True, trellis=1)
# group -> (settings, fade_clip arguments: frames, pan, flashes, cut)
STREAM_GROUPS = {
    "p16_ref3": (dict(ref_frames=3), dict(n=5)),
    "p8x8_tools_ref2": (dict(TOOLS, ref_frames=2, p8x8=True), dict(n=4)),
    "bframes_ref2": (dict(ref_frames=2, p8x8=True, bframes=2,
                          full_recon=True),
                     dict(n=7, pan=(1, 1), flash=(3,))),
    "scenecut_ref2": (dict(ref_frames=2, scenecut_threshold=40,
                           keyint_min=1), dict(n=6, flash=(), cut=3)),
}


@pytest.mark.parametrize("group", list(STREAM_GROUPS))
def test_multiref_streams_match_reference_and_decode(group, monkeypatch):
    kw, clip_kw = STREAM_GROUPS[group]
    frames = [Frame420(*f) for f in fade_clip(64, 48, **clip_kw)]
    n = len(frames)
    port = Encoder(_params(**kw), device="cpu")
    wts, refs, hist = [], [], []
    run_core = port._run_core

    def spy(*a, **k):
        out, st = run_core(*a, **k)
        if k.get("wts") is not None:
            wts.append(k["wts"].numpy())
        if "ref_mb" in out:
            refs.append(out["ref_mb"].numpy())
        return out, st
    port._run_core = spy
    b_outs = []
    b_pair_core = t_api.b_pair_core

    def pair_spy(*a, **k):
        outs = b_pair_core(*a, **k)
        b_outs.append((k["col_ref"], outs))
        return outs
    monkeypatch.setattr(t_api, "b_pair_core", pair_spy)
    recons = {}
    port.recon_hook = recons.__setitem__
    stream = b""
    for f in frames:
        stream += port.encode(f)
        hist.append(len(port._src_hist))
    stream += port.flush()
    ref = RefEncoder(_params(ref=True, **kw))
    ref_hist = []
    want = b""
    for f in frames:
        want += ref.encode(f)
        ref_hist.append(len(ref._src_hist))
    assert stream == want + ref.flush()
    assert hist == ref_hist

    dec = decode_annexb(stream, 64, 48)
    assert len(dec) == n == len(recons)
    for d in range(n):
        for p_rec, p_dec in zip((recons[d].y, recons[d].u, recons[d].v),
                                dec[d]):
            hh, ww = p_dec.shape
            np.testing.assert_array_equal(p_rec[:hh, :ww].numpy(), p_dec,
                                          err_msg=f"display {d}")

    # the path really ran
    neutral = np.asarray(t_wp.NEUTRAL)
    if group != "bframes_ref2":
        assert any((w != neutral).any() for w in wts), wts
    if group != "scenecut_ref2":
        assert any((r > 0).any() for r in refs), refs
    if group == "bframes_ref2":
        barred = [(col_ref > 0).any(1) for col_ref, _ in b_outs
                  if col_ref is not None]
        assert len(b_outs) == 2 and any(m.any() for m in barred)
        for col_ref, outs in b_outs:
            if col_ref is not None:
                m = (col_ref > 0).any(1)
                for o in outs:
                    assert not (o["bmode"][m] == B_DIRECT).any()
    if group == "scenecut_ref2":
        types = [s.frame_type for s in port.stats]
        assert types == ["IDR", "P", "P", "IDR", "P", "P"], types
        # the promoted IDR restarts the source history with its own frame
        assert hist == [1, 2, 2, 1, 2, 2], hist
