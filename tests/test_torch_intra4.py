"""The I4x4 / I8x8 IDR core of the port against x264_tpu, on the CPU with
tolerance 0 (all integer arithmetic):

- ``predict_4x4_all`` / ``predict_8x8_all`` and the mode-availability
  masks, over every availability combination and random edges;
- the CABAC blob's I_NxN mode words (mode 8 in the top nibble wraps);
- ``nxn_candidates_plain`` (the NxN kernel's twin): every step's
  candidates of the MBs whose I4x4 or I8x8 candidate won equal the
  reference core's fields for them;
- ``i4_frame_core`` against ``intra_device.i4_frame_core``: every output
  field, the recon planes and ``host_blob``, at QP 0, 26 and 51 (one
  compile: QP is traced), 64x48 with ``t8_mode`` off and on, each with
  trellis off and 1, and 96x64 with both; the content makes I16x16,
  I4x4 and (with t8_mode) I8x8 MBs occur;
- streams with ``i4x4=True`` byte-identical to the reference and
  decoded by tools/avdec (libavcodec) bit-exact to the port's recon:
  I/P16 under CQP, ABR and a scenecut IDR (bframes=0), I/P8x8 with the
  8x8 transform and trellis, bench.py's whole config (bframes=2,
  full_recon off, P8x8, the 8x8 transform, trellis, weightp 1), and
  350x286.

Each test holds the cases that share the reference's compiled programs."""

import itertools
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
from x264_tpu.api import Encoder as RefEncoder  # noqa: E402
from x264_tpu.models import intra_device  # noqa: E402
from x264_tpu.models.inter_frame import me_lambda, sad_lambda  # noqa: E402
from x264_tpu.ops.device import entropy_pack as d_ep  # noqa: E402
from x264_tpu.ops.device import predict as d_pr  # noqa: E402
from x264_tpu.ops.device.trellis import frame_trellis as ref_trellis  # noqa
from x264_tpu.params import EncoderParams as RefParams  # noqa: E402
from x264_tpu.utils.oracle import decode_annexb  # noqa: E402
from x264_tpu_torch.api import Encoder, EncoderParams  # noqa: E402
from x264_tpu_torch.kernels import intra_nxn  # noqa: E402
from x264_tpu_torch.models import intra, residual  # noqa: E402
from x264_tpu_torch.ops import entropy_pack as t_ep  # noqa: E402
from x264_tpu_torch.ops import predict as t_pr  # noqa: E402
from x264_tpu_torch.ops.trellis import frame_trellis  # noqa: E402
from x264_tpu_torch.params import RC_ABR  # noqa: E402
from x264_tpu_torch.utils.yuv import Frame420  # noqa: E402

LV_CAP = 96          # the encoder's first entropy rung: shares compiles
QPS = (0, 26, 51)


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(np.asarray(port), np.asarray(ref),
                                  err_msg=msg)


# ---- prediction ----

def _avail_grid(k: int, per: int):
    """Every combination of k availability flags, each repeated per
    times -> (2**k * per, k) bool."""
    combos = np.array(list(itertools.product([False, True], repeat=k)))
    return np.repeat(combos, per, axis=0)


@pytest.mark.parametrize("size", [4, 8])
def test_predict_nxn_matches_reference(size, rng):
    if size == 4:
        av = _avail_grid(3, 12)                  # top, left, top-right
        n = av.shape[0]
        edges = (rng.integers(0, 256, (n, 8)), rng.integers(0, 256, (n, 4)),
                 rng.integers(0, 256, n))
        ref = d_pr.predict_4x4_all(*map(jnp.asarray, edges),
                                   *map(jnp.asarray, av.T))
        got = t_pr.predict_4x4_all(*map(torch.as_tensor, edges),
                                   *map(torch.as_tensor, av.T))
    else:
        av = _avail_grid(4, 12)                  # top, left, tl, tr
        n = av.shape[0]
        edges = (rng.integers(0, 256, (n, 16)), rng.integers(0, 256, (n, 8)),
                 rng.integers(0, 256, n))
        ref = d_pr.predict_8x8_all(*map(jnp.asarray, edges),
                                   *map(jnp.asarray, av.T))
        got = t_pr.predict_8x8_all(*map(torch.as_tensor, edges),
                                   *map(torch.as_tensor, av.T))
    assert got.dtype == torch.int32
    _eq(got, ref)
    flags = _avail_grid(3, 1)
    for t_fn, r_fn in ((t_pr.i4x4_mode_avail, d_pr.i4x4_mode_avail),
                       (t_pr.i8x8_mode_avail, d_pr.i8x8_mode_avail)):
        _eq(t_fn(*map(torch.as_tensor, flags.T)),
            r_fn(*map(jnp.asarray, flags.T)))


def test_cabac_blob_i4_fields_match_reference(rng):
    """The two I_NxN mode words, with mode 8 in the top nibble (past bit
    31: int32 wrap) and -1 for non-I_NxN MBs, and the stride."""
    n = 9
    f = dict(luma_dc=rng.integers(-3, 4, (n, 16)),
             luma_ac=rng.integers(-2, 3, (n, 16, 16)) * (rng.random(
                 (n, 16, 16)) < 0.2),
             chroma_dc=rng.integers(-2, 3, (n, 2, 4)),
             chroma_ac=np.zeros((n, 2, 4, 16), np.int64),
             mb_class=rng.integers(0, 2, n), mvd=np.zeros((n, 2), np.int64),
             i16_mode=rng.integers(0, 4, n), chroma_mode=rng.integers(0, 4, n),
             cbp_luma=rng.integers(0, 16, n), cbp_chroma=rng.integers(0, 3, n),
             qp=np.full(n, 26), mb_cost=rng.integers(0, 999, n),
             icost=np.zeros(n, np.int64))
    modes = rng.integers(0, 9, (n, 16))
    modes[0] = 8
    modes[1] = -1
    t8 = rng.integers(0, 2, n)
    args = [v.astype(np.int32) for v in f.values()]
    ref = d_ep.cabac_blob(*map(jnp.asarray, args), K=LV_CAP,
                          t8=jnp.asarray(t8.astype(bool)),
                          i4_modes=jnp.asarray(modes.astype(np.int32)))
    got = t_ep.cabac_blob(*map(torch.as_tensor, args), K=LV_CAP,
                          t8=torch.as_tensor(t8.astype(bool)),
                          i4_modes=torch.as_tensor(modes.astype(np.int32)))
    _eq(got, ref)
    assert t_ep.blob_stride(i4=True) == d_ep.blob_stride(i4=True) == 29


# ---- the core ----

def _content(w: int, h: int, seed: int = 11):
    """Texture where each MB class wins somewhere: a sine field with
    noise (I8x8), hard 45-degree stripes of 3-px grain on a third of the
    MBs (I4x4), horizontal ramps on a fifth (I16x16)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = 120 + 70 * np.sin(xx / 11) * np.cos(yy / 8) + rng.integers(0, 9,
                                                                   (h, w))
    mbx, mby = xx // 16, yy // 16
    y = np.where((mbx + mby) % 3 == 0,
                 np.where(((xx + yy) // 3) % 2 == 0, 40, 210), y)
    y = np.where((mbx + 2 * mby) % 5 == 1, 60 + xx // 4, y)
    u = 128 + 40 * np.sin(xx[::2, ::2] / 7)
    v = 128 + 40 * np.cos(yy[::2, ::2] / 5)
    return [np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v)]


def _cores(w, h, qp, t8_mode, trellis, planes, spy=None):
    """(reference output as numpy, port output) of the I4x4 core at qp;
    spy: a list that receives the port's per-step NxN candidates."""
    mbw, mbh = w // 16, h // 16
    lam = sad_lambda(qp)
    rtr = ref_trellis(qp, "I", me_lambda(qp), t8_mode, states=None) \
        if trellis else None
    ref = intra_device.i4_frame_core(
        *map(jnp.asarray, planes), np.int32(qp), np.int32(lam), mbw=mbw,
        mbh=mbh, cqp_off=0, entropy="cabac", lv_cap=LV_CAP, t8_mode=t8_mode,
        trellis_tbl=rtr)
    ttr = frame_trellis(qp, "I", me_lambda(qp), t8_mode) if trellis else None
    nxn = intra.nxn_candidates
    if spy is not None:
        def record(ry, grid, ysrc, qp_mb, lam_t, d, *a):
            c = nxn(ry, grid, ysrc, qp_mb, lam_t, d, *a)
            spy.append((d, c))
            return c
        intra.nxn_candidates = record
    try:
        got = intra.i4_frame_core(*map(torch.from_numpy, planes), qp, lam,
                                  mbw, mbh, 0, LV_CAP, t8_mode=t8_mode,
                                  trellis_tbl=ttr)
    finally:
        intra.nxn_candidates = nxn
    return {k: np.asarray(v) for k, v in ref.items()}, got


# (width, height, t8_mode, trellis): one reference compile each
CORE_GROUPS = [(64, 48, False, False), (64, 48, False, True),
               (64, 48, True, False), (64, 48, True, True),
               (96, 64, True, True)]


@pytest.mark.parametrize("w,h,t8_mode,trellis", CORE_GROUPS)
def test_i4_frame_core_matches_reference(w, h, t8_mode,
                                         trellis):
    planes = _content(w, h)
    hist = np.zeros(3, np.int64)
    for qp in QPS:
        ref, got = _cores(w, h, qp, t8_mode, trellis, planes)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == (torch.bool if k == "t8" else torch.uint8
                                    if k.startswith("recon") else
                                    torch.int32), k
            _eq(got[k], ref[k], f"qp {qp}: {k}")
        cls = ref["mb_class"] + ref["t8"]          # 0 I16, 1 I4, 2 I8
        hist += np.bincount(cls, minlength=3)
        if qp == 26:
            assert (np.bincount(cls, minlength=3)[:2 + t8_mode] > 0).all(), \
                np.bincount(cls, minlength=3)
    assert (hist[:2 + t8_mode] > 0).all() and (t8_mode or not hist[2]), hist


@pytest.mark.parametrize("t8_mode", [False, True])
def test_nxn_candidates_plain_matches_reference_fields(t8_mode):
    """Each step's NxN candidates from the twin, for the MBs whose I4x4
    (or I8x8) candidate won in the reference: the modes, zigzag levels,
    nonzero counts, coded block pattern and SATD cost the reference
    coded for them."""
    w, h = 64, 48
    mbw = w // 16
    planes = _content(w, h)
    spy = []
    ref, _ = _cores(w, h, 26, t8_mode, False, planes, spy)
    assert [d for d, _ in spy] == list(range(mbw + 2 * (h // 16) - 2))
    seen = np.zeros(3, np.int64)
    for d, c in spy:
        jmin, count = intra_nxn.knight_lanes(d, mbw, h // 16)
        for i in range(count):
            y = jmin + i
            mb = y * mbw + d - 2 * y
            if ref["mb_class"][mb] != 1:
                continue
            if ref["t8"][mb]:
                lv64 = c["lv64s"][i].numpy()
                cells = lv64.reshape(4, 16, 4).transpose(0, 2, 1).reshape(
                    16, 16)[residual._R2C]
                _eq(c["modes8"][i], ref["i4_modes"][mb][:4])
                _eq(cells, ref["luma_ac"][mb])
                _eq((cells != 0).sum(1), ref["luma_nnz"][mb])
                assert int(c["cost8t"][i]) == ref["mb_cost"][mb]
                assert sum(1 << q for q in range(4) if lv64[q].any()) \
                    == ref["cbp_luma"][mb]
                seen[2] += 1
            else:
                _eq(c["modes4"][i], ref["i4_modes"][mb])
                _eq(c["acs4"][i], ref["luma_ac"][mb])
                _eq(c["nnzs4"][i], ref["luma_nnz"][mb])
                assert int(c["cost4"][i]) == ref["mb_cost"][mb]
                seen[1] += 1
            if not t8_mode:
                assert c["i8tile"] is None
    assert seen[1] > 0 and (seen[2] > 0) == t8_mode, seen


# ---- streams ----

def _frames(w, h, n, cut=None):
    """The core test's content panning (2, 1) px per frame with a luma
    drift; from frame ``cut`` on, another scene (seeded noise)."""
    y, u, v = _content(w + 2 * n, h + n)
    rng = np.random.default_rng(12)
    out = []
    for t in range(n):
        planes = (np.clip(y[t:t + h, 2 * t:2 * t + w].astype(np.int32) + t,
                          0, 255), u[:h // 2, t:t + w // 2],
                  v[:h // 2, t:t + w // 2])
        if cut is not None and t >= cut:
            planes = [rng.integers(0, 256, p.shape) for p in planes]
        out.append(Frame420(*(np.ascontiguousarray(p.astype(np.uint8))
                              for p in planes)))
    return out


def _params(w, h, ref=False, **kw):
    base = dict(width=w, height=h, qp=26, me_range=8, subpel=2, cabac=True,
                deblock=True, bframes=0, ref_frames=1, keyint_max=250,
                scenecut_threshold=0, backend="device", i4x4=True)
    base.update(kw)
    return (RefParams if ref else EncoderParams)(**base)


TOOLS = dict(transform_8x8=True, trellis=1)
# group -> [(name, settings, frames, scene cut)]; a group shares compiles
STREAM_GROUPS = {
    "p16": [("cqp", {}, 3, None),
            ("abr", dict(rc_method=RC_ABR, bitrate=300), 4, None),
            ("scenecut", dict(scenecut_threshold=40, keyint_min=1), 3, 2)],
    "p8x8_tools": [("p8x8", dict(TOOLS, p8x8=True), 3, None)],
    "bench_gop": [("bench", dict(TOOLS, p8x8=True, bframes=2,
                                 full_recon=False, weightp=1), 7, None)],
    "odd_350x286": [("odd", dict(width=350, height=286), 2, None)],
}


@pytest.mark.parametrize("group", list(STREAM_GROUPS))
def test_i4_streams_match_reference_and_decode(group):
    for name, kw, n, cut in STREAM_GROUPS[group]:
        w, h = kw.get("width", 64), kw.get("height", 48)
        kw = {k: v for k, v in kw.items() if k not in ("width", "height")}
        frames = _frames(w, h, n, cut)
        port = Encoder(_params(w, h, **kw), device="cpu")
        classes = []
        run_core = port._run_core

        def spy(*a, **k):
            out, st = run_core(*a, **k)
            if "i4_modes" in out:
                classes.append(out["mb_class"] + out["t8"])
            return out, st
        port._run_core = spy
        recons = {}
        port.recon_hook = recons.__setitem__
        stream = b"".join(port.encode(f) for f in frames) + port.flush()
        ref = RefEncoder(_params(w, h, ref=True, **kw))
        assert stream == b"".join(ref.encode(f) for f in frames) \
            + ref.flush(), name
        types = [s.frame_type for s in port.stats]
        if cut is not None:
            # the promoted frame's I core ran (again at the next entropy
            # rung when the noise overflowed the first)
            assert types[cut] == "IDR" and len(classes) >= 2, (name, types)
        hist = np.bincount(torch.cat(classes).numpy(), minlength=3)
        assert hist[1] > 0 and (hist[2] > 0) == bool(
            kw.get("transform_8x8")), (name, hist)
        dec = decode_annexb(stream, w, h)
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
