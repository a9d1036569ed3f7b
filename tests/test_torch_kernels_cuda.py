"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (they have no CPU mode, so these tests skip without one).  Imports
only the port (no JAX, no x264_tpu), so the card's machine runs them as
they are:

    python -m pytest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py

Tolerance 0: all of it is integer arithmetic."""

import numpy as np
import pytest
import torch

from _test_clock import per_test_clock  # noqa: F401

import x264_tpu_torch
from x264_tpu_torch.api import Encoder
from x264_tpu_torch.kernels import bitpack
from x264_tpu_torch.kernels import deblock as k_db
from x264_tpu_torch.kernels import esa16, esa_parts, intra_nxn
from x264_tpu_torch.kernels import trellis as k_tr
from x264_tpu_torch.models import graph, intra
from x264_tpu_torch.ops import trellis as tr
from x264_tpu_torch.ops.deblock import bs_grids
from x264_tpu_torch.params import RC_ABR, EncoderParams
from x264_tpu_torch.state import PAD, me_lambda, sad_lambda
from x264_tpu_torch.utils.yuv import Frame420

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


ESA_CASES = [(7, 5, 16, 14), (16, 9, 8, 4), (3, 2, 32, 90), (4, 4, 16, 0),
             (1, 3, 32, 0)]


def _esa_inputs(cuda, mbw, mbh, me_range, lam):
    """A shifted, noised reference; flat planes (every candidate ties)
    when lam is 0."""
    rng = np.random.default_rng(mbw * 100 + me_range)
    h, w = 16 * mbh, 16 * mbw
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    big = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.int32)
    big[PAD - 3:PAD - 3 + h, PAD + 5:PAD + 5 + w] = src
    ref = np.clip(big + rng.integers(-6, 7, big.shape), 0, 255
                  ).astype(np.uint8)
    if lam == 0:
        src[:] = 90
        ref[:] = 90
    return torch.from_numpy(src).to(cuda), torch.from_numpy(ref).to(cuda)


@pytest.mark.parametrize("mbw,mbh,me_range,lam", ESA_CASES[:4])
def test_esa16_kernel_matches_plain(cuda, mbw, mbh, me_range, lam):
    s, r = _esa_inputs(cuda, mbw, mbh, me_range, lam)
    before = x264_tpu_torch.launch_counts()["esa16"]
    mv_k, c_k = esa16.full_search_16x16(s, r, lam, me_range, mbw, mbh)
    assert x264_tpu_torch.launch_counts()["esa16"] == before + 1
    mv_p, c_p = esa16.full_search_16x16_plain(s, r, lam, me_range, mbw, mbh)
    torch.cuda.synchronize()
    assert torch.equal(mv_k, mv_p) and torch.equal(c_k, c_p)


@pytest.mark.parametrize("mbw,mbh,me_range,lam", ESA_CASES)
def test_esa_parts_kernel_matches_plain(cuda, mbw, mbh, me_range, lam):
    """All nine units bit-exact against the plain twin, and the 16x16
    unit bit-exact against esa16 (one-MB-wide frames, range 32 and the
    all-ties flat frame included)."""
    s, r = _esa_inputs(cuda, mbw, mbh, me_range, lam)
    before = x264_tpu_torch.launch_counts()["esa_parts"]
    got = esa_parts.full_search_parts(s, r, lam, me_range, mbw, mbh)
    assert x264_tpu_torch.launch_counts()["esa_parts"] == before + 1
    want = esa_parts.full_search_parts_plain(s, r, lam, me_range, mbw, mbh)
    mv16, c16 = esa16.full_search_16x16(s, r, lam, me_range, mbw, mbh)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["mv_f"], mv16) and torch.equal(got["cost_f"], c16)
    if lam == 0:
        assert (got["mv_q"] == -4 * me_range).all()


def _esa_check(s, r, lam, me_range, mbw, mbh):
    """Both ESA kernels against their plain twins, and esa_parts' 16x16
    unit against esa16; returns the kernels' (mv, cost) and units."""
    mv_k, c_k = esa16.full_search_16x16(s, r, lam, me_range, mbw, mbh)
    mv_p, c_p = esa16.full_search_16x16_plain(s, r, lam, me_range, mbw, mbh)
    got = esa_parts.full_search_parts(s, r, lam, me_range, mbw, mbh)
    want = esa_parts.full_search_parts_plain(s, r, lam, me_range, mbw, mbh)
    torch.cuda.synchronize()
    assert torch.equal(mv_k, mv_p) and torch.equal(c_k, c_p)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["mv_f"], mv_k) and torch.equal(got["cost_f"], c_k)
    return (mv_k, c_k), got


@pytest.mark.parametrize("me_range", [1, 4, 7, 8, 16, 24, 32])
def test_esa_kernels_every_range(cuda, me_range):
    """7x5 MBs: 35 MBs leave the last CTA part-filled at every range (3 MBs
    per CTA at r = 16, 10 at r = 8); r = 7 starts the window off a 4-byte
    boundary, r = 24 and 32 beyond the Pallas kernel's key cap."""
    s, r = _esa_inputs(cuda, 7, 5, me_range, 4)
    _esa_check(s, r, 4, me_range, 7, 5)


@pytest.mark.parametrize("mbw,mbh,me_range", [(1, 9, 16), (9, 1, 8),
                                              (1, 1, 32), (1, 4, 7)])
def test_esa_kernels_thin_frames(cuda, mbw, mbh, me_range):
    """One-MB-wide and one-MB-tall frames."""
    s, r = _esa_inputs(cuda, mbw, mbh, me_range, 9)
    _esa_check(s, r, 9, me_range, mbw, mbh)


def test_esa_kernels_largest_key(cuda):
    """src all 255, ref all 0, r = 32, lambda 91 (QP 51): every SAD is
    65280, the largest cost 65280 + 91 * 34 fits the key, and the least
    bias (dx = dy = 0) wins."""
    mbw, mbh, me_range, lam = 3, 2, 32, 91
    s = torch.full((16 * mbh, 16 * mbw), 255, dtype=torch.uint8, device=cuda)
    r = torch.zeros((16 * mbh + 2 * PAD, 16 * mbw + 2 * PAD),
                    dtype=torch.uint8, device=cuda)
    (mv, cost), units = _esa_check(s, r, lam, me_range, mbw, mbh)
    assert (mv == 0).all() and (cost == 65280 + 2 * lam).all()
    assert (units["cost_q"] == 16320 + 2 * lam).all()


def test_esa_kernels_repeatable(cuda):
    """20 launches of each kernel at 120x68 MBs give equal outputs."""
    s, r = _esa_inputs(cuda, 120, 68, 16, 4)
    first = (esa16.full_search_16x16(s, r, 4, 16, 120, 68),
             esa_parts.full_search_parts(s, r, 4, 16, 120, 68))
    for _ in range(19):
        mv, cost = esa16.full_search_16x16(s, r, 4, 16, 120, 68)
        units = esa_parts.full_search_parts(s, r, 4, 16, 120, 68)
        assert torch.equal(mv, first[0][0]) and torch.equal(cost, first[0][1])
        for k, v in units.items():
            assert torch.equal(v, first[1][k]), k


def test_esa_geometry_matches_mirror(cuda):
    """The tile height and launch geometry that each ESA kernel computes
    (esa_geom_query), at every range 0-32, equal the CPU tests' mirror
    of esa_core.cuh (tests/test_torch_esa_keys.py)."""
    import ctypes
    from test_torch_esa_keys import _geom, tile_rows
    from x264_tpu_torch.kernels.build import library
    fields = ("r", "span", "win", "off", "g0", "ngx", "ngy", "tiles",
              "chunks", "stride", "rows", "per_mb", "copies", "mbs")
    out = (ctypes.c_int * (1 + len(fields)))()
    for units in (1, 9):
        for r in range(PAD + 1):
            assert library().esa_geom_query(units, r, PAD, out) == 0
            ty = tile_rows(units, r)
            want = dict(_geom(r, PAD, ty), r=r)
            assert list(out) == [ty] + [want[f] for f in fields], (units, r)
    assert library().esa_geom_query(2, 16, PAD, out) != 0


def test_esa_bad_launches_raise(cuda):
    """A plane off a 16-byte boundary, a lambda whose costs overflow the
    key, and a range the C entry point refuses all raise; nothing falls
    back to the plain twin."""
    from x264_tpu_torch.kernels.build import check, library
    s, r = _esa_inputs(cuda, 2, 2, 8, 4)
    flat = torch.empty(r.numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = flat[1:].view(r.shape)
    shifted.copy_(r)
    before = dict(x264_tpu_torch.launch_counts())
    for fn in (esa16.full_search_16x16, esa_parts.full_search_parts):
        with pytest.raises(ValueError, match="16-byte"):
            fn(s, shifted, 4, 8, 2, 2)
        with pytest.raises(ValueError, match="key"):
            fn(s, r, 1 << 16, 8, 2, 2)
    assert x264_tpu_torch.launch_counts() == before
    out = torch.empty(8, dtype=torch.int32, device=cuda)
    bits = torch.zeros(8 * PAD + 9, dtype=torch.int32, device=cuda)
    err = library().esa16_launch(
        s.data_ptr(), r.data_ptr(), bits.data_ptr(), out.data_ptr(),
        out.data_ptr(), 2, 2, PAD + 1, 4, PAD,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="esa16"):
        check(err, "esa16")


def _deblock_inputs(dev, mbw, mbh, mode="mixed"):
    """Smooth planes (most edges pass the alpha/beta tests), strengths
    from random MB syntax (mode "intra": every MB intra, so every MB edge
    has bS 4; "zero": every bS 0), random QPs."""
    rng = np.random.default_rng(mbw * 10 + mbh)
    n, h, w = mbw * mbh, 16 * mbh, 16 * mbw
    base = rng.integers(60, 200, (mbh * 4 + 1, mbw * 4 + 1))
    y = np.clip(np.kron(base, np.ones((4, 4)))[:h, :w]
                + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    u = np.ascontiguousarray(y[::2, ::2])
    v = np.ascontiguousarray(255 - y[1::2, 1::2])
    intra = rng.random(n) < (1.0 if mode == "intra" else 0.2)
    bs_v, bs_h = bs_grids(
        torch.from_numpy(intra).to(dev),
        torch.from_numpy((rng.random((n, 16)) < 0.4).astype(np.int32)
                         ).to(dev),
        torch.from_numpy(rng.integers(-32, 33, (n, 2)).astype(np.int32)
                         ).to(dev),
        torch.zeros(n, dtype=torch.int32, device=dev), mbw, mbh)
    if mode == "zero":
        bs_v.zero_()
        bs_h.zero_()
    qp = torch.from_numpy(rng.integers(10, 46, n).astype(np.int32)).to(dev)
    qpc = (qp - 3).clamp(0, 51)
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    return planes, bs_v, bs_h, qp, qpc


def _deblock_check(cuda, mbw, mbh, mode="mixed", off=(2, -2)):
    planes, bs_v, bs_h, qp, qpc = _deblock_inputs(cuda, mbw, mbh, mode)
    before = x264_tpu_torch.launch_counts()["deblock"]
    out_k = k_db.deblock_filter(*planes, bs_v, bs_h, qp, qpc, *off, mbw,
                                mbh)
    assert x264_tpu_torch.launch_counts()["deblock"] == before + 1
    out_p = k_db.deblock_filter_plain(*planes, bs_v, bs_h, qp, qpc, *off,
                                      mbw, mbh)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    return planes, out_k


@pytest.mark.parametrize("mbw,mbh", [(6, 4), (5, 7), (3, 2), (2, 2),
                                     (1, 3), (120, 68), (7, 1)])
def test_deblock_kernels_match_plain(cuda, mbw, mbh):
    planes, out_k = _deblock_check(cuda, mbw, mbh)
    assert not torch.equal(out_k[0], planes[0])


@pytest.mark.parametrize("mode", ["intra", "zero"])
def test_deblock_kernel_strength_extremes(cuda, mode):
    """Every MB edge at bS 4 (the strong filters), or nothing to filter."""
    planes, out_k = _deblock_check(cuda, 9, 6, mode)
    assert torch.equal(out_k[0], planes[0]) == (mode == "zero")


@pytest.mark.parametrize("off", [(12, 12), (-12, -12), (12, -12),
                                 (-12, 12)])
def test_deblock_kernel_offsets(cuda, off):
    """off_a / off_b (twice the slice's alpha / beta offsets) at +-12:
    the table indices clip at 0 and 51."""
    _deblock_check(cuda, 5, 7, off=off)


def test_deblock_kernel_more_rows_than_resident(cuda):
    """A one-MB-wide frame of 4400 rows: more one-warp blocks than the card
    keeps resident (at most 32 blocks per SM, 132 SMs: 4224), so rows wait
    on rows whose blocks started earlier, never on blocks still queued.
    Against the plain twin on the CPU copy."""
    mbw, mbh = 1, 4400
    planes, bs_v, bs_h, qp, qpc = _deblock_inputs(cuda, mbw, mbh)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert mbh > 32 * n_sm
    out_k = k_db.deblock_filter(*planes, bs_v, bs_h, qp, qpc, 2, -2, mbw,
                                mbh)
    out_p = k_db.deblock_filter_plain(
        *(t.cpu() for t in (*planes, bs_v, bs_h, qp, qpc)), 2, -2, mbw, mbh)
    for a, b in zip(out_k, out_p):
        assert torch.equal(a.cpu(), b)


def test_deblock_kernel_repeatable(cuda):
    """20 launches on a 1080p-sized frame give the same planes: a race
    between the rows would show as drift from run to run."""
    planes, bs_v, bs_h, qp, qpc = _deblock_inputs(cuda, 120, 68)
    first = k_db.deblock_filter(*planes, bs_v, bs_h, qp, qpc, 2, -2, 120,
                                68)
    for _ in range(19):
        out = k_db.deblock_filter(*planes, bs_v, bs_h, qp, qpc, 2, -2, 120,
                                  68)
        for a, b in zip(out, first):
            assert torch.equal(a, b)


def test_encoder_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    w, h = 96, 64
    tex = rng.integers(0, 256, (h + 8, w + 8)).astype(np.uint8)
    frames = [Frame420(np.ascontiguousarray(tex[t:t + h, 2 * t:2 * t + w]),
                       np.ascontiguousarray(tex[::2, ::2][:h // 2, :w // 2]),
                       np.ascontiguousarray(tex[1::2, ::2][:h // 2, :w // 2]))
              for t in range(3)]
    p = EncoderParams(width=w, height=h, qp=26, cabac=True, bframes=0,
                      scenecut_threshold=0, backend="device")
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        assert enc.last_recon.y.device.type == torch.device(d).type
    assert streams[0] == streams[1]


def test_p8x8_encoder_on_card_matches_cpu(cuda):
    """Split motion at 8-px grain, so that partitions are chosen."""
    from chip_smoke import split_motion_clip
    w, h = 96, 64
    frames = [Frame420(*f) for f in split_motion_clip(w, h, 3)]
    p = EncoderParams(width=w, height=h, qp=26, cabac=True, bframes=0,
                      me_range=8, scenecut_threshold=0, backend="device",
                      p8x8=True)
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            n = x264_tpu_torch.launch_counts()
            assert n["esa_parts"] == 2 and n["esa16"] == 0, n
    assert streams[0] == streams[1]


@pytest.mark.parametrize("bframes,p8x8", [(1, False), (2, True), (3, False)])
def test_b_encoder_on_card_matches_cpu(cuda, bframes, p8x8):
    """B frames (pairs and single Bs, full_recon on): the card stream
    equals the CPU stream; esa16 runs twice per B frame and deblock once
    per frame."""
    from chip_smoke import split_motion_clip
    w, h, n = 96, 64, 7
    frames = [Frame420(*f) for f in split_motion_clip(w, h, n)]
    p = EncoderParams(width=w, height=h, qp=26, cabac=True,
                      bframes=bframes, me_range=8, scenecut_threshold=0,
                      backend="device", p8x8=p8x8, full_recon=True)
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            c = x264_tpu_torch.launch_counts()
            n_b = [s.frame_type for s in enc.stats].count("B")
            n_p = n - 1 - n_b
            assert n_b and c["deblock"] == n and c["esa16"] == 2 * n_b + (
                0 if p8x8 else n_p) and c["esa_parts"] == (
                n_p if p8x8 else 0), c
    assert streams[0] == streams[1]


@pytest.mark.parametrize("k", [1, 2])
def test_esa_kernels_on_stacked_refs(cuda, k):
    """A P frame on several references searches each plane of the stacked
    (K, H+2PAD, W+2PAD) padded luma in turn: both ESA kernels on the
    second and third plane (a view at an offset into the stack) against
    their twins, each one launch."""
    mbw, mbh, me_range, lam = 7, 5, 16, 14
    s, r = _esa_inputs(cuda, mbw, mbh, me_range, lam)
    stack = torch.stack([torch.roll(r, (2 * j, -3 * j), (0, 1))
                         for j in range(3)])
    plane = stack[k]
    assert plane.data_ptr() != stack.data_ptr()
    before = x264_tpu_torch.launch_counts()
    mv_k, c_k = esa16.full_search_16x16(s, plane, lam, me_range, mbw, mbh)
    got = esa_parts.full_search_parts(s, plane, lam, me_range, mbw, mbh)
    after = x264_tpu_torch.launch_counts()
    assert after["esa16"] == before["esa16"] + 1
    assert after["esa_parts"] == before["esa_parts"] + 1
    mv_p, c_p = esa16.full_search_16x16_plain(s, plane, lam, me_range, mbw,
                                              mbh)
    assert torch.equal(mv_k, mv_p) and torch.equal(c_k, c_p)
    want = esa_parts.full_search_parts_plain(s, plane, lam, me_range, mbw,
                                             mbh)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("kw,n", [
    (dict(ref_frames=3), 5),
    (dict(ref_frames=2, p8x8=True, transform_8x8=True, trellis=1), 4),
    (dict(ref_frames=2, p8x8=True, bframes=2, full_recon=True), 7)])
def test_multiref_weightp_encoder_on_card_matches_cpu(cuda, kw, n):
    """Weighted prediction on several references: the card stream equals
    the CPU stream, and each P frame launches its ESA kernel once per
    active reference (min(ref_frames, anchors since the IDR))."""
    from chip_smoke import fade_clip
    w, h = 96, 64
    frames = [Frame420(*f) for f in fade_clip(w, h, n)]
    p = EncoderParams(**dict(dict(
        width=w, height=h, qp=26, cabac=True, bframes=0, me_range=8,
        scenecut_threshold=0, backend="device", weightp=1), **kw))
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            c = x264_tpu_torch.launch_counts()
            n_b = [s.frame_type for s in enc.stats].count("B")
            n_p = n - 1 - n_b
            searches = sum(min(p.ref_frames, i + 1) for i in range(n_p))
            want = {"esa_parts": searches if p.p8x8 else 0,
                    "esa16": 2 * n_b + (0 if p.p8x8 else searches)}
            assert {k: c[k] for k in want} == want, c
    assert streams[0] == streams[1]


def _trellis_inputs(cuda, nblocks, nc, qp, scale, seed):
    """Zigzag coefficients of random residual blocks (amplitudes from
    noise to 255, so levels reach the escape range at low QP) and the dq
    of a per-block QP around ``qp``."""
    rng = np.random.default_rng(seed)
    amp = rng.choice([1, 4, 16, 64, scale], size=(nblocks, 1))
    c = np.clip(np.round(rng.standard_normal((nblocks, nc)) * amp * 8),
                -16320, 16320).astype(np.int32)
    q = np.clip(qp + rng.integers(-2, 3, nblocks), 0, 51).astype(np.int32)
    qt = torch.from_numpy(q).to(cuda)
    dq = tr.dq1_8x8(qt) if nc == 64 else tr.dq1_4x4(qt)
    if nc == 15:
        dq = dq[:, 1:].contiguous()
    return torch.from_numpy(c).to(cuda), dq


@pytest.mark.parametrize("nc,cat", [(16, 2), (64, 5), (15, 1), (15, 4)])
@pytest.mark.parametrize("qp,stype", [(0, "I"), (26, "P"), (40, "B"),
                                      (51, "P")])
def test_trellis_kernel_matches_plain(cuda, nc, cat, qp, stype):
    """Levels bit-exact against the plain twin (its float semantics are
    the kernel's), with a launch counted; 1000 blocks, a partial CTA."""
    c, dq = _trellis_inputs(cuda, 1000, nc, qp, 255, nc * 100 + qp)
    tbl = tr.tables_tuple(qp, stype, cat)
    lam2f = tr.frame_trellis(qp, stype, me_lambda(qp), True)[2]
    before = x264_tpu_torch.launch_counts()["trellis"]
    got = k_tr.trellis_quant(c, dq, lam2f, tbl, nc)
    assert x264_tpu_torch.launch_counts()["trellis"] == before + 1
    want = tr.trellis_quant_plain(c, dq, lam2f, tbl, nc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (want != 0).any()


def test_trellis_kernel_1080p_shapes_and_layout(cuda):
    """The 1080p block counts (130560 4x4, 32640 8x8, 65280 chroma AC),
    repeated launches equal, and the parameter block's length equal to
    the kernel's own."""
    from x264_tpu_torch.kernels.build import library
    bundle = tr.frame_trellis(26, "P", me_lambda(26), True)
    for nblocks, nc, tbl in ((130560, 16, bundle[0]), (32640, 64, bundle[1]),
                             (65280, 15, bundle[4])):
        assert library().trellis_params_len(nc) == \
            k_tr.params_block(tbl, bundle[2], nc, cuda).numel()
        c, dq = _trellis_inputs(cuda, nblocks, nc, 26, 255, nc)
        a = k_tr.trellis_quant(c, dq, bundle[2], tbl, nc)
        b = k_tr.trellis_quant(c, dq, bundle[2], tbl, nc)
        want = tr.trellis_quant_plain(c, dq, bundle[2], tbl, nc)
        torch.cuda.synchronize()
        assert torch.equal(a, want) and torch.equal(a, b)


def test_trellis_bad_launches_raise(cuda):
    tbl = tr.tables_tuple(26, "P", 2)
    c = torch.zeros((4, 16), dtype=torch.int32, device=cuda)
    dq = tr.dq1_4x4(torch.full((4,), 26, device=cuda))
    with pytest.raises(ValueError):
        k_tr.trellis_quant(c, dq, np.float32(1.0), tbl, 32)
    with pytest.raises(ValueError):
        k_tr.trellis_quant(c, dq[:, :15], np.float32(1.0), tbl, 16)
    with pytest.raises(ValueError):
        k_tr.trellis_quant(c, dq.cpu(), np.float32(1.0), tbl, 16)


def _trellis_case(cuda, nblocks, nc, qp, seed):
    """Inputs, the tables of a slice type at qp and the twin's levels."""
    stype, cat = ("I", {15: 1, 16: 2, 64: 5}[nc]) if qp == 0 else \
        ("P", {15: 4, 16: 2, 64: 5}[nc])
    c, dq = _trellis_inputs(cuda, nblocks, nc, qp, 255, seed)
    tbl = tr.tables_tuple(qp, stype, cat)
    lam2f = tr.frame_trellis(qp, stype, me_lambda(qp), True)[2]
    return c, dq, lam2f, tbl, tr.trellis_quant_plain(c, dq, lam2f, tbl, nc)


def _trellis_layouts_equal(c, dq, lam2f, tbl, nc, want):
    """The launcher's choice and both forced layouts equal the twin."""
    for layout in ("auto", *k_tr.LAYOUTS):
        got = k_tr.trellis_quant_(c, dq, lam2f, tbl, nc) if layout == "auto" \
            else k_tr._trellis_quant_layout(c, dq, lam2f, tbl, nc, layout)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (layout, c.shape)


@pytest.mark.parametrize("nc", [15, 16, 64])
@pytest.mark.parametrize("nblocks", [1, 2, 3, 15, 17, 33, 8, 16, 240, 480,
                                     960])
def test_trellis_layouts_match_plain(cuda, nblocks, nc):
    """Both layouts (thread per block, lanes per state) and the
    launcher's choice bit-exact against the twin at block counts that
    leave a CTA or a warp part-filled, and at the I4x4 IDR's step shapes
    (8 and 16 x 1, 30 and 60 MBs), at QP 0 (I tables, levels past the
    escape) and 26 (P tables)."""
    for qp in (0, 26):
        args = _trellis_case(cuda, nblocks, nc, qp, 31 * nblocks + nc + qp)
        _trellis_layouts_equal(*args[:4], nc, args[4])


@pytest.mark.parametrize("nc", [15, 16, 64])
@pytest.mark.parametrize("nblocks", [40, 20000])
def test_trellis_layouts_edge_rows(cuda, nc, nblocks):
    """Rows of zeros (every started path ties at BIG, so the first
    minimum and the dummy column decide), rows past the escape (+-16320
    at QP 0: levels above 15), rows of one repeated value (equal
    candidates at every step) and random rows, mixed in one call: both
    layouts equal the twin, at a small and a large block count."""
    rng = np.random.default_rng(nc + nblocks)
    c, dq = _trellis_inputs(cuda, nblocks, nc, 0, 255, 5)
    kind = torch.from_numpy(rng.integers(0, 4, nblocks)).to(cuda)
    sign = torch.from_numpy(rng.choice([-1, 1], (nblocks, nc))).to(cuda)
    c = torch.where(kind[:, None] == 0, 0, c)
    c = torch.where(kind[:, None] == 1, 16320 * sign, c)
    c = torch.where(kind[:, None] == 2, 40 * sign, c).to(torch.int32)
    tbl = tr.tables_tuple(0, "I", {15: 1, 16: 2, 64: 5}[nc])
    lam2f = tr.frame_trellis(0, "I", me_lambda(0), True)[2]
    want = tr.trellis_quant_plain(c, dq, lam2f, tbl, nc)
    assert (want.abs() > 15).any() and (want[kind == 0] == 0).all()
    _trellis_layouts_equal(c, dq, lam2f, tbl, nc, want)


def test_trellis_repeatable(cuda):
    """20 launches of each layout on the same inputs give the same
    levels, at an IDR step shape and at a P frame's 8x8 count."""
    for nblocks, nc in ((960, 15), (32640, 64)):
        c, dq, lam2f, tbl, want = _trellis_case(cuda, nblocks, nc, 26, nc)
        for layout in k_tr.LAYOUTS:
            runs = [k_tr._trellis_quant_layout(c, dq, lam2f, tbl, nc, layout)
                    for _ in range(20)]
            torch.cuda.synchronize()
            assert all(torch.equal(r, want) for r in runs), layout


def test_trellis_auto_layout(cuda):
    """The launcher takes lanes per state for the I wavefront's calls
    and a thread per block for a 1080p P frame's; it switches after 4096
    blocks of 15 or 16 and after 2048 of 64."""
    from x264_tpu_torch.kernels.build import library
    auto = library().trellis_auto_layout
    lanes, thread = k_tr.LAYOUTS["lanes"], k_tr.LAYOUTS["thread"]
    assert all(auto(n, 15) == lanes for n in (1, 8, 480, 960))
    assert all(auto(n, nc) == thread for n, nc in ((130560, 16),
                                                   (32640, 64), (65280, 15)))
    assert [auto(n, nc) for n, nc in ((4096, 15), (4097, 15), (4096, 16),
                                      (4097, 16), (2048, 64), (2049, 64))
            ] == [lanes, thread, lanes, thread, lanes, thread]


@pytest.mark.parametrize("bframes,p8x8", [(0, False), (0, True), (2, True)])
def test_t8_trellis_encoder_on_card_matches_cpu(cuda, bframes, p8x8):
    """The 8x8 transform and trellis on P16, P8x8 and a B pair
    (full_recon on): card stream == CPU stream, trellis launched."""
    from chip_smoke import split_motion_clip
    w, h, n = 96, 64, 4
    frames = [Frame420(*f) for f in split_motion_clip(w, h, n)]
    p = EncoderParams(width=w, height=h, qp=26, cabac=True,
                      bframes=bframes, me_range=8, scenecut_threshold=0,
                      backend="device", p8x8=p8x8, full_recon=True,
                      transform_8x8=True, trellis=1)
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            assert x264_tpu_torch.launch_counts()["trellis"] > 0
    assert streams[0] == streams[1]


# ---- the NxN candidate kernel and the intra graph ----

def _nxn_state(dev, mbw, mbh, seed):
    """Random recon plane, source, mode grid (modes 0-8 inside the frame)
    and per-MB QP (0 and 51 included): kernel and twin must agree on any
    state, the edges they read as well as the garbage they must not."""
    rng = np.random.default_rng(seed)
    h, w = 16 * mbh, 16 * mbw

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    qp = rng.integers(0, 52, mbw * mbh)
    qp[:2] = (0, 51)[:qp.size]
    return (t(rng.integers(0, 256, (h, w))), t(rng.integers(0, 9, (
        4 * mbh, 4 * mbw))), t(rng.integers(0, 256, (h, w))), t(qp))


def _nxn_check(dev, state, d, mbw, mbh, t8_mode, lam):
    """Kernel and twin on copies of one state: outputs and the recon
    plane and mode grid they leave, equal; returns the twin's state."""
    ry, grid, src, qp = state
    lam_t = torch.tensor([lam], dtype=torch.int32, device=dev)
    rk, gk, rp, gp = ry.clone(), grid.clone(), ry.clone(), grid.clone()
    before = x264_tpu_torch.launch_counts()["intra_nxn"]
    got = intra_nxn.nxn_candidates(rk, gk, src, qp, lam_t, d, mbw, mbh,
                                   t8_mode)
    assert x264_tpu_torch.launch_counts()["intra_nxn"] == before + 1
    want = intra_nxn.nxn_candidates_plain(rp, gp, src, qp, lam, d, mbw, mbh,
                                          t8_mode)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            assert torch.equal(got[k], want[k]), (d, k)
    assert torch.equal(rk, rp) and torch.equal(gk, gp), d
    return rp, gp, src, qp


@pytest.mark.parametrize("t8_mode", [False, True])
def test_nxn_kernel_matches_plain_1080p_steps(cuda, t8_mode):
    """The first knight step, a full-length middle one (60 MBs) and the
    last of a 1080p frame, on random states, at two lambdas."""
    mbw, mbh = 120, 68
    counts = [intra_nxn.knight_lanes(d, mbw, mbh)[1]
              for d in range(mbw + 2 * mbh - 2)]
    full = counts.index(max(counts))
    assert max(counts) == 60 and len(counts) == 254
    for i, d in enumerate((0, full, 253)):
        state = _nxn_state(cuda, mbw, mbh, 40 + i)
        for lam in (sad_lambda(26), sad_lambda(51)):
            _nxn_check(cuda, state, d, mbw, mbh, t8_mode, lam)


@pytest.mark.parametrize("mbw,mbh", [(1, 5), (6, 1), (2, 3)])
@pytest.mark.parametrize("t8_mode", [False, True])
def test_nxn_kernel_matches_plain_thin_frames(cuda, mbw, mbh, t8_mode):
    """Every step of one-MB-wide and one-MB-high frames in order, each
    step on the state the previous one left."""
    state = _nxn_state(cuda, mbw, mbh, 7)
    for d in range(mbw + 2 * mbh - 2):
        if intra_nxn.knight_lanes(d, mbw, mbh)[1]:    # mbw 1: odd d empty
            state = _nxn_check(cuda, state, d, mbw, mbh, t8_mode,
                               sad_lambda(30))


@pytest.mark.parametrize("t8_mode", [False, True])
def test_nxn_kernel_matches_plain_every_1080p_step(cuda, t8_mode):
    """All 254 knight steps of a 1080p IDR in order (chip_smoke.py's
    clip as source, a zero recon and a DC mode grid to start), kernel
    and twin each carrying their own recon plane and mode grid forward."""
    from chip_smoke import make_clip
    mbw, mbh = 120, 68
    y = make_clip(1)[0][0]
    src = np.zeros((16 * mbh, 16 * mbw), np.int32)
    src[:y.shape[0], :y.shape[1]] = y
    src = torch.from_numpy(src).to(cuda)
    state = (torch.zeros_like(src), torch.full((4 * mbh, 4 * mbw), 2,
                                               dtype=torch.int32,
                                               device=cuda),
             src, torch.full((mbw * mbh,), 26, dtype=torch.int32,
                             device=cuda))
    for d in range(mbw + 2 * mbh - 2):
        state = _nxn_check(cuda, state, d, mbw, mbh, t8_mode, sad_lambda(26))


@pytest.mark.parametrize("qp", [0, 51])
@pytest.mark.parametrize("t8_mode", [False, True])
def test_nxn_kernel_qp_extremes_every_corner(cuda, qp, t8_mode):
    """Every step of a 5x4-MB frame (each availability corner: no top,
    no left, neither, no top-right at the right edge, all) on a random
    state at a uniform QP 0 or 51."""
    mbw, mbh = 5, 4
    ry, grid, src, _ = _nxn_state(cuda, mbw, mbh, qp + 3)
    state = (ry, grid, src, torch.full((mbw * mbh,), qp, dtype=torch.int32,
                                       device=cuda))
    for d in range(mbw + 2 * mbh - 2):
        state = _nxn_check(cuda, state, d, mbw, mbh, t8_mode, sad_lambda(qp))


@pytest.mark.parametrize("t8_mode", [False, True])
@pytest.mark.parametrize("flat", ["constant", "ramp"])
def test_nxn_kernel_flat_sources_tie(cuda, flat, t8_mode):
    """Flat content, where several modes predict the same block and tie
    on cost (lambda 0 too, where only the first-minimum order decides):
    every step of a 4x3-MB frame from a flat recon and source."""
    mbw, mbh = 4, 3
    h, w = 16 * mbh, 16 * mbw
    if flat == "constant":
        src = torch.full((h, w), 97, dtype=torch.int32, device=cuda)
    else:
        src = (torch.arange(w, device=cuda)[None] * 3 + 20).expand(h, w)
        src = src.to(torch.int32).contiguous()
    for lam in (0, sad_lambda(26)):
        state = (src.clone(), torch.full((4 * mbh, 4 * mbw), 2,
                                         dtype=torch.int32, device=cuda),
                 src, torch.full((mbw * mbh,), 26, dtype=torch.int32,
                                 device=cuda))
        for d in range(mbw + 2 * mbh - 2):
            state = _nxn_check(cuda, state, d, mbw, mbh, t8_mode, lam)


def test_nxn_kernel_repeatable(cuda):
    """20 launches at a 60-MB 1080p step, each on a fresh copy of one
    random state, give the same outputs, recon plane and mode grid."""
    mbw, mbh = 120, 68
    counts = [intra_nxn.knight_lanes(d, mbw, mbh)[1]
              for d in range(mbw + 2 * mbh - 2)]
    d = counts.index(60)
    ry, grid, src, qp = _nxn_state(cuda, mbw, mbh, 77)
    lam = torch.tensor([sad_lambda(26)], dtype=torch.int32, device=cuda)
    first = None
    for _ in range(20):
        rk, gk = ry.clone(), grid.clone()
        out = intra_nxn.nxn_candidates(rk, gk, src, qp, lam, d, mbw, mbh,
                                       True)
        torch.cuda.synchronize()
        run = [out[k] for k in sorted(out)] + [rk, gk]
        if first is None:
            first = run
        assert all(torch.equal(a, b) for a, b in zip(run, first))


def test_nxn_bad_launches_raise(cuda):
    ry, grid, src, qp = _nxn_state(cuda, 2, 2, 1)
    lam = torch.tensor([4], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        intra_nxn.nxn_candidates(ry, grid, src, qp, lam, 5, 2, 2, False)
    with pytest.raises(ValueError):
        intra_nxn.nxn_candidates(ry.float(), grid, src, qp, lam, 0, 2, 2,
                                 False)
    with pytest.raises(ValueError):
        intra_nxn.nxn_candidates(ry, grid, src, qp.cpu(), lam, 0, 2, 2,
                                 False)


def _intra_planes(dev, w, h, seed):
    from chip_smoke import split_motion_clip
    y, u, v = split_motion_clip(w, h, 1)[0]
    rng = np.random.default_rng(seed)
    y = np.clip(y.astype(np.int32) + rng.integers(-30, 31, y.shape), 0, 255)
    return [torch.from_numpy(np.ascontiguousarray(p.astype(np.uint8))).to(dev)
            for p in (y, u, v)]


@pytest.mark.parametrize("i4", [False, True])
def test_intra_graph_matches_eager_core(cuda, i4):
    """The I16 and the I4x4/I8x8 core replayed as a CUDA graph equal the
    eager core on the card, field for field, for two frames at two QPs
    (the second a replay with new inputs, lambda and trellis tables),
    and every replay adds its captured launches."""
    from x264_tpu_torch.ops.trellis import frame_trellis
    w, h = 96, 64
    core = intra.i4_frame_core if i4 else intra.i_frame_core
    kw = dict(mbw=w // 16, mbh=h // 16, cqp_off=2, lv_cap=96)
    if i4:
        kw["t8_mode"] = True
    for seed, qp in ((1, 26), (2, 33)):
        planes = _intra_planes(cuda, w, h, seed)
        tt = frame_trellis(qp, "I", me_lambda(qp), True)
        qp_t = torch.full((1,), qp, dtype=torch.int32, device=cuda)
        lam = sad_lambda(qp) if i4 else None
        eager = core(*planes, qp_t, *([lam] if i4 else []), trellis_tbl=tt,
                     **kw)
        g = graph.graph_for(core, planes, qp_t, lam, tt, **kw)
        before = x264_tpu_torch.launch_counts()
        got = graph.run_core(core, *planes, qp_t, lam, trellis_tbl=tt, **kw)
        after = x264_tpu_torch.launch_counts()
        torch.cuda.synchronize()
        assert {k: after[k] - before[k] for k in after} == g.launches
        assert g.launches["trellis"] == 2 * (
            kw["mbw"] + (2 if i4 else 1) * kw["mbh"] - (2 if i4 else 1))
        assert g.launches["intra_nxn"] == (
            kw["mbw"] + 2 * kw["mbh"] - 2 if i4 else 0)
        assert set(got) == set(eager)
        for k in eager:
            assert torch.equal(got[k], eager[k]), (qp, k)
        if i4:
            assert (got["mb_class"] == 1).any() and got["t8"].any()


def test_i4_encoder_on_card_matches_cpu(cuda):
    """352x288 I/P8x8 with I4x4, the 8x8 transform and trellis, and a
    second IDR (keyint 3): card stream == CPU stream, the NxN kernel
    launched on every knight step of both IDRs."""
    from chip_smoke import split_motion_clip
    w, h, n = 352, 288, 4
    frames = [Frame420(*f) for f in split_motion_clip(w, h, n)]
    p = EncoderParams(width=w, height=h, qp=26, cabac=True, bframes=0,
                      me_range=8, scenecut_threshold=0, backend="device",
                      p8x8=True, transform_8x8=True, trellis=1, i4x4=True,
                      keyint_max=3)
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            launches = x264_tpu_torch.launch_counts()
        assert [s.frame_type for s in enc.stats] == ["IDR", "P", "P", "IDR"]
    assert streams[0] == streams[1]
    assert launches["intra_nxn"] >= 2 * (w // 16 + 2 * (h // 16) - 2)


# ---- CAVLC: the block coder and the bit packer ----

def _cavlc_fields(mbw: int, mbh: int, seed: int, kind: str = "large"):
    """A frame's random CAVLC fields in residual_slots' argument order
    (CPU tensors): levels with a density per row (magnitudes all +-1,
    small, large or past both level escapes), counts 0-16, every cbp, I16
    and other MBs."""
    rng = np.random.default_rng(seed)
    n = mbw * mbh

    def levels(shape):
        mag = {"ones": np.ones(shape, np.int64),
               "small": rng.integers(1, 4, shape),
               "large": rng.integers(1, 60, shape),
               "escape": rng.integers(1, 9000, shape)}[kind]
        live = rng.random(shape) < rng.random(shape[:-1] + (1,))
        return np.where(live, rng.choice([-1, 1], shape) * mag, 0)

    arrs = [levels((n, 16)), levels((n, 16, 16)),
            rng.integers(0, 17, (n, 16)), levels((n, 2, 4)),
            levels((n, 2, 4, 16)), rng.integers(0, 16, (n, 2, 4)),
            rng.integers(0, 16, n), rng.integers(0, 3, n)]
    return [torch.from_numpy(a.astype(np.int32)) for a in arrs] + [
        torch.from_numpy(rng.random(n) < 0.5)]


@pytest.mark.parametrize("levels", ["ones", "small", "large", "escape"])
@pytest.mark.parametrize("mbw,mbh", [(1, 1), (7, 1), (8, 1), (9, 2),
                                     (37, 3), (120, 68)])
def test_cavlc_blocks_kernel_matches_plain(cuda, levels, mbw, mbh):
    """The kernel on a frame's fields, bit-exact against the twin
    (block_inputs + code_blocks_plain + the gate); 120 x 68 is a 1080p
    frame's 8160 MBs, 4 MBs a CTA with the last CTA full or part empty
    at the others."""
    from x264_tpu_torch.kernels import cavlc as k_cv
    from x264_tpu_torch.ops import cavlc as cv
    fields = _cavlc_fields(mbw, mbh, mbw * 100 + mbh, levels)
    pv, pl = cv.residual_slots(*fields, mbw, mbh)
    kv, kl = k_cv.residual_slots_(*(t.to(cuda) for t in fields), mbw, mbh)
    torch.cuda.synchronize()
    assert torch.equal(kv.cpu(), pv) and torch.equal(kl.cpu(), pl)


def test_cavlc_blocks_wrapper_launches_and_counts(cuda):
    """One launch a call, counted; a dtype, shape, stride or alignment
    the kernel does not take raises."""
    from x264_tpu_torch.ops import cavlc as cv
    fields = [t.to(cuda) for t in _cavlc_fields(5, 4, 3, "small")]
    before = x264_tpu_torch.launch_counts()["cavlc_blocks"]
    cv.residual_slots(*fields, 5, 4)
    assert x264_tpu_torch.launch_counts()["cavlc_blocks"] == before + 1
    bad = [fields[:1] + [fields[1].to(torch.int64)] + fields[2:],
           fields[:2] + [fields[2][:, :15]] + fields[3:],
           [fields[0].t().contiguous().t()] + fields[1:],
           [torch.empty(20 * 16 + 1, dtype=torch.int32,
                        device=cuda)[1:].view(20, 16)] + fields[1:],
           fields[:8] + [fields[8].to(torch.uint8)]]
    for args in bad:
        with pytest.raises(ValueError):
            cv.residual_slots(*args, 5, 4)
    assert x264_tpu_torch.launch_counts()["cavlc_blocks"] == before + 1


def _tokens(n: int, s: int, seed: int):
    """(N, S) tokens of 1-30 bits whose values fit them, densities per MB
    from sparse to past 64 words."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 31, (n, s))
    dens = 0.02 + 0.48 * rng.random((n, 1))
    lens = np.where(rng.random((n, s)) < dens, lens, 0)
    vals = rng.integers(0, 1 << 30, (n, s)) & ((1 << lens) - 1)
    return (torch.from_numpy(vals.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


def _blob_case(cuda, n, h, n_words, seed, nf=3, r=972):
    """The packing and the placement on the card against their twins:
    (N, h) header and (N, r) residual grids and nf fields -> the card's
    blob and payload beside the plain ones."""
    from x264_tpu_torch.kernels import bitpack
    vals, lens = _tokens(n, h + r, seed)
    rng = np.random.default_rng(seed)
    fields = [torch.from_numpy(rng.integers(0, 9, n).astype(np.int32))
              for _ in range(nf)]
    parts = (vals[:, :h].contiguous(), lens[:, :h].contiguous(),
             vals[:, h:].contiguous(), lens[:, h:].contiguous())
    want = bitpack.pack_blob_plain(*parts, n_words, fields)
    blob = bitpack.pack_blob(*(t.to(cuda) for t in parts), n_words,
                             [f.to(cuda) for f in fields])
    pay = bitpack.place(blob, n_words)
    torch.cuda.synchronize()
    return ([blob.cpu(), pay.cpu()],
            [want, bitpack.place_blob_plain(want, n_words)])


@pytest.mark.parametrize("n,s", [(1, 981), (5, 7), (37, 994), (8160, 982)])
@pytest.mark.parametrize("n_words", [1, 4, 64, 416])
def test_bitpack_kernel_matches_plain(cuda, n, s, n_words):
    """Bit-exact against the twins, MBs past the budget included (their
    first words and whole nbits); 8160 x 982 is a 1080p B frame's slot
    grid: first the whole grid as the header part (no residual part, no
    fields), then a header and a residual grid with fields; blob and
    payload."""
    got, want = _blob_case(cuda, n, s, n_words, n * 7 + n_words, nf=0,
                           r=0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got, want = _blob_case(cuda, n, s % 23, n_words, n + n_words)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bitpack_wrapper_launches_and_counts(cuda):
    """One launch of the packing and one of the placement a call, each
    counted; a budget, dtype, width, alignment or blob the kernels do not
    take raises, and so does pack_tokens (the CPU twin) on the card."""
    from x264_tpu_torch.kernels import bitpack
    vals, lens = (t.to(cuda) for t in _tokens(4, 981, 1))
    before = x264_tpu_torch.launch_counts()["bitpack"]
    with pytest.raises(ValueError):
        bitpack.pack_tokens(vals, lens, 64)
    hv, hl = vals[:, :9].contiguous(), lens[:, :9].contiguous()
    rv, rl = vals[:, 9:].contiguous(), lens[:, 9:].contiguous()
    f = [torch.zeros(4, dtype=torch.int32, device=cuda)] * 2
    blob = bitpack.pack_blob(hv, hl, rv, rl, 64, f)
    assert x264_tpu_torch.launch_counts()["bitpack"] == before + 1
    bitpack.place(blob, 64)
    assert x264_tpu_torch.launch_counts()["bitpack"] == before + 2
    off = torch.empty(4 * 972 + 1, dtype=torch.int32, device=cuda)[1:]
    for args in ((hv, hl, rv, rl, 0, f),
                 (hv, hl, rv, rl, bitpack.max_words() + 1, f),
                 (hv, hl, rv.to(torch.int64), rl, 64, f),
                 (hv, hl, rv[:, :970].contiguous(),
                  rl[:, :970].contiguous(), 64, f),
                 (hv, hl, off.view(4, 972), rl, 64, f),
                 (hv, hl, rv, rl, 64, [hv[:, 0]]),
                 (hv, hl, rv, rl, 64, f * 3)):
        with pytest.raises(ValueError):
            bitpack.pack_blob(*args)
    for b, n_words in ((blob, 0), (blob, 67), (blob.to(torch.int64), 64),
                       (blob[:, :40], 64), (blob.t(), 64)):
        with pytest.raises(ValueError):
            bitpack.place(b, n_words)
    assert x264_tpu_torch.launch_counts()["bitpack"] == before + 2


@pytest.mark.parametrize("n_words", [64, 416])
def test_bitpack_payload_matches_plain_placement(cuda, n_words):
    """The payload the kernel places, every word of its fixed size,
    equals the plain placement (cumsum of nbits and scatter_add_) at the
    1080p frame's 8160 MBs, MBs past the budget included, on two calls
    and captured in a CUDA graph replayed twice; and, on MBs cut to the
    budget, the host merge it replaced (merge_mb_strings)."""
    from x264_tpu_torch.bitstream.slice_assemble import merge_mb_strings
    from x264_tpu_torch.kernels import bitpack
    got, want = _blob_case(cuda, 8160, 22, n_words, 5)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    blob = got[0].to(cuda)
    assert torch.equal(bitpack.place(blob, n_words).cpu(), want[1])
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        pay = bitpack.place(blob, n_words)
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(pay.cpu(), want[1])
    vals, lens = _tokens(8160, 994, 6)
    lens = torch.where(torch.cumsum(lens, 1) <= 32 * n_words, lens, 0)
    vals = torch.where(lens > 0, vals, 0)
    blob = bitpack.pack_blob(vals[:, :22].contiguous().to(cuda),
                             lens[:, :22].contiguous().to(cuda),
                             vals[:, 22:].contiguous().to(cuda),
                             lens[:, 22:].contiguous().to(cuda), n_words)
    pay = bitpack.place(blob, n_words).cpu().numpy().view(np.uint32)
    blob = blob.cpu().numpy()
    ref, total = merge_mb_strings(
        np.ascontiguousarray(blob[:, :n_words]).view(np.uint32),
        blob[:, n_words])
    assert total == int(lens.sum()) and (total + 31) // 32 <= len(pay)
    m = min(len(ref), len(pay))
    assert np.array_equal(pay[:m], ref[:m]) and not pay[m:].any()


@pytest.mark.parametrize("kw", [
    dict(), dict(qp=0), dict(p8x8=True, transform_8x8=True, weightp=1,
                             ref_frames=2),
    dict(bframes=2, p8x8=True, full_recon=True, transform_8x8=True)],
    ids=["p16", "p16_qp0", "p8x8_tools_ref2", "bframes"])
def test_cavlc_encoder_on_card_matches_cpu(cuda, kw):
    """CAVLC streams: card == CPU, every frame's core launching the block
    coder and the packer once and the encoder the placement once (more
    when an MB overflows its words and the core re-runs at the next
    rung), the I frames' cores inside the graph."""
    from chip_smoke import split_motion_clip
    w, h, n = 96, 64, 7
    frames = [Frame420(*f) for f in split_motion_clip(w, h, n)]
    p = EncoderParams(**dict(dict(
        width=w, height=h, qp=26, cabac=False, bframes=0, me_range=8,
        scenecut_threshold=0, backend="device"), **kw))
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        g0 = len(graph._GRAPHS)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            c = x264_tpu_torch.launch_counts()
            captured = len(graph._GRAPHS) - g0
    assert streams[0] == streams[1]
    # a core run codes its blocks and packs once (an I16 graph's warm-up
    # at its capture too, one a rung that this run captured:
    # models/graph.py counts the warm-up's launches), and the encoder
    # places each run's payload once (bitpack's second entry point)
    placed = c["bitpack"] - c["cavlc_blocks"]
    assert placed >= n and c["cavlc_blocks"] - placed == captured, c
    if kw.get("qp") != 0:
        assert placed == n, c
    assert c["trellis"] == c["intra_nxn"] == 0, c


def test_cavlc_i16_graph_matches_eager_core(cuda):
    """The CAVLC I16 core replayed as a CUDA graph equals the eager core
    (host_blob included), at two word budgets, each its own graph, on two
    replays; the placement captured in a graph after it, replayed twice,
    equals the eager placement and the plain placement of the blob."""
    w, h = 96, 64
    planes = _intra_planes(cuda, w, h, 4)
    qp_t = torch.full((1,), 26, dtype=torch.int32, device=cuda)
    for n_words in (64, 416):
        kw = dict(mbw=w // 16, mbh=h // 16, cqp_off=0, n_words=n_words)
        eager = intra.i_frame_core(*planes, qp_t, **kw)
        g = graph.graph_for(intra.i_frame_core, planes, qp_t, **kw)
        got = [graph.run_core(intra.i_frame_core, *planes, qp_t, **kw)
               for _ in range(2)]
        torch.cuda.synchronize()
        assert g.launches["cavlc_blocks"] == g.launches["bitpack"] == 1
        for run in got:
            assert set(run) == set(eager)
            for k in eager:
                assert torch.equal(run[k], eager[k]), (n_words, k)
        n = kw["mbw"] * kw["mbh"]
        blob = got[1]["host_blob"]
        assert blob.shape == (n, n_words + 3)
        want = bitpack.place(blob, n_words)
        pg = torch.cuda.CUDAGraph()
        with torch.cuda.graph(pg):
            pay = bitpack.place(blob, n_words)
        for _ in range(2):
            pg.replay()
            torch.cuda.synchronize()
            assert torch.equal(pay, want), n_words
        assert torch.equal(pay.cpu(), bitpack.place_blob_plain(
            blob.cpu(), n_words))


# ---- the refresh bar (csrc/pir_column.cu) ----

def _bar_case(cuda, mbw, mbh, seed):
    from x264_tpu_torch.kernels import pir_column as k_pir
    from x264_tpu_torch.state import CHROMA_QP_TABLE
    rng = np.random.default_rng(seed)
    n, h, w = mbw * mbh, 16 * mbh, 16 * mbw
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    rec = [rng.integers(0, 256, p.shape).astype(np.int32) for p in planes]
    qp = rng.integers(0, 52, n).astype(np.int32)
    qpc = CHROMA_QP_TABLE[np.clip(qp + 1, 0, 51)].astype(np.int32)
    acc = {k: (rng.integers(0, 2, (n, *s)).astype(bool)
               if k in ("intra_mask", "t8")
               else rng.integers(-5, 5, (n, *s)).astype(np.int32))
           for k, s in k_pir._FIELDS}

    def inputs(dev):
        return ([torch.from_numpy(a.copy()).to(dev)
                 for a in (*planes, *rec, qp, qpc)],
                {k: torch.from_numpy(a.copy()).to(dev)
                 for k, a in acc.items()})
    return inputs


@pytest.mark.parametrize("mbw,mbh,col,ncols", [
    (6, 4, 0, 1), (6, 4, 2, 3), (6, 4, 5, 3), (1, 1, 0, 1), (120, 68, 0, 3),
    (120, 68, 59, 3), (120, 68, 117, 3), (120, 68, 119, 3),
    # 1080p at keyint 30, 10 and 2 (the whole frame: 187 steps of up to
    # 68 MBs, in rounds of 16 warps)
    (120, 68, 0, 5), (120, 68, 0, 14), (120, 68, 0, 120),
    # diagonals capped by mbh (mbh < ncols), masked bars at the right edge
    (16, 4, 1, 12), (16, 4, 12, 14), (120, 68, 110, 14)])
def test_pir_column_kernel_matches_plain(cuda, mbw, mbh, col, ncols):
    """The kernel's planes and fields equal the plain twin's (run on the
    CPU, the faster of the two for it) at per-MB QPs 0-51, at 1080p too,
    with bars reaching past the right edge; one launch, counted."""
    from x264_tpu_torch.kernels import pir_column as k_pir
    inputs = _bar_case(cuda, mbw, mbh, mbw * 7 + col)
    t, f = inputs(cuda)
    before = x264_tpu_torch.launch_counts()["pir_column"]
    got = k_pir.pir_column_pass(*t[:6], f, t[6], t[7], col, mbw, mbh, ncols)
    torch.cuda.synchronize()
    assert x264_tpu_torch.launch_counts()["pir_column"] == before + 1
    t, f = inputs("cpu")
    want = k_pir.pir_column_pass_plain(*t[:6], f, t[6], t[7], col, mbw,
                                       mbh, ncols)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    for k in k_pir.FIELDS:
        assert torch.equal(got[3][k].cpu(), want[3][k]), k


def test_pir_column_bad_launches_raise(cuda):
    from x264_tpu_torch.kernels import pir_column as k_pir
    inputs = _bar_case(cuda, 4, 2, 3)
    t, f = inputs(cuda)
    with pytest.raises(ValueError):
        k_pir.pir_column_pass(*t[:6], f, t[6], t[7], 4, 4, 2, 1)
    with pytest.raises(ValueError):
        k_pir.pir_column_pass(*t[:6], dict(f, t8=f["t8"].int()), t[6],
                              t[7], 0, 4, 2, 1)
    with pytest.raises(ValueError):
        k_pir.pir_column_pass(t[0][:, :32], *t[1:6], f, t[6], t[7], 0, 4, 2,
                              1)
    # a plane off the 16-byte boundary its copies and stores need: the
    # launcher refuses it
    for i in (0, 3):  # y, ry
        a = t[i]
        off = torch.empty(a.numel() + 1, dtype=a.dtype, device=cuda)[1:]
        t_off = list(t)
        t_off[i] = off.view(a.shape).copy_(a)
        with pytest.raises(RuntimeError):
            k_pir.pir_column_pass(*t_off[:6], f, t_off[6], t_off[7], 0, 4,
                                  2, 1)
    off = torch.empty(f["luma_ac"].numel() + 1, dtype=torch.int32,
                      device=cuda)[1:].view(f["luma_ac"].shape)
    with pytest.raises(RuntimeError):
        k_pir.pir_column_pass(*t[:6], dict(f, luma_ac=off), t[6], t[7], 0,
                              4, 2, 1)


@pytest.mark.parametrize("cabac", [True, False])
def test_live_encoder_on_card_matches_cpu(cuda, cabac):
    """Intra refresh on P16 anchors (CABAC also with the 8x8 transform
    and trellis) under a tight VBV buffer: the card's stream equals the
    CPU's, with the bar kernel launched."""
    from x264_tpu_torch.params import RC_ABR
    rng = np.random.default_rng(4)
    frames = [Frame420(rng.integers(0, 256, (64, 96), dtype=np.uint8),
                       rng.integers(0, 256, (32, 48), dtype=np.uint8),
                       rng.integers(0, 256, (32, 48), dtype=np.uint8))
              for _ in range(5)]
    kw = dict(width=96, height=64, cabac=cabac, intra_refresh=True,
              keyint_max=3, me_range=8, rc_method=RC_ABR, bitrate=300,
              vbv_maxrate=300, vbv_bufsize=100)
    if cabac:
        kw.update(transform_8x8=True, trellis=1)
    streams = {}
    for d in ("cuda", "cpu"):
        enc = Encoder(EncoderParams(**kw), device=d)
        x264_tpu_torch.reset_launch_counts()
        streams[d] = b"".join(enc.encode(f) for f in frames) + enc.flush()
        if d == "cuda":
            assert x264_tpu_torch.launch_counts()["pir_column"] >= 2
    assert streams["cuda"] == streams["cpu"]


# ---- multi-slice frames and the fullpel-only search ----

@pytest.mark.parametrize("bh", [34, 33])
def test_esa16_kernel_at_4k_band_shape(cuda, bh):
    """esa16 on a 4K band (240 MBs wide, 34 or 33 rows: 3840x2160 in four
    slices) at r = 8, the band's source and reference rows being views of
    whole padded planes (as the band loop hands them in), against the
    twin."""
    mbw, y0 = 240, 34
    rng = np.random.default_rng(bh)
    h, w = 16 * 135, 16 * mbw
    src = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8))
    ref = np.clip(np.roll(src.numpy(), (5, -3), (0, 1)).astype(np.int32)
                  + rng.integers(-4, 5, (h, w)), 0, 255).astype(np.uint8)
    src = src.to(cuda)
    ref_pad = torch.from_numpy(np.pad(ref, PAD, mode="edge")).to(cuda)
    s = src[16 * y0:16 * (y0 + bh)]
    r = ref_pad[16 * y0:16 * (y0 + bh) + 2 * PAD]
    lam = sad_lambda(26)
    before = x264_tpu_torch.launch_counts()["esa16"]
    mv_k, c_k = esa16.full_search_16x16(s, r, lam, 8, mbw, bh)
    assert x264_tpu_torch.launch_counts()["esa16"] == before + 1
    mv_p, c_p = esa16.full_search_16x16_plain(s, r, lam, 8, mbw, bh)
    torch.cuda.synchronize()
    assert torch.equal(mv_k, mv_p) and torch.equal(c_k, c_p)
    assert int((mv_k[:, 1] == 20).sum()) > mbw * bh // 2


@pytest.mark.parametrize("mbw,mbh", [(240, 34), (120, 17)])
def test_cavlc_kernels_at_4k_band_shape(cuda, mbw, mbh):
    """The CAVLC block coder on a 4K band's fields (240 x 34 MBs) and a
    1080p band's (120 x 17), and the packer on their MBs at both word
    rungs, blob and payload, against their twins."""
    from x264_tpu_torch.kernels import cavlc as k_cv
    from x264_tpu_torch.ops import cavlc as cv
    fields = _cavlc_fields(mbw, mbh, 34, "large")
    pv, pl = cv.residual_slots(*fields, mbw, mbh)
    kv, kl = k_cv.residual_slots_(*(t.to(cuda) for t in fields), mbw, mbh)
    torch.cuda.synchronize()
    assert torch.equal(kv.cpu(), pv) and torch.equal(kl.cpu(), pl)
    for n_words in (64, 416):
        got, want = _blob_case(cuda, mbw * mbh, 9, n_words, 34)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("kw", [
    dict(slices=4, cabac=True, rc_method=RC_ABR, bitrate=300),
    dict(slices=3, cabac=False),
    dict(preset="ultrafast", bframes=2),
    dict(preset="ultrafast", tune="zerolatency", slices=4)],
    ids=["slices4_cabac_abr", "slices3_cavlc", "ultrafast_b",
         "ultrafast_zerolatency_slices4"])
def test_sliced_and_fullpel_encoder_on_card_matches_cpu(cuda, kw):
    """Multi-slice and fullpel-only streams: card == CPU, esa16 launched
    once per P band and once more per re-run of a P band."""
    from chip_smoke import split_motion_clip
    from x264_tpu_torch.params import param_default_preset
    w, h, n = 96, 64, 5
    frames = [Frame420(*f) for f in split_motion_clip(w, h, n)]
    kw = dict(kw)
    p = param_default_preset(kw.pop("preset", "superfast"),
                             tune=kw.pop("tune", None))
    p = p.clone(width=w, height=h, qp=26, me_range=8, **kw)
    streams, reruns = [], []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        rerun = enc._rerun_band

        def spy(job, b, n_words, rerun=rerun):
            reruns.append((str(d), job["ftype"], b, n_words))
            return rerun(job, b, n_words)
        enc._rerun_band = spy
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            c = x264_tpu_torch.launch_counts()
    assert streams[0] == streams[1]
    on_card = [r[1:] for r in reruns if r[0] == "cuda"]
    assert on_card == [r[1:] for r in reruns if r[0] == "cpu"]
    if not p.bframes:
        assert c["esa16"] == (n - 1) * min(p.slices, h // 16) + sum(
            r[0] == "P" for r in on_card), c


@pytest.mark.parametrize("kw", [
    dict(cabac=False, i4x4=True, aq_mode=1),
    dict(preset="medium", tune="fastdecode"),
    dict(backend="device_host_entropy", cabac=True, i4x4=True, cut=3),
    dict(backend="device_host_entropy", cabac=False, cut=3),
    dict(backend="reference", cabac=False, i4x4=True)],
    ids=["i4_cavlc_aq", "fastdecode", "host_entropy_cabac_cut",
         "host_entropy_cavlc_cut", "reference"])
def test_syntax_path_encoder_on_card_matches_cpu(cuda, kw):
    """The host-syntax path at 352x288: card stream == CPU stream, I4x4
    with CAVLC under AQ, the fastdecode preset with B frames at CRF 23,
    the host-entropy backend on a cut that its scenecut promotes, and
    the reference backend; the I4x4 IDR launches intra_nxn, and the
    promoted cut is an IDR."""
    from chip_smoke import syntax_clip
    from x264_tpu_torch.params import RC_CRF, param_default_preset
    w, h = 352, 288
    kw = dict(kw)
    cut = kw.pop("cut", None)
    n = 3 if kw.get("backend") == "reference" else 5
    frames = [Frame420(*f) for f in syntax_clip(w, h, n, cut=cut)]
    preset = kw.pop("preset", None)
    if preset:
        p = param_default_preset(preset, tune=kw.pop("tune")).clone(
            rc_method=RC_CRF, crf=23.0, aq_mode=1, mbtree=True, b_adapt=1)
    else:
        p = EncoderParams(qp=26, bframes=0, scenecut_threshold=40,
                          keyint_min=2)
    p = p.clone(width=w, height=h, me_range=8, **kw)
    streams = []
    for d in (cuda, "cpu"):
        enc = Encoder(p, device=d)
        x264_tpu_torch.reset_launch_counts()
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        if d is cuda:
            c = x264_tpu_torch.launch_counts()
            types = [s.frame_type for s in enc.stats]
    assert streams[0] == streams[1]
    if p.i4x4 and p.backend != "reference":
        assert c["intra_nxn"], c
    if cut is not None:
        assert types[cut] == "IDR", types


# ---- another card than the current one, and the band mesh ----

@pytest.fixture
def last_card(cuda):
    """The host's last card, while card 0 stays the current device: a
    wrapper must launch on its tensors' card, not on the current one."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more cards, the host has {n}: on one "
                    "card the current device is the tensors' card")
    torch.cuda.set_device(0)
    return torch.device("cuda", n - 1)


def _on_last_card(case, dev):
    """One kernel wrapper on ``dev``'s tensors against its plain twin, one
    launch counted."""
    if case in ("esa16", "esa_parts"):
        s, r = _esa_inputs(dev, 7, 5, 16, 14)
        fn = (esa16.full_search_16x16 if case == "esa16"
              else esa_parts.full_search_parts)
        twin = (esa16.full_search_16x16_plain if case == "esa16"
                else esa_parts.full_search_parts_plain)
        got, want = fn(s, r, 14, 16, 7, 5), twin(s, r, 14, 16, 7, 5)
        if case == "esa_parts":
            got, want = [got[k] for k in want], list(want.values())
        return got, want
    if case == "deblock":
        planes, bs_v, bs_h, qp, qpc = _deblock_inputs(dev, 6, 4)
        args = (*planes, bs_v, bs_h, qp, qpc, 2, -2, 6, 4)
        return k_db.deblock_filter(*args), k_db.deblock_filter_plain(*args)
    if case == "trellis":
        c, dq = _trellis_inputs(dev, 1000, 16, 26, 255, 7)
        tbl = tr.tables_tuple(26, "P", 2)
        lam2f = tr.frame_trellis(26, "P", me_lambda(26), True)[2]
        return ([k_tr.trellis_quant(c, dq, lam2f, tbl, 16)],
                [tr.trellis_quant_plain(c, dq, lam2f, tbl, 16)])
    if case == "intra_nxn":
        state = _nxn_state(dev, 6, 4, 3)
        lam_t = torch.tensor([sad_lambda(26)], dtype=torch.int32,
                             device=dev)
        ry, grid = state[0], state[1]
        got = intra_nxn.nxn_candidates(ry.clone(), grid.clone(), state[2],
                                       state[3], lam_t, 4, 6, 4, True)
        want = intra_nxn.nxn_candidates_plain(ry.clone(), grid.clone(),
                                              state[2], state[3],
                                              sad_lambda(26), 4, 6, 4, True)
        return [got[k] for k in want], list(want.values())
    if case == "cavlc_blocks":
        from x264_tpu_torch.kernels import cavlc as k_cv
        from x264_tpu_torch.ops import cavlc as cv
        fields = [t.to(dev) for t in _cavlc_fields(9, 2, 5)]
        return (k_cv.residual_slots_(*fields, 9, 2),
                cv.residual_slots(*(t.cpu() for t in fields), 9, 2))
    if case == "bitpack":
        vals, lens = _tokens(37, 9 + 972, 11)
        parts = [t.contiguous() for t in (vals[:, :9], lens[:, :9],
                                          vals[:, 9:], lens[:, 9:])]
        want = bitpack.pack_blob_plain(*parts, 64)
        blob = bitpack.pack_blob(*(t.to(dev) for t in parts), 64)
        return ([blob, bitpack.place(blob, 64)],
                [want, bitpack.place_blob_plain(want, 64)])
    if case == "pir_column":
        from x264_tpu_torch.kernels import pir_column as k_pir
        inputs = _bar_case(dev, 6, 4, 5)
        t, f = inputs(dev)
        got = k_pir.pir_column_pass(*t[:6], f, t[6], t[7], 2, 6, 4, 3)
        t, f = inputs("cpu")
        want = k_pir.pir_column_pass_plain(*t[:6], f, t[6], t[7], 2, 6, 4,
                                           3)
        return ([*got[:3], *(got[3][k] for k in k_pir.FIELDS)],
                [*want[:3], *(want[3][k] for k in k_pir.FIELDS)])
    raise ValueError(case)


@pytest.mark.parametrize("case", ["esa16", "esa_parts", "deblock",
                                  "trellis", "intra_nxn", "cavlc_blocks",
                                  "bitpack", "pir_column"])
def test_kernel_wrappers_launch_on_their_tensors_card(last_card, case):
    """Each wrapper on the last card's tensors, card 0 current: its
    outputs on the last card, equal to the plain twin's, its launches
    counted (the bitpack case: the packing and the placement), and card
    0 still current."""
    before = x264_tpu_torch.launch_counts()[case]
    got, want = _on_last_card(case, last_card)
    torch.cuda.synchronize(last_card)
    assert x264_tpu_torch.launch_counts()[case] == before + (
        2 if case == "bitpack" else 1)
    assert torch.cuda.current_device() == 0
    for a, b in zip(got, want, strict=True):
        assert a.device == last_card
        assert torch.equal(a.cpu(), b.cpu())


def test_graph_and_host_copy_on_the_last_card(last_card):
    """The I16 core captured as a graph and replayed on the last card
    (card 0 current) equals the eager core there; a ``_HostCopy`` of a
    tensor that the last card is still computing waits for that card's
    stream."""
    from x264_tpu_torch.api import _HostCopy
    planes = _intra_planes(last_card, 96, 64, 4)
    kw = dict(mbw=6, mbh=4, cqp_off=0, lv_cap=96)
    qp_t = torch.full((1,), 30, dtype=torch.int32, device=last_card)
    eager = intra.i_frame_core(*planes, qp_t, **kw)
    got = graph.run_core(intra.i_frame_core, *planes, qp_t, **kw)
    assert torch.cuda.current_device() == 0
    for k in eager:
        assert got[k].device == last_card and torch.equal(got[k], eager[k])
    x = torch.randn((4096, 4096), device=last_card)
    for _ in range(30):
        x = torch.tanh(x @ x)
    t = (x[:512] > 0).to(torch.int32)
    host = _HostCopy(t).numpy()
    np.testing.assert_array_equal(host, t.cpu().numpy())


def _mesh_inputs(dev, mbw=120, mbh=68, seed=8):
    """A 1080p P frame of make_clip's formula and the previous frame's
    planes padded as references (the frames' own pixels as the recon)."""
    from chip_smoke import _pad_to_mb, make_clip_at
    from x264_tpu_torch.ops.mc import pad_edge
    frames = make_clip_at(16 * mbw, 16 * mbh, 2)
    cur = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
           for p, s in zip(frames[1], (16, 8, 8))]
    ref = [pad_edge(torch.from_numpy(_pad_to_mb(p, s)).to(dev), q)
           for p, s, q in zip(frames[0], (16, 8, 8), (PAD, PAD // 2,
                                                        PAD // 2))]
    return cur, ref


def test_mesh_step_on_one_card_equals_the_band_loop(cuda):
    """The step over card 0 four times on a 1080p ultrafast P frame (four
    bands of 17 rows, fullpel, CAVLC at 64 words) equals
    ``p_band_core`` on each band's rows and halo window, field for
    field."""
    from x264_tpu_torch.models.inter import p_band_core
    from x264_tpu_torch.parallel import sliced
    cur, ref = _mesh_inputs(cuda)
    kw = dict(me_range=16, cqp_off=0, subpel=0, n_words=64)
    step, _ = sliced.build_sliced_p_step([cuda] * 4, mbw=120,
                                         mbh_per_band=17, **kw)
    got = step(*cur, *ref, 26, sad_lambda(26))
    loop = []
    for b in range(4):
        y0 = 17 * b
        loop.append(p_band_core(
            cur[0][16 * y0:16 * (y0 + 17)], cur[1][8 * y0:8 * (y0 + 17)],
            cur[2][8 * y0:8 * (y0 + 17)],
            ref[0][16 * y0:16 * (y0 + 17) + 2 * PAD],
            ref[1][8 * y0:8 * (y0 + 17) + PAD],
            ref[2][8 * y0:8 * (y0 + 17) + PAD], 26, sad_lambda(26), mbw=120,
            mbh=17, me_range=16, cqp_off=0, subpel=0, n_words=64))
    assert set(got) == set(loop[0])
    for k in got:
        assert torch.equal(got[k], torch.cat([o[k] for o in loop])), k


def test_mesh_across_cards_equals_one_card(last_card):
    """The step over the host's cards (up to four; a band a card) equals
    the step over card 0 four times, field for field, on card 0; an
    encoder with ``threads`` on its cards and one whose card is the last
    one (``device="cuda:N"``, card 0 current) write the one-card
    stream."""
    from chip_smoke import split_motion_clip
    from x264_tpu_torch.parallel import sliced
    from x264_tpu_torch.params import param_default_preset
    n = 4 if torch.cuda.device_count() >= 4 else 2
    cur, ref = _mesh_inputs(torch.device("cuda", 0), mbh=4 * 17)
    kw = dict(mbw=120, mbh_per_band=68 // n, me_range=16, cqp_off=0,
              subpel=0, n_words=64)
    one, _ = sliced.build_sliced_p_step([torch.device("cuda", 0)] * n, **kw)
    mesh, _ = sliced.build_sliced_p_step(
        sliced.make_band_mesh(n, "cuda:0"), **kw)
    want = one(*cur, *ref, 26, sad_lambda(26))
    got = mesh(*cur, *ref, 26, sad_lambda(26))
    for k in want:
        assert got[k].device == want[k].device and \
            torch.equal(got[k], want[k]), k
    w, h = 96, 16 * n
    frames = [Frame420(*f) for f in split_motion_clip(w, h, 4)]
    p = param_default_preset("ultrafast").clone(width=w, height=h, qp=26,
                                                slices=n)
    streams = []
    for kwp, d in ((dict(threads=n), "cuda:0"), (dict(), "cuda:0"),
                   (dict(), str(last_card))):
        enc = Encoder(p.clone(**kwp), device=d)
        streams.append(b"".join(enc.encode(f) for f in frames) + enc.flush())
        assert torch.cuda.current_device() == 0
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.parametrize("coder", ["cabac", "cavlc"])
def test_warm_captures_every_graph_the_stream_reaches(cuda, coder):
    """bench.py's params (bench.py:67-72) at 1080p, and its CAVLC twin
    (no I4x4 or trellis): warm() returns True with the kernel library
    loaded; an IDR, a noise IDR whose levels overflow the first entropy
    rung and a mini-GOP after it add no graph; a second warm() returns
    True at once."""
    import time

    from chip_smoke import make_clip
    from x264_tpu_torch.kernels import build
    from x264_tpu_torch.params import TYPE_IDR
    w, h = 1920, 1080
    kw = dict(width=w, height=h, qp=26, me_range=16, backend="device",
              deblock=True, keyint_max=250, bframes=2, full_recon=False,
              cabac=True, transform_8x8=True, weightp=1, trellis=1,
              i4x4=True, p8x8=True, scenecut_threshold=0)
    if coder == "cavlc":
        kw.update(cabac=False, trellis=0, i4x4=False)
    enc = Encoder(EncoderParams(**kw), device=cuda)
    assert enc.warm(3600, full=True) is True
    assert build._lib is not None
    g0 = len(graph._GRAPHS)
    rng = np.random.default_rng(3)
    noise = Frame420(rng.integers(0, 256, (h, w), dtype=np.uint8),
                     rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
                     rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    clip = [Frame420(*f) for f in make_clip(4)]
    enc.encode(clip[0])
    enc.encode(noise, TYPE_IDR)
    for f in clip[1:]:
        enc.encode(f)
    enc.flush()
    torch.cuda.synchronize()
    assert [s.frame_type for s in enc.stats] == ["IDR", "IDR", "P", "B",
                                                 "B"]
    assert enc._rung_floor == enc._RUNGS[kw["cabac"]][-1]
    assert len(graph._GRAPHS) == g0
    t0 = time.perf_counter()
    assert enc.warm() is True
    assert time.perf_counter() - t0 < 0.01
