"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card (they have no CPU mode, so these tests skip without one).  Imports
no JAX, so the card's machine runs them as they are:

    python -m pytest -o addopts="" -m cuda tests/test_torch_kernels_cuda.py

Tolerance 0: all of it is integer arithmetic."""

import numpy as np
import pytest
import torch

from x264_tpu.models.inter_frame import PAD
from x264_tpu.params import EncoderParams
from x264_tpu.utils.yuv import Frame420
import x264_tpu_torch
from x264_tpu_torch.api import Encoder
from x264_tpu_torch.kernels import deblock as k_db
from x264_tpu_torch.kernels import esa16
from x264_tpu_torch.ops.deblock import bs_grids

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mbw,mbh,me_range,lam",
                         [(7, 5, 16, 14), (16, 9, 8, 4), (3, 2, 32, 90),
                          (4, 4, 16, 0)])
def test_esa16_kernel_matches_plain(cuda, mbw, mbh, me_range, lam):
    rng = np.random.default_rng(mbw * 100 + me_range)
    h, w = 16 * mbh, 16 * mbw
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    big = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.int32)
    big[PAD - 3:PAD - 3 + h, PAD + 5:PAD + 5 + w] = src
    ref = np.clip(big + rng.integers(-6, 7, big.shape), 0, 255
                  ).astype(np.uint8)
    if lam == 0:
        src[:] = 90          # flat: every candidate ties
        ref[:] = 90
    s, r = torch.from_numpy(src).to(cuda), torch.from_numpy(ref).to(cuda)
    before = x264_tpu_torch.launch_counts()["esa16"]
    mv_k, c_k = esa16.full_search_16x16(s, r, lam, me_range, mbw, mbh)
    assert x264_tpu_torch.launch_counts()["esa16"] == before + 1
    mv_p, c_p = esa16.full_search_16x16_plain(s, r, lam, me_range, mbw, mbh)
    torch.cuda.synchronize()
    assert torch.equal(mv_k, mv_p) and torch.equal(c_k, c_p)


@pytest.mark.parametrize("mbw,mbh", [(6, 4), (5, 7), (3, 2), (2, 2),
                                     (1, 3), (120, 68)])
def test_deblock_kernels_match_plain(cuda, mbw, mbh):
    rng = np.random.default_rng(mbw * 10 + mbh)
    n, h, w = mbw * mbh, 16 * mbh, 16 * mbw
    base = rng.integers(60, 200, (mbh * 4 + 1, mbw * 4 + 1))
    y = np.clip(np.kron(base, np.ones((4, 4)))[:h, :w]
                + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.uint8)
    u = np.ascontiguousarray(y[::2, ::2])
    v = np.ascontiguousarray(255 - y[1::2, 1::2])
    bs_v, bs_h = bs_grids(
        torch.from_numpy(rng.random(n) < 0.2).to(cuda),
        torch.from_numpy((rng.random((n, 16)) < 0.4).astype(np.int32)
                         ).to(cuda),
        torch.from_numpy(rng.integers(-32, 33, (n, 2)).astype(np.int32)
                         ).to(cuda),
        torch.zeros(n, dtype=torch.int32, device=cuda), mbw, mbh)
    qp = torch.from_numpy(rng.integers(10, 46, n).astype(np.int32)).to(cuda)
    qpc = (qp - 3).clamp(0, 51)
    planes = [torch.from_numpy(p).to(cuda) for p in (y, u, v)]
    out_k = k_db.deblock_filter(*planes, bs_v, bs_h, qp, qpc, 2, -2, mbw,
                                mbh)
    out_p = k_db.deblock_filter_plain(*planes, bs_v, bs_h, qp, qpc, 2, -2,
                                      mbw, mbh)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    assert not torch.equal(out_k[0], planes[0])


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
