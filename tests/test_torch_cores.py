"""The port's frame cores against x264_tpu's, key by key, including the
CABAC ``host_blob``: ``i_frame_core`` (CABAC) and ``p_frame_core``
(single reference, CABAC), the P core fed the same reference frame on
both sides (``state.to_port``).  Tolerance 0."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from x264_tpu.models import inter_device, intra_device  # noqa: E402
from x264_tpu.models.inter_frame import sad_lambda  # noqa: E402
from x264_tpu_torch.models import inter, intra  # noqa: E402
from x264_tpu_torch.state import to_port  # noqa: E402

MBW, MBH, LV_CAP = 5, 3, 96


def _frames(rng):
    """Two textured frames: the second pans the first by (2, 3) px and
    carries a patch the reference lacks (so some MBs go intra)."""
    h, w = 16 * MBH, 16 * MBW
    tex = rng.integers(0, 256, (h + 8, w + 8)).astype(np.int32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) // 3
    y0 = tex[4:4 + h, 4:4 + w].astype(np.uint8)
    y1 = tex[2:2 + h, 1:1 + w].astype(np.uint8).copy()
    yy, xx = np.mgrid[0:16, 0:32]
    y1[16:32, 32:64] = (40 + 6 * yy + 3 * xx).astype(np.uint8)
    u0 = tex[::2, ::2][:h // 2, :w // 2].astype(np.uint8)
    v0 = (255 - tex[1::2, 1::2][:h // 2, :w // 2]).astype(np.uint8)
    u1 = np.roll(u0, 1, 1).copy()
    v1 = np.roll(v0, 1, 0).copy()
    return (y0, u0, v0), (y1, u1, v1)


def _compare(port: dict, ref: dict):
    assert set(port) == set(ref)
    for k in ref:
        p, r = port[k], np.asarray(ref[k])
        assert tuple(p.shape) == r.shape, k
        np.testing.assert_array_equal(p.numpy(), r, err_msg=k)


@pytest.mark.parametrize("qp", [0, 26, 51])
def test_i_frame_core(rng, qp):
    f0, _ = _frames(rng)
    ref = intra_device.i_frame_core(*map(jnp.asarray, f0), np.int32(qp),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    entropy="cabac", lv_cap=LV_CAP)
    port = intra.i_frame_core(*map(torch.from_numpy, f0), qp, mbw=MBW,
                              mbh=MBH, cqp_off=0, lv_cap=LV_CAP)
    _compare(port, ref)


@pytest.mark.parametrize("qp", [0, 26, 51])
def test_p_frame_core(rng, qp):
    f0, f1 = _frames(rng)
    # the reference frame: the reference encoder's I recon
    rec = intra_device.i_frame_core(*map(jnp.asarray, f0), np.int32(qp),
                                    mbw=MBW, mbh=MBH, cqp_off=0,
                                    entropy="cabac", lv_cap=LV_CAP)
    ref_planes = [np.asarray(rec[k]) for k in ("recon_y", "recon_u",
                                                "recon_v")]
    lam = sad_lambda(qp)
    ref = inter_device.p_frame_core(
        *map(jnp.asarray, f1), *map(jnp.asarray, ref_planes), np.int32(qp),
        np.int32(lam), mbw=MBW, mbh=MBH, me_range=16, cqp_off=0, subpel=2,
        entropy="cabac", lv_cap=LV_CAP)
    port = inter.p_frame_core(*map(torch.from_numpy, f1),
                              *to_port(ref_planes, "cpu"), qp, lam,
                              mbw=MBW, mbh=MBH, me_range=16, cqp_off=0,
                              subpel=2, lv_cap=LV_CAP)
    _compare(port, ref)
    if qp == 26:
        classes = set(port["mb_class"].tolist())
        assert {0, 2} <= classes, classes   # intra-in-P and P16 occur
