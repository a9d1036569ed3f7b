"""The port's motion search against x264_tpu's: the ESA kernel's plain
twin against ``me._full_search_xla`` (the XLA twin of the Pallas kernel)
at the fixtures of tests/test_device_parity.py, and the direct-gather
subpel refinement against the reference's half-pel-planes path.  Same
seeded numpy inputs; tolerance 0."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
from x264_tpu.models.inter_frame import PAD  # noqa: E402
from x264_tpu.ops.device import me as d_me  # noqa: E402
from x264_tpu.ops.device.mc import hpel_planes  # noqa: E402
import x264_tpu_torch  # noqa: E402
from x264_tpu_torch.kernels import esa16  # noqa: E402
from x264_tpu_torch.ops import me as t_me  # noqa: E402


def _search_inputs(rng, mbw, mbh):
    h, w = mbh * 16, mbw * 16
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    big = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.int32)
    big[PAD - 3:PAD - 3 + h, PAD + 5:PAD + 5 + w] = src
    ref = np.clip(big + rng.integers(-6, 7, big.shape), 0, 255
                  ).astype(np.uint8)
    return src, ref


@pytest.mark.parametrize("mbw,mbh,me_range",
                         [(6, 4, 8), (7, 5, 16), (10, 6, 8), (16, 9, 8)])
def test_full_search_plain_matches_xla(rng, mbw, mbh, me_range):
    src, ref = _search_inputs(rng, mbw, mbh)
    lam = 14
    mv_r, c_r = d_me._full_search_xla(jnp.asarray(src), jnp.asarray(ref),
                                      np.int32(lam), me_range=me_range,
                                      mbw=mbw, mbh=mbh)
    before = x264_tpu_torch.launch_counts()["esa16"]
    # the wrapper takes the plain twin for CPU tensors and counts nothing
    mv_p, c_p = t_me.full_search_16x16(torch.from_numpy(src),
                                       torch.from_numpy(ref), lam,
                                       me_range, mbw, mbh)
    assert x264_tpu_torch.launch_counts()["esa16"] == before
    assert mv_p.dtype == torch.int32 and c_p.dtype == torch.int32
    np.testing.assert_array_equal(mv_p.numpy(), np.asarray(mv_r))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))


def test_full_search_tie_goes_to_first_candidate():
    """A flat frame makes every candidate's SAD 0; with lam 0 all costs
    tie and the first candidate in (dy, dx) raster order, (-r, -r),
    wins — in the port as in the reference."""
    mbw, mbh, r = 2, 2, 4
    src = np.full((32, 32), 77, np.uint8)
    ref = np.full((32 + 2 * PAD, 32 + 2 * PAD), 77, np.uint8)
    mv_r, _ = d_me._full_search_xla(jnp.asarray(src), jnp.asarray(ref),
                                    np.int32(0), me_range=r, mbw=mbw,
                                    mbh=mbh)
    mv_p, _ = esa16.full_search_16x16_plain(
        torch.from_numpy(src), torch.from_numpy(ref), 0, r, mbw, mbh)
    np.testing.assert_array_equal(mv_p.numpy(), np.asarray(mv_r))
    assert (mv_p.numpy() == -4 * r).all()


def test_full_search_rejects_range_beyond_padding(rng):
    src, ref = _search_inputs(rng, 2, 2)
    with pytest.raises(ValueError):
        t_me.full_search_16x16(torch.from_numpy(src), torch.from_numpy(ref),
                               4, PAD + 1, 2, 2)


@pytest.mark.parametrize("steps", [1, 2])
def test_subpel_refine_direct_gather_matches_planes_path(rng, steps):
    mbw, mbh, mer = 6, 4, 8
    h, w = mbh * 16, mbw * 16
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ref = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.uint8)
    src_mbs = (src.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
               .reshape(mbw * mbh, 16, 16).astype(np.int32))
    mv0 = (rng.integers(-mer, mer + 1, (mbw * mbh, 2)) * 4).astype(np.int32)
    lam = 9
    planes = hpel_planes(jnp.asarray(ref))
    mv_r, c_r, pred_r = d_me.subpel_refine(
        jnp.asarray(src_mbs), planes, jnp.asarray(mv0), np.int32(lam), mer,
        steps, mbw, mbh, return_pred=True)
    mv_p, c_p, pred_p = t_me.subpel_refine(
        torch.from_numpy(src_mbs), torch.from_numpy(ref),
        torch.from_numpy(mv0), lam, mer, steps, mbw, mbh, return_pred=True)
    np.testing.assert_array_equal(mv_p.numpy(), np.asarray(mv_r))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(pred_p.numpy(), np.asarray(pred_r))
    mv_q, c_q = t_me.subpel_refine(
        torch.from_numpy(src_mbs), torch.from_numpy(ref),
        torch.from_numpy(mv0), lam, mer, steps, mbw, mbh)
    assert torch.equal(mv_q, mv_p) and torch.equal(c_q, c_p)
    assert t_me.subpel_candidates(steps) == d_me.subpel_candidates(steps)
