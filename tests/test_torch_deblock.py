"""The port's deblocking against x264_tpu's: boundary strengths, the
kernels' plain twin against ``deblock._deblock_filter`` (the XLA twin of
the Pallas kernel) at the fixtures of tests/test_deblock_device.py plus
the small-mbh geometries, and ``deblock_frame`` end to end.  Same seeded
numpy inputs; tolerance 0."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from x264_tpu.bitstream.tables import CHROMA_QP_TABLE  # noqa: E402
from x264_tpu.ops.device import deblock as d_db  # noqa: E402
from x264_tpu_torch.kernels import deblock as k_db  # noqa: E402
from x264_tpu_torch.ops import deblock as t_db  # noqa: E402


def _planes(rng, mbw, mbh):
    h, w = mbh * 16, mbw * 16
    # smooth content so that most edges pass the alpha/beta tests
    base = rng.integers(60, 200, (mbh * 4 + 1, mbw * 4 + 1))
    y = np.kron(base, np.ones((4, 4)))[:h, :w] + rng.integers(-6, 7, (h, w))
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = np.clip(y[::2, ::2].astype(np.int32) + rng.integers(-3, 4,
                                                            (h // 2, w // 2)),
                0, 255).astype(np.uint8)
    v = np.clip(255 - u.astype(np.int32), 0, 255).astype(np.uint8)
    return y, u, v


def _syntax(rng, mbw, mbh):
    n = mbw * mbh
    return dict(
        intra=rng.random(n) < 0.2,
        nnz=(rng.random((n, 16)) < 0.4).astype(np.int32),
        mv=rng.integers(-32, 33, (n, 2)).astype(np.int32),
        ref=np.zeros(n, np.int32),
        qp=rng.integers(10, 46, n).astype(np.int32))


@pytest.mark.parametrize("mbw,mbh", [(6, 4), (5, 7), (3, 2), (2, 2)])
def test_filter_plain_matches_xla(rng, mbw, mbh):
    y, u, v = _planes(rng, mbw, mbh)
    s = _syntax(rng, mbw, mbh)
    qpc = np.clip(s["qp"] - 3, 0, 51).astype(np.int32)
    bs_r = d_db.bs_grids(jnp.asarray(s["intra"]), jnp.asarray(s["nnz"]),
                         jnp.asarray(s["mv"]), jnp.asarray(s["ref"]),
                         mbw, mbh)
    bs_p = t_db.bs_grids(*(torch.from_numpy(s[k])
                           for k in ("intra", "nnz", "mv", "ref")),
                         mbw, mbh)
    for a, b in zip(bs_p, bs_r):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ref = jax.jit(functools.partial(d_db._deblock_filter, mbw=mbw,
                                    mbh=mbh))(
        y, u, v, *bs_r, s["qp"], qpc, np.int32(2), np.int32(-2))
    port = k_db.deblock_filter(torch.from_numpy(y), torch.from_numpy(u),
                               torch.from_numpy(v), *bs_p,
                               torch.from_numpy(s["qp"]),
                               torch.from_numpy(qpc), 2, -2, mbw, mbh)
    for a, b in zip(port, ref):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not np.array_equal(port[0].numpy(), y)     # the filter did work


@pytest.mark.parametrize("cqp_off", [0, 4])
def test_deblock_frame_end_to_end(rng, cqp_off):
    """QP chain (skip / no-residual MBs carry the previous QP), chroma QP
    lookup, strengths and filter against the reference's deblock_frame."""
    mbw, mbh = 5, 4
    n = mbw * mbh
    y, u, v = _planes(rng, mbw, mbh)
    s = _syntax(rng, mbw, mbh)
    mb_class = rng.choice([0, 2, 3], n, p=[.2, .5, .3]).astype(np.int32)
    cbp_l = (rng.integers(0, 16, n) * (rng.random(n) < .5)).astype(np.int32)
    cbp_c = (rng.integers(0, 3, n) * (rng.random(n) < .5)).astype(np.int32)
    cbp_l[mb_class == 3] = 0
    cbp_c[mb_class == 3] = 0
    args = (y, u, v, mb_class, cbp_l, cbp_c, s["nnz"], s["mv"], s["ref"],
            s["qp"])
    ref = d_db.deblock_frame(*map(jnp.asarray, args), np.int32(0),
                             np.int32(2), mbw=mbw, mbh=mbh, impl="xla",
                             cqp_off=cqp_off,
                             chroma_qp_table=jnp.asarray(CHROMA_QP_TABLE))
    port = t_db.deblock_frame(*map(torch.from_numpy, args), 0, 2, mbw, mbh,
                              cqp_off=cqp_off)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
