"""The port's deblocking against x264_tpu's: boundary strengths, the
kernel's plain twin against ``deblock._deblock_filter`` (the XLA twin of
the Pallas kernel) at the fixtures of tests/test_deblock_device.py plus
the small-mbh geometries, the CUDA kernel's row wait rule (one MB at a
time in the orders it allows), and ``deblock_frame`` end to end.  Same
seeded numpy inputs; tolerance 0."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _jax_maps import free_jax_executables  # noqa: E402,F401
import _one_thread  # noqa: E402,F401
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


@functools.lru_cache(maxsize=None)
def _xla_jit(mbw, mbh):
    """One compile of the XLA twin per geometry and test process."""
    return jax.jit(functools.partial(d_db._deblock_filter, mbw=mbw, mbh=mbh))


def _xla_filter(y, u, v, s, mbw, mbh):
    """The XLA twin on the fixture; returns (y, u, v, strengths, QPs)."""
    qpc = np.clip(s["qp"] - 3, 0, 51).astype(np.int32)
    bs = d_db.bs_grids(jnp.asarray(s["intra"]), jnp.asarray(s["nnz"]),
                       jnp.asarray(s["mv"]), jnp.asarray(s["ref"]), mbw, mbh)
    ref = _xla_jit(mbw, mbh)(y, u, v, *bs, s["qp"], qpc, np.int32(2),
                             np.int32(-2))
    return ([np.asarray(p) for p in ref],
            [torch.from_numpy(np.array(g)) for g in bs],
            torch.from_numpy(s["qp"]), torch.from_numpy(qpc))


def _kernel_order(mbw, mbh, slack, rng=None):
    """An order of the MBs' vertical ("v") and horizontal ("h") edges that
    the CUDA kernel's wait rule allows, one block per MB row running v, h
    of each MB left to right.  The kernel's progress[y] counts the MBs of
    row y whose pixels are final: x once row y has run v of MB x (the last
    edges to touch MB x-1), and mbw at the end of the row.  Row y may run h
    of MB x once progress[y-1] > x - slack (slack 0: the kernel's rule);
    v needs no wait.  Without rng: in rounds, every row that may run its
    next phase does, the lower rows first (each row as far ahead as the
    rule lets it, reading the row above before the row above moves on);
    with rng: one random ready row at a time."""
    done = [0] * mbh            # phases run per row: v0 h0 v1 h1 ...

    def progress(y):
        return mbw if done[y] == 2 * mbw else max((done[y] + 1) // 2 - 1, 0)

    def ready():
        return [y for y in range(mbh) if done[y] < 2 * mbw and
                (done[y] % 2 == 0 or y == 0
                 or progress(y - 1) > done[y] // 2 - slack)]

    order = []
    while len(order) < 2 * mbw * mbh:
        rows = ready()
        assert rows, "the wait rule deadlocked"
        if rng is not None:
            rows = [rows[rng.integers(len(rows))]]
        for y in sorted(rows, reverse=True):
            order.append((y, done[y] // 2, "vh"[done[y] % 2]))
            done[y] += 1
    return order


def _filter_in_order(y, u, v, bs, qp, qpc, mbw, order):
    yp, cp = k_db.padded_planes(*map(torch.from_numpy, (y, u, v)))
    for mby, mbx, phase in order:
        k_db.filter_mbs(yp, cp, phase == "v", torch.tensor([mby]),
                        torch.tensor([mbx]), *bs, qp, qpc, 2, -2, mbw)
    return [p.numpy() for p in k_db.unpadded_planes(yp, cp)]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("mbw,mbh", [(6, 4), (5, 7), (3, 2), (2, 2),
                                     (1, 3), (4, 1)])
def test_kernel_wait_rule_orders_match_xla(seed, mbw, mbh):
    """Filtering one MB's vertical or horizontal edges at a time in the
    order that runs each row as far ahead as the kernel's rule allows, and
    in a random order it allows, gives the XLA twin's planes bit for
    bit."""
    rng = np.random.default_rng(seed)
    y, u, v = _planes(rng, mbw, mbh)
    ref, bs, qp, qpc = _xla_filter(y, u, v, _syntax(rng, mbw, mbh), mbw,
                                   mbh)
    for order in (_kernel_order(mbw, mbh, 0),
                  _kernel_order(mbw, mbh, 0, np.random.default_rng(seed))):
        assert sorted(order) == [(r, c, p) for r in range(mbh)
                                 for c in range(mbw) for p in "hv"]
        got = _filter_in_order(y, u, v, bs, qp, qpc, mbw, order)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mbw,mbh", [(6, 4), (5, 7)])
def test_kernel_wait_rule_weakened_breaks(rng, mbw, mbh):
    """The rule weakened by one MB (row y runs MB x's horizontal edges as
    soon as the row above has run MB x's vertical edges) lets row y read
    pixels before the row above's MB x+1 filters them: the planes differ
    from the twin's."""
    y, u, v = _planes(rng, mbw, mbh)
    s = _syntax(rng, mbw, mbh)
    qp = torch.from_numpy(s["qp"])
    qpc = (qp - 3).clamp(0, 51)
    bs = t_db.bs_grids(*(torch.from_numpy(s[k])
                         for k in ("intra", "nnz", "mv", "ref")), mbw, mbh)
    want = k_db.deblock_filter_plain(*map(torch.from_numpy, (y, u, v)), *bs,
                                     qp, qpc, 2, -2, mbw, mbh)
    assert _kernel_order(mbw, mbh, 1) != _kernel_order(mbw, mbh, 0)
    got = _filter_in_order(y, u, v, bs, qp, qpc, mbw,
                           _kernel_order(mbw, mbh, 1))
    assert any(not np.array_equal(a, b.numpy()) for a, b in zip(got, want))


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
