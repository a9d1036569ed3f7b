"""The ESA kernels' host-side rules, on the CPU: the 32-bit argmin key and
its range check (kernels/esa16.py), the tile and staging geometry of
csrc/esa_core.cuh, and the parser of ptxas's register report
(kernels/build.py).  The geometry is a Python mirror of make_geom and of
the tile heights in Tiles; the card test
test_torch_kernels_cuda.test_esa_geometry_matches_mirror holds the mirror
to the geometry the kernels' launches compute (esa_geom_query), and the
kernels themselves run only on the card.  Tolerance 0."""

import os
import re

import numpy as np
import pytest

from _test_clock import per_test_clock  # noqa: F401

from x264_tpu_torch.kernels import build
from x264_tpu_torch.kernels.esa16 import (KEY_CAND_BITS, KEY_COST_BITS,
                                          SAD_MAX, check_key_range, pack_key,
                                          unpack_key)
from x264_tpu_torch.state import PAD, mv_bits_arr, sad_lambda

# the largest lambda whose costs fit at r = 32 (mv bits up to 17) beside
# the cost of a masked candidate (a SAD of up to SAD_MAX above them)
_LAM_MAX = ((1 << KEY_COST_BITS) - 1 - 2 * SAD_MAX) // (2 * 17)


@pytest.mark.parametrize("me_range", [1, 8, 16, 24, 32])
def test_key_range_accepts_qp51(me_range):
    assert sad_lambda(51) == 91
    check_key_range(sad_lambda(51), me_range)
    assert 2 * SAD_MAX + 91 * 2 * int(mv_bits_arr(4 * me_range).max()) \
        < 1 << KEY_COST_BITS


@pytest.mark.parametrize("lam,me_range", [(_LAM_MAX + 1, 32),
                                          (1 << 20, 16), (-1, 8)])
def test_key_range_rejects_overflow(lam, me_range):
    check_key_range(_LAM_MAX, 32)
    with pytest.raises(ValueError):
        check_key_range(lam, me_range)


def test_key_range_rejects_too_many_candidates():
    with pytest.raises(ValueError):
        check_key_range(4, 46)          # 93^2 > 2^13 candidates


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_key_min_is_the_raster_first_winner(seed):
    """Costs with many ties over r = 32's 4225 candidates: the least key,
    taken in shuffled order, unpacks to the least cost and the first
    candidate in raster order that has it; the empty key never wins."""
    rng = np.random.default_rng(seed)
    n = 65 * 65
    cost = rng.integers(0, 40, n).astype(np.uint32)
    cost[rng.integers(0, n, 5)] = 0
    cost[-1] = (1 << KEY_COST_BITS) - 1
    keys = pack_key(cost, np.arange(n, dtype=np.uint32))
    order = rng.permutation(n)
    best = np.uint32(0xFFFFFFFF)
    for k in keys[order]:
        best = min(best, k)
    got_cost, got_cand = unpack_key(best)
    assert got_cost == cost.min()
    assert got_cand == int(np.flatnonzero(cost == cost.min())[0])
    assert unpack_key(keys[-1]) == ((1 << KEY_COST_BITS) - 1, n - 1)
    assert n < 1 << KEY_CAND_BITS


# esa_core.cuh's Tiles: kernel units -> (short, tall) tile heights, the
# tall one from range TALL_FROM on
TILES = {1: (6, 11), 9: (3, 4)}
TALL_FROM = 12


def tile_rows(units, r):
    """esa_core.cuh's tile_rows."""
    return TILES[units][r >= TALL_FROM]


def _geom(r, pad, ty, threads=256, max_mbs=16, max_smem=96 * 1024):
    """esa_core.cuh's make_geom."""
    g = dict(span=2 * r + 1, win=16 + 2 * r, off=(pad - r) & 15)
    g["g0"] = g["off"] >> 2
    g["ngx"] = ((g["off"] + g["span"] - 1) >> 2) - g["g0"] + 1
    g["ngy"] = -(-g["span"] // ty)
    g["tiles"] = g["ngx"] * g["ngy"]
    g["chunks"] = (g["off"] + g["win"] + 15) // 16
    g["stride"] = 4 * (g["chunks"] | 1)
    g["rows"] = g["ngy"] * ty + 16
    g["per_mb"] = g["rows"] * g["stride"] + 64
    g["copies"] = g["win"] * g["chunks"] + 16
    g["mbs"] = min(max(threads // g["tiles"], 1), max_mbs,
                   max_smem // (2 * 4 * g["per_mb"]))
    return g


@pytest.mark.parametrize("ty", sorted({t for p in TILES.values() for t in p}))
def test_tiles_cover_every_candidate_once(ty):
    """For every range 0-32: the tiles' (group, shift, row) slots hold each
    candidate exactly once; every byte a candidate reads is staged, and
    every word a tile reads is allocated (the fifth word of a group may be
    the next row's first, which feeds only masked shifts); the staged
    columns of the first and last MB stay inside the padded row; a
    thread's two copies cover an MB; a group's lanes fit the CTA, or the
    group is one MB; the double buffer fits 96 KB; every candidate index
    fits the key."""
    for r in range(PAD + 1):
        g = _geom(r, PAD, ty)
        seen = np.zeros((g["span"], g["span"]), np.int64)
        for gy in range(g["ngy"]):
            for gx in range(g["ngx"]):
                gw = g["g0"] + gx
                assert gw + 4 <= g["stride"]
                dx0 = 4 * gw - g["off"]
                for u in range(ty):
                    dyi = ty * gy + u
                    assert dyi + 15 < g["rows"] - 1
                    for x in range(4):
                        dxi = dx0 + x
                        if 0 <= dxi < g["span"] and dyi < g["span"]:
                            seen[dyi, dxi] += 1
                            assert g["off"] + dxi + 15 < 16 * g["chunks"]
                            assert dyi + 15 < g["win"]
        assert (seen == 1).all(), r
        assert (g["stride"] // 4) % 2 == 1 and g["stride"] >= 4 * g["chunks"]
        w = 16 * 3
        first = PAD - r - g["off"]
        assert first >= 0 and first % 16 == 0
        last = PAD + 16 * 2 - r - g["off"] + 16 * g["chunks"]
        assert last <= w + 2 * PAD
        assert g["copies"] <= 2 * 256
        assert g["mbs"] * g["tiles"] <= 256 or g["mbs"] == 1
        assert 2 * g["mbs"] * g["per_mb"] * 4 <= 96 * 1024
        assert g["span"] ** 2 < 1 << KEY_CAND_BITS
    assert _geom(16, PAD, 4)["mbs"] * _geom(16, PAD, 4)["tiles"] == 243
    assert _geom(16, PAD, 11)["mbs"] == 9


def test_tiles_mirror_the_source():
    """TILES and TALL_FROM are what esa_core.cuh says, and each kernel
    takes its tall tile at the main path's range 16 and its short one at
    lookahead's range 8."""
    path = os.path.join(os.path.dirname(build.__file__), os.pardir, "csrc",
                        "esa_core.cuh")
    with open(path) as f:
        text = f.read()
    got = {int(u): (int(a), int(b)) for u, a, b in re.findall(
        r"struct Tiles<(\d)> \{\n  static constexpr int kShort = (\d+), "
        r"kTall = (\d+),", text)}
    assert got == TILES
    assert re.search(r"constexpr int kTallFrom = (\d+);", text
                     ).group(1) == str(TALL_FROM)
    assert [tile_rows(u, r) for u in (1, 9) for r in (8, 16)] == [6, 11, 3, 4]


def test_kernel_resources_parses_ptxas():
    log = """== esa16.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3esa13search_kernelILi1ELi4EEEvPKh' for 'sm_90a'
ptxas info    : Function properties for _ZN3esa13search_kernelILi1ELi4EEEvPKh
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z13esa_sad_probePji' for 'sm_90a'
ptxas info    : Function properties for _Z13esa_sad_probePji
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers, 368 bytes cmem[0]
"""
    got = build.kernel_resources(log)
    assert got == {"_ZN3esa13search_kernelILi1ELi4EEEvPKh": (122, 0, 0, 0, 0),
                   "_Z13esa_sad_probePji": (40, 4, 8, 0, 8)}
