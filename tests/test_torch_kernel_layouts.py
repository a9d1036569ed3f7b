"""The work layouts of csrc/intra_nxn.cu and csrc/trellis.cu, on the CPU:
the kernels' own tables parsed from their sources and held to the plain
twins, and Python mirrors of the lane arithmetic that the tables feed.
The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py holds them to the twins there).
Imports only the port, no JAX.  Tolerance 0: all of it is integer or
compares float32 values exactly."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from x264_tpu_torch.kernels import build
from x264_tpu_torch.kernels.intra_nxn import _SUBSTEPS
from x264_tpu_torch.ops import pixel as P
from x264_tpu_torch.ops import predict as PR
from x264_tpu_torch.ops.trellis import BIG, GROUP_IDX, TRANS_EQ1, TRANS_GT1

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "x264_tpu_torch", "csrc")


def _source(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _table(src: str, name: str) -> np.ndarray:
    """A brace-initialised integer table of the source, as an array."""
    body = re.search(name + r"(?:\[\w+\])+ = \{(.*?)\n\};", src, re.S).group(1)
    rows = re.findall(r"\{([^{}]*)\}", body)
    return np.array([[int(v) for v in r.split(",") if v.strip()]
                     for r in rows])


def _f2(e):
    return (e[:, :-1] + e[:, 1:] + 1) >> 1


def _f3(e, lok=None, rok=None):
    """Three-tap average of each entry of the edge line; a neighbour off
    the line's ends (or, where lok / rok say so, unavailable) counts as
    the centre."""
    left = torch.cat([e[:, :1], e[:, :-1]], 1)
    right = torch.cat([e[:, 1:], e[:, -1:]], 1)
    if lok is not None:
        left = torch.where(lok, left, e)
        right = torch.where(rok, right, e)
    return (left + 2 * e + right + 2) >> 2


def _dc(at, al, st, sl, n):
    both = (st + sl + n) >> (3 if n == 4 else 4)
    one_t = (st + n // 2) >> (2 if n == 4 else 3)
    one_l = (sl + n // 2) >> (2 if n == 4 else 3)
    return torch.where(at & al, both, torch.where(
        at, one_t, torch.where(al, one_l, torch.full_like(st, 128))))


def _value_rows(n, top, left, tl, at, al, atl, atr):
    """The kernel's value row [E, F2, F3, DC] of a block (n = 4 or 8)
    from its raw edges: E = the left column bottom-up, the corner and the
    top row, the top-right half replaced when unavailable (8.3.1.2.1);
    for 8x8 after the 8.3.2.2.1 filter, whose neighbour rule is the
    kernel's (lok / rok of i8_chain)."""
    top = torch.cat([top[:, :n], torch.where(atr[:, None], top[:, n:],
                                             top[:, n - 1:n])], 1)
    e = torch.cat([left.flip(1), tl[:, None], top], 1)
    if n == 8:
        lane = torch.arange(e.shape[1])[None]
        lok = (lane > 0) & ~((lane == 8) & ~al[:, None]) \
            & ~((lane == 9) & ~atl[:, None])
        rok = (lane < 24) & ~((lane == 8) & ~at[:, None]) \
            & ~((lane == 7) & ~atl[:, None])
        e = _f3(e, lok, rok)
    st = e[:, n + 1:2 * n + 1].sum(1)
    sl = e[:, :n].sum(1)
    return torch.cat([e, _f2(e), _f3(e), _dc(at, al, st, sl, n)[:, None]], 1)


def test_nxn_substeps_match_the_twin():
    """kSubsteps equals the twin's _SUBSTEPS, and every block's left,
    top, top-left and top-right neighbours inside the MB come in an
    earlier sub-step, so the two half-warps of a sub-step never wait on
    each other."""
    src = _source("intra_nxn.cu")
    body = re.search(r"kSubsteps\[10\]\[2\]\[2\] = \{(.*?)\n\s*\};",
                     src, re.S).group(1)
    steps = [[(int(a), int(b)) for a, b in
              re.findall(r"\{(-?\d+), (-?\d+)\}", row)]
             for row in re.findall(r"\{(\{[^{}]*\}, \{[^{}]*\})\}", body)]
    assert len(steps) == 10
    got = [[b for b in s if b != (-1, -1)] for s in steps]
    assert got == [list(map(tuple, s)) for s in _SUBSTEPS]
    when = {b: i for i, s in enumerate(got) for b in s}
    assert sorted(when) == [(x, y) for x in range(4) for y in range(4)]
    for (x, y), s in when.items():
        assert s == x + 2 * y
        for nb in ((x - 1, y), (x, y - 1), (x - 1, y - 1), (x + 1, y - 1)):
            if nb in when:
                assert when[nb] < s, ((x, y), nb)


@pytest.mark.parametrize("n", [4, 8])
def test_nxn_prediction_tables_match_the_plain_predictors(n):
    """Every entry of kPred4 / kPred8 is the one place of the value row
    that equals the plain predictor's output, on random edges with every
    neighbour available (the entries differ there)."""
    tab = _table(_source("intra_nxn.cu"), f"kPred{n}")
    assert tab.shape == (9, n * n)
    rng = np.random.default_rng(n)
    m = 64
    top = torch.from_numpy(rng.integers(0, 256, (m, 2 * n))).int()
    left = torch.from_numpy(rng.integers(0, 256, (m, n))).int()
    tl = torch.from_numpy(rng.integers(0, 256, m)).int()
    yes = torch.ones(m, dtype=torch.bool)
    if n == 4:
        pred = PR.predict_4x4_all(top, left, tl, yes, yes, yes)
    else:
        pred = PR.predict_8x8_all(top, left, tl, yes, yes, yes, yes)
    rows = _value_rows(n, top, left, tl, yes, yes, yes, yes)
    hit = (rows[:, None, None, :] == pred.reshape(m, 9, n * n, 1)).all(0)
    assert (hit.sum(-1) == 1).all()
    assert np.array_equal(hit.int().argmax(-1).numpy(), tab)


@pytest.mark.parametrize("n", [4, 8])
def test_nxn_value_rows_mirror_every_availability(n):
    """The kernel's prediction (its value row at kPred's entry) equals the
    plain predictor for every available mode, in every combination of
    neighbour availability, on random edges."""
    tab = torch.from_numpy(_table(_source("intra_nxn.cu"), f"kPred{n}"))
    rng = np.random.default_rng(10 + n)
    combos = list(itertools.product([False, True], repeat=4))
    m = 16 * len(combos)
    flags = torch.tensor(combos).repeat(16, 1)
    at, al, atl, atr = flags.unbind(1)
    top = torch.from_numpy(rng.integers(0, 256, (m, 2 * n))).int()
    left = torch.from_numpy(rng.integers(0, 256, (m, n))).int()
    tl = torch.from_numpy(rng.integers(0, 256, m)).int()
    if n == 4:
        pred = PR.predict_4x4_all(top, left, tl, at, al, atr)
        avail = PR.i4x4_mode_avail(at, al, atl)
    else:
        pred = PR.predict_8x8_all(top, left, tl, at, al, atl, atr)
        avail = PR.i8x8_mode_avail(at, al, atl)
    rows = _value_rows(n, top, left, tl, at, al, atl, atr)
    got = rows[:, tab.reshape(-1)].reshape(m, 9, n * n)
    same = (got == pred.reshape(m, 9, n * n)).all(-1)
    assert (same | ~avail).all()
    assert avail.sum() > m


def _lane_satd(d: torch.Tensor, bits: tuple) -> torch.Tensor:
    """The kernels' SATD: butterflies across the lane bits ``bits`` (the
    lower lane keeps the sum, the upper one the difference), the sum of
    absolute values over all lanes, then the final >> 1."""
    lane = torch.arange(d.shape[-1])
    for o in bits:
        w = d[..., lane ^ o]
        d = torch.where((lane & o) != 0, w - d, d + w)
    return d.abs().sum(-1) >> 1


def test_nxn_lane_hadamard_equals_satd():
    """The lane-order Walsh-Hadamard of intra_nxn.cu gives the twin's
    SATD: a half-warp per 4x4 block (lane bits 0-1 x, 2-3 y) and, for
    8x8, two pixels a lane (lane bits 0-2 x, 3-4 y, rows y and y + 4)
    with the four 4x4 transforms inside."""
    rng = np.random.default_rng(3)
    d4 = torch.from_numpy(rng.integers(-255, 256, (200, 4, 4))).int()
    assert torch.equal(_lane_satd(d4.reshape(200, 16), (1, 2, 4, 8)),
                       P.satd(d4, torch.zeros_like(d4)))
    d8 = torch.from_numpy(rng.integers(-255, 256, (200, 8, 8))).int()
    regs = d8.reshape(200, 2, 32)          # rows 0-3, rows 4-7
    lane = torch.arange(32)
    for o in (1, 2, 8, 16):
        w = regs[..., lane ^ o]
        regs = torch.where((lane & o) != 0, w - regs, regs + w)
    got = regs.abs().sum((-1, -2)) >> 1
    assert torch.equal(got, P.satd(d8, torch.zeros_like(d8)))


def _groups_of_kernel():
    """csrc/trellis.cu's groups (kGroupLen, kGroupCol) and kGroupMax."""
    src = _source("trellis.cu")
    lens = [int(x) for x in re.search(
        r"kGroupLen\[9\] = \{([^}]*)\}", src).group(1).split(",")]
    body = re.search(r"kGroupCol\[9\]\[kGroupMax\] = \{(.*?)\n\s*\};", src,
                     re.S).group(1)
    cols = [[int(x) for x in r.split(",") if x.strip()]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    gmax = int(re.search(r"kGroupMax = (\d+)", src).group(1))
    list_len = int(re.search(r"kListLen = (\d+)", src).group(1))
    return lens, cols, gmax, list_len


def _lane_lists(cols, list_len):
    """The lanes-per-state layout's column lists (trellis_wide): lane t
    takes target t's group, target 4's first list_len columns, lane 9
    the rest of target 4's; each padded with its own last column."""
    lists = []
    for lane in range(10):
        t, off = (4, list_len) if lane == 9 else (lane, 0)
        real = cols[t][off:off + list_len]
        lists.append(real + [real[-1]] * (list_len - len(real)))
    return lists


def test_trellis_layouts_take_the_twins_first_minimum():
    """Both layouts of csrc/trellis.cu pick, for every target, the
    column the twin's argmin over GROUP_IDX picks (first minimum in
    column order, then the dummy column 45): the lanes-per-state lists
    with target 4's two halves joined by a strict <, and the thread-per-
    block code of the winner's place in its group (its length for the
    dummy), on candidates with ties, BIG and costs past BIG."""
    lens, cols, gmax, list_len = _groups_of_kernel()
    real = [[int(c) for c in row if c < 45] for row in GROUP_IDX]
    assert cols == real and lens == [len(r) for r in real]
    assert gmax == GROUP_IDX.shape[1] and max(lens) == gmax
    assert max(n for t, n in enumerate(lens) if t != 4) <= list_len
    assert lens[4] <= 2 * list_len
    rng = np.random.default_rng(8)
    big = np.float32(BIG)
    vals = np.array([0.5, 1.0, 2.0, big, np.float32(1.5e30)], np.float32)
    cand = rng.choice(vals, size=(4000, 46)).astype(np.float32)
    cand[:, 45] = big
    want = np.argmin(cand[:, GROUP_IDX], axis=2)      # (B, 9) places
    want_col = np.take_along_axis(
        np.broadcast_to(GROUP_IDX, (4000, 9, gmax)), want[..., None],
        2)[..., 0]
    lists = _lane_lists(cols, list_len)
    for t in range(9):
        # lanes per state
        def first_min(lst):
            v = cand[:, lst]
            k = np.argmin(v, axis=1)
            return v[np.arange(len(v)), k], np.asarray(lst)[k]
        best, pick = first_min(lists[t])
        if t == 4:
            b9, p9 = first_min(lists[9])
            take = b9 < best
            best, pick = np.where(take, b9, best), np.where(take, p9, pick)
        else:
            dummy = big < best
            best, pick = np.where(dummy, big, best), np.where(dummy, 45, pick)
        assert np.array_equal(pick, want_col[:, t]), t
        # thread per block: the place in the group, the dummy as its length
        v = cand[:, cols[t]]
        place = np.argmin(v, axis=1)
        if lens[t] < gmax:
            place = np.where(big < v.min(1), lens[t], place)
        assert np.array_equal(place, want[:, t]), t


def test_trellis_finite_moves_keep_the_column_order():
    """kCand of csrc/trellis.cu (the thread-per-block layout's moves into
    each state: kind << 4 | source, kind 0 level 0, 1 move 2, 2 move 1
    or 3, 3 move 4) holds, for every class of a1 (0, 1, 2, >= 3), exactly
    the columns of GROUP_IDX that the class allows, in their order."""
    src = _source("trellis.cu")
    lens = [int(x) for x in re.search(
        r"kCandLen\[9\] = \{([^}]*)\}", src).group(1).split(",")]
    body = re.search(r"kCand\[9\]\[kCandMax\] = \{(.*?)\n\s*\};", src,
                     re.S).group(1)
    cands = [[int(x) for x in r.split(",") if x.strip()]
             for r in re.findall(r"\{([^{}]*)\}", body)]
    assert [len(c) for c in cands] == lens and len(cands) == 9
    eq1 = [int(x) for x in TRANS_EQ1] + [int(TRANS_EQ1[0])]
    gt1 = [int(x) for x in TRANS_GT1] + [int(TRANS_GT1[0])]
    for t, lst in enumerate(cands):
        assert lst[0] == t                    # level 0 from itself first
        for e in lst[1:]:
            kind, s = e >> 4, e & 15
            assert (gt1 if kind in (1, 3) else eq1)[s] == t, (t, e)
    # the column of each kind per class of a1; kind 2 is move 1 when
    # a1 == 1 and move 3 when a1 == 2 (a2 == 1)
    classes = {0: {0: 0}, 1: {0: 0, 2: 9}, 2: {0: 0, 1: 18, 2: 27},
               3: {0: 0, 1: 18, 3: 36}}
    for a1, col in classes.items():
        allowed = {c for k, base in col.items() for c in range(base, base + 9)}
        for t, lst in enumerate(cands):
            mine = [col[e >> 4] + (e & 15) for e in lst if e >> 4 in col]
            real = [int(c) for c in GROUP_IDX[t] if c in allowed]
            assert mine == real, (a1, t)


def test_trellis_bound_counts_the_finite_moves():
    """kernels/trellis.FLOPS_PER_STEP, the bound's operations a step,
    counts the moves the thread-per-block layout computes (kCand, 4 kinds
    per source state: 36) and one comparison for each move after a
    target's first (27), beside 17 per block and 18 per state."""
    from x264_tpu_torch.kernels.trellis import FLOPS_PER_STEP
    lens = [int(x) for x in re.search(
        r"kCandLen\[9\] = \{([^}]*)\}", _source("trellis.cu")).group(1)
        .split(",")]
    assert sum(lens) == 4 * 9
    assert FLOPS_PER_STEP == 17 + 18 * 9 + sum(lens) - 9 == 206


def test_kernel_resources_reads_shared_memory_and_stack():
    """kernels/build.kernel_resources: registers, spills, the
    static shared memory and the stack frame of each kernel, as
    chip_smoke.py prints them."""
    log = """ptxas info    : Compiling entry function '_Z4tallPKi' for 'sm_90a'
ptxas info    : Function properties for _Z4tallPKi
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 95 registers, used 1 barriers, 40 bytes cumulative stack size, 22140 bytes smem
ptxas info    : Compiling entry function '_Z4widePKi' for 'sm_90a'
ptxas info    : Function properties for _Z4widePKi
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 368 bytes cmem[0]
"""
    got = build.kernel_resources(log)
    assert got == {"_Z4tallPKi": (95, 0, 0, 22140, 40),
                   "_Z4widePKi": (40, 8, 4, 0, 0)}
    assert got["_Z4tallPKi"].smem == 22140 and got["_Z4tallPKi"].stack == 40


# ---- csrc/pir_column.cu run on the CPU ----
# The kernel is one CUDA block of MB warps that meet at __syncthreads()
# once a wavefront step; inside an MB a warp's lanes meet at shuffles and
# ballots.  Its source compiles as C++ when each CUDA thread is an OS
# thread, the block's barrier a std::barrier, each warp's shuffles a
# barrier of its 32 threads around an exchange array, and the device
# primitives (dynamic shared memory, cp.async and its wait) plain memory
# (the CUDA_SHIM branch of the source); so its arithmetic and its step
# order are checked here against the plain twin (the card checks the real
# build: tests/test_torch_kernels_cuda.py).

_CUDA_SHIM = r"""
#pragma once
#include <barrier>
#include <cstdint>
#include <cstring>
#define CUDA_SHIM 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline unsigned __dp4a(unsigned a, unsigned b, unsigned c) {
  for (int i = 0; i < 4; ++i) c += ((a >> 8 * i) & 255) * ((b >> 8 * i) & 255);
  return c;
}
struct Dim3Emu { int x; };
extern thread_local Dim3Emu threadIdx;
extern Dim3Emu blockDim;
// the CTAs of a grid run one after another, in blockIdx order
extern Dim3Emu blockIdx, gridDim;
template <class T> inline T __ldg(const T* p) { return *p; }
template <class T> inline T __ldcg(const T* p) { return *p; }
template <class T> inline void __stcs(T* p, T v) { *p = v; }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
// per warp: a barrier of its 32 threads and the lanes' exchange words
struct WarpEmu { std::barrier<>* bar; int word[32]; };
extern std::barrier<>* g_bar;
extern WarpEmu* g_warps;
extern unsigned char* g_smem;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline WarpEmu& warp_emu() { return g_warps[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  warp_emu().bar->arrive_and_wait();
}
// all 32 lanes call each shuffle and ballot, as the kernel does
inline int __shfl_sync(unsigned, int v, int src, int width = 32) {
  WarpEmu& w = warp_emu();
  const int lane = threadIdx.x & 31;
  w.word[lane] = v;
  w.bar->arrive_and_wait();
  const int got = w.word[(lane & ~(width - 1)) | (src & (width - 1))];
  w.bar->arrive_and_wait();
  return got;
}
inline int __shfl_xor_sync(unsigned m, int v, int x, int width = 32) {
  return __shfl_sync(m, v, (threadIdx.x & 31) ^ x, width);
}
inline int __shfl_up_sync(unsigned m, int v, int d, int width = 32) {
  const int lane = threadIdx.x & 31;
  const int got = __shfl_sync(m, v, lane - d < 0 ? lane : lane - d, width);
  return (lane & (width - 1)) >= d ? got : v;
}
inline unsigned __ballot_sync(unsigned, int p) {
  WarpEmu& w = warp_emu();
  w.word[threadIdx.x & 31] = p != 0;
  w.bar->arrive_and_wait();
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= (unsigned)w.word[i] << i;
  w.bar->arrive_and_wait();
  return b;
}
inline unsigned char* smem_base() { return g_smem; }
inline void copy_async(void* dst, const void* src, int bytes) {
  std::memcpy(dst, src, bytes);
}
inline void copy_async_commit() {}
inline void copy_async_wait() {}
"""

_PIR_THREADS = r"""
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>
thread_local Dim3Emu threadIdx;
Dim3Emu blockDim, blockIdx;
std::barrier<>* g_bar;
WarpEmu* g_warps;
unsigned char* g_smem;
// groups: the block's MB warps, 0 for the launcher's (mb_warps)
extern "C" int pir_column_threads(void** p, const void* tab, int pir_col,
                                  int ncols, int mbw, int mbh, int groups) {
  const int ncl = imin(ncols, mbw - pir_col);
  if (groups <= 0) groups = mb_warps(ncl, mbh);
  Fields f{(int*)p[8],  (int*)p[9],  (int*)p[10], (int*)p[11], (int*)p[12],
           (int*)p[13], (int*)p[14], (int*)p[15], (int*)p[16], (int*)p[17],
           (int*)p[18], (int*)p[19], (bool*)p[20], (bool*)p[21]};
  const int nt = 32 * groups;
  blockDim.x = nt;
  const size_t bytes = (smem_bytes(groups, ncl, mbh) + 15) / 16 * 16;
  g_smem = (unsigned char*)std::aligned_alloc(16, bytes);
  std::barrier<> bar(nt);
  g_bar = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<WarpEmu> warps(groups);
  for (int g = 0; g < groups; ++g) {
    warp_bars.emplace_back(new std::barrier<>(32));
    warps[g].bar = warp_bars.back().get();
  }
  g_warps = warps.data();
  std::vector<std::thread> th;
  for (int i = 0; i < nt; ++i)
    th.emplace_back([&, i] {
      threadIdx.x = i;
      pir_column_kernel(
          (const uint8_t*)p[0], (const uint8_t*)p[1], (const uint8_t*)p[2],
          (int*)p[3], (int*)p[4], (int*)p[5], (const int*)p[6],
          (const int*)p[7], f, (const int*)tab, pir_col, ncols, mbw, mbh);
    });
  for (auto& t : th) t.join();
  std::free(g_smem);
  return groups;
}
"""


@pytest.fixture(scope="module")
def pir_threads(tmp_path_factory):
    """csrc/pir_column.cu's kernel built with g++, a thread per CUDA
    thread."""
    import ctypes
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("pir_column")
    (d / "cuda_runtime.h").write_text(_CUDA_SHIM)
    src = _source("pir_column.cu")
    (d / "pir.cpp").write_text(src[:src.index('extern "C"')] + _PIR_THREADS)
    so = d / "libpir.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", f"-I{d}", str(d / "pir.cpp"), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.pir_column_threads.argtypes = [ctypes.c_void_p] * 2 + \
        [ctypes.c_int] * 5
    return lib


@pytest.mark.parametrize("seed", range(4))
def test_pir_column_source_runs_as_its_twin(pir_threads, seed):
    """Random frames of 1-6 x 1-4 MBs, QPs 0-51 per MB, bars of 1-3
    columns anywhere (masked columns past the edge included), flat and
    noisy content, then a bar of 5 or 14 columns on a frame wider than
    tall (its diagonals hold up to mbh MBs): the kernel's planes and
    fields equal the twin's, with the launcher's MB warps and with one
    warp (every diagonal's MBs in rounds)."""
    import ctypes
    from x264_tpu_torch.kernels import pir_column as KR
    from x264_tpu_torch.state import CHROMA_QP_TABLE
    rng = np.random.default_rng(40 + seed)
    for trial in range(5):
        if trial < 4:
            mbw, mbh = int(rng.integers(1, 7)), int(rng.integers(1, 5))
        else:
            mbw, mbh = int(rng.integers(14, 18)), int(rng.integers(2, 5))
        n, h, w = mbw * mbh, 16 * mbh, 16 * mbw
        if trial % 2:
            yy, xx = np.mgrid[0:h, 0:w]
            y = (128 + 60 * np.sin(xx / 7 + yy / 9)).astype(np.uint8)
            u = (128 + 30 * np.cos(xx[::2, ::2] / 5)).astype(np.uint8)
            v = np.full((h // 2, w // 2), 100, np.uint8)
        else:
            y = rng.integers(0, 256, (h, w)).astype(np.uint8)
            u, v = (rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8)
                    for _ in range(2))
        rec = [rng.integers(0, 256, s).astype(np.int32)
               for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
        qp = rng.integers(0, 52, n).astype(np.int32)
        qpc = CHROMA_QP_TABLE[np.clip(qp + int(rng.integers(-4, 5)), 0, 51)
                              ].astype(np.int32)
        acc = {k: (rng.integers(0, 2, (n, *s)).astype(bool)
                   if k in ("intra_mask", "t8")
                   else rng.integers(-5, 5, (n, *s)).astype(np.int32))
               for k, s in KR._FIELDS}
        if trial < 4:
            col, ncols = int(rng.integers(0, mbw)), int(rng.integers(1, 4))
        else:
            ncols = (5, 14)[seed % 2]
            col = int(rng.integers(0, mbw - 3))  # past the edge at times

        def run(fn):
            t = [torch.from_numpy(a.copy()) for a in (y, u, v, *rec, qp,
                                                      qpc)]
            f = {k: torch.from_numpy(a.copy()) for k, a in acc.items()}
            return fn(t, f)

        twin = run(lambda t, f: KR.pir_column_pass_plain(
            *t[:6], f, t[6], t[7], col, mbw, mbh, ncols))

        for groups in (0, 1):
            def threads(t, f):
                ptrs = [x.data_ptr() for x in t] + [f[k].data_ptr()
                                                   for k in KR.FIELDS]
                pir_threads.pir_column_threads(
                    (ctypes.c_void_p * len(ptrs))(*ptrs),
                    KR._tables("cpu").data_ptr(), col, ncols, mbw, mbh,
                    groups)
                return (*t[3:6], f)
            got = run(threads)
            for name, a, b in zip(("ry", "ru", "rv"), got[:3], twin[:3]):
                assert torch.equal(a, b), (trial, groups, name)
            for k in KR.FIELDS:
                assert torch.equal(got[3][k], twin[3][k]), (trial, groups, k)


# ---- csrc/cavlc_blocks.cu and csrc/bitpack.cu run on the CPU ----
# The same shim, with a grid of CTAs run one after another in blockIdx
# order (the kernels' CTAs never wait on one another, so any order
# would do), each CTA's shared memory filled with garbage first (so a
# word the kernel forgets to zero shows).  Both sources are held to their
# plain twins at tolerance 0.

_GRID_THREADS = r"""
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>
thread_local Dim3Emu threadIdx;
Dim3Emu blockDim, blockIdx, gridDim;
std::barrier<>* g_bar;
WarpEmu* g_warps;
unsigned char* g_smem;
static void run_grid(int grid, int nt, size_t smem,
                     const std::function<void()>& body) {
  const size_t bytes = (smem + 15) / 16 * 16 + 16;
  blockDim.x = nt;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    g_smem = (unsigned char*)std::aligned_alloc(16, bytes);
    std::memset(g_smem, 0xA5, bytes);
    std::barrier<> bar(nt);
    g_bar = &bar;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    std::vector<WarpEmu> warps(nt / 32);
    for (auto& w : warps) {
      warp_bars.emplace_back(new std::barrier<>(32));
      w.bar = warp_bars.back().get();
    }
    g_warps = warps.data();
    std::vector<std::thread> th;
    for (int i = 0; i < nt; ++i)
      th.emplace_back([&, i] {
        threadIdx.x = i;
        body();
      });
    for (auto& t : th) t.join();
    std::free(g_smem);
  }
}
"""

_CAVLC_THREADS = _GRID_THREADS + r"""
extern "C" void cavlc_threads(void** p, const void* tab, void* vals,
                              void* lens, int mbw, int mbh) {
  Fields f{(const int*)p[0], (const int*)p[1], (const int*)p[2],
           (const int*)p[3], (const int*)p[4], (const int*)p[5],
           (const int*)p[6], (const int*)p[7], (const uint8_t*)p[8]};
  const int n = mbw * mbh;
  run_grid((n + kMbsPerCta - 1) / kMbsPerCta, kThreads, kSmemBytes, [&] {
    cavlc_mb_kernel(f, (const int*)tab, (int*)vals, (int*)lens, mbw, n);
  });
}
"""

_BITPACK_THREADS = _GRID_THREADS + r"""
extern "C" void bitpack_threads(void** p, int h, int r, int nf, int n_words,
                                int n) {
  Grid g{(const int*)p[0], (const int*)p[1], h, (const int*)p[2],
         (const int*)p[3], r};
  Fields fl{{(const int*)p[4], (const int*)p[5], (const int*)p[6],
             (const int*)p[7]}, nf};
  run_grid((n + kMbs - 1) / kMbs, kThreads, smem_bytes(h, r, n_words),
           [&] { bitpack_kernel(g, fl, (int*)p[8], n_words, n); });
}

extern "C" int sum_mbs() { return kSumMbs; }

// the placement's two launches, with zero_ctas CTAs zeroing the payload
extern "C" void bitplace_threads(const void* blob, int stride, int n_words,
                                 int n, void* sums, void* payload,
                                 long long pay_words, int zero_ctas) {
  const int blocks = (n + kSumMbs - 1) / kSumMbs;
  run_grid(blocks + zero_ctas, kSumMbs, kSumMbs / 32 * 4, [&] {
    bitsum_kernel((const int*)blob, stride, n_words, n, (unsigned*)sums,
                  (unsigned*)payload, pay_words);
  });
  run_grid((n + kPlaceMbs - 1) / kPlaceMbs, kPlaceThreads, kPlaceMbs * 12,
           [&] {
    bitplace_kernel((const int*)blob, stride, n_words, n,
                    (const unsigned*)sums, (unsigned*)payload, pay_words);
  });
}
"""


def _build_threads(tmp_path_factory, name: str, runner: str):
    """csrc/<name>.cu's kernel built with g++ and ``runner`` (a thread
    per CUDA thread, the CTAs in order)."""
    import ctypes
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(_CUDA_SHIM)
    src = _source(f"{name}.cu")
    (d / "k.cpp").write_text(src[:src.index('extern "C"')] + runner)
    so = d / f"lib{name}.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", f"-I{d}", str(d / "k.cpp"), "-o",
                        str(so)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def cavlc_threads(tmp_path_factory):
    import ctypes
    lib = _build_threads(tmp_path_factory, "cavlc_blocks", _CAVLC_THREADS)
    lib.cavlc_threads.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    return lib


@pytest.fixture(scope="module")
def bitpack_threads(tmp_path_factory):
    import ctypes
    lib = _build_threads(tmp_path_factory, "bitpack", _BITPACK_THREADS)
    lib.bitpack_threads.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5
    lib.sum_mbs.argtypes = []
    lib.bitplace_threads.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong, ctypes.c_int])
    return lib


def _levels(rng, shape, kind: str):
    """Random zigzag levels: a density per row, magnitudes all +-1,
    small, large or past both level escapes."""
    mag = {"ones": np.ones(shape, np.int64),
           "small": rng.integers(1, 4, shape),
           "large": rng.integers(1, 60, shape),
           "escape": rng.integers(1, 9000, shape)}[kind]
    dens = rng.random(shape[:-1] + (1,))
    live = rng.random(shape) < dens
    return np.where(live, rng.choice([-1, 1], shape) * mag, 0
                    ).astype(np.int32)


def _mb_fields(rng, n: int, kind: str) -> list:
    """A frame's random CAVLC fields in residual_slots' argument order:
    levels, counts 0-16, every cbp, I16 and other MBs."""
    return [_levels(rng, (n, 16), kind), _levels(rng, (n, 16, 16), kind),
            rng.integers(0, 17, (n, 16)).astype(np.int32),
            _levels(rng, (n, 2, 4), kind),
            _levels(rng, (n, 2, 4, 16), kind),
            rng.integers(0, 16, (n, 2, 4)).astype(np.int32),
            rng.integers(0, 16, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32),
            rng.random(n) < 0.5]


@pytest.mark.parametrize("kind", ["ones", "small", "large", "escape"])
def test_cavlc_blocks_source_runs_as_its_twin(cavlc_threads, kind):
    """Frames of 1-6 x 1-4 MBs (a CTA's 4 MBs split across rows, and a
    last CTA part empty), random levels with I16 and other MBs, every
    cbp_luma and cbp_chroma, counts 0-16 across MB borders: the kernel's
    vals and lens equal the twin's (block_inputs + code_blocks_plain),
    every slot."""
    import ctypes
    from x264_tpu_torch.kernels import cavlc as KC
    from x264_tpu_torch.ops import cavlc as CV
    rng = np.random.default_rng(60 + len(kind))
    for trial in range(6):
        mbw, mbh = int(rng.integers(1, 7)), int(rng.integers(1, 5))
        n = mbw * mbh
        fields = [torch.from_numpy(a) for a in _mb_fields(rng, n, kind)]
        if trial == 0:
            fields[8][:] = True                  # an all-I16 frame
        want = CV.residual_slots(*fields, mbw, mbh)
        vals = torch.full((n, KC.MB_SLOTS), -7, dtype=torch.int32)
        lens = torch.full_like(vals, -7)
        ptrs = [t.data_ptr() for t in fields]
        cavlc_threads.cavlc_threads(
            (ctypes.c_void_p * 9)(*ptrs),
            KC.tables_on("cpu")["block"].data_ptr(), vals.data_ptr(),
            lens.data_ptr(), mbw, mbh)
        assert torch.equal(vals, want[0]), (trial, mbw, mbh)
        assert torch.equal(lens, want[1]), (trial, mbw, mbh)


def _token_rows(rng, n: int, s: int, n_words: int):
    """(N, S) tokens of 1-30 bits whose values fit them, densities per MB
    from sparse to dense; then, where S allows, an all-empty row, rows of
    exactly 32 * n_words bits and one bit more, and rows of a whole
    number of words (so the next MB starts on a word boundary)."""
    lens = rng.integers(1, 31, (n, s))
    lens = np.where(rng.random((n, s)) < rng.random((n, 1)), lens, 0)

    def row(bits):
        """Tokens of 30 bits and one of the rest, at random slots."""
        k = -(-bits // 30)
        if k > s:
            return None
        r = np.zeros(s, np.int64)
        at = np.sort(rng.choice(s, k, replace=False))
        r[at] = 30
        r[at[-1]] = bits - 30 * (k - 1)
        return r

    specials = [np.zeros(s, np.int64), row(32 * n_words),
                row(32 * n_words + 1), row(32 * int(rng.integers(1, 4)))]
    for i, r in enumerate(specials):
        if r is not None and i < n:
            lens[(i * 3) % n] = r
    vals = rng.integers(0, 1 << 30, (n, s)) & ((1 << lens) - 1)
    return vals.astype(np.int32), lens.astype(np.int32)


@pytest.mark.parametrize("n_words", [1, 4, 64, 416])
def test_bitpack_source_runs_as_its_twin(bitpack_threads, n_words):
    """Frames of 1-24 MBs (the last packer's 4 MBs full or part empty);
    header grids of 0-22 slots (the residual row's 16-byte place shifts
    the header's), residual grids of 0, 8 and 972 slots, 0-4 fields; MBs
    past the word budget, at exactly 32 * n_words bits and one more,
    all-empty rows and word-aligned offsets: the packing's blob (every
    word, nbits, the fields) equals the twin's (pack_tokens_plain), and
    the placement's whole payload (which it zeroes itself, with 1 or 2
    zeroing CTAs: it starts as garbage here) equals the plain
    placement's (place_plain), its blocks' sums the sums of nbits."""
    import ctypes
    from x264_tpu_torch.kernels import bitpack as KB
    rng = np.random.default_rng(70 + n_words)
    for trial in range(8):
        mbw, mbh = int(rng.integers(1, 7)), int(rng.integers(1, 5))
        n = mbw * mbh
        h = int(rng.choice([0, 3, 9, 10, 22]))
        r = int(rng.choice([0, 8, 972]))
        if h + r == 0:
            r = 8
        nf = int(rng.integers(0, 5))
        vals, lens = _token_rows(rng, n, h + r, n_words)
        hv, hl = (torch.from_numpy(a[:, :h].copy()) for a in (vals, lens))
        rv, rl = (torch.from_numpy(a[:, h:].copy()) for a in (vals, lens))
        fields = [torch.from_numpy(rng.integers(-9, 99, n).astype(np.int32))
                  for _ in range(nf)]
        blob_p = KB.pack_blob_plain(hv, hl, rv, rl, n_words, fields)
        blob = torch.full((n, n_words + 1 + nf), -7, dtype=torch.int32)
        fp = [f.data_ptr() for f in fields] + [None] * (4 - nf)
        ptrs = [t.data_ptr() for t in (hv, hl, rv, rl)] + fp + [
            blob.data_ptr()]
        bitpack_threads.bitpack_threads((ctypes.c_void_p * 9)(*ptrs), h, r,
                                        nf, n_words, n)
        where = (trial, n, h, r, nf)
        assert torch.equal(blob, blob_p), where
        payload, sums = _place_threads(bitpack_threads, blob, n_words,
                                       1 + trial % 2)
        assert torch.equal(payload, KB.place_blob_plain(blob_p, n_words)), \
            where
        assert torch.equal(sums, _block_sums(bitpack_threads, blob_p,
                                             n_words)), where


def _place_threads(lib, blob, n_words: int, zero_ctas: int):
    """The placement's two launches on a CPU blob -> (payload, the
    blocks' sums), both started as garbage."""
    from x264_tpu_torch.kernels import bitpack as KB
    n = blob.shape[0]
    payload = torch.full((KB.payload_words(n, n_words),), -7,
                         dtype=torch.int32)
    sums = torch.full((-(-n // lib.sum_mbs()),), -7, dtype=torch.int32)
    lib.bitplace_threads(blob.data_ptr(), blob.shape[1], n_words, n,
                         sums.data_ptr(), payload.data_ptr(),
                         payload.numel(), zero_ctas)
    return payload, sums


def _block_sums(lib, blob, n_words: int):
    """The nbits of each block of the placement's MBs, summed."""
    nb = blob[:, n_words].to(torch.int64)
    k = lib.sum_mbs()
    nb = torch.nn.functional.pad(nb, (0, -len(nb) % k))
    return nb.view(-1, k).sum(1).to(torch.int32)


@pytest.mark.parametrize("n,n_words", [(1030, 2), (2600, 5)])
def test_bitplace_source_past_one_block(bitpack_threads, n, n_words):
    """Past 256 MBs the placement's first launch sums several blocks and
    each CTA of the second adds the sums of the blocks before it and the
    nbits of its own block's earlier MBs: on a blob made by the twin,
    with MBs past the budget, empty rows and word-aligned ends, the sums
    and the whole payload equal the plain placement's."""
    from x264_tpu_torch.kernels import bitpack as KB
    rng = np.random.default_rng(n)
    vals, lens = _token_rows(rng, n, 40, n_words)
    blob = KB.pack_blob_plain(*(torch.from_numpy(a.copy()) for a in (
        vals[:, :7], lens[:, :7], vals[:, 7:], lens[:, 7:])), n_words)
    payload, sums = _place_threads(bitpack_threads, blob, n_words, 2)
    assert torch.equal(sums, _block_sums(bitpack_threads, blob, n_words))
    assert torch.equal(payload, KB.place_blob_plain(blob, n_words))


def test_place_plain_is_merge_mb_strings():
    """The plain placement equals the host merge it replaces
    (bitstream/slice_assemble.merge_mb_strings) over its whole length,
    zeros after the last bit, on MBs of 0 bits to a full budget and on
    word-aligned offsets."""
    from x264_tpu_torch.bitstream.slice_assemble import merge_mb_strings
    from x264_tpu_torch.kernels import bitpack as KB
    rng = np.random.default_rng(9)
    for n_words in (1, 3, 64):
        for n in (1, 5, 37):
            vals, lens = _token_rows(rng, n, 300, n_words)
            lens[:, :] = np.where(np.cumsum(lens, 1) <= 32 * n_words, lens, 0)
            words, nbits = KB.pack_tokens_plain(torch.from_numpy(vals),
                                                torch.from_numpy(lens),
                                                n_words)
            pay = KB.place_plain(words, nbits, KB.payload_words(n, n_words))
            ref, total = merge_mb_strings(
                words.numpy().view(np.uint32), nbits.numpy())
            got = pay.numpy().view(np.uint32)
            m = min(len(ref), len(got))
            assert np.array_equal(got[:m], ref[:m]), (n_words, n)
            assert not got[m:].any() and not ref[m:].any()
            assert total == int(nbits.sum())
