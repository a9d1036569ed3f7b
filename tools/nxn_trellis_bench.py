#!/usr/bin/env python3
"""Times the NxN candidate kernel (csrc/intra_nxn.cu) and the trellis
kernel (csrc/trellis.cu) on one NVIDIA GPU at the shapes of a 1080p IDR
and P frame, so that two trees can be compared in one call:

    python3 tools/nxn_trellis_bench.py [--tree DIR] [--reps N] [--profile]

--tree: the repository whose x264_tpu_torch is timed (default: the one
this file is in); its kernels are built there.  The inputs, bounds and
timers are this repository's chip_smoke.py's.  Prints the card's name,
power limit and maximum SM clock, then:
- intra_nxn at 1080p (the first frame of the clip as source and recon, a
  DC mode grid, CQP 26): a CUDA graph of its 254 knight-step launches, ms
  per replay, with t8_mode on and off; and one MB's chain (step 0 alone,
  254 launches in a graph), us per launch;
- trellis at the I4x4 IDR's step shapes (chip_smoke._trellis_idr_inputs:
  nc 15, I16 AC 16 x count blocks and chroma AC 8 x count, count 1, 30
  and 60) and at a 1080p P frame's three shapes
  (chip_smoke._trellis_p_shapes) and at block counts from 32 to the
  shape's own, each a CUDA graph of 254 launches, us per launch, in the
  launcher's layout and each forced one (where the tree has layouts),
  with the bound (chip_smoke._trellis_bound_ms);
- per trellis kernel of the build, the SASS instructions of its longest
  loop (the Viterbi step; cuobjdump), and for the thread-per-block layout
  at each P shape the issue floor: the warps' steps times that count at
  one warp instruction per scheduler per clock (4 per SM) at the maximum
  SM clock;
- --profile: the I4x4/I8x8 core's graph (chip_smoke.py's IDR key) under
  torch.profiler over three replays: device time and launches per
  replay of the trellis and intra_nxn kernels."""

import argparse
import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


def nxn(frame, reps: int) -> None:
    import torch
    from x264_tpu_torch.kernels import intra_nxn as KN
    from x264_tpu_torch.state import sad_lambda
    dev = torch.device("cuda")
    mbw, mbh = (CS.W + 15) // 16, (CS.H + 15) // 16
    steps = mbw + 2 * mbh - 2
    ysrc = torch.from_numpy(CS._pad_to_mb(frame, 16).astype("int32")).to(dev)
    ry = ysrc.clone()
    grid = torch.full((4 * mbh, 4 * mbw), 2, dtype=torch.int32, device=dev)
    qp = torch.full((mbw * mbh,), CS.QP, dtype=torch.int32, device=dev)
    lam = torch.tensor([sad_lambda(CS.QP)], dtype=torch.int32, device=dev)
    for t8 in (True, False):
        def call(d):
            KN.nxn_candidates(ry, grid, ysrc, qp, lam, d, mbw, mbh, t8)

        ms = CS._graph_ms(lambda: [call(d) for d in range(steps)], reps)
        us = 1e3 * CS._graph_ms(lambda: [call(0) for _ in range(steps)],
                                reps) / steps
        print(f"intra_nxn t8_mode={int(t8)}: {ms:.4f} ms per 1080p IDR "
              f"(a graph of {steps} launches, {1e3 * ms / steps:.2f} us per "
              f"step); one MB's chain {us:.2f} us per launch")


def step_loops(so: str) -> dict:
    """{trellis kernel: SASS instructions in its longest loop}, the loop
    being the span from a backward branch's target to the branch."""
    from x264_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    out, fn, addrs, loops = {}, None, [], []

    def close():
        if fn:
            out[fn] = max((sum(a0 <= a <= a1 for a in addrs)
                           for a0, a1 in loops), default=0)

    for line in text.splitlines():
        m = re.search(r"Function : \S*(trellis_(?:tall|wide)ILi(\d+)E)", line)
        if m or "Function :" in line:
            close()
            fn = f"{m.group(1)[:12]}<{m.group(2)}>" if m else None
            addrs, loops = [], []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if fn and m:
            a = int(m.group(1), 16)
            addrs.append(a)
            b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", m.group(2))
            if b and int(b.group(1), 16) <= a:
                loops.append((int(b.group(1), 16), a))
    close()
    return out


def trellis(clip, reps: int, sm_clock_mhz: float) -> None:
    import torch
    from x264_tpu_torch.kernels import build, trellis as KT
    dev = torch.device("cuda")
    steps = 254
    calls = CS._trellis_calls()
    cac, dq, lam2f_i, tbl16, tblc = CS._trellis_idr_inputs(clip)
    lam2f_p, p_shapes = CS._trellis_p_shapes(clip)
    shapes = []
    for count in (1, 30, 60):
        for name, k, tbl in (("I16 AC", 16, tbl16), ("chroma AC", 8, tblc)):
            shapes.append((f"IDR {name} x {count}", cac[:k * count],
                           dq[:k * count], lam2f_i, tbl, 15))
    for name, c, d, tbl, nc in p_shapes:
        b = c.shape[0]
        for n in sorted({32, 128, 512, 2048, 4096, 8192, 16384, b // 8,
                         b // 4, b // 2, b}):
            shapes.append((f"P {name} x {n}", c[:n], d[:n], lam2f_p, tbl,
                           nc))
    for name, c, d, lam2f, tbl, nc in shapes:
        params = KT.params_block(tbl, lam2f, nc, dev)
        row = []
        for lay, fn in calls.items():
            us = 1e3 * CS._graph_ms(lambda: [fn(c, d, lam2f, params, nc)
                                             for _ in range(steps)],
                                    reps) / steps
            row.append(f"{lay} {us:.2f} us")
        bound = 1e3 * max(CS._trellis_bound_ms(c.shape[0], nc))
        print(f"trellis {name}: {c.shape[0]} blocks x {nc}, "
              + ", ".join(row) + f" per launch (a graph of {steps}); "
              f"bound {bound:.3f} us")
    loops = step_loops(build.build_info["path"])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for fn, count in sorted(loops.items()):
        print(f"SASS {fn}: {count} instructions in its step loop")
    for name, c, _, _, nc in p_shapes:
        key = f"trellis_tall<{nc}>"
        if key not in loops:
            continue
        threads = 32 if nc == 64 else 128     # Tall<NC>::kThreads
        warps = -(-c.shape[0] // threads) * threads // 32
        floor_us = warps * nc * loops[key] / (4 * n_sm * sm_clock_mhz)
        print(f"trellis P {name}, thread per block: {warps} warps x {nc} "
              f"steps x {loops[key]} instructions at 4 per SM per clock, "
              f"{sm_clock_mhz:.0f} MHz: issue floor {floor_us:.2f} us")


def profile_idr(clip) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from x264_tpu_torch.models.graph import graph_for, run_core
    from x264_tpu_torch.models.intra import i4_frame_core
    from x264_tpu_torch.ops.trellis import frame_trellis
    from x264_tpu_torch.state import me_lambda, sad_lambda
    dev = torch.device("cuda")
    mbw, mbh = (CS.W + 15) // 16, (CS.H + 15) // 16
    planes = [torch.from_numpy(CS._pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    qp = torch.full((mbw * mbh,), CS.QP, dtype=torch.int32, device=dev)
    lam = sad_lambda(CS.QP)
    tt = frame_trellis(CS.QP, "I", me_lambda(CS.QP), True)
    kw = dict(mbw=mbw, mbh=mbh, cqp_off=0, lv_cap=96, t8_mode=True)
    graph_for(i4_frame_core, planes, qp, lam, tt, **kw)
    run_core(i4_frame_core, *planes, qp, lam, trellis_tbl=tt, **kw)
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run_core(i4_frame_core, *planes, qp, lam, trellis_tbl=tt, **kw)
        torch.cuda.synchronize()
    for key in ("trellis", "intra_nxn"):
        rows = [e for e in prof.key_averages() if key in e.key
                and e.self_device_time_total > 0]
        us = sum(e.self_device_time_total for e in rows) / reps
        count = sum(e.count for e in rows) / reps
        print(f"I4x4 IDR graph replay, {key} kernels: {us / 1e3:.4f} ms of "
              f"device time in {count:g} launches per replay "
              f"({us / max(count, 1):.2f} us each)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("nxn_trellis_bench: no CUDA device", file=sys.stderr)
        return 1
    print(CS._smi("name,power.limit"))
    clock = float(CS._smi("clocks.max.sm").split()[0])
    print(f"tree {os.path.abspath(args.tree)}, max SM clock {clock:.0f} MHz")
    clip = CS.make_clip(2)
    nxn(clip[0][0], args.reps)
    trellis(clip, args.reps, clock)
    if args.profile:
        profile_idr(clip)
    return 0


if __name__ == "__main__":
    sys.exit(main())
