#!/usr/bin/env python3
"""Times the refresh-bar kernel (csrc/pir_column.cu) on one NVIDIA GPU on
1080p bars of several widths, so that two trees can be compared in one
call:

    python3 tools/pir_bars.py [--tree DIR] [--reps N] [--sass]

--tree: the repository whose x264_tpu_torch is timed (default: the one
this file is in); its kernels are built there.  The inputs and timers are
this repository's chip_smoke.py's (frame 1 of its clip as the source,
frame 0 as the live recon planes, AQ mode 1's QP map).  Prints the card's
name and power limit, the kernel's registers, spills and static shared
memory where this run built the library (ptxas), then for bars of 3
columns (keyint 60), 5 (keyint 30), 14 (keyint 10) and 120 (keyint 2:
the whole frame), each from column 0: the wrapper's ms and the launch
alone (CUDA events over --reps runs after a warm-up), us per MB and per
wavefront step (mbh + ncols - 1 steps), and a digest of the planes and
fields one launch leaves on fresh inputs (equal digests: equal outputs,
so two trees' kernels can be held to each other).
--sass: the kernel's SASS instruction count and its most frequent
opcodes (cuobjdump)."""

import argparse
import collections
import hashlib
import importlib.util
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BARS = (3, 5, 14, 120)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _load_chip_smoke()


def digest(planes, acc, fields) -> str:
    h = hashlib.sha256()
    for t in (*planes, *(acc[k] for k in fields)):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sass_mix(so: str) -> collections.Counter:
    """The opcodes of the pir_column kernel's SASS (cuobjdump) and their
    counts: nearly all of the kernel is the loop body that codes an MB."""
    from x264_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    mix, on = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            on = "pir_column_kernel" in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if on and m:
            mix[m.group(1).split(".")[0]] += 1
    return mix


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("pir_bars: no CUDA device", file=sys.stderr)
        return 1
    from x264_tpu_torch.kernels import build
    from x264_tpu_torch.kernels import pir_column as KR
    print(CS._smi("name,power.limit"))
    print(f"tree {os.path.abspath(args.tree)}")
    lib = build.library()
    CS._print_resources(build.build_info["log"], ("pir_column",))
    if args.sass:
        mix = sass_mix(build.build_info["path"])
        print(f"pir_column_kernel SASS: {sum(mix.values())} instructions; "
              + ", ".join(f"{op} {n}" for op, n in mix.most_common(24)))
    clip = CS.make_clip(2)
    mbw, mbh = (CS.W + 15) // 16, (CS.H + 15) // 16
    src, rec, qp, qpc, acc = CS._pir_inputs(clip, CS._aq_map(clip[1]))
    stream = torch.cuda.current_stream().cuda_stream
    tab = KR._tables("cuda:0").data_ptr()

    def fresh():
        return [r.clone() for r in rec], {k: a.clone()
                                          for k, a in acc.items()}

    for ncols in BARS:
        r_k, a_k = fresh()
        KR.pir_column_pass(*src, *r_k, a_k, qp, qpc, 0, mbw, mbh, ncols)
        torch.cuda.synchronize()
        dig = digest(r_k, a_k, KR.FIELDS)
        ms = CS._time_ms(lambda: KR.pir_column_pass(
            *src, *r_k, a_k, qp, qpc, 0, mbw, mbh, ncols), args.reps)
        ptrs = [t.data_ptr() for t in (*src, *r_k, qp, qpc)] + \
            [a_k[k].data_ptr() for k in KR.FIELDS] + [tab]
        alone = CS._time_ms(lambda: lib.pir_column_launch(
            *ptrs, 0, ncols, mbw, mbh, stream), args.reps)
        n_mb = KR.bar_mbs(0, ncols, mbw, mbh)
        steps = mbh + min(ncols, mbw) - 1
        print(f"pir_column {ncols} columns ({n_mb} MBs, {steps} steps): "
              f"{ms:.4f} ms through the wrapper, launch alone {alone:.4f} "
              f"ms, {1e3 * alone / n_mb:.3f} us an MB, "
              f"{1e3 * alone / steps:.3f} us a step; digest {dig}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
