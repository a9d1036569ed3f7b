#!/usr/bin/env python3
"""Where the ESA kernels' time goes, on one NVIDIA GPU: times
x264_tpu_torch/csrc/esa16.cu and esa_parts.cu at 1080p (120x68 MBs) and
ranges 16 and 8, beside variants of the same sources built next to them.

    python3 tools/esa_variants.py [--parent DIR] [--sass DIR]

Variants (text edits of csrc/esa_core.cuh's Tiles: each kernel's short
and tall tile heights TY, dy candidates per thread, of which the launch
takes the tall one from r = 12 on, and the resident CTAs per SM it is built
for):
  rows4        TY 4 for both kernels at every range;
  esa16_rows6  TY 6 for esa16 at every range (esa_parts as in the sources);
  parts_rows3  TY 3 for esa_parts at every range (esa16 as in the sources);
  parts_minb1  esa_parts built for one resident CTA per SM, not two;
  parent       with --parent DIR: DIR/x264_tpu_torch/csrc's esa16.cu and
               esa_parts.cu (an earlier tree with the same entry points).
Each variant is built with kernels/build.py's nvcc flags into its own
library in the build directory; its registers and spills come from
ptxas's report, its instruction mix from cuobjdump -sass (the opcodes of
each ESA kernel, counted in the binary; with --sass DIR the whole listing
goes to DIR).  Inputs: a random reference, the source a shifted copy of
it plus noise, lambda 4.  Each variant is launched through the wrappers'
launcher (kernels/esa16.esa_launcher: the wrappers' checks, outputs
allocated once, no launch count) into the variant's library, timed with
CUDA events around 50 launches after a warm-up, in the order base,
variants, variants reversed, base, and checked bit-exact against the base;
then the SM clock, power and temperature (nvidia-smi) while the base
esa_parts runs 5000 times.  Prints the card's name and power limit first.
"""

import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_FILES = ("esa16.cu", "esa_parts.cu", "esa_core.cuh")
_TILES = re.compile(r"(struct Tiles<(\d)> \{\n  static constexpr int )"
                    r"kShort = \d+, kTall = \d+, kMinBlocks = \d+;")


def variants(csrc: str, parent: str = None) -> dict:
    base = {}
    for f in _FILES:
        with open(os.path.join(csrc, f)) as fh:
            base[f] = fh.read()
    if len(_TILES.findall(base["esa_core.cuh"])) != 2:
        raise RuntimeError("esa_core.cuh's Tiles have changed")

    def edit(**tiles):
        """tiles: units ("t1", "t9") -> (short, tall, resident CTAs)."""
        def sub(m):
            t = tiles.get(f"t{m.group(2)}")
            return m.group(0) if t is None else (
                f"{m.group(1)}kShort = {t[0]}, kTall = {t[1]}, "
                f"kMinBlocks = {t[2]};")
        return dict(base, **{"esa_core.cuh": _TILES.sub(
            sub, base["esa_core.cuh"])})

    out = {"base": base, "rows4": edit(t1=(4, 4, 1), t9=(4, 4, 2)),
           "esa16_rows6": edit(t1=(6, 6, 1)),
           "parts_rows3": edit(t9=(3, 3, 2)),
           "parts_minb1": edit(t9=(3, 4, 1))}
    if parent:
        pdir = os.path.join(parent, "x264_tpu_torch", "csrc")
        out["parent"] = {}
        for f in _FILES[:2]:
            with open(os.path.join(pdir, f)) as fh:
                out["parent"][f] = fh.read()
    return out


def build_all(srcs: dict) -> dict:
    """name -> (library, its path, ptxas's report)."""
    from x264_tpu_torch.kernels import build
    libs = {}
    for name, files in srcs.items():
        d = os.path.join(build.BUILD, f"esa_variant_{name}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, "libesa.so")
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                            "-o", so, os.path.join(d, "esa16.cu"),
                            os.path.join(d, "esa_parts.cu")],
                           capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{r.stdout}"
                               f"{r.stderr}")
        lib = ctypes.CDLL(so)
        for fn in ("esa16_launch", "esa_parts_launch"):
            getattr(lib, fn).argtypes = build.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, so, r.stdout + r.stderr)
    return libs


def sass_mix(so: str, out_dir: str = None, name: str = "") -> dict:
    """{kernel: Counter of opcodes} of the ESA kernels in a library."""
    from x264_tpu_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"esa_sass_{name}.txt"), "w") as f:
            f.write(text)
    mix, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "esa" in m.group(1) or "search" in \
                m.group(1) else None
            if fn:
                mix[fn] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9]*)", line)
        if fn and m:
            mix[fn][m.group(1)] += 1
    return mix


def inputs(dev, mbw: int, mbh: int, seed: int):
    """(src, ref_pad) uint8 on dev: a random padded reference holding the
    source shifted by 3 rows up and 5 columns right, plus noise of +-6."""
    import numpy as np
    import torch
    from x264_tpu_torch.state import PAD
    rng = np.random.default_rng(seed)
    h, w = 16 * mbh, 16 * mbw
    src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    big = rng.integers(0, 256, (h + 2 * PAD, w + 2 * PAD)).astype(np.int32)
    big[PAD - 3:PAD - 3 + h, PAD + 5:PAD + 5 + w] = src
    ref = np.clip(big + rng.integers(-6, 7, big.shape), 0, 255
                  ).astype(np.uint8)
    return torch.from_numpy(src).to(dev), torch.from_numpy(ref).to(dev)


def time_ms(fn, reps: int = 50) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier tree to time beside")
    ap.add_argument("--sass", help="directory for the SASS listings")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("esa_variants: no CUDA device", file=sys.stderr)
        return 1
    from x264_tpu_torch.kernels import esa_parts
    from x264_tpu_torch.kernels.build import kernel_resources
    from x264_tpu_torch.kernels.esa16 import OUT_SHAPES, esa_launcher
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_all(variants(os.path.join(REPO, "x264_tpu_torch", "csrc"),
                              args.parent))
    for name, (_, so, log) in libs.items():
        for fn, r in sorted(kernel_resources(log).items()):
            if "esa" in fn or "search" in fn:
                print(f"{name} {fn}: {r.registers} registers, spills "
                      f"{r.spill_stores}/{r.spill_loads} bytes")
        for fn, mix in sass_mix(so, args.sass, name).items():
            print(f"{name} {fn} SASS: {sum(mix.values())} instructions; "
                  + " ".join(f"{op} {c}" for op, c in mix.most_common(14)))
    names = list(libs)
    order = names + names[1:][::-1] + names[:1]
    dev = torch.device("cuda")
    mbw, mbh = 120, 68
    for me_range in (16, 8):
        s, r = inputs(dev, mbw, mbh, 100 * mbw + me_range)
        for label, shapes in (("esa16", OUT_SHAPES),
                              ("esa_parts", esa_parts.OUT_SHAPES)):
            times, ref = {}, None
            for name in order:
                launch, out = esa_launcher(label, shapes, s, r, 4, me_range,
                                           mbw, mbh, lib=libs[name][0])
                try:
                    launch()
                except RuntimeError as e:
                    raise RuntimeError(f"variant {name}, r = {me_range}: "
                                       f"{e}") from e
                if name == "base":
                    ref = out
                elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
                    raise AssertionError(f"{name} differs from base: "
                                         f"{label} r = {me_range}")
                times.setdefault(name, []).append(time_ms(launch))
            print(f"{label} r = {me_range} {mbw}x{mbh} MBs, ms per launch: "
                  + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v)
                              for k, v in times.items()), flush=True)
    # the SM clock while the base esa_parts kernel runs for ~0.5 s
    launch, _ = esa_launcher("esa_parts", esa_parts.OUT_SHAPES, s, r, 4, 16,
                             mbw, mbh, lib=libs["base"][0])
    for _ in range(5000):
        launch()
    print("during 5000 base esa_parts launches: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip())
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
