#!/usr/bin/env python3
"""Where the deblock kernel's time goes, on one NVIDIA GPU: times
x264_tpu_torch/csrc/deblock.cu at several frame geometries, beside
variants of the same source built next to it.

    python3 tools/deblock_variants.py

Geometries: 120x68 MBs (1080p), one MB row (120x1: no waits, the cost
of a block's own work per MB), one MB column (1x68: every MB waits on
the row above), and two halves.  Variants (text edits of the source):
  fence           an extra __threadfence() before each release store;
  early_prefetch  the next MB's loads issued before the release store;
  plainstore      a plain store instead of the release (no ordering:
                  timing only, its planes are not checked).
Each variant is built with kernels/build.py's nvcc flags into the build
directory, run on fresh copies of the card tests' mixed-strength inputs
(tests/test_torch_kernels_cuda._deblock_inputs), timed with CUDA events
around each of 20 launches after a warm-up, in the order base, variants,
variants reversed, base, and checked bit-exact against the base.
Prints the card's name and power limit first.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

_RELEASE = "  if (lane == 0) st_release(progress + row, n);"
_LATE_LOAD = """    // loaded after the release, which would otherwise wait for them
    MbIn next;
    if (mbx + 1 < mbw)
      next = load_mb(pl, bs_v, bs_h, q, mbw, mby, mbx + 1, lane, g,
                     ln.chroma);
"""
_TILE = """    store_mb_to_tile(sh, cur, lane);
"""


def variants(src: str) -> dict:
    out = {
        "fence": src.replace(_RELEASE, "  if (lane == 0) {\n    "
                             "__threadfence();\n    st_release(progress "
                             "+ row, n);\n  }"),
        "early_prefetch": src.replace(_LATE_LOAD, "").replace(
            _TILE, _TILE + _LATE_LOAD.split("\n", 1)[1]),
        "plainstore": src.replace(
            _RELEASE, "  if (lane == 0) *(volatile int*)(progress + row) "
            "= n;"),
    }
    for name, text in out.items():
        if text == src:
            raise RuntimeError(f"variant {name}: the source has changed")
    return {"base": src, **out}


def build_all(srcs: dict) -> dict:
    from x264_tpu_torch.kernels import build
    os.makedirs(build.BUILD, exist_ok=True)
    libs = {}
    for name, text in srcs.items():
        cu = os.path.join(build.BUILD, f"deblock_variant_{name}.cu")
        so = cu[:-3] + ".so"
        with open(cu, "w") as f:
            f.write(text)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                        so, cu], check=True, capture_output=True)
        lib = ctypes.CDLL(so)
        lib.deblock_launch.argtypes = build.SIGNATURES["deblock_launch"]
        lib.deblock_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def time_variant(lib, inputs, mbw: int, mbh: int, reps: int = 20):
    """Mean launch time (ms) and the planes of the first launch."""
    import torch
    from x264_tpu_torch.state import tables
    planes, bs_v, bs_h, qp, qpc = inputs
    tb = tables(planes[0].device)
    copies = [[p.clone() for p in planes] for _ in range(reps + 1)]
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in copies]
    for (e0, e1), c in zip(ev, copies):
        sync = torch.zeros(mbh + 1, dtype=torch.int32, device=c[0].device)
        e0.record()
        err = lib.deblock_launch(
            *(t.data_ptr() for t in (*c, bs_v, bs_h, qp, qpc, tb.alpha,
                                     tb.beta, tb.tc0, sync)),
            mbw, mbh, 2, -2, torch.cuda.current_stream().cuda_stream)
        e1.record()
        if err:
            raise RuntimeError(f"deblock_launch: CUDA error {err}")
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev[1:]) / reps, copies[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("deblock_variants: no CUDA device", file=sys.stderr)
        return 1
    from test_torch_kernels_cuda import _deblock_inputs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with open(os.path.join(REPO, "x264_tpu_torch", "csrc",
                           "deblock.cu")) as f:
        libs = build_all(variants(f.read()))
    names = list(libs)
    order = names + names[1:][::-1] + names[:1]
    dev = torch.device("cuda")
    for mbw, mbh in [(120, 68), (120, 1), (1, 68), (60, 68), (120, 34)]:
        inputs = _deblock_inputs(dev, mbw, mbh)
        times, ref = {}, None
        for name in order:
            ms, out = time_variant(libs[name], inputs, mbw, mbh)
            times.setdefault(name, []).append(ms)
            if name == "base":
                ref = out
            elif name != "plainstore" and not all(
                    torch.equal(a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"{name} differs from base at "
                                     f"{mbw}x{mbh}")
        print(f"{mbw}x{mbh} MBs, ms per launch: " + "; ".join(
            f"{k} " + " ".join(f"{t:.4f}" for t in v)
            for k, v in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
