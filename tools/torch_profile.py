#!/usr/bin/env python3
"""Where the time of a 1080p P frame, a 1080p B pair and a 1080p IDR
goes in the PyTorch + CUDA port, on one NVIDIA GPU: per-stage wall time
and a torch.profiler breakdown.

    python3 tools/torch_profile.py [--frames N] [--pairs M]
        [--modes p16,p8x8,bpair,idr16,idr4] [--tools]

For P16x16 and for P8x8, an encoder on the card encodes chip_smoke.py's
1080p clip (bench.py's formula): the IDR and two P frames to warm up,
then N P frames with a synchronise around each stage (the frame core,
the deblock, the host finalize: CABAC coder, headers, NAL).  For the B
pair (bench.py's GOP: bframes=2, P8x8 anchors, full_recon off), an
encoder encodes the IDR and two mini-GOPs to warm up, then submits and
finalizes the last mini-GOP's B pair M times again, with a synchronise
around each stage (``_submit_b_pair``: both B cores; ``_finalize_b``;
the CABAC coder inside it).  For the IDR (idr16: the I16 core; idr4:
the I4x4/I8x8 core), an encoder with keyint 1 encodes one IDR (its core's
CUDA graph is captured there), then N more with a synchronise around
each stage (``_run_core``: the graph replay; ``_deblock_device``;
``_finalize_cabac``).  Then, for each mode again (after every
timed pass: the profiler slows later launches in the same process), the
same work under torch.profiler: device time by kernel, kernel launches
(split by kernel), and the device's idle share of the profiled wall
time; graph launches are counted apart from kernel launches, and
host-to-device copies by API (``cudaMemcpyAsync``, ``cudaMemcpy``,
``cudaMemcpyWithStream``).  --tools turns on the 8x8 transform and
trellis (bench.py's) in every mode.  Prints the card's name and power
limit first.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
TOOLS = {}          # extra encoder params of every mode (--tools)


def _timed(obj, name, times):
    """Wrap obj.<name> (an encoder's method or a module's function) so
    that each call's synchronised wall time is appended to times[name];
    returns the unwrapped function."""
    import torch
    fn = getattr(obj, name)

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(1000 * (time.perf_counter() - t0))
        return out

    setattr(obj, name, run)
    return fn


def _warm_encoder(p8x8: bool, frames):
    """An encoder on the card that has encoded the IDR and two P frames."""
    from chip_smoke import H, W, _params
    from x264_tpu_torch.api import Encoder
    enc = Encoder(_params(W, H, p8x8, **TOOLS), device="cuda")
    for f in frames[:3]:
        enc.encode(f)
    return enc


def stages(p8x8: bool, frames, n: int) -> None:
    import torch
    label = "P8x8" if p8x8 else "P16"
    enc = _warm_encoder(p8x8, frames)
    times = {}
    for name in ("_run_core", "_deblock_device", "_finalize_cabac"):
        _timed(enc, name, times)
    t0 = time.perf_counter()
    for f in frames[3:3 + n]:
        enc.encode(f)
    torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0) / n
    print(f"{label}: {wall:.1f} ms per P frame; stages (ms per frame): "
          + ", ".join(f"{k} {sum(v) / n:.1f}" for k, v in times.items()))


def _profiled(work):
    """(profiler, wall ms) of work() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0)
    return prof, pwall


def profile(p8x8: bool, frames, n: int) -> None:
    label = "P8x8" if p8x8 else "P16"
    enc2 = _warm_encoder(p8x8, frames)

    def work():
        for f in frames[3:3 + n]:
            enc2.encode(f)

    prof, pwall = _profiled(work)
    _report(prof, pwall, n, f"{label} profiled", "P frame")


def _report(prof, pwall: float, n: int, label: str, unit: str,
            by_count: bool = False) -> None:
    """Device busy time, idle share, launches and memcpy calls per
    ``unit``, then the kernels by device time (and by launches)."""
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    # the kernels themselves (the operators' rows repeat their kernels'
    # device time)
    dev = [e for e in ka if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in dev) / 1000
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel",
                                                    "cuLaunchKernel"))
    launch_ms = sum(e.self_cpu_time_total for e in ka
                    if e.key in ("cudaLaunchKernel", "cuLaunchKernel")) / 1000
    graphs = sum(e.count for e in ka if e.key == "cudaGraphLaunch")
    copies = [e for e in ka if e.key in ("cudaMemcpyAsync", "cudaMemcpy",
                                         "cudaMemcpyWithStream")]
    by_api = {e.key: e.count / n for e in copies}
    print(f"{label}: {pwall / n:.1f} ms wall per {unit}, device "
          f"busy {dev_ms / n:.2f} ms, idle share {1 - dev_ms / pwall:.3f}, "
          f"{launches / n:.0f} kernel launches per {unit} "
          f"({launch_ms / n:.1f} ms of host launch time), {graphs / n:g} "
          f"graph launches, "
          f"{sum(e.count for e in copies) / n:.0f} memcpy calls per {unit} "
          f"({sum(e.self_cpu_time_total for e in copies) / 1000 / n:.1f} ms "
          f"of host time, waits for the stream included; by API {by_api}); "
          f"{sum(e.count for e in dev) / n:.0f} kernels ran on the device")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1000 / n:8.3f} ms "
              f"{e.count / n:7.1f}x  {e.key[:90]}")
    if by_count:
        print(f"  kernel launches per {unit} by kernel (the 15 most):")
        for e in sorted(dev, key=lambda e: -e.count)[:15]:
            print(f"  {e.count / n:7.1f}x {e.self_device_time_total / 1000 / n:8.3f}"
                  f" ms  {e.key[:90]}")


def _b_encoder(frames):
    """An encoder on the card with bench.py's GOP that has encoded the IDR
    and two mini-GOPs (the first finalized), and the arguments of its
    last ``_submit_b_pair`` call."""
    from chip_smoke import H, W, _params
    from x264_tpu_torch.api import Encoder
    enc = Encoder(_params(W, H, True, bframes=2, full_recon=False, **TOOLS),
                  device="cuda")
    calls = []
    submit = enc._submit_b_pair
    enc._submit_b_pair = lambda *a: calls.append(a) or submit(*a)
    for f in frames[:7]:
        enc.encode(f)
    del enc._submit_b_pair
    return enc, calls[-1]


def _one_pair(enc, args):
    for job in enc._submit_b_pair(*args):
        enc._finalize_b(job)


def b_stages(frames, n: int) -> None:
    import torch
    import x264_tpu_torch.api as api
    enc, args = _b_encoder(frames)
    times = {}
    for name in ("_submit_b_pair", "_finalize_b"):
        _timed(enc, name, times)
    cabac = _timed(api, "write_slice_cabac", times)
    try:
        t0 = time.perf_counter()
        for _ in range(n):
            _one_pair(enc, args)
        torch.cuda.synchronize()
    finally:
        api.write_slice_cabac = cabac
    wall = 1000 * (time.perf_counter() - t0) / n
    print(f"B pair: {wall:.1f} ms per pair (submit and both finalizes); "
          "stages (ms per pair): "
          + ", ".join(f"{k} {sum(v) / n:.1f}" for k, v in times.items()))


def b_profile(frames, n: int) -> None:
    import x264_tpu_torch
    enc, args = _b_encoder(frames)
    x264_tpu_torch.reset_launch_counts()

    def work():
        for _ in range(n):
            _one_pair(enc, args)

    prof, pwall = _profiled(work)
    print(f"B pair hand-kernel launches per pair: "
          f"{ {k: v / n for k, v in x264_tpu_torch.launch_counts().items()} }")
    _report(prof, pwall, n, "B pair profiled", "B pair", by_count=True)


def _idr_encoder(i4: bool, frames):
    """An encoder on the card whose every frame is an IDR (keyint 1),
    after its first IDR (the core's CUDA graph captured)."""
    from chip_smoke import H, W, _params
    from x264_tpu_torch.api import Encoder
    enc = Encoder(_params(W, H, True, keyint_max=1, i4x4=i4, **TOOLS),
                  device="cuda")
    enc.encode(frames[0])
    return enc


def idr_stages(i4: bool, frames, n: int) -> None:
    import torch
    label = "IDR (I4x4/I8x8 core)" if i4 else "IDR (I16 core)"
    enc = _idr_encoder(i4, frames)
    times = {}
    for name in ("_run_core", "_deblock_device", "_finalize_cabac"):
        _timed(enc, name, times)
    t0 = time.perf_counter()
    for f in frames[1:1 + n]:
        enc.encode(f)
    torch.cuda.synchronize()
    wall = 1000 * (time.perf_counter() - t0) / n
    print(f"{label}: {wall:.1f} ms per IDR; stages (ms per frame): "
          + ", ".join(f"{k} {sum(v) / n:.1f}" for k, v in times.items()))


def idr_profile(i4: bool, frames, n: int) -> None:
    import x264_tpu_torch
    label = "IDR (I4x4/I8x8 core)" if i4 else "IDR (I16 core)"
    enc = _idr_encoder(i4, frames)
    x264_tpu_torch.reset_launch_counts()

    def work():
        for f in frames[1:1 + n]:
            enc.encode(f)

    prof, pwall = _profiled(work)
    print(f"{label} hand-kernel launches per IDR: "
          f"{ {k: v / n for k, v in x264_tpu_torch.launch_counts().items()} }")
    _report(prof, pwall, n, f"{label} profiled", "IDR", by_count=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--modes", default="p16,p8x8,bpair,idr16,idr4")
    ap.add_argument("--tools", action="store_true")
    args = ap.parse_args()
    modes = args.modes.split(",")
    from chip_smoke import TOOLS as bench_tools, make_clip
    if args.tools:
        TOOLS.update(bench_tools)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from x264_tpu_torch.api import Frame420
    frames = [Frame420(*f) for f in make_clip(max(3 + args.frames, 7))]
    p_modes = [m == "p8x8" for m in modes if m in ("p16", "p8x8")]
    for p8x8 in p_modes:
        stages(p8x8, frames, args.frames)
    if "bpair" in modes:
        b_stages(frames, args.pairs)
    idr_modes = [m == "idr4" for m in modes if m in ("idr16", "idr4")]
    for i4 in idr_modes:
        idr_stages(i4, frames, args.frames)
    for p8x8 in p_modes:
        profile(p8x8, frames, args.frames)
    if "bpair" in modes:
        b_profile(frames, args.pairs)
    for i4 in idr_modes:
        idr_profile(i4, frames, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
