#!/usr/bin/env python3
"""Where the time of a 1080p P frame goes in the PyTorch + CUDA port, on
one NVIDIA GPU: per-stage wall time and a torch.profiler breakdown.

    python3 tools/torch_profile.py [--frames N]

For P16x16 and for P8x8, an encoder on the card encodes chip_smoke.py's
1080p clip (bench.py's formula): the IDR and two P frames to warm up,
then N P frames with a synchronise around each stage (the frame core,
the deblock, the host finalize: CABAC coder, headers, NAL).  Then, for
each mode again (after every timed pass: the profiler slows later
launches in the same process), the same N frames under torch.profiler:
device time by kernel, kernel launches, and the device's idle share of
the profiled wall time.  Prints the card's name and power limit first.
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _timed(enc, name, times):
    """Wrap enc.<name> so that each call's synchronised wall time is
    appended to times[name]."""
    import torch
    fn = getattr(enc, name)

    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.setdefault(name, []).append(1000 * (time.perf_counter() - t0))
        return out

    setattr(enc, name, run)


def _warm_encoder(p8x8: bool, frames):
    """An encoder on the card that has encoded the IDR and two P frames."""
    from chip_smoke import H, W, _params
    from x264_tpu_torch.api import Encoder
    enc = Encoder(_params(W, H, p8x8), device="cuda")
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


def profile(p8x8: bool, frames, n: int) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    label = "P8x8" if p8x8 else "P16"
    enc2 = _warm_encoder(p8x8, frames)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[3:3 + n]:
            enc2.encode(f)
        torch.cuda.synchronize()
        pwall = 1000 * (time.perf_counter() - t0)
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
    copies = [e for e in ka if e.key in ("cudaMemcpyAsync", "cudaMemcpy")]
    print(f"{label} profiled: {pwall / n:.1f} ms wall per P frame, device "
          f"busy {dev_ms / n:.2f} ms, idle share {1 - dev_ms / pwall:.3f}, "
          f"{launches / n:.0f} kernel launches per frame "
          f"({launch_ms / n:.1f} ms of host launch time), "
          f"{sum(e.count for e in copies) / n:.0f} memcpy calls per frame "
          f"({sum(e.self_cpu_time_total for e in copies) / 1000 / n:.1f} ms "
          "of host time, waits for the stream included)")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1000 / n:8.3f} ms "
              f"{e.count / n:7.1f}x  {e.key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()
    from chip_smoke import make_clip
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from x264_tpu_torch.api import Frame420
    frames = [Frame420(*f) for f in make_clip(3 + args.frames)]
    for p8x8 in (False, True):
        stages(p8x8, frames, args.frames)
    for p8x8 in (False, True):
        profile(p8x8, frames, args.frames)
    return 0


if __name__ == "__main__":
    sys.exit(main())
