#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (x264_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from x264_tpu_torch/csrc (nvcc, sm_90a,
     one process per source); then Encoder.warm() at 1080p before any
     other phase captures a graph, on bench.py's GOP (CABAC) and its
     CAVLC twin: warm()'s ms and the graphs it captured, the first IDR's
     encode() ms after it beside the steady IDR's, a noise IDR that
     overflows the first entropy rung and a mini-GOP, with the kernel
     library loaded and no graph captured after warm() returned True (or
     the run fails), a second warm() at once, and a cold encoder's bytes
     equal to the warm one's; the graphs are dropped after the phase;
  3. each kernel against its plain PyTorch twin at 1080p on the card,
     bit-exact, with both times (CUDA events over several runs after a
     warm-up) and the kernel's bound: the ESA kernels (16x16 and
     partitions, with their registers and spills from the build log) on a
     1080p frame against a shifted, noised copy at range 8 (lookahead's),
     24 (the three-reference run's) and 16 (the main path's, the one
     recorded), the partition kernel's
     16x16 unit against esa16, their bound's operation rate the lower of
     the nominal one and the one the probe esa_sad_probe measures; both
     again at the lookahead's shape (lowres 960x544 planes, 60x34 MBs,
     range 8, lambda sad_lambda(24)) with the launch alone and the
     bound, and one plan's 8 pair searches (ROADMAP B9); the
     deblock kernel (one launch for Y, Cb and Cr) on the recon planes and
     bS grids of an encoded P8x8 frame, with both terms of its bound
     (bytes, and the dependent chain timed by a probe kernel); the trellis
     kernel on the three blockings of a 1080p P frame's residual (4x4
     luma, 8x8 luma, chroma AC) and at the I4x4 IDR's step shapes (1, 30
     and 60 MBs, and one IDR's 508 launches as a graph), in both of its
     layouts, its bound the larger of its bytes and its float operations
     at the card's FP32 rate; the I4x4/I8x8 core on the first frame,
     eager against its CUDA graph (capture and replay ms), and the NxN
     candidate kernel against its twin on every knight step of that IDR,
     with t8_mode on and off, with its bound and one MB's chain; under
     AQ mode 1's QP map of a 1080p frame, the NxN kernel against its
     twin on every knight step and inside the I4 core's graph, and the
     trellis kernel on a P frame's blockings; the
     CAVLC block coder (cavlc_blocks) and bit packer (bitpack: the
     packing, then the payload's placement) on the slot grids of a 1080p
     P8x8 frame and a B frame, the packer at both word rungs, with the
     launches alone, together and apart, and the bound; the refresh-bar
     kernel (pir_column) on 3-column bars at columns 0, 59, 117 and 119
     of a 1080p frame under AQ's QP map, with the launch alone and the
     bound, and on bars of 5, 14 and 120 columns against twins that
     worker processes started at the beginning run on the host, each
     with its wavefront steps, us a step, MB warps and shared memory;
     the registers, spills and shared memory of the ESA, trellis, NxN,
     CAVLC and refresh-bar kernels (ptxas); the kernels of the
     multi-slice path at its band shapes: esa16 on a 4K band of 34 and of
     33 MB rows (3840x2160 in four slices) and on a 1080p band of 17 rows
     at range 8, deblock on a 4K frame put together from four superfast P
     bands, and the CAVLC pair on a 1080p ultrafast P band, each with its
     time, the twin's and the bound;
  4. the main paths, each with the kernels' launch counts reset just
     before and read just after: Encoder(device="cuda") encodes a 1080p
     clip of one IDR and 5 P frames (the clip formula of bench.py's
     make_clip) with P16x16 only (then the I16 core's graph: capture and
     replay ms, replay == eager core), then again with P8x8 partitions,
     the 8x8 transform and trellis, then 10 frames as bench.py's GOP (IDR
     + 3 x (B B P): bench.py's whole config, bframes=2, full_recon off,
     P8x8 anchors, I4x4, the 8x8 transform, trellis and weightp=1), then
     6 frames on three references (I/P8x8, ref_frames=3, weightp=1, the
     8x8 transform, trellis, I4x4, range 24: the slower preset without
     aq_mode), then bench.py's GOP again with CAVLC (cabac=False, so no
     trellis and no I4x4: the library's default entropy coder, every
     core's slice body coded and packed on the card), then 36 frames of
     x264's medium preset at CRF 23 with AQ, MB-tree and b_adapt=1
     (scenecut 40, a hard cut at frame 30: the lookahead's lowres
     scenecut, plans and MB-tree, with its host ms per frame and the
     ESA launches it adds), then 41 frames of the live configuration
     (medium with tune zerolatency on P16 anchors, CRF 23, VBV 4000
     kbit/s over 1500 kbit, NAL HRD, intra refresh at keyint 60 with the
     sweep started before frame 1: the VBV re-encodes and their ms, the
     decoder-buffer walk's lowest fill, encode() ms p50/p95/max, the
     launches per P frame), then BASELINE.json's fifth configuration
     through the port's CLI (cli.main on a 4K y4m written from
     make_clip's formula: superfast on 4 slices at 20000 kbit/s, --pass 1
     then --pass 2 --stats, 12 frames each: fps per pass, kbit a frame
     against the target, the recon's Y-PSNR, the I16 graph keys of the
     bands and their capture ms, the ms per band, the band re-runs,
     esa16 and deblock launches per frame), then 30 frames of ultrafast
     with tune zerolatency on 4 slices at CRF 23 through the API (fps,
     encode() ms p50/p95/max, esa16, cavlc_blocks and bitpack launches
     per P frame), then the band mesh (threads > 1,
     x264_tpu_torch/parallel/sliced.py): the step over card 0 four times
     against the band loop on 3 P frames of ultrafast on 4 slices, a
     band re-run at 416 words, ms per P frame and the synchronising CUDA
     calls in a step, and on a host of two or more cards the threads=n
     stream against the one-card stream (on one card a line says that
     part did not run); fps, bytes,
     Y-PSNR, the partition shapes chosen, the share
     of 8x8-transform MBs, the P frames with a non-neutral weight, the
     esa_parts launches of each P frame (one per active reference) and
     the share of MBs on each reference, per-frame ms by frame type and,
     where tools/avdec runs, a decode that must equal the encoder's recon
     (keyed by display index: B frames are final after their anchor);
  5. 352x288 streams encoded on the card must equal, byte for byte, the
     streams the port encodes on the CPU (the kernels' plain twins), with
     and without partitions, with B frames (one pair, one single tail B,
     full_recon on), with the 8x8 transform and trellis on P8x8 and
     on a B pair, with I4x4 on I/P8x8 (two IDRs), and on a fading clip
     with weightp=1 on several references (P16 on three, P8x8 with the
     tools on two, B frames on P8x8 anchors on two), each with a
     non-neutral weight and MBs on ref_idx > 0, with CAVLC: I/P16 at
     QP 26 and I/B/P8x8 with the 8x8 transform and weightp=1 on two
     references, and the medium preset at CRF 23 with AQ, MB-tree and
     b_adapt, and CAVLC with AQ on I/B/P8x8, and the live settings:
     intra refresh with CABAC (I4x4, the 8x8 transform, trellis) and
     with CAVLC, VBV with CAVLC (re-encodes), NAL HRD with VBV and B
     frames, and the multi-slice and fullpel settings: 4 slices (bands
     of 5, 5, 4 and 4 MB rows) with CABAC under ABR and with CAVLC,
     ultrafast with bframes=2, and a forced band re-run (noise at QP 12,
     CAVLC, 4 slices).
Every I frame's core, and every I band's, on the card is a CUDA graph
replay (x264_tpu_torch/models/graph.py).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits 1.
"""

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H, QP = 1920, 1080, 26
N_FRAMES = 6                 # per 1080p I/P run: one IDR, then P frames
B_FRAMES = 10                # the 1080p B-GOP run: IDR + 3 x (B B P)
CLIP_FRAMES = 48             # bench.py's N_FRAMES: sets the texture pad
CHECK_W, CHECK_H, CHECK_FRAMES = 352, 288, 4
CHECK_B_FRAMES = 6           # IDR, B B P, then B + P at flush
AVDEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                     "avdec")
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
FP32_FLOPS_PER_S = 67e12     # H100 SXM, published, outside the tensor cores
INT32_LANES_PER_SM = 64      # sm_90 integer add / min / sad per clock
TOOLS = dict(transform_8x8=True, trellis=1)   # bench.py's, ported in A8
MULTIREF_FRAMES = 6          # the 1080p run on three references
LA_FRAMES, LA_CUT = 36, 30   # the 1080p medium-CRF run and its scene cut


def make_clip(n: int):
    """bench.py's make_clip (same seed and formula), first n frames:
    panning detailed texture + slow luminance drift."""
    rng = np.random.default_rng(20260816)
    pad = 4 * CLIP_FRAMES
    tex = rng.integers(-24, 25, (H + pad, W + pad)).astype(np.int16)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) // 4          # soften a touch
    yy, xx = np.mgrid[0:H, 0:W]
    frames = []
    for t in range(n):
        dx, dy = 3 * t, 2 * t
        base = (128 + 60 * np.sin((xx + dx) / 41.0)
                * np.cos((yy + dy) / 59.0))
        y = np.clip(base + tex[dy:dy + H, dx:dx + W] + t, 0, 255
                    ).astype(np.uint8)
        u = (128 + 32 * np.sin((xx[::2, ::2] + dx) / 61.0)).astype(np.uint8)
        v = (128 + 32 * np.cos((yy[::2, ::2] + dy) / 59.0)).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def cut_clip(n: int, cut: int):
    """make_clip's first n frames with a hard cut: from frame ``cut`` on,
    the luma inverted and the chroma planes swapped (another scene, as
    smooth as the first, so the lowres scenecut sees it)."""
    return [f if t < cut else (255 - f[0], f[2], f[1])
            for t, f in enumerate(make_clip(n))]


def split_motion_clip(w: int, h: int, n: int):
    """Two motion fields at 8-px grain (tests/test_parts_e2e.py's content
    idea): the top half of every MB row pans right, the bottom half pans
    down, and in the right third the split is vertical instead, so 16x8,
    8x16 and 8x8 partitions win in many MBs."""
    rng = np.random.default_rng(9)
    big = rng.integers(0, 256, (3 * h, 3 * w)).astype(np.int32)
    big = (big[:-1, :-1] + big[1:, :-1] + big[:-1, 1:] + big[1:, 1:]) // 4
    frames = []
    for t in range(n):
        a = big[8:8 + h, 8 + 3 * t:8 + 3 * t + w]     # pans right
        b = big[8 + 2 * t:8 + 2 * t + h, 8:8 + w]     # pans down
        y = a.copy()
        for my in range(h // 16):
            y[16 * my + 8:16 * my + 16] = b[16 * my + 8:16 * my + 16]
        for mx in range(2 * (w // 16) // 3, w // 16):
            y[:, 16 * mx:16 * mx + 8] = a[:, 16 * mx:16 * mx + 8]
            y[:, 16 * mx + 8:16 * mx + 16] = b[:, 16 * mx + 8:16 * mx + 16]
        u = big[1:1 + h // 2, 2:2 + w // 2] // 2 + 60
        v = big[3:3 + h // 2, 5:5 + w // 2] // 2 + 70
        frames.append(tuple(p.astype(np.uint8) for p in (y, u, v)))
    return frames


def fade_clip(w: int, h: int, n: int, pan=(3, 2), flash=(2,), cut=None):
    """tests/test_weightp.py's fade (own copy of its formula, seed 9): a
    textured pan whose luma is scaled by 0.92**t and shifted by -4*t, so
    weighted prediction pays.  On the frames in ``flash`` the left half
    shows another texture (seed 11), so the next frame finds its left
    half two frames back, on ref_idx 1; from frame ``cut`` on, another
    scene (seed 10) fading the same way."""
    def tex(seed):
        rng = np.random.default_rng(seed)
        t = rng.integers(0, 160, (h * 2 + 4 * n, w * 2 + 4 * n))
        t = t.astype(np.float64)
        return (t + np.roll(t, 1, 0) + np.roll(t, 1, 1)) / 3 + 48

    a, b, other = tex(9), tex(10), tex(11)
    frames = []
    for t in range(n):
        dy, dx = pan[1] * t, pan[0] * t
        src = b if cut is not None and t >= cut else a
        y = src[dy:dy + h, dx:dx + w] * 0.92 ** t - 4 * t
        if t in flash:
            y[:, :w // 2] = other[:h, :w // 2]
        frames.append((np.clip(y, 0, 255).astype(np.uint8),
                       np.full((h // 2, w // 2), 120 + 2 * t, np.uint8),
                       np.full((h // 2, w // 2), 132 - t, np.uint8)))
    return frames


def _spy(enc, key: str = "shape") -> list:
    """Record out[key] of every I or P core run of ``enc`` that has it:
    the partition shapes or the 8x8-transform flags of the P frames."""
    found = []
    run_core = enc._run_core

    def spy(*a, **kw):
        out, st = run_core(*a, **kw)
        if key in out:
            found.append(out[key])
        return out, st

    enc._run_core = spy
    return found


def _weights_spy(enc) -> list:
    """Record the (weight, offset) list of every P frame ``enc`` submits
    (weightp's host analysis, one pair per active reference)."""
    found = []
    submit = enc._submit_device

    def spy(*a, **kw):
        job = submit(*a, **kw)
        if job["weights"] is not None:
            found.append(job["weights"])
        return job

    enc._submit_device = spy
    return found


def _weighted(weights: list) -> int:
    """How many frames carried a non-neutral weight on some reference."""
    from x264_tpu_torch.models.weightp import NEUTRAL
    return sum(any(tuple(w) != NEUTRAL for w in ws) for ws in weights)


def _time_ms(fn, reps: int) -> float:
    """Mean time of fn() on the card over reps runs after a warm-up,
    from CUDA events around the whole run."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def _params(w: int, h: int, p8x8: bool, **kw):
    """bench.py's settings the port runs (CQP 26, me_range 16, subpel 2,
    CABAC, deblock, one reference, no scenecut); I/P unless ``kw`` sets
    bframes."""
    from x264_tpu_torch.api import EncoderParams
    base = dict(width=w, height=h, qp=QP, me_range=16, subpel=2,
                cabac=True, deblock=True, bframes=0, ref_frames=1,
                keyint_max=250, scenecut_threshold=0, backend="device",
                p8x8=p8x8)
    base.update(kw)
    return EncoderParams(**base)


def _psnr(a, b) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    mse = float((d * d).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255.0 * 255.0 / mse)


def _pad_to_mb(plane, s: int):
    h, w = plane.shape
    return np.pad(plane, ((0, -h % s), (0, -w % s)), mode="edge")


def _avdec_available() -> bool:
    """tools/avdec links libavcodec, which the machine may lack."""
    try:
        r = subprocess.run([AVDEC], capture_output=True, text=True)
    except OSError as e:
        print(f"avdec unavailable ({e}); decode check skipped")
        return False
    if "usage" not in r.stderr:
        print(f"avdec unavailable ({r.stderr.strip()[:200]}); "
              "decode check skipped")
        return False
    return True


def _decode(stream: bytes, w: int, h: int) -> list:
    """Decode an Annex-B stream with tools/avdec -> [(y, u, v)] planes."""
    with tempfile.TemporaryDirectory() as td:
        inp, outp = os.path.join(td, "in.264"), os.path.join(td, "out.yuv")
        with open(inp, "wb") as f:
            f.write(stream)
        subprocess.run([AVDEC, inp, outp], check=True, capture_output=True)
        data = np.fromfile(outp, dtype=np.uint8)
    fs = w * h * 3 // 2
    return [(f[:w * h].reshape(h, w),
             f[w * h:w * h * 5 // 4].reshape(h // 2, w // 2),
             f[w * h * 5 // 4:].reshape(h // 2, w // 2))
            for f in (data[i:i + fs] for i in range(0, len(data), fs))]


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _esa_bound_ms(src, ref_pad, r: int, units: int, out_words: int,
                  int_ops_per_s: float) -> tuple:
    """Least time of an exhaustive search: per MB and candidate, 64
    vabsdiff4 (4 absolute differences each) and, per unit, a cost add and
    a running minimum, at int_ops_per_s; bytes: the source
    and padded reference planes read once, the outputs (out_words int32
    per MB) written once."""
    n_mb = src.numel() // 256
    ops = n_mb * (2 * r + 1) ** 2 * (64 + 2 * units)
    nbytes = src.numel() + ref_pad.numel() + 4 * out_words * n_mb
    t_ops, t_bytes = 1e3 * ops / int_ops_per_s, 1e3 * nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _esa_probe_rate(lib, n_sm: int) -> float:
    """vabsdiff4 per second on the whole card, from the probe
    esa_sad_probe in csrc/esa16.cu: eight independent chains per thread,
    eight 256-thread blocks per SM, no memory traffic."""
    import torch
    from x264_tpu_torch.kernels.build import check
    blocks, iters = 8 * n_sm, 4096
    out = torch.zeros(1, dtype=torch.int32, device="cuda")

    def probe():
        check(lib.esa_sad_probe_launch(
            out.data_ptr(), blocks, iters,
            torch.cuda.current_stream().cuda_stream), "esa_sad_probe")

    return blocks * 256 * iters * 8 * 16 / (1e-3 * _time_ms(probe, 5))


def _print_resources(log: str, keys: tuple) -> None:
    """Registers, spills, static shared memory and stack frame of the
    kernels whose names hold one of keys, from ptxas's report."""
    from x264_tpu_torch.kernels.build import kernel_resources
    for name, r in sorted(kernel_resources(log).items()):
        if any(k in name for k in keys):
            print(f"ptxas {name}: {r.registers} registers, spill stores "
                  f"{r.spill_stores} bytes, spill loads {r.spill_loads} "
                  f"bytes, {r.smem} bytes of shared memory, {r.stack} bytes "
                  "of stack")


def _deblock_chain_passes(mbw: int, mbh: int) -> int:
    """The longest chain of dependent edge passes in the deblock filter,
    an edge pass (4 vertical, then 4 horizontal per MB; one MB edge over
    all its lines) taken as one step.  Vertical edge 0 of MB (x, y) follows
    the last horizontal edge of MB (x-1, y); each edge follows the one
    before it in its MB; horizontal edge 0 also follows the last
    horizontal edge of MB (x, y-1) and vertical edge 0 of MB (x+1, y-1),
    which changes columns 13-15 of the lines above it.  (The knight order,
    which waits for whole MBs, takes 8 * (mbw + 2*mbh - 2) steps.)"""
    h3_above = v0_above = None
    for y in range(mbh):
        h3_row, v0_row, left = [0] * mbw, [0] * mbw, 0
        for x in range(mbw):
            v0_row[x] = left + 1
            h0 = v0_row[x] + 4
            if y:
                h0 = max(h0, h3_above[x] + 1,
                         v0_above[x + 1] + 1 if x + 1 < mbw else 0)
            h3_row[x] = left = h0 + 3
        h3_above, v0_above = h3_row, v0_row
    return h3_above[-1]


def _deblock_bound_ms(lib, planes, grids, mbw: int, mbh: int) -> tuple:
    """Least time of the deblock filter: the larger of
    - bytes: the Y, U and V planes read once and written once, both bS
      grids and both QP vectors read once, over the HBM rate;
    - chain: the _deblock_chain_passes dependent luma edge passes (the
      chroma edges ride beside them), each at the time one warp takes for
      a pass on a tile already in shared memory (the probe
      deblock_chain_probe in csrc/deblock.cu: no global memory, no other
      block), weighted by the share of this frame's (MB, pass) pairs with
      an edge of bS > 0 (a pass without one skips the filter)."""
    import torch
    from x264_tpu_torch.kernels.build import check
    from x264_tpu_torch.state import tables
    steps = mbw + 2 * mbh - 2       # the probe runs 8 passes per step
    t_bytes = 1e3 * (2 * sum(p.numel() for p in planes)
                     + sum(4 * g.numel() for g in grids)) / HBM_BYTES_PER_S
    tb = tables(planes[0].device)
    out = torch.empty(20 * 20 + 2 * 12 * 12, dtype=torch.uint8,   # tiles
                      device=planes[0].device)

    def probe(bs):
        check(lib.deblock_chain_probe_launch(
            out.data_ptr(), tb.alpha.data_ptr(), tb.beta.data_ptr(),
            tb.tc0.data_ptr(), steps, bs,
            torch.cuda.current_stream().cuda_stream), "deblock_chain_probe")

    us_filter = 1e3 * _time_ms(lambda: probe(2), 20) / (8 * steps)
    us_skip = 1e3 * _time_ms(lambda: probe(0), 20) / (8 * steps)
    bs_v, bs_h = grids[0], grids[1]
    active = (int((bs_v.reshape(mbh, 4, mbw, 4) > 0).any(1).sum())
              + int((bs_h.reshape(mbh, 4, mbw, 4) > 0).any(3).sum()))
    share = active / (8 * mbw * mbh)
    passes = _deblock_chain_passes(mbw, mbh)
    t_chain = 1e-3 * passes * (share * us_filter + (1 - share) * us_skip)
    print(f"deblock bound: bytes {t_bytes:.4f} ms; chain {passes} dependent "
          f"passes (knight order {8 * steps}) x (share {share:.4f} filtering"
          f" at {us_filter:.4f} us + the rest skipping at {us_skip:.4f} us;"
          f" probe of {8 * steps} passes) = {t_chain:.4f} ms")
    return ((t_chain, "operations") if t_chain >= t_bytes
            else (t_bytes, "bytes"))


def _deblock_kernel_only_ms(KD, ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb,
                            mbw: int, mbh: int, reps: int) -> float:
    """Mean time of the deblock kernel's launch alone, CUDA events around
    each launch on a fresh copy of the planes."""
    import torch
    copies = [[p.clone() for p in (ry, ru, rv)] for _ in range(reps + 1)]
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in copies]
    for (e0, e1), planes in zip(ev, copies):
        e0.record()
        KD.deblock_(*planes, bs_v, bs_h, qp_mb, qpc_mb, 0, 0, mbw, mbh)
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev[1:]) / reps


def _trellis_launches(n_i: int, n_p: int, n_b: int, i4: bool = False) -> int:
    """Trellis launches of a 1080p run with the 8x8 transform and
    trellis, overflow re-runs and graph warm-ups aside: two per step of
    the I wavefront (I16 AC, chroma AC; 187 diagonals of the I16 core,
    254 knight steps of the I4x4 core), five per P or B frame (4x4 luma,
    8x8 luma, chroma AC, and the intra escape's I16 AC and chroma AC,
    which the port computes on every frame)."""
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    steps = mbw + 2 * mbh - 2 if i4 else mbw + mbh - 1
    return 2 * steps * n_i + 5 * (n_p + n_b)


def _trellis_p_shapes(clip, qp_mb=None) -> tuple:
    """lam2f and the three trellis calls of a 1080p P frame at QP 26 (the
    dequantisation at the per-MB QPs qp_mb when given, the tables at 26),
    [(name, coefficients, dq, tables, nc)]: 4x4 luma (130560 blocks of
    16), 8x8 luma (32640 of 64) and chroma AC (65280 of 15).  The input
    is the luma difference of frames 1 and 0 (the clip's chroma is too
    smooth to leave a level at QP 26): its 4x4 and 8x8 coefficients, and
    for the chroma-AC shape the AC positions of the first 65280 4x4
    blocks with the chroma-AC tables."""
    import torch
    from x264_tpu_torch.ops import transform as T
    from x264_tpu_torch.ops.trellis import dq1_4x4, dq1_8x8, frame_trellis
    from x264_tpu_torch.state import me_lambda
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    n = mbw * mbh
    res = torch.from_numpy(_pad_to_mb(clip[1][0], 16).astype(np.int32)
                           - _pad_to_mb(clip[0][0], 16).astype(np.int32)
                           ).to(dev)
    luma = T.plane_to_mbs(res, mbh, mbw, 16)
    c4 = T.zigzag(T.dct4x4(T.mb_luma_to_blocks(luma))).reshape(n * 16, 16)
    c8 = T.zigzag8(T.dct8x8(T.mb_luma_to_blocks8(luma))).reshape(n * 4, 64)
    q = torch.full((n,), QP, dtype=torch.int32, device=dev) \
        if qp_mb is None else qp_mb
    tbl4, tbl8, lam2f, _, tblc = frame_trellis(QP, "P", me_lambda(QP), True)
    return lam2f, [
        ("4x4 luma", c4, dq1_4x4(q.repeat_interleave(16)), tbl4, 16),
        ("8x8 luma", c8, dq1_8x8(q.repeat_interleave(4)), tbl8, 64),
        ("chroma AC", c4[:n * 8, 1:].contiguous(),
         dq1_4x4(q.repeat_interleave(8))[:, 1:].contiguous(), tblc, 15)]


def _trellis_idr_inputs(clip) -> tuple:
    """(coefficients, dq, lam2f, I16 AC tables, chroma AC tables) for the
    I4x4 IDR's step shapes: 960 blocks of 15 (60 MBs' I16 AC), the AC
    positions of the 4x4 transforms of frame 0's luma minus each MB's
    mean, with the I-slice tables at QP 26."""
    import torch
    from x264_tpu_torch.ops import transform as T
    from x264_tpu_torch.ops.trellis import dq1_4x4, frame_trellis
    from x264_tpu_torch.state import me_lambda
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    mbs = T.plane_to_mbs(torch.from_numpy(_pad_to_mb(clip[0][0], 16).astype(
        np.int32)).to(dev), mbh, mbw, 16)
    mbs = mbs - mbs.float().mean((1, 2), keepdim=True).round().int()
    cac = T.zigzag(T.dct4x4(T.mb_luma_to_blocks(mbs[:60]))).reshape(960, 16)
    dq = dq1_4x4(torch.full((960,), QP, dtype=torch.int32, device=dev))
    _, _, lam2f, tbl16, tblc = frame_trellis(QP, "I", me_lambda(QP), True)
    return (cac[:, 1:].contiguous(), dq[:, 1:].contiguous(), lam2f, tbl16,
            tblc)


def _trellis_calls() -> dict:
    """{layout: fn(coefs, dq, lam2f, tables, nc)}: "auto", the wrapper the
    encoder calls (the launcher picks the layout), then each layout of
    kernels/trellis.LAYOUTS forced (none in a tree that has one layout,
    which tools/nxn_trellis_bench.py may time)."""
    from x264_tpu_torch.kernels import trellis as KT
    calls = {"auto": KT.trellis_quant_}
    for lay in getattr(KT, "LAYOUTS", ()):
        calls[lay] = functools.partial(KT._trellis_quant_layout, layout=lay)
    return calls


def _trellis_bound_ms(nblocks: int, nc: int) -> tuple:
    """(bytes term, operations term) of one call's bound, ms."""
    from x264_tpu_torch.kernels import trellis as KT
    nbytes, flops = KT.work(nblocks, nc)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOPS_PER_S


def _trellis_phase(clip, record) -> None:
    """The trellis kernel against its plain twin at the three shapes of
    a 1080p P frame (_trellis_p_shapes), bit-exact in the layout the
    launcher picks and in both layouts forced, each timed with its
    bound; the record sums the three, one P frame's trellis work.  Then
    the I4x4 IDR's shapes (_trellis_idr_phase)."""
    import torch
    from x264_tpu_torch.kernels import build, trellis as KT
    from x264_tpu_torch.kernels.build import check
    from x264_tpu_torch.ops.trellis import trellis_quant_plain
    dev = torch.device("cuda")
    lam2f, shapes = _trellis_p_shapes(clip)
    calls = _trellis_calls()
    tot = dict(err=0, ms=0.0, plain=0.0, t_bytes=0.0, t_ops=0.0)
    for name, c, dq, tbl, nc in shapes:
        lv_p = trellis_quant_plain(c, dq, lam2f, tbl, nc)
        err = max(_max_err(fn(c, dq, lam2f, tbl, nc), lv_p)
                  for fn in calls.values())
        nz = int((lv_p != 0).sum())
        if err or not nz:
            raise AssertionError(f"trellis {name}: max err {err}, {nz} "
                                 "nonzero levels")
        ms = _time_ms(lambda: KT.trellis_quant(c, dq, lam2f, tbl, nc), 20)
        plain = _time_ms(lambda: trellis_quant_plain(c, dq, lam2f, tbl, nc),
                         3)
        forced = {lay: _time_ms(lambda: fn(c, dq, lam2f, tbl, nc), 20)
                  for lay, fn in calls.items() if lay != "auto"}
        # a diagnostic: the launch alone, on an output allocated once
        params, out = KT.params_block(tbl, lam2f, nc, dev), torch.empty_like(c)
        stream = torch.cuda.current_stream().cuda_stream
        alone = _time_ms(lambda: check(build.library().trellis_launch(
            c.data_ptr(), dq.data_ptr(), params.data_ptr(), out.data_ptr(),
            c.shape[0], nc, stream), "trellis"), 50)
        t_bytes, t_ops = _trellis_bound_ms(c.shape[0], nc)
        print(f"trellis {name}: {c.shape[0]} blocks x {nc}, bit-exact in "
              f"every layout ({nz} nonzero levels), {ms:.4f} ms through the "
              f"wrapper, layout {_trellis_layout(c.shape[0], nc)} (its "
              f"launch alone {alone:.4f} ms; thread per block "
              f"{forced['thread']:.4f}, lanes per state "
              f"{forced['lanes']:.4f}; plain {plain:.3f} ms), bound "
              f"max(bytes {t_bytes:.4f}, operations {t_ops:.4f}) ms")
        tot["err"] = max(tot["err"], err)
        for k, v in (("ms", ms), ("plain", plain), ("t_bytes", t_bytes),
                     ("t_ops", t_ops)):
            tot[k] += v
    record("trellis", "x264_tpu_torch/csrc/trellis.cu",
           "x264_tpu/ops/device/trellis.py:244", tot["err"], tot["ms"],
           tot["plain"], (tot["t_ops"], "operations")
           if tot["t_ops"] >= tot["t_bytes"] else (tot["t_bytes"], "bytes"))
    _trellis_idr_phase(clip)


def _trellis_layout(nblocks: int, nc: int) -> str:
    """The layout the launcher picks for this call."""
    from x264_tpu_torch.kernels import build, trellis as KT
    code = build.library().trellis_auto_layout(nblocks, nc)
    return next(k for k, v in KT.LAYOUTS.items() if v == code)


def _graph_ms(fn, reps: int) -> float:
    """ms of one replay of a CUDA graph of fn()'s launches, captured
    after one eager run of fn()."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return _time_ms(g.replay, reps)


def _trellis_idr_phase(clip) -> None:
    """The trellis kernel at the I4x4 IDR's step shapes (nc 15: the I16
    AC blocks of a knight step's MBs, 16 x count, and the chroma AC
    ones, 8 x count, count 1, 30 and 60; _trellis_idr_inputs), bit-exact
    against the twin in every layout, each timed as a CUDA graph of 254
    launches (us per launch) with its bound; then one IDR's 508 launches
    (the two shapes at every knight step's MB count) as one graph,
    against the sum of their bounds."""
    import torch
    from x264_tpu_torch.kernels import intra_nxn as KN, trellis as KT
    from x264_tpu_torch.ops.trellis import trellis_quant_plain
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    steps = mbw + 2 * mbh - 2
    cac, dq, lam2f, tbl16, tblc = _trellis_idr_inputs(clip)
    p16 = KT.params_block(tbl16, lam2f, 15, dev)
    pc = KT.params_block(tblc, lam2f, 15, dev)
    calls = _trellis_calls()

    def bound_ms(nblocks):
        return max(_trellis_bound_ms(nblocks, 15))

    for count in (1, 30, 60):
        for name, k, tbl, params in (("I16 AC", 16, tbl16, p16),
                                     ("chroma AC", 8, tblc, pc)):
            b = k * count
            c, d = cac[:b], dq[:b]
            want = trellis_quant_plain(c, d, lam2f, tbl, 15)
            err = max(_max_err(fn(c, d, lam2f, params, 15), want)
                      for fn in calls.values())
            if err or not (want != 0).any():
                raise AssertionError(f"trellis IDR {name} x {count}: max err "
                                     f"{err}")
            us = {lay: 1e3 * _graph_ms(lambda: [fn(
                c, d, lam2f, params, 15) for _ in range(steps)], 5) / steps
                for lay, fn in calls.items()}
            print(f"trellis IDR {name}, {count} MBs ({b} blocks x 15): "
                  f"bit-exact in every layout, {us['auto']:.2f} us per launch"
                  f" (layout {_trellis_layout(b, 15)}; thread per block "
                  f"{us['thread']:.2f}, lanes per state {us['lanes']:.2f}; "
                  f"a graph of {steps} launches), bound "
                  f"{1e3 * bound_ms(b):.3f} us")
    counts = [KN.knight_lanes(d, mbw, mbh)[1] for d in range(steps)]

    def idr():
        for cnt in counts:
            KT.trellis_quant_(cac[:16 * cnt], dq[:16 * cnt], lam2f, p16, 15)
            KT.trellis_quant_(cac[:8 * cnt], dq[:8 * cnt], lam2f, pc, 15)

    print(f"trellis, one 1080p I4x4 IDR's {2 * steps} launches (I16 AC and "
          f"chroma AC at every knight step's MB count) as one graph: "
          f"{_graph_ms(idr, 5):.4f} ms, bound "
          f"{sum(bound_ms(16 * c) + bound_ms(8 * c) for c in counts):.4f} ms")


def _graph_replays(core, planes, qp, lam, tt, reps: int, **kw) -> tuple:
    """(the graph, ms of each of reps replays, the last replay's output) of
    an intra core at this key, captured now if no run captured it yet;
    each replay timed with the card synchronised around it."""
    import torch
    from x264_tpu_torch.models.graph import graph_for, run_core
    g = graph_for(core, planes, qp, lam, tt, **kw)
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_core(core, *planes, qp, lam, trellis_tbl=tt, **kw)
        torch.cuda.synchronize()
        times.append(1000 * (time.perf_counter() - t0))
    return g, times, out


def _i4_state(out, mbw: int, mbh: int) -> tuple:
    """The int32 recon plane (before deblock) and the mode grid an I4x4
    core left: each MB's neighbours as its knight step saw them."""
    import torch
    n = mbw * mbh
    modes = out["i4_modes"]
    quads = modes[:, :4].reshape(n, 2, 1, 2, 1).expand(n, 2, 2, 2, 2) \
        .reshape(n, 16)
    cells = torch.where(out["t8"][:, None], quads,
                        torch.where(out["mb_class"][:, None] == 1, modes, 2))
    grid = cells.reshape(mbh, mbw, 4, 4).permute(0, 2, 1, 3) \
        .reshape(4 * mbh, 4 * mbw)
    return (out["recon_y"].to(torch.int32).contiguous(),
            grid.to(torch.int32).contiguous())


def _nxn_phase(clip, record, int_ops_per_s: float) -> None:
    """The I4x4/I8x8 core on the first 1080p frame (CQP 26, the 8x8
    transform and trellis: the B-GOP run's key): the eager core against
    its CUDA graph (capture ms, then replay ms, every field equal); then
    the NxN kernel against its plain twin on every one of the 254 knight
    steps, from the state that IDR left, with t8_mode on and off (kernel
    and twin each carry their own copy forward; outputs, recon plane and
    mode grid equal), timed
    per IDR (all 254 launches through the wrapper, CUDA events around
    the whole pass; the recorded time is a CUDA graph of the 254
    launches, as the core's graph runs them), with its bound
    (``kernels/intra_nxn.work`` at the HBM and int32 rates) and the
    dependent chain of one MB (the kernel at step 0, one MB, 254 times in
    a graph), both also with t8_mode off (the I4x4 chain alone)."""
    import torch
    from x264_tpu_torch.kernels import intra_nxn as KN
    from x264_tpu_torch.models.intra import i4_frame_core
    from x264_tpu_torch.ops.trellis import frame_trellis
    from x264_tpu_torch.state import me_lambda, sad_lambda
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    n_mb, steps = mbw * mbh, mbw + 2 * mbh - 2
    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    qp = torch.full((n_mb,), QP, dtype=torch.int32, device=dev)
    lam = sad_lambda(QP)
    tt = frame_trellis(QP, "I", me_lambda(QP), True)
    kw = dict(mbw=mbw, mbh=mbh, cqp_off=0, lv_cap=96, t8_mode=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = i4_frame_core(*planes, qp, lam, trellis_tbl=tt, **kw)
    torch.cuda.synchronize()
    eager_ms = 1000 * (time.perf_counter() - t0)
    g, replay, out = _graph_replays(i4_frame_core, planes, qp, lam, tt, 5,
                                    **kw)
    bad = [k for k in eager if not torch.equal(eager[k], out[k])]
    if bad:
        raise AssertionError(f"I4 core: graph replay != eager core in {bad}")
    hist = np.bincount((out["mb_class"] + out["t8"]).cpu().numpy(),
                       minlength=3)
    print(f"I4x4/I8x8 core, 1080p IDR: graph replay == eager core, every "
          f"field; MBs I16 {hist[0]}, I4x4 {hist[1]}, I8x8 {hist[2]}; "
          f"eager {eager_ms:.1f} ms, capture {g.capture_ms:.1f} ms (warm-up "
          f"and capture), replay ms " + " ".join(f"{t:.2f}" for t in replay)
          + f"; {g.launches['intra_nxn']} NxN and {g.launches['trellis']} "
          "trellis launches per replay")

    ysrc = planes[0].to(torch.int32)
    state = _i4_state(eager, mbw, mbh)
    lam_t = torch.tensor([lam], dtype=torch.int32, device=dev)
    err = 0
    for t8 in (True, False):
        kst = [t.clone() for t in state]
        pst = [t.clone() for t in state]
        for d in range(steps):
            got = KN.nxn_candidates(kst[0], kst[1], ysrc, qp, lam_t, d, mbw,
                                    mbh, t8)
            want = KN.nxn_candidates_plain(pst[0], pst[1], ysrc, qp, lam, d,
                                           mbw, mbh, t8)
            err = max([err, _max_err(kst[0], pst[0]),
                       _max_err(kst[1], pst[1])]
                      + [_max_err(got[k], want[k]) for k in want
                         if want[k] is not None])
    if err:
        raise AssertionError(f"intra_nxn disagrees with its plain twin: "
                             f"max err {err}")

    def idr_pass(fn, st, ds=range(steps), t8=True):
        for d in ds:
            fn(st[0], st[1], ysrc, qp, lam_t, d, mbw, mbh, t8)

    reps = 5
    copies = [[t.clone() for t in state] for _ in range(reps + 1)]
    idr_pass(KN.nxn_candidates, copies[0])          # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for st in copies[1:]:
        idr_pass(KN.nxn_candidates, st)
    ev[1].record()
    ev[2].record()
    idr_pass(KN.nxn_candidates_plain, [t.clone() for t in state])
    ev[3].record()
    torch.cuda.synchronize()
    wrapper_ms = ev[0].elapsed_time(ev[1]) / reps
    plain = ev[2].elapsed_time(ev[3])

    def graph_ms(ds, t8=True) -> float:
        """ms of one replay of a CUDA graph of the kernel launched at the
        steps ds, as the I4 core's graph launches it (no wrapper)."""
        st = [t.clone() for t in state]
        return _graph_ms(lambda: idr_pass(KN.nxn_candidates, st, ds, t8),
                         reps)

    ms = graph_ms(range(steps))
    chain_us = 1e3 * graph_ms([0] * steps) / steps
    ms_i4 = graph_ms(range(steps), False)
    chain_i4 = 1e3 * graph_ms([0] * steps, False) / steps
    nbytes, ops = KN.work(n_mb, True)
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / int_ops_per_s
    print(f"intra_nxn at 1080p (t8_mode, {steps} knight steps, {n_mb} MBs): "
          f"bit-exact on every step, {ms:.4f} ms per IDR as a graph of "
          f"{steps} launches ({1e3 * ms / steps:.2f} us per step; through "
          f"the wrapper {wrapper_ms:.4f} ms; plain {plain:.1f} ms), bound "
          f"max(bytes {t_bytes:.4f}, operations {t_ops:.4f}) ms; one MB's "
          f"chain (step 0 alone, {steps} launches in a graph) "
          f"{chain_us:.2f} us, x {steps} steps = "
          f"{chain_us * steps / 1e3:.3f} ms; t8_mode off (the I4x4 chain "
          f"alone, bit-exact on every step too): {ms_i4:.4f} ms per IDR, "
          f"chain {chain_i4:.2f} us")
    record("intra_nxn", "x264_tpu_torch/csrc/intra_nxn.cu",
           "x264_tpu/models/intra_device.py:360-554", err, ms, plain,
           (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))


def _run_1080p(label, clip, p8x8, records, tools=None):
    """One main-path run (counts reset just before, read just after);
    tools: extra params (the 8x8 transform and trellis).  Adds its
    launches to the records and returns (launches, the shape of every MB
    of every P frame when partitions are on)."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    enc = Encoder(_params(W, H, p8x8, **(tools or {})), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__       # keyed by display index
    shapes = _spy(enc)
    t8s = _spy(enc, "t8")
    stream, times = b"", []
    x264_tpu_torch.reset_launch_counts()
    for y, u, v in clip:
        t0 = time.perf_counter()
        stream += enc.encode(Frame420(y, u, v))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stream += enc.flush()
    torch.cuda.synchronize()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p {label} run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    steady = times[2:]          # P frames after the first
    fps = len(steady) / sum(steady)
    print(f"{label} frame ms: " + " ".join(f"{1000 * t:.1f}" for t in times))
    print(f"1080p {label}: {fps:.3f} fps steady state (P frames "
          f"3-{len(clip)}), IDR {1000 * times[0]:.1f} ms, {len(stream)} "
          f"bytes, {len(stream) * 8 / len(clip) / 1000:.1f} kbit/frame, "
          f"mean Y-PSNR {_check_recon(label, stream, recons, clip):.3f} dB")
    if recons[len(clip) - 1] is not enc.last_recon:
        raise AssertionError(f"{label}: last_recon is not the last recon")
    if tools:
        share = float(torch.cat(t8s).float().mean()) if t8s else 0.0
        print(f"1080p {label}: {share:.4f} of the P frames' MBs use the "
              "8x8 transform")
        if not share:
            raise AssertionError(f"{label}: no MB chose the 8x8 transform")
    return launches, [s.cpu().numpy() for s in shapes]


def _check_recon(label, stream, recons, clip, decoded=None) -> float:
    """Every frame's recon (keyed by display index) has a Y-PSNR of at
    least 30 dB against its source and, where avdec runs, equals the
    decoded frame (only the display indices in ``decoded`` when given:
    with full_recon off a B frame's recon is not deblocked).  Returns the
    mean Y-PSNR."""
    if sorted(recons) != list(range(len(clip))):
        raise AssertionError(f"{label}: recons of display indices "
                             f"{sorted(recons)}")
    psnr = [_psnr(recons[d].y[:H, :W].cpu().numpy(), f[0])
            for d, f in enumerate(clip)]
    if not np.all(np.isfinite(psnr)) or min(psnr) < 30.0:
        raise AssertionError(f"{label}: recon quality out of range: {psnr}")
    if _avdec_available():
        dec = _decode(stream, W, H)
        if len(dec) != len(clip):
            raise AssertionError(f"avdec decoded {len(dec)} frames")
        for d, planes_d in enumerate(dec):
            if decoded is not None and d not in decoded:
                continue
            rec = recons[d]
            for p_rec, p_dec in zip((rec.y, rec.u, rec.v), planes_d):
                hh, ww = p_dec.shape
                if not np.array_equal(p_rec[:hh, :ww].cpu().numpy(), p_dec):
                    raise AssertionError(f"display {d}: decode != recon")
        print(f"avdec: {len(dec)} frames decoded, "
              f"{len(dec) if decoded is None else len(decoded)} of them "
              "checked bit-exact to the recon")
    return float(np.mean(psnr))


def _timed_stages(enc, times: dict) -> None:
    """Wrap the encoder's submit and finalize stages so each call's wall
    time, with the card synchronised before and after, is appended to
    times[(stage, frame type)]."""
    import torch

    def wrap(name, ftype_of):
        fn = getattr(enc, name)

        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.setdefault((name, ftype_of(a)), []).append(
                1000 * (time.perf_counter() - t0))
            return out
        setattr(enc, name, run)

    wrap("_submit_anchor", lambda a: a[2])
    wrap("_finalize_device", lambda a: a[0]["ftype"])
    wrap("_submit_b_pair", lambda a: "B")
    wrap("_submit_b", lambda a: "B")
    wrap("_finalize_b", lambda a: "B")


WARM_STEADY_IDRS = 3


def _warm_phase(clip) -> None:
    """Encoder.warm() at 1080p, before any other phase captures a graph:
    bench.py's GOP (CABAC, I4x4, the tools; bench.py calls warm(3600,
    full=True) before its clock) and its CAVLC twin (no I4x4 or trellis,
    so off the host-syntax path).  For each: warm()'s ms and the graphs
    it captured; then encode() ms, the card synchronised, of an IDR, of
    WARM_STEADY_IDRS more IDRs (the steady IDR), of a noise IDR whose
    levels overflow the first entropy rung (its core re-runs at the
    second) and of a mini-GOP (B B P, then flush); warm() must leave
    the kernel library loaded, no graph may be captured in those calls,
    and a second warm() returns True at once.  A cold encoder then
    writes the same bytes.  The graphs are dropped at the end, so that
    the later phases capture theirs as they did before this phase
    existed."""
    import torch
    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.kernels import build
    from x264_tpu_torch.models import graph
    from x264_tpu_torch.params import TYPE_IDR
    card = _smi("name,power.limit")
    rng = np.random.default_rng(3)
    noise = Frame420(rng.integers(0, 256, (H, W), dtype=np.uint8),
                     rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8),
                     rng.integers(0, 256, (H // 2, W // 2), dtype=np.uint8))
    frames = [Frame420(*f) for f in clip]
    n_idr = 1 + WARM_STEADY_IDRS
    # (frame, forced type): the IDRs, the noise IDR, then B B P
    plan = [(frames[i], TYPE_IDR if i else 0) for i in range(n_idr)] \
        + [(noise, TYPE_IDR)] + [(f, 0) for f in frames[n_idr:n_idr + 3]]

    def encode_all(enc, times=None) -> bytes:
        out = b""
        for fr, ftype in plan + [(None, None)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out += enc.flush() if fr is None else enc.encode(fr, ftype)
            torch.cuda.synchronize()
            if times is not None:
                times.append(1000 * (time.perf_counter() - t0))
        return out

    for label, kw in (
            ("bench.py's GOP, CABAC",
             dict(bframes=2, full_recon=False, i4x4=True, weightp=1,
                  **TOOLS)),
            ("its CAVLC twin",
             dict(bframes=2, full_recon=False, weightp=1,
                  transform_8x8=True, cabac=False))):
        params = _params(W, H, True, **kw)
        enc = Encoder(params, device="cuda")
        g0 = len(graph._GRAPHS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = enc.warm(3600, full=True)
        torch.cuda.synchronize()
        warm_ms = 1000 * (time.perf_counter() - t0)
        keys = list(graph._GRAPHS)[g0:]
        rungs = sorted(dict(k[-1]).get("lv_cap", dict(k[-1]).get("n_words"))
                       for k in keys)
        capture = " ".join(f"{graph._GRAPHS[k].capture_ms:.1f}" for k in keys)
        print(f"warm phase, {label}, {card}: warm() -> {ok} in "
              f"{warm_ms:.1f} ms, {len(keys)} graphs captured (rungs "
              f"{rungs}: ms {capture}), kernel library loaded "
              f"{build._lib is not None}, rung floor after it "
              f"{enc._rung_floor}")
        if not ok or len(keys) < 2 or build._lib is None:
            raise AssertionError(f"warm phase, {label}: warm() -> {ok}, "
                                 f"{len(keys)} graphs (both rungs expected),"
                                 f" library loaded {build._lib is not None}")
        g1 = len(graph._GRAPHS)
        times = []
        stream = encode_all(enc, times)
        new_graphs = len(graph._GRAPHS) - g1
        types = [s.frame_type for s in enc.stats]
        steady = times[1:n_idr]
        print(f"warm phase, {label}, {card}: encode() ms after warm(): the "
              f"first IDR {times[0]:.1f}, the steady IDR "
              f"{np.median(steady):.1f} (median of "
              f"{' '.join(f'{t:.1f}' for t in steady)}), the noise IDR "
              f"{times[n_idr]:.1f} (rung floor after it "
              f"{enc._rung_floor}), B B P and flush "
              f"{' '.join(f'{t:.1f}' for t in times[n_idr + 1:])}; graph "
              f"captures {new_graphs} (0 expected); frame types {types}")
        if new_graphs:
            raise AssertionError(
                f"warm phase, {label}: {new_graphs} graph captures after "
                "warm() returned True")
        if types != ["IDR"] * (n_idr + 1) + ["P", "B", "B"] or \
                enc._rung_floor != enc._RUNGS[params.cabac][-1]:
            raise AssertionError(f"warm phase, {label}: frame types {types},"
                                 f" rung floor {enc._rung_floor} (the noise "
                                 "IDR should overflow the first rung)")
        t0 = time.perf_counter()
        again = enc.warm(3600, full=True)
        again_ms = 1000 * (time.perf_counter() - t0)
        if not again or again_ms > 10:
            raise AssertionError(f"warm phase, {label}: a second warm() -> "
                                 f"{again} in {again_ms:.3f} ms")
        cold = encode_all(Encoder(params, device="cuda"))
        if cold != stream:
            raise AssertionError(f"warm phase, {label}: the warm encoder's "
                                 "stream != a cold encoder's")
        print(f"warm phase, {label}: a second warm() -> True in "
              f"{again_ms:.4f} ms; a cold encoder wrote the same "
              f"{len(stream)} bytes")
    graph._GRAPHS.clear()


def _run_1080p_b(clip, records):
    """The B-GOP main path (counts reset just before, read just after):
    bench.py's whole config, IDR + 3 x (B B P), P8x8 anchors, full_recon
    off, I4x4 on (the IDR's I4x4/I8x8 core one CUDA graph replay, the
    NxN kernel once per knight step), the 8x8 transform, trellis and
    weightp=1.  Prints each encode() call's ms, fps over the calls after
    the IDR's (display frames 1-9, flush included), the P frames with a
    non-neutral weight, and, from a second run with the card synchronised
    around each stage, the ms per I, P and B frame."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    kw = dict(bframes=2, full_recon=False, i4x4=True, weightp=1, **TOOLS)
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    weights = _weights_spy(enc)
    stream, times = b"", []
    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    for y, u, v in clip:
        t0 = time.perf_counter()
        stream += enc.encode(Frame420(y, u, v))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    stream += enc.flush()
    torch.cuda.synchronize()
    times.append(time.perf_counter() - t0)
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p I/B/P8x8 run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    types = [s.frame_type for s in enc.stats]
    n_b = types.count("B")
    least = _trellis_launches(n_i=1, n_p=3, n_b=n_b, i4=True)
    steps = (W + 15) // 16 + 2 * ((H + 15) // 16) - 2
    nxn = launches["intra_nxn"]
    if types != ["IDR"] + ["P", "B", "B"] * 3 or \
            dict(launches, trellis=0, intra_nxn=0) != {
                "esa16": 4 * n_b // 2, "esa_parts": 3, "deblock": 4,
                "trellis": 0, "intra_nxn": 0, "cavlc_blocks": 0,
                "bitpack": 0, "pir_column": 0} \
            or launches["trellis"] < least or not nxn or nxn % steps:
        raise AssertionError(f"I/B/P8x8: frame types {types}, launches "
                             f"{launches} (expected esa16 12, esa_parts 3, "
                             "deblock 4: B frames are not deblocked with "
                             f"full_recon off; trellis at least {least}; "
                             f"intra_nxn a multiple of the {steps} knight "
                             "steps, one per step of each I4 core run)")
    # the IDR is coded whole inside its own encode() call; every later
    # call up to flush() holds only the stages of display frames 1-9
    tail = times[1:]
    n_pairs = n_b // 2
    n_anchors = len(types) - n_b
    print("I/B/P8x8 encode() ms (display 0-9, then flush): "
          + " ".join(f"{1000 * t:.1f}" for t in times))
    print(f"1080p I/B/P8x8: {(len(clip) - 1) / sum(tail):.3f} fps over "
          f"display frames 1-{len(clip) - 1} (the calls after the IDR's, "
          f"flush included), {len(stream)} bytes, "
          f"{len(stream) * 8 / len(clip) / 1000:.1f} kbit/frame, mean "
          f"Y-PSNR {_check_recon('I/B/P8x8', stream, recons, clip, range(0, len(clip), 3)):.3f} dB,"
          f" launches per B pair: esa16 {launches['esa16'] / n_pairs:g},"
          f" deblock {(launches['deblock'] - n_anchors) / n_pairs:g};"
          f" trellis {launches['trellis']} in the run (at least {least});"
          f" {_weighted(weights)} of the {len(weights)} P frames carried a "
          f"non-neutral weight ({weights})")
    stage = {}
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    _timed_stages(enc, stage)
    for y, u, v in clip:
        enc.encode(Frame420(y, u, v))
    enc.flush()

    def ms(ftype, *names):
        calls = [t for nm in names for t in stage.get((nm, ftype), [])]
        n = types.count(ftype)
        return sum(calls) / n
    print(f"1080p I/B/P8x8 ms per frame (second run, the card synchronised "
          f"around each stage): I {ms('IDR', '_submit_anchor', '_finalize_device'):.1f}"
          f", P {ms('P', '_submit_anchor', '_finalize_device'):.1f}, B "
          f"{ms('B', '_submit_b_pair', '_submit_b', '_finalize_b'):.1f} "
          "(B pair submit "
          + " ".join(f"{t:.1f}" for t in stage[("_submit_b_pair", "B")])
          + "; B finalize "
          + " ".join(f"{t:.1f}" for t in stage[("_finalize_b", "B")]) + ")")
    return launches


def _check_small_b() -> None:
    """352x288 with B frames (one pair, one single tail B, full_recon on,
    P8x8 anchors): the card stream equals the CPU stream, with one
    deblock launch per frame and four esa16 launches for the pair and
    two for the single B."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    small = [Frame420(*f) for f in split_motion_clip(CHECK_W, CHECK_H,
                                                     CHECK_B_FRAMES)]
    streams = {}
    for d in ("cuda", "cpu"):
        e = Encoder(_params(CHECK_W, CHECK_H, True, bframes=2,
                            full_recon=True), device=d)
        x264_tpu_torch.reset_launch_counts()
        streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
        if d == "cuda":
            launches = x264_tpu_torch.launch_counts()
            types = [s.frame_type for s in e.stats]
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("352x288 B: card stream != CPU stream")
    if types != ["IDR", "P", "B", "B", "P", "B"] or launches != {
            "esa16": 6, "esa_parts": 2, "deblock": CHECK_B_FRAMES,
            "trellis": 0, "intra_nxn": 0, "cavlc_blocks": 0, "bitpack": 0,
            "pir_column": 0}:
        raise AssertionError(f"352x288 B: frame types {types}, launches "
                             f"{launches}")
    print(f"{CHECK_W}x{CHECK_H} I/B/P8x8 x{CHECK_B_FRAMES}: card stream == "
          f"CPU stream ({len(streams['cuda'])} bytes), launches {launches}")


def _check_small_tools() -> None:
    """352x288 with the 8x8 transform and trellis: I/P8x8 (4 frames) and
    one B pair on P8x8 anchors (full_recon on); card streams equal the
    CPU streams, and the card runs launched the trellis kernel."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    for label, n, kw in (("I/P8x8", CHECK_FRAMES, {}),
                         ("I/B/P8x8", 4, dict(bframes=2, full_recon=True))):
        small = [Frame420(*f) for f in split_motion_clip(CHECK_W, CHECK_H,
                                                         n)]
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(_params(CHECK_W, CHECK_H, True, **kw, **TOOLS),
                        device=d)
            t8s = _spy(e, "t8")
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                share = float(torch.cat(t8s).float().mean())
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label} t8 + trellis: card stream"
                                 " != CPU stream")
        if not launches["trellis"] or not share:
            raise AssertionError(f"352x288 {label} t8 + trellis: launches "
                                 f"{launches}, 8x8 share {share}")
        print(f"{CHECK_W}x{CHECK_H} {label} x{n} with the 8x8 transform and "
              f"trellis: card stream == CPU stream "
              f"({len(streams['cuda'])} bytes), launches {launches}, "
              f"{share:.4f} of the P MBs use the 8x8 transform")


def _check_small_i4() -> None:
    """352x288 I/P8x8 with I4x4, the 8x8 transform and trellis, and a
    second IDR (keyint 3): the card stream equals the CPU stream, and the
    card run launched the NxN kernel on every knight step of both IDRs
    (graph replays)."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    small = [Frame420(*f) for f in split_motion_clip(CHECK_W, CHECK_H,
                                                     CHECK_FRAMES)]
    streams = {}
    for d in ("cuda", "cpu"):
        e = Encoder(_params(CHECK_W, CHECK_H, True, i4x4=True, keyint_max=3,
                            **TOOLS), device=d)
        x264_tpu_torch.reset_launch_counts()
        streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
        if d == "cuda":
            launches = x264_tpu_torch.launch_counts()
            types = [s.frame_type for s in e.stats]
    steps = CHECK_W // 16 + 2 * (CHECK_H // 16) - 2
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("352x288 I4x4: card stream != CPU stream")
    if types != ["IDR", "P", "P", "IDR"] or launches["intra_nxn"] < 2 * steps:
        raise AssertionError(f"352x288 I4x4: frame types {types}, launches "
                             f"{launches}")
    print(f"{CHECK_W}x{CHECK_H} I4x4 + I/P8x8 x{CHECK_FRAMES} (keyint 3) "
          f"with the 8x8 transform and trellis: card stream == CPU stream "
          f"({len(streams['cuda'])} bytes), launches {launches}")


def _run_1080p_multiref(clip, records):
    """I/P8x8 on three references (counts reset just before, read after
    each encode() call and just after the run): ref_frames=3, weightp=1,
    the 8x8 transform, trellis and I4x4 at range 24 (the slower preset
    without aq_mode).  Each P frame launches esa_parts once per active
    reference, min(3, frames since the IDR).  Prints the share of MBs on
    each reference, the frames with a non-neutral weight, fps over the
    P frames on three references (display 3-5), and, from a second run
    with the card synchronised around each stage, the ms of each frame
    and of the host's weight analysis in it."""
    import torch
    import x264_tpu_torch
    import x264_tpu_torch.api as api
    from x264_tpu_torch.api import Encoder, Frame420
    kw = dict(ref_frames=3, weightp=1, i4x4=True, me_range=24, **TOOLS)
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    refs = _spy(enc, "ref_mb")
    weights = _weights_spy(enc)
    stream, times, per_frame = b"", [], []
    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    for y, u, v in clip:
        before = x264_tpu_torch.launch_counts()["esa_parts"]
        t0 = time.perf_counter()
        stream += enc.encode(Frame420(y, u, v))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_frame.append(x264_tpu_torch.launch_counts()["esa_parts"] - before)
    stream += enc.flush()
    torch.cuda.synchronize()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p I/P8x8 three-reference run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    n = len(clip)
    want = [0] + [min(3, d) for d in range(1, n)]
    steps = (W + 15) // 16 + 2 * ((H + 15) // 16) - 2
    least = _trellis_launches(n_i=1, n_p=n - 1, n_b=0, i4=True)
    if per_frame != want or launches["esa16"] or \
            launches["deblock"] != n or launches["trellis"] < least or \
            not launches["intra_nxn"] or launches["intra_nxn"] % steps:
        raise AssertionError(f"three references: esa_parts per frame "
                             f"{per_frame} (expected {want}), launches "
                             f"{launches}")
    hist = np.bincount(torch.cat(refs).cpu().numpy(), minlength=3)
    share = hist / hist.sum()
    tail = times[3:]
    print("I/P8x8 three references encode() ms: "
          + " ".join(f"{1000 * t:.1f}" for t in times))
    print(f"1080p I/P8x8 on three references: esa_parts launches per frame "
          f"{per_frame} (one per active reference); MBs of the P frames on "
          f"ref_idx 0/1/2: {' '.join(str(int(c)) for c in hist)} (shares "
          f"{' '.join(f'{x:.4f}' for x in share)}); {_weighted(weights)} of "
          f"the {len(weights)} P frames carried a non-neutral weight; "
          f"{len(tail) / sum(tail):.3f} fps over display 3-{n - 1} (three "
          f"references), {len(stream)} bytes, "
          f"{len(stream) * 8 / n / 1000:.1f} kbit/frame, mean Y-PSNR "
          f"{_check_recon('three references', stream, recons, clip):.3f} dB")
    stage, analysis = {}, {}
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    real_analysis = api.analyse_weights

    def timed_analysis(y, hist):
        t0 = time.perf_counter()
        out = real_analysis(y, hist)
        analysis.setdefault(len(hist), []).append(
            1000 * (time.perf_counter() - t0))
        return out
    for name in ("_submit_device", "_finalize_device"):
        fn = getattr(enc, name)

        def run(*a, _fn=fn, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            stage.setdefault(enc.frame_idx, []).append(
                1000 * (time.perf_counter() - t0))
            return out
        setattr(enc, name, run)
    api.analyse_weights = timed_analysis
    try:
        for y, u, v in clip:
            enc.encode(Frame420(y, u, v))
    finally:
        api.analyse_weights = real_analysis
    # _submit_device advances frame_idx: its time lands on the next key
    ms = [stage[d + 1][0] + stage[d + 1][1] for d in range(n)]
    print("1080p I/P8x8 three references, ms per frame (second run, the "
          "card synchronised around each stage; submit + finalize): "
          + " ".join(f"{t:.1f}" for t in ms) + f" (refs {want}); of it the "
          "host's weight analysis (models/weightp.analyse_weights) by "
          "reference count: " + ", ".join(
              f"{k}: " + " ".join(f"{t:.1f}" for t in analysis[k])
              for k in sorted(analysis)) + " ms")


def _check_small_weightp() -> None:
    """352x288 on fade_clip with weightp=1 on several references: P16 on
    three, P8x8 with the 8x8 transform and trellis on two, and B frames
    (bframes=2, P8x8 anchors, full_recon on) on two; the card stream
    equals the CPU stream, some P frame carries a non-neutral weight, some
    MB sits on ref_idx > 0, and each P frame launched its ESA kernel once
    per active reference."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    for label, n, kw, clip_kw in (
            ("P16, ref_frames=3", 5, dict(ref_frames=3), {}),
            ("P8x8 + tools, ref_frames=2", 4,
             dict(p8x8=True, ref_frames=2, **TOOLS), {}),
            ("B B P8x8, ref_frames=2", 7,
             dict(p8x8=True, ref_frames=2, bframes=2, full_recon=True),
             dict(pan=(1, 1), flash=(3,)))):
        small = [Frame420(*f) for f in fade_clip(CHECK_W, CHECK_H, n,
                                                 **clip_kw)]
        p = _params(CHECK_W, CHECK_H, kw.pop("p8x8", False), weightp=1,
                    me_range=8, **kw)
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(p, device=d)
            refs, weights = _spy(e, "ref_mb"), _weights_spy(e)
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                n_b = [s.frame_type for s in e.stats].count("B")
                on_older = int(sum((r > 0).sum() for r in refs))
                weighted = _weighted(weights)
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label} weightp: card stream != "
                                 "CPU stream")
        searches = sum(min(p.ref_frames, i + 1) for i in range(n - 1 - n_b))
        want = {"esa_parts": searches if p.p8x8 else 0,
                "esa16": 2 * n_b + (0 if p.p8x8 else searches)}
        if not (on_older and weighted) or \
                {k: launches[k] for k in want} != want:
            raise AssertionError(f"352x288 {label} weightp: {on_older} MBs "
                                 f"on ref_idx > 0, {weighted} weighted "
                                 f"frames, launches {launches} (expected "
                                 f"{want})")
        print(f"{CHECK_W}x{CHECK_H} {label}, weightp=1, x{n}: card stream =="
              f" CPU stream ({len(streams['cuda'])} bytes), {weighted} P "
              f"frames with a non-neutral weight, {on_older} MBs on "
              f"ref_idx > 0, launches {launches}")


def _i16_graph_phase(clip) -> None:
    """The I16 core of the I/P16 run's IDR key (CQP 26, no trellis): its
    graph's capture ms and replay ms, the replay equal to the eager core
    in every field."""
    import torch
    from x264_tpu_torch.models.intra import i_frame_core
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    qp = torch.full((mbw * mbh,), QP, dtype=torch.int32, device=dev)
    kw = dict(mbw=mbw, mbh=mbh, cqp_off=0, lv_cap=96)
    eager = i_frame_core(*planes, qp, **kw)
    g, replay, out = _graph_replays(i_frame_core, planes, qp, None, None, 5,
                                    **kw)
    bad = [k for k in eager if not torch.equal(eager[k], out[k])]
    if bad:
        raise AssertionError(f"I16 core: graph replay != eager core in {bad}")
    print(f"I16 core, 1080p IDR: graph replay == eager core, every field; "
          f"capture {g.capture_ms:.1f} ms (warm-up and capture, in the "
          "I/P16 run's IDR), replay ms "
          + " ".join(f"{t:.2f}" for t in replay))


_FIELD_KEYS = ("luma_dc", "luma_ac", "luma_nnz", "chroma_dc", "chroma_ac",
               "chroma_nnz", "cbp_luma", "cbp_chroma")


def _cavlc_inputs(out, b: bool):
    """A core's fields -> the CAVLC kernels' inputs as the main path makes
    them: residual_slots' fields (is_i16 last) and the header slots (a
    P8x8 frame's 22 per MB or a B frame's 10)."""
    from x264_tpu_torch.ops import header as HD
    intra = out["mb_class"] == 0
    fields = [out[k] for k in _FIELD_KEYS] + [intra]
    if b:
        hdr = HD.header_slots_b(out["bmode"], out["mb_class"] == 3,
                                out["mvd0"], out["mvd1"], out["cbp_luma"],
                                out["cbp_chroma"], out["qp_mb"],
                                t8_mode=True, intra=intra,
                                i16_mode=out["i16_mode"],
                                chroma_mode=out["chroma_mode"])
    else:
        hdr = HD.header_slots_parts(
            out["mb_class"], out["shape"], out["i16_mode"],
            out["chroma_mode"], out["mvd_part"], out["ref8"],
            out["cbp_luma"], out["cbp_chroma"], out["qp_mb"], num_ref=1,
            t8=out["t8"])
    return fields, hdr


def _cavlc_alone(fields, mbw: int, mbh: int, hv, hl, rv, rl, flds,
                 n_words: int = 64):
    """(blocks, pack, packing, placement): the CAVLC kernels' launches
    alone, on inputs and outputs made once: cavlc_blocks on the frame's
    fields, and bitpack's two entry points, together and apart: the
    packing of the header and residual grids and the (N,) ``flds`` into
    the blob, and the placement of its payload."""
    import torch
    from x264_tpu_torch.kernels import bitpack as KB, build, cavlc as KC
    from x264_tpu_torch.kernels.build import check
    lib = build.library()
    dev = hv.device
    tab = KC._device_ctx(str(dev))[1]
    n = mbw * mbh
    vals = torch.empty((n, KC.MB_SLOTS), dtype=torch.int32, device=dev)
    lens = torch.empty_like(vals)
    ptrs = [t.data_ptr() for t in fields]
    nf = len(flds)
    fp = [f.data_ptr() for f in flds] + [None] * (4 - nf)
    blob = torch.empty((n, n_words + 1 + nf), dtype=torch.int32, device=dev)
    pay = torch.empty(KB.payload_words(n, n_words), dtype=torch.int32,
                      device=dev)
    sums = torch.empty(KB.sum_words(n), dtype=torch.int32, device=dev)

    def blocks():
        check(lib.cavlc_mb_launch(
            *ptrs, tab.data_ptr(), vals.data_ptr(), lens.data_ptr(), mbw,
            mbh, torch.cuda.current_stream().cuda_stream), "cavlc_blocks")

    def packing():
        check(lib.bitpack_launch(
            hv.data_ptr(), hl.data_ptr(), hv.shape[1], rv.data_ptr(),
            rl.data_ptr(), rv.shape[1], *fp, nf, blob.data_ptr(), n_words,
            n, torch.cuda.current_stream().cuda_stream), "bitpack")

    def placement():
        check(lib.bitplace_launch(
            blob.data_ptr(), blob.shape[1], n_words, n, sums.data_ptr(),
            pay.data_ptr(), pay.numel(),
            torch.cuda.current_stream().cuda_stream), "bitplace")

    def pack():
        packing()
        placement()
    return blocks, pack, packing, placement


def _v1_start():
    """Start building the CAVLC pair's first design (tools/cavlc_v1.py),
    which the CAVLC phases time beside the current kernels."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "cavlc_v1", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tools", "cavlc_v1.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, mod.build_start()


def _graph_calls_ms(fn, calls: int = 20) -> float:
    """ms a call of fn() on the card from a CUDA graph of ``calls`` calls
    (``_graph_ms``), so that neither the host's enqueue nor the graph's
    own launch, once per replay, is in the time."""
    return _graph_ms(lambda: [fn() for _ in range(calls)], 5) / calls


def _cavlc_compare(label: str, fields, hdr, mbw: int, mbh: int, v1,
                   int_ops_per_s: float, n_fields: int) -> dict:
    """The CAVLC pair on one shape: each kernel against its twin on the
    card (residual_slots_plain; pack_blob_plain, then the payload's
    placement place_blob_plain
    included) at both word rungs, and the first design (``v1``) held
    equal; then each one's ms through its wrapper and its launch alone,
    v1 and the current kernels in turns (v1, current, current, v1), the
    twin's ms and the bound.  Returns {name: (ms, plain_ms, bound,
    err)}."""
    import torch
    from x264_tpu_torch.kernels import bitpack as KB, cavlc as KC
    from x264_tpu_torch.ops import cavlc as CV
    hv, hl = hdr
    n = mbw * mbh
    flds = [fields[6]] * n_fields          # any n_fields int32 columns
    kv, kl = CV.residual_slots(*fields, mbw, mbh)
    pv, pl = CV.residual_slots_plain(*fields, mbw, mbh)
    v1v, v1l = v1.slots(fields, mbw, mbh)
    err_b = max(_max_err(kv, pv), _max_err(kl, pl))
    v1_equal = torch.equal(kv, v1v) and torch.equal(kl, v1l)
    if err_b or not v1_equal:
        raise AssertionError(f"cavlc_blocks on the {label}: twin error "
                             f"{err_b}, v1 equal {v1_equal}")
    err_p = 0
    for n_words in (64, 416):
        blob = CV.cavlc_blob(hv, hl, kv, kl, n_words, flds)
        pay = KB.place(blob, n_words)
        pblob = KB.pack_blob_plain(hv, hl, kv, kl, n_words, flds)
        ppay = KB.place_blob_plain(pblob, n_words)
        err_p = max(err_p, _max_err(blob, pblob), _max_err(pay, ppay))
        if not torch.equal(v1.blob(hv, hl, kv, kl, n_words, flds), blob):
            raise AssertionError(f"bitpack on the {label}: v1's blob != "
                                 f"the current one at {n_words} words")
    if err_p:
        raise AssertionError(f"bitpack on the {label}: twin error {err_p}")
    blob = CV.cavlc_blob(hv, hl, kv, kl, 64, flds)
    nbits = blob[:, 64].long()
    s = hv.shape[1] + kv.shape[1]
    used = int(((nbits + 31) // 32).clamp(max=64).sum())
    blocks_alone, pack_alone, packing, placement = _cavlc_alone(
        fields, mbw, mbh, hv, hl, kv, kl, flds)
    cat_v, cat_l = torch.cat([hv, kv], 1), torch.cat([hl, kl], 1)
    v1_blocks, v1_pack = v1.alone(fields, mbw, mbh, cat_v, cat_l, 64)
    nonzero = int(sum((f != 0).sum() for f in fields[:2])
                  + sum((f != 0).sum() for f in fields[3:5]))
    paths = {
        "cavlc_blocks": (lambda: CV.residual_slots(*fields, mbw, mbh),
                         blocks_alone, lambda: v1.slots(fields, mbw, mbh),
                         v1_blocks,
                         lambda: CV.residual_slots_plain(*fields, mbw, mbh),
                         KC.work(n) / HBM_BYTES_PER_S * 1e3,
                         # ~48 operations a block, ~24 a nonzero level
                         (48 * 27 * n + 24 * nonzero) / int_ops_per_s * 1e3),
        "bitpack": (lambda: KB.place(CV.cavlc_blob(hv, hl, kv, kl, 64,
                                                   flds), 64),
                    pack_alone, lambda: v1.blob(hv, hl, kv, kl, 64, flds),
                    v1_pack,
                    lambda: KB.place_blob_plain(
                        KB.pack_blob_plain(hv, hl, kv, kl, 64, flds), 64),
                    KB.work(n, s, 64, n_fields, used) / HBM_BYTES_PER_S
                    * 1e3,
                    # the scan and ~10 more a slot
                    15 * n * s / int_ops_per_s * 1e3)}
    from x264_tpu_torch.kernels import build
    lib = build.library()
    print(f"{label}: dynamic shared memory a CTA: cavlc_blocks "
          f"{lib.cavlc_smem_bytes()} bytes (4 MBs), bitpack "
          f"{lib.bitpack_smem_bytes(hv.shape[1], kv.shape[1], 64)} bytes at "
          f"64 words, {lib.bitpack_smem_bytes(hv.shape[1], kv.shape[1], 416)}"
          " at 416 (4 MBs)")
    rec = {}
    for name, (wrap, alone, v1_wrap, v1_alone, plain, by_bytes,
               by_ops) in paths.items():
        t_v1 = [_time_ms(v1_wrap, 20)]
        t_v1a = [_time_ms(v1_alone, 50)]
        t_v1g = [_graph_calls_ms(v1_alone)]
        t_new = [_time_ms(wrap, 20), _time_ms(wrap, 20)]
        t_newa = [_time_ms(alone, 50), _time_ms(alone, 50)]
        t_newg = [_graph_calls_ms(alone), _graph_calls_ms(alone)]
        t_v1.append(_time_ms(v1_wrap, 20))
        t_v1a.append(_time_ms(v1_alone, 50))
        t_v1g.append(_graph_calls_ms(v1_alone))
        plain_ms = _time_ms(plain, 3)
        bound = (max(by_bytes, by_ops),
                 "bytes" if by_bytes >= by_ops else "operations")
        what = (f"{n * 27} blocks" if name == "cavlc_blocks"
                else f"{n} x {s} slots, 64 words, {used} payload words")
        print(f"{name}, {label} ({what}): bit-exact against the twin, v1 "
              f"equal; v1 -> current (v1, current, current, v1): through "
              f"the wrapper {t_v1[0]:.4f}, {t_v1[1]:.4f} -> {t_new[0]:.4f},"
              f" {t_new[1]:.4f} ms; launch alone {t_v1a[0]:.4f}, "
              f"{t_v1a[1]:.4f} -> {t_newa[0]:.4f}, {t_newa[1]:.4f} ms, in a "
              f"CUDA graph of 20 {t_v1g[0]:.4f}, {t_v1g[1]:.4f} -> "
              f"{t_newg[0]:.4f}, {t_newg[1]:.4f} ms; twin "
              f"{plain_ms:.3f} ms; bound {bound[0]:.4f} ms by {bound[1]} "
              f"(bytes {by_bytes:.4f}, operations {by_ops:.4f})")
        rec[name] = (min(t_new), plain_ms, bound,
                     err_b if name == "cavlc_blocks" else err_p)
    nov = int((nbits > 32 * 64).sum())
    print(f"{label}: max MB {int(nbits.max())} bits, {nov} MBs past 64 "
          "words; bitpack's entry points apart, in a CUDA graph of 20: "
          f"packing {_graph_calls_ms(packing):.4f} ms, placement (its sums "
          f"and zeroing, then its stores) {_graph_calls_ms(placement):.4f}"
          " ms")
    return rec


def _cavlc_phase(frames: dict, record, int_ops_per_s: float, v1) -> None:
    """The CAVLC block coder and bit packer against their twins,
    bit-exact, at the 1080p shapes of a P8x8 frame and a B frame (the
    cores' fields, ``frames``: label -> (out, is_b)), the packer at both
    rungs (64 and 416 words) with its payload; the first design beside
    them (``_cavlc_compare``).  The P8x8 frame's numbers are recorded."""
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    rec = {}
    for label, (out, is_b) in frames.items():
        fields, hdr = _cavlc_inputs(out, is_b)
        got = _cavlc_compare(f"1080p {label} frame", fields, hdr, mbw, mbh,
                             v1, int_ops_per_s, 2 if is_b else 3)
        for k, v in got.items():
            rec.setdefault(k, v)
    record("cavlc_blocks", "x264_tpu_torch/csrc/cavlc_blocks.cu",
           "x264_tpu/ops/device/cavlc.py:197", rec["cavlc_blocks"][3],
           *rec["cavlc_blocks"][:3])
    record("bitpack", "x264_tpu_torch/csrc/bitpack.cu",
           "x264_tpu/ops/device/bitpack.py:24", rec["bitpack"][3],
           *rec["bitpack"][:3])


class _AppendSpy:
    """Spies on the CAVLC host append: each ``api._append_mbs`` call's
    host ms (the wait for the payload's copy, the words' put_many and
    the skip run) grouped per frame, the part of it spent waiting for
    the payload's copy (``api._HostCopy.numpy`` inside the call), and a
    count of the host merge (``slice_assemble.merge_mb_strings``) calls,
    which the card path no longer makes."""

    def __init__(self):
        from x264_tpu_torch import api
        from x264_tpu_torch.bitstream import slice_assemble as SA
        self.api, self.sa = api, SA
        self.saved = (api._append_mbs, SA.merge_mb_strings,
                      api._HostCopy.numpy)
        self.calls, self.waits, self.merges = [], [], 0
        spy = self

        def append(*a, **k):
            spy.waits.append(0.0)
            t0 = time.perf_counter()
            try:
                return spy.saved[0](*a, **k)
            finally:
                spy.calls.append(1000 * (time.perf_counter() - t0))

        def merge(*a, **k):
            spy.merges += 1
            return spy.saved[1](*a, **k)

        def numpy(copy):
            t0 = time.perf_counter()
            try:
                return spy.saved[2](copy)
            finally:
                if len(spy.waits) > len(spy.calls):   # inside an append
                    spy.waits[-1] += 1000 * (time.perf_counter() - t0)
        api._append_mbs, SA.merge_mb_strings = append, merge
        api._HostCopy.numpy = numpy

    def close(self):
        (self.api._append_mbs, self.sa.merge_mb_strings,
         self.api._HostCopy.numpy) = self.saved

    def line(self, label: str, n_frames: int) -> str:
        ms = np.array(self.calls)
        per = ms.sum() / n_frames
        wait = sum(self.waits) / n_frames
        return (f"{label}: CAVLC host append {per:.3f} ms a frame over "
                f"{n_frames} frames ({len(ms)} calls: p50 "
                f"{np.percentile(ms, 50):.3f}, max {ms.max():.3f} ms), of "
                f"which the wait for the payload's copy {wait:.3f} and "
                f"put_many and the skip run {per - wait:.3f}; "
                f"merge_mb_strings calls {self.merges}")


def _graph_count() -> int:
    """The CUDA graphs the process has captured (models/graph.py)."""
    from x264_tpu_torch.models import graph
    return len(graph._GRAPHS)


def _cavlc_placed(launches, new_graphs: int, least: int) -> int:
    """The CAVLC payloads a run placed, from its launch counts, or -1
    when the counts disagree with the path: every core run codes its
    blocks (cavlc_blocks) and packs its MBs (bitpack) once, and so does
    an I graph's warm-up at its capture (``new_graphs`` of them); the
    encoder places each core run's payload once (bitpack's second entry
    point), at least ``least`` times in the run."""
    runs = launches["cavlc_blocks"]
    placed = launches["bitpack"] - runs
    return placed if placed >= least and runs - placed == new_graphs \
        else -1


def _run_1080p_cavlc(clip, records):
    """The CAVLC main path (counts reset just before, read just after):
    bench.py's GOP (IDR + 3 x (B B P), P8x8 anchors, full_recon off, the
    8x8 transform, weightp=1) with cabac=False, so trellis and I4x4 off.
    Every core codes its blocks (cavlc_blocks) and packs its MBs
    (bitpack) once, and the encoder places its payload (bitpack's second
    entry point) once, more when an MB overflows the first word rung.
    Prints each encode() call's ms, fps over display frames 1-9, bytes,
    Y-PSNR, the rung floor, and from a second run with the card
    synchronised around each stage the ms per I, P and B frame, submit
    and finalize apart."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    kw = dict(bframes=2, full_recon=False, weightp=1, transform_8x8=True,
              cabac=False)
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    weights = _weights_spy(enc)
    stream, times = b"", []
    appends = _AppendSpy()
    g0 = _graph_count()
    try:
        torch.cuda.synchronize()
        x264_tpu_torch.reset_launch_counts()
        for y, u, v in clip:
            t0 = time.perf_counter()
            stream += enc.encode(Frame420(y, u, v))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        stream += enc.flush()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finally:
        appends.close()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p CAVLC I/B/P8x8 run: {launches}")
    print(appends.line("1080p CAVLC I/B/P8x8", len(clip)))
    if appends.merges or len(appends.calls) != len(clip):
        raise AssertionError(f"CAVLC I/B/P8x8: {len(appends.calls)} appends"
                             f" for {len(clip)} frames, {appends.merges} "
                             "host merges")
    for r in records:
        r["launches"] += launches[r["name"]]
    types = [s.frame_type for s in enc.stats]
    n_b = types.count("B")
    cv = launches["cavlc_blocks"]
    placed = _cavlc_placed(launches, _graph_count() - g0, len(clip))
    if types != ["IDR"] + ["P", "B", "B"] * 3 or \
            dict(launches, cavlc_blocks=0, bitpack=0) != {
                "esa16": 4 * n_b // 2, "esa_parts": 3, "deblock": 4,
                "trellis": 0, "intra_nxn": 0, "cavlc_blocks": 0,
                "bitpack": 0, "pir_column": 0} or placed < 0:
        raise AssertionError(f"CAVLC I/B/P8x8: frame types {types}, "
                             f"launches {launches} (expected esa16 12, "
                             "esa_parts 3, deblock 4, no trellis or NxN, "
                             "cavlc_blocks once per core run, bitpack "
                             "once more per placement, at least "
                             f"{len(clip)} placements)")
    tail = times[1:]
    print("CAVLC I/B/P8x8 encode() ms (display 0-9, then flush): "
          + " ".join(f"{1000 * t:.1f}" for t in times))
    psnr = _check_recon("CAVLC I/B/P8x8", stream, recons, clip,
                        range(0, len(clip), 3))
    print(f"1080p CAVLC I/B/P8x8: {(len(clip) - 1) / sum(tail):.3f} fps "
          f"over display frames 1-{len(clip) - 1} (the calls after the "
          f"IDR's, flush included), {len(stream)} bytes, "
          f"{len(stream) * 8 / len(clip) / 1000:.1f} kbit/frame, mean "
          f"Y-PSNR {psnr:.3f} dB,"
          f" cavlc_blocks {cv} and bitpack {launches['bitpack']} launches "
          f"({placed} core runs, each packed and placed; the rest the I16 "
          f"graph's warm-up at its capture, which packs and does not "
          f"place), rung floor "
          f"{enc._rung_floor} words; {_weighted(weights)} of the "
          f"{len(weights)} P frames carried a non-neutral weight")
    stage = {}
    enc = Encoder(_params(W, H, True, **kw), device="cuda")
    _timed_stages(enc, stage)
    for y, u, v in clip:
        enc.encode(Frame420(y, u, v))
    enc.flush()

    def ms(ftype, *names):
        calls = [t for nm in names for t in stage.get((nm, ftype), [])]
        return sum(calls) / types.count(ftype)
    print("1080p CAVLC I/B/P8x8 ms per frame (second run, the card "
          "synchronised around each stage): "
          + ", ".join(
              f"{f} {ms(k, sub, fin):.1f} (submit {ms(k, sub):.1f}, "
              f"finalize {ms(k, fin):.1f})"
              for f, k, sub, fin in (
                  ("I", "IDR", "_submit_anchor", "_finalize_device"),
                  ("P", "P", "_submit_anchor", "_finalize_device"),
                  ("B", "B", "_submit_b_pair", "_finalize_b"))))


def _check_small_cavlc() -> None:
    """352x288 CAVLC: I/P16 at QP 26 (BASELINE.json's first config's
    shape) and I/B/P8x8 with the 8x8 transform and weightp=1 on two
    references (fade_clip, full_recon on); the card stream equals the CPU
    stream, and every core launched both CAVLC kernels (bitpack's
    placement once per core run)."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    for label, frames, p8x8, kw in (
            ("I/P16", split_motion_clip(CHECK_W, CHECK_H, CHECK_FRAMES),
             False, {}),
            ("I/B/P8x8, 8x8 transform, weightp=1, ref_frames=2",
             fade_clip(CHECK_W, CHECK_H, 7, pan=(1, 1), flash=(3,)), True,
             dict(bframes=2, full_recon=True, transform_8x8=True, weightp=1,
                  ref_frames=2, me_range=8))):
        small = [Frame420(*f) for f in frames]
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(_params(CHECK_W, CHECK_H, p8x8, cabac=False, **kw),
                        device=d)
            g0 = _graph_count()
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                new_graphs = _graph_count() - g0
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 CAVLC {label}: card stream != "
                                 "CPU stream")
        if _cavlc_placed(launches, new_graphs, len(small)) < 0 or \
                launches["trellis"]:
            raise AssertionError(f"352x288 CAVLC {label}: launches "
                                 f"{launches}")
        print(f"{CHECK_W}x{CHECK_H} CAVLC {label} x{len(small)}: card stream"
              f" == CPU stream ({len(streams['cuda'])} bytes), launches "
              f"{launches}")


def _medium_params(w: int, h: int, **kw):
    """x264's medium preset (the port's param_default_preset: bframes 2,
    P8x8, I4x4, the 8x8 transform, trellis, weightp=1, range 16, CABAC)
    at CRF 23 with AQ mode 1, MB-tree and b_adapt=1; scenecut 40,
    keyint_min 25 and rc_lookahead 8 are its defaults."""
    from x264_tpu_torch.params import RC_CRF, param_default_preset
    return param_default_preset("medium").clone(
        width=w, height=h, rc_method=RC_CRF, crf=23.0, aq_mode=1,
        mbtree=True, b_adapt=1, **kw)


def _aq_map(frame) -> np.ndarray:
    """The AQ mode-1 QP map of a frame at QP 26, as the encoder's _aq_qp
    makes it: (N,) int32."""
    from x264_tpu_torch.rc import aq_offsets
    y, u, v = (_pad_to_mb(p, s) for p, s in zip(frame, (16, 8, 8)))
    off = aq_offsets(y, u, v, y.shape[1] // 16, y.shape[0] // 16, 1.0,
                     mode=1)
    return np.clip(QP + np.round(off).astype(np.int64), 10, 51
                   ).astype(np.int32)


def _lowres_esa_phase(clip, esa_rate: float) -> None:
    """esa16 and esa_parts at the lookahead's shape: lowres planes of two
    1080p frames (models/lookahead.lowres_plane: 960x544, 60x34 lowres
    MBs), range 8, lambda sad_lambda(24); bit-exact against their plain
    twins, ms through the wrapper and for the launch alone, and the bound
    (_esa_bound_ms).  Then one plan's pair searches (bframes 2: three
    queued frames, 8 pairs; models/lookahead._pair_costs, one esa16
    launch per pair): ms per plan and per pair, ROADMAP B9's number."""
    import torch
    from x264_tpu_torch.kernels import esa16 as KE, esa_parts as KP
    from x264_tpu_torch.models import lookahead as LA
    from x264_tpu_torch.ops.mc import pad_edge
    from x264_tpu_torch.state import PAD, sad_lambda
    dev = torch.device("cuda")
    lrs = [LA.lowres_plane(torch.from_numpy(_pad_to_mb(f[0], 16)).to(dev))
           for f in clip[:4]]
    h, w = lrs[0].shape
    mbw, mbh = w // 16, h // 16
    if (w, h) != (960, 544):
        raise AssertionError(f"lowres plane {w}x{h}, not 960x544")
    lam, r = sad_lambda(LA._LOOKAHEAD_QP), LA._RANGE
    src, ref_pad = lrs[1], pad_edge(lrs[0], PAD)
    mv_k, cost_k = KE.full_search_16x16(src, ref_pad, lam, r, mbw, mbh)
    mv_p, cost_p = KE.full_search_16x16_plain(src, ref_pad, lam, r, mbw,
                                              mbh)
    units_k = KP.full_search_parts(src, ref_pad, lam, r, mbw, mbh)
    units_p = KP.full_search_parts_plain(src, ref_pad, lam, r, mbw, mbh)
    errs = {"esa16": max(_max_err(mv_k, mv_p), _max_err(cost_k, cost_p)),
            "esa_parts": max(_max_err(units_k[k], units_p[k])
                             for k in units_p)}
    if any(errs.values()):
        raise AssertionError(f"lowres ESA kernels disagree with their "
                             f"plain twins: {errs}")
    times = {
        "esa16": _time_ms(lambda: KE.full_search_16x16(
            src, ref_pad, lam, r, mbw, mbh), 20),
        "esa_parts": _time_ms(lambda: KP.full_search_parts(
            src, ref_pad, lam, r, mbw, mbh), 20)}
    alone = {name: _time_ms(KE.esa_launcher(
        name, shapes, src, ref_pad, lam, r, mbw, mbh)[0], 50)
        for name, shapes in (("esa16", KE.OUT_SHAPES),
                             ("esa_parts", KP.OUT_SHAPES))}
    plain = {"esa16": _time_ms(lambda: KE.full_search_16x16_plain(
        src, ref_pad, lam, r, mbw, mbh), 3),
        "esa_parts": _time_ms(lambda: KP.full_search_parts_plain(
            src, ref_pad, lam, r, mbw, mbh), 3)}
    bounds = {"esa16": _esa_bound_ms(src, ref_pad, r, 1, 3, esa_rate),
              "esa_parts": _esa_bound_ms(src, ref_pad, r, 9, 27, esa_rate)}
    for name in times:
        print(f"{name} at the lookahead's shape ({w}x{h} lowres, {mbw}x{mbh}"
              f" MBs, r = {r}, lambda {lam}): bit-exact, {times[name]:.4f} "
              f"ms through the wrapper (its launch alone {alone[name]:.4f} "
              f"ms; plain {plain[name]:.3f} ms), bound "
              f"{bounds[name][0]:.4f} ms by {bounds[name][1]}")
    stack = torch.stack(lrs)
    pairs = ((1, 0), (2, 1), (3, 2), (2, 0), (3, 0), (1, 2), (1, 3), (2, 3))
    plan_ms = _time_ms(lambda: LA._pair_costs(stack, pairs, mbw, mbh), 10)
    print(f"B9: one plan's {len(pairs)} pair searches (_pair_costs, "
          f"bframes 2) {plan_ms:.4f} ms, {plan_ms / len(pairs):.4f} ms per "
          f"pair (the padding and the esa16 wrapper); the {len(pairs)} "
          f"launches alone {len(pairs) * alone['esa16']:.4f} ms, bound "
          f"{len(pairs) * bounds['esa16'][0]:.4f} ms")


def _aq_kernel_phase(clip) -> None:
    """intra_nxn and trellis under a non-uniform QP map, AQ mode 1's on a
    1080p clip frame (_aq_map).  The I4x4/I8x8 core of frame 0 (the 8x8
    transform and trellis: the B-GOP run's graph key) runs eagerly with
    every knight step's NxN call checked: the kernel on copies of the
    state against the plain twin, which carries the state on; then the
    core's CUDA graph, replayed on the same map, equals that eager core in
    every field.  Then the trellis kernel in every layout against its
    twin on the three blockings of a P frame (_trellis_p_shapes) with
    the dequantisation of frame 1's QP map."""
    import torch
    import x264_tpu_torch.models.intra as MI
    from x264_tpu_torch.kernels import intra_nxn as KN
    from x264_tpu_torch.models.graph import run_core
    from x264_tpu_torch.ops.trellis import frame_trellis, trellis_quant_plain
    from x264_tpu_torch.state import me_lambda, sad_lambda
    dev = torch.device("cuda")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    qp_np = _aq_map(clip[0])
    if qp_np.min() == qp_np.max():
        raise AssertionError("AQ gave a uniform QP map")
    print(f"AQ mode 1 QP map of 1080p frame 0 at QP {QP}: {qp_np.min()}-"
          f"{qp_np.max()}, {len(np.unique(qp_np))} distinct values, "
          f"{float((qp_np != QP).mean()):.4f} of the MBs off QP {QP}")
    qp = torch.from_numpy(qp_np).to(dev)
    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    lam = sad_lambda(QP)
    tt = frame_trellis(QP, "I", me_lambda(QP), True)
    kw = dict(mbw=mbw, mbh=mbh, cqp_off=0, lv_cap=96, t8_mode=True)
    seen = dict(steps=0, err=0)

    def checked(ry, grid, ysrc, q, lam_t, d, mbw_, mbh_, t8):
        kry, kgrid = ry.clone(), grid.clone()
        got = KN.nxn_candidates_(kry, kgrid, ysrc, q, lam_t, d, mbw_, mbh_,
                                 t8)
        want = KN.nxn_candidates_plain(ry, grid, ysrc, q, lam_t, d, mbw_,
                                       mbh_, t8)
        seen["err"] = max([seen["err"], _max_err(kry, ry),
                           _max_err(kgrid, grid)]
                          + [_max_err(got[k], want[k]) for k in want
                             if want[k] is not None])
        seen["steps"] += 1
        return want

    real = MI.nxn_candidates
    MI.nxn_candidates = checked
    try:
        eager = MI.i4_frame_core(*planes, qp, lam, trellis_tbl=tt, **kw)
    finally:
        MI.nxn_candidates = real
    steps = mbw + 2 * mbh - 2
    if seen["err"] or seen["steps"] != steps:
        raise AssertionError(f"intra_nxn under the AQ map: max err "
                             f"{seen['err']} over {seen['steps']} steps")
    out = run_core(MI.i4_frame_core, *planes, qp, lam, trellis_tbl=tt, **kw)
    bad = [k for k in eager if not torch.equal(eager[k], out[k])]
    if bad or not torch.equal(out["qp_mb"], qp):
        raise AssertionError(f"I4 graph under the AQ map != the eager core "
                             f"with the plain NxN twin in {bad}")
    hist = np.bincount((out["mb_class"] + out["t8"]).cpu().numpy(),
                       minlength=3)
    print(f"intra_nxn under the AQ map: bit-exact against its plain twin on "
          f"all {steps} knight steps of the eager I4x4/I8x8 core; the "
          f"core's CUDA graph replayed on the map == that core in every "
          f"field (MBs I16 {hist[0]}, I4x4 {hist[1]}, I8x8 {hist[2]})")
    qp_p = _aq_map(clip[1])
    lam2f, shapes = _trellis_p_shapes(clip, torch.from_numpy(qp_p).to(dev))
    for name, c, dq, tbl, nc in shapes:
        lv_p = trellis_quant_plain(c, dq, lam2f, tbl, nc)
        err = max(_max_err(fn(c, dq, lam2f, tbl, nc), lv_p)
                  for fn in _trellis_calls().values())
        nz = int((lv_p != 0).sum())
        if err or not nz:
            raise AssertionError(f"trellis {name} under the AQ map: max err "
                                 f"{err}, {nz} nonzero levels")
        print(f"trellis {name} under frame 1's AQ map (QP {qp_p.min()}-"
              f"{qp_p.max()}): {c.shape[0]} blocks x {nc}, bit-exact in "
              f"every layout, {nz} nonzero levels")


def _lookahead_spies(enc, synced: bool):
    """Wrap the lookahead's host steps of ``enc``: AQ (_aq_qp, which runs
    aq_offsets), the lowres scenecut, Lookahead.plan, lowres_stats8 and
    MB-tree's propagate.  Each call appends (ms, the esa16 and esa_parts
    launches it made, its result when an int: a plan's m) to
    log[step]; with ``synced`` the card is synchronised before and after
    each call, so its ms holds its device work.  Returns (log, restore):
    restore() puts the module functions back."""
    import torch
    import x264_tpu_torch.api as api
    import x264_tpu_torch.models.mbtree as MT
    from x264_tpu_torch.kernels import LAUNCHES
    log = {}

    def wrap(name, fn):
        def run(*a, **k):
            if synced:
                torch.cuda.synchronize()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if synced:
                torch.cuda.synchronize()
            log.setdefault(name, []).append((
                1000 * (time.perf_counter() - t0),
                {x: LAUNCHES[x] - before[x] for x in ("esa16", "esa_parts")},
                out if isinstance(out, int) else None))
            return out
        return run

    enc._aq_qp = wrap("aq_offsets", enc._aq_qp)
    enc._lowres_scenecut = wrap("lowres scenecut", enc._lowres_scenecut)
    la = enc._lookahead()
    la.plan = wrap("plan", la.plan)
    saved = api.lowres_stats8, MT.propagate
    api.lowres_stats8 = wrap("lowres_stats8", api.lowres_stats8)
    MT.propagate = wrap("propagate", MT.propagate)

    def restore():
        api.lowres_stats8, MT.propagate = saved
    return log, restore


def _run_1080p_medium(records):
    """The medium-preset main path (counts reset just before, read just
    after): _medium_params at 1080p on cut_clip (LA_FRAMES frames, a hard
    cut to another scene at LA_CUT, past keyint_min 25), so AQ, the
    lowres scenecut, b_adapt's plans and MB-tree all run.  Prints the
    frame types, each plan's m, the QP range per frame type, bytes,
    kbit/frame, Y-PSNR (every frame decodes to its recon: full_recon is
    on), fps over the frames after the first IDR, the esa16 and esa_parts
    launches the lookahead adds; then from a second run with the card
    synchronised around each step, the host ms per frame of aq_offsets,
    the lowres scenecut, plan, lowres_stats8 and propagate, and the ms
    per I, P and B frame."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    clip = cut_clip(LA_FRAMES, LA_CUT)
    enc = Encoder(_medium_params(W, H), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    qps = []
    submit = enc._submit_device

    def qp_spy(*a, **kw):
        job = submit(*a, **kw)
        q = np.atleast_1d(job["qp_arr"])
        qps.append((job["ftype"], int(q.min()), int(q.max())))
        return job
    enc._submit_device = qp_spy
    log, restore = _lookahead_spies(enc, synced=False)
    stream, times, sizes = b"", [], []
    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    try:
        for y, u, v in clip:
            t0 = time.perf_counter()
            data = enc.encode(Frame420(y, u, v))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            sizes.append(len(data))
            stream += data
        t0 = time.perf_counter()
        stream += enc.flush()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finally:
        restore()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p medium-CRF run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    types = [s.frame_type for s in enc.stats]
    plans = [m for _, _, m in log.get("plan", [])]
    n = len(clip)
    steps = (W + 15) // 16 + 2 * ((H + 15) // 16) - 2
    la_launch = {k: {x: sum(c[1][x] for c in v) for x in ("esa16",
                                                          "esa_parts")}
                 for k, v in log.items()}
    cut_idr = types.count("IDR") > 1
    if len(types) != n or types[0] != "IDR" or \
            not (cut_idr or any(m < 2 for m in plans)) or \
            launches["deblock"] != n or not launches["trellis"] or \
            not launches["intra_nxn"] or launches["intra_nxn"] % steps or \
            launches["cavlc_blocks"] or launches["bitpack"] or \
            la_launch.get("lowres_stats8", {}).get("esa_parts") != n - 1 \
            or la_launch.get("plan", {}).get("esa16") != 8 * len(plans):
        raise AssertionError(f"medium CRF: frame types {types}, plans "
                             f"{plans}, launches {launches}, lookahead "
                             f"launches {la_launch}")
    first = next(i for i, s in enumerate(sizes) if s)
    tail = times[first + 1:]
    byt = {}
    for t, lo, hi in qps + [("B", s.qp, s.qp) for s in enc.stats
                            if s.frame_type == "B"]:
        a = byt.setdefault(t, [lo, hi])
        a[0], a[1] = min(a[0], lo), max(a[1], hi)
    psnr = _check_recon("medium CRF", stream, recons, clip)
    print(f"1080p medium CRF 23 (AQ 1, MB-tree, b_adapt=1, scenecut 40) x"
          f"{n}, cut at {LA_CUT}: frame types (coded order) "
          f"{' '.join(types)}; plans m = {plans}; QP range per frame type "
          + ", ".join(f"{t} {lo}-{hi}" for t, (lo, hi) in byt.items())
          + f"; {len(stream)} bytes, {len(stream) * 8 / n / 1000:.1f} "
          f"kbit/frame, mean Y-PSNR {psnr:.3f} dB; "
          f"{(n - 1) / sum(tail):.3f} fps over display 1-{n - 1} (the "
          f"encode() calls after the one that coded the first IDR, call "
          f"{first}, flush included)")
    print("medium CRF encode() ms: "
          + " ".join(f"{1000 * t:.1f}" for t in times))
    print(f"lookahead launches in the medium CRF run: "
          + ", ".join(f"{k} esa16 {v['esa16']} esa_parts {v['esa_parts']}"
                      for k, v in la_launch.items())
          + f" (of esa16 {launches['esa16']}, esa_parts "
          f"{launches['esa_parts']} in the run)")
    stage = {}
    enc = Encoder(_medium_params(W, H), device="cuda")
    _timed_stages(enc, stage)
    log, restore = _lookahead_spies(enc, synced=True)
    try:
        for y, u, v in clip:
            enc.encode(Frame420(y, u, v))
        enc.flush()
    finally:
        restore()
    types2 = [s.frame_type for s in enc.stats]
    if types2 != types:
        raise AssertionError(f"medium CRF second run: types {types2}")
    print("1080p medium CRF host ms (second run, the card synchronised "
          "around each call): " + "; ".join(
              f"{k} {sum(c[0] for c in v) / n:.2f} per frame ({len(v)} "
              f"calls, {sum(c[0] for c in v) / len(v):.2f} each)"
              for k, v in log.items()))

    def ms(ftype, *names):
        calls = [t for nm in names for t in stage.get((nm, ftype), [])]
        return sum(calls) / max(1, types.count(ftype))
    print("1080p medium CRF ms per frame (second run, stage-synced): "
          + ", ".join(
              f"{f} {ms(k, sub, fin):.1f} (submit {ms(k, sub):.1f}, "
              f"finalize {ms(k, fin):.1f})"
              for f, k, sub, fin in (
                  ("I", "IDR", "_submit_anchor", "_finalize_device"),
                  ("P", "P", "_submit_anchor", "_finalize_device"),
                  ("B", "B", "_submit_b_pair", "_finalize_b"))))


def _check_small_lookahead() -> None:
    """352x288 card stream == CPU stream for the medium preset at CRF 23
    with AQ, MB-tree and b_adapt (fade_clip with a cut, keyint_min 3, so
    the lowres scenecut can fire), and for CAVLC with AQ on I/B/P8x8
    (which reaches cavlc_blocks and bitpack with a per-MB QP)."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    for label, frames, p in (
            ("medium CRF 23, AQ, MB-tree, b_adapt=1",
             fade_clip(CHECK_W, CHECK_H, 9, pan=(1, 1), cut=5),
             _medium_params(CHECK_W, CHECK_H, keyint_min=3)),
            ("CAVLC, AQ, I/B/P8x8",
             split_motion_clip(CHECK_W, CHECK_H, 5),
             _params(CHECK_W, CHECK_H, True, cabac=False, aq_mode=1,
                     bframes=2, me_range=8))):
        small = [Frame420(*f) for f in frames]
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(p, device=d)
            g0 = _graph_count()
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                new_graphs = _graph_count() - g0
                types = [s.frame_type for s in e.stats]
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label}: card stream != CPU "
                                 "stream")
        cavlc = not p.cabac
        if not launches["esa16"] or not launches["esa_parts"] or \
                bool(launches["cavlc_blocks"]) != cavlc or \
                (cavlc and _cavlc_placed(launches, new_graphs,
                                         len(small)) < 0):
            raise AssertionError(f"352x288 {label}: launches {launches}")
        print(f"{CHECK_W}x{CHECK_H} {label} x{len(small)}: card stream == "
              f"CPU stream ({len(streams['cuda'])} bytes), frame types "
              f"{' '.join(types)}, launches {launches}")


def _pir_host_inputs(clip, qp_map):
    """The refresh bar's inputs at 1080p as host arrays: frame 1's
    source, frame 0's source as the live recon planes (int32), the per-MB
    QP map and its chroma QPs, and per-MB fields holding junk the bar
    overwrites at its MBs."""
    from x264_tpu_torch.kernels import pir_column as KR
    from x264_tpu_torch.state import CHROMA_QP_TABLE
    src = [_pad_to_mb(p, s) for p, s in zip(clip[1], (16, 8, 8))]
    rec = [_pad_to_mb(p, s).astype(np.int32)
           for p, s in zip(clip[0], (16, 8, 8))]
    n = qp_map.shape[0]
    qpc = CHROMA_QP_TABLE[np.clip(qp_map, 0, 51)].astype(np.int32)
    rng = np.random.default_rng(12)
    acc = {k: rng.integers(0, 2, (n, *sh)).astype(bool)
           if k in ("intra_mask", "t8")
           else rng.integers(-3, 4, (n, *sh)).astype(np.int32)
           for k, sh in KR._FIELDS}
    return src, rec, qp_map, qpc, acc


def _pir_inputs(clip, qp_map, dev="cuda"):
    """_pir_host_inputs as tensors on dev."""
    import torch
    src, rec, qp, qpc, acc = _pir_host_inputs(clip, qp_map)

    def on(a):
        return torch.from_numpy(a).to(dev)
    return ([on(a) for a in src], [on(a) for a in rec], on(qp), on(qpc),
            {k: on(a) for k, a in acc.items()})


PIR_WIDE = (5, 14, 120)      # bars at keyint 30, 10 and 2 (the whole frame)


def _pir_twin_job(ncols: int) -> dict:
    """The plain twin of a 1080p bar of ncols columns from column 0, on
    the host (a worker process: see _pir_twins_start): its planes and
    fields as arrays."""
    import torch
    torch.set_num_threads(1)
    from x264_tpu_torch.kernels import pir_column as KR
    clip = make_clip(2)
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    src, rec, qp, qpc, acc = _pir_inputs(clip, _aq_map(clip[1]), "cpu")
    out = KR.pir_column_pass_plain(*src, *rec, acc, qp, qpc, 0, mbw, mbh,
                                   ncols)
    return {"planes": [a.numpy() for a in out[:3]],
            "fields": {k: out[3][k].numpy() for k in KR.FIELDS}}


def _pir_twins_start():
    """Start the plain twins of the wide bars (PIR_WIDE) in worker
    processes: some 8000 MBs one after another take about a minute on the
    host, which then overlaps the kernels' build.  _pir_twins_wait takes
    their results before any phase is timed, so that no timing shares the
    host with them."""
    import concurrent.futures as cf
    import multiprocessing as mp
    pool = cf.ProcessPoolExecutor(len(PIR_WIDE),
                                  mp_context=mp.get_context("spawn"))
    return pool, {n: pool.submit(_pir_twin_job, n) for n in PIR_WIDE}


def _pir_twins_wait(twins) -> dict:
    """The results of _pir_twins_start's twins by bar width; its worker
    processes ended."""
    pool, futures = twins
    try:
        return {n: f.result() for n, f in futures.items()}
    finally:
        pool.shutdown(cancel_futures=True)


def _pir_phase(clip, record, int_ops_per_s: float, twins) -> dict:
    """The refresh-bar kernel against its plain twin at 1080p under AQ
    mode 1's QP map, bit-exact on bars of 3 columns at columns 0, 59, 117
    (up to the right edge) and 119 (one live column, two masked); times
    through the wrapper, the launch alone and the plain twin on the
    headline bar (3 columns, the live run's width at keyint 60) with its
    bound; then bars of 5, 14 and 120 columns from column 0, bit-exact
    against twins (the host's twins, as _pir_twins_wait returns them),
    timed.  Each with its wavefront steps, MB warps and shared memory.
    Returns the headline bar's times."""
    import torch
    from x264_tpu_torch.kernels import build
    from x264_tpu_torch.kernels import pir_column as KR
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    qp_map = _aq_map(clip[1])
    src, rec, qp, qpc, acc = _pir_inputs(clip, qp_map)
    lib = build.library()
    tab = KR._tables("cuda:0").data_ptr()
    stream = torch.cuda.current_stream().cuda_stream

    def fresh():
        return ([r.clone() for r in rec], {k: a.clone()
                                           for k, a in acc.items()})

    def timed(ncols):
        """(wrapper ms, launch alone ms) of a bar from column 0."""
        r_k, a_k = fresh()
        ms = _time_ms(lambda: KR.pir_column_pass(
            *src, *r_k, a_k, qp, qpc, 0, mbw, mbh, ncols), 20)
        ptrs = [t.data_ptr() for t in (*src, *r_k, qp, qpc)] + \
            [a_k[k].data_ptr() for k in KR.FIELDS] + [tab]
        alone = _time_ms(lambda: lib.pir_column_launch(
            *ptrs, 0, ncols, mbw, mbh, stream), 20)
        return ms, alone

    for col in (0, 59, 117, 119):
        (r_k, a_k), (r_p, a_p) = fresh(), fresh()
        got = KR.pir_column_pass(*src, *r_k, a_k, qp, qpc, col, mbw, mbh, 3)
        want = KR.pir_column_pass_plain(*src, *r_p, a_p, qp, qpc, col, mbw,
                                        mbh, 3)
        torch.cuda.synchronize()
        err = max([_max_err(a, b) for a, b in zip(got[:3], want[:3])]
                  + [_max_err(got[3][k], want[3][k]) for k in KR.FIELDS])
        live = KR.bar_mbs(col, 3, mbw, mbh)
        if err or int(got[3]["intra_mask"].sum()) < live:
            raise AssertionError(f"pir_column at column {col}: max err "
                                 f"{err}")
        print(f"pir_column at column {col} (3 columns, {live} MBs): "
              "bit-exact against pir_column_pass_plain under the AQ map "
              f"(QPs {int(qp_map.min())}-{int(qp_map.max())})")
    ms, alone = timed(3)
    r_p, a_p = fresh()
    plain = _time_ms(lambda: KR.pir_column_pass_plain(
        *src, *r_p, a_p, qp, qpc, 0, mbw, mbh, 3), 2)
    n_bar = KR.bar_mbs(0, 3, mbw, mbh)
    groups, smem, steps = KR.geometry(0, 3, mbw, mbh)
    nbytes, ops = KR.work(n_bar)
    bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                (ops / int_ops_per_s * 1e3, "operations"))
    print(f"pir_column, a 3-column bar at 1080p ({n_bar} MBs, {steps} "
          f"wavefront steps; {groups} MB warps, {smem} bytes of dynamic "
          f"shared memory): {ms:.4f} ms through the wrapper (its launch "
          f"alone {alone:.4f} ms, {1000 * alone / steps:.3f} us a step, "
          f"{1000 * alone / n_bar:.3f} us an MB), plain twin {plain:.3f} "
          f"ms; bound {bound[0]:.5f} ms by {bound[1]} ({nbytes} bytes, "
          f"{ops} int32 operations)")
    record("pir_column", "x264_tpu_torch/csrc/pir_column.cu",
           "x264_tpu/models/inter_device.py:101", 0, ms, plain, bound)
    for ncols in PIR_WIDE:
        r_k, a_k = fresh()
        got = KR.pir_column_pass(*src, *r_k, a_k, qp, qpc, 0, mbw, mbh,
                                 ncols)
        want = twins[ncols]
        err = max([_max_err(a.cpu(), torch.from_numpy(b))
                   for a, b in zip(got[:3], want["planes"])]
                  + [_max_err(got[3][k].cpu(),
                              torch.from_numpy(want["fields"][k]))
                     for k in KR.FIELDS])
        live = KR.bar_mbs(0, ncols, mbw, mbh)
        if err or int(got[3]["intra_mask"].sum()) < live:
            raise AssertionError(f"pir_column, {ncols} columns: max err "
                                 f"{err}")
        w_ms, w_alone = timed(ncols)
        groups, smem, steps = KR.geometry(0, ncols, mbw, mbh)
        print(f"pir_column, a {ncols}-column bar at 1080p ({live} MBs, "
              f"{steps} wavefront steps; {groups} MB warps, {smem} bytes "
              "of dynamic shared memory): bit-exact against "
              "pir_column_pass_plain (run on the host); "
              f"{w_ms:.4f} ms through the wrapper (its launch alone "
              f"{w_alone:.4f} ms, {1000 * w_alone / steps:.3f} us a "
              f"step, {1000 * w_alone / live:.3f} us an MB)")
    return dict(ms=ms, alone=alone, plain=plain)


LIVE_FRAMES = 41              # IDR + 40 P: one whole sweep of 120 columns
LIVE_VBV = dict(vbv_maxrate=4000, vbv_bufsize=1500)


def _live_params(w: int, h: int, **kw):
    """The live configuration: x264's medium preset with tune zerolatency
    (no B frames, no lookahead; I4x4, the 8x8 transform, trellis,
    weightp=1, CABAC) on P16 anchors (the port refuses intra refresh
    with P8x8: ROADMAP C, fault 3) at CRF 23 and 30 fps, a VBV cap, NAL
    HRD and periodic intra refresh at keyint 60."""
    from x264_tpu_torch.params import RC_CRF, param_default_preset
    base = dict(width=w, height=h, rc_method=RC_CRF, crf=23.0, fps_num=30,
                fps_den=1, nal_hrd=True, intra_refresh=True, keyint_max=60,
                p8x8=False, **LIVE_VBV)
    base.update(kw)
    return param_default_preset("medium", tune="zerolatency").clone(**base)


def _vbv_walk(enc, sizes) -> float:
    """The decoder-buffer walk over the access units' sizes (refill at
    vbv_maxrate, then take the frame): the lowest fill after a frame,
    in bits; raises if a frame does not fit."""
    rc = enc.rc
    fill = rc.vbv_size * enc.p.vbv_init
    low = fill
    for i, nb in enumerate(sizes):
        fill = min(fill + rc.vbv_max / rc.fps, rc.vbv_size)
        if nb * 8 > fill + 1e-6:
            raise AssertionError(f"VBV underflow at access unit {i}: "
                                 f"{nb * 8} bits, fill {fill:.0f}")
        fill -= nb * 8
        low = min(low, fill)
    return low


def _reencode_spy(enc, synced: bool) -> list:
    """Record every VBV re-encode (frame type, old and new QP, ms of the
    core's re-run and deblock with the card synchronised when
    ``synced``)."""
    import torch
    fn = enc._vbv_reencode
    log = []

    def spy(job, nq):
        if synced:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(job, nq)
        if synced:
            torch.cuda.synchronize()
        log.append((job["ftype"], job["qp"], nq,
                    1000 * (time.perf_counter() - t0)))
        return out
    enc._vbv_reencode = spy
    return log


def _run_1080p_live(records, bar_ms: dict):
    """The live main path (counts reset just before, read just after):
    _live_params at 1080p on make_clip, LIVE_FRAMES frames, with
    intra_refresh() before frame 1 so that a whole sweep (3 columns a
    frame at keyint 60) falls in the run.  Fails unless a frame was
    re-encoded, the decoder-buffer walk never goes below zero, every P
    frame of the sweep launched pir_column once and every frame decodes
    to its recon where avdec runs.  Prints fps over the P frames, the
    encode() wall ms (p50, p95, max), kbit/frame, Y-PSNR, the re-encodes
    and their ms, the lowest buffer fill, the launches per P frame and
    the bar's ms."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    clip = make_clip(LIVE_FRAMES)
    enc = Encoder(_live_params(W, H), device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    retries = _reencode_spy(enc, synced=True)
    bars = []
    submit = enc._submit_device

    def bar_spy(*a, **kw):
        job = submit(*a, **kw)
        bars.append(job["pir"] is not None)
        return job
    enc._submit_device = bar_spy
    stream, times = b"", []
    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    for i, (y, u, v) in enumerate(clip):
        if i == 1:
            enc.intra_refresh()
        t0 = time.perf_counter()
        stream += enc.encode(Frame420(y, u, v))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    stream += enc.flush()
    torch.cuda.synchronize()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p live run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    types = [s.frame_type for s in enc.stats]
    n = len(clip)
    n_bar = sum(bars)
    p_retry = sum(1 for t, *_ in retries if t == "P")
    sizes = [m["bytes"] for m in enc.drain_au_meta()]
    low = _vbv_walk(enc, sizes)
    ncols = enc._pir_w()
    if types != ["IDR"] + ["P"] * (n - 1) or not retries or \
            n_bar != min(n - 1, -(-((W + 15) // 16) // ncols)) or \
            launches["pir_column"] < n_bar or \
            launches["pir_column"] > n_bar + p_retry + n_bar or \
            launches["esa16"] < n - 1 or launches["esa_parts"] or \
            launches["deblock"] != n + len(retries) or \
            launches["cavlc_blocks"] or launches["bitpack"]:
        raise AssertionError(f"live: frame types {types}, {n_bar} bars of "
                             f"{ncols} columns, re-encodes {retries}, "
                             f"launches {launches}")
    psnr = _check_recon("live", stream, recons, clip)
    ms = np.array(times) * 1000
    p_ms = ms[1:]
    print(f"1080p live (medium, zerolatency, P16, CRF 23, VBV "
          f"{LIVE_VBV['vbv_maxrate']} kbit/s / {LIVE_VBV['vbv_bufsize']} "
          f"kbit, NAL HRD, intra refresh at keyint 60, {ncols} columns a "
          f"frame) x{n}: {len(stream)} bytes, "
          f"{len(stream) * 8 / n / 1000:.1f} kbit/frame, mean Y-PSNR "
          f"{psnr:.3f} dB; {(n - 1) / (p_ms.sum() / 1000):.3f} fps over "
          f"the P frames; encode() ms p50 {np.percentile(ms, 50):.1f}, p95 "
          f"{np.percentile(ms, 95):.1f}, max {ms.max():.1f} (IDR "
          f"{ms[0]:.1f}, P p50 {np.percentile(p_ms, 50):.1f})")
    print(f"live VBV: {len(retries)} re-encodes ("
          + ", ".join(f"{t} QP {q0}->{q1} {m:.1f} ms (core re-run and "
                      f"deblock)" for t, q0, q1, m in retries)
          + f"); lowest decoder-buffer fill {low / 1000:.1f} kbit of "
          f"{enc.rc.vbv_size / 1000:.0f}; frame QPs "
          + " ".join(str(s.qp) for s in enc.stats))
    print("live launches per P frame: " + ", ".join(
        f"{k} {v / (n - 1):.3f}" for k, v in launches.items() if v)
          + f"; {n_bar} P frames carried a bar")
    print(f"live refresh bar ({ncols} columns, {ncols * ((H + 15) // 16)} "
          f"MBs): kernel alone {bar_ms['alone']:.4f} ms, through its "
          f"wrapper {bar_ms['ms']:.4f} ms, plain twin {bar_ms['plain']:.3f} "
          "ms (the kernel phase's times)")
    print("live encode() ms: " + " ".join(f"{t:.1f}" for t in ms))


def _check_small_live() -> None:
    """352x288 card stream == CPU stream for the live settings: intra
    refresh with CABAC, I4x4, the 8x8 transform and trellis on P16
    anchors; intra refresh with CAVLC and P16; VBV with CAVLC under a
    tight ABR buffer (at least one re-encode); NAL HRD with VBV and
    bframes=2 (P8x8 anchors)."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.params import RC_ABR
    frames = split_motion_clip(CHECK_W, CHECK_H, 6)
    for label, p, want in (
            ("intra refresh, CABAC, I4x4, t8, trellis, P16",
             _params(CHECK_W, CHECK_H, False, intra_refresh=True,
                     keyint_max=4, i4x4=True, **TOOLS), "pir_column"),
            ("intra refresh, CAVLC, P16",
             _params(CHECK_W, CHECK_H, False, cabac=False,
                     intra_refresh=True, keyint_max=4, me_range=8),
             "pir_column"),
            ("VBV, CAVLC, ABR",
             _params(CHECK_W, CHECK_H, False, cabac=False, rc_method=RC_ABR,
                     bitrate=300, vbv_maxrate=300, vbv_bufsize=60,
                     me_range=8), "retry"),
            ("NAL HRD, VBV, bframes=2",
             _params(CHECK_W, CHECK_H, True, rc_method=RC_ABR, bitrate=600,
                     vbv_maxrate=600, vbv_bufsize=300, nal_hrd=True,
                     bframes=2), None)):
        small = [Frame420(*f) for f in frames]
        streams, retries = {}, {}
        for d in ("cuda", "cpu"):
            e = Encoder(p, device=d)
            retries[d] = _reencode_spy(e, synced=False)
            x264_tpu_torch.reset_launch_counts()
            out = b""
            for i, f in enumerate(small):
                if i == 1 and p.intra_refresh:
                    e.intra_refresh()
                out += e.encode(f)
            streams[d] = out + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                types = [s.frame_type for s in e.stats]
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label}: card stream != CPU "
                                 "stream")
        if [r[:3] for r in retries["cuda"]] != \
                [r[:3] for r in retries["cpu"]] or \
                (want == "pir_column" and not launches["pir_column"]) or \
                (want == "retry" and not retries["cuda"]):
            raise AssertionError(f"352x288 {label}: launches {launches}, "
                                 f"re-encodes {retries}")
        if _avdec_available():
            if len(_decode(streams["cuda"], CHECK_W, CHECK_H)) != len(small):
                raise AssertionError(f"352x288 {label}: avdec frame count")
        print(f"{CHECK_W}x{CHECK_H} {label} x{len(small)}: card stream == "
              f"CPU stream ({len(streams['cuda'])} bytes), frame types "
              f"{' '.join(types)}, {len(retries['cuda'])} re-encodes, "
              f"launches {launches}")


UHD_W, UHD_H = 3840, 2160    # BASELINE.json's fifth configuration's frame
UHD_FRAMES = 12              # per pass of the 4K two-pass CLI run
UHD_SLICES = 4
UHD_KBPS = 20000
UF_FRAMES = 30               # the 1080p ultrafast four-slice run


def make_clip_at(w: int, h: int, n: int):
    """make_clip's formula (bench.py's seed) at another frame size."""
    rng = np.random.default_rng(20260816)
    pad = 4 * CLIP_FRAMES
    tex = rng.integers(-24, 25, (h + pad, w + pad)).astype(np.int16)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)
           + np.roll(tex, (1, 1), (0, 1))) // 4
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        dx, dy = 3 * t, 2 * t
        base = (128 + 60 * np.sin((xx + dx) / 41.0)
                * np.cos((yy + dy) / 59.0))
        y = np.clip(base + tex[dy:dy + h, dx:dx + w] + t, 0, 255
                    ).astype(np.uint8)
        u = (128 + 32 * np.sin((xx[::2, ::2] + dx) / 61.0)).astype(np.uint8)
        v = (128 + 32 * np.cos((yy[::2, ::2] + dy) / 59.0)).astype(np.uint8)
        frames.append((y, u, v))
    return frames


def _bands(mbh: int, slices: int) -> list:
    """(first MB row, rows) of each band, as the encoder splits them."""
    nsl = max(1, min(slices, mbh))
    base, rem = divmod(mbh, nsl)
    heights = [base + (1 if i < rem else 0) for i in range(nsl)]
    return list(zip(np.cumsum([0] + heights[:-1]).tolist(), heights))


def _band_planes(frame, y0: int, bh: int, dev):
    """A band's rows of a frame's planes, as views of the whole planes on
    the card."""
    import torch
    planes = [torch.from_numpy(p).to(dev) for p in frame]
    return (planes[0][16 * y0:16 * (y0 + bh)],
            planes[1][8 * y0:8 * (y0 + bh)], planes[2][8 * y0:8 * (y0 + bh)])


def _padded(recon):
    """Reference planes padded as the encoder pads them (PAD luma, PAD//2
    chroma)."""
    from x264_tpu_torch.ops.mc import pad_edge
    from x264_tpu_torch.state import PAD
    return [pad_edge(p, s) for p, s in zip(recon, (PAD, PAD // 2, PAD // 2))]


def _band_refs(padded, y0: int, bh: int):
    """A band's rows of the padded reference planes (PAD and PAD//2 rows
    of the neighbouring bands on each side)."""
    from x264_tpu_torch.state import PAD
    ry, ru, rv = padded
    return (ry[16 * y0:16 * (y0 + bh) + 2 * PAD],
            ru[8 * y0:8 * (y0 + bh) + PAD], rv[8 * y0:8 * (y0 + bh) + PAD])


def _esa_band_check(label, src, ref, lam, mbw, bh, esa_rate) -> None:
    """esa16 on one band at r = 8 against its twin; its time through the
    wrapper, its launch alone and its bound."""
    from x264_tpu_torch.kernels import esa16 as KE
    mv_k, c_k = KE.full_search_16x16(src, ref, lam, 8, mbw, bh)
    mv_p, c_p = KE.full_search_16x16_plain(src, ref, lam, 8, mbw, bh)
    err = max(_max_err(mv_k, mv_p), _max_err(c_k, c_p))
    if err:
        raise AssertionError(f"esa16 disagrees with its twin on the {label} "
                             f"band: {err}")
    ms = _time_ms(lambda: KE.full_search_16x16(src, ref, lam, 8, mbw, bh),
                  20)
    alone = _time_ms(KE.esa_launcher("esa16", KE.OUT_SHAPES, src, ref, lam,
                                     8, mbw, bh)[0], 50)
    plain = _time_ms(lambda: KE.full_search_16x16_plain(src, ref, lam, 8,
                                                        mbw, bh), 3)
    bound = _esa_bound_ms(src, ref, 8, 1, 3, esa_rate)
    print(f"esa16 on the {label} band ({mbw}x{bh} MBs, r = 8): bit-exact, "
          f"{ms:.4f} ms through the wrapper (launch alone {alone:.4f} ms), "
          f"twin {plain:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]}")


def _band_kernel_phase(esa_rate: float, int_ops_per_s: float, v1) -> None:
    """The kernels of the multi-slice path at its band shapes, each
    against its plain twin on the same inputs: esa16 on a 4K band of 34
    and of 33 MB rows (3840x2160 in four slices, 240 MBs wide) and on a
    1080p band of 17 rows (four slices), r = 8; the deblock kernel on a
    4K frame put together from four P bands (superfast: subpel 1,
    CABAC); the CAVLC block coder and packer on a 1080p ultrafast P band
    (fullpel, CAVLC), beside their first design (``v1``)."""
    import torch
    from x264_tpu_torch.kernels import deblock as KD
    from x264_tpu_torch.models.inter import p_band_core
    from x264_tpu_torch.models.intra import i_frame_core
    from x264_tpu_torch.ops import header as HD
    from x264_tpu_torch.ops.deblock import deblock_prep
    from x264_tpu_torch.state import PAD, sad_lambda
    dev = torch.device("cuda")
    lam = sad_lambda(QP)
    uhd = make_clip_at(UHD_W, UHD_H, 2)
    mbw, mbh = UHD_W // 16, (UHD_H + 15) // 16
    uhd = [tuple(_pad_to_mb(p, s) for p, s in zip(f, (16, 8, 8)))
           for f in uhd]
    ref_pad = _padded([torch.from_numpy(uhd[0][0]).to(dev)])[0]
    src = torch.from_numpy(uhd[1][0]).to(dev)
    for y0, bh in _bands(mbh, UHD_SLICES)[::UHD_SLICES - 1]:
        _esa_band_check(f"4K {bh}-row", src[16 * y0:16 * (y0 + bh)],
                        ref_pad[16 * y0:16 * (y0 + bh) + 2 * PAD], lam, mbw,
                        bh, esa_rate)
    # deblock on a 4K P frame of four superfast bands
    padded = _padded([torch.from_numpy(p).to(dev) for p in uhd[0]])
    outs = []
    for y0, bh in _bands(mbh, UHD_SLICES):
        outs.append(p_band_core(*_band_planes(uhd[1], y0, bh, dev),
                                *_band_refs(padded, y0, bh), QP, lam, mbw=mbw,
                                mbh=bh, me_range=8, cqp_off=0, subpel=1,
                                lv_cap=96))
    cat = {k: torch.cat([o[k] for o in outs]) for k in (
        "recon_y", "recon_u", "recon_v", "mb_class", "cbp_luma",
        "cbp_chroma", "luma_nnz", "mv", "qp_mb")}
    n = mbw * mbh
    bs_v, bs_h, qp_mb, qpc_mb = deblock_prep(
        cat["mb_class"], cat["cbp_luma"], cat["cbp_chroma"],
        cat["luma_nnz"], cat["mv"], torch.zeros(n, dtype=torch.int32,
                                                device=dev),
        cat["qp_mb"], mbw, mbh)
    ry, ru, rv = cat["recon_y"], cat["recon_u"], cat["recon_v"]
    out_k = KD.deblock_filter(ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb, 0, 0,
                              mbw, mbh)
    # the twin takes seconds at 4K: its one run, timed, is its time
    t0 = time.perf_counter()
    out_p = KD.deblock_filter_plain(ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb,
                                    0, 0, mbw, mbh)
    torch.cuda.synchronize()
    plain = 1000 * (time.perf_counter() - t0)
    err = max(_max_err(a, b) for a, b in zip(out_k, out_p))
    if err:
        raise AssertionError(f"deblock disagrees with its twin on the 4K "
                             f"sliced P frame: {err}")
    ms = _time_ms(lambda: KD.deblock_filter(ry, ru, rv, bs_v, bs_h, qp_mb,
                                            qpc_mb, 0, 0, mbw, mbh), 10)
    alone = _deblock_kernel_only_ms(KD, ry, ru, rv, bs_v, bs_h, qp_mb,
                                    qpc_mb, mbw, mbh, 10)
    from x264_tpu_torch.kernels import build
    bound = _deblock_bound_ms(build.library(), (ry, ru, rv),
                              (bs_v, bs_h, qp_mb, qpc_mb), mbw, mbh)
    print(f"deblock on the 4K frame of four P bands ({mbw}x{mbh} MBs): "
          f"bit-exact, {ms:.4f} ms through the wrapper (launch alone "
          f"{alone:.4f} ms), twin {plain:.3f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]}")
    del uhd, outs, cat, out_k, out_p, padded, ref_pad, src
    # a 1080p ultrafast P band: esa16 and the CAVLC pair
    hd = [tuple(_pad_to_mb(p, s) for p, s in zip(f, (16, 8, 8)))
          for f in make_clip(2)]
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    y0, bh = _bands(mbh, 4)[1]
    planes = [torch.from_numpy(p).to(dev) for p in hd[0]]
    rec_i = i_frame_core(*planes, QP, mbw=mbw, mbh=mbh, cqp_off=0,
                         n_words=64)
    refs = _band_refs(_padded([rec_i[k] for k in ("recon_y", "recon_u",
                                                  "recon_v")]), y0, bh)
    src = _band_planes(hd[1], y0, bh, dev)
    _esa_band_check(f"1080p {bh}-row", src[0], refs[0], lam, mbw, bh,
                    esa_rate)
    out = p_band_core(*src, *refs, QP, lam, mbw=mbw, mbh=bh, me_range=8,
                      cqp_off=0, subpel=0, n_words=64)
    intra = out["mb_class"] == 0
    hdr = HD.header_slots(out["mb_class"], out["i16_mode"],
                          out["chroma_mode"], out["mvd"], out["cbp_luma"],
                          out["cbp_chroma"], out["qp_mb"], is_p_slice=True,
                          ref=out["ref_mb"], num_ref=1)
    _cavlc_compare(f"1080p ultrafast {bh}-row P band",
                   [out[k] for k in _FIELD_KEYS] + [intra], hdr, mbw, bh, v1,
                   int_ops_per_s, 3)


class _BandTimes:
    """Spies on the encoder class's band loop: CUDA events around every
    band's core (its time on the card's timeline, no synchronisation
    added), the band re-runs, and the sliced frames' submits."""

    def __init__(self):
        from x264_tpu_torch.api import Encoder
        self.cls = Encoder
        self.saved = {k: getattr(Encoder, k) for k in
                      ("_band_core", "_rerun_band")}
        self.events, self.reruns = [], []
        spy = self

        def band_core(enc, job, b, n_words):
            import torch
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = spy.saved["_band_core"](enc, job, b, n_words)
            e1.record()
            spy.events.append((job["ftype"], job["heights"][b], e0, e1))
            return out

        def rerun(enc, job, b, n_words):
            spy.reruns.append((job["ftype"], b, n_words))
            return spy.saved["_rerun_band"](enc, job, b, n_words)

        Encoder._band_core = band_core
        Encoder._rerun_band = rerun

    def close(self) -> dict:
        """Restore the class; ms of the bands by (frame type, rows)."""
        import torch
        for k, fn in self.saved.items():
            setattr(self.cls, k, fn)
        torch.cuda.synchronize()
        ms = {}
        for ftype, bh, e0, e1 in self.events:
            ms.setdefault((ftype, bh), []).append(e0.elapsed_time(e1))
        return ms


def _band_ms_line(ms: dict) -> str:
    return "; ".join(f"{t} bands of {bh} rows: {len(v)}, ms p50 "
                     f"{np.percentile(v, 50):.2f} min {min(v):.2f} max "
                     f"{max(v):.2f}" for (t, bh), v in sorted(ms.items()))


def _graph_keys(shapes) -> str:
    """The I16 core graphs captured for band planes of these luma shapes:
    rows, entropy rung and capture ms of each."""
    from x264_tpu_torch.models import graph
    keys = sorted((k[2][0] // 16, dict(k[5]), g.capture_ms)
                  for k, g in graph._GRAPHS.items()
                  if k[0] == "i_frame_core" and k[2] in shapes)
    return ", ".join(f"{rows} rows at {st.get('lv_cap') or st.get('n_words')}"
                     f" ({'levels' if 'lv_cap' in st else 'words'}) a MB: "
                     f"capture {ms:.1f} ms" for rows, st, ms in keys)


def _slice_counts(stream: bytes) -> list:
    """Slice NALs (types 1 and 5) per access unit, an access unit
    starting at a slice whose first_mb (its first ue) is 0."""
    import re
    counts = []
    for m in re.finditer(b"\x00\x00\x01", stream):
        i = m.end()
        if i < len(stream) and stream[i] & 31 in (1, 5):
            first_bit = stream[i + 1] >> 7   # ue(0) is the bit '1'
            if first_bit:
                counts.append(0)
            counts[-1] += 1
    return counts


def _run_4k_cli(records) -> None:
    """BASELINE.json's fifth configuration on one card through the port's
    CLI (``cli.main``): 3840x2160 from a y4m written from make_clip's
    formula, x264's superfast preset on 4 slices at 20000 kbit/s ABR, 30
    fps, two passes of UHD_FRAMES frames (``--pass 1``, then ``--pass 2
    --stats``).  Counts reset just before each pass and read just after.
    Fails unless every frame has 4 slices, esa16 launched once per P band
    and deblock once per frame.  Prints fps per pass (the CLI's own
    line), kbit/frame against the target, the mean Y-PSNR of the port's
    recon (``--psnr``), the I16 graph keys with their capture ms, the ms
    per band, the band re-runs and the launches per frame."""
    import contextlib
    import io
    import torch
    import x264_tpu_torch
    from x264_tpu_torch import cli
    from x264_tpu_torch.utils.y4m import write_y4m
    from x264_tpu_torch.utils.yuv import Frame420
    mbh = (UHD_H + 15) // 16
    bands = _bands(mbh, UHD_SLICES)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "uhd.y4m")
        write_y4m(src, [Frame420(*f) for f in
                        make_clip_at(UHD_W, UHD_H, UHD_FRAMES)], (30, 1))
        print(f"4K y4m: {UHD_FRAMES} frames {UHD_W}x{UHD_H} written in "
              f"{time.perf_counter() - t0:.1f} s")
        log = os.path.join(td, "2pass.log")
        target = UHD_KBPS / 30.0
        for p in (1, 2):
            out = os.path.join(td, f"pass{p}.264")
            args = [src, "-o", out, "--preset", "superfast", "--slices",
                    str(UHD_SLICES), "--bitrate", str(UHD_KBPS), "--fps",
                    "30", "--pass", str(p), "--stats", log, "--frames",
                    str(UHD_FRAMES), "--psnr", "--quiet", "--device",
                    "cuda"]
            spy = _BandTimes()
            err = io.StringIO()
            torch.cuda.synchronize()
            x264_tpu_torch.reset_launch_counts()
            try:
                with contextlib.redirect_stderr(err):
                    rc = cli.main(args)
                torch.cuda.synchronize()
            finally:
                band_ms = spy.close()
            launches = x264_tpu_torch.launch_counts()
            for r in records:
                r["launches"] += launches[r["name"]]
            text = err.getvalue()
            with open(out, "rb") as f:
                stream = f.read()
            counts = _slice_counts(stream)
            n_p = UHD_FRAMES - 1
            p_reruns = sum(1 for t, *_ in spy.reruns if t == "P")
            if rc != 0 or counts != [UHD_SLICES] * UHD_FRAMES or \
                    launches["esa16"] != UHD_SLICES * n_p + p_reruns or \
                    launches["deblock"] != UHD_FRAMES or \
                    "PSNR Mean Y" not in text:
                raise AssertionError(f"4K CLI pass {p}: rc {rc}, slices per "
                                     f"frame {counts}, launches {launches}, "
                                     f"stderr {text[-2000:]}")
            lines = [ln.strip() for ln in text.replace("\r", "\n")
                     .splitlines() if ln.strip()]
            psnr = float([ln for ln in lines if "PSNR Mean Y" in ln][0]
                         .split()[3])
            if not 25.0 < psnr < 99.0:
                raise AssertionError(f"4K CLI pass {p}: Y-PSNR {psnr}")
            kbit = len(stream) * 8 / UHD_FRAMES / 1000
            print(f"4K CLI pass {p} (superfast, {UHD_SLICES} slices, "
                  f"{UHD_KBPS} kbit/s ABR, 30 fps) x{UHD_FRAMES}: "
                  + [ln for ln in lines if ln.startswith("encoded")][0]
                  + f"; {len(stream)} bytes, {kbit:.1f} kbit/frame against "
                  f"{target:.1f} targeted; mean Y-PSNR {psnr:.3f} dB (the "
                  "port's recon, the CLI's --psnr)")
            print(f"4K CLI pass {p} launches: {launches}; per frame: "
                  f"esa16 {launches['esa16'] / UHD_FRAMES:.3f} "
                  f"({launches['esa16'] / n_p:.3f} per P frame), deblock "
                  f"{launches['deblock'] / UHD_FRAMES:.3f}")
            print(f"4K CLI pass {p} band ms (CUDA events around each "
                  f"band's core): {_band_ms_line(band_ms)}; band re-runs "
                  f"{spy.reruns}")
    shapes = {(16 * bh, UHD_W) for _, bh in bands}
    print("4K I16 graph keys: " + _graph_keys(shapes))


def _run_1080p_ultrafast(records) -> None:
    """The low-latency live and screen-capture setting through the API
    (counts reset just before, read just after): x264's ultrafast preset
    (fullpel only, CAVLC, no deblock) with tune zerolatency on 4 slices
    at CRF 23, UF_FRAMES frames of make_clip at 1080p.  Fails unless
    every P frame launched esa16 and cavlc_blocks 4 times each and
    bitpack 8 (one a band, and the band's placement; more only where a
    band re-ran) and deblock never.
    Prints fps over the P frames, encode() ms p50/p95/max, kbit/frame,
    Y-PSNR and the launches per P frame, the ms per band and the I16
    graph keys."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.params import RC_CRF, param_default_preset
    clip = make_clip(UF_FRAMES)
    p = param_default_preset("ultrafast", tune="zerolatency").clone(
        width=W, height=H, rc_method=RC_CRF, crf=23.0, fps_num=30,
        fps_den=1, slices=4)
    enc = Encoder(p, device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    spy = _BandTimes()
    appends = _AppendSpy()
    stream, times = b"", []
    g0 = _graph_count()
    try:
        torch.cuda.synchronize()
        x264_tpu_torch.reset_launch_counts()
        for i, (y, u, v) in enumerate(clip):
            t0 = time.perf_counter()
            stream += enc.encode(Frame420(y, u, v))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                after_idr = x264_tpu_torch.launch_counts()
        stream += enc.flush()
        torch.cuda.synchronize()
    finally:
        band_ms = spy.close()
        appends.close()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p ultrafast run: {launches}")
    print(appends.line("1080p ultrafast (4 slices)", len(clip)))
    if appends.merges or len(appends.calls) != 4 * len(clip):
        raise AssertionError(f"ultrafast: {len(appends.calls)} appends for "
                             f"{len(clip)} frames of 4 slices, "
                             f"{appends.merges} host merges")
    for r in records:
        r["launches"] += launches[r["name"]]
    n_p = len(clip) - 1
    per_p = {k: (launches[k] - after_idr[k]) / n_p for k in launches}
    reruns = sum(1 for t, *_ in spy.reruns if t == "P")
    types = [s.frame_type for s in enc.stats]
    if types != ["IDR"] + ["P"] * n_p or \
            launches["esa16"] != 4 * n_p + reruns or launches["deblock"] or \
            not 4 * n_p <= launches["cavlc_blocks"] - after_idr[
                "cavlc_blocks"] <= 4 * n_p + reruns or \
            _cavlc_placed(launches, _graph_count() - g0,
                          4 * len(clip)) < 0 or \
            _slice_counts(stream) != [4] * len(clip):
        raise AssertionError(f"ultrafast: types {types}, launches "
                             f"{launches}, after the IDR {after_idr}, "
                             f"re-runs {spy.reruns}")
    psnr = _check_recon("ultrafast", stream, recons, clip)
    ms = np.array(times) * 1000
    print(f"1080p ultrafast (tune zerolatency, 4 slices, CRF 23, CAVLC, "
          f"fullpel, no deblock) x{len(clip)}: {len(stream)} bytes, "
          f"{len(stream) * 8 / len(clip) / 1000:.1f} kbit/frame, mean "
          f"Y-PSNR {psnr:.3f} dB; {n_p / (ms[1:].sum() / 1000):.3f} fps "
          f"over the P frames; encode() ms p50 {np.percentile(ms, 50):.1f}, "
          f"p95 {np.percentile(ms, 95):.1f}, max {ms.max():.1f} (IDR "
          f"{ms[0]:.1f})")
    print("ultrafast launches per P frame: " + ", ".join(
        f"{k} {v:.3f}" for k, v in per_p.items() if v)
        + f"; band re-runs {spy.reruns}")
    print(f"ultrafast band ms (CUDA events around each band's core): "
          f"{_band_ms_line(band_ms)}")
    print("ultrafast I16 graph keys: " + _graph_keys({(16 * 17, W)}))
    print("ultrafast encode() ms: " + " ".join(f"{t:.1f}" for t in ms))


def _check_small_slices() -> None:
    """352x288 card stream == CPU stream for the multi-slice and fullpel
    settings: 4 slices (bands of 5, 5, 4 and 4 MB rows) with CABAC under
    ABR, and with CAVLC; ultrafast with bframes=2; and noise at QP
    12 with CAVLC on 4 slices, whose bands re-run at the second rung
    (the same re-runs on both)."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.params import RC_ABR, param_default_preset
    rng = np.random.default_rng(14)
    noise = [tuple(rng.integers(0, 256, s).astype(np.uint8) for s in
                   ((CHECK_H, CHECK_W), (CHECK_H // 2, CHECK_W // 2),
                    (CHECK_H // 2, CHECK_W // 2))) for _ in range(2)]
    motion = split_motion_clip(CHECK_W, CHECK_H, CHECK_FRAMES)
    for label, p, frames, want in (
            ("4 slices, CABAC, ABR",
             _params(CHECK_W, CHECK_H, False, slices=4, rc_method=RC_ABR,
                     bitrate=400, me_range=8), motion, "esa16"),
            ("4 slices, CAVLC",
             _params(CHECK_W, CHECK_H, False, slices=4, cabac=False,
                     me_range=8), motion, "cavlc_blocks"),
            ("ultrafast, bframes=2",
             param_default_preset("ultrafast").clone(
                 width=CHECK_W, height=CHECK_H, bframes=2), motion, "esa16"),
            ("4 slices, CAVLC, noise at QP 12 (band re-runs)",
             _params(CHECK_W, CHECK_H, False, slices=4, cabac=False, qp=12,
                     me_range=8), noise, "rerun")):
        small = [Frame420(*f) for f in frames]
        streams, reruns = {}, {}
        for d in ("cuda", "cpu"):
            e = Encoder(p, device=d)
            log = reruns[d] = []
            run = e._rerun_band

            def spy(job, b, n_words, run=run, log=log):
                log.append((b, n_words))
                return run(job, b, n_words)
            e._rerun_band = spy
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label}: card stream != CPU "
                                 "stream")
        if reruns["cuda"] != reruns["cpu"] or \
                (want == "rerun" and not reruns["cuda"]) or \
                (want != "rerun" and not launches[want]):
            raise AssertionError(f"352x288 {label}: launches {launches}, "
                                 f"re-runs {reruns}")
        slices = _slice_counts(streams["cuda"])
        if p.slices > 1 and slices != [p.slices] * len(small):
            raise AssertionError(f"352x288 {label}: slices {slices}")
        if _avdec_available():
            if len(_decode(streams["cuda"], CHECK_W, CHECK_H)) != len(small):
                raise AssertionError(f"352x288 {label}: avdec frame count")
        print(f"{CHECK_W}x{CHECK_H} {label} x{len(small)}: card stream == "
              f"CPU stream ({len(streams['cuda'])} bytes), slices per "
              f"frame {slices}, band re-runs {reruns['cuda']}, launches "
              f"{launches}")


# ---- the band mesh (ROADMAP A15, parallel/sliced.py): threads > 1 ----

MESH_FRAMES = 4              # IDR + 3 P frames of ultrafast on 4 slices


def _mesh_params(**kw):
    """x264's ultrafast preset (fullpel, CAVLC, no deblock) on 4 slices at
    CQP 26 at 1080p: 4 bands of 17 MB rows."""
    from x264_tpu_torch.params import param_default_preset
    base = dict(width=W, height=H, qp=QP, slices=4, fps_num=30, fps_den=1)
    base.update(kw)
    return param_default_preset("ultrafast").clone(**base)


def _mesh_fields(out: dict) -> dict:
    """A band's outputs as host arrays: the fields, the blob's columns
    after its words and the placed payload (``_host_copies``' copies)."""
    return {k: (v.numpy() if k in ("host_blob", "host_payload")
                else v.cpu().numpy()) for k, v in out.items()}


def _mesh_equal(label: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{label}: fields {sorted(got)} != "
                             f"{sorted(want)}")
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{label}: field {k} differs")


def _mesh_syncs(fn) -> list:
    """The synchronising CUDA calls (torch.cuda.set_sync_debug_mode) that
    fn() makes, each at its innermost frame in x264_tpu_torch."""
    import traceback
    import warnings
    import torch
    sites = []

    here = os.path.dirname(os.path.abspath(__file__))

    def show(message, category, filename, lineno, file=None, line=None):
        # the mode's own notice that it is a prototype is no sync
        if "called a synchronizing" not in str(message):
            return
        st = [f"{os.path.relpath(f.filename, here)}:{f.lineno} {f.name}"
              for f in traceback.extract_stack()[:-1]
              if f.filename.startswith(here)]
        sites.append(st[-1] if st else f"{filename}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def _run_1080p_mesh(records) -> None:
    """The band mesh (``threads`` > 1; parallel/sliced.py).  (a) On every
    host: the 1080p ultrafast clip (IDR + 3 P, 4 slices of 17 MB rows,
    fullpel, CAVLC at 64 words) through the encoder's band loop
    (threads=1), each P band's outputs kept (``_host_copies``' input and
    output); then, counts reset just before and read just after, the step
    over card 0 four times (``build_sliced_p_step``) on each P frame's
    planes and padded references, with each band's blob placed as the
    encoder places it: every field, the blob and the payload equal the
    loop's at tolerance 0, and esa16, cavlc_blocks and bitpack launched 4,
    4 and 8 times a P frame.  A noise frame at QP 12 over the first P
    frame's references: a band overflows 64 words, and the loop's re-run
    at 416 (``_rerun_band``) equals the step's band at 416 and the
    encoder's mesh re-run on the band's card.  The synchronising CUDA
    calls inside one warm step (torch.cuda.set_sync_debug_mode).  ms per
    P frame of the step and of the loop's four bands (host clock, card
    synchronised).  (b) With two or more cards: the clip encoded with
    slices = threads = n (4, or 2 on a host of 2 or 3 cards) and with
    threads=1, counts reset and read around the mesh encode: equal
    streams, the mesh taken on every P frame, its cards, and encode() ms
    per P frame of each, after an untimed encode that makes each card's
    first use.  Fails on any difference; (b) is said not to
    run on a host of one card."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.kernels.bitpack import place
    from x264_tpu_torch.parallel import sliced
    from x264_tpu_torch.state import sad_lambda
    smi = _smi("name,power.limit")
    clip = make_clip(MESH_FRAMES)
    p = _mesh_params()
    enc = Encoder(p, device="cuda")
    kept, jobs = [], []
    host_copies = enc._host_copies

    def keep(out, n_words):
        fields = dict(out)
        res = host_copies(out, n_words)
        kept.append((fields, res))
        return res

    enc._host_copies = keep
    submit = enc._submit_device_sliced

    def keep_job(*a):
        job = submit(*a)
        jobs.append(job)
        return job

    enc._submit_device_sliced = keep_job
    loop_ms = []
    for i, f in enumerate(clip):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(Frame420(*f))
        torch.cuda.synchronize()
        if i:
            loop_ms.append(1000 * (time.perf_counter() - t0))
    enc.flush()
    del enc._host_copies, enc._submit_device_sliced
    p_jobs = [j for j in jobs if not j["idr"]]
    if len(p_jobs) != MESH_FRAMES - 1 or len(kept) != 4 * MESH_FRAMES or \
            any(j["heights"] != [17] * 4 for j in p_jobs):
        raise AssertionError(f"mesh (a): {len(p_jobs)} P jobs, {len(kept)} "
                             "bands")
    loop = [[_mesh_fields(res) for _, res in kept[4 * i:4 * i + 4]]
            for i in range(1, MESH_FRAMES)]
    dev0 = torch.device("cuda", 0)
    kw = dict(mbw=W // 16, mbh_per_band=17, me_range=p.me_range,
              cqp_off=p.chroma_qp_offset, subpel=p.subpel)
    step, _ = sliced.build_sliced_p_step([dev0] * 4, n_words=64, **kw)

    def mesh_frame(job, stp=step, n_words=64):
        outs = stp.bands(*job["planes"], *job["refpads"], job["qp"],
                         sad_lambda(job["qp"]))
        for d, o in zip(stp.devices, outs):
            with sliced.on_card(d):
                enc._host_copies(o, n_words)
        return outs

    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    mesh = [[_mesh_fields(o) for o in mesh_frame(j)] for j in p_jobs]
    torch.cuda.synchronize()
    launches = x264_tpu_torch.launch_counts()
    for r in records:
        r["launches"] += launches[r["name"]]
    n_p = len(p_jobs)
    want = {"esa16": 4 * n_p, "cavlc_blocks": 4 * n_p, "bitpack": 8 * n_p}
    if {k: launches[k] for k in want} != want or any(
            v for k, v in launches.items() if k not in want):
        raise AssertionError(f"mesh (a): launches {launches}, want {want}")
    for i, (m, lp) in enumerate(zip(mesh, loop)):
        for b in range(4):
            _mesh_equal(f"mesh (a) P frame {i + 1} band {b}", m[b], lp[b])
    # ms per P frame: the step (bands, placement, the deblock fields
    # gathered) against the loop's four bands, on one card
    keys = ("recon_y", "recon_u", "recon_v", "mb_class", "luma_nnz",
            "cbp_luma", "cbp_chroma", "qp_mb", "mv")
    step_ms, bands_ms = [], []
    for job in p_jobs:
        for dst, fn in ((step_ms, lambda: sliced.gather(
                mesh_frame(job), keys, dev0)),
                        (bands_ms, lambda: sliced.gather(
                            [enc._band_core(job, b, 64) for b in range(4)],
                            keys, dev0))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dst.append(1000 * (time.perf_counter() - t0))
    syncs = _mesh_syncs(lambda: sliced.gather(mesh_frame(p_jobs[-1]),
                                              keys, dev0))
    # the check's control: a tensor made from host data on the card
    control = _mesh_syncs(lambda: torch.tensor([1, 2], device=dev0))
    if len(control) != 1:
        raise AssertionError(f"mesh (a): the sync check saw {control} in "
                             "a copy from pageable memory")
    print(f"band mesh (a): the step over {[str(d) for d in step.devices]} "
          f"== the band loop, every field, blob and payload, on {n_p} "
          f"1080p ultrafast P frames of 4 bands of 17 MB rows; launches "
          f"{launches}")
    print(f"band mesh (a) ms per P frame on one card ({smi}): step "
          + " ".join(f"{t:.2f}" for t in step_ms) + "; loop's four bands "
          + " ".join(f"{t:.2f}" for t in bands_ms) + "; encode() with the "
          "loop " + " ".join(f"{t:.2f}" for t in loop_ms))
    print(f"band mesh (a) synchronising CUDA calls in one warm step, its "
          f"placement and gather (torch.cuda.set_sync_debug_mode; its "
          f"control, a tensor from host data, shows {len(control)}): "
          f"{len(syncs)}: {', '.join(syncs) or 'none'}")
    # a band re-run at the second rung inside a mesh frame
    rng = np.random.default_rng(14)
    noise = [torch.from_numpy(_pad_to_mb(rng.integers(0, 256, (H // q, W // q))
                                         .astype(np.uint8), 16 // q)).to(dev0)
             for q in (1, 2, 2)]
    job = dict(p_jobs[0], planes=noise, qp=12, devices=None)
    first = [_mesh_fields(o) for o in mesh_frame(job)]
    over = [b for b, f in enumerate(first)
            if f["host_blob"][:, 0].max() > 32 * 64]
    if not over:
        raise AssertionError("mesh (a): no band of the noise frame "
                             "overflows 64 words")
    b = over[0]
    step416, _ = sliced.build_sliced_p_step([dev0] * 4, n_words=416, **kw)
    m416 = _mesh_fields(mesh_frame(job, step416, 416)[b])
    l416 = _mesh_fields(enc._rerun_band(job, b, 416))
    e416 = _mesh_fields(enc._rerun_band(dict(job, devices=[dev0] * 4), b,
                                        416))
    _mesh_equal(f"mesh (a) re-run of band {b} at 416", m416, l416)
    _mesh_equal(f"mesh (a) encoder's mesh re-run of band {b}", e416, l416)
    print(f"band mesh (a): noise at QP 12, bands {over} overflow 64 words; "
          f"band {b} re-run at 416: the step's == the loop's == the "
          f"encoder's mesh re-run (max nbits "
          f"{int(l416['host_blob'][:, 0].max())})")
    # (b) the encoder across cards
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        print(f"band mesh (b): not run: the host has {n_dev} card; the mesh "
              "across cards needs 2 or more (on one card the encoder runs "
              "the band loop, as the reference does with fewer devices "
              "than bands)")
        return
    n = 4 if n_dev >= 4 else 2
    # each card's first use (its context, tables and caches) before the
    # timed encodes
    warm = Encoder(_mesh_params(slices=n, threads=n), device="cuda")
    for f in clip[:2]:
        warm.encode(Frame420(*f))
    warm.flush()
    streams, ms, calls = {}, {}, []
    bands = sliced.SlicedPStep.bands

    def spy(self, *a):
        calls.append([str(d) for d in self.devices])
        return bands(self, *a)

    for threads in (n, 1):
        e = Encoder(_mesh_params(slices=n, threads=threads), device="cuda")
        sliced.SlicedPStep.bands = spy if threads > 1 else bands
        t, out = [], b""
        try:
            torch.cuda.synchronize()
            if threads > 1:
                x264_tpu_torch.reset_launch_counts()
            for i, f in enumerate(clip):
                t0 = time.perf_counter()
                out += e.encode(Frame420(*f))
                for d in range(n):
                    torch.cuda.synchronize(d)
                if i:
                    t.append(1000 * (time.perf_counter() - t0))
            out += e.flush()
            for d in range(n):
                torch.cuda.synchronize(d)
            if threads > 1:
                launches = x264_tpu_torch.launch_counts()
        finally:
            sliced.SlicedPStep.bands = bands
        streams[threads], ms[threads] = out, t
    for r in records:
        r["launches"] += launches[r["name"]]
    if streams[n] != streams[1] or len(calls) != MESH_FRAMES - 1 or \
            launches["esa16"] < n * (MESH_FRAMES - 1):
        raise AssertionError(f"mesh (b): streams equal "
                             f"{streams[n] == streams[1]}, mesh calls "
                             f"{calls}, launches {launches}")
    print(f"band mesh (b): {n} slices on {calls[0]}: stream == the one-"
          f"card loop's ({len(streams[n])} bytes), the mesh on every P "
          f"frame; launches {launches}")
    print(f"band mesh (b) encode() ms per P frame ({smi}, {n_dev} cards): "
          f"threads={n} " + " ".join(f"{x:.2f}" for x in ms[n])
          + "; threads=1 " + " ".join(f"{x:.2f}" for x in ms[1]))


# ---- the host-syntax path (ROADMAP A16): I4x4 with CAVLC, the
# device_host_entropy and reference backends ----

def syntax_clip(w: int, h: int, n: int, cut=None):
    """A pan over texture where each intra class wins somewhere (a sine
    field with noise, 45-degree stripes of 3-px grain on a third of the
    MBs, which pick I4x4, ramps on a fifth), seed 15; from frame ``cut``
    on a still noise scene that inter prediction cannot follow (the
    syntax path's scenecut promotes it)."""
    rng = np.random.default_rng(15)
    yy, xx = np.mgrid[0:h + 2 * n, 0:w + 3 * n]
    y = 120 + 70 * np.sin(xx / 11) * np.cos(yy / 8) \
        + rng.integers(0, 9, yy.shape)
    mbx, mby = xx // 16, yy // 16
    y = np.where((mbx + mby) % 3 == 0,
                 np.where(((xx + yy) // 3) % 2 == 0, 40, 210), y)
    y = np.where((mbx + 2 * mby) % 5 == 1, 60 + xx // 4, y)
    y = np.clip(y, 0, 255).astype(np.uint8)
    u = (128 + 40 * np.sin(xx[::2, ::2] / 7)).astype(np.uint8)
    v = (128 + 40 * np.cos(yy[::2, ::2] / 5)).astype(np.uint8)
    noise = [rng.integers(0, 256, sh, dtype=np.uint8)
             for sh in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    frames = []
    for t in range(n):
        if cut is not None and t >= cut:
            frames.append(tuple(noise))
            continue
        frames.append(tuple(np.ascontiguousarray(p) for p in (
            y[t:t + h, 2 * t:2 * t + w], u[t:t + h // 2, t:t + w // 2],
            v[:h // 2, t:t + w // 2])))
    return frames


def _fastdecode_params(w: int, h: int, **kw):
    """x264's medium preset with tune fastdecode (CAVLC, no deblock, no
    weightp, P16 anchors, no 8x8 transform, no trellis; I4x4 and two B
    frames stay) at CRF 23 with AQ mode 1, MB-tree and b_adapt=1: the
    host-syntax path (I4x4 with CAVLC)."""
    from x264_tpu_torch.params import RC_CRF, param_default_preset
    return param_default_preset("medium", "fastdecode").clone(
        width=w, height=h, rc_method=RC_CRF, crf=23.0, aq_mode=1,
        mbtree=True, b_adapt=1, **kw)


def _syntax_spies(enc) -> dict:
    """Wrap the host-syntax path's steps of ``enc``, the card synchronised
    after each: an anchor's whole encode (_encode_frame_syn, keyed by the
    type it coded), its writer (_syn_slice: the slice header and the
    CABAC coder or the CAVLC writers, keyed "writer IDR" or "writer P",
    with the IDR's count of I4x4 MBs) and a B frame's submit and
    finalize (keyed "B").  Returns the log: key -> list of (ms, I4x4
    MBs or None)."""
    import torch
    from x264_tpu_torch.models.syntax import MB_I4
    log = {}

    def wrap(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            ms = 1000 * (time.perf_counter() - t0)
            kk, i4 = key(a)
            log.setdefault(kk, []).append((ms, i4))
            return out
        return run

    enc._encode_frame_syn = wrap(enc._encode_frame_syn,
                                 lambda a: (enc.stats[-1].frame_type, None))
    enc._syn_slice = wrap(enc._syn_slice, lambda a: (
        "writer IDR" if a[2] else "writer P",
        int((a[0].mb_class == MB_I4).sum()) if a[2] else None))
    enc._submit_b = wrap(enc._submit_b, lambda a: ("B submit", None))
    enc._finalize_b = wrap(enc._finalize_b, lambda a: ("B finalize", None))
    return log


def _run_1080p_syntax(label, clip, params, records) -> tuple:
    """One run of the host-syntax path at 1080p (counts reset just before,
    read just after): each encode() call's ms (the card synchronised at
    its end), fps over the calls after the one that coded the first IDR
    (flush included), bytes, kbit/frame, Y-PSNR (where avdec runs, every
    frame's decode equals its recon), the frame types, ms per frame by
    type and the writer's host ms per IDR and per P anchor (the spies of
    _syntax_spies); adds the launches to ``records``.  Returns
    (launches, frame types, the spies' log)."""
    import torch
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    enc = Encoder(params, device="cuda")
    recons = {}
    enc.recon_hook = recons.__setitem__
    log = _syntax_spies(enc)
    la_log, restore = _lookahead_spies(enc, synced=False)
    stream, times, sizes = b"", [], []
    torch.cuda.synchronize()
    x264_tpu_torch.reset_launch_counts()
    try:
        for y, u, v in clip:
            t0 = time.perf_counter()
            data = enc.encode(Frame420(y, u, v))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            sizes.append(len(data))
            stream += data
        t0 = time.perf_counter()
        stream += enc.flush()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    finally:
        restore()
    launches = x264_tpu_torch.launch_counts()
    print(f"launches in the 1080p {label} run: {launches}")
    for r in records:
        r["launches"] += launches[r["name"]]
    types = [st.frame_type for st in enc.stats]
    n = len(clip)
    first = next(i for i, sz in enumerate(sizes) if sz)
    psnr = _check_recon(label, stream, recons, clip)
    print(f"1080p {label} x{n}: frame types (coded order) {' '.join(types)}"
          f"; {len(stream)} bytes, {len(stream) * 8 / n / 1000:.1f} "
          f"kbit/frame, mean Y-PSNR {psnr:.3f} dB; "
          f"{(n - 1) / sum(times[first + 1:]):.3f} fps over display "
          f"1-{n - 1} (the encode() calls after the one that coded the "
          f"first IDR, call {first}, flush included)")
    print(f"{label} encode() ms: "
          + " ".join(f"{1000 * t:.1f}" for t in times))

    def stat(key):
        ms = [m for m, _ in log.get(key, [])]
        return (f"{key} {np.mean(ms):.1f} ms a frame over {len(ms)} (max "
                f"{max(ms):.1f})") if ms else f"{key}: none"
    print(f"1080p {label} ms per frame by type (the card synchronised "
          f"after each step): " + "; ".join(
              stat(k) for k in ("IDR", "P", "B submit", "B finalize")))
    print(f"1080p {label} host writer ms: IDR " + ", ".join(
        f"{m:.1f} ({i4} I4x4 MBs)" for m, i4 in log.get("writer IDR", []))
        + "; " + stat("writer P"))
    la_launch = {k: {x: sum(c[1][x] for c in v) for x in ("esa16",
                                                          "esa_parts")}
                 for k, v in la_log.items()}
    return launches, types, log, la_launch


def _run_1080p_fastdecode(records):
    """x264's medium preset with tune fastdecode at CRF 23 (AQ 1, MB-tree,
    b_adapt=1) on cut_clip at 1080p: the host-syntax path's anchors
    (the I4x4 IDRs through the scalar CAVLC writer, the P16 anchors
    through the vectorised one with the device's slot grids) and B
    frames on their own cores.  Checks the launches: no deblock, no
    trellis, intra_nxn a multiple of the knight steps, esa_parts only in
    MB-tree's lowres_stats8, cavlc_blocks once per P anchor and B core
    run, bitpack twice per B core run (the packing and the placement)."""
    clip = cut_clip(LA_FRAMES, LA_CUT)
    launches, types, log, la = _run_1080p_syntax(
        "fastdecode", clip, _fastdecode_params(W, H), records)
    steps = (W + 15) // 16 + 2 * ((H + 15) // 16) - 2
    n_p = types.count("P")
    if types[0] != "IDR" or "B" not in types or launches["deblock"] or \
            launches["trellis"] or not launches["intra_nxn"] or \
            launches["intra_nxn"] % steps or \
            launches["esa_parts"] != la.get("lowres_stats8", {}).get(
                "esa_parts") or \
            launches["bitpack"] % 2 or \
            launches["cavlc_blocks"] - launches["bitpack"] // 2 != n_p or \
            launches["bitpack"] // 2 < types.count("B"):
        raise AssertionError(f"fastdecode: frame types {types}, launches "
                             f"{launches}, lookahead launches {la}")


def _run_1080p_host_entropy(clip, records):
    """backend="device_host_entropy" at 1080p, bench.py's GOP (IDR + 3 x
    (B B P)) with CABAC, CQP 26, I4x4, deblock and full_recon: the anchors
    through the device cores' syntax entries and the C coder's FrameSyntax
    entry, deblocked from the host arrays; each B frame on its own core.
    Checks the launches: deblock once a frame, esa16 once a P anchor and
    twice a B frame, intra_nxn a multiple of the knight steps, no CAVLC
    kernel."""
    launches, types, log, _ = _run_1080p_syntax(
        "host-entropy", clip, _params(W, H, False, bframes=2, i4x4=True,
                                      backend="device_host_entropy"),
        records)
    steps = (W + 15) // 16 + 2 * ((H + 15) // 16) - 2
    n_b, n_p = types.count("B"), types.count("P")
    if types[0] != "IDR" or launches["deblock"] != len(clip) or \
            launches["esa16"] != n_p + 2 * n_b or \
            not launches["intra_nxn"] or launches["intra_nxn"] % steps or \
            launches["cavlc_blocks"] or launches["bitpack"]:
        raise AssertionError(f"host-entropy: frame types {types}, launches "
                             f"{launches}")


def _check_small_syntax() -> None:
    """352x288 card stream == CPU stream on the host-syntax path: I4x4 with
    CAVLC on I/P16 under AQ; the fastdecode preset with B frames (CRF 23,
    AQ, MB-tree, b_adapt); the host-entropy backend with CABAC and with
    CAVLC on a cut that the syntax path's scenecut promotes to an IDR;
    the reference backend (the NumPy tier) on three frames."""
    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420
    cut = dict(scenecut_threshold=40, keyint_min=2)
    for label, frames, p in (
            ("I4x4, CAVLC, AQ 1, I/P16", syntax_clip(CHECK_W, CHECK_H, 4),
             _params(CHECK_W, CHECK_H, False, cabac=False, i4x4=True,
                     aq_mode=1, me_range=8)),
            ("fastdecode, CRF 23, B frames",
             syntax_clip(CHECK_W, CHECK_H, 7),
             _fastdecode_params(CHECK_W, CHECK_H)),
            ("host entropy, CABAC, I4x4, a promoted cut",
             syntax_clip(CHECK_W, CHECK_H, 5, cut=3),
             _params(CHECK_W, CHECK_H, False, i4x4=True, me_range=8,
                     backend="device_host_entropy", **cut)),
            ("host entropy, CAVLC, a promoted cut",
             syntax_clip(CHECK_W, CHECK_H, 5, cut=3),
             _params(CHECK_W, CHECK_H, False, cabac=False, me_range=8,
                     backend="device_host_entropy", **cut)),
            ("reference backend, CAVLC, I4x4",
             syntax_clip(CHECK_W, CHECK_H, 3),
             _params(CHECK_W, CHECK_H, False, cabac=False, i4x4=True,
                     me_range=8, backend="reference"))):
        small = [Frame420(*f) for f in frames]
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(p, device=d)
            x264_tpu_torch.reset_launch_counts()
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
            if d == "cuda":
                launches = x264_tpu_torch.launch_counts()
                types = [st.frame_type for st in e.stats]
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label}: card stream != CPU "
                                 "stream")
        if "cut" in label and types[3] != "IDR":
            raise AssertionError(f"352x288 {label}: frame types {types}")
        print(f"{CHECK_W}x{CHECK_H} {label} x{len(small)}: card stream == "
              f"CPU stream ({len(streams['cuda'])} bytes), frame types "
              f"{' '.join(types)}, launches {launches}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from x264_tpu_torch.api import Encoder, Frame420
    from x264_tpu_torch.kernels import build, deblock as KD
    from x264_tpu_torch.kernels import esa16 as KE, esa_parts as KP
    from x264_tpu_torch.models.b_frame import b_frame_core
    from x264_tpu_torch.models.inter import p_frame_core
    from x264_tpu_torch.models.intra import i_frame_core
    from x264_tpu_torch.ops.deblock import deblock_frame, deblock_prep
    from x264_tpu_torch.ops.mc import pad_edge
    from x264_tpu_torch.state import PAD, sad_lambda

    # ---- 1. the card ----
    t_main = time.perf_counter()

    def lap(what: str) -> None:
        """The script's elapsed seconds, so that its phases' shares of the
        time limit show."""
        print(f"elapsed {time.perf_counter() - t_main:.1f} s after {what}")

    dev = torch.device("cuda")
    print(_smi("name,power.limit"))
    clk_mhz = float(_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = n_sm * INT32_LANES_PER_SM * clk_mhz * 1e6
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}, {n_sm} SMs, max SM "
          f"clock {clk_mhz:.0f} MHz: {int_ops_per_s / 1e12:.2f} T int32 "
          "ops/s")

    # ---- 2. build, the host's twins of the wide bars beside it ----
    pir_twins = _pir_twins_start()
    v1_mod, v1_build = _v1_start()
    build.library()
    print(f"kernel build: {build.build_info['seconds']:.3f} s "
          f"({build.build_info['path']})")
    print(build.build_info["log"], file=sys.stderr)
    _print_resources(build.build_info["log"],
                     ("search_kernel", "esa", "trellis", "intra_nxn",
                      "cavlc", "bitpack", "bitscan", "bitplace",
                      "pir_column"))
    v1 = v1_mod.build_wait(v1_build)
    print("the CAVLC pair's first design (tools/cavlc_v1), for the "
          "comparisons:")
    _print_resources(v1.log, ("cavlc", "bitpack"))
    t0 = time.perf_counter()
    pir_twins = _pir_twins_wait(pir_twins)
    print(f"host twins of the {', '.join(map(str, PIR_WIDE))}-column bars: "
          f"waited {time.perf_counter() - t0:.1f} s for them after the build")
    probe_rate = _esa_probe_rate(build.library(), n_sm)
    print(f"esa_sad_probe: {probe_rate / 1e12:.3f} T vabsdiff4/s, "
          f"{probe_rate / (n_sm * clk_mhz * 1e6):.2f} per SM per clock at "
          f"the max clock (nominal {INT32_LANES_PER_SM}); the ESA bound "
          "takes the lower rate")
    esa_rate = min(int_ops_per_s, probe_rate)

    # ---- 2b. Encoder.warm(), before any other phase captures a graph ----
    bclip = make_clip(B_FRAMES)
    _warm_phase(bclip)
    lap("_warm_phase")

    # ---- 3. kernels against their plain twins at 1080p ----
    t0 = time.perf_counter()
    clip = make_clip(N_FRAMES)
    print(f"clip: {len(clip)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    n_mb = mbw * mbh
    records = []

    def record(name, source, replaces, err, ms, plain_ms, bound):
        records.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=0, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                            bound_by=bound[1], library_ms=None))

    src = _pad_to_mb(clip[0][0], 16)
    rng = np.random.default_rng(7)
    ref = np.clip(np.roll(src, (3, -5), (0, 1)).astype(np.int32)
                  + rng.integers(-4, 5, src.shape), 0, 255).astype(np.uint8)
    src_d = torch.from_numpy(src).to(dev)
    ref_pad = pad_edge(torch.from_numpy(ref).to(dev), PAD).contiguous()
    lam = sad_lambda(QP)
    # lookahead's range, the three-reference run's, then the main path's
    # (the one recorded)
    for me_range in (8, 24, 16):
        mv_k, cost_k = KE.full_search_16x16(src_d, ref_pad, lam, me_range,
                                            mbw, mbh)
        mv_p, cost_p = KE.full_search_16x16_plain(src_d, ref_pad, lam,
                                                  me_range, mbw, mbh)
        err16 = max(_max_err(mv_k, mv_p), _max_err(cost_k, cost_p))
        if err16:
            raise AssertionError(f"esa16 disagrees with its plain twin at "
                                 f"r = {me_range}: {err16}")
        units_k = KP.full_search_parts(src_d, ref_pad, lam, me_range, mbw,
                                       mbh)
        units_p = KP.full_search_parts_plain(src_d, ref_pad, lam, me_range,
                                             mbw, mbh)
        err = max(_max_err(units_k[k], units_p[k]) for k in units_p)
        if err:
            raise AssertionError(f"esa_parts disagrees with its plain twin "
                                 f"at r = {me_range}: {err}")
        if not (torch.equal(units_k["mv_f"], mv_k)
                and torch.equal(units_k["cost_f"], cost_k)):
            raise AssertionError(f"esa_parts' 16x16 unit != esa16 at r = "
                                 f"{me_range}")
        n_split = int((units_k["mv_q"] != units_k["mv_f"][:, None]).any(2)
                      .any(1).sum())
        times = {
            "esa16": _time_ms(lambda: KE.full_search_16x16(
                src_d, ref_pad, lam, me_range, mbw, mbh), 20),
            "esa_parts": _time_ms(lambda: KP.full_search_parts(
                src_d, ref_pad, lam, me_range, mbw, mbh), 20)}
        # a diagnostic: the wrappers' launch alone, on outputs allocated
        # once (KE.esa_launcher, through which the wrappers launch)
        alone = {name: _time_ms(KE.esa_launcher(
            name, shapes, src_d, ref_pad, lam, me_range, mbw, mbh)[0], 50)
            for name, shapes in (("esa16", KE.OUT_SHAPES),
                                 ("esa_parts", KP.OUT_SHAPES))}
        bounds = {"esa16": _esa_bound_ms(src_d, ref_pad, me_range, 1, 3,
                                         esa_rate),
                  "esa_parts": _esa_bound_ms(src_d, ref_pad, me_range, 9, 27,
                                             esa_rate)}
        for name in times:
            print(f"{name} at r = {me_range}: bit-exact, {times[name]:.4f} "
                  f"ms through the wrapper (its launch alone "
                  f"{alone[name]:.4f} ms), bound {bounds[name][0]:.4f} ms "
                  f"by {bounds[name][1]}")
        print(f"esa_parts at r = {me_range}: 16x16 unit == esa16 bit for "
              f"bit; {n_split} of {n_mb} MBs have a quadrant mv apart from "
              "the 16x16 mv")
    record("esa16", "x264_tpu_torch/csrc/esa16.cu",
           "x264_tpu/ops/device/me_pallas.py:142", err16, times["esa16"],
           _time_ms(lambda: KE.full_search_16x16_plain(
               src_d, ref_pad, lam, 16, mbw, mbh), 3), bounds["esa16"])
    record("esa_parts", "x264_tpu_torch/csrc/esa_parts.cu",
           "x264_tpu/ops/device/me_parts_pallas.py:148", err,
           times["esa_parts"],
           _time_ms(lambda: KP.full_search_parts_plain(
               src_d, ref_pad, lam, 16, mbw, mbh), 3), bounds["esa_parts"])
    _lowres_esa_phase(clip, esa_rate)
    lap("_lowres_esa_phase")

    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    out_i = i_frame_core(*planes, QP, mbw=mbw, mbh=mbh, cqp_off=0,
                         lv_cap=408)
    ref_planes = deblock_frame(
        out_i["recon_y"], out_i["recon_u"], out_i["recon_v"],
        out_i["mb_class"], out_i["cbp_luma"], out_i["cbp_chroma"],
        out_i["luma_nnz"], torch.zeros((n_mb, 2), dtype=torch.int32,
                                       device=dev),
        torch.zeros(n_mb, dtype=torch.int32, device=dev),
        out_i["qp_mb"], 0, 0, mbw, mbh)
    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[1], (16, 8, 8))]
    out_p = p_frame_core(*planes, *ref_planes, QP, lam, mbw=mbw, mbh=mbh,
                         me_range=16, cqp_off=0, subpel=2, lv_cap=408,
                         parts=True)
    # a CAVLC B frame between the IDR's recon and this P frame: with the
    # P8x8 frame, the CAVLC kernels' inputs at 1080p
    b_planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
                for p, s in zip(clip[2], (16, 8, 8))]
    out_b = b_frame_core(*b_planes, *ref_planes, out_p["recon_y"],
                         out_p["recon_u"], out_p["recon_v"], out_p["mv8"],
                         out_p["mb_class"] == 0, 128, QP, lam, mbw=mbw,
                         mbh=mbh, me_range=16, cqp_off=0, n_words=64,
                         t8_mode=True)
    cavlc_frames = {"P8x8": (out_p, False), "B": (out_b, True)}
    bs_v, bs_h, qp_mb, qpc_mb = deblock_prep(
        out_p["mb_class"], out_p["cbp_luma"], out_p["cbp_chroma"],
        out_p["nnz_deblock"], out_p["mv8"], out_p["ref8"], out_p["qp_mb"],
        mbw, mbh)
    ry, ru, rv = out_p["recon_y"], out_p["recon_u"], out_p["recon_v"]
    nz = (bs_v > 0).sum().item() + (bs_h > 0).sum().item()
    print(f"deblock input: P8x8 frame, {nz} edges with bS > 0")

    # the deblock kernel: one launch filters Y, Cb and Cr
    def db_kernel():
        return KD.deblock_filter(ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb, 0, 0,
                                 mbw, mbh)

    out_k = db_kernel()
    out_p = KD.deblock_filter_plain(ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb, 0,
                                    0, mbw, mbh)
    err = max(_max_err(a, b) for a, b in zip(out_k, out_p))
    changed = sum((a != b).sum().item() for a, b in zip(out_p, (ry, ru, rv)))
    if err or not changed:
        raise AssertionError(f"deblock: max err {err}, {changed} pixels "
                             "filtered")
    record("deblock", "x264_tpu_torch/csrc/deblock.cu",
           "x264_tpu/ops/device/deblock_pallas.py:302,312", err,
           _time_ms(db_kernel, 20),
           _time_ms(lambda: KD.deblock_filter_plain(
               ry, ru, rv, bs_v, bs_h, qp_mb, qpc_mb, 0, 0, mbw, mbh), 3),
           _deblock_bound_ms(build.library(), (ry, ru, rv),
                             (bs_v, bs_h, qp_mb, qpc_mb), mbw, mbh))
    alone = _deblock_kernel_only_ms(KD, ry, ru, rv, bs_v, bs_h, qp_mb,
                                    qpc_mb, mbw, mbh, 20)
    print(f"deblock kernel alone (without the wrapper's clones and counter "
          f"zeroing): {alone:.4f} ms")
    _trellis_phase(clip, record)
    lap("_trellis_phase")
    _nxn_phase(clip, record, int_ops_per_s)
    lap("_nxn_phase")
    _aq_kernel_phase(clip)
    lap("_aq_kernel_phase")
    _cavlc_phase(cavlc_frames, record, int_ops_per_s, v1)
    lap("_cavlc_phase")
    bar_ms = _pir_phase(clip, record, int_ops_per_s, pir_twins)
    lap("_pir_phase")
    _band_kernel_phase(esa_rate, int_ops_per_s, v1)
    lap("_band_kernel_phase")
    for r in records:
        print(f"kernel {r['name']}: bit-exact, {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']})")

    # ---- 4. the main paths: 1080p, 1 IDR + 5 P, P16x16 then P8x8 ----
    n_p = N_FRAMES - 1
    launches, _ = _run_1080p("I/P16", clip, False, records)
    if not (launches["esa16"] == n_p and launches["esa_parts"] == 0
            and launches["deblock"] == N_FRAMES):
        raise AssertionError(f"I/P16 kernel launches {launches} do not "
                             f"match {N_FRAMES} frames ({n_p} P)")
    _i16_graph_phase(clip)
    lap("_i16_graph_phase")
    launches, shapes = _run_1080p("I/P8x8", clip, True, records, TOOLS)
    least = _trellis_launches(n_i=1, n_p=n_p, n_b=0)
    if not (launches["esa_parts"] == n_p and launches["esa16"] == 0
            and launches["deblock"] == N_FRAMES
            and launches["trellis"] >= least):
        raise AssertionError(f"I/P8x8 kernel launches {launches} do not "
                             f"match {N_FRAMES} frames ({n_p} P; trellis "
                             f"at least {least})")
    hist = np.bincount(np.concatenate(shapes), minlength=4)
    print("1080p P8x8 shapes over the P frames (16x16, 16x8, 8x16, 8x8; "
          "intra and skip MBs count as 16x16): "
          + " ".join(str(int(c)) for c in hist))
    if len(shapes) != n_p or hist.sum() != n_p * n_mb:
        raise AssertionError(f"partition shapes of {len(shapes)} frames")
    _run_1080p_b(bclip, records)
    lap("_run_1080p_b")
    _run_1080p_multiref(clip[:MULTIREF_FRAMES], records)
    lap("_run_1080p_multiref")
    _run_1080p_cavlc(bclip, records)
    lap("_run_1080p_cavlc")
    _run_1080p_medium(records)
    lap("_run_1080p_medium")
    _run_1080p_live(records, bar_ms)
    lap("_run_1080p_live")
    _run_4k_cli(records)
    lap("_run_4k_cli")
    _run_1080p_ultrafast(records)
    lap("_run_1080p_ultrafast")
    _run_1080p_mesh(records)
    lap("_run_1080p_mesh")
    _run_1080p_fastdecode(records)
    lap("_run_1080p_fastdecode")
    _run_1080p_host_entropy(bclip, records)
    lap("_run_1080p_host_entropy")

    # ---- 5. card streams == CPU (plain twins) streams at 352x288 ----
    small = [Frame420(*f) for f in split_motion_clip(CHECK_W, CHECK_H,
                                                     CHECK_FRAMES)]
    for p8x8 in (False, True):
        streams = {}
        for d in ("cuda", "cpu"):
            e = Encoder(_params(CHECK_W, CHECK_H, p8x8), device=d)
            shapes = _spy(e)
            streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
        label = "P8x8" if p8x8 else "P16"
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"352x288 {label}: card stream != CPU "
                                 "stream")
        hist = np.bincount(torch.cat(shapes).cpu().numpy(), minlength=4) \
            if p8x8 else None
        if p8x8 and not (hist[1:] > 0).all():
            raise AssertionError(f"352x288 P8x8: shapes {hist}")
        print(f"{CHECK_W}x{CHECK_H} {label} x{CHECK_FRAMES}: card stream == "
              f"CPU stream ({len(streams['cuda'])} bytes)"
              + (f"; shapes {' '.join(str(int(c)) for c in hist)}"
                 if p8x8 else ""))
    _check_small_b()
    _check_small_tools()
    _check_small_i4()
    _check_small_weightp()
    _check_small_cavlc()
    _check_small_lookahead()
    _check_small_live()
    _check_small_slices()
    _check_small_syntax()
    lap("_check_small_syntax")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
