#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (x264_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from x264_tpu_torch/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin at 1080p on the card,
     bit-exact, with both times (median of several runs after a warm-up):
     ESA on a 1080p frame against a shifted, noised copy; the deblock
     kernels on the recon planes and bS grids of an encoded P frame;
  4. the main path: Encoder(device="cuda") encodes a 1080p clip of one IDR
     and 9 P frames (bench.py's make_clip), with the kernels' launch counts
     reset just before and read just after; fps, bytes and Y-PSNR, and,
     where tools/avdec runs, a decode that must equal the encoder's recon;
  5. a 352x288 stream encoded on the card must equal, byte for byte, the
     stream the port encodes on the CPU (the kernels' plain twins).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it prints no result
and exits 1.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H, N_FRAMES, QP = 1920, 1080, 10, 26
CHECK_W, CHECK_H, CHECK_FRAMES = 352, 288, 4
AVDEC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                     "avdec")


def _time_ms(fn, reps: int) -> float:
    """Median wall time of fn() on the card, synchronised, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(1000.0 * (time.perf_counter() - t0))
    return statistics.median(ts)


def _max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def _params(w: int, h: int):
    from x264_tpu_torch.api import EncoderParams
    return EncoderParams(width=w, height=h, qp=QP, me_range=16, subpel=2,
                         cabac=True, deblock=True, bframes=0, ref_frames=1,
                         keyint_max=250, scenecut_threshold=0,
                         backend="device")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from bench import make_clip

    import x264_tpu_torch
    from x264_tpu_torch.api import Encoder, Frame420, sad_lambda
    from x264_tpu_torch.kernels import build, deblock as KD, esa16 as KE
    from x264_tpu_torch.models.inter import p_frame_core
    from x264_tpu_torch.models.intra import i_frame_core
    from x264_tpu_torch.ops.deblock import deblock_frame, deblock_prep
    from x264_tpu_torch.ops.mc import pad_edge

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    build.library()
    print(f"kernel build: {build.build_info['seconds']:.3f} s "
          f"({build.build_info['path']})")
    print(build.build_info["log"], file=sys.stderr)

    # ---- 3. kernels against their plain twins at 1080p ----
    t0 = time.perf_counter()
    clip = make_clip()[:N_FRAMES]
    print(f"clip: {len(clip)} frames {W}x{H} in "
          f"{time.perf_counter() - t0:.1f} s")
    mbw, mbh = (W + 15) // 16, (H + 15) // 16
    records = []

    src = _pad_to_mb(clip[0][0], 16)
    rng = np.random.default_rng(7)
    ref = np.clip(np.roll(src, (3, -5), (0, 1)).astype(np.int32)
                  + rng.integers(-4, 5, src.shape), 0, 255).astype(np.uint8)
    src_d = torch.from_numpy(src).to(dev)
    ref_pad = pad_edge(torch.from_numpy(ref).to(dev), KE.PAD).contiguous()
    lam = sad_lambda(QP)
    mv_k, cost_k = KE.full_search_16x16(src_d, ref_pad, lam, 16, mbw, mbh)
    mv_p, cost_p = KE.full_search_16x16_plain(src_d, ref_pad, lam, 16, mbw,
                                              mbh)
    err = max(_max_err(mv_k, mv_p), _max_err(cost_k, cost_p))
    if err:
        raise AssertionError(f"esa16 disagrees with its plain twin: {err}")
    records.append(dict(
        name="esa16", route="cuda", source="x264_tpu_torch/csrc/esa16.cu",
        replaces="x264_tpu/ops/device/me_pallas.py:142", max_abs_err=err,
        ms=_time_ms(lambda: KE.full_search_16x16(src_d, ref_pad, lam, 16,
                                                 mbw, mbh), 10),
        plain_ms=_time_ms(lambda: KE.full_search_16x16_plain(
            src_d, ref_pad, lam, 16, mbw, mbh), 3)))

    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[0], (16, 8, 8))]
    out_i = i_frame_core(*planes, QP, mbw=mbw, mbh=mbh, cqp_off=0,
                         lv_cap=408)
    ref_planes = deblock_frame(
        out_i["recon_y"], out_i["recon_u"], out_i["recon_v"],
        out_i["mb_class"], out_i["cbp_luma"], out_i["cbp_chroma"],
        out_i["luma_nnz"], torch.zeros((mbw * mbh, 2), dtype=torch.int32,
                                       device=dev),
        torch.zeros(mbw * mbh, dtype=torch.int32, device=dev),
        out_i["qp_mb"], 0, 0, mbw, mbh)
    planes = [torch.from_numpy(_pad_to_mb(p, s)).to(dev)
              for p, s in zip(clip[1], (16, 8, 8))]
    out_p = p_frame_core(*planes, *ref_planes, QP, lam, mbw=mbw, mbh=mbh,
                         me_range=16, cqp_off=0, subpel=2, lv_cap=408)
    bs_v, bs_h, qp_mb, qpc_mb = deblock_prep(
        out_p["mb_class"], out_p["cbp_luma"], out_p["cbp_chroma"],
        out_p["nnz_deblock"], out_p["mv"], out_p["ref_mb"], out_p["qp_mb"],
        mbw, mbh)
    ry, ru, rv = out_p["recon_y"], out_p["recon_u"], out_p["recon_v"]
    nz = (bs_v > 0).sum().item() + (bs_h > 0).sum().item()
    print(f"deblock input: P frame, {nz} edges with bS > 0")

    def luma_kernel():
        y = ry.clone()
        KD.deblock_luma_(y, bs_v, bs_h, qp_mb, 0, 0, mbw, mbh)
        return y

    def chroma_kernel():
        u, v = ru.clone(), rv.clone()
        KD.deblock_chroma_(u, v, bs_v, bs_h, qpc_mb, 0, 0, mbw, mbh)
        return u, v

    y_k = luma_kernel()
    y_p = KD.deblock_luma_plain(ry, bs_v, bs_h, qp_mb, 0, 0, mbw, mbh)
    err = _max_err(y_k, y_p)
    changed = (y_p != ry).sum().item()
    if err or not changed:
        raise AssertionError(f"deblock_luma: max err {err}, "
                             f"{changed} pixels filtered")
    records.append(dict(
        name="deblock_luma", route="cuda",
        source="x264_tpu_torch/csrc/deblock.cu",
        replaces="x264_tpu/ops/device/deblock_pallas.py:302",
        max_abs_err=err, ms=_time_ms(luma_kernel, 10),
        plain_ms=_time_ms(lambda: KD.deblock_luma_plain(
            ry, bs_v, bs_h, qp_mb, 0, 0, mbw, mbh), 3)))
    u_k, v_k = chroma_kernel()
    u_p, v_p = KD.deblock_chroma_plain(ru, rv, bs_v, bs_h, qpc_mb, 0, 0,
                                       mbw, mbh)
    err = max(_max_err(u_k, u_p), _max_err(v_k, v_p))
    changed = (u_p != ru).sum().item() + (v_p != rv).sum().item()
    if err or not changed:
        raise AssertionError(f"deblock_chroma: max err {err}, "
                             f"{changed} pixels filtered")
    records.append(dict(
        name="deblock_chroma", route="cuda",
        source="x264_tpu_torch/csrc/deblock.cu",
        replaces="x264_tpu/ops/device/deblock_pallas.py:312",
        max_abs_err=err, ms=_time_ms(chroma_kernel, 10),
        plain_ms=_time_ms(lambda: KD.deblock_chroma_plain(
            ru, rv, bs_v, bs_h, qpc_mb, 0, 0, mbw, mbh), 3)))
    for r in records:
        print(f"kernel {r['name']}: bit-exact, {r['ms']:.3f} ms "
              f"(plain {r['plain_ms']:.3f} ms)")

    # ---- 4. the main path: 1080p, 1 IDR + 9 P ----
    enc = Encoder(_params(W, H), device="cuda")
    recons = []
    enc.recon_hook = lambda d, rec: recons.append(rec)
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
    n_p = N_FRAMES - 1
    print(f"launches in the 1080p run: {launches}")
    if not (launches["esa16"] >= n_p and launches["deblock_luma"] == N_FRAMES
            and launches["deblock_chroma"] == N_FRAMES):
        raise AssertionError(f"kernel launches {launches} do not match "
                             f"{N_FRAMES} frames ({n_p} P)")
    for r in records:
        r["launches"] = launches[r["name"]]
    steady = times[2:]          # P frames after the first
    fps = len(steady) / sum(steady)
    psnr = [_psnr(rec.y[:H, :W].cpu().numpy(), f[0])
            for rec, f in zip(recons, clip)]
    print("frame ms: " + " ".join(f"{1000 * t:.1f}" for t in times))
    print(f"1080p I/P: {fps:.3f} fps steady state (P frames 3-{N_FRAMES}), "
          f"IDR {1000 * times[0]:.1f} ms, {len(stream)} bytes, "
          f"{len(stream) * 8 / N_FRAMES / 1000:.1f} kbit/frame, "
          f"mean Y-PSNR {np.mean(psnr):.3f} dB")
    if len(recons) != N_FRAMES or not np.all(np.isfinite(psnr)) \
            or min(psnr) < 30.0:
        raise AssertionError(f"recon quality out of range: {psnr}")
    if _avdec_available():
        dec = _decode(stream, W, H)
        if len(dec) != N_FRAMES:
            raise AssertionError(f"avdec decoded {len(dec)} frames")
        for i, (rec, planes_d) in enumerate(zip(recons, dec)):
            for p_rec, p_dec in zip((rec.y, rec.u, rec.v), planes_d):
                hh, ww = p_dec.shape
                if not np.array_equal(p_rec[:hh, :ww].cpu().numpy(), p_dec):
                    raise AssertionError(f"frame {i}: decode != recon")
        if recons[-1] is not enc.last_recon:
            raise AssertionError("last_recon is not the last frame's recon")
        print(f"avdec: {len(dec)} frames decode bit-exact to the recon")

    # ---- 5. card stream == CPU (plain twins) stream at 352x288 ----
    small = [Frame420(y[:CHECK_H, :CHECK_W], u[:CHECK_H // 2, :CHECK_W // 2],
                      v[:CHECK_H // 2, :CHECK_W // 2])
             for y, u, v in clip[:CHECK_FRAMES]]
    streams = {}
    for d in ("cuda", "cpu"):
        e = Encoder(_params(CHECK_W, CHECK_H), device=d)
        streams[d] = b"".join(e.encode(f) for f in small) + e.flush()
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("352x288: card stream != CPU stream")
    print(f"{CHECK_W}x{CHECK_H} x{CHECK_FRAMES}: card stream == CPU stream "
          f"({len(streams['cuda'])} bytes)")

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
