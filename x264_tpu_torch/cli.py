"""CLI driver of the PyTorch + CUDA port — the analog of the reference's
x264.c application layer: demuxer selection, option parsing
(x264-compatible spellings), encode loop with progress meter,
end-of-encode summary (x264.c:1871-2101).  A copy of x264_tpu/cli.py but
for its imports, its program name, ``--device`` (where the frames are
encoded: ``cuda``, the default, or ``cpu``, which runs the kernels' plain
twins) and the recon planes it reads back from the device.

Usage:
    python -m x264_tpu_torch [options] -o out.264 input.y4m
    python -m x264_tpu_torch --device cpu --input-res 352x288 \
        -o out.264 input.yuv
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from x264_tpu_torch.api import Encoder
from x264_tpu_torch.params import (
    RC_ABR,
    RC_CQP,
    RC_CRF,
    EncoderParams,
    param_default_preset,
)
from x264_tpu_torch.utils.y4m import RawReader, Y4MReader


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="x264_tpu_torch",
        description="H.264 encoder on PyTorch + CUDA (x264_tpu's port)")
    ap.add_argument("input", help="input file (.y4m, or raw I420 with "
                                  "--input-res)")
    ap.add_argument("-o", "--output", required=True, help="output .264 "
                    "(Annex-B)")
    ap.add_argument("--input-res", help="WxH for raw input")
    ap.add_argument("--fps", help="N or N/D frame rate for raw input")
    ap.add_argument("--frames", type=int, default=0, help="max frames")
    ap.add_argument("--seek", type=int, default=0, help="skip first N")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default=None)
    ap.add_argument("--qp", type=int, default=None, help="CQP mode")
    ap.add_argument("--crf", type=float, default=None, help="CRF mode")
    ap.add_argument("--bitrate", type=int, default=None, help="ABR kbit/s")
    ap.add_argument("--vbv-maxrate", type=int, default=None, help="kbit/s")
    ap.add_argument("--vbv-bufsize", type=int, default=None, help="kbit")
    ap.add_argument("--vbv-init", type=float, default=None)
    ap.add_argument("--bframes", type=int, default=None)
    ap.add_argument("--b-adapt", type=int, default=None, choices=[0, 1])
    ap.add_argument("--keyint", type=int, default=None)
    ap.add_argument("--merange", type=int, default=None)
    ap.add_argument("--subme", type=int, default=None)
    ap.add_argument("--mbtree", action="store_true")
    ap.add_argument("--rc-lookahead", type=int, default=None)
    ap.add_argument("--aq-mode", type=int, default=None)
    ap.add_argument("--aq-strength", type=float, default=None)
    ap.add_argument("--no-deblock", action="store_true")
    ap.add_argument("--deblock", help="alpha:beta offsets")
    ap.add_argument("--cabac", action="store_true")
    ap.add_argument("--no-cabac", action="store_true")
    ap.add_argument("--pass", dest="rc_pass", type=int, choices=[1, 2],
                    default=0)
    ap.add_argument("--stats", default="x264_tpu_2pass.log")
    ap.add_argument("--scenecut", type=int, default=None)
    ap.add_argument("--slices", type=int, default=None)
    ap.add_argument("--threads", type=int, default=None,
                    help="devices for the sliced band mesh (with --slices)")
    ap.add_argument("--ref", type=int, default=None,
                    help="reference frames (1-3)")
    ap.add_argument("--8x8dct", dest="t8", action="store_true",
                    help="adaptive 8x8 transform (High profile)")
    ap.add_argument("--weightp", type=int, default=None, choices=[0, 1, 2],
                    help="P-slice weighted prediction")
    ap.add_argument("--trellis", type=int, default=None, choices=[0, 1, 2],
                    help="RD-optimal quantization (needs --cabac)")
    ap.add_argument("--sar", default=None, help="sample AR width:height")
    ap.add_argument("--range", dest="range_", default=None,
                    choices=["tv", "pc"], help="video range")
    ap.add_argument("--videoformat", type=int, default=None)
    ap.add_argument("--colorprim", type=int, default=None)
    ap.add_argument("--transfer", type=int, default=None)
    ap.add_argument("--colormatrix", type=int, default=None)
    ap.add_argument("--chromaloc", type=int, default=None)
    ap.add_argument("--nal-hrd", dest="nal_hrd", action="store_true",
                    help="signal HRD (needs VBV)")
    ap.add_argument("--level", default=None,
                    help="force level (e.g. 4.1 or 41)")
    ap.add_argument("--i4x4", dest="i4x4", action="store_true")
    ap.add_argument("--no-i4x4", dest="no_i4x4", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "device", "reference"])
    ap.add_argument("--device", default="cuda",
                    help="where the frames are encoded: cuda or cpu")
    ap.add_argument("--psnr", action="store_true", help="report PSNR")
    ap.add_argument("--ssim", action="store_true", help="report SSIM")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--zones", default=None,
                    help="per-range RC overrides: start,end,q=QP or "
                         "start,end,b=FACTOR, '/'-separated")
    ap.add_argument("--no-dct-decimate", dest="no_dct_decimate",
                    action="store_true",
                    help="disable inter coefficient decimation")
    ap.add_argument("--p8x8", dest="p8x8", action="store_true",
                    help="inter partitions 16x8/8x16/8x8")
    ap.add_argument("--qpfile", default=None,
                    help="force frame types/QPs from a file "
                         "('frame type [qp]' per line)")
    ap.add_argument("--vf", "--video-filter", dest="vf", default=None,
                    help="filter chain, e.g. crop:0,0,16,0/"
                         "resize:640x360/select_every:2,0")
    ap.add_argument("--input-depth", type=int, default=4,
                    help="read-ahead frames (threaded input)")
    ap.add_argument("--dump-recon", help="write reconstructed frames to "
                    "a .y4m (regression_test.txt workflow)")
    return ap


def params_from_args(args, reader) -> EncoderParams:
    p = param_default_preset(args.preset, args.tune)
    p = p.clone(width=reader.width, height=reader.height,
                fps_num=reader.fps_num, fps_den=reader.fps_den,
                backend=args.backend)
    if args.crf is not None:
        p = p.clone(rc_method=RC_CRF, crf=args.crf)
    elif args.bitrate is not None:
        p = p.clone(rc_method=RC_ABR, bitrate=args.bitrate)
    elif args.qp is not None:
        p = p.clone(rc_method=RC_CQP, qp=args.qp)
    if args.vbv_maxrate is not None:
        p = p.clone(vbv_maxrate=args.vbv_maxrate)
    if args.vbv_bufsize is not None:
        p = p.clone(vbv_bufsize=args.vbv_bufsize)
    if args.vbv_init is not None:
        p = p.clone(vbv_init=args.vbv_init)
    if args.bframes is not None:
        p = p.clone(bframes=args.bframes)
    if args.b_adapt is not None:
        p = p.clone(b_adapt=args.b_adapt)
    if args.keyint is not None:
        p = p.clone(keyint_max=args.keyint)
    if args.merange is not None:
        p = p.clone(me_range=args.merange)
    if args.subme is not None:
        if args.subme > 2:
            sys.stderr.write(
                f"x264_tpu [warning]: --subme {args.subme} capped at 2 "
                "(exhaustive qpel; RD refinement levels land later)\n")
        p = p.clone(subpel=min(args.subme, 2))
    if args.mbtree:
        p = p.clone(mbtree=True)
    if args.rc_lookahead is not None:
        p = p.clone(rc_lookahead=args.rc_lookahead)
    if args.aq_mode is not None:
        p = p.clone(aq_mode=args.aq_mode)
    if args.aq_strength is not None:
        p = p.clone(aq_strength=args.aq_strength)
    if args.cabac:
        p = p.clone(cabac=True)
    if args.no_cabac:
        p = p.clone(cabac=False)
    if args.rc_pass == 1:
        p = p.clone(stats_write=args.stats)
    elif args.rc_pass == 2:
        p = p.clone(stats_read=args.stats)
    if args.scenecut is not None:
        p = p.clone(scenecut_threshold=args.scenecut)
    if args.slices is not None:
        p = p.clone(slices=args.slices)
    if args.no_deblock:
        p = p.clone(deblock=False)
    elif args.deblock:
        a, b = (args.deblock.split(":") + ["0"])[:2]
        p = p.clone(deblock_alpha=int(a), deblock_beta=int(b))
    if args.threads is not None:
        p = p.clone(threads=args.threads)
    if args.ref is not None:
        p = p.clone(ref_frames=args.ref)
    if args.t8:
        p = p.clone(transform_8x8=True)
    if args.weightp is not None:
        p = p.clone(weightp=args.weightp)
    if args.trellis is not None:
        p = p.clone(trellis=args.trellis)
    if args.zones is not None:
        p = p.clone(zones=args.zones)
    if args.no_dct_decimate:
        p = p.clone(dct_decimate=False)
    if args.p8x8:
        p = p.clone(p8x8=True)
    if args.sar:
        sw, sh = args.sar.replace("/", ":").split(":")
        p = p.clone(sar_width=int(sw), sar_height=int(sh))
    if args.range_:
        p = p.clone(fullrange=args.range_ == "pc")
    for name in ("videoformat", "colorprim", "transfer", "chromaloc"):
        v = getattr(args, name)
        if v is not None:
            key = "chroma_loc" if name == "chromaloc" else name
            p = p.clone(**{key: v})
    if args.colormatrix is not None:
        p = p.clone(colmatrix=args.colormatrix)
    if args.nal_hrd:
        p = p.clone(nal_hrd=True)
    if args.level is not None:
        lv = args.level
        p = p.clone(level_idc=int(float(lv) * 10) if "." in lv else int(lv))
    if args.i4x4:
        p = p.clone(i4x4=True)
    if args.no_i4x4:
        p = p.clone(i4x4=False)
    if args.quiet:
        p = p.clone(log_level=0)
    elif args.verbose:
        p = p.clone(log_level=3)
    return p


def open_input(args):
    if args.input_res:
        w, h = map(int, args.input_res.lower().split("x"))
        fps = (25, 1)
        if args.fps:
            fps = (tuple(map(int, args.fps.split("/"))) + (1,))[:2] \
                if "/" in args.fps else (int(args.fps), 1)
        return RawReader(args.input, w, h, fps)
    return Y4MReader(args.input)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    reader = open_input(args)
    p = params_from_args(args, reader)
    from x264_tpu_torch.utils.filters import (ThreadedReader, apply_chain,
                                        chain_out_size, parse_qpfile,
                                        parse_vf)
    chain = parse_vf(args.vf) if args.vf else []
    if chain:
        w2, h2 = chain_out_size(chain, p.width, p.height)
        p = p.clone(width=w2, height=h2)
    qpfile = parse_qpfile(args.qpfile) if args.qpfile else {}
    enc = Encoder(p, device=args.device)

    from x264_tpu_torch.utils.metrics import psnr, ssim
    recon_frames = {} if args.dump_recon else None
    src_hist = {}       # disp -> source luma (PSNR/SSIM, display order)

    def _on_recon(disp, r):
        ry = np.asarray(r.y.cpu())[:p.height, :p.width]
        sy = src_hist.pop(disp, None)
        if sy is not None:
            if args.psnr:
                psnr_acc.append(psnr(ry, sy))
            if args.ssim:
                ssim_acc.append(ssim(ry, sy))
        if recon_frames is not None:
            from x264_tpu_torch.utils.yuv import Frame420
            recon_frames[disp] = Frame420(
                ry.copy(),
                np.asarray(r.u.cpu())[:p.height // 2, :p.width // 2].copy(),
                np.asarray(r.v.cpu())[:p.height // 2, :p.width // 2].copy())

    if args.psnr or args.ssim or recon_frames is not None:
        enc.recon_hook = _on_recon
    psnr_acc, ssim_acc = [], []

    t0 = time.time()
    nframes = 0
    total_bytes = 0
    from x264_tpu_torch.output import RawMuxer, open_muxer
    mux = open_muxer(args.output, p)
    raw_out = isinstance(mux, RawMuxer)
    if not raw_out:
        mux.write_headers(enc.headers())
    delay = 1 if p.bframes else 0        # pts shift keeps cts >= 0

    def write_aus(data):
        for meta in enc.drain_au_meta():
            au, rest = data[:meta["bytes"]], data[meta["bytes"]:]
            data = rest
            mux.write_frame(au, meta["pts"] + delay, meta["dts"],
                            meta["key"])
        assert not data, "AU metadata out of sync with the byte stream"

    if True:
        out = None
        for i, fr in enumerate(ThreadedReader(reader,
                                              args.input_depth)):
            if i < args.seek:
                continue
            if args.frames and nframes >= args.frames:
                break
            if chain:
                fr = apply_chain(chain, fr)
                if fr is None:
                    continue            # dropped by select_every
            ft, fqp = qpfile.get(nframes, (0, None))
            if args.psnr or args.ssim:
                src_hist[nframes] = fr.y.copy()
            data = enc.encode(fr, frame_type=ft, qp=fqp)
            write_aus(data)
            total_bytes += len(data)
            nframes += 1
            if not args.quiet and nframes % 10 == 0:
                el = time.time() - t0
                fps_now = nframes / max(el, 1e-9)
                kbps = total_bytes * 8 * (p.fps_num / p.fps_den) \
                    / max(nframes, 1) / 1000
                sys.stderr.write(
                    f"\r{nframes} frames, {fps_now:.2f} fps, "
                    f"{kbps:.2f} kb/s")
                sys.stderr.flush()
        # drain reordering/lookahead queues (x264's pi_nal flush loop)
        tail = enc.flush()
        write_aus(tail)
        total_bytes += len(tail)
        mux.close()

    el = time.time() - t0
    fps_out = p.fps_num / p.fps_den
    kbps = total_bytes * 8 * fps_out / max(nframes, 1) / 1000
    sys.stderr.write(
        f"\rencoded {nframes} frames, {nframes / max(el, 1e-9):.2f} fps, "
        f"{kbps:.2f} kb/s\n")
    if args.psnr and psnr_acc:
        sys.stderr.write(f"PSNR Mean Y: {np.mean(psnr_acc):.3f} dB\n")
    if args.ssim and ssim_acc:
        sys.stderr.write(f"SSIM Mean Y: {np.mean(ssim_acc):.7f}\n")
    if recon_frames is not None:
        from x264_tpu_torch.utils.y4m import write_y4m
        write_y4m(args.dump_recon,
                  [recon_frames[d] for d in sorted(recon_frames)],
                  (p.fps_num, p.fps_den),
                  colorspace=getattr(reader, "colorspace", "420mpeg2"),
                  aspect=getattr(reader, "aspect", "0:0"))
    if p.log_level >= 2:
        for line in enc.summary_lines():
            sys.stderr.write("x264_tpu [info]: " + line + "\n")
    enc.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
