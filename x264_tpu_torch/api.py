"""Public encoder API of the PyTorch port: ``x264_tpu.api.Encoder`` with
its device seams running on PyTorch tensors.

Everything on the host — parameters, rate control, headers, the frame
type decision, the CABAC coder (``native/cabac.c``) and the Annex-B
assembly — is the reference's own code, inherited.  What runs on the
device is replaced: the frame cores, the deblock and the upload.  The
decoded picture buffer (``dpb``, ``last_recon``) holds torch tensors on
the encoder's device.

    from x264_tpu_torch.api import Encoder, EncoderParams, Frame420
    enc = Encoder(EncoderParams(..., cabac=True, bframes=0), device="cuda")
    stream = b"".join(enc.encode(Frame420(y, u, v)) for ...) + enc.flush()

``EncoderParams`` and ``Frame420`` are the reference's, re-exported here.
"""

from __future__ import annotations

import numpy as np
import torch

from x264_tpu.api import Encoder as _ReferenceEncoder
from x264_tpu.api import FrameStats, ReconFrame
from x264_tpu.bitstream.bits import BitWriter
from x264_tpu.bitstream.headers import (SLICE_I, SLICE_P, wrap_slice_nal,
                                        write_slice_header)
from x264_tpu.models.inter_frame import PAD, sad_lambda
from x264_tpu.params import EncoderParams
from x264_tpu.utils.yuv import Frame420  # noqa: F401  (re-exported)
from x264_tpu_torch.models.inter import p_frame_core
from x264_tpu_torch.models.intra import i_frame_core
from x264_tpu_torch.ops.deblock import deblock_frame
from x264_tpu_torch.ops.entropy_pack import blob_stride, write_slice_cabac

# parameters whose paths are not ported yet (ROADMAP queue A), with the
# value the port runs
_NOT_PORTED = dict(cabac=True, bframes=0, ref_frames=1, i4x4=False,
                   p8x8=False, transform_8x8=False, trellis=0, weightp=0,
                   aq_mode=0, mbtree=False, intra_refresh=False, slices=1,
                   vbv_maxrate=0, vbv_bufsize=0)


def _check_params(p: EncoderParams) -> None:
    bad = {k: getattr(p, k) for k, want in _NOT_PORTED.items()
           if getattr(p, k) != want}
    if p.backend not in ("auto", "device"):
        bad["backend"] = p.backend
    if p.subpel < 1:
        bad["subpel"] = p.subpel
    if p.me_range > PAD:
        bad["me_range"] = p.me_range
    if bad:
        raise NotImplementedError(
            f"x264_tpu_torch does not run these settings yet: {bad}")


class Encoder(_ReferenceEncoder):
    """The reference encoder with every device seam of the I/P CABAC path
    on PyTorch: ``_run_core``, ``_submit_device``, ``_deblock_device`` and
    ``_cab_rows``.  ``device`` is where the frames are encoded; a CUDA
    device runs the hand-written kernels, the CPU their plain twins."""

    # _use_device() reads this: False while the base __init__ runs, so
    # the base never starts its JAX compile warm-up thread
    _device_ready = False

    def __init__(self, params: EncoderParams, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Encoder(device='cuda'): no CUDA device")
        super().__init__(params)
        _check_params(self.p)
        self._device_ready = True

    def _use_device(self) -> bool:
        return self._device_ready

    def _cab_rows(self, blob, n: int, is_b: bool = False,
                  parts: bool = False, i4: bool = False):
        """Per-MB field rows of a flat CABAC blob (entropy_pack layout)."""
        st = blob_stride()
        return np.asarray(blob).reshape(-1)[:n * st].reshape(n, st)

    def _run_core(self, yd, ud, vd, ref, idr: bool, base_qp: int, qp_arr,
                  n_words: int, mbw: int, mbh: int, wts=None, pir=None):
        """Run the I or P core; ``host_blob`` comes back as a host numpy
        int32 array, the one device-to-host copy of a frame."""
        qp = torch.as_tensor(np.asarray(qp_arr, np.int32),
                             device=self.device)
        if idr or ref is None:
            out = i_frame_core(yd, ud, vd, qp, mbw=mbw, mbh=mbh,
                               cqp_off=self.p.chroma_qp_offset,
                               lv_cap=n_words)
            slice_type = SLICE_I
        else:
            r = ref[0] if isinstance(ref, list) else ref
            out = p_frame_core(yd, ud, vd, r.y, r.u, r.v, qp,
                               sad_lambda(base_qp), mbw=mbw, mbh=mbh,
                               me_range=self.p.me_range,
                               cqp_off=self.p.chroma_qp_offset,
                               subpel=self.p.subpel, lv_cap=n_words,
                               decimate=self.p.dct_decimate)
            slice_type = SLICE_P
        out["host_blob"] = out["host_blob"].cpu().numpy()
        return out, slice_type

    def _deblock_device(self, out, qp, mbw, mbh):
        ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
        if not self.p.deblock:
            return ry, ru, rv
        n = mbw * mbh
        zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
        return deblock_frame(
            ry, ru, rv, out["mb_class"], out["cbp_luma"], out["cbp_chroma"],
            out.get("nnz_deblock", out["luma_nnz"]),
            out["mv"] if "mv" in out else zeros[:, None].expand(n, 2),
            out.get("ref_mb", zeros), out["qp_mb"],
            self.p.deblock_alpha * 2, self.p.deblock_beta * 2, mbw=mbw,
            mbh=mbh, cqp_off=self.p.chroma_qp_offset)

    def _submit_device(self, y, u, v, ftype: str, qp: int) -> dict:
        """Upload the frame, run its core and deblock, advance the DPB
        (the reference's _submit_device on one slice, without AQ, MB-tree,
        PIR or weighted prediction)."""
        h, w = y.shape
        mbw, mbh = w // 16, h // 16
        idr = ftype == "IDR"
        ladder = self._ladder(qp)
        n_words = ladder[0]
        yd, ud, vd = (torch.from_numpy(np.ascontiguousarray(p))
                      .to(self.device) for p in (y, u, v))
        qp_arr = np.int32(qp)
        ref = None if (idr or not self.dpb) else self.dpb
        out, slice_type = self._run_core(yd, ud, vd, ref, idr, qp, qp_arr,
                                         n_words, mbw, mbh)
        if (ref is not None and self.p.scenecut_threshold > 0
                and self.frame_idx - self._last_idr_idx
                >= self.p.keyint_min
                and self._pending is None):
            # post-encode scenecut (x264 slicetype.c:1430 rule, no
            # lookahead): promote to IDR when inter is no cheaper than
            # intra, from the costs the P core already computed
            rows = self._cab_rows(out["host_blob"], mbw * mbh)
            p_cost = float(rows[:, 14 + 9].astype(np.int64).sum())
            i_cost = float(rows[:, 14 + 10].astype(np.int64).sum())
            if p_cost >= (1.0 - self.p.scenecut_threshold / 100.0) * i_cost:
                idr = True
                ftype = "IDR"
                self.frame_num = 0
                self._last_idr_idx = self.frame_idx
                qp = self._requantize_idr(qp)
                qp_arr = np.int32(qp)
                out, slice_type = self._run_core(yd, ud, vd, None, True, qp,
                                                 qp_arr, n_words, mbw, mbh)
        recon = self._deblock_device(out, qp, mbw, mbh)
        job = dict(out=out, slice_type=slice_type, idr=idr, qp=qp,
                   blob=out["host_blob"],
                   num_ref=1 if ref is None else len(ref), qp_arr=qp_arr,
                   slice_qp=qp, mbw=mbw, mbh=mbh, n_words=n_words,
                   ladder=ladder, frame_num=self.frame_num,
                   idr_pic_id=self.idr_pic_id, ftype=ftype,
                   planes=(yd, ud, vd), ref=ref)
        # advance encoder state now (dpb is list0 order, sliding window)
        new = ReconFrame(*recon, frame_num=self.frame_num)
        job["rec"] = new
        self.dpb = ([new] + ([] if idr else self.dpb))[:self.p.ref_frames]
        self.last_recon = new
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.log2_max_frame_num)
        self.frame_idx += 1
        return job

    def _finalize_cabac(self, job: dict, blob: np.ndarray) -> bytes:
        """The reference's _finalize_cabac for one I/P16 slice: re-run at
        the next entropy rung when the level stream overflowed, then the
        slice header and the C CABAC coder (``write_slice_cabac``)."""
        K = job["n_words"]
        n = job["mbw"] * job["mbh"]
        rows = self._cab_rows(blob, n)
        total = int(rows[:, 14 + 8].astype(np.int64).sum())
        if total > n * K:
            yd, ud, vd = job["planes"]
            for K in job["ladder"][1:]:
                job["n_words"] = K
                out, _ = self._run_core(yd, ud, vd, job["ref"], job["idr"],
                                        job["qp"], job["qp_arr"], K,
                                        job["mbw"], job["mbh"])
                blob = out["host_blob"]
                rows = self._cab_rows(blob, n)
                total = int(rows[:, 14 + 8].astype(np.int64).sum())
                if total <= n * K:
                    break
        self._note_budget(True, -(-total // n))

        out_bytes = b""
        if job["ftype"] == "IDR" and self.p.repeat_headers:
            out_bytes += self.headers()
        bs = BitWriter()
        write_slice_header(bs, self.p, self.sps, init_qp=self._init_qp,
                           slice_type=job["slice_type"], idr=job["idr"],
                           frame_num=job["frame_num"],
                           idr_pic_id=job["idr_pic_id"], qp=job["slice_qp"],
                           num_ref=job["num_ref"], poc_lsb=0)
        pad = (-bs.bit_length) % 8
        if pad:
            bs.put(pad, (1 << pad) - 1)    # cabac_alignment_one_bit
        kind = 0 if job["slice_type"] == SLICE_I else 1
        payload = write_slice_cabac(blob, job["mbw"], job["mbh"], kind,
                                    job["slice_qp"], K)
        out_bytes += wrap_slice_nal(bs.to_bytes_aligned() + payload,
                                    job["idr"])
        cost = int(rows[:, 14 + 9].astype(np.int64).sum())
        self.stats.append(FrameStats(job["ftype"], len(out_bytes) * 8,
                                     job["qp"]))
        self.rc.update(job["ftype"], len(out_bytes) * 8, cost)
        self._record_stats(job["ftype"], job["qp"], len(out_bytes) * 8,
                           cost, rows[:, 14])
        self._note_au(len(out_bytes), job["ftype"], 0)
        return out_bytes
