"""Public encoder API of the PyTorch port: ``Encoder(params, device)``.

The host layer is the port's own copy of the reference's
(``x264_tpu/api.py``): parameters, rate control, headers, the frame type
decision, the Annex-B assembly and the C CABAC coder
(``native/cabac.c``).  What ran on the TPU runs here on PyTorch tensors:
the frame cores, the deblock and the upload.  The decoded picture buffer
(``dpb``, ``last_recon``) holds torch tensors on the encoder's device.

    from x264_tpu_torch.api import Encoder, EncoderParams, Frame420
    enc = Encoder(EncoderParams(..., cabac=True, bframes=0), device="cuda")
    stream = b"".join(enc.encode(Frame420(y, u, v)) for ...) + enc.flush()

The port runs the single-slice path with either entropy coder: CABAC
(the C coder on the host) or CAVLC (the library's default; every MB's
codes packed into words and placed in the slice payload on the device,
the host only appends the payload's words, ``_append_mbs``).  I frames
(I16x16, or with ``i4x4`` and CABAC the I16x16 / I4x4 / I8x8 choice), P
frames on ``ref_frames`` references with explicit weighted prediction
when asked (``weightp``), with or without P8x8 partitions, and B frames
in mini-GOPs (``bframes`` > 0, temporal direct, one reference per list),
with the adaptive 8x8 transform and, with CABAC, trellis quantisation
when asked; and the
lookahead: adaptive quantisation (``aq_mode`` 1-3, a per-MB QP map on I
and P frames), the lowres scenecut with B frames, adaptive B placement
(``b_adapt=1``) and MB-tree under CRF or ABR (``models/lookahead.py``,
``models/mbtree.py``); and the live-streaming settings: VBV with its
frame-grain re-encode of an anchor that would underflow the decoder's
buffer, NAL HRD buffering-period and pic-timing SEIs, periodic intra
refresh (a moving I16 bar, ``kernels/pir_column``, with its
recovery-point SEI), and the run-time entry points ``reconfig``,
``delayed_frames``, ``intra_refresh``, ``invalidate_reference`` and
``encode_pipelined``; the fullpel-only search (``subpel`` 0, x264's
``ultrafast``); and multi-slice frames (``slices`` > 1: bands of MB rows,
each an I16 or P16 slice of its own, ``_submit_device_sliced``); and
the host-syntax path (``_syn_path``: I4x4 with CAVLC, and the backends
``device_host_entropy`` and ``reference``), on which the device cores'
syntax entries (``models/intra.encode_iframe_device``,
``models/inter.encode_pframe_device``) or, with ``reference``, the NumPy
tier (``models/intra_frame.py``, ``models/inter_frame.py``) hand a
``FrameSyntax`` to the host writers (the C coder's FrameSyntax entry or
``bitstream/slice_writer_vec.py``), ``_encode_frame_syn``.  ``auto`` is
the device: nothing switches to the NumPy tier on its own.  The settings
``_check_params`` names raise ``NotImplementedError``.  On the card an I
frame's core, or an I band's, is one CUDA graph replay
(``models/graph.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from x264_tpu_torch.bitstream.bits import BitWriter
from x264_tpu_torch.bitstream.headers import (SLICE_B, SLICE_I, SLICE_P,
                                              sps_from_params,
                                              wrap_slice_nal, write_pps,
                                              write_slice_header, write_sps)
from x264_tpu_torch.bitstream.sei import (buffering_period_sei,
                                          pic_timing_sei,
                                          recovery_point_sei, version_sei)
from x264_tpu_torch.bitstream.slice_assemble import append_payload
from x264_tpu_torch.bitstream.slice_writer_vec import \
    write_slice_data_vec as write_slice_data
from x264_tpu_torch.kernels.bitpack import place
from x264_tpu_torch.models.b_frame import b_frame_core, b_pair_core
from x264_tpu_torch.models.graph import run_core
from x264_tpu_torch.models import mbtree as MT
from x264_tpu_torch.models import inter_frame, intra_frame
from x264_tpu_torch.models.inter import encode_pframe_device, p_frame_core
from x264_tpu_torch.models.intra import (encode_iframe_device,
                                         i4_frame_core, i_frame_core)
from x264_tpu_torch.models.lookahead import (Lookahead,
                                             intra_cost_estimate,
                                             lowres_plane, lowres_search,
                                             lowres_stats8)
from x264_tpu_torch.models.syntax import (MB_I4, MB_I16, MB_PSKIP,
                                          effective_qp)
from x264_tpu_torch.models.weightp import analyse_weights
from x264_tpu_torch.ops.deblock import (deblock_core, deblock_frame,
                                        deblock_frame_b)
from x264_tpu_torch.ops.entropy_pack import (blob_stride, write_slice_cabac,
                                             write_slice_cabac_syn)
from x264_tpu_torch.ops.reference import deblock as ref_deblock
from x264_tpu_torch.ops.mc import pad_edge
from x264_tpu_torch.ops.trellis import frame_trellis
from x264_tpu_torch.parallel.sliced import (build_sliced_p_step, gather,
                                            make_band_mesh, on_card,
                                            run_band)
from x264_tpu_torch.params import RC_CQP, EncoderParams
from x264_tpu_torch.rc import RateControl, aq_offsets
from x264_tpu_torch.state import CHROMA_QP_TABLE, PAD, me_lambda, sad_lambda
from x264_tpu_torch.utils.yuv import Frame420, pad_to_mb

__all__ = ["Encoder", "EncoderParams", "Frame420", "FrameStats",
           "ReconFrame"]


def _check_params(p: EncoderParams) -> None:
    bad = {}
    if p.backend not in ("auto", "device", "device_host_entropy",
                         "reference"):
        bad["backend"] = p.backend
    # the reference gathers P16 and B windows from 80-row bands, which
    # hold every window only up to me_range PAD - 1: at PAD its streams
    # stop decoding to its recon (ROADMAP C)
    if p.me_range > PAD or (p.me_range == PAD
                            and (p.bframes > 0 or not p.p8x8)):
        bad["me_range"] = p.me_range
    # the reference clamps each 8x8 quadrant's mvx left of the refresh bar
    # on its own, so one partition's quadrants can end up with different
    # mvs while the stream codes one: its streams stop decoding to its
    # recon (ROADMAP C, fault 3)
    if p.intra_refresh and p.p8x8:
        bad["p8x8"] = "on with intra_refresh"
    # the reference deblocks a multi-slice frame along one QP chain over
    # the whole frame, so an MB at a slice's start that carries its QP
    # takes the previous slice's where the decoder takes the slice QP:
    # with AQ's per-MB QPs its streams stop decoding to its recon
    # (ROADMAP C, fault 4)
    if p.slices > 1 and p.aq_mode:
        bad["aq_mode"] = "on with slices"
    # the reference's host-syntax path writes no transform_size_8x8_flag
    # (its cores run no 8x8 transform) while its PPS turns the 8x8 mode
    # on: with the host-entropy backend its streams stop decoding to its
    # recon (ROADMAP C, fault 5)
    if p.transform_8x8 and p.backend == "device_host_entropy":
        bad["transform_8x8"] = "on with backend device_host_entropy"
    if bad:
        raise NotImplementedError(
            f"x264_tpu_torch does not run these settings yet: {bad}")


# the CAVLC blob's columns after its words, as the host gets them
# (``Encoder._host_copies``): nbits, then the cores' fields
_NBITS, _CLASS, _COST, _ICOST = 0, 1, 2, 3


def _append_mbs(bs: BitWriter, rows: np.ndarray, payload: "_HostCopy",
                skip_class) -> None:
    """Append a CAVLC slice's MB strings to ``bs``: the used words of the
    payload placed on the device (``kernels/bitpack.place``; its length
    the sum of the rows' nbits), once its copy has landed, and, when
    ``skip_class`` is given (P and B slices), the ue(mb_skip_run) of the
    skipped MBs after the last coded one.  ``rows``: the blob's columns
    after its words."""
    total = int(rows[:, _NBITS].astype(np.int64).sum())
    append_payload(bs, payload.numpy().view(np.uint32), total)
    if skip_class is not None:
        coded = rows[:, _CLASS] != skip_class
        last = np.nonzero(coded)[0][-1] if coded.any() else -1
        trailing = int(len(coded) - 1 - last)
        if trailing:
            bs.ue(trailing)


@dataclass
class ReconFrame:
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    frame_num: int = 0
    poc: int = 0
    # an anchor's colocated motion field for temporal direct: quadrant
    # mvs (N,4,2), intra MBs (N,), quadrant ref_idx (N,4) or None
    col_mv: torch.Tensor | None = None
    col_intra: torch.Tensor | None = None
    col_ref: torch.Tensor | None = None


class _HostCopy:
    """A device tensor's copy to host memory, started without blocking
    the host: pinned memory, a non-blocking copy on the tensor's stream
    and an event that ``numpy()`` waits on.  A CPU tensor is its own
    copy."""

    def __init__(self, t: torch.Tensor):
        self._ev = None
        if t.device.type == "cuda":
            self._buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._buf.copy_(t, non_blocking=True)
            self._ev = torch.cuda.Event()
            self._ev.record(torch.cuda.current_stream(t.device))
        else:
            self._buf = t

    def numpy(self) -> np.ndarray:
        if self._ev is not None:
            self._ev.synchronize()
        return self._buf.numpy()


@dataclass
class FrameStats:
    frame_type: str = "I"
    bits: int = 0
    qp: float = 0.0


class Encoder:
    """x264_encoder_open + x264_encoder_encode for the port's path: every
    frame is one job — upload, frame core, deblock on ``device`` — then
    the host CABAC coder or the append of the CAVLC payload placed on the
    device, and the Annex-B bytes.  ``device`` is where the
    frames are encoded: a CUDA device runs the hand-written kernels, the
    CPU their plain twins."""

    # the entropy ladders (levels per MB for CABAC, words per MB for
    # CAVLC), the reference's fixed two rungs each
    _RUNGS = {True: (96, 408), False: (64, 416)}

    def __init__(self, params: EncoderParams, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Encoder(device='cuda'): no CUDA device")
        self.p = params.validate()
        _check_params(self.p)
        self.sps = sps_from_params(self.p)
        self._sps_bytes = write_sps(self.sps, self.p)
        self._pps_bytes = write_pps(self.p)
        self.frame_idx = 0
        self.frame_num = 0
        self.idr_pic_id = 0
        self.dpb: list[ReconFrame] = []
        self._src_hist: list = []       # source luma per dpb slot (weightp)
        self.stats: list[FrameStats] = []
        self.last_recon: ReconFrame | None = None
        self.rc = RateControl(self.p)
        self._pass2_qps = None
        self._twopass_stats = []
        if self.p.stats_read:
            from x264_tpu_torch.rc.twopass import plan_pass2, read_stats
            entries = read_stats(self.p.stats_read)
            self._pass2_qps = plan_pass2(
                entries, self.p.bitrate or 1000,
                self.p.fps_num / max(1, self.p.fps_den),
                qp_min=self.p.qp_min, qp_max=self.p.qp_max)
        self._init_qp = self.p.qp      # PPS pic_init_qp base (frozen)
        # recon callback (display index, ReconFrame), fired as each
        # frame's reconstruction is final: an anchor at its submit, a B
        # frame at its finalize, so not in display order with B frames
        self.recon_hook = None
        # the band mesh's steps (``_sliced_mesh_step``)
        self._mesh_cache: dict = {}
        self._zones = []
        if self.p.zones:
            from x264_tpu_torch.params import parse_zones
            self._zones = parse_zones(self.p.zones)

    # -- x264_encoder_reconfig (encoder/encoder.c:1955) ----------------------
    RECONFIG_OK = frozenset((
        "qp", "crf", "bitrate", "qp_min", "qp_max", "me_range", "subpel",
        "scenecut_threshold", "deblock", "deblock_alpha", "deblock_beta",
        "weightp", "trellis", "aq_mode", "aq_strength", "keyint_max",
        "keyint_min", "vbv_maxrate", "vbv_bufsize", "rc_method",
        "log_level", "me_method"))

    def reconfig(self, **kw) -> None:
        """Change run-time parameters mid-stream.  Only the analysis/RC
        whitelist is reconfigurable (anything baked into SPS/PPS is
        rejected with ``ValueError``), and a value the port does not run
        raises ``NotImplementedError`` as it would at open."""
        bad = set(kw) - self.RECONFIG_OK
        if bad:
            raise ValueError(f"not reconfigurable: {sorted(bad)}")
        newp = self.p.clone(**kw).validate()
        _check_params(newp)
        self.p = newp
        self.rc.p = newp               # RC reads params dynamically

    def delayed_frames(self) -> int:
        """Frames buffered inside the encoder (B queue + lookahead +
        deferred mini-GOP finalize + the pipelined frame) —
        x264_encoder_delayed_frames."""
        n = len(self._bq or [])
        n += len(self._mbt_q or [])
        n += len(self._gop_q or [])
        n += 1 if getattr(self, "_pending", None) is not None else 0
        return n

    # ---- periodic intra refresh (PIR) sweep state ----
    _pir_col = None          # next column to refresh, or None (no sweep)
    _pir_restart = False

    def _pir_w(self) -> int:
        """Columns refreshed per P frame: a sweep spans ~keyint frames
        (encoder.c:3626 refresh-bar advance)."""
        k = max(2, self.p.keyint_max or 2)
        return max(1, -(-self.p.mb_width // (k - 1)))

    def _pir_args(self, idr: bool):
        """(pir_ncols, pir_col, pir_bound, recovery-point SEI bytes) for
        this frame, advancing the sweep; the SEI at a sweep's start."""
        if not self.p.intra_refresh or idr:
            return 0, None, None, b""
        sei = b""
        if self._pir_restart or (
                self.p.keyint_max > 1
                and self.frame_idx % self.p.keyint_max == 0):
            self._pir_col = 0
            self._pir_restart = False
            sei = recovery_point_sei(
                -(-self.p.mb_width // self._pir_w()))
        if self._pir_col is None or self._pir_col >= self.p.mb_width:
            return 0, None, None, sei
        col = self._pir_col
        self._pir_col = col + self._pir_w()
        return (self._pir_w(), np.int32(col), np.int32(16 * col), sei)

    def intra_refresh(self) -> None:
        """Request a refresh at the earliest opportunity
        (x264_encoder_intra_refresh).  With ``intra_refresh`` this
        restarts the PIR sweep (no IDR, encoder.c:3280); otherwise it
        forces the next frame to IDR."""
        if self.p.intra_refresh:
            self._pir_restart = True
            return
        if self._force is None:
            self._force = {}
        self._force[self._in_disp] = ("IDR", None)

    def invalidate_reference(self, frame_num: int) -> int:
        """Stop predicting from pictures with frame_num >= the given
        coded frame number (x264_encoder_invalidate_reference: the
        downstream decoder lost them); the recovery is an immediate
        refresh (``intra_refresh``).  Returns how many DPB pictures were
        invalid."""
        invalid = sum(1 for r in self.dpb if r.frame_num >= frame_num)
        if invalid:
            self.intra_refresh()
        return invalid

    # -- x264_encoder_headers ------------------------------------------------
    def headers(self) -> bytes:
        out = self._sps_bytes + self._pps_bytes
        if self.p.sei_version:
            out += version_sei(self.p)
        return out

    # access-unit metadata log (container muxing: pts/dts/keyframe)
    _au_meta: list = None
    _cod_count = 0

    def _note_au(self, nbytes: int, ftype: str, poc_lsb: int):
        if self._au_meta is None:
            self._au_meta = []
        disp = (self._idr_disp + poc_lsb // 2 if self.p.bframes
                else self._cod_count)
        self._au_meta.append(dict(bytes=nbytes, pts=disp,
                                  dts=self._cod_count,
                                  key=ftype == "IDR"))
        self._cod_count += 1

    def drain_au_meta(self) -> list:
        """Access units (sizes within the bytes returned so far, pts/dts
        in frame units, keyframe flags) since the last drain — the
        x264_picture_t out-fields analog for muxers."""
        m = self._au_meta or []
        self._au_meta = []
        return m

    # NAL HRD timing SEI state (coded-order counters)
    _hrd_cod_since_bp = 0
    _hrd_cod_total = 0

    def _hrd_sei(self, idr: bool, poc_lsb: int) -> bytes:
        """Buffering-period SEI at each IDR + pic-timing SEI per frame
        when ``nal_hrd`` (D.1.1/D.1.2; x264 encoder.c:3700 emission
        points).  Delays use the 24-bit lengths the VUI declares."""
        if not self.p.nal_hrd:
            return b""
        out = b""
        if idr:
            d90k = int(90000 * self.p.vbv_bufsize * self.p.vbv_init
                       / max(1, self.p.vbv_maxrate))
            out += buffering_period_sei(d90k)
            self._hrd_cod_since_bp = 0
        reorder = 1 if self.p.bframes else 0
        disp = (self._idr_disp + poc_lsb // 2 if self.p.bframes
                else self._hrd_cod_total)
        out += pic_timing_sei(
            2 * self._hrd_cod_since_bp,
            max(0, 2 * (disp + reorder - self._hrd_cod_total)))
        self._hrd_cod_since_bp += 1
        self._hrd_cod_total += 1
        return out

    def _entropy_kw(self, budget: int) -> dict:
        """The cores' entropy argument: the CABAC blob's level capacity
        or the CAVLC word budget per MB."""
        return dict(lv_cap=budget) if self.p.cabac else dict(n_words=budget)

    def _host_copies(self, out: dict, n_words: int) -> dict:
        """A core's ``host_blob`` replaced by its ``_HostCopy``, in place.
        With CAVLC the MBs' strings are first placed in the slice payload
        on the device (``kernels/bitpack.place``), which comes back as
        ``host_payload``, and the host gets only the blob's columns after
        its words (``_NBITS``, ``_CLASS``, ...)."""
        blob = out["host_blob"]
        if not self.p.cabac:
            out["host_payload"] = _HostCopy(place(blob, n_words))
            blob = blob[:, n_words:].contiguous()
        out["host_blob"] = _HostCopy(blob)
        return out

    def _cab_rows(self, blob, n: int, is_b: bool = False,
                  parts: bool = False, i4: bool = False):
        """Per-MB field rows of a flat CABAC blob (entropy_pack layout)."""
        st = blob_stride(is_b, parts, i4)
        return np.asarray(blob).reshape(-1)[:n * st].reshape(n, st)

    def _syn_path(self) -> bool:
        """Frames go through the host FrameSyntax writers (instead of the
        device-packed fast path): the reference backend, the host-entropy
        debug backend, and I4x4 with CAVLC (the device CAVLC word packer
        has no I4 header support)."""
        return (self.p.backend in ("reference", "device_host_entropy")
                or (self.p.i4x4 and not self.p.cabac))

    def _use_device(self) -> bool:
        """The frame cores run on ``device``, unless the caller asked for
        the NumPy tier (``backend="reference"``); ``auto`` is the
        device."""
        return self.p.backend != "reference"

    def _run_core(self, yd, ud, vd, ref, idr: bool, base_qp: int, qp_arr,
                  n_words: int, mbw: int, mbh: int, wts=None, pir=None):
        """Run the I or P core; ``host_blob`` comes back as a
        ``_HostCopy``, the one device-to-host copy of a frame.  An I
        frame takes ``i4_frame_core`` with i4x4 (at the lambda of the
        frame QP, as the reference), else ``i_frame_core``; on the card
        as a CUDA graph replay.  A P frame searches every reference of
        ``ref`` (the DPB in list0 order, stacked on the device when
        there are several), weights its prediction by ``wts`` (K, 2)
        when given and codes the refresh bar ``pir`` = (pir_ncols,
        pir_col, pir_bound) when given."""
        qp = torch.as_tensor(np.asarray(qp_arr, np.int32),
                             device=self.device)
        if idr or ref is None:
            kw = dict(mbw=mbw, mbh=mbh, cqp_off=self.p.chroma_qp_offset,
                      trellis_tbl=self._trellis_tbl(base_qp, "I"),
                      **self._entropy_kw(n_words))
            core, args = i_frame_core, (yd, ud, vd, qp)
            if self.p.i4x4 and self.p.cabac:
                # with CAVLC I4x4 runs on the host-syntax path; the fast
                # path (encode_pipelined) codes I16 there, as the
                # reference's does
                core, args = i4_frame_core, args + (sad_lambda(base_qp),)
                kw["t8_mode"] = self.p.transform_8x8
            out = run_core(core, *args, **kw) \
                if self.device.type == "cuda" else core(*args, **kw)
            slice_type = SLICE_I
        else:
            if len(ref) == 1:
                ry, ru, rv = ref[0].y, ref[0].u, ref[0].v
            else:
                ry, ru, rv = (torch.stack([getattr(r, c) for r in ref])
                              for c in "yuv")
            pkw = {}
            if pir is not None and pir[0]:
                pkw = dict(pir_ncols=pir[0], pir_col=int(pir[1]),
                           pir_bound=int(pir[2]))
            out = p_frame_core(yd, ud, vd, ry, ru, rv, qp,
                               sad_lambda(base_qp), mbw=mbw, mbh=mbh,
                               me_range=self.p.me_range,
                               cqp_off=self.p.chroma_qp_offset,
                               subpel=self.p.subpel, parts=self.p.p8x8,
                               decimate=self.p.dct_decimate,
                               t8=self.p.transform_8x8,
                               trellis_tbl=self._trellis_tbl(base_qp, "P"),
                               wts=wts, **pkw, **self._entropy_kw(n_words))
            slice_type = SLICE_P
        return self._host_copies(out, n_words), slice_type

    def _trellis_tbl(self, qp: int, slice_type: str):
        """The frame's trellis cost bundle (``frame_trellis`` at the RD
        slope me_lambda), or None when trellis is off or the coder is
        CAVLC; the reference's static ctx-init tables, never the coder's
        live states."""
        if not (self.p.trellis and self.p.cabac):
            return None
        return frame_trellis(qp, slice_type, me_lambda(qp),
                             self.p.transform_8x8)

    def _note_recon(self, disp, rec) -> None:
        if self.recon_hook is not None and disp is not None:
            self.recon_hook(disp, rec)

    def _zone_qp(self, disp, qp: int) -> int:
        """Per-range RC override (x264 --zones, ratecontrol.c:1346
        zone_for_frame + rate_estimate_qscale's zone application):
        q= forces the QP, b= scales bits (qp -= 6*log2(factor))."""
        if not self._zones or disp is None:
            return qp
        for (s, e, (k, v)) in self._zones:
            if s <= disp <= e:
                if k == "q":
                    return int(np.clip(v, 0, 51))
                return int(np.clip(round(qp - 6.0 * np.log2(v)),
                                   self.p.qp_min, self.p.qp_max))
        return qp

    def _requantize_idr(self, qp: int) -> int:
        """Re-derive the frame QP when a P frame is promoted to IDR."""
        return max(self.p.qp_min, qp - self.rc.IP_OFFSET)

    # Entropy budget: the reference's fixed two-rung ladder, of level-stream
    # capacities for CABAC (lv_cap K, levels per MB on average) or of
    # words per MB for CAVLC.  After an overflow the floor ratchets up and
    # stays up; the bytes depend on the rung only through the overflow
    # re-run.
    _rung_floor = 0

    def _ladder(self, qp: int) -> list:
        full = self._RUNGS[self.p.cabac]
        keep = [r for r in full if r >= self._rung_floor]
        return keep if keep else [full[-1]]

    def _note_budget(self, cabac: bool, observed: int):
        """Record a frame's observed entropy size; ratchet the ladder
        floor so a rung that overflowed once is never retried."""
        full = self._RUNGS[cabac]
        for r in full:
            if observed <= r:
                if r > self._rung_floor:
                    self._rung_floor = r
                return
        self._rung_floor = full[-1]

    def _deblock_device(self, out, qp, mbw, mbh):
        ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
        if not self.p.deblock:
            return ry, ru, rv
        n = mbw * mbh
        zeros = torch.zeros(n, dtype=torch.int32, device=self.device)
        if "mv8" in out:
            # quadrant-granular mvs/refs when partitions are active (the
            # internal-edge mv-discontinuity bS rule needs them)
            mv, ref = out["mv8"], out["ref8"]
        else:
            mv = out["mv"] if "mv" in out else zeros[:, None].expand(n, 2)
            ref = out.get("ref_mb", zeros)
        has_t8 = self.p.transform_8x8 and "t8" in out
        return deblock_frame(
            ry, ru, rv, out["mb_class"], out["cbp_luma"], out["cbp_chroma"],
            out.get("nnz_deblock", out["luma_nnz"]), mv, ref, out["qp_mb"],
            self.p.deblock_alpha * 2, self.p.deblock_beta * 2, mbw=mbw,
            mbh=mbh, cqp_off=self.p.chroma_qp_offset,
            t8=out["t8"] if has_t8 else None)

    def _submit_device(self, y, u, v, ftype: str, qp: int) -> dict:
        """Upload the frame, run its core and deblock, advance the DPB."""
        if self.p.slices > 1:
            return self._submit_device_sliced(y, u, v, ftype, qp)
        h, w = y.shape
        mbw, mbh = w // 16, h // 16
        idr = ftype == "IDR"
        ladder = self._ladder(qp)
        n_words = ladder[0]
        yd, ud, vd = self._upload((y, u, v))
        qp_arr, slice_qp = self._qp_map(qp, y, u, v, mbw, mbh)
        if self._mbt_off is not None:
            base = np.broadcast_to(np.atleast_1d(qp_arr),
                                   (mbw * mbh,)).astype(np.float64)
            qp_arr = np.clip(np.round(base + self._mbt_off),
                             self.p.qp_min, self.p.qp_max).astype(np.int32)
            slice_qp = int(qp_arr[0])
        ref = None if (idr or not self.dpb) else self.dpb
        pir = None
        pir_sei = b""
        if self.p.intra_refresh:
            ncols, col, bound, pir_sei = self._pir_args(idr or ref is None)
            if ncols:
                pir = (ncols, col, bound)
        wts = weights = None
        if self.p.weightp and ref is not None:
            # weight analysis from the source frames (models/weightp.py),
            # on the host: the decision waits on nothing from the card;
            # one (K, 2) upload per frame
            weights = analyse_weights(y, self._src_hist[:len(ref)])
            wts = torch.as_tensor(np.asarray(weights, np.int32),
                                  device=self.device)
        out, slice_type = self._run_core(yd, ud, vd, ref, idr, qp, qp_arr,
                                         n_words, mbw, mbh, wts=wts,
                                         pir=pir)
        if (ref is not None and self.p.scenecut_threshold > 0
                and not self.p.intra_refresh
                and self.p.bframes == 0
                and self.frame_idx - self._last_idr_idx
                >= self.p.keyint_min
                and self._pending is None):
            # post-encode scenecut (x264 slicetype.c:1430 rule, no
            # lookahead): promote to IDR when inter is no cheaper than
            # intra, from the costs the P core already computed (B GOPs
            # cut before the encode instead, _lowres_scenecut)
            blob = out["host_blob"].numpy()
            if self.p.cabac:
                rows = self._cab_rows(blob, mbw * mbh, parts=self.p.p8x8)
                p_cost = float(rows[:, 14 + 9].astype(np.int64).sum())
                i_cost = float(rows[:, 14 + 10].astype(np.int64).sum())
            else:
                p_cost = float(blob[:, _COST].astype(np.int64).sum())
                i_cost = float(blob[:, _ICOST].astype(np.int64).sum())
            if p_cost >= (1.0 - self.p.scenecut_threshold / 100.0) * i_cost:
                idr = True
                ftype = "IDR"
                self.frame_num = 0
                self._last_idr_idx = self.frame_idx
                qp = self._requantize_idr(qp)
                qp_arr, slice_qp = self._qp_map(qp, y, u, v, mbw, mbh)
                out, slice_type = self._run_core(yd, ud, vd, None, True, qp,
                                                 qp_arr, n_words, mbw, mbh)
        recon = self._deblock_device(out, qp, mbw, mbh)
        job = dict(out=out, slice_type=slice_type, idr=idr, qp=qp,
                   blob=out["host_blob"],
                   num_ref=1 if ref is None else len(ref), qp_arr=qp_arr,
                   slice_qp=slice_qp, mbw=mbw, mbh=mbh, n_words=n_words,
                   ladder=ladder, frame_num=self.frame_num,
                   idr_pic_id=self.idr_pic_id, ftype=ftype,
                   planes=(yd, ud, vd), ref=ref,
                   wts=None if idr else wts, pir=pir, pir_sei=pir_sei,
                   weights=None if idr else weights)
        # advance encoder state now (dpb is list0 order, sliding window;
        # the source history follows it and restarts at every IDR, a
        # scenecut-promoted one included); a VBV re-encode rewrites the
        # job's ReconFrame in place
        new = ReconFrame(*recon, frame_num=self.frame_num)
        job["rec"] = new
        self.dpb = ([new] + ([] if idr else self.dpb))[:self.p.ref_frames]
        if self.p.weightp:
            self._src_hist = ([y] + ([] if idr else self._src_hist)
                              )[:self.p.ref_frames]
        self.last_recon = new
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.log2_max_frame_num)
        self.frame_idx += 1
        return job

    # ---- multi-slice frames: bands of MB rows, one slice NAL each ----

    def _band_core(self, job: dict, b: int, n_words: int) -> dict:
        """Band ``b`` of a sliced job through the I16 core (on the card a
        graph replay, one key per band height and rung) or ``p_band_core``
        on the band's rows of the padded references, on the band's card
        in a mesh job (``job["devices"]``), else on the encoder's;
        ``host_blob`` comes back as a ``_HostCopy``.  The band is coded as
        a frame of its own: nothing above or below it is available to its
        MBs."""
        y0, bh = int(job["starts"][b]), job["heights"][b]
        mbw, qp = job["mbw"], job["qp"]
        ekw = self._entropy_kw(n_words)
        if job["refpads"] is None:
            yd, ud, vd = job["planes"]
            yb, ub, vb = (yd[16 * y0:16 * (y0 + bh)],
                          ud[8 * y0:8 * (y0 + bh)], vd[8 * y0:8 * (y0 + bh)])
            kw = dict(mbw=mbw, mbh=bh, cqp_off=self.p.chroma_qp_offset,
                      **ekw)
            out = (run_core(i_frame_core, yb, ub, vb, qp, **kw)
                   if self.device.type == "cuda"
                   else i_frame_core(yb, ub, vb, qp, **kw))
            return self._host_copies(out, n_words)
        dev = job["devices"][b] if job["devices"] else self.device
        out = run_band(dev, job["planes"], job["refpads"], y0, bh, qp,
                       sad_lambda(qp), mbw, me_range=self.p.me_range,
                       cqp_off=self.p.chroma_qp_offset,
                       subpel=self.p.subpel, **ekw)
        with on_card(dev):
            return self._host_copies(out, n_words)

    def _mesh_on(self, idr: bool, nsl: int, rem: int) -> bool:
        """A sliced frame's bands run on the band mesh, one a device, under
        the reference's condition (x264_tpu/api.py:545-547): ``threads``
        > 1, a P frame on bands of equal height, CAVLC, and at least
        ``nsl`` devices (on the CPU the bands run in turn, the reference's
        virtual CPU devices); otherwise the band loop runs, as the
        reference's does with fewer devices."""
        return (self.p.threads > 1 and not idr and rem == 0 and nsl > 1
                and not self.p.cabac
                and (self.device.type != "cuda"
                     or torch.cuda.device_count() >= nsl))

    def _sliced_mesh_step(self, nsl: int, mbw: int, mbh_per_band: int,
                          n_words: int):
        """The band step over an ``nsl``-device mesh, cached per key."""
        key = (nsl, mbw, mbh_per_band, n_words, self.p.subpel,
               self.p.me_range)
        if key not in self._mesh_cache:
            step, _ = build_sliced_p_step(
                make_band_mesh(nsl, self.device), mbw=mbw,
                mbh_per_band=mbh_per_band, me_range=self.p.me_range,
                cqp_off=self.p.chroma_qp_offset, n_words=n_words,
                subpel=self.p.subpel)
            self._mesh_cache[key] = step
        return self._mesh_cache[key]

    def _submit_device_sliced(self, y, u, v, ftype: str, qp: int) -> dict:
        """A multi-slice frame (the reference's ``_submit_device_sliced``,
        its band loop): the MB rows split into min(slices, mbh) bands, the
        first ``mbh % nsl`` one row taller; each band through its core,
        the frame deblocked from the bands' outputs, one slice NAL per
        band at finalize.  Slice-local entropy (nC availability, skip runs,
        the QP chain, the MVP) follows from coding each band on its own,
        as x264's sliced threads do.  An IDR or a P frame on the newest
        reference only, every MB at the frame QP (AQ is refused with
        slices: ROADMAP C, fault 4; MB-tree is off); no scenecut
        promotion.  Under ``_mesh_on`` (``threads`` > 1, a P frame, CAVLC,
        enough cards) the bands run on the band mesh, one a card
        (``parallel/sliced.py``): each band's blob is placed in its slice
        payload on its own card, and the deblock runs on the encoder's
        card from the fields gathered there, as after the loop."""
        h, w = y.shape
        mbw, mbh = w // 16, h // 16
        idr = ftype == "IDR" or not self.dpb
        if idr:
            ftype = "IDR"
        nsl = max(1, min(self.p.slices, mbh))
        base, rem = divmod(mbh, nsl)
        heights = [base + (1 if i < rem else 0) for i in range(nsl)]
        starts = np.concatenate(([0], np.cumsum(heights)))[:-1]
        # the fixed ladder of the stream's coder, not the ratcheting
        # ``_ladder`` (the reference's sliced path keeps its own)
        ladder = self._RUNGS[self.p.cabac]
        yd, ud, vd = self._upload((y, u, v))
        ref = None if idr else self.dpb[0]
        refpads = None if ref is None else (
            pad_edge(ref.y, PAD), pad_edge(ref.u, PAD // 2),
            pad_edge(ref.v, PAD // 2))
        job = dict(sliced=True, starts=starts, heights=heights,
                   slice_type=SLICE_I if idr else SLICE_P, idr=idr, qp=qp,
                   mbw=mbw, mbh=mbh, n_words=ladder[0], ladder=ladder,
                   planes=(yd, ud, vd), refpads=refpads, devices=None,
                   frame_num=self.frame_num, idr_pic_id=self.idr_pic_id,
                   ftype=ftype)
        if self._mesh_on(idr, nsl, rem):
            step = self._sliced_mesh_step(nsl, mbw, base, ladder[0])
            job["devices"] = step.devices
            # every band enqueued on its card before any is placed
            outs = step.bands(yd, ud, vd, *refpads, qp, sad_lambda(qp))
            for dev, o in zip(step.devices, outs):
                with on_card(dev):
                    self._host_copies(o, ladder[0])
        else:
            outs = [self._band_core(job, b, ladder[0]) for b in range(nsl)]
        # the whole frame's recon and deblock from the bands' outputs, on
        # the encoder's card
        keys = ("recon_y", "recon_u", "recon_v", "mb_class", "luma_nnz",
                "cbp_luma", "cbp_chroma", "qp_mb") + (() if idr else ("mv",))
        full = gather(outs, keys, self.device)
        if idr:
            full["mv"] = torch.zeros((mbw * mbh, 2), dtype=torch.int32,
                                     device=self.device)
        recon = self._deblock_device(full, qp, mbw, mbh)
        job["outs"] = outs
        new = ReconFrame(*recon, frame_num=self.frame_num)
        job["rec"] = new
        self.dpb = [new]
        self.last_recon = new
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.log2_max_frame_num)
        self.frame_idx += 1
        return job

    def _rerun_band(self, job: dict, b: int, n_words: int) -> dict:
        """Re-run one band at a larger entropy budget (its recon does not
        depend on the budget; only the blob changes), on its own card in a
        mesh job."""
        return self._band_core(job, b, n_words)

    def _finalize_device_sliced(self, job: dict) -> bytes:
        """A multi-slice frame's bytes: per band, the re-run at the next
        rung of the fixed ladder while its blob overflows (past the last
        rung the reference raises, and so does the port), the slice header
        with the band's first MB and QP, and its CABAC payload or CAVLC
        payload with the trailing mb_skip_run; then the frame's
        stats.  There is no VBV re-encode: a sliced frame has only rate
        control's soft clip, as in the reference."""
        mbw = job["mbw"]
        cab = self.p.cabac
        out_bytes = self._frame_prefix(job)
        total_cost = 0
        classes = []
        for b, ob in enumerate(job["outs"]):
            n_words = job["n_words"]
            bh = job["heights"][b]
            nmb = bh * mbw
            blob = ob["host_blob"].numpy()

            def over(blob, n_words):
                if cab:
                    rows = self._cab_rows(blob, nmb)
                    return int(rows[:, 14 + 8].astype(np.int64).sum()) \
                        > nmb * n_words
                return int(blob[:, _NBITS].max(initial=0)) > 32 * n_words

            if over(blob, n_words):
                for n_words in job["ladder"][1:]:
                    ob = self._rerun_band(job, b, n_words)
                    blob = ob["host_blob"].numpy()
                    if not over(blob, n_words):
                        break
                else:
                    raise RuntimeError(
                        "sliced entropy overflow beyond the largest budget")
            first_mb = int(job["starts"][b]) * mbw
            if cab:
                rows = self._cab_rows(blob, nmb)
                mb_class = rows[:, 14]
                total_cost += int(rows[:, 14 + 9].astype(np.int64).sum())
            else:
                mb_class = blob[:, _CLASS]
                total_cost += int(blob[:, _COST].astype(np.int64).sum())
            classes.append(mb_class)
            bs = BitWriter()
            write_slice_header(bs, self.p, self.sps, init_qp=self._init_qp,
                               slice_type=job["slice_type"], idr=job["idr"],
                               frame_num=job["frame_num"],
                               idr_pic_id=job["idr_pic_id"],
                               first_mb=first_mb, qp=job["qp"], num_ref=1)
            if cab:
                pad = (-bs.bit_length) % 8
                if pad:
                    bs.put(pad, (1 << pad) - 1)  # cabac_alignment_one_bit
                payload = write_slice_cabac(
                    blob, mbw, bh, 0 if job["slice_type"] == SLICE_I else 1,
                    job["qp"], n_words, t8_mode=self.p.transform_8x8)
                out_bytes += wrap_slice_nal(bs.to_bytes_aligned() + payload,
                                            job["idr"])
            else:
                _append_mbs(bs, blob, ob["host_payload"],
                            skip_class=MB_PSKIP if job["slice_type"]
                            == SLICE_P else None)
                out_bytes += wrap_slice_nal(bs.to_rbsp(), job["idr"])
        self._account(job, len(out_bytes), total_cost,
                      np.concatenate(classes))
        return out_bytes

    def _vbv_retry_qp(self, job: dict, nbytes: int):
        """Frame-grain VBV hard guarantee: if the coded frame would
        underflow the decoder buffer, return a bumped QP to re-encode at
        (the batched analog of x264's row-VBV rollback + re-encode,
        ratecontrol.c:1590 x264_ratecontrol_mb + encoder.c:2770 bs_bak;
        the rollback unit is the frame).  Anchors only: B frames rely on
        the soft clip_qscale bound."""
        rc = self.rc
        if not rc.vbv_on or job.get("vbv_tries", 0) >= 8:
            return None
        budget = min(rc.vbv_fill + rc.vbv_max / rc.fps, rc.vbv_size)
        if nbytes * 8 <= max(budget, 1.0):
            return None
        d = max(1, int(np.ceil(6.0 * np.log2(
            nbytes * 8.0 / max(budget, 1.0)))))
        nq = int(np.clip(job["qp"] + d, self.p.qp_min, self.p.qp_max))
        return nq if nq > job["qp"] else None

    def _vbv_reencode(self, job: dict, nq: int) -> dict:
        """Re-run the frame core at the bumped QP and rewrite the DPB
        recon in place (the job's ReconFrame is the object the DPB
        holds; nothing has been submitted against it yet: with VBV the
        finalize queue drains before new submits).  On the card an IDR
        replays its core's graph at the new QP."""
        dq = nq - job["qp"]
        qp_arr = np.clip(np.asarray(job["qp_arr"]) + dq,
                         self.p.qp_min, self.p.qp_max).astype(np.int32)
        if np.ndim(qp_arr) == 0:
            qp_arr = np.int32(qp_arr)
        yd, ud, vd = job["planes"]
        out, _ = self._run_core(yd, ud, vd, job["ref"], job["idr"], nq,
                                qp_arr, job["n_words"], job["mbw"],
                                job["mbh"], wts=job.get("wts"),
                                pir=job.get("pir"))
        job = dict(job, qp=nq, slice_qp=int(np.atleast_1d(qp_arr)[0]),
                   qp_arr=qp_arr, out=out, blob=out["host_blob"],
                   vbv_tries=job.get("vbv_tries", 0) + 1)
        recon = self._deblock_device(out, nq, job["mbw"], job["mbh"])
        rec = job.get("rec")
        if rec is not None:
            rec.y, rec.u, rec.v = recon
            if "mv8" in out or "mv" in out:
                self._set_colocated(rec, out, job["mbw"] * job["mbh"])
        self.last_recon = rec if rec is not None else self.last_recon
        return job

    def _finalize_device(self, job: dict) -> bytes:
        """An I or P frame's bytes, by the stream's entropy coder; a
        multi-slice frame's slice by slice."""
        if job.get("sliced"):
            return self._finalize_device_sliced(job)
        return (self._finalize_cabac(job) if self.p.cabac
                else self._finalize_cavlc(job))

    def _frame_prefix(self, job: dict) -> bytes:
        """What goes before an anchor's slice NAL: the repeated headers
        at an IDR, the refresh sweep's recovery-point SEI and the NAL
        HRD timing SEIs (the HRD counters advance at every call, a VBV
        re-encode's finalize included, as in the reference)."""
        out = b""
        if job["ftype"] == "IDR" and self.p.repeat_headers:
            out += self.headers()
        out += job.get("pir_sei", b"")
        return out + self._hrd_sei(job["idr"], job.get("poc_lsb", 0))

    def _slice_writer(self, job: dict) -> BitWriter:
        """A BitWriter holding the frame's slice header."""
        bs = BitWriter()
        write_slice_header(bs, self.p, self.sps, init_qp=self._init_qp,
                           slice_type=job["slice_type"], idr=job["idr"],
                           frame_num=job["frame_num"],
                           idr_pic_id=job["idr_pic_id"], qp=job["slice_qp"],
                           num_ref=job["num_ref"],
                           poc_lsb=job.get("poc_lsb", 0),
                           weights=job["weights"])
        return bs

    def _account(self, job: dict, nbytes: int, cost: int,
                 mb_class) -> None:
        """Stats, rate control and the access-unit log of an I or P
        frame."""
        self.stats.append(FrameStats(job["ftype"], nbytes * 8, job["qp"]))
        self.rc.update(job["ftype"], nbytes * 8, cost)
        self._record_stats(job["ftype"], job["qp"], nbytes * 8, cost,
                           mb_class)
        self._note_au(nbytes, job["ftype"], job.get("poc_lsb", 0))

    def _finalize_cabac(self, job: dict) -> bytes:
        """The frame's bytes (the reference's ``_finalize_device`` on its
        CABAC branch): re-run the core at the next entropy rung when the
        level stream overflowed, then the slice header and the C CABAC
        coder (``write_slice_cabac``)."""
        blob = job["blob"].numpy()
        K = job["n_words"]
        n = job["mbw"] * job["mbh"]
        parts = self.p.p8x8 and job["slice_type"] == SLICE_P
        i4 = self.p.i4x4 and job["slice_type"] == SLICE_I
        rows = self._cab_rows(blob, n, parts=parts, i4=i4)
        total = int(rows[:, 14 + 8].astype(np.int64).sum())
        if total > n * K:
            # frame-level stream overflow: re-run at the next capacity
            yd, ud, vd = job["planes"]
            for K in job["ladder"][1:]:
                job["n_words"] = K
                out, _ = self._run_core(yd, ud, vd, job["ref"], job["idr"],
                                        job["qp"], job["qp_arr"], K,
                                        job["mbw"], job["mbh"],
                                        wts=job["wts"], pir=job["pir"])
                blob = out["host_blob"].numpy()
                rows = self._cab_rows(blob, n, parts=parts, i4=i4)
                total = int(rows[:, 14 + 8].astype(np.int64).sum())
                if total <= n * K:
                    break
        self._note_budget(True, -(-total // n))
        mb_class = rows[:, 14]

        out_bytes = self._frame_prefix(job)
        bs = self._slice_writer(job)
        pad = (-bs.bit_length) % 8
        if pad:
            bs.put(pad, (1 << pad) - 1)    # cabac_alignment_one_bit
        kind = 0 if job["slice_type"] == SLICE_I else 1
        payload = write_slice_cabac(blob, job["mbw"], job["mbh"], kind,
                                    job["slice_qp"], K, parts=parts,
                                    t8_mode=self.p.transform_8x8, i4=i4,
                                    num_ref=job["num_ref"] if kind else 1)
        out_bytes += wrap_slice_nal(bs.to_bytes_aligned() + payload,
                                    job["idr"])
        nq = self._vbv_retry_qp(job, len(out_bytes))
        if nq is not None:
            return self._finalize_cabac(self._vbv_reencode(job, nq))
        self._account(job, len(out_bytes),
                      int(rows[:, 14 + 9].astype(np.int64).sum()), mb_class)
        return out_bytes

    def _finalize_cavlc(self, job: dict) -> bytes:
        """The frame's bytes (the reference's ``_finalize_device`` on its
        CAVLC branch): re-run the core at the next word budget when an
        MB's packed string overflowed, then the slice header, the payload
        of the MBs' strings and, in a P slice, the trailing
        ue(mb_skip_run)."""
        blob = job["blob"].numpy()
        out = job["out"]
        n_words = job["n_words"]
        nbits = blob[:, _NBITS]
        if int(nbits.max(initial=0)) > 32 * n_words:
            # an MB past its word budget: re-run the entropy at a bigger
            # one (reference encoder/encoder.c:2893 re-encode pattern)
            yd, ud, vd = job["planes"]
            for n_words in job["ladder"][1:]:
                out, _ = self._run_core(yd, ud, vd, job["ref"], job["idr"],
                                        job["qp"], job["qp_arr"], n_words,
                                        job["mbw"], job["mbh"],
                                        wts=job["wts"], pir=job["pir"])
                blob = out["host_blob"].numpy()
                nbits = blob[:, _NBITS]
                if int(nbits.max(initial=0)) <= 32 * n_words:
                    break
        self._note_budget(False, -(-int(nbits.max(initial=0)) // 32))
        mb_class = blob[:, _CLASS]

        out_bytes = self._frame_prefix(job)
        bs = self._slice_writer(job)
        _append_mbs(bs, blob, out["host_payload"],
                    skip_class=MB_PSKIP if job["slice_type"] == SLICE_P
                    else None)
        out_bytes += wrap_slice_nal(bs.to_rbsp(), job["idr"])
        nq = self._vbv_retry_qp(job, len(out_bytes))
        if nq is not None:
            return self._finalize_cavlc(self._vbv_reencode(job, nq))
        self._account(job, len(out_bytes),
                      int(blob[:, _COST].astype(np.int64).sum()), mb_class)
        return out_bytes

    # ---- B-frame mini-GOPs (I/P anchors, B frames between them, temporal
    # direct; the reference's device fast path without VBV) ----
    _bq: list = None          # pending (frame, display index)
    _disp_idx = 0
    _idr_disp = 0
    # deferred finalize queue [("a" | "b", job), ...]: mini-GOP k's device
    # work runs while the host codes mini-GOP k-1, so bytes come out one
    # mini-GOP late; flush() and IDR boundaries drain it
    _gop_q: list = None

    def _poc_lsb(self, disp: int) -> int:
        """Unwrapped POC 2*(disp - idr_disp): temporal direct's tb/td take
        the unwrapped values (8.4.1.2.3); write_slice_header masks."""
        return 2 * (disp - self._idr_disp)

    def _dist_scale(self, disp: int, prev: ReconFrame,
                    nxt: ReconFrame) -> tuple:
        """(POC, DistScaleFactor) of the B frame at ``disp`` between the
        anchors ``prev`` and ``nxt`` (8.4.1.2.3, host integer math)."""
        poc_cur = self._poc_lsb(disp)
        tb = int(np.clip(poc_cur - prev.poc, -128, 127))
        td = int(np.clip(nxt.poc - prev.poc, -128, 127)) or 1
        tx = (16384 + abs(td) // 2) // td
        return poc_cur, int(np.clip((tb * tx + 32) >> 6, -1024, 1023))

    def _encode_bgop(self, fr: Frame420) -> bytes:
        if self._bq is None:
            self._bq = []
        d = self._disp_idx
        self._disp_idx += 1
        out = b""
        f_type = self._force.get(d, (None, None))[0] if self._force \
            else None
        if f_type is None and d > 0 and self._lowres_scenecut(fr, d):
            # pre-encode scenecut (slicetype.c:1430 lowres rule): cut
            # before the encode, not the bframes=0 encode-then-promote
            f_type = "IDR"
        if d == 0 or f_type == "IDR" or (self.p.keyint_max > 0
                                         and d % self.p.keyint_max == 0):
            # close the open mini-GOP (not flush(): fed from the MB-tree
            # queue, flush() would pull later display frames ahead)
            out += self._flush_rest()
            self._idr_disp = d
            out += self._encode_anchor(fr, d, "IDR")
            if self.p.b_adapt:
                self._lookahead().push_anchor(self._pad(fr)[0])
            return out
        self._bq.append((fr, d))
        if f_type == "P":
            return out + self._flush_bq()
        if len(self._bq) == self.p.bframes + 1:
            if self.p.b_adapt:
                # adaptive mini-GOP cut (slicetype b_adapt=1 analog):
                # lowres costs pick how many queued frames stay B
                m = self._lookahead().plan(
                    [self._pad(f)[0] for (f, _) in self._bq])
                split = min(m + 1, len(self._bq))
                pend, self._bq = self._bq[:split], self._bq[split:]
                out += self._flush_bq(pend)
            else:
                out += self._flush_bq()
        return out

    _sc_prev_lr = None

    def _lowres_scenecut(self, fr, d: int) -> bool:
        """Lowres inter-vs-intra scene test on the source frames (x264
        lookahead scenecut, slicetype.c:1430), for B GOPs: one esa16
        search at range 8 of this frame's lowres plane against the
        previous frame's, beside the lowres intra estimate."""
        if not self.p.scenecut_threshold:
            return False
        y, _, _ = self._pad(fr)
        lr = lowres_plane(self._upload((y,))[0])
        prev = self._sc_prev_lr
        self._sc_prev_lr = lr
        if prev is None:
            return False
        mbw_lr, mbh_lr = lr.shape[1] // 16, lr.shape[0] // 16
        if mbw_lr < 1 or mbh_lr < 1:
            return False
        if d - self._idr_disp < max(1, self.p.keyint_min):
            return False
        pc = lowres_search(lr, prev, mbw_lr, mbh_lr)
        p_cost = float(pc.to(torch.int64).sum())
        i_cost = float(intra_cost_estimate(lr, mbw_lr, mbh_lr).sum())
        bias = self.p.scenecut_threshold / 100.0
        return p_cost >= (1.0 - bias) * i_cost

    _la = None

    def _lookahead(self) -> Lookahead:
        if self._la is None:
            self._la = Lookahead(self.p, self.device)
        return self._la

    def _drain_gop_q(self) -> bytes:
        out = b""
        for kind, job in (self._gop_q or []):
            out += (self._finalize_device(job) if kind == "a"
                    else self._finalize_b(job))
        self._gop_q = []
        return out

    def _flush_bq(self, pend=None) -> bytes:
        """Submit a mini-GOP, ``pend`` or the whole queue (its last frame
        as the P anchor, the rest as B frames, a pair in one core), then
        finalize the previous mini-GOP."""
        if pend is None:
            pend, self._bq = self._bq, []
        if not pend:
            return b""
        anchor, ad = pend[-1]
        prev = self.dpb[0]
        if self._syn_path():
            # the anchor through the host writers, then each B frame on
            # its own core (never the pair core), finalized at once
            out = self._encode_anchor(anchor, ad, "P")
            if len(pend) > 1 and self.stats[-1].frame_type == "IDR":
                # the reference's post-encode scenecut promoted the anchor
                # of a mini-GOP whose B frames are queued: they would
                # predict from a picture the IDR drops, and its streams
                # stop decoding to its recon (ROADMAP C, fault 6)
                raise NotImplementedError(
                    "x264_tpu_torch does not run this: the host-syntax "
                    "path's scenecut promoted a mini-GOP's anchor to an "
                    "IDR after its B frames were queued (fault 6)")
            if self.p.b_adapt:
                self._lookahead().push_anchor(self._pad(anchor)[0])
            nxt = self.dpb[0]
            jobs = [self._submit_b(bf, bd, prev, nxt)
                    for (bf, bd) in pend[:-1]]
            for j in jobs:
                out += self._finalize_b(j)
            return out
        if self.rc.vbv_on:
            # a VBV re-encode may rewrite a finalized anchor's recon in
            # place, so nothing is submitted against an anchor before it
            # clears its VBV check: drain the queue, finalize the new
            # anchor (retry included) before the B frames capture it, and
            # code each B frame eagerly, one core each
            out = self._drain_gop_q()
            prev = self.dpb[0]
            ajob = self._submit_anchor(anchor, ad, "P")
            if self.p.b_adapt:
                self._lookahead().push_anchor(self._pad(anchor)[0])
            out += self._finalize_device(ajob)
            nxt = self.dpb[0]
            for (bf, bd) in pend[:-1]:
                out += self._finalize_b(self._submit_b(bf, bd, prev, nxt))
            return out
        ajob = self._submit_anchor(anchor, ad, "P")
        if self.p.b_adapt:
            self._lookahead().push_anchor(self._pad(anchor)[0])
        nxt = self.dpb[0]
        bs = pend[:-1]
        if len(bs) == 2:
            jobs = self._submit_b_pair(bs[0], bs[1], prev, nxt)
        else:
            jobs = [self._submit_b(bf, bd, prev, nxt) for (bf, bd) in bs]
        out = self._drain_gop_q()
        self._gop_q = [("a", ajob)] + [("b", j) for j in jobs]
        return out

    def _encode_anchor(self, fr: Frame420, disp: int, ftype: str) -> bytes:
        if self._syn_path():
            # the host-syntax path: the QP of rate control alone (no
            # zones, no forced QP, no MB-tree offsets), as the reference
            y, u, v = self._pad(fr)
            if ftype == "IDR":
                self.frame_num = 0
            qp = self._qp_for_frame(ftype)
            out_bytes = b""
            if ftype == "IDR" and self.p.repeat_headers:
                out_bytes += self.headers()
            out_bytes += self._hrd_sei(ftype == "IDR",
                                       self._poc_lsb(disp))
            out_bytes += self._encode_frame_syn(
                y, u, v, ftype, qp, poc_lsb=self._poc_lsb(disp))
            rec = self.dpb[0]
            rec.poc = self._poc_lsb(disp)
            self._note_recon(disp, rec)
            # the colocated field from the FrameSyntax: the 16x16 mvs and
            # refs over the quadrants, intra where the MB is I16
            syn = self._last_syn
            n = syn.mv.shape[0]
            rec.col_mv = torch.as_tensor(
                syn.mv.astype(np.int32), device=self.device)[:, None] \
                .expand(n, 4, 2)
            rec.col_intra = torch.as_tensor(syn.mb_class == 0,
                                            device=self.device)
            rec.col_ref = (None if syn.ref is None else torch.as_tensor(
                syn.ref.astype(np.int32), device=self.device)[:, None]
                .expand(n, 4))
            self._note_au(len(out_bytes), ftype, self._poc_lsb(disp))
            return out_bytes
        return self._finalize_device(self._submit_anchor(fr, disp, ftype))

    def _frame_qp_at(self, disp: int, ftype: str) -> int:
        """The QP of the frame at ``disp``: rate control, zones, then a
        forced QP."""
        qp = self._zone_qp(disp, self._qp_for_frame(ftype))
        f_qp = self._forced_for(disp)[1]
        if f_qp is not None:
            qp = int(np.clip(f_qp, self.p.qp_min, self.p.qp_max))
        return qp

    def _submit_anchor(self, fr: Frame420, disp: int, ftype: str) -> dict:
        """Enqueue an anchor's device work and advance the DPB, with the
        colocated motion field temporal direct reads."""
        y, u, v = self._pad(fr)
        if ftype == "IDR":
            self.frame_num = 0
        qp = self._frame_qp_at(disp, ftype)
        self._mbt_off = (self._mbt_off_by_disp or {}).pop(disp, None)
        try:
            job = self._submit_device(y, u, v, ftype, qp)
        finally:
            self._mbt_off = None
        job["poc_lsb"] = self._poc_lsb(disp)
        out = job["out"]
        rec = self.dpb[0]
        self._note_recon(disp, rec)
        rec.poc = job["poc_lsb"]
        self._set_colocated(rec, out, job["mbw"] * job["mbh"])
        return job

    def _set_colocated(self, rec: ReconFrame, out: dict, n: int) -> None:
        """An anchor's colocated motion field, which temporal direct
        reads: quadrant mvs and refs, and the intra MBs."""
        if "mv8" in out:
            # quadrant motion (partitions): direct derives per quadrant
            rec.col_mv, rec.col_ref = out["mv8"], out["ref8"]
            rec.col_intra = out["mb_class"] == 0
        elif "mv" in out:
            rec.col_mv = out["mv"][:, None].expand(n, 4, 2)
            rec.col_ref = out["ref_mb"][:, None].expand(n, 4)
            rec.col_intra = out["mb_class"] == 0
        else:
            rec.col_mv = torch.zeros((n, 4, 2), dtype=torch.int32,
                                     device=self.device)
            rec.col_intra = torch.ones(n, dtype=torch.bool,
                                       device=self.device)
            rec.col_ref = None

    def _upload(self, planes):
        return [torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                for p in planes]

    def _col_ref(self, nxt: ReconFrame):
        """The future anchor's quadrant refs, which bar direct where one
        is above 0: only with several references (with one, every
        colocated ref is 0 and the reference passes None)."""
        return nxt.col_ref if self.p.ref_frames > 1 else None

    def _b_core(self, y, u, v, prev: ReconFrame, nxt: ReconFrame, dsf: int,
                qp: int, n_words: int) -> dict:
        """One B frame through ``b_frame_core`` at its own lambda."""
        return b_frame_core(
            y, u, v, prev.y, prev.u, prev.v, nxt.y, nxt.u, nxt.v,
            nxt.col_mv, nxt.col_intra, dsf, qp, sad_lambda(qp),
            mbw=y.shape[1] // 16, mbh=y.shape[0] // 16,
            me_range=self.p.me_range, cqp_off=self.p.chroma_qp_offset,
            subpel=self.p.subpel, decimate=self.p.dct_decimate,
            t8_mode=self.p.transform_8x8,
            trellis_tbl=self._trellis_tbl(qp, "B"),
            col_ref=self._col_ref(nxt), **self._entropy_kw(n_words))

    def _b_job(self, out: dict, disp: int, qp: int, poc_cur: int, ladder,
               n_words: int, args: tuple) -> dict:
        h, w = args[0].shape
        self._host_copies(out, n_words)
        return dict(out=out, blob=out["host_blob"], mbw=w // 16,
                    mbh=h // 16, qp=qp, ladder=ladder, n_words=n_words,
                    poc_cur=poc_cur, disp=disp, frame_num=self.frame_num,
                    args=args)

    def _submit_b(self, fr: Frame420, disp: int, prev: ReconFrame,
                  nxt: ReconFrame) -> dict:
        qp = self._frame_qp_at(disp, "B")
        # MB-tree offsets apply to anchors only: drop a B frame's
        self._drop_mbt_off(disp)
        ladder = self._ladder(qp)
        poc_cur, dsf = self._dist_scale(disp, prev, nxt)
        y, u, v = self._upload(self._pad(fr))
        out = self._b_core(y, u, v, prev, nxt, dsf, qp, ladder[0])
        return self._b_job(out, disp, qp, poc_cur, ladder, ladder[0],
                           (y, u, v, prev, nxt, dsf))

    def _submit_b_pair(self, b1, b2, prev: ReconFrame,
                       nxt: ReconFrame) -> list:
        """Both B frames of a mini-GOP through ``b_pair_core``: the first
        frame's QP sets the lambda and the entropy ladder of both."""
        qps, dsfs, pocs = [], [], []
        for (_, d) in (b1, b2):
            qps.append(self._frame_qp_at(d, "B"))
            self._drop_mbt_off(d)
            poc_cur, dsf = self._dist_scale(d, prev, nxt)
            pocs.append(poc_cur)
            dsfs.append(dsf)
        ladder = self._ladder(qps[0])
        n_words = ladder[0]
        planes = [self._upload(self._pad(f)) for (f, _) in (b1, b2)]
        y1 = planes[0][0]
        outs = b_pair_core(
            *zip(*planes), prev.y, prev.u, prev.v, nxt.y, nxt.u, nxt.v,
            nxt.col_mv, nxt.col_intra, dsfs, qps, sad_lambda(qps[0]),
            mbw=y1.shape[1] // 16, mbh=y1.shape[0] // 16,
            me_range=self.p.me_range, cqp_off=self.p.chroma_qp_offset,
            subpel=self.p.subpel, decimate=self.p.dct_decimate,
            t8_mode=self.p.transform_8x8,
            trellis_tbl=self._trellis_tbl(qps[0], "B"),
            col_ref=self._col_ref(nxt), **self._entropy_kw(n_words))
        return [self._b_job(outs[i], d, qps[i], pocs[i], ladder, n_words,
                            (*planes[i], prev, nxt, dsfs[i]))
                for i, (_, d) in enumerate((b1, b2))]

    def _finalize_b(self, job: dict) -> bytes:
        """A B frame's bytes: the overflow ladder re-runs ``b_frame_core``
        at the frame's own lambda; then the non-reference slice (the
        current frame_num, not advanced) through the CABAC coder or the
        CAVLC payload, the deblocked recon when ``full_recon`` is
        on, and the stats."""
        out = job["out"]
        mbw, mbh, qp = job["mbw"], job["mbh"], job["qp"]
        n = mbw * mbh
        n_words = job["n_words"]
        blob = job["blob"].numpy()
        cab = self.p.cabac

        def used(blob, n_words):
            """The blob's entropy size in its ladder's unit: levels per
            MB (CABAC, the frame's total) or words of the largest MB."""
            if cab:
                rows = self._cab_rows(blob, n, is_b=True)
                return -(-int(rows[:, 14 + 8].astype(np.int64).sum()) // n)
            return -(-int(blob[:, _NBITS].max(initial=0)) // 32)

        if used(blob, n_words) > n_words:
            y, u, v, prev, nxt, dsf = job["args"]
            for n_words in job["ladder"][1:]:
                out = self._host_copies(
                    self._b_core(y, u, v, prev, nxt, dsf, qp, n_words),
                    n_words)
                blob = out["host_blob"].numpy()
                if used(blob, n_words) <= n_words:
                    break
        self._note_budget(cab, used(blob, n_words))

        hrd = self._hrd_sei(False, job["poc_cur"])
        bs = BitWriter()
        write_slice_header(bs, self.p, self.sps, init_qp=self._init_qp,
                           slice_type=SLICE_B, idr=False,
                           frame_num=job["frame_num"], qp=qp, num_ref=1,
                           num_ref_l1=1, poc_lsb=job["poc_cur"],
                           is_ref=False)
        if cab:
            rows = self._cab_rows(blob, n, is_b=True)
            mb_class = rows[:, 14]
            cost_total = int(rows[:, 14 + 9].astype(np.int64).sum())
            pad = (-bs.bit_length) % 8
            if pad:
                bs.put(pad, (1 << pad) - 1)    # cabac_alignment_one_bit
            payload = write_slice_cabac(blob, mbw, mbh, 2, qp, n_words,
                                        t8_mode=self.p.transform_8x8)
            data = hrd + wrap_slice_nal(bs.to_bytes_aligned() + payload,
                                        False, is_ref=False)
        else:
            mb_class = blob[:, _CLASS]
            cost_total = int(blob[:, _COST].astype(np.int64).sum())
            _append_mbs(bs, blob, out["host_payload"],
                        skip_class=MB_PSKIP)
            data = hrd + wrap_slice_nal(bs.to_rbsp(), False, is_ref=False)

        # the deblocked recon for output (a B frame is no reference; the
        # b_full_recon analog skips it when full_recon is off)
        ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
        if self.p.deblock and self.p.full_recon:
            ry, ru, rv = deblock_frame_b(
                ry, ru, rv, out["nnz_deblock"], out["mv0"], out["mv1"],
                out["any0"], out["any1"], qp, self.p.deblock_alpha * 2,
                self.p.deblock_beta * 2, mbw=mbw, mbh=mbh,
                cqp_off=self.p.chroma_qp_offset,
                intra=out["mb_class"] == 0,
                t8=out["t8"] if self.p.transform_8x8 else None)
        self.last_recon = ReconFrame(ry, ru, rv)
        self._note_recon(job["disp"], self.last_recon)
        self.stats.append(FrameStats("B", len(data) * 8, qp))
        self.rc.update("B", len(data) * 8, cost_total)
        self._record_stats("B", qp, len(data) * 8, cost_total,
                           np.where(mb_class == 3, 3,
                                    np.where(mb_class == 0, 0, 2)))
        self._note_au(len(data), "B", job["poc_cur"])
        return data

    def encode_pipelined(self, fr: Frame420) -> bytes:
        """Submit this frame, return the previous frame's bytes (b"" for
        the first call): the device work of frame t+1 is enqueued before
        the host codes frame t.  Call ``flush()`` for the last frame.
        Frame types and QPs come from rate control alone (no forced
        types, zones or MB-tree), and B frames are not used."""
        out = b""
        if self.rc.vbv_on and self._pending is not None:
            # a VBV re-encode rewrites the pending frame's DPB recon in
            # place: finalize it (retry included) before this frame's
            # submit captures its reference planes
            out += self._finalize_device(self._pending)
            self._pending = None
        y, u, v = self._pad(fr)
        ftype = self._decide_type()
        if ftype == "IDR":
            self.frame_num = 0
        job = self._submit_device(y, u, v, ftype, self._qp_for_frame(ftype))
        prev = self._pending
        self._pending = job
        if prev is not None:
            out += self._finalize_device(prev)
        return out

    def flush(self) -> bytes:
        """The bytes still held back: the MB-tree lookahead queue, then
        the open mini-GOP, the finalize queue and the pipelined frame."""
        out = b""
        while self._mbt_q:
            out += self._pop_mbtree()
        return out + self._flush_rest()

    def _flush_rest(self) -> bytes:
        out = b""
        if self._bq:
            out += self._flush_bq()
        out += self._drain_gop_q()
        if self._pending is not None:
            job = self._pending
            self._pending = None
            out += self._finalize_device(job)
        return out

    _pending = None             # encode_pipelined's frame, not finalized

    def _pad(self, fr: Frame420):
        y = pad_to_mb(fr.y, 16)
        u = pad_to_mb(fr.u, 8)
        v = pad_to_mb(fr.v, 8)
        return y, u, v

    _enc_idx = 0       # encode-order frame counter

    def _qp_for_frame(self, ftype: str) -> int:
        """One call per encoded frame, in encode order — the pass-2 plan
        is indexed per encoded frame, matching the stats file."""
        i = self._enc_idx
        self._enc_idx += 1
        if self._pass2_qps is not None:
            return self._pass2_qps[min(i, len(self._pass2_qps) - 1)]
        if ftype == "B":
            return self.rc.b_qp()
        return self.rc.frame_qp(ftype)

    # per-type aggregates for the close() summary
    # (x264 encoder_close stat block, encoder/encoder.c:4196)
    _agg = None

    def _record_stats(self, ftype, qp, bits, cost, mb_class):
        from x264_tpu_torch.rc.twopass import FrameStat
        imb = int(np.isin(mb_class, (MB_I16, MB_I4)).sum())
        smb = int((mb_class == MB_PSKIP).sum())
        pmb = len(mb_class) - imb - smb
        if self._agg is None:
            self._agg = {}
        t = "I" if ftype == "IDR" else ftype
        a = self._agg.setdefault(
            t, dict(n=0, bits=0, qp=0.0, imb=0, pmb=0, smb=0))
        a["n"] += 1
        a["bits"] += bits
        a["qp"] += qp
        a["imb"] += imb
        a["pmb"] += pmb
        a["smb"] += smb
        if self.p.stats_write:
            self._twopass_stats.append(FrameStat(
                idx=len(self._twopass_stats),
                ftype="I" if ftype == "IDR" else ftype,
                qp=qp, bits=bits, cost=cost,
                imb=imb, pmb=pmb, smb=smb))

    # scenecut may not promote within keyint_min of the last keyframe
    # (x264's min-keyint rule, slicetype.c:1438)
    _last_idr_idx = 0

    def _decide_type(self) -> str:
        if self.p.intra_refresh:
            # PIR: one IDR at stream start, then refresh bars
            # (encoder.c:3626; keyint boundaries restart the sweep)
            if self.frame_idx == 0:
                self._last_idr_idx = 0
                return "IDR"
            return "P"
        if self.frame_idx == 0 or (self.p.keyint_max > 0
                                   and self.frame_idx % self.p.keyint_max == 0):
            self._last_idr_idx = self.frame_idx
            return "IDR"
        return "P"

    # per-frame overrides (x264_picture_t.i_type / i_qplus1 analog):
    # display idx -> (forced ftype or None, forced qp or None)
    _force: dict = None
    _in_disp = 0

    def _forced_for(self, d: int):
        if not self._force:
            return (None, None)
        return self._force.pop(d, (None, None))

    def encode(self, fr: Frame420, frame_type: int = 0,
               qp: int | None = None) -> bytes:
        """frame_type: TYPE_AUTO/IDR/I/P (params enums) to force this
        frame's type; qp: force this frame's QP — the --qpfile hooks
        (reference x264.c:1801 parse_qpfile -> pic.i_type/i_qpplus1)."""
        if frame_type or qp is not None:
            from x264_tpu_torch.params import (TYPE_B, TYPE_BREF, TYPE_I,
                                               TYPE_IDR, TYPE_P)
            tmap = {TYPE_IDR: "IDR", TYPE_I: "IDR", TYPE_P: "P",
                    TYPE_B: "B", TYPE_BREF: "B"}
            if self._force is None:
                self._force = {}
            self._force[self._in_disp] = (tmap.get(frame_type), qp)
        self._in_disp += 1
        if self._mbtree_on():
            return self._encode_mbtree(fr)
        if self.p.bframes > 0:
            return self._encode_bgop(fr)
        return self._encode_now(fr, disp=self._in_disp - 1)

    def _qp_map(self, qp: int, y, u, v, mbw: int, mbh: int):
        """(qp_arr, slice QP) of an I or P frame: the frame QP, or with
        AQ its per-MB map and the first MB's QP."""
        if not self.p.aq_mode:
            return qp, qp
        qp_arr = self._aq_qp(qp, y, u, v, mbw, mbh)
        return qp_arr, int(qp_arr[0])

    def _aq_qp(self, base: int, y, u, v, mbw: int, mbh: int):
        off = aq_offsets(y, u, v, mbw, mbh, self.p.aq_strength,
                         mode=self.p.aq_mode)
        qp_mb = np.clip(base + np.round(off).astype(np.int64),
                        self.p.qp_min, self.p.qp_max).astype(np.int32)
        return qp_mb

    # ---- MB-tree lookahead window (bframes >= 0) ----
    _mbt_q = None
    _mbt_off_by_disp = None
    _mbt_off = None             # the offsets of the frame being submitted

    def _mbtree_on(self) -> bool:
        """MB-tree runs under CRF and ABR with one slice on the device;
        under CQP, with slices or on the NumPy tier it is off."""
        return (self.p.mbtree and self.p.rc_method != RC_CQP
                and self.p.slices <= 1 and self._use_device())

    def _drop_mbt_off(self, disp: int) -> None:
        if self._mbt_off_by_disp:
            self._mbt_off_by_disp.pop(disp, None)

    def _encode_mbtree(self, fr: Frame420) -> bytes:
        """Queue rc_lookahead frames with their lowres statistics at 8x8
        lowres grain (one cell per source MB; host copies started
        without blocking), and pop the head once the window is full."""
        if self._mbt_q is None:
            self._mbt_q = []
        y, _, _ = self._pad(fr)
        lr = lowres_plane(self._upload((y,))[0])
        mbw_lr, mbh_lr = lr.shape[1] // 16, lr.shape[0] // 16
        prev = self._mbt_q[-1]["lr"] if self._mbt_q else None
        stats = lowres_stats8(lr, prev, mbw_lr, mbh_lr)
        ic, pc, mv = (None if t is None else _HostCopy(t) for t in stats)
        self._mbt_q.append(dict(fr=fr, lr=lr, ic=ic, pc=pc, mv=mv,
                                disp=self._in_disp - 1))
        if len(self._mbt_q) <= max(1, self.p.rc_lookahead):
            return b""
        return self._pop_mbtree()

    def _pop_mbtree(self) -> bytes:
        """Propagate over the remaining window (the display-order chain,
        models/mbtree.py), keep the head's offsets by display index for
        its submit, post the window's costs to rate control and encode
        the head."""
        q = self._mbt_q
        head = q.pop(0)
        nbw, nbh = 2 * (head["lr"].shape[1] // 16), \
            2 * (head["lr"].shape[0] // 16)
        ics = [e["ic"].numpy() for e in [head] + q]
        pcs = [None if e["pc"] is None else e["pc"].numpy()
               for e in [head] + q]
        if q:
            # propagate never reads the head's inter cost or mv
            mvs = [None] + [e["mv"].numpy() for e in q]
            prop = MT.propagate(ics, pcs, mvs, nbw, nbh, bs=8)
            off = MT.finish(ics[0], prop)
            if self._mbt_off_by_disp is None:
                self._mbt_off_by_disp = {}
            self._mbt_off_by_disp[head["disp"]] = MT.expand_offsets8(
                off, nbw, nbh, self.p.mb_width, self.p.mb_height)
        # the window's per-frame lowres costs (min(inter, intra), head
        # first) for the rate controller
        self.rc.lookahead_costs = [
            float((ic.astype(np.float64) if pc is None else np.minimum(
                pc.astype(np.float64), ic)).sum())
            for ic, pc in zip(ics, pcs)]
        if self.p.bframes > 0:
            return self._encode_bgop(head["fr"])
        self._mbt_off = (self._mbt_off_by_disp or {}).pop(head["disp"],
                                                           None)
        try:
            return self._encode_now(head["fr"], disp=head["disp"])
        finally:
            self._mbt_off = None

    def _encode_now(self, fr: Frame420, disp: int | None = None) -> bytes:
        y, u, v = self._pad(fr)
        f_type = (self._force.get(disp, (None, None))[0]
                  if self._force and disp is not None else None)
        if f_type in ("IDR", "P"):
            ftype = f_type
            if f_type == "IDR":
                self._last_idr_idx = self.frame_idx
        else:
            ftype = self._decide_type()
        qp = self._frame_qp_at(disp, ftype)
        if ftype == "IDR":
            self.frame_num = 0
        if not self._syn_path():
            if self._pending is not None:
                raise RuntimeError("encode() after encode_pipelined(): "
                                   "call flush() first")
            job = self._submit_device(y, u, v, ftype, qp)
            self._note_recon(disp, self.dpb[0])
            return self._finalize_device(job)
        data = (self.headers() if ftype == "IDR" and self.p.repeat_headers
                else b"") + self._encode_frame_syn(y, u, v, ftype, qp)
        self._note_recon(disp, self.dpb[0])
        self._note_au(len(data), ftype, 0)
        return data

    _last_syn = None            # the last syntax-path frame's FrameSyntax

    def _encode_frame_syn(self, y, u, v, ftype, qp, poc_lsb=0):
        """The host-syntax path (the reference backend, the host-entropy
        backend, I4x4 with CAVLC): the frame's FrameSyntax on the host
        from the device cores' syntax entries (or the NumPy tier's), the
        slice through the host writers, the deblock from the host arrays,
        and the one-entry DPB.  A P frame whose inter cost reaches (1 -
        bias) of its intra estimate past keyint_min is promoted to an IDR
        after its encode.  Returns the frame's slice bytes (no SPS/PPS
        but a promoted IDR's repeated headers)."""
        out = b""
        use_device = self._use_device()
        mbw, mbh = (y.shape[1] // 16, y.shape[0] // 16)
        qp_arr, slice_qp = self._qp_map(qp, y, u, v, mbw, mbh)
        cavlc = not self.p.cabac
        planes = self._upload((y, u, v)) if use_device else None
        syn = None
        if not (ftype == "IDR" or not self.dpb):
            # encode as P, then possibly promote to IDR on scenecut
            # (one reference on this path)
            ref = self.dpb[0]
            if use_device:
                ry, ru, rv, syn = encode_pframe_device(
                    *planes, ref, qp_arr, self.p, lam=sad_lambda(qp),
                    cavlc=cavlc)
            else:
                ry, ru, rv, syn = inter_frame.encode_pframe(
                    y, u, v, ReconFrame(*(t.cpu().numpy() for t in (
                        ref.y, ref.u, ref.v))), qp_arr, self.p,
                    lam=sad_lambda(qp))
            if (self.p.scenecut_threshold > 0 and syn.icost is not None
                    and self.frame_idx - self._last_idr_idx
                    >= self.p.keyint_min):
                bias = self.p.scenecut_threshold / 100.0
                if float(syn.mb_cost.sum()) >= (1.0 - bias) * float(
                        syn.icost.sum()):
                    ftype = "IDR"
                    self.frame_num = 0
                    self._last_idr_idx = self.frame_idx
                    if self.p.repeat_headers:
                        out += self.headers()
                    qp = self._requantize_idr(qp)
                    qp_arr, slice_qp = self._qp_map(qp, y, u, v, mbw, mbh)
                    syn = None
        if syn is not None:
            slice_type = SLICE_P
            idr = False
        else:
            if use_device:
                ry, ru, rv, syn = encode_iframe_device(
                    *planes, qp_arr, self.p.chroma_qp_offset,
                    i4x4=self.p.i4x4, lam=sad_lambda(qp), cavlc=cavlc)
            else:
                ry, ru, rv, syn = intra_frame.encode_iframe(
                    y, u, v, qp_arr, self.p.chroma_qp_offset,
                    i4x4=self.p.i4x4, lam=sad_lambda(qp))
            slice_type = SLICE_I
            idr = True
        out += self._syn_slice(syn, slice_type, idr, slice_qp, poc_lsb)

        if self.p.deblock:
            eff_qp = effective_qp(syn.qp.astype(np.int32), syn.mb_class,
                                  syn.cbp_luma, syn.cbp_chroma, slice_qp)
            if use_device:
                intra_mb = np.isin(syn.mb_class, (MB_I16, MB_I4))
                qpc = CHROMA_QP_TABLE[np.clip(
                    eff_qp + self.p.chroma_qp_offset, 0, 51)] \
                    .astype(np.int32)
                ry, ru, rv = deblock_core(
                    ry, ru, rv, *self._upload((
                        intra_mb, syn.luma_nnz.astype(np.int32),
                        syn.mv.astype(np.int32), syn.ref.astype(np.int32),
                        eff_qp, qpc)),
                    self.p.deblock_alpha * 2, self.p.deblock_beta * 2,
                    mbw=syn.mb_width, mbh=syn.mb_height)
            else:
                ry, ru, rv = ref_deblock.deblock_frame(
                    ry, ru, rv,
                    dataclasses.replace(syn, qp=eff_qp.astype(np.int64)),
                    self.p.deblock_alpha,
                    self.p.deblock_beta, self.p.chroma_qp_offset)
        if not use_device:
            # the DPB holds the planes on the device, as elsewhere
            ry, ru, rv = self._upload((ry, ru, rv))

        recon = ReconFrame(ry, ru, rv, frame_num=self.frame_num)
        self.last_recon = recon
        self.dpb = ([recon] + ([] if idr else self.dpb))[:1]
        if idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536
        self.frame_num = (self.frame_num + 1) % (
            1 << self.sps.log2_max_frame_num)
        self.frame_idx += 1
        self.stats.append(FrameStats(ftype, len(out) * 8, qp))
        cost = int(syn.mb_cost.sum()) if syn.mb_cost is not None else 0
        self.rc.update(ftype, len(out) * 8, cost)
        self._record_stats(ftype, qp, len(out) * 8, cost, syn.mb_class)
        self._last_syn = syn
        return out

    def _syn_slice(self, syn, slice_type: int, idr: bool, slice_qp: int,
                   poc_lsb: int) -> bytes:
        """One slice NAL from a FrameSyntax: the header, then the C CABAC
        coder's FrameSyntax entry or the CAVLC writers
        (``slice_writer_vec``, which hands a frame with I4x4 MBs to the
        scalar writer)."""
        bs = BitWriter()
        write_slice_header(bs, self.p, self.sps,
                           init_qp=self._init_qp, slice_type=slice_type,
                           idr=idr, frame_num=self.frame_num,
                           idr_pic_id=self.idr_pic_id, qp=slice_qp,
                           num_ref=1, poc_lsb=poc_lsb)
        if self.p.cabac:
            pad = (-bs.bit_length) % 8
            if pad:
                bs.put(pad, (1 << pad) - 1)    # cabac_alignment_one_bit
            payload = write_slice_cabac_syn(syn, slice_type, slice_qp)
            return wrap_slice_nal(bs.to_bytes_aligned() + payload, idr)
        write_slice_data(bs, syn, slice_type)
        return wrap_slice_nal(bs.to_rbsp(), idr)

    def close(self) -> dict:
        """Summary stats (analog of encoder_close's log summary); writes
        the 2-pass stats file if requested."""
        if self.p.stats_write and self._twopass_stats:
            from x264_tpu_torch.rc.twopass import write_stats
            write_stats(self.p.stats_write, self._twopass_stats,
                        f"qp={self.p.qp} rc={self.p.rc_method}")
        if not self.stats:
            return {}
        bits = sum(s.bits for s in self.stats)
        fps = self.p.fps_num / max(1, self.p.fps_den)
        out = {
            "frames": len(self.stats),
            "kbps": bits * fps / max(1, len(self.stats)) / 1000.0,
            "avg_qp": float(np.mean([s.qp for s in self.stats])),
            "frame_types": {},
            "mb_mix": {},
        }
        for t, a in (self._agg or {}).items():
            out["frame_types"][t] = dict(
                count=a["n"], avg_qp=a["qp"] / a["n"],
                avg_bytes=a["bits"] / 8.0 / a["n"])
            nmb = a["imb"] + a["pmb"] + a["smb"]
            out["mb_mix"][t] = dict(
                intra=a["imb"] / max(1, nmb), inter=a["pmb"] / max(1, nmb),
                skip=a["smb"] / max(1, nmb))
        return out

    def summary_lines(self) -> list:
        """x264 encoder_close-style log lines (frame type counts, avg QP,
        avg size, MB type mix) — the CLI prints these at log_level>=2."""
        out = []
        for t in ("I", "P", "B"):
            a = (self._agg or {}).get(t)
            if not a:
                continue
            nmb = max(1, a["imb"] + a["pmb"] + a["smb"])
            out.append(
                f"frame {t}:{a['n']:<5d} Avg QP:{a['qp'] / a['n']:6.2f}"
                f"  size:{a['bits'] / 8.0 / a['n']:9.1f}"
                f"  mb I:{100.0 * a['imb'] / nmb:5.1f}%"
                f" P:{100.0 * a['pmb'] / nmb:5.1f}%"
                f" skip:{100.0 * a['smb'] / nmb:5.1f}%")
        return out
