"""Rate control: CQP / CRF / ABR frame-QP decision + variance-based
adaptive quantization.

Parity anchors (reference encoder/ratecontrol.c):
- qp<->qscale mapping qp2qscale/qscale2qp (:96-104)
- qscale law  q = complexity^(1-qcomp) / rate_factor
  (get_qscale :2060, rate_estimate_qscale :2400); until the lookahead
  lands, per-frame complexity is the encoder's own prediction-cost EMA
  (one-frame lag) instead of the lookahead-blurred SATD
- ABR: bits predictor (bits ~ coeff * satd / qscale, predict_size :2109)
  sets the rate factor; shrinking-buffer overflow feedback (:2475-2495)
- AQ mode 1: per-MB energy -> qp offset (x264_adaptive_quant_frame :304):
  qp_adj = strength * 1.5 * (log2(max(energy,1)) - 14.427)

Copied whole from x264_tpu/rc/ratecontrol.py (``aq_offsets`` stays host
NumPy in float64, so its offsets round as the reference's do).
"""

from __future__ import annotations

import math

import numpy as np

from x264_tpu_torch.params import RC_ABR, RC_CQP, RC_CRF


def qp2qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale2qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


class RateControl:
    """Per-frame QP decision; update() feeds back actual bits and the
    frame's prediction cost (SATD sum) after each frame."""

    IP_OFFSET = 3      # I frames finer: round(6*log2(1.4)), the x264
                       # ip_factor=1.40 CQP mapping (ratecontrol.c:744
                       # qp_constant[SLICE_TYPE_I])
    PB_OFFSET = 2      # B frames coarser (x264 pb_factor analog)

    def __init__(self, params):
        self.p = params
        self.qcomp = 0.6
        self.fps = params.fps_num / max(1, params.fps_den)
        self.bitrate = params.bitrate * 1000.0
        # EMAs (0.9 decay): complexity, bits*qscale/cplx predictor,
        # cplx^qcomp for the ABR rate factor
        self.cplx = 0.0
        self.coeff = 0.0
        self.cq = 0.0
        self.w = 0.0
        self.wanted_bits = 0.0
        self.actual_bits = 0.0
        self.n_frames = 0
        self.rate_factor = None
        self.last_qscale = qp2qscale(params.qp or 26)
        # VBV (x264 clip_qscale / update_vbv analog, ratecontrol.c:1375,
        # :1977): decoder-buffer model — the frame's bits may not exceed
        # the current fill; fill drains by frame bits and refills at
        # vbv_maxrate.  Engaged for CRF/ABR when both knobs are set.
        self.vbv_max = params.vbv_maxrate * 1000.0
        self.vbv_size = params.vbv_bufsize * 1000.0
        self.vbv_on = (self.vbv_max > 0 and self.vbv_size > 0
                       and params.rc_method != RC_CQP)
        self.vbv_fill = self.vbv_size * params.vbv_init
        # vbv_lookahead (ratecontrol.c:1225 analog): the encoder's
        # lookahead window posts per-frame lowres costs here (head
        # first); the VBV clip then bounds the WHOLE window's predicted
        # bits by the cumulative refill, not just the head frame's.
        self.lookahead_costs = None

    def _predict_bits(self, qscale: float) -> float:
        """bits ~ coeff * cplx / qscale (predict_size analog)."""
        cplx = max(self.cplx / self.w, 1.0)
        return max(self.coeff / self.w, 1e-9) * cplx / max(qscale, 1e-9)

    def _clip_qscale_vbv(self, q: float, frame_type: str) -> float:
        if not self.vbv_on or self.w <= 0:
            return q
        bufrate = self.vbv_max / self.fps
        fill = min(self.vbv_fill + bufrate, self.vbv_size)
        # underflow guard: predicted frame must fit in a safety fraction
        # of the available fill (x264 uses fill - size*0.5 headroom for
        # non-P; a flat 0.8 of fill is our single-predictor analog)
        max_bits = 0.8 * fill
        pred = self._predict_bits(q)
        if pred > max_bits:
            q *= pred / max_bits
        # overflow guard: if even after refill the buffer would stay
        # nearly full, spend more bits (lower qscale) to avoid drift
        space = self.vbv_size - (fill - self._predict_bits(q))
        if space < 0.1 * self.vbv_size:
            q *= max(0.5, space / (0.1 * self.vbv_size) + 1e-9)
        # vbv_lookahead: scale future frames' bits off the head
        # prediction by their lowres-cost ratio and require the running
        # total to fit the cumulative refill at every window position
        if self.lookahead_costs:
            head = max(self.lookahead_costs[0], 1.0)
            pred0 = self._predict_bits(q)
            cum, factor = 0.0, 1.0
            for j, wc in enumerate(self.lookahead_costs):
                cum += pred0 * max(wc, 1.0) / head
                avail = fill + j * bufrate
                if avail > 0 and cum > avail:
                    factor = max(factor, cum / avail)
            q *= factor
        return q

    def _clip_qp(self, qp: float, frame_type: str) -> int:
        if frame_type in ("IDR", "I"):
            qp -= self.IP_OFFSET
        return int(np.clip(round(qp), self.p.qp_min, self.p.qp_max))

    def frame_qp(self, frame_type: str) -> int:
        p = self.p
        if p.rc_method == RC_CQP:
            qp = p.qp - (self.IP_OFFSET if frame_type in ("IDR", "I") else 0)
            return int(np.clip(qp, 0, 51))

        if self.w <= 0:
            q = qp2qscale(p.crf if p.rc_method == RC_CRF else (p.qp or 26))
            self.last_qscale = q
            return self._clip_qp(qscale2qp(q), frame_type)

        cplx = max(self.cplx / self.w, 1.0)
        if p.rc_method == RC_CRF:
            q = cplx ** (1.0 - self.qcomp) / self.rate_factor
        else:  # ABR
            target = self.bitrate / self.fps
            coeff = max(self.coeff / self.w, 1e-9)
            cqm = max(self.cq / self.w, 1e-9)
            rf = target / (coeff * cqm)
            q = cplx ** (1.0 - self.qcomp) / max(rf, 1e-9)
            abr_buffer = 2.0 * max(self.bitrate, 1.0)
            overflow = float(np.clip(
                1.0 + (self.actual_bits - self.wanted_bits) / abr_buffer,
                0.5, 2.0))
            q *= overflow
        # limit qscale swing between consecutive frames (x264 lstep)
        lstep = 2.0 ** (8.0 / 6.0)
        q = float(np.clip(q, self.last_qscale / lstep,
                          self.last_qscale * lstep))
        # VBV has priority over lstep smoothing (clip_qscale runs last)
        q = self._clip_qscale_vbv(q, frame_type)
        self.last_qscale = q
        return self._clip_qp(qscale2qp(max(q, 1e-9)), frame_type)

    def b_qp(self) -> int:
        """B-frame QP derived from the last anchor qscale (pb_factor
        analog, ratecontrol.c pb ratio).  Does NOT mutate RC state —
        B decisions must not drift the anchor lstep chain."""
        if self.p.rc_method == RC_CQP:
            return int(np.clip(self.p.qp + self.PB_OFFSET, 0, 51))
        qp = qscale2qp(max(self.last_qscale, 1e-9)) + self.PB_OFFSET
        return int(np.clip(round(qp), self.p.qp_min, self.p.qp_max))

    def update(self, frame_type: str, bits: int, cost: float) -> None:
        cost = max(float(cost), 1.0)
        decay = 0.9
        # B frames were coded at last_qscale * pb ratio; feed the coeff
        # predictor at the qscale actually used so ABR/CRF see B bits
        qscale = self.last_qscale
        if frame_type == "B":
            qscale *= 2.0 ** (self.PB_OFFSET / 6.0)
        self.cplx = self.cplx * decay + cost
        self.coeff = self.coeff * decay + bits * qscale / cost
        self.cq = self.cq * decay + cost ** self.qcomp
        self.w = self.w * decay + 1.0
        self.actual_bits += bits
        self.wanted_bits += self.bitrate / self.fps if self.bitrate else 0.0
        self.n_frames += 1
        if self.vbv_on:
            self.vbv_fill = min(self.vbv_fill + self.vbv_max / self.fps,
                                self.vbv_size) - bits
            self.vbv_fill = max(self.vbv_fill, 0.0)
        if self.p.rc_method == RC_CRF:
            cplx = max(self.cplx / self.w, 1.0)
            self.rate_factor = (cplx ** (1.0 - self.qcomp)
                                / qp2qscale(self.p.crf))


def aq_offsets(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               mbw: int, mbh: int, strength: float,
               mode: int = 1) -> np.ndarray:
    """AQ modes 1-3 (x264_adaptive_quant_frame, ratecontrol.c:304-415):
    per-MB energy = sum of the four 8x8 luma variances + the two chroma
    8x8 variances.
    mode 1 (variance):       qp_adj = s*1.5*(log2(max(E,1)) - 14.427)
    mode 2 (autovariance):   per-frame normalised — a = (E+1)^0.125,
        strength = s*avg(a), bias avg' = avg - 0.5*(avg(a^2)-14)/avg,
        qp_adj = strength*(a - avg')
    mode 3 (autovariance-biased): mode 2 + s*(1 - 14/a^2) dark-bias
    Returns float offsets (N,)."""
    def var_blocks(p, s):
        hh, ww = p.shape
        b = (p.astype(np.int64).reshape(hh // s, s, ww // s, s)
             .transpose(0, 2, 1, 3).reshape(-1, s * s))
        sm = b.sum(1)
        sq = (b * b).sum(1)
        return (sq - sm * sm // (s * s)).reshape(hh // s, ww // s)

    vy = var_blocks(y, 8)                       # (2*mbh, 2*mbw)
    e = vy.reshape(mbh, 2, mbw, 2).sum((1, 3))
    e = e + var_blocks(u, 8) + var_blocks(v, 8)
    e = e.reshape(-1).astype(np.float64)
    if mode >= 2:
        a = np.power(e + 1.0, 0.125)
        avg = float(a.mean())
        avg2 = float((a * a).mean())
        st = strength * avg
        avg_b = avg - 0.5 * (avg2 - 14.0) / max(avg, 1e-9)
        off = st * (a - avg_b)
        if mode >= 3:
            off = off + strength * (1.0 - 14.0 / np.maximum(a * a, 1e-9))
        return off
    return strength * 1.5 * (np.log2(np.maximum(e, 1.0)) - 14.427)
