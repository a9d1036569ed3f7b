"""Encoder parameters — the analog of x264's `x264_param_t` (x264.h:310-620)
with the same 4-layer resolution order: defaults -> preset/tune -> user ->
profile (x264.h:680-691, common/base.c:344-886).

Round-1 scope implements the fields the current pipeline consumes; the full
~130-field surface is being filled in as capabilities land.  Every field name
mirrors the reference option it corresponds to.

Copied whole from x264_tpu/params.py; the port keeps its own copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

# -- enums (x264.h:190-280) ---------------------------------------------------
RC_CQP, RC_CRF, RC_ABR = 0, 1, 2
ME_DIA, ME_HEX, ME_UMH, ME_ESA, ME_TESA = 0, 1, 2, 3, 4
PROFILE_BASELINE, PROFILE_MAIN, PROFILE_HIGH = 66, 77, 100
TYPE_AUTO, TYPE_IDR, TYPE_I, TYPE_P, TYPE_BREF, TYPE_B = 0, 1, 2, 3, 4, 5
AQ_NONE, AQ_VARIANCE, AQ_AUTOVARIANCE, AQ_AUTOVARIANCE_BIASED = 0, 1, 2, 3
CSP_I420, CSP_I422, CSP_I444 = 1, 2, 3


@dataclass
class EncoderParams:
    # frame geometry
    width: int = 352
    height: int = 288
    csp: int = CSP_I420
    bit_depth: int = 8
    fps_num: int = 25
    fps_den: int = 1

    # GOP structure
    keyint_max: int = 250           # --keyint
    keyint_min: int = 25
    bframes: int = 0                # max consecutive B frames
    b_adapt: int = 0                # 0 fixed pattern, 1 lowres-cost adaptive
    mbtree: bool = False            # MB-tree QP propagation (CRF/ABR)
    rc_lookahead: int = 8           # lookahead depth for MB-tree
    scenecut_threshold: int = 40
    intra_refresh: bool = False

    # rate control
    rc_method: int = RC_CQP
    qp: int = 26                    # CQP
    crf: float = 23.0
    bitrate: int = 0                # kbit/s for ABR
    vbv_maxrate: int = 0            # kbit/s; 0 = VBV off
    vbv_bufsize: int = 0            # kbit; 0 = VBV off
    vbv_init: float = 0.9           # initial buffer fullness fraction
    qp_min: int = 10
    qp_max: int = 51
    chroma_qp_offset: int = 0
    aq_mode: int = AQ_NONE
    aq_strength: float = 1.0

    # analysis
    # me_method is accepted for x264 CLI compatibility but the TPU
    # pipeline ALWAYS runs the batched exhaustive search: DIA/HEX/UMH
    # exist to skip work on latency-bound CPUs; on TPU the dense SAD
    # field is the fast path, so every method resolves to >= the
    # requested quality (same rationale as x264's OpenCL lookahead).
    me_method: int = ME_ESA
    me_range: int = 16
    # --weightp: explicit P-slice weighted prediction (luma).  1/2 both
    # run the same explicit-weight analysis here (the reference's mode 2
    # adds duplicate-ref tricks that don't apply to the batched core).
    weightp: int = 0
    subpel: int = 2                 # 0=fpel, 1=hpel, 2=qpel (x264 subme analog)
    ref_frames: int = 1
    i4x4: bool = False              # enable intra 4x4 analysis
    i16x16: bool = True             # mandatory mode (validate rejects False)
    p16x16: bool = True             # mandatory mode (validate rejects False)
    # --partitions p8x8: inter partitions 16x8/8x16/8x8 (one shared ref
    # per MB; sub-8x8 splits pending like x264 presets <= slow)
    p8x8: bool = False
    transform_8x8: bool = False     # --8x8dct (High profile adaptive 8x8)
    # --trellis: RD-optimal quantization (ops/device/trellis.py, the
    # rdo.c quant_trellis_cabac analog).  1/2 both run the same batched
    # DP here (x264's 2 re-runs it inside RD mode decision, which has no
    # analog yet).  CABAC-cost model, so requires cabac=1 like x264.
    trellis: int = 0
    # JVT-B118 coefficient decimation of inter blocks (x264
    # --no-dct-decimate to disable; encoder/macroblock.c b_dct_decimate)
    dct_decimate: bool = True
    # JM/x264-default quant rounding (intra 1/3, inter 1/6) is what the
    # quant kernels implement; custom deadzones are rejected loudly at
    # validate() until they are plumbed through (x264 set.c:179).
    deadzone_intra: int = 11
    deadzone_inter: int = 21

    # entropy / syntax
    cabac: bool = False             # round-1: CAVLC
    deblock: bool = True
    deblock_alpha: int = 0
    deblock_beta: int = 0
    constrained_intra: bool = False

    # parallelism
    slices: int = 1
    threads: int = 1                # devices for the sliced band mesh
                                    # (--threads; parallel/sliced.py)

    # output
    repeat_headers: bool = True
    sei_version: bool = True    # x264_sei_version_write analog
    annexb: bool = True
    level_idc: int = 0              # 0 = auto

    # VUI (Annex E; x264 --sar/--range/--videoformat/--colorprim/
    # --transfer/--colormatrix/--chromaloc/--nal-hrd)
    sar_width: int = 0              # 0 = unspecified
    sar_height: int = 0
    fullrange: bool = False
    videoformat: int = 5            # 5 = unspecified (E-2)
    colorprim: int = 2              # 2 = unspecified
    transfer: int = 2
    colmatrix: int = 2
    chroma_loc: int = 0
    nal_hrd: bool = False           # HRD in VUI + buffering/timing SEI

    # misc x264-parity knobs
    # b_full_recon (x264.h:397): deblock non-reference (B) recon too so
    # last_recon matches the decoder; off = encode-speed mode
    full_recon: bool = True
    log_level: int = 2              # 0 quiet .. 3 debug (cli verbosity)

    # zones: "start,end,q=QP/start,end,b=FACTOR" per-range RC override
    # (x264 --zones; encoder/ratecontrol.c:1219 parse_zone — the param-
    # override form is rejected at validate, like the q=/b= subset docs)
    zones: str = ""

    # 2-pass rate control (x264 --pass/--stats analog)
    stats_write: str = ""
    stats_read: str = ""

    # compute backend: "device" = JAX/XLA (TPU) pipeline, "reference" =
    # NumPy bit-exact tier (plays the role of x264's C kernels vs asm),
    # "auto" = device when JAX is importable.
    backend: str = "auto"

    def clone(self, **kw) -> "EncoderParams":
        return dataclasses.replace(self, **kw)

    # -- derived ------------------------------------------------------------
    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def profile_idc(self) -> int:
        if self.transform_8x8:
            return PROFILE_HIGH
        if self.cabac or self.bframes:
            return PROFILE_MAIN
        return PROFILE_BASELINE

    def validate(self) -> "EncoderParams":
        """Constraint propagation (analog of encoder.c validate_parameters)."""
        p = self
        assert p.bit_depth == 8, "10-bit: later round"
        assert p.csp == CSP_I420, "4:2:2/4:4:4: later round"
        assert p.width > 0 and p.height > 0
        assert p.width % 2 == 0 and p.height % 2 == 0
        # fail-loudly gates for accepted-but-unimplemented knobs (the
        # round-1 review flagged silently-dead fields; anything here is
        # either consumed somewhere or rejected — tests/test_params.py)
        if p.intra_refresh:
            # PIR: a moving forced-intra column replaces periodic IDRs
            # (reference encoder/encoder.c:3626 refresh bar).  Round-4
            # scope: single-slice P GOPs on the device backend.
            if p.bframes:
                raise NotImplementedError("--intra-refresh with bframes:"
                                          " pending (x264 also restricts"
                                          " PIR GOP shapes)")
            if p.slices > 1:
                raise NotImplementedError("--intra-refresh with slices:"
                                          " pending")
            if p.backend in ("reference", "device_host_entropy"):
                raise NotImplementedError(
                    "--intra-refresh: device pipeline only")
            if p.i4x4 and not p.cabac:
                raise NotImplementedError(
                    "--intra-refresh: i4x4+CAVLC host-syntax path"
                    " unsupported")
            if p.ref_frames > 1:
                # the PIR MV clamp bounds mvx against the CURRENT frame's
                # refresh bar; older refs have a smaller refreshed region,
                # so multi-ref would silently break the recovery guarantee.
                # The reference likewise forces ref=1/dpb=1 for PIR
                # (encoder.c:1092 validate_parameters).
                p = p.clone(ref_frames=1)
        if p.constrained_intra:
            raise NotImplementedError("--constrained-intra: pending")
        if p.p8x8:
            # fail-loudly gates for the partition path's pending combos
            if p.subpel < 1:
                p = p.clone(p8x8=False)   # like x264 ultrafast: no p8x8
            if p.backend in ("reference", "device_host_entropy"):
                raise NotImplementedError("p8x8: device pipeline only")
            if p.slices > 1 or p.threads > 1:
                raise NotImplementedError("p8x8 + slices/threads: pending")
            if p.i4x4 and not p.cabac:
                raise NotImplementedError(
                    "p8x8 + i4x4 + CAVLC: pending (CAVLC i4x4 rides the "
                    "host-entropy syntax path, which has no partition "
                    "writer; use --cabac)")
        if not (p.i16x16 and p.p16x16):
            raise NotImplementedError("i16x16/p16x16 cannot be disabled")
        if (p.deadzone_intra, p.deadzone_inter) != (11, 21):
            raise NotImplementedError(
                "custom quant deadzones: pending (kernels implement the "
                "x264/JM defaults)")
        if p.me_method not in (ME_DIA, ME_HEX, ME_UMH, ME_ESA, ME_TESA):
            raise ValueError(f"bad me_method {p.me_method}")
        if not p.annexb:
            raise NotImplementedError(
                "length-prefixed NAL output (mp4-style): pending muxers")
        if p.qp_min > p.qp:
            p = p.clone(qp_min=p.qp)
        if p.bframes:
            # multi-ref P with B frames (round 5): P slices search all
            # ref_frames anchors; B slices use one ref per list (past /
            # future anchor), which is a legal H.264 combination — the
            # decoder's default B lists order past refs by POC desc
            # (list0[0] = nearest past) and future by POC asc (list1[0]
            # = nearest future), matching the encoder's choice.
            assert p.slices == 1, "B+slices: round 2"
        if p.i4x4 and p.slices > 1:
            raise NotImplementedError("i4x4 + slices: pending")
        if p.i4x4 and p.transform_8x8 and not p.cabac:
            raise NotImplementedError(
                "i4x4 + 8x8dct + CAVLC: pending (the CAVLC i4x4 syntax "
                "path has no transform_size flag writer; use --cabac)")
        if p.transform_8x8:
            if p.backend == "reference":
                raise NotImplementedError(
                    "8x8 transform is device-pipeline only")
            if p.slices > 1:
                raise NotImplementedError("8x8dct + slices: pending")
        if p.nal_hrd and not (p.vbv_maxrate and p.vbv_bufsize):
            raise ValueError(
                "--nal-hrd requires VBV (vbv-maxrate + vbv-bufsize), "
                "like the reference (encoder.c validate_parameters)")
        if p.chroma_loc not in range(6):
            raise ValueError("chroma_loc must be 0..5 (E-2)")
        if p.zones:
            parse_zones(p.zones)      # raises on malformed input
        if p.trellis:
            if not p.cabac:
                raise NotImplementedError(
                    "trellis uses the CABAC cost model (x264 likewise "
                    "defaults trellis off for CAVLC)")
            if p.backend in ("reference",):
                raise NotImplementedError("trellis: device pipeline only")
            if p.slices > 1:
                raise NotImplementedError("trellis + slices: pending")
        if p.weightp:
            # weighted_pred_flag=1 requires a pred_weight_table in EVERY
            # P slice header, so every P path must support it; gate the
            # ones that don't yet (fail loudly, not silently-unweighted)
            if p.backend in ("reference", "device_host_entropy"):
                raise NotImplementedError("weightp: device pipeline only")
            if p.slices > 1:
                raise NotImplementedError("weightp + slices: pending")
            if p.i4x4 and not p.cabac:
                raise NotImplementedError(
                    "weightp + i4x4 + CAVLC: pending (CAVLC i4x4 rides "
                    "the host-entropy syntax path, which has no "
                    "pred_weight_table writer; use --cabac)")
        return p


# -- presets (common/base.c:489-609) -----------------------------------------
# Speed/quality ladder re-expressed for the TPU pipeline: the knobs that
# matter on TPU are batch-shape ones (search range, subpel taps, partitions),
# not the CPU ones (trellis threads etc.).
_PRESETS = {
    # Speed ladder re-expressed in the knobs that matter on TPU
    # (batch shapes: search range, subpel taps, partitions, transforms),
    # tracking the reference ladder's capability steps
    # (common/base.c:489-609)
    "ultrafast": dict(me_range=8, subpel=0, i4x4=False, deblock=False,
                      scenecut_threshold=0, ref_frames=1, cabac=False),
    "superfast": dict(me_range=8, subpel=1, i4x4=False, ref_frames=1,
                      cabac=True),
    "veryfast": dict(me_range=16, subpel=1, i4x4=False, ref_frames=1,
                     cabac=True, transform_8x8=True),
    "faster": dict(me_range=16, subpel=1, i4x4=True, ref_frames=1,
                   cabac=True, transform_8x8=True),
    "fast": dict(me_range=16, subpel=1, i4x4=True, ref_frames=1,
                 cabac=True, transform_8x8=True, weightp=1, trellis=1),
    "medium": dict(me_range=16, subpel=2, i4x4=True, ref_frames=1,
                   cabac=True, transform_8x8=True, weightp=1, trellis=1,
                   p8x8=True, bframes=2),
    "slow": dict(me_range=24, subpel=2, i4x4=True, ref_frames=2,
                 cabac=True, transform_8x8=True, weightp=1, trellis=1,
                 p8x8=True),
    "slower": dict(me_range=24, subpel=2, i4x4=True, ref_frames=3,
                   cabac=True, transform_8x8=True, weightp=1, trellis=1,
                   p8x8=True, aq_mode=1),
    "veryslow": dict(me_range=32, subpel=2, i4x4=True, ref_frames=4,
                     cabac=True, transform_8x8=True, weightp=1, trellis=1,
                     p8x8=True, aq_mode=1),
    "placebo": dict(me_range=32, subpel=2, i4x4=True, ref_frames=4,
                    cabac=True, transform_8x8=True, weightp=1, trellis=1,
                    p8x8=True, aq_mode=1, scenecut_threshold=40),
}

# tunes (common/base.c:611-704) restricted to the supported knobs;
# tunes needing custom deadzones (grain) or psy-RD stay rejected
_TUNES = {
    "psnr": dict(aq_mode=AQ_NONE),
    "ssim": dict(aq_mode=AQ_VARIANCE),
    "zerolatency": dict(bframes=0, rc_lookahead=0, mbtree=False),
    "fastdecode": dict(cabac=False, deblock=False, weightp=0,
                   # CAVLC path: no partitions / 8x8dct-with-i4 yet
                   p8x8=False, transform_8x8=False, trellis=0),
    "stillimage": dict(scenecut_threshold=0, bframes=0),
    "animation": dict(deblock_alpha=1, deblock_beta=1, aq_strength=0.6),
    "film": dict(deblock_alpha=-1, deblock_beta=-1),
}


def param_default_preset(preset: str = "medium", tune: str | None = None) -> EncoderParams:
    p = EncoderParams()
    if preset not in _PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    p = p.clone(**_PRESETS[preset])
    if tune is not None:
        if tune not in _TUNES:
            raise ValueError(f"unknown tune {tune!r} (grain/psy tunes "
                             "need custom deadzones: pending)")
        p = p.clone(**_TUNES[tune])
    return p


def parse_zones(spec: str) -> list:
    """Parse --zones "start,end,q=QP/start,end,b=F" (x264
    encoder/ratecontrol.c:1219 parse_zone; the per-zone param-override
    form is not supported).  Returns [(start, end, ('q', qp) |
    ('b', factor))]."""
    out = []
    for z in spec.split("/"):
        parts = z.split(",")
        if len(parts) != 3:
            raise ValueError(f"invalid zone {z!r} (start,end,q=|b=)")
        start, end = int(parts[0]), int(parts[1])
        if start > end or start < 0:
            raise ValueError(f"invalid zone range {z!r}")
        k, _, v = parts[2].partition("=")
        if k == "q":
            out.append((start, end, ("q", int(v))))
        elif k == "b":
            f = float(v)
            if f <= 0:
                raise ValueError(f"zone bitrate factor must be > 0: {z!r}")
            out.append((start, end, ("b", f)))
        else:
            raise ValueError(f"unknown zone key {k!r} in {z!r}")
    return out


def param_parse(p: EncoderParams, name: str, value: str) -> EncoderParams:
    """String option front-end (analog of x264_param_parse, common/base.c:886)."""
    name = name.replace("-", "_")
    alias = {
        "keyint": "keyint_max", "min_keyint": "keyint_min",
        "qp_step": None, "merange": "me_range", "subme": "subpel",
        "ref": "ref_frames",
    }
    name = alias.get(name, name)
    if name is None:
        return p
    if not hasattr(p, name):
        raise ValueError(f"unknown option {name!r}")
    cur = getattr(p, name)
    if isinstance(cur, bool):
        v: object = value.lower() in ("1", "true", "yes", "on")
    elif isinstance(cur, int):
        v = int(value)
    elif isinstance(cur, float):
        v = float(value)
    else:
        v = value
    return p.clone(**{name: v})
