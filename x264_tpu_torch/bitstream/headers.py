"""SPS/PPS/slice-header writers (spec 7.3.2; capability parity with
reference encoder/set.c x264_sps_write/x264_pps_write and
encoder/encoder.c slice_header_write).

Copied from x264_tpu/bitstream/headers.py; the port's imports and no
``auto_level``.
"""

from __future__ import annotations

from dataclasses import dataclass

from x264_tpu_torch.bitstream.bits import BitWriter
from x264_tpu_torch.bitstream.nal import (
    NAL_PPS,
    NAL_PRIORITY_HIGHEST,
    NAL_SLICE,
    NAL_SLICE_IDR,
    NAL_SPS,
    make_nal,
)
from x264_tpu_torch.params import RC_ABR as RC_ABR_
from x264_tpu_torch.params import EncoderParams

SLICE_P, SLICE_B, SLICE_I = 0, 1, 2


@dataclass
class SpsInfo:
    profile_idc: int
    level_idc: int
    log2_max_frame_num: int = 8
    poc_type: int = 2
    num_ref_frames: int = 1
    mb_width: int = 22
    mb_height: int = 18
    crop_right: int = 0   # pixels
    crop_bottom: int = 0


# spec Table A-1 (the x264_levels table, reference common/tables.c):
# level -> (MaxMBPS, MaxFS, MaxDpbMbs, MaxBR kbit, MaxCPB kbit, MaxVmvR)
LEVELS = [
    (10, 1485, 99, 396, 64, 175, 64),
    (11, 3000, 396, 900, 192, 500, 128),
    (12, 6000, 396, 2376, 384, 1000, 128),
    (13, 11880, 396, 2376, 768, 2000, 128),
    (20, 11880, 396, 2376, 2000, 2000, 128),
    (21, 19800, 792, 4752, 4000, 4000, 256),
    (22, 20250, 1620, 8100, 4000, 4000, 256),
    (30, 40500, 1620, 8100, 10000, 10000, 256),
    (31, 108000, 3600, 18000, 14000, 14000, 512),
    (32, 216000, 5120, 20480, 20000, 20000, 512),
    (40, 245760, 8192, 32768, 20000, 25000, 512),
    (41, 245760, 8192, 32768, 50000, 62500, 512),
    (42, 522240, 8704, 34816, 50000, 62500, 512),
    (50, 589824, 22080, 110400, 135000, 135000, 512),
    (51, 983040, 36864, 184320, 240000, 240000, 512),
    (52, 2073600, 36864, 184320, 240000, 240000, 512),
]


def validate_levels(p) -> tuple:
    """(level_idc, warnings) — the x264_validate_levels analog
    (reference encoder/set.c:876): pick the smallest level whose frame
    size / MB rate / DPB / bitrate / CPB limits all hold, or check the
    user's forced level against them (warn, don't refuse — like the
    reference)."""
    mbs = p.mb_width * p.mb_height
    fps = p.fps_num / max(1, p.fps_den)
    dpb_frames = max(p.ref_frames, 2 if p.bframes else p.ref_frames)
    br = p.vbv_maxrate or (p.bitrate if p.rc_method == RC_ABR_ else 0)
    cpb = p.vbv_bufsize

    def fits(lv):
        _, max_mbps, max_fs, max_dpb_mbs, max_br, max_cpb, _ = lv
        return (mbs <= max_fs and mbs * fps <= max_mbps
                and dpb_frames * mbs <= max_dpb_mbs
                and (not br or br <= max_br * 1.25)    # high-profile CpbBrFactor
                and (not cpb or cpb <= max_cpb * 1.25))

    warnings = []
    if p.level_idc:
        row = next((lv for lv in LEVELS if lv[0] == p.level_idc), None)
        if row is None:
            raise ValueError(f"unknown level_idc {p.level_idc}")
        if not fits(row):
            warnings.append(
                f"level {p.level_idc/10:.1f} is too small for "
                f"{16*p.mb_width}x{16*p.mb_height}@{fps:.3g} with "
                f"dpb={dpb_frames}; stream will exceed its limits")
        return p.level_idc, warnings
    for lv in LEVELS:
        if fits(lv):
            return lv[0], warnings
    warnings.append("stream exceeds level 5.2 limits")
    return 52, warnings


def sps_from_params(p: EncoderParams) -> SpsInfo:
    level, _ = validate_levels(p)
    return SpsInfo(
        profile_idc=p.profile_idc,
        level_idc=level,
        # poc_type 2 forbids reordering; B frames need explicit POC, and
        # both anchors must survive in the decoder DPB (sliding window)
        poc_type=0 if p.bframes else 2,
        num_ref_frames=max(p.ref_frames, 2) if p.bframes else p.ref_frames,
        mb_width=p.mb_width,
        mb_height=p.mb_height,
        crop_right=p.mb_width * 16 - p.width,
        crop_bottom=p.mb_height * 16 - p.height,
    )


# Table E-1 standard sample aspect ratios -> aspect_ratio_idc
_SAR_IDC = {(1, 1): 1, (12, 11): 2, (10, 11): 3, (16, 11): 4, (40, 33): 5,
            (24, 11): 6, (20, 11): 7, (32, 11): 8, (80, 33): 9,
            (18, 11): 10, (15, 11): 11, (64, 33): 12, (160, 99): 13,
            (4, 3): 14, (3, 2): 15, (2, 1): 16}


def _hrd_values(p: EncoderParams) -> dict:
    """NAL HRD parameters (E.1.2) from the VBV config, x264-style scale
    selection (reference encoder/set.c:74): largest scale whose unit
    still divides into the rate (values round UP — signaled rate/cpb
    may slightly exceed the configured ones, never undershoot)."""
    br = p.vbv_maxrate * 1000
    cpb = p.vbv_bufsize * 1000
    brs = cps = 0
    while brs < 15 and (br % (1 << (7 + brs))) == 0:
        brs += 1
    while cps < 15 and (cpb % (1 << (5 + cps))) == 0:
        cps += 1
    return dict(
        bit_rate_scale=brs, cpb_size_scale=cps,
        bit_rate_value=-(-br // (1 << (6 + brs))),
        cpb_size_value=-(-cpb // (1 << (4 + cps))),
        cbr=int(p.rc_method == RC_ABR_ and p.vbv_maxrate
                and p.bitrate == p.vbv_maxrate))


def _write_vui(bs: BitWriter, p: EncoderParams, s: SpsInfo) -> None:
    """vui_parameters (E.1.1) — parity: reference encoder/set.c
    x264_sps_init VUI block."""
    sar = (p.sar_width, p.sar_height)
    if p.sar_width and p.sar_height:
        bs.put1(1)
        idc = _SAR_IDC.get(sar, 255)
        bs.put(8, idc)
        if idc == 255:                      # Extended_SAR
            bs.put(16, p.sar_width)
            bs.put(16, p.sar_height)
    else:
        bs.put1(0)
    bs.put1(0)                              # overscan_info_present
    signal = (p.videoformat != 5 or p.fullrange or p.colorprim != 2
              or p.transfer != 2 or p.colmatrix != 2)
    bs.put1(1 if signal else 0)
    if signal:
        bs.put(3, p.videoformat)
        bs.put1(1 if p.fullrange else 0)
        desc = (p.colorprim != 2 or p.transfer != 2 or p.colmatrix != 2)
        bs.put1(1 if desc else 0)
        if desc:
            bs.put(8, p.colorprim)
            bs.put(8, p.transfer)
            bs.put(8, p.colmatrix)
    if p.chroma_loc:
        bs.put1(1)
        bs.ue(p.chroma_loc)                 # top field
        bs.ue(p.chroma_loc)                 # bottom field
    else:
        bs.put1(0)
    bs.put1(1)                              # timing_info_present
    bs.put(32, p.fps_den)                   # num_units_in_tick
    bs.put(32, 2 * p.fps_num)               # time_scale (field units)
    bs.put1(1)                              # fixed_frame_rate
    if p.nal_hrd:
        bs.put1(1)                          # nal_hrd_parameters_present
        h = _hrd_values(p)
        bs.ue(0)                            # cpb_cnt_minus1
        bs.put(4, h["bit_rate_scale"])
        bs.put(4, h["cpb_size_scale"])
        bs.ue(h["bit_rate_value"] - 1)
        bs.ue(h["cpb_size_value"] - 1)
        bs.put1(h["cbr"])
        bs.put(5, 23)                       # initial_cpb_removal_delay_len-1
        bs.put(5, 23)                       # cpb_removal_delay_length-1
        bs.put(5, 23)                       # dpb_output_delay_length-1
        bs.put(5, 0)                        # time_offset_length
    else:
        bs.put1(0)
    bs.put1(0)                              # vcl_hrd_parameters_present
    if p.nal_hrd:
        bs.put1(0)                          # low_delay_hrd_flag
    bs.put1(0)                              # pic_struct_present
    bs.put1(1)                              # bitstream_restriction
    bs.put1(1)                              # mvs_over_pic_boundaries
    bs.ue(0)                                # max_bytes_per_pic_denom
    bs.ue(0)                                # max_bits_per_mb_denom
    bs.ue(16)                               # log2_max_mv_length_horizontal
    bs.ue(16)                               # log2_max_mv_length_vertical
    bs.ue(1 if p.bframes else 0)            # num_reorder_frames
    bs.ue(s.num_ref_frames)                 # max_dec_frame_buffering


def write_sps(s: SpsInfo, p: EncoderParams | None = None) -> bytes:
    bs = BitWriter()
    bs.put(8, s.profile_idc)
    # constraint_set0..5 + 2 reserved zero bits
    cs0 = 1 if s.profile_idc == 66 else 0
    cs1 = 1 if s.profile_idc in (66, 77) else 0
    bs.put(8, (cs0 << 7) | (cs1 << 6))
    bs.put(8, s.level_idc)
    bs.ue(0)                                # sps_id
    if s.profile_idc >= 100:
        bs.ue(1)                            # chroma_format_idc 4:2:0
        bs.ue(0)                            # bit_depth_luma_minus8
        bs.ue(0)                            # bit_depth_chroma_minus8
        bs.put1(0)                          # qpprime_y_zero_transform_bypass
        bs.put1(0)                          # seq_scaling_matrix_present
    bs.ue(s.log2_max_frame_num - 4)
    bs.ue(s.poc_type)
    if s.poc_type == 0:
        bs.ue(s.log2_max_frame_num - 4)     # log2_max_poc_lsb_minus4
    bs.ue(s.num_ref_frames)
    bs.put1(0)                              # gaps_in_frame_num_value_allowed
    bs.ue(s.mb_width - 1)
    bs.ue(s.mb_height - 1)
    bs.put1(1)                              # frame_mbs_only_flag
    bs.put1(1)                              # direct_8x8_inference_flag
    if s.crop_right or s.crop_bottom:
        bs.put1(1)
        bs.ue(0)
        bs.ue(s.crop_right // 2)
        bs.ue(0)
        bs.ue(s.crop_bottom // 2)
    else:
        bs.put1(0)
    if p is not None:
        bs.put1(1)                          # vui_parameters_present
        _write_vui(bs, p, s)
    else:
        bs.put1(0)
    return make_nal(NAL_SPS, NAL_PRIORITY_HIGHEST, bs.to_rbsp())


def write_pps(p: EncoderParams) -> bytes:
    bs = BitWriter()
    bs.ue(0)                                # pps_id
    bs.ue(0)                                # sps_id
    bs.put1(1 if p.cabac else 0)
    bs.put1(0)                              # bottom_field_pic_order_present
    bs.ue(0)                                # num_slice_groups_minus1
    bs.ue(p.ref_frames - 1)
    bs.ue(0)                                # num_ref_idx_l1_active_minus1
    bs.put1(1 if p.weightp else 0)          # weighted_pred_flag
    bs.put(2, 0)                            # weighted_bipred_idc
    bs.se(p.qp - 26)                        # pic_init_qp_minus26
    bs.se(0)                                # pic_init_qs_minus26
    bs.se(p.chroma_qp_offset)
    bs.put1(1)                              # deblocking_filter_control_present
    bs.put1(1 if p.constrained_intra else 0)
    bs.put1(0)                              # redundant_pic_cnt_present
    if p.transform_8x8:
        # PPS extension (7.3.2.2 more_rbsp_data branch)
        bs.put1(1)                          # transform_8x8_mode_flag
        bs.put1(0)                          # pic_scaling_matrix_present
        bs.se(p.chroma_qp_offset)           # second_chroma_qp_index_offset
    return make_nal(NAL_PPS, NAL_PRIORITY_HIGHEST, bs.to_rbsp())


def write_slice_header(bs: BitWriter, p: EncoderParams, sps: SpsInfo, *,
                       slice_type: int, idr: bool, frame_num: int,
                       idr_pic_id: int = 0, first_mb: int = 0,
                       qp: int | None = None, num_ref: int = 1,
                       poc_lsb: int = 0, num_ref_l1: int = 1,
                       is_ref: bool = True, weights=None,
                       init_qp: int | None = None) -> None:
    """Appends slice_header() bits to bs. Caller wraps into a NAL."""
    bs.ue(first_mb)
    bs.ue(slice_type + 5)                   # "all slices same type" variant
    bs.ue(0)                                # pps_id
    bs.put(sps.log2_max_frame_num, frame_num)
    if idr:
        bs.ue(idr_pic_id)
    if sps.poc_type == 0:
        # callers pass the UNWRAPPED POC; only the LSBs go in the header
        # (reference encoder.c:241 masks i_poc the same way)
        bs.put(sps.log2_max_frame_num,
               poc_lsb & ((1 << sps.log2_max_frame_num) - 1))
    if slice_type == SLICE_B:
        bs.put1(0)                          # direct_spatial_mv_pred: temporal
    if slice_type in (SLICE_P, SLICE_B):
        override = 1 if (num_ref != p.ref_frames
                         or (slice_type == SLICE_B and num_ref_l1 != 1)) \
            else 0
        bs.put1(override)
        if override:
            bs.ue(num_ref - 1)
            if slice_type == SLICE_B:
                bs.ue(num_ref_l1 - 1)
        bs.put1(0)                          # ref_pic_list_modification_flag_l0
        if slice_type == SLICE_B:
            bs.put1(0)                      # ref_pic_list_modification_flag_l1
    if slice_type == SLICE_P and p.weightp:
        # pred_weight_table (7.3.3.2) — mandatory once the PPS sets
        # weighted_pred_flag; luma explicit, chroma default weights
        from x264_tpu_torch.models.weightp import LOG2_DENOM, NEUTRAL
        w_list = weights if weights is not None else [NEUTRAL] * num_ref
        bs.ue(LOG2_DENOM)                   # luma_log2_weight_denom
        bs.ue(LOG2_DENOM)                   # chroma_log2_weight_denom
        for (w, off) in w_list[:num_ref]:
            if (w, off) == NEUTRAL:
                bs.put1(0)                  # luma_weight_l0_flag
            else:
                bs.put1(1)
                bs.se(w)
                bs.se(off)
            bs.put1(0)                      # chroma_weight_l0_flag
    # dec_ref_pic_marking (reference pictures only)
    if idr:
        bs.put1(0)                          # no_output_of_prior_pics
        bs.put1(0)                          # long_term_reference_flag
    elif is_ref:
        bs.put1(0)                          # adaptive_ref_pic_marking_mode
    if p.cabac and slice_type != SLICE_I:
        bs.ue(0)                            # cabac_init_idc
    qp = p.qp if qp is None else qp
    # slice_qp_delta is vs the PPS's pic_init_qp, which was written at
    # open — reconfig may have changed p.qp since (encoder.c reconfig)
    bs.se(qp - (p.qp if init_qp is None else init_qp))
    # deblocking_filter_control_present is always on in our PPS
    if p.deblock:
        bs.ue(0)
        bs.se(p.deblock_alpha)
        bs.se(p.deblock_beta)
    else:
        bs.ue(1)                            # disable deblocking


def wrap_slice_nal(rbsp: bytes, idr: bool, is_ref: bool = True) -> bytes:
    return make_nal(NAL_SLICE_IDR if idr else NAL_SLICE,
                    NAL_PRIORITY_HIGHEST if idr else (2 if is_ref else 0),
                    rbsp)
