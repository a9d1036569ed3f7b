"""SEI messages (Annex D; parity: reference encoder/set.c
x264_sei_version_write and the generic x264_sei_write).

Round scope: user_data_unregistered version SEI (the header x264 always
emits after SPS/PPS identifying the encoder and its settings) plus the
generic payload framing (ff-escaped type/size bytes, rbsp trailing).

Copied from x264_tpu/bitstream/sei.py: the version SEI, the NAL HRD
buffering-period and pic-timing SEIs and the recovery-point SEI (their
``BitWriter`` import moved to the module's head).
"""

from __future__ import annotations

from x264_tpu_torch.bitstream.bits import BitWriter
from x264_tpu_torch.bitstream.nal import make_nal

SEI_USER_DATA_UNREGISTERED = 5

# matches the role of x264's fixed UUID (encoder/set.c:601) — a distinct
# one so streams are attributable to this encoder
_UUID = bytes.fromhex("b1d1a4e5a09c4f70b0c2a3d86e01f642")


def _sei_nal(payload_type: int, payload: bytes) -> bytes:
    """One SEI message wrapped in a NAL (nal_unit_type 6, nri 0)."""
    body = b""
    t = payload_type
    while t >= 255:
        body += b"\xff"
        t -= 255
    body += bytes([t])
    sz = len(payload)
    while sz >= 255:
        body += b"\xff"
        sz -= 255
    body += bytes([sz])
    body += payload
    body += b"\x80"                       # rbsp_trailing_bits
    return make_nal(6, 0, body)


def _payload_bytes(bs) -> bytes:
    """sei_payload alignment (D.1): bit_equal_to_one + zeros only when
    the payload is not already byte-aligned."""
    return (bs.to_bytes_aligned() if bs.bit_length % 8 == 0
            else bs.to_rbsp())


SEI_BUFFERING_PERIOD = 0
SEI_PIC_TIMING = 1
SEI_RECOVERY_POINT = 6


def buffering_period_sei(initial_delay_90k: int,
                         offset_90k: int = 0) -> bytes:
    """Buffering-period SEI (D.1.1) — NAL HRD branch (x264_sei_buffering_
    period_write, reference encoder/set.c:563).  Delays in 90 kHz ticks,
    24-bit fields (initial_cpb_removal_delay_length-1 = 23 in our VUI)."""
    bs = BitWriter()
    bs.ue(0)                                # seq_parameter_set_id
    bs.put(24, max(1, min(initial_delay_90k, (1 << 24) - 1)))
    bs.put(24, min(offset_90k, (1 << 24) - 1))
    return _sei_nal(SEI_BUFFERING_PERIOD, _payload_bytes(bs))


def pic_timing_sei(cpb_removal_delay: int, dpb_output_delay: int) -> bytes:
    """Pic-timing SEI (D.1.2) with CpbDpbDelaysPresent (nal_hrd in VUI),
    pic_struct absent (pic_struct_present=0) — x264_sei_pic_timing_write
    analog (reference encoder/set.c:653)."""
    bs = BitWriter()
    bs.put(24, min(cpb_removal_delay, (1 << 24) - 1))
    bs.put(24, min(dpb_output_delay, (1 << 24) - 1))
    return _sei_nal(SEI_PIC_TIMING, _payload_bytes(bs))


def recovery_point_sei(recovery_frame_cnt: int) -> bytes:
    """Recovery-point SEI (D.1.8) — x264_sei_recovery_point_write
    (reference encoder/set.c:688); marks gradual-refresh recovery."""
    bs = BitWriter()
    bs.ue(recovery_frame_cnt)
    bs.put1(1)                              # exact_match_flag
    bs.put1(0)                              # broken_link_flag
    bs.put(2, 0)                            # changing_slice_group_idc
    return _sei_nal(SEI_RECOVERY_POINT, _payload_bytes(bs))


def version_sei(params) -> bytes:
    """user_data_unregistered SEI describing the encoder + settings
    (x264_sei_version_write analog)."""
    opts = (f"cabac={int(params.cabac)} ref={params.ref_frames} "
            f"deblock={int(params.deblock)}:{params.deblock_alpha}:"
            f"{params.deblock_beta} me=esa subme={params.subpel} "
            f"merange={params.me_range} bframes={params.bframes} "
            f"b_adapt={params.b_adapt} keyint={params.keyint_max} "
            f"aq={params.aq_mode}:{params.aq_strength:.2f}")
    text = (f"x264_tpu - H.264/AVC codec for TPUs - "
            f"options: {opts}\x00").encode()
    return _sei_nal(SEI_USER_DATA_UNREGISTERED, _UUID + text)
