"""SEI messages (Annex D; parity: reference encoder/set.c
x264_sei_version_write and the generic x264_sei_write).

Round scope: user_data_unregistered version SEI (the header x264 always
emits after SPS/PPS identifying the encoder and its settings) plus the
generic payload framing (ff-escaped type/size bytes, rbsp trailing).

Copied from x264_tpu/bitstream/sei.py: the version SEI only (the HRD
and recovery-point SEIs belong to settings the port does not run).
"""

from __future__ import annotations

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
