"""NAL unit encapsulation: start codes + emulation prevention.

Equivalent capability to reference common/bitstream.c `x264_nal_encode` /
`nal_escape` (common/bitstream.h:57-69), implemented as a vectorized NumPy
scan rather than a byte loop.

Copied from x264_tpu/bitstream/nal.py (the writers, and the Annex-B
splitter the muxers use).
"""

from __future__ import annotations

import numpy as np

# nal_ref_idc
NAL_PRIORITY_DISPOSABLE = 0
NAL_PRIORITY_LOW = 1
NAL_PRIORITY_HIGH = 2
NAL_PRIORITY_HIGHEST = 3

# nal_unit_type
NAL_SLICE = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_FILLER = 12


def escape_rbsp(payload: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (0x03) before any byte that
    would complete a 0x000000/0x000001/0x000002/0x000003 sequence."""
    if len(payload) < 3:
        return payload
    b = np.frombuffer(payload, dtype=np.uint8)
    # candidate positions i where b[i-2]==0 and b[i-1]==0 and b[i]<=3
    cand = np.where((b[2:] <= 3) & (b[1:-1] == 0) & (b[:-2] == 0))[0] + 2
    if len(cand) == 0:
        return payload
    # After inserting 0x03 at position i, the window restarts; consecutive
    # candidates sharing zeros must be re-evaluated sequentially, but
    # insertion of 03 breaks any overlapping run, so we only need to drop
    # candidates whose preceding zeros were consumed by a previous insertion.
    keep = []
    last = -3
    for i in cand:
        if i - last >= 2:  # the two zero bytes are intact
            keep.append(i)
            last = i
    out = np.insert(b, np.array(keep, dtype=np.int64), 0x03)
    return out.tobytes()


def make_nal(nal_type: int, ref_idc: int, rbsp: bytes,
             long_startcode: bool = True) -> bytes:
    header = bytes([(ref_idc << 5) | nal_type])
    start = b"\x00\x00\x00\x01" if long_startcode else b"\x00\x00\x01"
    return start + header + escape_rbsp(rbsp)


def split_annexb(data: bytes):
    """Split an Annex-B elementary stream into raw NAL payloads (test use)."""
    b = np.frombuffer(data, dtype=np.uint8)
    starts = []
    i = 0
    n = len(b)
    while i + 2 < n:
        if b[i] == 0 and b[i + 1] == 0:
            if b[i + 2] == 1:
                starts.append(i + 3)
                i += 3
                continue
            if i + 3 < n and b[i + 2] == 0 and b[i + 3] == 1:
                starts.append(i + 4)
                i += 4
                continue
        i += 1
    nals = []
    for k, s in enumerate(starts):
        e = len(data) if k + 1 == len(starts) else starts[k + 1] - 3
        # trim trailing zeros belonging to next start code
        chunk = data[s:e]
        while chunk.endswith(b"\x00"):
            chunk = chunk[:-1]
        nals.append(chunk)
    return nals
