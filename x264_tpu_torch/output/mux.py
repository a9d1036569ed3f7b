"""Container muxers (reference output/raw.c, output/flv.c, output/mp4.c).

The encoder emits Annex-B access units; FLV/MP4 carry AVCC instead
(4-byte length prefixes + an avcC decoder-configuration record built
from the SPS/PPS).  Both muxers here write the simplest spec-conformant
form: FLV with onMetaData + AVC video tags; MP4 as a classic
ftyp/mdat/moov file with full sample tables written at close.

Copied from x264_tpu/output/mux.py; the port keeps its own copy."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from x264_tpu_torch.bitstream.nal import split_annexb


def extract_parameter_sets(au: bytes):
    """(sps_list, pps_list, vcl_and_sei_nals) from an Annex-B AU."""
    sps, pps, rest = [], [], []
    for nal in split_annexb(au):
        t = nal[0] & 0x1F
        if t == 7:
            sps.append(nal)
        elif t == 8:
            pps.append(nal)
        else:
            rest.append(nal)
    return sps, pps, rest


def annexb_to_avcc(au: bytes, keep_ps: bool = False) -> bytes:
    """Annex-B start codes -> 4-byte length prefixes (ISO 14496-15)."""
    out = bytearray()
    for nal in split_annexb(au):
        t = nal[0] & 0x1F
        if not keep_ps and t in (7, 8):
            continue
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def avcc_record(sps: bytes, pps: bytes) -> bytes:
    """AVCDecoderConfigurationRecord (14496-15 5.2.4.1)."""
    return (bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
            + struct.pack(">H", len(sps)) + sps
            + bytes([1]) + struct.pack(">H", len(pps)) + pps)


class RawMuxer:
    """Annex-B passthrough (output/raw.c)."""

    def __init__(self, path: str, params=None):
        self.f = open(path, "wb")

    def write_headers(self, headers: bytes):
        self.f.write(headers)

    def write_frame(self, au: bytes, pts: int, dts: int, keyframe: bool):
        self.f.write(au)

    def close(self):
        self.f.close()


class FlvMuxer:
    """FLV with AVC video tags (output/flv.c).  Timestamps in ms."""

    def __init__(self, path: str, params):
        self.f = open(path, "wb")
        self.p = params
        self.ms = 1000.0 * params.fps_den / max(1, params.fps_num)
        self.f.write(b"FLV\x01\x01\x00\x00\x00\x09")   # video-only
        self.f.write(struct.pack(">I", 0))             # PreviousTagSize0
        self._wrote_cfg = False

    def _tag(self, ttype: int, ts_ms: int, data: bytes):
        ts = int(ts_ms) & 0x7FFFFFFF
        hdr = struct.pack(">B", ttype) + struct.pack(">I", len(data))[1:] \
            + struct.pack(">I", ts & 0xFFFFFF)[1:] \
            + bytes([(ts >> 24) & 0xFF]) + b"\x00\x00\x00"
        self.f.write(hdr + data)
        self.f.write(struct.pack(">I", 11 + len(data)))

    def write_headers(self, headers: bytes):
        sps, pps, _ = extract_parameter_sets(headers)
        cfg = avcc_record(sps[0], pps[0])
        # VIDEODATA: keyframe(1)|AVC(7), AVCPacketType 0 (seq header)
        self._tag(9, 0, bytes([0x17, 0x00, 0, 0, 0]) + cfg)
        self._wrote_cfg = True

    def write_frame(self, au: bytes, pts: int, dts: int, keyframe: bool):
        if not self._wrote_cfg:
            self.write_headers(au)
        data = annexb_to_avcc(au)
        if not data:
            return
        ct = max(0, int(round((pts - dts) * self.ms)))   # composition offset
        self._tag(9, dts * self.ms,
                  bytes([0x17 if keyframe else 0x27, 0x01])
                  + struct.pack(">I", ct)[1:] + data)

    def close(self):
        self.f.close()


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags),
                *payload)


@dataclass
class _Mp4State:
    sizes: list = field(default_factory=list)
    offsets: list = field(default_factory=list)
    keyflags: list = field(default_factory=list)
    ctts: list = field(default_factory=list)      # composition offsets


class Mp4Muxer:
    """Minimal unfragmented MP4 (output/mp4.c role): ftyp + mdat + moov
    with stts/stsc/stsz/stco/stss/ctts sample tables written at close."""

    def __init__(self, path: str, params):
        self.f = open(path, "wb")
        self.p = params
        self.st = _Mp4State()
        self.sps = self.pps = None
        self.f.write(_box(b"ftyp", b"isom", struct.pack(">I", 512),
                          b"isomiso2avc1mp41"))
        self._mdat_pos = self.f.tell()
        self.f.write(struct.pack(">I", 0) + b"mdat")

    def write_headers(self, headers: bytes):
        sps, pps, _ = extract_parameter_sets(headers)
        if self.sps is None:
            self.sps, self.pps = sps[0], pps[0]

    def write_frame(self, au: bytes, pts: int, dts: int, keyframe: bool):
        if self.sps is None:
            self.write_headers(au)
        data = annexb_to_avcc(au)
        if not data:
            return
        self.st.offsets.append(self.f.tell())
        self.st.sizes.append(len(data))
        self.st.keyflags.append(keyframe)
        self.st.ctts.append(pts - dts)
        self.f.write(data)

    def close(self):
        st = self.st
        n = len(st.sizes)
        end = self.f.tell()
        # patch mdat size
        self.f.seek(self._mdat_pos)
        self.f.write(struct.pack(">I", end - self._mdat_pos))
        self.f.seek(end)

        p = self.p
        tscale = p.fps_num
        dur = p.fps_den
        total = n * dur
        w, h = p.width, p.height

        stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, dur))
        stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n),
                     b"".join(struct.pack(">I", s) for s in st.sizes))
        stco = _full(b"stco", 0, 0, struct.pack(">I", n),
                     b"".join(struct.pack(">I", o) for o in st.offsets))
        keys = [i + 1 for i, k in enumerate(st.keyflags) if k]
        stss = _full(b"stss", 0, 0, struct.pack(">I", len(keys)),
                     b"".join(struct.pack(">I", k) for k in keys))
        boxes = [stts, stsc, stsz, stco, stss]
        if any(st.ctts):
            # version 1 (signed offsets), one entry per sample
            ctts = _full(b"ctts", 1, 0, struct.pack(">I", n),
                         b"".join(struct.pack(">Ii", 1, c * dur)
                                  for c in st.ctts))
            boxes.insert(1, ctts)

        avc1 = _box(
            b"avc1",
            struct.pack(">IHH", 0, 0, 1)        # reserved, data_ref_idx
            + b"\x00" * 16
            + struct.pack(">HH", w, h)
            + struct.pack(">II", 0x00480000, 0x00480000)   # 72 dpi
            + struct.pack(">IH", 0, 1)          # reserved, frame_count
            + b"\x00" * 32                       # compressorname
            + struct.pack(">Hh", 0x18, -1),      # depth, color table
            _box(b"avcC", avcc_record(self.sps, self.pps)))
        stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1), avc1)
        stbl = _box(b"stbl", stsd, *boxes)
        vmhd = _full(b"vmhd", 0, 1, b"\x00" * 8)
        dinf = _box(b"dinf", _full(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full(b"url ", 0, 1)))
        minf = _box(b"minf", vmhd, dinf, stbl)
        hdlr = _full(b"hdlr", 0, 0, b"\x00" * 4 + b"vide" + b"\x00" * 12
                     + b"VideoHandler\x00")
        mdhd = _full(b"mdhd", 0, 0,
                     struct.pack(">IIIIHH", 0, 0, tscale, total,
                                 0x55C4, 0))    # und language
        mdia = _box(b"mdia", mdhd, hdlr, minf)
        tkhd = _full(b"tkhd", 0, 7,
                     struct.pack(">IIIII", 0, 0, 1, 0, total)
                     + b"\x00" * 16
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + struct.pack(">II", w << 16, h << 16))
        trak = _box(b"trak", tkhd, mdia)
        mvhd = _full(b"mvhd", 0, 0,
                     struct.pack(">IIII", 0, 0, tscale, total)
                     + struct.pack(">IH", 0x10000, 0x100) + b"\x00" * 10
                     + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                   0, 0, 0x40000000)
                     + b"\x00" * 24 + struct.pack(">I", 2))
        self.f.write(_box(b"moov", mvhd, trak))
        self.f.close()


def open_muxer(path: str, params):
    """Pick a muxer by file extension (the reference's select_output)."""
    low = path.lower()
    if low.endswith(".flv"):
        return FlvMuxer(path, params)
    if low.endswith((".mp4", ".m4v", ".mov")):
        return Mp4Muxer(path, params)
    if low.endswith((".mkv", ".webm")):
        return MkvMuxer(path, params)
    return RawMuxer(path, params)


# ---- Matroska (reference output/matroska.c: a standalone EBML writer) ----

def _vint(v: int) -> bytes:
    """EBML variable-length size coding."""
    for n in range(1, 9):
        if v < (1 << (7 * n)) - 1:
            b = v | (1 << (7 * n))
            return b.to_bytes(n, "big")
    raise ValueError("vint overflow")


def _ebml(eid: int, payload: bytes) -> bytes:
    nid = (eid.bit_length() + 7) // 8
    return eid.to_bytes(nid, "big") + _vint(len(payload)) + payload


def _ebml_uint(eid: int, v: int) -> bytes:
    n = max(1, (v.bit_length() + 7) // 8)
    return _ebml(eid, v.to_bytes(n, "big"))


def _ebml_float(eid: int, v: float) -> bytes:
    return _ebml(eid, struct.pack(">d", v))


def _ebml_str(eid: int, s: str) -> bytes:
    return _ebml(eid, s.encode())


class MkvMuxer:
    """Matroska with one Cluster per frame (SimpleBlocks, ms timestamps,
    frames in decode order with pts timecodes — the reference
    output/matroska.c layout).  The Segment is buffered and written
    sized at close (the reference instead back-patches a seekable
    file)."""

    def __init__(self, path: str, params):
        self.f = open(path, "wb")
        self.p = params
        self.ms = 1000.0 * params.fps_den / max(1, params.fps_num)
        self._body = []
        self._cfg = None
        self._maxpts = 0

    def write_headers(self, headers: bytes):
        sps, pps, _ = extract_parameter_sets(headers)
        self._cfg = avcc_record(sps[0], pps[0])

    def write_frame(self, au: bytes, pts: int, dts: int, keyframe: bool):
        if self._cfg is None:
            self.write_headers(au)
        data = annexb_to_avcc(au)
        if not data:
            return
        ts = int(round(pts * self.ms))
        self._maxpts = max(self._maxpts, ts)
        sb = _ebml(0xA3, b"\x81" + struct.pack(">h", 0)
                   + bytes([0x80 if keyframe else 0x00]) + data)
        self._body.append(_ebml(0x1F43B675,                  # Cluster
                                _ebml_uint(0xE7, ts) + sb))

    def close(self):
        p = self.p
        ebml_hdr = _ebml(0x1A45DFA3,
                         _ebml_uint(0x4286, 1)               # EBMLVersion
                         + _ebml_uint(0x42F7, 1)
                         + _ebml_uint(0x42F2, 4)
                         + _ebml_uint(0x42F3, 8)
                         + _ebml_str(0x4282, "matroska")     # DocType
                         + _ebml_uint(0x4287, 2)
                         + _ebml_uint(0x4285, 2))
        info = _ebml(0x1549A966,
                     _ebml_uint(0x2AD7B1, 1000000)           # 1 ms scale
                     + _ebml_float(0x4489, float(self._maxpts + self.ms))
                     + _ebml_str(0x4D80, "x264_tpu")
                     + _ebml_str(0x5741, "x264_tpu"))
        video = _ebml(0xE0, _ebml_uint(0xB0, p.width)
                      + _ebml_uint(0xBA, p.height))
        track = _ebml(0xAE,
                      _ebml_uint(0xD7, 1)                    # TrackNumber
                      + _ebml_uint(0x73C5, 1)                # TrackUID
                      + _ebml_uint(0x83, 1)                  # video
                      + _ebml_uint(0x23E383, int(round(
                          1e9 * p.fps_den / max(1, p.fps_num))))
                      + _ebml_str(0x86, "V_MPEG4/ISO/AVC")
                      + _ebml(0x63A2, self._cfg or b"")      # CodecPrivate
                      + video)
        tracks = _ebml(0x1654AE6B, track)
        seg = info + tracks + b"".join(self._body)
        self.f.write(ebml_hdr + _ebml(0x18538067, seg))
        self.f.close()
