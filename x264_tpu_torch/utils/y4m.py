"""Y4M (YUV4MPEG2) demuxer/muxer + raw YUV reader (parity: reference
input/y4m.c, input/raw.c, output/raw.c — the CLI I/O stack's default
path).

Copied from x264_tpu/utils/y4m.py; the port keeps its own copy."""

from __future__ import annotations

import io
import re

import numpy as np

from x264_tpu_torch.utils.yuv import Frame420


class Y4MReader:
    """Streaming YUV4MPEG2 reader (4:2:0 8-bit)."""

    def __init__(self, f):
        self.f = f if hasattr(f, "read") else open(f, "rb")
        header = self.f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m stream")
        self.width = self.height = 0
        self.fps_num, self.fps_den = 25, 1
        self.interlaced = False
        self.colorspace = "420mpeg2"     # y4m default chroma siting
        self.aspect = "0:0"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.width = int(tok[1:])
            elif tok[0] == "A":
                self.aspect = tok[1:]
            elif tok[0] == "H":
                self.height = int(tok[1:])
            elif tok[0] == "F":
                num, den = tok[1:].split(":")
                self.fps_num, self.fps_den = int(num), int(den)
            elif tok[0] == "I":
                self.interlaced = tok[1:] != "p"
            elif tok[0] == "C":
                if not tok[1:].startswith("420"):
                    raise ValueError(f"unsupported y4m colorspace {tok}")
                self.colorspace = tok[1:]
        if not (self.width and self.height):
            raise ValueError("y4m missing geometry")
        self._fsz = self.width * self.height * 3 // 2

    def __iter__(self):
        return self

    def __next__(self) -> Frame420:
        line = self.f.readline()
        if not line:
            raise StopIteration
        if not line.startswith(b"FRAME"):
            raise ValueError("bad y4m frame marker")
        data = self.f.read(self._fsz)
        if len(data) < self._fsz:
            raise StopIteration
        return _unpack_i420(data, self.width, self.height)


class RawReader:
    """Raw I420 reader (needs explicit geometry; input/raw.c analog)."""

    def __init__(self, f, width: int, height: int, fps=(25, 1)):
        self.f = f if hasattr(f, "read") else open(f, "rb")
        self.width, self.height = width, height
        self.fps_num, self.fps_den = fps
        self._fsz = width * height * 3 // 2

    def __iter__(self):
        return self

    def __next__(self) -> Frame420:
        data = self.f.read(self._fsz)
        if len(data) < self._fsz:
            raise StopIteration
        return _unpack_i420(data, self.width, self.height)


def _unpack_i420(data: bytes, w: int, h: int) -> Frame420:
    a = np.frombuffer(data, np.uint8)
    y = a[:w * h].reshape(h, w)
    u = a[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
    v = a[w * h + w * h // 4:].reshape(h // 2, w // 2)
    return Frame420(y.copy(), u.copy(), v.copy())


def write_y4m(path, frames, fps=(25, 1), colorspace="420mpeg2",
              aspect="0:0") -> None:
    """Y4M muxer (for recon dumps / tooling).  Carries the source's
    chroma-siting/aspect tokens through instead of mislabeling
    (defaults match the y4m spec's implied C420mpeg2)."""
    with open(path, "wb") as f:
        first = True
        for fr in frames:
            if first:
                h, w = fr.y.shape
                f.write(f"YUV4MPEG2 W{w} H{h} F{fps[0]}:{fps[1]} Ip "
                        f"A{aspect} C{colorspace}\n".encode())
                first = False
            f.write(b"FRAME\n")
            f.write(fr.y.tobytes())
            f.write(fr.u.tobytes())
            f.write(fr.v.tobytes())
