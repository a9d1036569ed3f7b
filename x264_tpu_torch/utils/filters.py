"""Video filter chain (--vf) — the reference's filters/video/ analog
(crop/select_every/resize; filters/video/video.h:34-56).  Filters are
host-side numpy transforms applied per input frame before encoding.

Copied from x264_tpu/utils/filters.py; the port keeps its own copy."""

from __future__ import annotations

import numpy as np

from x264_tpu_torch.utils.yuv import Frame420


class CropFilter:
    """crop:left,top,right,bottom (pixels; even values for 4:2:0)."""

    def __init__(self, left: int, top: int, right: int, bottom: int):
        if any(v % 2 for v in (left, top, right, bottom)):
            raise ValueError("crop offsets must be even for 4:2:0")
        self.l, self.t, self.r, self.b = left, top, right, bottom

    def out_size(self, w: int, h: int):
        return w - self.l - self.r, h - self.t - self.b

    def __call__(self, fr: Frame420) -> Frame420:
        h, w = fr.y.shape
        l, t = self.l, self.t
        r, b = w - self.r, h - self.b
        return Frame420(np.ascontiguousarray(fr.y[t:b, l:r]),
                        np.ascontiguousarray(fr.u[t // 2:b // 2,
                                                  l // 2:r // 2]),
                        np.ascontiguousarray(fr.v[t // 2:b // 2,
                                                  l // 2:r // 2]))


class SelectEveryFilter:
    """select_every:step,offset0[,offset1...] — frame decimation
    (filters/video/select_every.c).  __call__ returns None for dropped
    frames."""

    def __init__(self, step: int, offsets):
        self.step = step
        self.offsets = set(offsets)
        self.idx = 0

    def out_size(self, w, h):
        return w, h

    def __call__(self, fr: Frame420):
        keep = (self.idx % self.step) in self.offsets
        self.idx += 1
        return fr if keep else None


def _resize_plane(p: np.ndarray, ow: int, oh: int) -> np.ndarray:
    """Separable bilinear resample (the swscale-bilinear analog)."""
    ih, iw = p.shape
    if (iw, ih) == (ow, oh):
        return p
    x = (np.arange(ow) + 0.5) * iw / ow - 0.5
    y = (np.arange(oh) + 0.5) * ih / oh - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, iw - 1)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, ih - 1)
    x1 = np.minimum(x0 + 1, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    fx = np.clip(x - x0, 0, 1)
    fy = np.clip(y - y0, 0, 1)
    pf = p.astype(np.float32)
    top = pf[y0][:, x0] * (1 - fx) + pf[y0][:, x1] * fx
    bot = pf[y1][:, x0] * (1 - fx) + pf[y1][:, x1] * fx
    out = top * (1 - fy)[:, None] + bot * fy[:, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


class ResizeFilter:
    """resize:WxH — bilinear scaler (the reference delegates to
    libswscale; a native separable bilinear here)."""

    def __init__(self, w: int, h: int):
        if w % 2 or h % 2:
            raise ValueError("resize target must be even for 4:2:0")
        self.w, self.h = w, h

    def out_size(self, w, h):
        return self.w, self.h

    def __call__(self, fr: Frame420) -> Frame420:
        return Frame420(_resize_plane(fr.y, self.w, self.h),
                        _resize_plane(fr.u, self.w // 2, self.h // 2),
                        _resize_plane(fr.v, self.w // 2, self.h // 2))


def parse_vf(spec: str):
    """'crop:0,0,16,0/resize:640x360/select_every:2,0' -> filter list
    (the reference's --vf chain syntax, x264.c)."""
    chain = []
    for part in spec.split("/"):
        if not part:
            continue
        name, _, args = part.partition(":")
        if name == "crop":
            vals = [int(v) for v in args.split(",")]
            if len(vals) != 4:
                raise ValueError("crop takes left,top,right,bottom")
            chain.append(CropFilter(*vals))
        elif name == "select_every":
            vals = [int(v) for v in args.split(",")]
            if len(vals) < 2:
                raise ValueError("select_every takes step,offset[,...]")
            chain.append(SelectEveryFilter(vals[0], vals[1:]))
        elif name == "resize":
            w, _, h = args.partition("x")
            chain.append(ResizeFilter(int(w), int(h)))
        else:
            raise ValueError(f"unknown filter {name!r}")
    return chain


def apply_chain(chain, fr: Frame420):
    """Run the chain; None = frame dropped by a decimator."""
    for f in chain:
        fr = f(fr)
        if fr is None:
            return None
    return fr


def chain_out_size(chain, w: int, h: int):
    for f in chain:
        w, h = f.out_size(w, h)
    return w, h


def parse_qpfile(path: str):
    """--qpfile: lines 'frame_number frame_type [qp]' (reference
    x264.c:1801 parse_qpfile).  Returns {frame: (type_enum, qp|None)}."""
    from x264_tpu_torch.params import TYPE_B, TYPE_BREF, TYPE_I, TYPE_IDR, TYPE_P
    tmap = {"I": TYPE_IDR, "i": TYPE_I, "K": TYPE_IDR, "P": TYPE_P,
            "B": TYPE_BREF, "b": TYPE_B}
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            idx = int(parts[0])
            t = tmap.get(parts[1])
            if t is None:
                raise ValueError(f"bad qpfile frame type {parts[1]!r}")
            qp = int(parts[2]) if len(parts) > 2 else None
            out[idx] = (t, qp)
    return out


class ThreadedReader:
    """Read-ahead input thread (the reference input/thread.c analog):
    prefetches frames from any iterator into a bounded queue so disk IO
    overlaps encoding."""

    def __init__(self, it, depth: int = 4):
        import queue
        import threading
        self.q = queue.Queue(maxsize=max(1, depth))
        self._done = object()

        def pump():
            try:
                for fr in it:
                    self.q.put(fr)
            finally:
                self.q.put(self._done)

        self.t = threading.Thread(target=pump, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            fr = self.q.get()
            if fr is self._done:
                return
            yield fr
