"""The I-frame cores replayed as CUDA graphs on the card.

An intra core is a wavefront of a few hundred dependent steps (187 at
1080p for the I16 core, 254 knight steps for the I4x4/I8x8 core), each a
few dozen small launches, so eager PyTorch spends its time launching.
Its shapes are fixed by the frame size, so the whole core is captured
once per key (core, size, options) as a ``torch.cuda.CUDAGraph`` and
replayed for every I frame.  There is no eager fallback on the card: a
failed capture raises.

- Inputs are static buffers of the graph, filled before each replay: the
  planes, the per-MB QP, the lambda (rate control changes it per frame)
  and the trellis parameter blocks (``kernels/trellis.params_block``
  caches one per QP; the graph holds its own copy).
- The first call warms the core up on a side stream (the per-device
  table caches fill there, so nothing uploads from host memory during
  capture), captures it on that stream and replays it, all under the
  planes' card.
- Outputs are owned by the graph and overwritten by the next replay, so
  every call returns clones.
- ``kernels.LAUNCHES`` counts in Python, that is at capture; each replay
  adds the counts its capture recorded, and the capture's own are taken
  back (it launches nothing).

The graphs are kept per process, like the kernel library: a 1080p
capture takes seconds, and every encoder of that size and options
replays the same graph.  Its input buffers are shared, so two encoders
must not run I frames of one key from two threads at once.
"""

from __future__ import annotations

import time

import torch

from x264_tpu_torch.kernels import LAUNCHES
from x264_tpu_torch.kernels.trellis import params_block

_I32 = torch.int32
_GRAPHS: dict = {}


class CoreGraph:
    """One intra core captured for one key; ``capture_ms`` is the first
    call's warm-up and capture time (the card synchronised)."""

    def __init__(self, core, planes, qp, lam, trellis_tbl, static: dict):
        with torch.cuda.device(planes[0].device):
            self._capture(core, planes, qp, lam, trellis_tbl, static)

    def _capture(self, core, planes, qp, lam, trellis_tbl, static: dict):
        dev = planes[0].device
        t0 = time.perf_counter()
        self.planes = [p.clone() for p in planes]
        self.qp = torch.empty(static["mbw"] * static["mbh"], dtype=_I32,
                              device=dev)
        self.lam = None if lam is None else torch.empty(1, dtype=_I32,
                                                        device=dev)
        self.tr = None
        bundle = None
        if trellis_tbl is not None:
            self.tr = [params_block(trellis_tbl[i], trellis_tbl[2], 15,
                                    dev).clone() for i in (3, 4)]
            # the I cores read only the I16-AC and chroma-AC blocks; the
            # trellis wrapper takes a tensor as a ready parameter block
            bundle = (None, None, trellis_tbl[2], *self.tr)
        self._load(planes, qp, lam, trellis_tbl)
        args = [*self.planes, self.qp] + ([] if lam is None else [self.lam])

        def run():
            return core(*args, trellis_tbl=bundle, **static)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(dev).wait_stream(side)
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        # captured on the side stream: torch.cuda.graph's default capture
        # stream is one stream for the process, on the device current when
        # it was first made, and a capture on another card's stream
        # records nothing of this card's launches
        with torch.cuda.graph(self.graph, stream=side):
            self.out = run()
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        LAUNCHES.update(before)
        torch.cuda.synchronize(dev)
        self.capture_ms = 1000 * (time.perf_counter() - t0)

    def _load(self, planes, qp, lam, trellis_tbl) -> None:
        for buf, p in zip(self.planes, planes):
            buf.copy_(p)
        self.qp.copy_(torch.as_tensor(qp, dtype=_I32, device=self.qp.device)
                      .reshape(-1).expand_as(self.qp))
        if lam is not None:
            self.lam.fill_(int(lam))
        if self.tr is not None:
            for buf, i in zip(self.tr, (3, 4)):
                buf.copy_(params_block(trellis_tbl[i], trellis_tbl[2], 15,
                                       buf.device))

    def __call__(self, planes, qp, lam, trellis_tbl) -> dict:
        self._load(planes, qp, lam, trellis_tbl)
        with torch.cuda.device(self.qp.device):
            self.graph.replay()
        for k, c in self.launches.items():
            LAUNCHES[k] += c
        return {k: v.clone() for k, v in self.out.items()}


def graph_for(core, planes, qp, lam=None, trellis_tbl=None,
              **static) -> CoreGraph:
    """The captured graph of ``core`` for this key, captured on first use
    with these inputs."""
    key = (core.__name__, str(planes[0].device), tuple(planes[0].shape),
           lam is not None, trellis_tbl is not None,
           tuple(sorted(static.items())))
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = CoreGraph(core, planes, qp, lam, trellis_tbl,
                                     static)
    return g


def run_core(core, y, u, v, qp, lam=None, trellis_tbl=None,
             **static) -> dict:
    """``core(y, u, v, qp[, lam], trellis_tbl=..., **static)`` on CUDA
    tensors, as a replay of its graph.  lam: the I4x4 core's lambda (an
    int), None for the I16 core."""
    if y.device.type != "cuda":
        raise ValueError(f"run_core: CUDA graphs need CUDA tensors, not "
                         f"{y.device}")
    g = graph_for(core, (y, u, v), qp, lam, trellis_tbl, **static)
    return g((y, u, v), qp, lam, trellis_tbl)
