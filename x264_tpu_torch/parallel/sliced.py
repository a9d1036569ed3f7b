"""Sliced-band P frames over CUDA devices, one band a card: the port of
x264_tpu/parallel/sliced.py, the analog of x264's sliced threads
(encoder/encoder.c threaded_slices_write, doc/threads.txt).

The frame is split into horizontal bands of MB rows of equal height, one
a device.  Each band runs ``models.inter.p_band_core`` on its own card,
on its rows of the source and its halo window of the edge-padded
reference planes: its rows and the PAD rows (PAD // 2 in chroma) of the
bands around it, which is the window the reference cuts from its
replicated planes (sliced.py:59-66).  So no reference plane is copied
whole, and no band predicts from another: each band is coded as a slice
of its own (first_mb_in_slice = its first MB), and its outputs equal
the band loop's (``Encoder._band_core``) field for field.

The copies between cards are PyTorch's, which orders a copy after the
current streams of both cards; so the bands need no streams or events
of their own, and the host enqueues every band before it waits on any
card.  On the CPU the device list is the CPU device n times (the
reference's virtual CPU devices, tests/conftest.py) and the bands run
in turn.
"""

from __future__ import annotations

import contextlib

import torch

from x264_tpu_torch.models.inter import p_band_core
from x264_tpu_torch.state import PAD


def on_card(device):
    """A context in which ``device`` is the current CUDA device (where a
    raw kernel launch and a graph capture go); nothing for the CPU."""
    device = torch.device(device)
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def make_band_mesh(n_devices: int, device="cuda") -> list:
    """The devices that hold the bands: on CUDA ``device``'s card first,
    then the host's other cards in index order (raises when the host has
    fewer than ``n_devices``, as the reference does); on the CPU the CPU
    device ``n_devices`` times."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n_devices
    if device.type != "cuda":
        raise ValueError(f"make_band_mesh: no band mesh on {device}")
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    first = (device.index if device.index is not None
             else torch.cuda.current_device())
    order = [first] + [i for i in range(have) if i != first]
    return [torch.device("cuda", i) for i in order[:n_devices]]


def band_window(planes, refpads, y0: int, bh: int) -> tuple:
    """Views of MB rows [y0, y0 + bh): the source rows of ``planes`` (y, u,
    v) and the halo window of ``refpads`` (the reference planes padded by
    PAD luma and PAD // 2 chroma), rows [16 y0, 16 (y0 + bh) + 2 PAD) and
    [8 y0, 8 (y0 + bh) + PAD)."""
    y, u, v = planes
    ry, ru, rv = refpads
    return (y[16 * y0:16 * (y0 + bh)], u[8 * y0:8 * (y0 + bh)],
            v[8 * y0:8 * (y0 + bh)], ry[16 * y0:16 * (y0 + bh) + 2 * PAD],
            ru[8 * y0:8 * (y0 + bh) + PAD], rv[8 * y0:8 * (y0 + bh) + PAD])


def run_band(device, planes, refpads, y0: int, bh: int, qp, lam: int,
             mbw: int, **core_kw) -> dict:
    """Band rows [y0, y0 + bh) through ``p_band_core`` on ``device``: its
    window copied there (a view where it is there already) and the core
    run with ``device`` current.  qp: an int, or the frame's per-MB QPs
    (N,), of which the band takes its own.  Returns the core's outputs,
    on ``device``."""
    device = torch.device(device)
    with on_card(device):
        args = [t.to(device) for t in band_window(planes, refpads, y0, bh)]
        if torch.is_tensor(qp):
            qp = qp[y0 * mbw:(y0 + bh) * mbw].to(device)
        return p_band_core(*args, qp, lam, mbw=mbw, mbh=bh, **core_kw)


def gather(outs: list, keys, device) -> dict:
    """Each of ``keys`` of the bands' outputs concatenated band-major
    (which is the frame's MB raster order for horizontal bands) onto
    ``device``."""
    return {k: torch.cat([o[k].to(device) for o in outs]) for k in keys}


class SlicedPStep:
    """A P frame's bands over ``devices``, one band a device (see
    ``build_sliced_p_step``)."""

    def __init__(self, devices, mbw: int, mbh_per_band: int, core_kw: dict):
        self.devices = [torch.device(d) for d in devices]
        self.mbw, self.mbh_per_band = mbw, mbh_per_band
        self.core_kw = core_kw

    def bands(self, y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp_mb,
              lam) -> list:
        """Every band enqueued on its card, none waited on: the bands'
        outputs, band b's on ``devices[b]``."""
        bh = self.mbh_per_band
        return [run_band(d, (y, u, v), (ref_y_pad, ref_u_pad, ref_v_pad),
                         b * bh, bh, qp_mb, int(lam), self.mbw,
                         **self.core_kw)
                for b, d in enumerate(self.devices)]

    def __call__(self, y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp_mb,
                 lam) -> dict:
        """The bands' outputs, each field gathered band-major onto
        ``devices[0]`` (the reference's ``out_specs``)."""
        outs = self.bands(y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp_mb,
                          lam)
        return gather(outs, outs[0].keys(), self.devices[0])


def build_sliced_p_step(devices, mbw: int, mbh_per_band: int,
                        me_range: int, cqp_off: int, n_words: int = 24,
                        subpel: int = 0, entropy: str = "cavlc",
                        lv_cap: int = 64):
    """Returns (step, dict(mbh, mbw, n_band)):
        step(y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, qp_mb, lam) -> dict
    where the planes are the whole frame (mbh = len(devices) *
    mbh_per_band MB rows), the reference planes already edge-padded (PAD
    luma, PAD // 2 chroma), qp_mb an int or a per-MB (N,) int32 tensor
    and lam an int.
    Band b runs on ``devices[b]`` the program of the band loop
    (``p_band_core``) with the CAVLC words (``entropy`` "cavlc",
    ``n_words`` a MB) or the CABAC blob ("cabac", ``lv_cap``); every
    output field comes back band-major on ``devices[0]``, which is the
    frame's MB raster order.  ``step.bands`` gives the bands' outputs on
    their own cards instead."""
    if entropy not in ("cavlc", "cabac"):
        raise ValueError(f"build_sliced_p_step: entropy {entropy!r}")
    core_kw = dict(me_range=me_range, cqp_off=cqp_off, subpel=subpel)
    core_kw.update(dict(n_words=n_words) if entropy == "cavlc"
                   else dict(lv_cap=lv_cap))
    step = SlicedPStep(devices, mbw, mbh_per_band, core_kw)
    return step, dict(mbh=mbh_per_band * len(step.devices), mbw=mbw,
                      n_band=len(step.devices))
