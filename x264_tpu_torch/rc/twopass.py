"""Two-pass rate control: x264-style stats file write/read + pass-2
allocation (parity: reference encoder/ratecontrol.c — stat line written in
x264_ratecontrol_end :1846-1871, parsed in x264_ratecontrol_new
:1050-1066, allocation in init_pass2 :1219).

Line format follows x264's field names so existing tooling can parse it:
  in:%d out:%d type:%c dur:%f q:%.2f aq:%.2f tex:%d mv:%d misc:%d \
  imb:%d pmb:%d smb:%d d:-
(round 1: tex carries all payload bits; mv/misc are 0 until bit-type
accounting lands).

Copied whole from x264_tpu/rc/twopass.py.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from x264_tpu_torch.rc.ratecontrol import qp2qscale, qscale2qp


@dataclass
class FrameStat:
    idx: int
    ftype: str          # "I" or "P" (or "B" later)
    qp: float
    bits: int
    cost: float         # prediction cost (complexity proxy)
    imb: int = 0
    pmb: int = 0
    smb: int = 0


def write_stats(path: str, stats: list[FrameStat], options: str) -> None:
    with open(path, "w") as f:
        f.write(f"#options: {options}\n")
        for s in stats:
            c = "I" if s.ftype in ("I", "IDR") else s.ftype[0]
            f.write(f"in:{s.idx} out:{s.idx} type:{c} dur:0.04 "
                    f"q:{s.qp:.2f} aq:{s.qp:.2f} tex:{s.bits} mv:0 misc:0 "
                    f"imb:{s.imb} pmb:{s.pmb} smb:{s.smb} d:-\n")


def read_stats(path: str) -> list[FrameStat]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            kv = dict(t.split(":", 1) for t in line.split() if ":" in t)
            out.append(FrameStat(
                idx=int(kv["in"]), ftype=kv["type"], qp=float(kv["q"]),
                bits=int(kv["tex"]) + int(kv.get("mv", 0))
                + int(kv.get("misc", 0)),
                cost=0.0,
                imb=int(kv.get("imb", 0)), pmb=int(kv.get("pmb", 0)),
                smb=int(kv.get("smb", 0))))
    return out


def plan_pass2(stats: list[FrameStat], bitrate_kbps: int, fps: float,
               qcomp: float = 0.6, qp_min: int = 0,
               qp_max: int = 51) -> list[int]:
    """Allocate per-frame QPs to hit the target bitrate.

    Model (init_pass2's): bits_i ~ coeff * cplx_i / qscale_i with
    cplx_i = bits_i * qscale_i from pass 1; choose
    qscale_i = cplx_i^(1-qcomp) / rf with rf solved in closed form so the
    modelled total equals the target, then clip to the spec QP range."""
    target = bitrate_kbps * 1000.0 / fps * len(stats)
    cplx = np.array([max(s.bits, 1) * qp2qscale(s.qp) for s in stats])
    # bits_i(rf) = cplx_i / qscale_i = cplx_i^qcomp * rf
    rf = target / np.sum(cplx ** qcomp)
    qps = []
    for s, cx in zip(stats, cplx):
        q = cx ** (1.0 - qcomp) / max(rf, 1e-12)
        qp = qscale2qp(max(q, 1e-9))
        if s.ftype == "I":
            qp -= 2.0
        qps.append(int(np.clip(round(qp), qp_min, qp_max)))
    return qps
