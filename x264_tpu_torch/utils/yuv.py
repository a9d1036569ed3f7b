"""The 4:2:0 frame container and MB padding (copied from
x264_tpu/utils/yuv.py: ``Frame420`` and ``pad_to_mb``; analog of
reference common/frame.c plane expansion)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

@dataclass
class Frame420:
    y: np.ndarray   # (H, W) uint8
    u: np.ndarray   # (H/2, W/2)
    v: np.ndarray

    @property
    def shape(self):
        return self.y.shape


def pad_to_mb(plane: np.ndarray, mb_size: int = 16) -> np.ndarray:
    """Pad plane to a multiple of mb_size by edge replication (matches the
    reference's frame_expand_border_mod16, common/frame.c)."""
    h, w = plane.shape
    ph = (-h) % mb_size
    pw = (-w) % mb_size
    if ph == 0 and pw == 0:
        return plane
    return np.pad(plane, ((0, ph), (0, pw)), mode="edge")
