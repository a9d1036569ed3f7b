"""The 4:2:0 frame container and MB padding (copied from
x264_tpu/utils/yuv.py: ``Frame420``, ``pad_to_mb`` and, for the NumPy
tier, ``expand_border``; analog of reference common/frame.c plane
expansion)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from x264_tpu_torch.state import PAD

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


def expand_border(plane: np.ndarray, pad: int = PAD) -> np.ndarray:
    """Edge-replicate padding on all sides (for unclipped ME windows)."""
    return np.pad(plane, pad, mode="edge")
