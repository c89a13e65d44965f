"""Test-time image resize (host side, numpy/cv2): the eval part of
``afigan_tpu/data/transforms.py``, the port's own copy. The training
augmentations (crop, flip, colour jitter, the x0.5 replay) come with the
training slices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class ResolvedTransform:
    """A resolved resize: original size and target size."""

    orig_h: int
    orig_w: int
    new_h: int
    new_w: int

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        import cv2

        out = cv2.resize(img, (self.new_w, self.new_h), interpolation=cv2.INTER_LINEAR)
        if out.ndim == 2:
            out = out[:, :, None]
        return np.ascontiguousarray(out)


def _shortest_edge_size(h: int, w: int, short: int, max_size: int) -> Tuple[int, int]:
    """d2 ResizeShortestEdge.get_output_shape numerics; size 0 means
    no resize (the d2 convention for disabling test-time resize)."""
    if short == 0:
        return h, w
    scale = short / min(h, w)
    if h < w:
        nh, nw = short, scale * w
    else:
        nh, nw = scale * h, short
    if max(nh, nw) > max_size:
        s = max_size / max(nh, nw)
        nh, nw = nh * s, nw * s
    return int(nh + 0.5), int(nw + 0.5)


def test_transform(h: int, w: int, min_size: int, max_size: int) -> ResolvedTransform:
    nh, nw = _shortest_edge_size(h, w, min_size, max_size)
    return ResolvedTransform(h, w, nh, nw)
