"""Image transforms (host side, numpy/cv2), the port's own copy of
``afigan_tpu/data/transforms.py``: the test-time resize, and the stage-3
training augmentation (ResizeShortestEdge over ``INPUT.MIN_SIZE_TRAIN`` by
choice or range, ``MAX_SIZE_TRAIN`` cap, horizontal flip) as a resolved
record applied to images, boxes and polygons. Crop, colour jitter and the
x0.5 replay of stages 1-2 come with those stages (the training mapper raises
on them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


def hflip_boxes(boxes: np.ndarray, width: float) -> np.ndarray:
    """Flip (N, 4) xyxy boxes in a ``width``-wide image (d2 HFlipTransform:
    x1' = w - x2, x2' = w - x1)."""
    out = np.asarray(boxes, np.float32).copy()
    x1 = width - out[:, 2]
    x2 = width - out[:, 0]
    out[:, 0], out[:, 2] = x1, x2
    return out


@dataclasses.dataclass
class ResolvedTransform:
    """A resolved resize (original size, target size) and flip."""

    orig_h: int
    orig_w: int
    new_h: int
    new_w: int
    hflip: bool = False

    def apply_image(self, img: np.ndarray, interp: str = "linear") -> np.ndarray:
        import cv2

        flags = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_NEAREST
        out = cv2.resize(img, (self.new_w, self.new_h), interpolation=flags)
        if out.ndim == 2:
            out = out[:, :, None]
        if self.hflip:
            out = out[:, ::-1]
        return np.ascontiguousarray(out)

    def apply_boxes(self, boxes: np.ndarray) -> np.ndarray:
        """(N, 4) xyxy in original coords → transformed coords."""
        if boxes.size == 0:
            return boxes.reshape(-1, 4)
        out = boxes.astype(np.float32).copy()
        out[:, [0, 2]] *= self.new_w / self.orig_w
        out[:, [1, 3]] *= self.new_h / self.orig_h
        return hflip_boxes(out, self.new_w) if self.hflip else out

    def apply_polygons(self, polygons):
        sx, sy = self.new_w / self.orig_w, self.new_h / self.orig_h
        out = []
        for p in polygons:
            p = np.asarray(p, dtype=np.float64).reshape(-1, 2).copy()
            p[:, 0] *= sx
            p[:, 1] *= sy
            if self.hflip:
                p[:, 0] = self.new_w - p[:, 0]
            out.append(p.reshape(-1).tolist())
        return out


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


def sample_train_transform(rng: np.random.RandomState, h: int, w: int,
                           min_sizes: Sequence[int], max_size: int,
                           sampling: str = "choice", flip_prob: float = 0.5
                           ) -> ResolvedTransform:
    """The short side by choice (or uniformly in a range) from ``min_sizes``,
    capped at ``max_size``, then a flip with ``flip_prob``: the JAX
    package's draws in its order (without crop and colour jitter), so one
    seed gives the same transforms."""
    if sampling == "choice":
        short = int(rng.choice(list(min_sizes)))
    else:
        short = int(rng.randint(min(min_sizes), max(min_sizes) + 1))
    nh, nw = _shortest_edge_size(h, w, short, max_size)
    return ResolvedTransform(h, w, nh, nw, bool(rng.rand() < flip_prob))
