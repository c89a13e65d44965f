"""Static-shape padded image batching on the host (counterpart of
``afigan_tpu/ops/image_list.py``): every image of a batch is zero-padded to
the smallest ``TPU.IMAGE_BUCKETS`` canvas that fits the largest, rounded up
to the model's size divisibility (``data/loader.py::choose_bucket``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..data.loader import choose_bucket


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad an (H, W, C) host image to the canvas."""
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    if ch < h or cw < w:
        raise ValueError(f"canvas {canvas_hw} smaller than image {(h, w)}")
    out = np.zeros((ch, cw) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    return out


def batch_images(images: Sequence[np.ndarray], buckets: Sequence[Sequence[int]],
                 size_divisibility: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """A list of (H, W, C) images → ((B, canvas, C) batch, (B, 2) int32 sizes)."""
    canvas = choose_bucket(max(im.shape[0] for im in images),
                           max(im.shape[1] for im in images), buckets, size_divisibility)
    tensor = np.stack([pad_to_canvas(im, canvas) for im in images])
    sizes = np.asarray([[im.shape[0], im.shape[1]] for im in images], dtype=np.int32)
    return tensor, sizes
