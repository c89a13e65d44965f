"""Box primitives (counterpart of ``afigan_tpu/ops/boxes.py``): pairwise
intersection, IoU and IoA, clipping, non-empty mask and d2's
``Box2BoxTransform`` (xyxy, no +1, log(1000/16) scale clamp; ``get_deltas``
for the training targets)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_intersection(boxes1, boxes2):
    """(..., N, 4) x (..., M, 4) → (..., N, M) intersection areas."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1, boxes2):
    """(..., N, 4) x (..., M, 4) → (..., N, M) IoU; zero where the union is
    empty."""
    inter = pairwise_intersection(boxes1, boxes2)
    union = box_area(boxes1)[..., :, None] + box_area(boxes2)[..., None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def pairwise_ioa(boxes1, boxes2):
    """Intersection over the area of ``boxes2``: (..., N, M)."""
    inter = pairwise_intersection(boxes1, boxes2)
    area2 = box_area(boxes2)[..., None, :]
    return torch.where(area2 > 0, inter / torch.clamp(area2, min=1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def clip_boxes(boxes, image_size):
    """Clip (..., 4) xyxy to [0, W] x [0, H]; image_size is (h, w)."""
    h = image_size[..., 0].to(boxes.dtype)
    w = image_size[..., 1].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def nonempty_mask(boxes, threshold: float = 0.0):
    return ((boxes[..., 2] - boxes[..., 0]) > threshold) & (
        (boxes[..., 3] - boxes[..., 1]) > threshold)


class Box2BoxTransform:
    def __init__(self, weights: Sequence[float],
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes, target_boxes):
        """Regression targets (..., 4) that map ``src_boxes`` (anchors or
        proposals) onto ``target_boxes`` (the GT)."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h
        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h
        wx, wy, ww, wh = self.weights
        eps = 1e-12
        dx = wx * (tgt_cx - src_cx) / torch.clamp(src_w, min=eps)
        dy = wy * (tgt_cy - src_cy) / torch.clamp(src_h, min=eps)
        dw = ww * torch.log(torch.clamp(tgt_w, min=eps) / torch.clamp(src_w, min=eps))
        dh = wh * torch.log(torch.clamp(tgt_h, min=eps) / torch.clamp(src_h, min=eps))
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas, boxes):
        """(..., k*4) deltas on (..., 4) boxes → (..., k*4) boxes."""
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        ctr_x = boxes[..., 0] + 0.5 * widths
        ctr_y = boxes[..., 1] + 0.5 * heights
        wx, wy, ww, wh = self.weights
        d = deltas.reshape(*deltas.shape[:-1], -1, 4)
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp(d[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(d[..., 3] / wh, max=self.scale_clamp)
        pcx = dx * widths[..., None] + ctr_x[..., None]
        pcy = dy * heights[..., None] + ctr_y[..., None]
        pw = torch.exp(dw) * widths[..., None]
        ph = torch.exp(dh) * heights[..., None]
        out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                           pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)
        return out.reshape(deltas.shape)
