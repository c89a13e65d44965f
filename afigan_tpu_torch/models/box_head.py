"""Fast R-CNN box head, output layers, losses and fixed-shape inference
(counterpart of ``afigan_tpu/models/box_head.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import clip_boxes, nonempty_mask
from ..ops.losses import smooth_l1
from ..ops.nms import batched_nms_padded
from .layers import Conv2d, Linear, init_weight


class FastRCNNConvFCHead(nn.Module):
    """NUM_CONV 3x3 convs (+ norm, no bias under a norm) then NUM_FC linears,
    ReLU after each (d2 keys conv{i}, fc{i}).

    Pooled features arrive NHWC (R, P, P, C); ``fc1`` keeps d2's weight,
    whose input order is the NCHW flatten (C, P, P), so the features are
    flattened in that order."""

    def __init__(self, in_channels: int, pooler_resolution: int,
                 num_conv: int = 0, conv_dim: int = 256, num_fc: int = 2,
                 fc_dim: int = 1024, norm: str = "", device=None):
        super().__init__()
        self.num_conv = num_conv
        self.num_fc = num_fc
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", Conv2d(
                in_channels, conv_dim, 3, padding=1, bias=not norm, norm=norm,
                device=device))
            in_channels = conv_dim
        dim = in_channels * pooler_resolution * pooler_resolution
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim, device=device))
            dim = fc_dim
        self.out_dim = dim

    def init_weights(self, gen: torch.Generator) -> None:
        for i in range(self.num_conv):
            m = getattr(self, f"conv{i + 1}")
            init_weight(m.weight, "msra", gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        for i in range(self.num_fc):
            m = getattr(self, f"fc{i + 1}")
            init_weight(m.weight, "xavier", gen)
            nn.init.zeros_(m.bias)

    def forward(self, x):
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class FastRCNNOutputLayers(nn.Module):
    def __init__(self, in_dim: int, num_classes: int,
                 cls_agnostic_bbox_reg: bool = False, device=None):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1, device=device)
        nb = 1 if cls_agnostic_bbox_reg else num_classes
        self.bbox_pred = Linear(in_dim, nb * 4, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        init_weight(self.cls_score.weight, "normal0.01", gen)
        init_weight(self.bbox_pred.weight, "normal0.001", gen)
        nn.init.zeros_(self.cls_score.bias)
        nn.init.zeros_(self.bbox_pred.bias)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_losses(class_logits, pred_deltas, gt_classes, gt_deltas, valid,
                     num_classes: int, smooth_l1_beta: float = 0.0):
    """class_logits (R, C+1); pred_deltas (R, 4C) or (R, 4); gt_classes (R,)
    in [0, C] (C is background); gt_deltas (R, 4); valid (R,) → softmax CE
    over the valid rows / their count, and smooth-L1 of the GT class's deltas
    over the valid foreground rows / the same count (d2 fast_rcnn.py)."""
    logits = class_logits.float()
    n_valid = torch.clamp(valid.float().sum(), min=1.0)
    zero = torch.zeros((), device=logits.device)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, 1, gt_classes.long()[:, None])[:, 0]
    loss_cls = torch.where(valid, ce, zero).sum() / n_valid
    fg = valid & (gt_classes < num_classes)
    d = pred_deltas.float().reshape(pred_deltas.shape[0], -1, 4)
    if d.shape[1] == 1:
        sel = d[:, 0]
    else:
        cls = torch.clamp(gt_classes.long(), 0, num_classes - 1)
        sel = torch.gather(d, 1, cls[:, None, None].expand(-1, 1, 4))[:, 0]
    l1 = smooth_l1(sel, gt_deltas, smooth_l1_beta)
    loss_box = torch.where(fg[:, None], l1, zero).sum() / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


class Detections(NamedTuple):
    boxes: torch.Tensor    # (D, 4)
    scores: torch.Tensor   # (D,)
    classes: torch.Tensor  # (D,) int
    valid: torch.Tensor    # (D,) bool
    keypoints: Optional[torch.Tensor] = None  # (D, K, 3) [x, y, score]


def fast_rcnn_inference_single(boxes, scores, image_size, proposal_valid,
                               score_thresh: float, nms_thresh: float,
                               max_detections: int,
                               candidate_pool: int = 4096) -> Detections:
    """Fixed-shape d2 fast_rcnn_inference_single_image.

    boxes: (R, C, 4) per-class decoded boxes (or (R, 1, 4)); scores:
    (R, C+1) softmax probabilities; image_size (2,); proposal_valid (R,)."""
    r, c = scores.shape[0], scores.shape[1] - 1
    fg = scores[:, :c]
    if boxes.shape[1] == 1:
        boxes = boxes.expand(r, c, 4)
    boxes = clip_boxes(boxes, image_size)
    flat_scores = fg.reshape(-1)
    flat_boxes = boxes.reshape(-1, 4)
    flat_classes = torch.arange(c, dtype=torch.int32, device=scores.device).repeat(r)
    flat_valid = ((flat_scores > score_thresh)
                  & proposal_valid.repeat_interleave(c)
                  & nonempty_mask(flat_boxes))
    k = min(candidate_pool, flat_scores.shape[0])
    masked = torch.where(flat_valid, flat_scores, torch.full_like(flat_scores, -1.0))
    cand_scores, cand_idx = torch.sort(masked, descending=True, stable=True)
    cand_scores, cand_idx = cand_scores[:k], cand_idx[:k]
    cand_boxes = flat_boxes[cand_idx]
    cand_classes = flat_classes[cand_idx]
    ob, osc, oi, ov = batched_nms_padded(cand_boxes, cand_scores, cand_classes,
                                         nms_thresh, max_detections,
                                         valid=cand_scores > 0)
    return Detections(boxes=ob, scores=torch.where(ov, osc, torch.zeros_like(osc)),
                      classes=cand_classes[oi], valid=ov)
