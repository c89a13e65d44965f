"""FCOS, inference (counterpart of ``afigan_tpu/models/fcos.py``): shared
class and box towers (3x3 conv + GN + ReLU) over p3-p7, a learnable scale per
level on the box regression, centerness on the box tower; per level the top
``pre_nms_topk`` class scores above the threshold, decoded to boxes, then
class-aware NMS across levels, all at fixed shapes. Targets and losses are
not ported (eval only).

State-dict keys follow AdelaiDet: ``backbone.*``,
``proposal_generator.fcos_head.{cls_tower,bbox_tower}.{3i}`` (conv) and
``.{3i+1}`` (GroupNorm; ``.{2i}`` convs without a norm),
``proposal_generator.fcos_head.{cls_logits,bbox_pred,ctrness}``,
``proposal_generator.fcos_head.scales.{level}.scale``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..ops.boxes import clip_boxes
from ..ops.nms import batched_nms_padded
from .box_head import Detections
from .layers import Conv2d, get_norm, init_weight


class Scale(nn.Module):
    def __init__(self, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones((), device=device))

    def forward(self, x):
        return x * self.scale.to(x.dtype)


class FCOSHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80, num_convs: int = 4,
                 norm: str = "GN", prior_prob: float = 0.01,
                 centerness_on_reg: bool = True, use_scale: bool = True,
                 num_levels: int = 5, device=None):
        super().__init__()
        self.prior_prob = prior_prob
        self.centerness_on_reg = centerness_on_reg

        def tower():
            mods = []
            for _ in range(num_convs):
                mods.append(Conv2d(in_channels, in_channels, 3, padding=1, device=device))
                n = get_norm(norm, in_channels)
                if n is not None:
                    mods.append(n.to(device))
                mods.append(nn.ReLU())
            return nn.Sequential(*mods)

        self.cls_tower = tower()
        self.bbox_tower = tower()
        self.cls_logits = Conv2d(in_channels, num_classes, 3, padding=1, device=device)
        self.bbox_pred = Conv2d(in_channels, 4, 3, padding=1, device=device)
        self.ctrness = Conv2d(in_channels, 1, 3, padding=1, device=device)
        self.scales = nn.ModuleList(Scale(device) for _ in range(num_levels)) \
            if use_scale else None

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_weight(m.weight, "normal0.01", gen)
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.cls_logits.bias,
                          -math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, features: Sequence[torch.Tensor]):
        """per-level (B, H, W, C) → lists of class logits (B, H, W, classes),
        non-negative box distances (B, H, W, 4) and centerness (B, H, W, 1)."""
        logits, regs, ctrs = [], [], []
        for lvl, f in enumerate(features):
            c = self.cls_tower(f)
            b = self.bbox_tower(f)
            logits.append(self.cls_logits(c))
            reg = self.bbox_pred(b)
            if self.scales is not None:
                reg = self.scales[lvl](reg)
            regs.append(torch.relu(reg))
            ctrs.append(self.ctrness(b if self.centerness_on_reg else c))
        return logits, regs, ctrs


def compute_locations(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                      device=None) -> List[torch.Tensor]:
    """Per level (H*W, 2) locations (x, y) = index * stride + stride // 2,
    rows first."""
    out = []
    for (h, w), s in zip(shapes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        ys = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1))
    return out


def fcos_inference(logits_l, regs_l, ctrs_l, locations_l, image_sizes, *,
                   num_classes: int, fpn_strides: Sequence[int],
                   thresh_with_ctr: bool, score_thresh: float, pre_nms_topk: int,
                   nms_thresh: float, post_nms_topk: int) -> Detections:
    """Head outputs (NHWC, per level) → padded ``Detections`` of (B, D, ...)."""
    b = logits_l[0].shape[0]
    cand = []
    for logit, reg, ctr, loc, stride in zip(logits_l, regs_l, ctrs_l, locations_l,
                                            fpn_strides):
        scores = torch.sigmoid(logit.reshape(b, -1, num_classes).float())
        ctrness = torch.sigmoid(ctr.reshape(b, -1, 1).float())
        if thresh_with_ctr:
            scores = scores * ctrness
        # the threshold reads ``scores``, the ranking score * centerness
        flat = (scores if thresh_with_ctr else scores * ctrness).reshape(b, -1)
        flat = torch.where(scores.reshape(b, -1) > score_thresh, flat,
                           torch.zeros_like(flat))
        k = min(pre_nms_topk, flat.shape[1])
        # a stable sort takes the lowest index first among equal scores, as
        # ``lax.top_k`` does; ``torch.topk`` promises no order
        top_scores, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        loc_idx = top_idx // num_classes
        reg_flat = reg.reshape(b, -1, 4).float() * stride
        sel_reg = torch.gather(reg_flat, 1, loc_idx[:, :, None].expand(b, k, 4))
        sel_loc = loc[loc_idx]
        boxes = torch.stack([sel_loc[..., 0] - sel_reg[..., 0],
                             sel_loc[..., 1] - sel_reg[..., 1],
                             sel_loc[..., 0] + sel_reg[..., 2],
                             sel_loc[..., 1] + sel_reg[..., 3]], dim=-1)
        cand.append((boxes, top_scores, (top_idx % num_classes).to(torch.int32),
                     top_scores > 0))
    boxes, scores, classes, valid = (torch.cat(t, dim=1) for t in zip(*cand))

    per_image = []
    for i in range(b):
        bx = clip_boxes(boxes[i], image_sizes[i])
        ob, osc, oi, ov = batched_nms_padded(bx, scores[i], classes[i], nms_thresh,
                                             post_nms_topk, valid=valid[i])
        per_image.append((ob, torch.where(ov, osc, torch.zeros_like(osc)),
                          classes[i][oi], ov))
    return Detections(*(torch.stack(t) for t in zip(*per_image)))


class ProposalGenerator(nn.Module):
    """Holds ``fcos_head`` so keys read ``proposal_generator.fcos_head.*``."""

    def __init__(self, fcos_head: FCOSHead):
        super().__init__()
        self.fcos_head = fcos_head


class FCOS(nn.Module):
    def __init__(self, backbone: nn.Module, in_channels: int, num_classes: int = 80,
                 in_features: Sequence[str] = ("p3", "p4", "p5", "p6", "p7"),
                 fpn_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 num_convs: int = 4, norm: str = "GN", prior_prob: float = 0.01,
                 centerness_on_reg: bool = True, use_scale: bool = True,
                 thresh_with_ctr: bool = False, score_thresh: float = 0.05,
                 nms_thresh: float = 0.6, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 100, pixel_mean=(103.53, 116.28, 123.675),
                 pixel_std=(1.0, 1.0, 1.0), dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = backbone
        self.proposal_generator = ProposalGenerator(FCOSHead(
            in_channels, num_classes, num_convs, norm, prior_prob, centerness_on_reg,
            use_scale, len(in_features), device))
        self.in_features = tuple(in_features)
        self.decode = dict(num_classes=num_classes, fpn_strides=tuple(fpn_strides),
                           thresh_with_ctr=thresh_with_ctr, score_thresh=score_thresh,
                           pre_nms_topk=pre_nms_topk, nms_thresh=nms_thresh,
                           post_nms_topk=post_nms_topk)
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, device=device),
                             persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        self.backbone.init_weights(gen)
        self.proposal_generator.fcos_head.init_weights(gen)

    def detect(self, images, image_sizes):
        """→ (the backbone's feature dict, Detections)."""
        with record_function("backbone"):
            x = (images.float() - self.pixel_mean) / self.pixel_std
            features = self.backbone(x.to(self.dtype))
        feats = [features[f] for f in self.in_features]
        with record_function("fcos_head"):
            logits, regs, ctrs = self.proposal_generator.fcos_head(feats)
        with record_function("fcos_decode"):
            locations = compute_locations([f.shape[1:3] for f in feats],
                                          self.decode["fpn_strides"], images.device)
            dets = fcos_inference(logits, regs, ctrs, locations, image_sizes,
                                  **self.decode)
        return features, dets

    def forward(self, images, image_sizes):
        """images (B, H, W, 3) raw pixels, padded; image_sizes (B, 2) int →
        (Detections with (B, D, ...) fields, None)."""
        return self.detect(images, image_sizes)[1], None
