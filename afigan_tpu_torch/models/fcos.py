"""FCOS (counterpart of ``afigan_tpu/models/fcos.py``): shared class and box
towers (3x3 conv + GN + ReLU) over p3-p7, a learnable scale per level on the
box regression, centerness on the box tower; per level the top
``pre_nms_topk`` class scores above the threshold, decoded to boxes, then
class-aware NMS across levels, all at fixed shapes.

Training (``FCOS.forward`` in training mode, given the padded GT): every
location is assigned the smallest valid GT box that holds it (inside the
centre-sampling radius of 1.5 strides) and whose largest l/t/r/b distance
lies in the level's size of interest (``fcos_targets``); the losses are the
sigmoid focal loss over the classes, the GIoU of the stride-scaled distances
weighted by the centerness target, and the centerness BCE, in float32, each
normalised by the positives (or, for GIoU, by the summed centerness
targets). The ``_TRAIN`` thresholds apply in training mode, the ``_TEST``
ones in eval mode.

State-dict keys follow AdelaiDet: ``backbone.*``,
``proposal_generator.fcos_head.{cls_tower,bbox_tower}.{3i}`` (conv) and
``.{3i+1}`` (GroupNorm; ``.{2i}`` convs without a norm),
``proposal_generator.fcos_head.{cls_logits,bbox_pred,ctrness}``,
``proposal_generator.fcos_head.scales.{level}.scale``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.boxes import clip_boxes
from ..ops.losses import bce_with_logits
from ..ops.nms import batched_nms_padded
from .box_head import Detections
from .layers import Conv2d, get_norm, init_weight
from .roi_heads import GroundTruth

INF = 1e8


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


def fcos_targets(locations, level_ranges, loc_strides, gt: GroundTruth,
                 center_sample: bool = True, pos_radius: float = 1.5):
    """``fcos_targets_single`` of the JAX package over a batch: locations (L,
    2) of all levels, their size-of-interest ranges (L, 2) and strides (L,),
    the padded GT (B, M, ...) → labels (B, L) (-1 background), the l/t/r/b
    distances to the matched box (B, L, 4) and its index (B, L). Where no box
    qualifies the index is 0 (``argmin``'s first on ties, as in JAX) and the
    distances are that box's: the losses mask them out."""
    xs, ys = locations[None, :, 0, None], locations[None, :, 1, None]  # (1, L, 1)
    boxes = gt.boxes[:, None]  # (B, 1, M, 4)
    x0, y0, x1, y1 = boxes.unbind(-1)
    areas = (x1 - x0) * (y1 - y0)
    reg = torch.stack([xs - x0, ys - y0, x1 - xs, y1 - ys], dim=-1)  # (B, L, M, 4)
    if center_sample:
        radius = pos_radius * loc_strides[None, :, None]
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        in_box = ((xs > torch.maximum(cx - radius, x0)) & (xs < torch.minimum(cx + radius, x1))
                  & (ys > torch.maximum(cy - radius, y0)) & (ys < torch.minimum(cy + radius, y1)))
    else:
        in_box = reg.amin(dim=-1) > 0
    max_reg = reg.amax(dim=-1)
    in_level = (max_reg >= level_ranges[None, :, 0, None]) & (
        max_reg <= level_ranges[None, :, 1, None])
    candidate = in_box & in_level & gt.valid[:, None]
    cand_areas = torch.where(candidate, areas, torch.full_like(areas, INF))
    best, matched = cand_areas.min(dim=-1)  # the first index among equals
    labels = torch.where(best < INF, torch.gather(gt.classes.long(), 1, matched),
                         torch.full_like(matched, -1))
    targets = torch.gather(reg, 2, matched[..., None, None].expand(*matched.shape, 1, 4))
    return labels, targets[:, :, 0], matched


def sigmoid_focal(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    """Elementwise sigmoid focal loss (``_sigmoid_focal``) with JAX's
    gradients at 0: ``jnp.maximum``'s tie splits it, ``jnp.abs`` takes +1."""
    p = torch.sigmoid(logits)
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * targets
          + torch.log1p(torch.exp(-torch.where(logits >= 0, logits, -logits))))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * (1 - p_t) ** gamma * ce


def giou_loss(pred, target):
    """1 - GIoU of l/t/r/b distances (N, 4) about one point (``_giou_loss``);
    finite for any target, a background location's too."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    zero = torch.zeros_like(pl)
    p_area = (pl + pr) * (pt + pb)
    t_area = (tl + tr) * (tt + tb)
    iw = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    ih = torch.minimum(pt, tt) + torch.minimum(pb, tb)
    inter = torch.maximum(iw, zero) * torch.maximum(ih, zero)
    union = p_area + t_area - inter
    iou = inter / torch.maximum(union, zero + 1e-7)
    cw = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    ch = torch.maximum(pt, tt) + torch.maximum(pb, tb)
    enclose = torch.maximum(cw * ch, zero + 1e-7)
    return 1.0 - (iou - (enclose - union) / enclose)


def fcos_losses(logits_l, regs_l, ctrs_l, locations_l, gt: GroundTruth, *,
                num_classes: int, fpn_strides: Sequence[int],
                sizes_of_interest: Sequence[float], center_sample: bool,
                pos_radius: float) -> Dict[str, torch.Tensor]:
    """``FCOS._losses``: {loss_fcos_cls, loss_fcos_loc, loss_fcos_ctr} in
    float32 from the head's per-level outputs; the regression in pixels (the
    distances times the level's stride)."""
    soi = [-1.0, *sizes_of_interest, INF]
    dev = logits_l[0].device
    locations = torch.cat(locations_l)
    level_ranges = torch.cat([torch.tensor([[soi[i], soi[i + 1]]], device=dev).expand(
        loc.shape[0], 2) for i, loc in enumerate(locations_l)])
    loc_strides = torch.cat([torch.full((loc.shape[0],), float(s), device=dev)
                             for s, loc in zip(fpn_strides, locations_l)])
    b = logits_l[0].shape[0]
    flat_logits = torch.cat([x.reshape(b, -1, num_classes) for x in logits_l], 1).float()
    flat_regs = torch.cat([r.reshape(b, -1, 4).float() * s
                           for r, s in zip(regs_l, fpn_strides)], 1)
    flat_ctrs = torch.cat([c.reshape(b, -1) for c in ctrs_l], 1).float()
    labels, reg_targets, _ = fcos_targets(locations, level_ranges, loc_strides, gt,
                                          center_sample, pos_radius)
    pos = labels >= 0
    num_pos = pos.float().sum().clamp(min=1.0)
    onehot = F.one_hot(labels.clamp(min=0), num_classes).float() * pos[..., None]
    cls_loss = sigmoid_focal(flat_logits, onehot).sum() / num_pos
    lr, tb = reg_targets[..., [0, 2]], reg_targets[..., [1, 3]]
    ctr_t = torch.sqrt(torch.clamp(
        lr.amin(-1) / lr.amax(-1).clamp(min=1e-7) * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-7)),
        min=0.0))
    zero = torch.zeros_like(ctr_t)
    ctr_norm = torch.where(pos, ctr_t, zero).sum().clamp(min=1e-6)
    giou = giou_loss(flat_regs.reshape(-1, 4), reg_targets.reshape(-1, 4)).reshape(pos.shape)
    reg_loss = torch.where(pos, giou * ctr_t, zero).sum() / ctr_norm
    ctr_loss = torch.where(pos, bce_with_logits(flat_ctrs, ctr_t), zero).sum() / num_pos
    return {"loss_fcos_cls": cls_loss, "loss_fcos_loc": reg_loss, "loss_fcos_ctr": ctr_loss}


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
                 sizes_of_interest: Sequence[float] = (64, 128, 256, 512),
                 num_convs: int = 4, norm: str = "GN", prior_prob: float = 0.01,
                 center_sample: bool = True, pos_radius: float = 1.5,
                 centerness_on_reg: bool = True, use_scale: bool = True,
                 thresh_with_ctr: bool = False, score_thresh: float = 0.05,
                 nms_thresh: float = 0.6, pre_nms_topk: int = 1000,
                 post_nms_topk: int = 100, score_thresh_train: float = 0.05,
                 pre_nms_topk_train: int = 1000, post_nms_topk_train: int = 100,
                 pixel_mean=(103.53, 116.28, 123.675), pixel_std=(1.0, 1.0, 1.0),
                 dtype=torch.float32, return_features: bool = False, device=None):
        super().__init__()
        self.backbone = backbone
        self.proposal_generator = ProposalGenerator(FCOSHead(
            in_channels, num_classes, num_convs, norm, prior_prob, centerness_on_reg,
            use_scale, len(in_features), device))
        self.in_features = tuple(in_features)
        self.return_features = return_features
        common = dict(num_classes=num_classes, fpn_strides=tuple(fpn_strides),
                      thresh_with_ctr=thresh_with_ctr, nms_thresh=nms_thresh)
        self.decode = dict(common, score_thresh=score_thresh, pre_nms_topk=pre_nms_topk,
                           post_nms_topk=post_nms_topk)
        self.decode_train = dict(common, score_thresh=score_thresh_train,
                                 pre_nms_topk=pre_nms_topk_train,
                                 post_nms_topk=post_nms_topk_train)
        self.loss_args = dict(num_classes=num_classes, fpn_strides=tuple(fpn_strides),
                              sizes_of_interest=tuple(sizes_of_interest),
                              center_sample=center_sample, pos_radius=pos_radius)
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, device=device),
                             persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        self.backbone.init_weights(gen)
        self.proposal_generator.fcos_head.init_weights(gen)

    def head(self, images):
        """→ (the backbone's feature dict, (per-level logits, box distances,
        centerness, locations))."""
        with record_function("backbone"):
            x = (images.float() - self.pixel_mean) / self.pixel_std
            features = self.backbone(x.to(self.dtype))
        feats = [features[f] for f in self.in_features]
        with record_function("fcos_head"):
            logits, regs, ctrs = self.proposal_generator.fcos_head(feats)
        locations = compute_locations([f.shape[1:3] for f in feats],
                                      self.decode["fpn_strides"], images.device)
        return features, (logits, regs, ctrs, locations)

    def decode_outputs(self, outputs, image_sizes, detach: bool = False) -> Detections:
        """The head's outputs → padded ``Detections``, at the ``_TRAIN``
        thresholds in training mode; ``detach``: on the outputs' values only."""
        *outs, locations = outputs
        if detach:
            outs = [[t.detach() for t in level] for level in outs]
        with record_function("fcos_decode"):
            return fcos_inference(*outs, locations, image_sizes,
                                  **(self.decode_train if self.training else self.decode))

    def detect(self, images, image_sizes):
        """→ (the backbone's feature dict, Detections)."""
        features, outputs = self.head(images)
        return features, self.decode_outputs(outputs, image_sizes)

    def losses(self, outputs, gt: GroundTruth) -> Dict[str, torch.Tensor]:
        with record_function("fcos_losses"):
            return fcos_losses(*outputs, gt, **self.loss_args)

    def forward(self, images, image_sizes, gt: Optional[GroundTruth] = None, draws=None):
        """images (B, H, W, 3) raw pixels, padded; image_sizes (B, 2) int → in
        eval mode (Detections with (B, D, ...) fields, None); in training
        mode, with ``gt``, the dict of losses, and with ``return_features``
        (stage 2) ``(losses, the backbone's features)``. ``draws`` (the
        subsample keys of the R-CNN models) is not used: FCOS samples
        nothing."""
        if not self.training:
            return self.detect(images, image_sizes)[1], None
        if gt is None:
            raise ValueError("a model in training mode needs the ground truth (gt=)")
        features, outputs = self.head(images)
        losses = self.losses(outputs, gt)
        return (losses, features) if self.return_features else losses
