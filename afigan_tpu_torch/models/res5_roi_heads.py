"""Res5 ROI heads (counterpart of ``afigan_tpu/models/res5_roi_heads.py``,
d2's C4 ``Res5ROIHeads``), NHWC.

A 14x14 pool of one feature (``ROI_HEADS.IN_FEATURES[0]``, stride 16)
through the ``fast`` pooler whatever ``TPU.POOLER_IMPL`` says, as in JAX (the
windowed forward: ``csrc/window_gather.cu`` on the card at inference; its
training route under autograd); the ResNet res5 stage inside the head (3
bottlenecks, the first of stride 2, 2048 out / 512 bottleneck); a global
average pool and the class / box predictors. The mask head (d2's C4
``MaskRCNNConvUpsampleHead`` with no conv: a 2x2/s2 deconv, ReLU and a 1x1
predictor) reads the same res5 output. d2 keys ``roi_heads.res5.{i}.*``,
``roi_heads.box_predictor.*``, ``roi_heads.mask_head.{deconv,predictor}.*``.

Training (``losses``): the standard heads' sampling, the box losses over the
sampled ROIs and the mask loss over all of them (the foreground ones count),
with no foreground compaction and no ``diag_fg_frac``, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import Box2BoxTransform
from ..ops.matcher import Matcher
from ..ops.roi_align import pool_rois
from .box_head import (Detections, FastRCNNOutputLayers, fast_rcnn_inference_single,
                       fast_rcnn_losses)
from .layers import Conv2d, init_weight
from .mask_head import MaskRCNNConvUpsampleHead, crop_and_resize_masks, mask_loss
from .resnet import BottleneckBlock
from .roi_heads import GroundTruth, _take, sample_proposals
from .rpn import RPNOutput


class Res5ROIHeads(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80, in_feature: str = "res4",
                 stride: int = 16, pooler_resolution: int = 14,
                 res5_out_channels: int = 2048, res5_bottleneck_channels: int = 512,
                 norm: str = "FrozenBN", num_res5_blocks: int = 3, stride_in_1x1: bool = True,
                 mask_on: bool = False, batch_size_per_image: int = 512,
                 positive_fraction: float = 0.25, iou_threshold: float = 0.5,
                 append_gt: bool = True,
                 bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
                 smooth_l1_beta: float = 0.0, score_thresh: float = 0.05,
                 nms_thresh: float = 0.5, detections_per_image: int = 100, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.in_feature = in_feature
        self.stride = stride
        self.res = pooler_resolution
        self.mask_on = mask_on
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.matcher = Matcher([iou_threshold], [0, 1])
        self.append_gt = append_gt
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.smooth_l1_beta = smooth_l1_beta
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image
        self.res5 = nn.Sequential(*(
            BottleneckBlock(in_channels if i == 0 else res5_out_channels, res5_out_channels,
                            res5_bottleneck_channels, 2 if i == 0 else 1, norm, stride_in_1x1,
                            device=device)
            for i in range(num_res5_blocks)))
        self.box_predictor = FastRCNNOutputLayers(res5_out_channels, num_classes, device=device)
        if mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(res5_out_channels, num_classes, 0, 256,
                                                      device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.res5.modules():
            if isinstance(m, Conv2d):
                init_weight(m.weight, "msra", gen)
        self.box_predictor.init_weights(gen)
        if self.mask_on:
            self.mask_head.init_weights(gen)

    def _shared(self, features: Dict[str, torch.Tensor], boxes):
        """(B, R, 4) boxes → the res5 output (B*R, P/2, P/2, 2048) in the
        features' dtype."""
        feature = features[self.in_feature]
        pooled = pool_rois("fast", [feature], boxes, (self.stride,), self.res, 2, True)
        return self.res5(pooled.reshape(-1, *pooled.shape[2:]).to(feature.dtype))

    def _mask_probs(self, x, dets: Detections):
        logits = self.mask_head(x)
        b, d = dets.scores.shape
        s = logits.shape[1]
        cls = torch.clamp(dets.classes.long(), 0, self.num_classes - 1)
        idx = cls[:, :, None, None, None].expand(b, d, s, s, 1)
        sel = torch.gather(logits.reshape(b, d, s, s, -1), -1, idx)[..., 0]
        return torch.sigmoid(sel.float())  # (B, D, S, S)

    def forward(self, features: Dict[str, torch.Tensor], proposals: Optional[RPNOutput],
                image_sizes, given_dets: Optional[Detections] = None
                ) -> Tuple[Detections, Optional[torch.Tensor]]:
        """→ (Detections of (B, D, ...) tensors, masks (B, D, 2P', 2P') or
        None). With ``given_dets`` only the mask branch runs, on those boxes."""
        if given_dets is not None:
            masks = (self._mask_probs(self._shared(features, given_dets.boxes), given_dets)
                     if self.mask_on else None)
            return given_dets, masks
        b, k = proposals.scores.shape
        x = self._shared(features, proposals.proposals)
        logits, deltas = self.box_predictor(x.mean(dim=(1, 2)))
        probs = torch.softmax(logits.float(), dim=-1).reshape(b, k, -1)
        boxes = self.box2box.apply_deltas(deltas.float().reshape(b, k, -1),
                                          proposals.proposals).reshape(b, k, -1, 4)
        per_image = [
            fast_rcnn_inference_single(boxes[i], probs[i], image_sizes[i],
                                       proposals.valid[i], self.score_thresh,
                                       self.nms_thresh, self.detections_per_image)
            for i in range(b)]
        dets = Detections(*(torch.stack([getattr(d, f) for d in per_image])
                            for f in ("boxes", "scores", "classes", "valid")))
        masks = (self._mask_probs(self._shared(features, dets.boxes), dets)
                 if self.mask_on else None)
        return dets, masks

    def losses(self, features: Dict[str, torch.Tensor], proposals: RPNOutput, image_sizes,
               gt: GroundTruth, draws=None) -> Dict[str, torch.Tensor]:
        """{loss_cls, loss_box_reg[, loss_mask]}. ``draws``: the subsample's
        key source (``ops/sampling.py::draw``)."""
        sampled = sample_proposals(
            proposals.proposals.detach(), proposals.valid, gt, self.batch_size_per_image,
            self.positive_fraction, self.matcher, self.num_classes, self.append_gt, draws)
        b, s = sampled.gt_classes.shape
        x = self._shared(features, sampled.boxes)
        logits, deltas = self.box_predictor(x.mean(dim=(1, 2)))
        gt_deltas = self.box2box.get_deltas(sampled.boxes, _take(gt.boxes, sampled.gt_idx))
        losses = fast_rcnn_losses(logits, deltas, sampled.gt_classes.reshape(-1),
                                  gt_deltas.reshape(-1, 4), sampled.valid.reshape(-1),
                                  self.num_classes, self.smooth_l1_beta)
        if self.mask_on:
            fg = sampled.valid & (sampled.gt_classes < self.num_classes)
            mask_logits = self.mask_head(x)
            size = mask_logits.shape[1]
            targets = crop_and_resize_masks(gt.masks, gt.boxes, sampled.boxes, sampled.gt_idx,
                                            size)
            losses["loss_mask"] = mask_loss(mask_logits, targets.reshape(b * s, size, size),
                                            sampled.gt_classes.reshape(-1), fg.reshape(-1),
                                            self.num_classes)
        return losses
