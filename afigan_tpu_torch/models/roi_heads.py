"""Standard ROI heads, inference branch (counterpart of
``afigan_tpu/models/roi_heads.py::StandardROIHeads``): multi-level ROI
pooling (``ops/roi_align.py::pool_rois`` by ``TPU.POOLER_IMPL``; CUDA kernels
on the card), the
Fast R-CNN box branch with fixed-shape per-image detection, and the mask
branch on the detected boxes."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import Box2BoxTransform
from ..ops.roi_align import POOLER_IMPLS, pool_rois
from .box_head import (Detections, FastRCNNConvFCHead, FastRCNNOutputLayers,
                       fast_rcnn_inference_single)
from .mask_head import MaskRCNNConvUpsampleHead
from .rpn import RPNOutput


class StandardROIHeads(nn.Module):
    def __init__(self, in_channels: int, num_classes: int = 80,
                 in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 strides: Sequence[int] = (4, 8, 16, 32),
                 box_pooler_resolution: int = 7, box_num_conv: int = 0,
                 box_conv_dim: int = 256, box_num_fc: int = 2,
                 box_fc_dim: int = 1024, box_norm: str = "",
                 bbox_reg_weights: Tuple[float, ...] = (10.0, 10.0, 5.0, 5.0),
                 cls_agnostic_bbox_reg: bool = False, mask_on: bool = False,
                 mask_pooler_resolution: int = 14, mask_num_conv: int = 4,
                 mask_conv_dim: int = 256, cls_agnostic_mask: bool = False,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5,
                 detections_per_image: int = 100, sampling_ratio: int = 2,
                 aligned: bool = True, pooler_impl: str = "pallas", device=None):
        super().__init__()
        if pooler_impl not in POOLER_IMPLS:
            raise ValueError(f"TPU.POOLER_IMPL {pooler_impl!r}: one of {POOLER_IMPLS}")
        self.pooler_impl = pooler_impl
        self.num_classes = num_classes
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.box_res = box_pooler_resolution
        self.mask_res = mask_pooler_resolution
        self.box2box = Box2BoxTransform(bbox_reg_weights)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_image = detections_per_image
        self.sampling_ratio = sampling_ratio
        self.aligned = aligned
        self.mask_on = mask_on
        self._build_box_heads(
            lambda: FastRCNNConvFCHead(in_channels, box_pooler_resolution, box_num_conv,
                                       box_conv_dim, box_num_fc, box_fc_dim, box_norm,
                                       device),
            lambda dim, agnostic=cls_agnostic_bbox_reg: FastRCNNOutputLayers(
                dim, num_classes, agnostic, device))
        if mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, num_classes, mask_num_conv, mask_conv_dim,
                cls_agnostic_mask, device)

    def _build_box_heads(self, make_head, make_predictor) -> None:
        self.box_head = make_head()
        self.box_predictor = make_predictor(self.box_head.out_dim)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (FastRCNNConvFCHead, FastRCNNOutputLayers)):
                m.init_weights(gen)
        if self.mask_on:
            self.mask_head.init_weights(gen)

    def _pool(self, features, boxes, resolution):
        """features dict of (B,H,W,C); boxes (B,R,4) → (B*R, P, P, C) in
        the features' dtype (the heads' compute dtype)."""
        feats = [features[f] for f in self.in_features]
        pooled = pool_rois(self.pooler_impl, feats, boxes, self.strides, resolution,
                           self.sampling_ratio, self.aligned)
        return pooled.reshape(-1, *pooled.shape[2:]).to(feats[0].dtype)

    def forward(self, features: Dict[str, torch.Tensor], proposals: RPNOutput,
                image_sizes) -> Tuple[Detections, torch.Tensor]:
        b, k = proposals.scores.shape
        flat = self._pool(features, proposals.proposals, self.box_res)
        logits, deltas = self.box_predictor(self.box_head(flat))
        probs = torch.softmax(logits.float(), dim=-1).reshape(b, k, -1)
        deltas = deltas.float().reshape(b, k, -1)
        boxes = self.box2box.apply_deltas(deltas, proposals.proposals)
        boxes = boxes.reshape(b, k, -1, 4)
        per_image = [
            fast_rcnn_inference_single(boxes[i], probs[i], image_sizes[i],
                                       proposals.valid[i], self.score_thresh,
                                       self.nms_thresh, self.detections_per_image)
            for i in range(b)]
        dets = Detections(*(torch.stack([getattr(d, f) for d in per_image])
                            for f in ("boxes", "scores", "classes", "valid")))
        masks = self._mask_branch(features, dets) if self.mask_on else None
        return dets, masks

    def _mask_branch(self, features, dets: Detections):
        b, d = dets.scores.shape
        flat = self._pool(features, dets.boxes, self.mask_res)
        logits = self.mask_head(flat)
        s = logits.shape[1]
        logits = logits.reshape(b, d, s, s, -1)
        if logits.shape[-1] == 1:
            sel = logits[..., 0]
        else:
            cls = torch.clamp(dets.classes.long(), 0, self.num_classes - 1)
            idx = cls[:, :, None, None, None].expand(b, d, s, s, 1)
            sel = torch.gather(logits, -1, idx)[..., 0]
        return torch.sigmoid(sel.float())  # (B, D, S, S)
