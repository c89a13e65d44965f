"""GeneralizedRCNN (counterpart of
``afigan_tpu/models/meta_arch.py::GeneralizedRCNN``): in-model pixel
normalisation of padded raw-pixel NHWC batches → backbone → RPN → ROI
heads. d2 key prefixes: ``backbone.``, ``proposal_generator.rpn_head.``,
``roi_heads.``.

In training mode, given the padded ground truth, the forward returns the
losses (RPN, box, mask, and the ``diag_fg_frac`` monitor; a cascade's
per stage, ``loss_{cls,box_reg}_stage{k}`` and ``diag_fg_frac_stage{k}``); the RPN's
pre/post-NMS top-k are the ``_TRAIN`` values then and the ``_TEST`` values in
eval mode. ``draws`` is the source of the two subsamples' uniform keys
(``ops/sampling.py::draw``). With ``return_features`` (the
``GeneralizedRCNN_AFExtractor`` of stage 2) the forward returns its result and
the backbone's features, ``(losses, features)``.

``RCNN_FPN_only`` is the frozen guide of stages 1-2: pixel normalisation and
the backbone, giving the pyramid ``{"p2": ..., "p6": ...}``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..ops.anchors import AnchorGenerator
from ..ops.boxes import Box2BoxTransform
from ..ops.matcher import Matcher
from .roi_heads import GroundTruth
from .rpn import RPNHead, generate_proposals, label_anchors, rpn_losses


class ProposalGenerator(nn.Module):
    """Holds ``rpn_head`` so keys read ``proposal_generator.rpn_head.*``."""

    def __init__(self, rpn_head: RPNHead):
        super().__init__()
        self.rpn_head = rpn_head


class GeneralizedRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, roi_heads: nn.Module,
                 rpn_in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6"),
                 rpn_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
                 anchor_aspect_ratios=((0.5, 1.0, 2.0),),
                 anchor_offset: float = 0.0, rpn_channels: int = 256,
                 rpn_bbox_reg_weights=(1.0, 1.0, 1.0, 1.0),
                 pre_nms_topk: int = 1000, post_nms_topk: int = 1000,
                 rpn_nms_thresh: float = 0.7, rpn_min_size: float = 0.0,
                 pre_nms_topk_train: int = 2000, post_nms_topk_train: int = 1000,
                 rpn_iou_thresholds=(0.3, 0.7), rpn_batch_size_per_image: int = 256,
                 rpn_positive_fraction: float = 0.5, rpn_smooth_l1_beta: float = 0.0,
                 rpn_loss_weight: float = 1.0,
                 pixel_mean=(103.53, 116.28, 123.675),
                 pixel_std=(1.0, 1.0, 1.0), dtype=torch.float32,
                 return_features: bool = False, device=None):
        super().__init__()
        self.backbone = backbone
        self.return_features = return_features
        self.anchor_generator = AnchorGenerator(
            [list(s) for s in anchor_sizes],
            [list(a) for a in anchor_aspect_ratios], list(rpn_strides),
            anchor_offset)
        self.proposal_generator = ProposalGenerator(RPNHead(
            rpn_channels, self.anchor_generator.num_anchors_per_location[0],
            device=device))
        self.roi_heads = roi_heads
        self.rpn_in_features = tuple(rpn_in_features)
        self.rpn_box2box = Box2BoxTransform(rpn_bbox_reg_weights)
        self.pre_nms_topk = pre_nms_topk
        self.post_nms_topk = post_nms_topk
        self.pre_nms_topk_train = pre_nms_topk_train
        self.post_nms_topk_train = post_nms_topk_train
        self.rpn_matcher = Matcher(list(rpn_iou_thresholds), [0, -1, 1],
                                   allow_low_quality_matches=True)
        self.rpn_batch_size_per_image = rpn_batch_size_per_image
        self.rpn_positive_fraction = rpn_positive_fraction
        self.rpn_smooth_l1_beta = rpn_smooth_l1_beta
        self.rpn_loss_weight = rpn_loss_weight
        self.rpn_nms_thresh = rpn_nms_thresh
        self.rpn_min_size = rpn_min_size
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, device=device),
                             persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        self.backbone.init_weights(gen)
        self.proposal_generator.rpn_head.init_weights(gen)
        self.roi_heads.init_weights(gen)

    def forward(self, images, image_sizes, gt: Optional[GroundTruth] = None, draws=None,
                given_dets=None):
        """images (B, H, W, 3) raw pixels, padded; image_sizes (B, 2) int →
        in eval mode (Detections with (B, D, ...) fields, masks (B, D, S, S)
        or None); in training mode, with ``gt``, the dict of losses. With
        ``given_dets`` (eval mode; test-time augmentation's mask fusion) the
        backbone and only the mask branch run on those boxes: ``(given_dets,
        masks or None)``. The JAX model also runs its RPN there and drops the
        proposals; the port skips it."""
        if self.training and (gt is None or given_dets is not None):
            raise ValueError("a model in training mode needs the ground truth (gt=) and "
                             "takes no given_dets")
        # record_function ranges name the layers in a torch.profiler trace
        with record_function("backbone"):
            x = (images.float() - self.pixel_mean) / self.pixel_std
            features = self.backbone(x.to(self.dtype))
        if given_dets is not None:
            with record_function("roi_heads"):
                out = self.roi_heads(features, None, image_sizes, given_dets=given_dets)
            return (out, features) if self.return_features else out
        with record_function("rpn"):
            rpn_feats = [features[f] for f in self.rpn_in_features]
            anchors = self.anchor_generator([f.shape[1:3] for f in rpn_feats],
                                            device=images.device)
            logits, deltas = self.proposal_generator.rpn_head(rpn_feats)
            train = self.training
            proposals = generate_proposals(
                anchors, logits, deltas, image_sizes, self.rpn_box2box,
                self.pre_nms_topk_train if train else self.pre_nms_topk,
                self.post_nms_topk_train if train else self.post_nms_topk,
                self.rpn_nms_thresh, self.rpn_min_size)
            if train:
                losses = self._rpn_losses(anchors, logits, deltas, gt, draws)
        with record_function("roi_heads"):
            if train:
                losses.update(self.roi_heads.losses(features, proposals, image_sizes, gt,
                                                    draws))
                out = losses
            else:
                out = self.roi_heads(features, proposals, image_sizes)
        return (out, features) if self.return_features else out

    def _rpn_losses(self, anchors, logits, deltas, gt: GroundTruth, draws):
        b = logits[0].shape[0]
        anchors = torch.cat(anchors, dim=0)
        flat_logits = torch.cat([lg.reshape(b, -1) for lg in logits], dim=1)
        flat_deltas = torch.cat([d.reshape(b, -1, 4) for d in deltas], dim=1)
        labels, matched = label_anchors(
            anchors, gt.boxes, gt.valid, self.rpn_batch_size_per_image,
            self.rpn_positive_fraction, self.rpn_matcher, draws)
        losses = rpn_losses(labels, matched, gt.boxes, anchors, flat_logits, flat_deltas,
                            self.rpn_box2box, self.rpn_batch_size_per_image,
                            self.rpn_smooth_l1_beta)
        return {k: v * self.rpn_loss_weight for k, v in losses.items()}


class RCNN_FPN_only(nn.Module):
    """The backbone alone (ref rcnn_only.py): raw-pixel NHWC images →
    normalised → pyramid features."""

    def __init__(self, backbone: nn.Module, pixel_mean=(103.53, 116.28, 123.675),
                 pixel_std=(1.0, 1.0, 1.0), dtype=torch.float32, device=None):
        super().__init__()
        self.backbone = backbone
        self.dtype = dtype
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, device=device),
                             persistent=False)

    def init_weights(self, gen: torch.Generator) -> None:
        self.backbone.init_weights(gen)

    def forward(self, images):
        x = (images.float() - self.pixel_mean) / self.pixel_std
        return self.backbone(x.to(self.dtype))
