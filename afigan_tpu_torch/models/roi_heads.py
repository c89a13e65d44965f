"""Standard ROI heads (counterpart of
``afigan_tpu/models/roi_heads.py::StandardROIHeads``): multi-level ROI
pooling (``ops/roi_align.py::pool_rois`` by ``TPU.POOLER_IMPL``; CUDA kernels
on the card, forward and backward), the Fast R-CNN box branch with
fixed-shape per-image detection, and the mask branch on the detected boxes
(or, for test-time augmentation, on boxes the caller gives).

Training (``losses``): proposals matched to the padded GT (Matcher 0.5) and
subsampled to ``batch_size_per_image`` per image at ``positive_fraction``
(the GT boxes appended first), the box losses over the sampled ROIs, and the
mask loss over a fixed capacity of foreground ROIs. Everything has a fixed
shape, as in JAX; the proposals are detached (``stop_gradient`` there).

With ``keypoint_on`` (``MODEL.KEYPOINT_ON``) the keypoint branch
(``models/keypoint_head.py``) pools with its own sampling ratio and
alignment: in training over the same foreground capacity as the mask branch
(``loss_keypoint``), at inference on the detected boxes (the detections'
``keypoints``, (B, D, K, 3)). Test-time augmentation runs no keypoint branch."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.boxes import Box2BoxTransform, pairwise_iou
from ..ops.matcher import Matcher
from ..ops.roi_align import POOLER_IMPLS, pool_rois
from ..ops.sampling import subsample_labels
from .box_head import (Detections, FastRCNNConvFCHead, FastRCNNOutputLayers,
                       fast_rcnn_inference_single, fast_rcnn_losses)
from .keypoint_head import (KRCNNConvDeconvUpsampleHead, heatmaps_to_keypoints,
                            keypoint_rcnn_loss)
from .mask_head import MaskRCNNConvUpsampleHead, crop_and_resize_masks, mask_loss
from .rpn import RPNOutput


class GroundTruth(NamedTuple):
    """Padded per-image GT: boxes (B, M, 4) xyxy, classes (B, M) in [0, C),
    valid (B, M) bool, masks (B, M, MH, MW) float canvases or None,
    keypoints (B, M, K, 3) [x, y, visibility] or None."""

    boxes: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    masks: Optional[torch.Tensor] = None
    keypoints: Optional[torch.Tensor] = None


class SampledProposals(NamedTuple):
    boxes: torch.Tensor       # (B, S, 4)
    gt_classes: torch.Tensor  # (B, S) in [0, C], C = background
    gt_idx: torch.Tensor      # (B, S) matched GT row
    valid: torch.Tensor       # (B, S)


def _take(x, idx):
    """x (B, N, ...) at idx (B, K) along dim 1."""
    return torch.gather(x, 1, idx.view(*idx.shape, *([1] * (x.dim() - 2))).expand(
        *idx.shape, *x.shape[2:]))


def sample_proposals(prop_boxes, prop_valid, gt: GroundTruth, num_samples: int,
                     positive_fraction: float, matcher: Matcher, num_classes: int,
                     append_gt: bool = True, draws=None) -> SampledProposals:
    """d2 label_and_sample_proposals at fixed shapes, batched over images
    (``sample_proposals_single`` of the JAX package, image by image):
    prop_boxes (B, K, 4), prop_valid (B, K) → ``num_samples`` ROIs an image.
    ``draws``: the subsample's uniform keys, (B, K + M) each with the GT
    appended, or their source (``ops/sampling.py::draw``)."""
    if append_gt:
        prop_boxes = torch.cat([prop_boxes, gt.boxes], dim=1)
        prop_valid = torch.cat([prop_valid, gt.valid], dim=1)
    matched_idx, match_labels = matcher(pairwise_iou(gt.boxes, prop_boxes), gt.valid)
    bg = torch.full_like(matched_idx, num_classes)
    gt_classes = torch.where(match_labels == 1,
                             torch.gather(gt.classes.long(), 1, matched_idx), bg)
    # invalid proposals are never sampled
    labels = torch.where(prop_valid, match_labels.long(), torch.full_like(matched_idx, -1))
    idx, valid = subsample_labels(labels, num_samples, positive_fraction, 0, draws)
    return SampledProposals(
        boxes=_take(prop_boxes, idx),
        gt_classes=torch.where(valid, torch.gather(gt_classes, 1, idx),
                               torch.full_like(idx, num_classes)),
        gt_idx=torch.gather(matched_idx, 1, idx), valid=valid)


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
                 mask_conv_dim: int = 256, mask_norm: str = "",
                 cls_agnostic_mask: bool = False, keypoint_on: bool = False,
                 keypoint_pooler_resolution: int = 14,
                 keypoint_conv_dims: Sequence[int] = (512,) * 8, num_keypoints: int = 17,
                 keypoint_loss_weight: float = 1.0,
                 keypoint_normalize_by_visible: bool = True,
                 keypoint_sampling_ratio: int = 2, keypoint_aligned: bool = True,
                 score_thresh: float = 0.05, nms_thresh: float = 0.5,
                 detections_per_image: int = 100, sampling_ratio: int = 2,
                 aligned: bool = True, pooler_impl: str = "pallas",
                 batch_size_per_image: int = 512, positive_fraction: float = 0.25,
                 iou_threshold: float = 0.5, append_gt: bool = True,
                 smooth_l1_beta: float = 0.0, device=None):
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
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.matcher = Matcher([iou_threshold], [0, 1])
        self.append_gt = append_gt
        self.smooth_l1_beta = smooth_l1_beta
        self._build_box_heads(
            lambda: FastRCNNConvFCHead(in_channels, box_pooler_resolution, box_num_conv,
                                       box_conv_dim, box_num_fc, box_fc_dim, box_norm,
                                       device),
            lambda dim, agnostic=cls_agnostic_bbox_reg: FastRCNNOutputLayers(
                dim, num_classes, agnostic, device))
        if mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(
                in_channels, num_classes, mask_num_conv, mask_conv_dim,
                cls_agnostic_mask, mask_norm, device)
        self.keypoint_on = keypoint_on
        self.keypoint_res = keypoint_pooler_resolution
        self.num_keypoints = num_keypoints
        self.keypoint_loss_weight = keypoint_loss_weight
        self.keypoint_normalize_by_visible = keypoint_normalize_by_visible
        self.keypoint_sampling_ratio = keypoint_sampling_ratio
        self.keypoint_aligned = keypoint_aligned
        if keypoint_on:
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(
                in_channels, num_keypoints, tuple(keypoint_conv_dims), device)

    def _build_box_heads(self, make_head, make_predictor) -> None:
        self.box_head = make_head()
        self.box_predictor = make_predictor(self.box_head.out_dim)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (FastRCNNConvFCHead, FastRCNNOutputLayers)):
                m.init_weights(gen)
        if self.mask_on:
            self.mask_head.init_weights(gen)
        if self.keypoint_on:
            self.keypoint_head.init_weights(gen)

    def _pool(self, features, boxes, resolution, sampling_ratio=None, aligned=None):
        """features dict of (B,H,W,C); boxes (B,R,4) → (B*R, P, P, C) in
        the features' dtype (the heads' compute dtype). ``sampling_ratio`` /
        ``aligned``: a branch's own (default the box branch's)."""
        feats = [features[f] for f in self.in_features]
        pooled = pool_rois(self.pooler_impl, feats, boxes, self.strides, resolution,
                           self.sampling_ratio if sampling_ratio is None else sampling_ratio,
                           self.aligned if aligned is None else aligned)
        return pooled.reshape(-1, *pooled.shape[2:]).to(feats[0].dtype)

    def forward(self, features: Dict[str, torch.Tensor], proposals: Optional[RPNOutput],
                image_sizes, given_dets: Optional[Detections] = None
                ) -> Tuple[Detections, Optional[torch.Tensor]]:
        """→ (Detections of (B, D, ...) tensors, with keypoints (B, D, K, 3)
        under ``keypoint_on``; masks (B, D, S, S) or None). With
        ``given_dets`` (test-time augmentation) only the mask branch runs, on
        those boxes, and they come back as they were given."""
        if given_dets is not None:
            return given_dets, self._mask_branch(features, given_dets) if self.mask_on else None
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
        return self._mask_and_keypoint_branches(features, dets)

    def _mask_and_keypoint_branches(self, features, dets: Detections):
        """The mask and keypoint branches on the detections: (dets with their
        keypoints under ``keypoint_on``, masks or None)."""
        masks = self._mask_branch(features, dets) if self.mask_on else None
        if self.keypoint_on:
            dets = dets._replace(keypoints=self._keypoint_branch_infer(features, dets))
        return dets, masks

    def _keypoint_branch_infer(self, features, dets: Detections):
        b, d = dets.scores.shape
        flat = self._pool(features, dets.boxes, self.keypoint_res,
                          self.keypoint_sampling_ratio, self.keypoint_aligned)
        kp = heatmaps_to_keypoints(self.keypoint_head(flat), dets.boxes.reshape(b * d, 4))
        return kp.reshape(b, d, self.num_keypoints, 3)

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

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def losses(self, features: Dict[str, torch.Tensor], proposals: RPNOutput,
               image_sizes, gt: GroundTruth, draws=None) -> Dict[str, torch.Tensor]:
        """{loss_cls, loss_box_reg[, loss_mask][, loss_keypoint], diag_fg_frac}: the last a
        monitor (the sampled foreground fraction), left out of the total.
        ``image_sizes`` is not read here (a cascade clips its stages' boxes to
        them). ``draws``: the subsample's key source (``ops/sampling.py::draw``)."""
        sampled = sample_proposals(
            proposals.proposals.detach(), proposals.valid, gt, self.batch_size_per_image,
            self.positive_fraction, self.matcher, self.num_classes, self.append_gt, draws)
        b, s = sampled.gt_classes.shape
        flat = self._pool(features, sampled.boxes, self.box_res)
        logits, deltas = self.box_predictor(self.box_head(flat))
        gt_deltas = self.box2box.get_deltas(sampled.boxes, _take(gt.boxes, sampled.gt_idx))
        losses = fast_rcnn_losses(logits, deltas, sampled.gt_classes.reshape(-1),
                                  gt_deltas.reshape(-1, 4), sampled.valid.reshape(-1),
                                  self.num_classes, self.smooth_l1_beta)
        losses.update(self._mask_and_keypoint_losses(features, sampled, gt))
        fg = (sampled.gt_classes < self.num_classes) & sampled.valid
        losses["diag_fg_frac"] = fg.float().mean()
        return losses

    def _select_fg(self, sampled: SampledProposals):
        """The foreground rows first (the lowest index first among equals, as
        ``lax.top_k``), cut to a fixed capacity of
        int(batch_size_per_image * positive_fraction)."""
        max_fg = max(1, int(self.batch_size_per_image * self.positive_fraction))
        fg = sampled.valid & (sampled.gt_classes < self.num_classes)
        fg_idx = torch.sort(fg.int(), dim=1, descending=True, stable=True).indices[:, :max_fg]
        return (max_fg, _take(sampled.boxes, fg_idx), torch.gather(sampled.gt_classes, 1, fg_idx),
                torch.gather(sampled.gt_idx, 1, fg_idx), torch.gather(fg, 1, fg_idx))

    def _mask_branch_train(self, features, sampled: SampledProposals, gt: GroundTruth):
        b = sampled.gt_classes.shape[0]
        max_fg, fg_boxes, fg_classes, fg_gt_idx, fg_valid = self._select_fg(sampled)
        logits = self.mask_head(self._pool(features, fg_boxes, self.mask_res))
        size = logits.shape[1]
        targets = crop_and_resize_masks(gt.masks, gt.boxes, fg_boxes, fg_gt_idx, size)
        return mask_loss(logits, targets.reshape(b * max_fg, size, size),
                         fg_classes.reshape(-1), fg_valid.reshape(-1), self.num_classes)

    def _mask_and_keypoint_losses(self, features, sampled: SampledProposals, gt: GroundTruth
                      ) -> Dict[str, torch.Tensor]:
        """{loss_mask} and {loss_keypoint} of the branches that are on."""
        losses = {}
        if self.mask_on:
            losses["loss_mask"] = self._mask_branch_train(features, sampled, gt)
        if self.keypoint_on:
            losses["loss_keypoint"] = self._keypoint_branch_train(features, sampled, gt)
        return losses

    def _keypoint_branch_train(self, features, sampled: SampledProposals, gt: GroundTruth):
        """The foreground keypoint branch (d2 ``keypoint_rcnn_loss``); d2's
        ``select_proposals_with_visible_keypoints`` is folded into the loss's
        visibility mask, as in JAX."""
        if gt.keypoints is None:
            raise ValueError("MODEL.KEYPOINT_ON needs the ground truth's keypoints")
        b = sampled.gt_classes.shape[0]
        max_fg, fg_boxes, _, fg_gt_idx, fg_valid = self._select_fg(sampled)
        logits = self.keypoint_head(self._pool(features, fg_boxes, self.keypoint_res,
                                               self.keypoint_sampling_ratio,
                                               self.keypoint_aligned))
        gt_kp = _take(gt.keypoints.float(), fg_gt_idx)
        # d2's flag-off constant: num_images * batch_size_per_image *
        # positive_fraction (= b * max_fg)
        return keypoint_rcnn_loss(logits, gt_kp.reshape(b * max_fg, self.num_keypoints, 3),
                                  fg_boxes.reshape(b * max_fg, 4), fg_valid.reshape(-1),
                                  self.keypoint_normalize_by_visible,
                                  self.keypoint_loss_weight, normalizer=float(b * max_fg))
