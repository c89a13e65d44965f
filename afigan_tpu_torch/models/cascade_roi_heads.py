"""Cascade R-CNN ROI heads (counterpart of
``afigan_tpu/models/cascade_roi_heads.py``, d2 CascadeROIHeads): three box
stages, each with its own head, class-agnostic regression and box2box
weights, each refining the previous stage's boxes (clipped to the image in
between). d2 keys ``box_head.{k}.*``, ``box_predictor.{k}.*``.

Inference: the class scores are the mean of the per-stage softmax
probabilities, then the fixed-shape per-image detection. The mask branch is
``StandardROIHeads``'s, on the final stage's detections (or on the boxes a
test-time-augmentation caller gives, with no box stage run).

Training (``losses``): stage 0 samples the proposals as ``StandardROIHeads``
does, matched at the first cascade IoU; stages 1 and 2 rematch every carried
box at their own IoU, with no resampling, and regress towards their own
matches. Each stage's box losses are named ``loss_{cls,box_reg}_stage{k}``,
its foreground fraction ``diag_fg_frac_stage{k}``. Between stages the
detached float32 deltas move the boxes, clipped to each image. The mask loss
is taken on the stage-0 samples. As in the JAX head, no stage scales the
gradient of its pooled features (d2's ``_ScaleGradient`` by 1/3 is not
applied).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ..ops.boxes import Box2BoxTransform, clip_boxes, pairwise_iou
from ..ops.matcher import Matcher
from .box_head import Detections, fast_rcnn_inference_single, fast_rcnn_losses
from .roi_heads import GroundTruth, StandardROIHeads, _take, sample_proposals


def _clip_each(boxes, image_sizes):
    """(B, R, 4) boxes clipped to each image's (h, w)."""
    return torch.stack([clip_boxes(boxes[i], image_sizes[i]) for i in range(boxes.shape[0])])


class CascadeROIHeads(StandardROIHeads):
    def __init__(self, *args,
                 cascade_bbox_reg_weights: Sequence[Sequence[float]] = (
                     (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
                     (30.0, 30.0, 15.0, 15.0)),
                 cascade_ious: Sequence[float] = (0.5, 0.6, 0.7), **kwargs):
        if len(cascade_ious) != len(cascade_bbox_reg_weights):
            raise ValueError(f"{len(cascade_ious)} cascade IoUs for "
                             f"{len(cascade_bbox_reg_weights)} stages")
        self.num_stages = len(cascade_bbox_reg_weights)
        super().__init__(*args, **kwargs)
        self.stage_box2box = [Box2BoxTransform(tuple(w)) for w in cascade_bbox_reg_weights]
        self.stage_matchers = [Matcher([float(t)], [0, 1]) for t in cascade_ious]

    def _build_box_heads(self, make_head, make_predictor) -> None:
        self.box_head = nn.ModuleList(make_head() for _ in range(self.num_stages))
        self.box_predictor = nn.ModuleList(
            make_predictor(h.out_dim, True) for h in self.box_head)

    def losses(self, features, proposals, image_sizes, gt: GroundTruth,
               draws=None) -> Dict[str, torch.Tensor]:
        """{loss_cls_stage{k}, loss_box_reg_stage{k}, diag_fg_frac_stage{k}
        for each stage[, loss_mask][, loss_keypoint]}. ``draws``: the stage-0 subsample's key
        source (``ops/sampling.py::draw``)."""
        sampled = sample_proposals(
            proposals.proposals.detach(), proposals.valid, gt, self.batch_size_per_image,
            self.positive_fraction, self.stage_matchers[0], self.num_classes,
            self.append_gt, draws)
        boxes, gt_classes, gt_idx, valid = sampled
        b, s = gt_classes.shape
        background = torch.full_like(gt_classes, self.num_classes)
        losses: Dict[str, torch.Tensor] = {}
        for stage in range(self.num_stages):
            box2box = self.stage_box2box[stage]
            if stage > 0:
                gt_idx, labels = self.stage_matchers[stage](
                    pairwise_iou(gt.boxes, boxes), gt.valid)
                matched = torch.gather(gt.classes.long(), 1, gt_idx)
                gt_classes = torch.where(valid & (labels == 1), matched, background)
            fg = (gt_classes < self.num_classes) & valid
            losses[f"diag_fg_frac_stage{stage}"] = fg.float().mean()
            flat = self._pool(features, boxes, self.box_res)
            logits, deltas = self.box_predictor[stage](self.box_head[stage](flat))
            gt_deltas = box2box.get_deltas(boxes, _take(gt.boxes, gt_idx))
            stage_losses = fast_rcnn_losses(
                logits, deltas, gt_classes.reshape(-1), gt_deltas.reshape(-1, 4),
                valid.reshape(-1), self.num_classes, self.smooth_l1_beta)
            losses.update({f"{k}_stage{stage}": v for k, v in stage_losses.items()})
            if stage < self.num_stages - 1:
                boxes = _clip_each(box2box.apply_deltas(
                    deltas.detach().float().reshape(b, s, 4), boxes), image_sizes)
        losses.update(self._mask_and_keypoint_losses(features, sampled, gt))
        return losses

    def forward(self, features, proposals, image_sizes, given_dets=None):
        if given_dets is not None:
            return super().forward(features, proposals, image_sizes, given_dets)
        b, k = proposals.scores.shape
        boxes = proposals.proposals
        all_probs = []
        for stage in range(self.num_stages):
            flat = self._pool(features, boxes, self.box_res)
            logits, deltas = self.box_predictor[stage](self.box_head[stage](flat))
            all_probs.append(torch.softmax(logits.float(), dim=-1).reshape(b, k, -1))
            new_boxes = self.stage_box2box[stage].apply_deltas(
                deltas.float().reshape(b, k, 4), boxes)
            boxes = _clip_each(new_boxes, image_sizes)
        mean_probs = sum(all_probs) / self.num_stages
        per_image = [
            fast_rcnn_inference_single(boxes[i][:, None, :], mean_probs[i], image_sizes[i],
                                       proposals.valid[i], self.score_thresh,
                                       self.nms_thresh, self.detections_per_image)
            for i in range(b)]
        dets = Detections(*(torch.stack([getattr(d, f) for d in per_image])
                            for f in ("boxes", "scores", "classes", "valid")))
        return self._mask_and_keypoint_branches(features, dets)
