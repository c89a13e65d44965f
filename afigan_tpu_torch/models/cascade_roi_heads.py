"""Cascade R-CNN ROI heads, inference branch (counterpart of
``afigan_tpu/models/cascade_roi_heads.py``, d2 CascadeROIHeads): three box
stages, each with its own head, class-agnostic regression and box2box
weights, each refining the previous stage's boxes (clipped to the image in
between); the class scores are the mean of the per-stage softmax
probabilities, then the fixed-shape per-image detection. The mask branch is
``StandardROIHeads``'s. d2 keys ``box_head.{k}.*``, ``box_predictor.{k}.*``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.boxes import Box2BoxTransform, clip_boxes
from .box_head import Detections, fast_rcnn_inference_single
from .roi_heads import StandardROIHeads


class CascadeROIHeads(StandardROIHeads):
    def __init__(self, *args,
                 cascade_bbox_reg_weights: Sequence[Sequence[float]] = (
                     (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
                     (30.0, 30.0, 15.0, 15.0)), **kwargs):
        self.num_stages = len(cascade_bbox_reg_weights)
        super().__init__(*args, **kwargs)
        self.stage_box2box = [Box2BoxTransform(tuple(w)) for w in cascade_bbox_reg_weights]

    def _build_box_heads(self, make_head, make_predictor) -> None:
        self.box_head = nn.ModuleList(make_head() for _ in range(self.num_stages))
        self.box_predictor = nn.ModuleList(
            make_predictor(h.out_dim, True) for h in self.box_head)

    def losses(self, *args, **kwargs):
        raise NotImplementedError(
            "Cascade R-CNN training is not ported yet (ROADMAP queue 1, the breadth "
            "families)")

    def forward(self, features, proposals, image_sizes):
        b, k = proposals.scores.shape
        boxes = proposals.proposals
        all_probs = []
        for stage in range(self.num_stages):
            flat = self._pool(features, boxes, self.box_res)
            logits, deltas = self.box_predictor[stage](self.box_head[stage](flat))
            all_probs.append(torch.softmax(logits.float(), dim=-1).reshape(b, k, -1))
            new_boxes = self.stage_box2box[stage].apply_deltas(
                deltas.float().reshape(b, k, 4), boxes)
            boxes = torch.stack([clip_boxes(new_boxes[i], image_sizes[i])
                                 for i in range(b)])
        mean_probs = sum(all_probs) / self.num_stages
        per_image = [
            fast_rcnn_inference_single(boxes[i][:, None, :], mean_probs[i], image_sizes[i],
                                       proposals.valid[i], self.score_thresh,
                                       self.nms_thresh, self.detections_per_image)
            for i in range(b)]
        dets = Detections(*(torch.stack([getattr(d, f) for d in per_image])
                            for f in ("boxes", "scores", "classes", "valid")))
        masks = self._mask_branch(features, dets) if self.mask_on else None
        return dets, masks
