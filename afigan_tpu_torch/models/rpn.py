"""Region Proposal Network (counterpart of ``afigan_tpu/models/rpn.py``):
``RPNHead`` (d2 StandardRPNHead, keys
``rpn_head.{conv,objectness_logits,anchor_deltas}``), the fixed-shape
``generate_proposals`` (per-level exact top-k → decode → clip → cross-level
batched NMS → ``post_nms_topk`` proposals + validity), and the training
targets and losses: ``label_anchors`` (Matcher 0.3 / 0.7 with low-quality
matches, then a 256-anchor subsample) and ``rpn_losses`` (BCE objectness and
smooth-L1 localisation, both over batch_size_per_image x images).

The JAX package's ``TPU.APPROX_TOPK`` (``lax.approx_max_k`` in its training
steps, a TPU approximation that is exact on the CPU) is not read: the port's
top-k is exact in training and at inference."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.boxes import Box2BoxTransform, clip_boxes, nonempty_mask, pairwise_iou
from ..ops.losses import bce_with_logits, smooth_l1
from ..ops.matcher import Matcher
from ..ops.nms import batched_nms_padded
from ..ops.sampling import subsample_labels
from .layers import Conv2d, init_weight


# The JAX package's ``rpn_conv_dim``: 256 whatever the pyramid width (d2
# uses the input width; the two agree at the main path's 256).
RPN_CONV_DIM = 256


class RPNHead(nn.Module):
    def __init__(self, in_channels: int, num_anchors: int, device=None):
        super().__init__()
        conv_dim = RPN_CONV_DIM
        self.conv = Conv2d(in_channels, conv_dim, 3, padding=1, device=device)
        self.objectness_logits = Conv2d(conv_dim, num_anchors, 1, device=device)
        self.anchor_deltas = Conv2d(conv_dim, num_anchors * 4, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in (self.conv, self.objectness_logits, self.anchor_deltas):
            init_weight(m.weight, "normal0.01", gen)
            nn.init.zeros_(m.bias)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for f in features:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t))
            deltas.append(self.anchor_deltas(t))
        return logits, deltas


class RPNOutput(NamedTuple):
    proposals: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor     # (B, K)
    valid: torch.Tensor      # (B, K) bool


def generate_proposals(anchors_per_level, logits_per_level, deltas_per_level,
                       image_sizes, box2box: Box2BoxTransform,
                       pre_nms_topk: int, post_nms_topk: int,
                       nms_thresh: float, min_size: float = 0.0) -> RPNOutput:
    """Fixed-shape d2 find_top_rpn_proposals with exact top-k (ties: lowest
    index first, as ``jax.lax.top_k``)."""
    b = logits_per_level[0].shape[0]
    all_boxes, all_scores, all_levels = [], [], []
    for lvl, (anch, lg, dl) in enumerate(
            zip(anchors_per_level, logits_per_level, deltas_per_level)):
        # no gradient through the proposals (stop_gradient in JAX)
        scores = lg.detach().reshape(b, -1).float()
        deltas = dl.detach().reshape(b, -1, 4).float()
        k = min(pre_nms_topk, scores.shape[1])
        top_scores, top_idx = torch.sort(scores, dim=1, descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        top_deltas = torch.gather(deltas, 1, top_idx[..., None].expand(b, k, 4))
        boxes = box2box.apply_deltas(top_deltas, anch[top_idx])
        all_boxes.append(boxes)
        all_scores.append(top_scores)
        all_levels.append(torch.full((b, k), lvl, dtype=torch.int32,
                                     device=scores.device))
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    levels = torch.cat(all_levels, dim=1)

    pb, ps, pv = [], [], []
    for i in range(b):
        bi = clip_boxes(boxes[i], image_sizes[i])
        vi = nonempty_mask(bi, min_size)
        ob, osc, _, ov = batched_nms_padded(bi, scores[i], levels[i], nms_thresh,
                                            post_nms_topk, valid=vi)
        pb.append(ob)
        ps.append(osc)
        pv.append(ov)
    return RPNOutput(torch.stack(pb), torch.stack(ps), torch.stack(pv))


def label_anchors(anchors, gt_boxes, gt_valid, batch_size_per_image: int,
                  positive_fraction: float, matcher: Matcher, draws=None):
    """Batched over images: anchors (N, 4), gt_boxes (B, M, 4), gt_valid (B,
    M) → (labels (B, N) int64 in {-1, 0, 1} after subsampling, the anchors
    not sampled folded into -1; matched GT row (B, N)). ``draws``: the
    subsample's uniform keys or their source (``ops/sampling.py``)."""
    iou = pairwise_iou(gt_boxes, anchors.expand(gt_boxes.shape[0], *anchors.shape))
    matched_idx, labels = matcher(iou, gt_valid)
    labels = labels.long()
    idx, valid = subsample_labels(labels, batch_size_per_image, positive_fraction, 0, draws)
    # a max-scatter: filler slots repeat in-range indices with valid False
    sampled = torch.zeros(labels.shape, dtype=torch.int32, device=labels.device)
    sampled = sampled.scatter_reduce(-1, idx, valid.int(), "amax").bool()
    return torch.where(sampled, labels, torch.full_like(labels, -1)), matched_idx


def rpn_losses(labels, matched_idx, gt_boxes, anchors, pred_logits, pred_deltas,
               box2box: Box2BoxTransform, batch_size_per_image: int,
               smooth_l1_beta: float = 0.0):
    """labels, matched_idx (B, N); gt_boxes (B, M, 4); anchors (N, 4);
    pred_logits (B, N); pred_deltas (B, N, 4) → {loss_rpn_cls, loss_rpn_loc},
    each a sum over the sampled (positive) anchors / (batch_size_per_image *
    B) in float32."""
    b = labels.shape[0]
    normalizer = batch_size_per_image * b
    matched_gt = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
    gt_deltas = box2box.get_deltas(anchors.expand_as(matched_gt), matched_gt)
    pos = labels == 1
    sampled = labels >= 0
    zero = torch.zeros((), device=labels.device)
    loc = smooth_l1(pred_deltas.float(), gt_deltas, smooth_l1_beta)
    loss_loc = torch.where(pos[..., None], loc, zero).sum() / normalizer
    obj = bce_with_logits(pred_logits.float(), pos.float())
    loss_obj = torch.where(sampled, obj, zero).sum() / normalizer
    return {"loss_rpn_cls": loss_obj, "loss_rpn_loc": loss_loc}
