"""Keypoint R-CNN head (counterpart of ``afigan_tpu/models/keypoint_head.py``,
d2's ``KRCNNConvDeconvUpsampleHead``), NHWC.

The head: ``conv_dims`` 3x3 convs with ReLU (d2 keys ``conv_fcn{i}``), a
ConvTranspose k4 s2 p1 to ``num_keypoints`` channels (``score_lowres``), then
a 2x bilinear upsample in float32: (R, P, P, C) → (R, 4P, 4P, K) logits.

The loss (d2 ``keypoint_rcnn_loss``): each visible GT keypoint falls in one
cell of its ROI's heatmap grid; softmax cross-entropy over the flattened map,
summed over the visible keypoints and divided by their count, or by a
constant (``normalizer``, d2's ``num_images * batch_size_per_image *
positive_fraction``) when ``NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS`` is off.

Inference: the JAX package's static-shape variant of d2's
``heatmaps_to_keypoints`` (not d2's bicubic resize to each box): a 2x
bilinear upsample, the argmax on that fixed grid, the cell centre mapped into
the box; the score is the softmax probability of that cell on the original
grid.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, ConvTranspose2d, bilinear_upsample_x2, init_weight


class KRCNNConvDeconvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17,
                 conv_dims: Sequence[int] = (512,) * 8, device=None):
        super().__init__()
        self.num_conv = len(conv_dims)
        dim = in_channels
        for i, out in enumerate(conv_dims):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(dim, out, 3, padding=1, device=device))
            dim = out
        self.score_lowres = ConvTranspose2d(dim, num_keypoints, 4, 2, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        """The JAX head's distributions: variance scaling 2.0 over fan-out
        (msra), zero biases."""
        for i in range(self.num_conv):
            m = getattr(self, f"conv_fcn{i + 1}")
            init_weight(m.weight, "msra", gen)
            nn.init.zeros_(m.bias)
        init_weight(self.score_lowres.weight, "msra", gen, transposed=True)
        nn.init.zeros_(self.score_lowres.bias)

    def forward(self, x):
        """(R, P, P, C) → (R, 4P, 4P, K) float32 logits."""
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        return bilinear_upsample_x2(self.score_lowres(x).float())


def keypoints_to_heatmap(keypoints, rois, heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """keypoints (R, K, 3) [x, y, vis] in image coords, rois (R, 4) xyxy →
    (the heatmap cell of each keypoint (R, K) int64 in [0, S*S), valid (R, K)
    bool: inside its ROI and visible). d2 ``_keypoints_to_heatmap``
    numerics: a point on the right or bottom edge is in the last cell."""
    scale_x = heatmap_size / torch.clamp(rois[:, 2:3] - rois[:, 0:1], min=1e-6)
    scale_y = heatmap_size / torch.clamp(rois[:, 3:4] - rois[:, 1:2], min=1e-6)
    x = torch.floor((keypoints[..., 0] - rois[:, 0:1]) * scale_x)
    y = torch.floor((keypoints[..., 1] - rois[:, 1:2]) * scale_y)
    x = torch.where(x == heatmap_size, x - 1, x)
    y = torch.where(y == heatmap_size, y - 1, y)
    inside = (x >= 0) & (x < heatmap_size) & (y >= 0) & (y < heatmap_size)
    valid = inside & (keypoints[..., 2] > 0)
    lin = (y * heatmap_size + x).to(torch.int64)  # truncates toward zero, as astype
    return torch.clamp(lin, 0, heatmap_size * heatmap_size - 1), valid


def keypoint_rcnn_loss(logits, gt_keypoints, rois, roi_valid,
                       normalize_by_visible: bool = True, loss_weight: float = 1.0,
                       normalizer: Optional[float] = None) -> torch.Tensor:
    """logits (R, S, S, K), gt_keypoints (R, K, 3) image coords, rois (R, 4),
    roi_valid (R,) → the scalar loss: softmax cross-entropy per visible
    keypoint over the flattened map, summed, over the visible count (or over
    ``normalizer``, which the flag-off mode requires)."""
    r, s, _, k = logits.shape
    target, kp_valid = keypoints_to_heatmap(gt_keypoints, rois, s)
    vis = (kp_valid & roi_valid[:, None]).reshape(r * k)
    flat = logits.float().reshape(r, s * s, k).permute(0, 2, 1).reshape(r * k, s * s)
    logp = torch.log_softmax(flat, dim=-1)
    ce = -torch.gather(logp, 1, target.reshape(r * k, 1))[:, 0]
    total = torch.where(vis, ce, torch.zeros((), device=ce.device)).sum()
    if normalize_by_visible:
        norm = torch.clamp(vis.float().sum(), min=1.0)
    else:
        if normalizer is None:
            raise ValueError("normalize_by_visible=False requires the d2 constant normalizer")
        norm = max(float(normalizer), 1.0)
    return loss_weight * total / norm


def heatmaps_to_keypoints(logits, rois) -> torch.Tensor:
    """logits (R, S, S, K), rois (R, 4) → (R, K, 3) [x, y, score] in image
    coordinates (see the module docstring)."""
    r, s, _, k = logits.shape
    maps = logits.float()
    s2 = 2 * s
    idx = bilinear_upsample_x2(maps).reshape(r, s2 * s2, k).argmax(dim=1)  # (R, K)
    yy = torch.div(idx, s2, rounding_mode="floor").float()
    xx = (idx % s2).float()
    w = torch.clamp(rois[:, 2:3] - rois[:, 0:1], min=1e-6)
    h = torch.clamp(rois[:, 3:4] - rois[:, 1:2], min=1e-6)
    x = rois[:, 0:1] + (xx + 0.5) * w / s2
    y = rois[:, 1:2] + (yy + 0.5) * h / s2
    probs = torch.softmax(maps.reshape(r, s * s, k), dim=1)
    orig = torch.clamp((yy / 2).to(torch.int64) * s + (xx / 2).to(torch.int64), 0, s * s - 1)
    score = torch.gather(probs, 1, orig[:, None, :])[:, 0, :]
    return torch.stack([x, y, score], dim=-1)
