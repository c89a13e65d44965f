"""Mask R-CNN mask head (counterpart of ``afigan_tpu/models/mask_head.py``):
NUM_CONV 3x3 convs → 2x2/s2 transposed conv → 1x1 per-class predictor (d2
keys mask_fcn{i}, deconv, predictor), and its training side: mask targets
by bilinear crop-resize of each GT instance's host-rasterised canvas under
the proposal → GT-box transform (two interpolation-matrix products, as the
JAX package computes them), and the BCE loss on the GT class's channel."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.losses import bce_with_logits
from .layers import Conv2d, ConvTranspose2d, init_weight


class MaskRCNNConvUpsampleHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 4,
                 conv_dim: int = 256, cls_agnostic: bool = False, device=None):
        super().__init__()
        self.num_conv = num_conv
        dim = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}",
                            Conv2d(dim, conv_dim, 3, padding=1, device=device))
            dim = conv_dim
        self.deconv = ConvTranspose2d(dim, conv_dim, 2, 2, 0, device=device)
        self.predictor = Conv2d(conv_dim, 1 if cls_agnostic else num_classes, 1,
                                device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        for i in range(self.num_conv):
            m = getattr(self, f"mask_fcn{i + 1}")
            init_weight(m.weight, "msra", gen)
            nn.init.zeros_(m.bias)
        init_weight(self.deconv.weight, "msra", gen, transposed=True)
        nn.init.zeros_(self.deconv.bias)
        init_weight(self.predictor.weight, "normal0.001", gen)
        nn.init.zeros_(self.predictor.bias)

    def forward(self, x):
        """(R, P, P, C) → (R, 2P, 2P, num_classes) mask logits (NHWC)."""
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x)


def crop_and_resize_masks(gt_masks, gt_boxes, rois, roi_gt_idx, out_size: int):
    """gt_masks (..., M, MH, MW) float canvases covering each GT box; gt_boxes
    (..., M, 4); rois (..., R, 4) image coords; roi_gt_idx (..., R) → (...,
    R, out_size, out_size) float32 targets in [0, 1]. Half-pixel sample
    centres; the hat weight relu(1 - |coord - tap|) is the two-tap bilinear
    kernel, an out-of-canvas tap absent (zero padding)."""
    mh, mw = gt_masks.shape[-2], gt_masks.shape[-1]
    g = torch.gather(gt_boxes, -2, roi_gt_idx[..., None].expand(*roi_gt_idx.shape, 4))
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-4)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-4)
    x1 = (rois[..., 0] - g[..., 0]) / gw * mw
    x2 = (rois[..., 2] - g[..., 0]) / gw * mw
    y1 = (rois[..., 1] - g[..., 1]) / gh * mh
    y2 = (rois[..., 3] - g[..., 1]) / gh * mh
    p = (torch.arange(out_size, dtype=rois.dtype, device=rois.device) + 0.5) / out_size
    ys = y1[..., None] + p * (y2 - y1)[..., None] - 0.5  # (..., R, S)
    xs = x1[..., None] + p * (x2 - x1)[..., None] - 0.5
    ay = torch.relu(1.0 - torch.abs(ys[..., None] - torch.arange(mh, dtype=ys.dtype,
                                                                   device=ys.device)))
    ax = torch.relu(1.0 - torch.abs(xs[..., None] - torch.arange(mw, dtype=xs.dtype,
                                                                   device=xs.device)))
    idx = roi_gt_idx[..., None, None].expand(*roi_gt_idx.shape, mh, mw)
    sel = torch.gather(gt_masks.float(), -3, idx)  # (..., R, MH, MW)
    tmp = torch.matmul(sel, ax.transpose(-1, -2))  # (..., R, MH, S)
    return torch.matmul(ay, tmp)  # (..., R, S, S)


def mask_loss(mask_logits, mask_targets, gt_classes, fg_valid, num_classes: int):
    """mask_logits (R, S, S, C) or (R, S, S, 1); targets (R, S, S) in [0, 1],
    binarised at 0.5; per-ROI mean BCE on the GT class's channel, summed over
    the valid foreground ROIs / their count."""
    logits = mask_logits.float()
    if logits.shape[-1] == 1:
        sel = logits[..., 0]
    else:
        cls = torch.clamp(gt_classes.long(), 0, num_classes - 1)
        idx = cls[:, None, None, None].expand(-1, *logits.shape[1:3], 1)
        sel = torch.gather(logits, -1, idx)[..., 0]
    t = (mask_targets >= 0.5).float()
    per_roi = bce_with_logits(sel, t).mean(dim=(1, 2))
    n = torch.clamp(fg_valid.float().sum(), min=1.0)
    return torch.where(fg_valid, per_roi, torch.zeros((), device=per_roi.device)).sum() / n
