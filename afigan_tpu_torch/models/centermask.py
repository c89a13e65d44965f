"""CenterMask (counterpart of ``afigan_tpu/models/centermask.py``): FCOS
detection and a spatial-attention (SAG) mask head on the detected boxes,
pooled from p3-p5 by the ``TPU.POOLER_IMPL`` pooler. The model is an ``FCOS``
(one backbone, the FCOS head and decode) with the mask branch added.

Training (CenterMask2's protocol, as the JAX package): the FCOS losses, and
the mask branch on the FCOS head's own detections of the step (decoded from
the detached outputs at the ``_TRAIN`` thresholds, NMS included), the GT
boxes appended, matched to the GT at IoU 0.5 and subsampled to ``max_fg``
ROIs an image, all foreground if there are as many; targets cropped from the
GT masks, the loss ``mask_loss`` over the foreground ROIs. Under
``pallas`` the pool's backward is ``csrc/roi_pool.cu::roi_pool_backward`` on
the card; the JAX package pools 160 channels with its ``fast`` pooler, which
equals it below 64 overflowing ROIs a call.

State-dict keys follow CenterMask2: FCOS's, and
``roi_heads.mask_head.{mask_fcn{i},spatialAtt.conv,deconv,predictor}``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.matcher import Matcher
from ..ops.roi_align import POOLER_IMPLS, pool_rois
from .fcos import FCOS
from .layers import Conv2d, ConvTranspose2d, init_weight
from .mask_head import crop_and_resize_masks, mask_loss
from .roi_heads import GroundTruth, sample_proposals


class SpatialAttention(nn.Module):
    """x * sigmoid(conv3x3(cat(mean_c x, max_c x))), the gate in float32."""

    def __init__(self, device=None):
        super().__init__()
        self.conv = Conv2d(2, 1, 3, padding=1, device=device)

    def forward(self, x):
        a = torch.cat([x.mean(dim=-1, keepdim=True), x.amax(dim=-1, keepdim=True)], -1)
        return x * torch.sigmoid(self.conv(a).float()).to(x.dtype)


class SAGMaskHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: int, num_conv: int = 4,
                 conv_dim: int = 256, device=None):
        super().__init__()
        self.num_conv = num_conv
        dim = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}",
                            Conv2d(dim, conv_dim, 3, padding=1, device=device))
            dim = conv_dim
        self.spatialAtt = SpatialAttention(device)
        self.deconv = ConvTranspose2d(dim, conv_dim, 2, 2, 0, device=device)
        self.predictor = Conv2d(conv_dim, num_classes, 1, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        convs = [getattr(self, f"mask_fcn{i + 1}") for i in range(self.num_conv)]
        for m in (*convs, self.spatialAtt.conv):
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
        x = F.relu(self.deconv(self.spatialAtt(x)))
        return self.predictor(x)


class MaskBranch(nn.Module):
    """Holds ``mask_head`` so keys read ``roi_heads.mask_head.*``."""

    def __init__(self, mask_head: SAGMaskHead):
        super().__init__()
        self.mask_head = mask_head


class CenterMask(FCOS):
    def __init__(self, backbone: nn.Module, in_channels: int, num_classes: int = 80,
                 mask_in_features: Sequence[str] = ("p3", "p4", "p5"),
                 mask_strides: Sequence[int] = (8, 16, 32),
                 mask_pooler_resolution: int = 14, pooler_impl: str = "pallas",
                 max_fg: int = 64, device=None, **fcos):
        super().__init__(backbone, in_channels, num_classes, device=device, **fcos)
        if pooler_impl not in POOLER_IMPLS:
            raise ValueError(f"TPU.POOLER_IMPL {pooler_impl!r}: one of {POOLER_IMPLS}")
        self.pooler_impl = pooler_impl
        self.num_classes = num_classes
        self.mask_in_features = tuple(mask_in_features)
        self.mask_strides = tuple(mask_strides)
        self.mask_res = mask_pooler_resolution
        self.max_fg = max_fg
        self.matcher = Matcher([0.5], [0, 1])
        self.roi_heads = MaskBranch(SAGMaskHead(in_channels, num_classes, device=device))

    def init_weights(self, gen: torch.Generator) -> None:
        super().init_weights(gen)
        self.roi_heads.mask_head.init_weights(gen)

    def _pool(self, features, boxes):
        """→ (B*R, P, P, C) in the features' dtype."""
        feats = [features[f] for f in self.mask_in_features]
        pooled = pool_rois(self.pooler_impl, feats, boxes, self.mask_strides,
                           self.mask_res, 2, True)
        return pooled.reshape(-1, *pooled.shape[2:]).to(feats[0].dtype)

    def forward(self, images, image_sizes, gt: Optional[GroundTruth] = None, draws=None):
        """→ in eval mode (Detections with (B, D, ...) fields, mask
        probabilities (B, D, 2P, 2P) of each detection's class); in training
        mode, with ``gt`` (masks included), the FCOS losses and ``loss_mask``.
        ``draws``: the subsample's key source (``ops/sampling.py::draw``)."""
        if self.training:
            return self._train_losses(images, image_sizes, gt, draws)
        features, dets = self.detect(images, image_sizes)
        b, d = dets.scores.shape
        with record_function("mask_pool"):
            flat = self._pool(features, dets.boxes)
        with record_function("mask_head"):
            logits = self.roi_heads.mask_head(flat)
            s = logits.shape[1]
            logits = logits.reshape(b, d, s, s, -1)
            cls = torch.clamp(dets.classes.long(), 0, self.num_classes - 1)
            sel = torch.gather(logits, -1,
                               cls[:, :, None, None, None].expand(b, d, s, s, 1))[..., 0]
            return dets, torch.sigmoid(sel.float())

    def _train_losses(self, images, image_sizes, gt: Optional[GroundTruth], draws):
        if gt is None or gt.masks is None:
            raise ValueError("a CenterMask in training mode needs the ground truth with masks")
        features, outputs = self.head(images)
        losses = self.losses(outputs, gt)
        props = self.decode_outputs(outputs, image_sizes, detach=True)
        with record_function("mask_sample"):
            sampled = sample_proposals(props.boxes, props.valid, gt, self.max_fg, 1.0,
                                       self.matcher, self.num_classes, True, draws)
            fg_valid = sampled.valid & (sampled.gt_classes < self.num_classes)
        with record_function("mask_pool"):
            flat = self._pool(features, sampled.boxes)
        with record_function("mask_head"):
            logits = self.roi_heads.mask_head(flat)
            s = logits.shape[1]
            targets = crop_and_resize_masks(gt.masks, gt.boxes, sampled.boxes,
                                            sampled.gt_idx, s)
            losses["loss_mask"] = mask_loss(logits, targets.reshape(-1, s, s),
                                            sampled.gt_classes.reshape(-1),
                                            fg_valid.reshape(-1), self.num_classes)
        return losses
