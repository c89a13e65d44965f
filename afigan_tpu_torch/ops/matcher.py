"""Anchor / proposal ↔ ground-truth matcher (counterpart of
``afigan_tpu/ops/matcher.py``): d2's ``Matcher`` over padded GT rows with a
validity mask. Invalid rows never win the argmax and never promote a
low-quality match; a GT whose best IoU is 0 promotes nothing."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class Matcher:
    def __init__(self, thresholds: Sequence[float], labels: Sequence[int],
                 allow_low_quality_matches: bool = False):
        thresholds = list(thresholds)
        if thresholds != sorted(thresholds):
            raise ValueError(f"thresholds {thresholds} must be sorted")
        if len(labels) != len(thresholds) + 1 or any(l not in (-1, 0, 1) for l in labels):
            raise ValueError(f"labels {labels} for thresholds {thresholds}")
        self.thresholds = [-float("inf")] + thresholds + [float("inf")]
        self.labels = list(labels)
        self.allow_low_quality_matches = allow_low_quality_matches

    def __call__(self, quality, gt_valid) -> Tuple[torch.Tensor, torch.Tensor]:
        """quality (..., M, N) IoU of padded GT rows against N candidates;
        gt_valid (..., M) → (matches (..., N) int64 best GT row, labels (...,
        N) int8 in {-1, 0, 1}). Ties in the argmax go to the lowest row."""
        quality = torch.where(gt_valid[..., :, None], quality,
                              torch.full_like(quality, -1.0))
        # max over rows, first row among equals (jnp.argmax's rule)
        matched_vals = quality.max(dim=-2).values
        m = quality.shape[-2]
        rows = torch.arange(m, device=quality.device).view(*([1] * (quality.dim() - 2)), m, 1)
        matches = torch.where(quality == matched_vals[..., None, :], rows, m).min(dim=-2).values
        labels = torch.ones(matched_vals.shape, dtype=torch.int8, device=quality.device)
        for label, low, high in zip(self.labels, self.thresholds[:-1], self.thresholds[1:]):
            in_bucket = (matched_vals >= low) & (matched_vals < high)
            labels = torch.where(in_bucket, torch.tensor(label, dtype=torch.int8,
                                                         device=quality.device), labels)
        if self.allow_low_quality_matches:
            highest = quality.max(dim=-1, keepdim=True).values  # (..., M, 1)
            promote = ((quality == highest) & (highest > 0)).any(dim=-2)
            labels = torch.where(promote, torch.ones_like(labels), labels)
        return matches, labels
