"""Elementwise loss primitives (counterpart of ``afigan_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch


def smooth_l1(pred, target, beta: float):
    """Elementwise d2 smooth_l1_loss; beta <= 1e-8 is plain L1 (fvcore)."""
    diff = torch.abs(pred - target)
    if beta <= 1e-8:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def bce_with_logits(logits, targets):
    """Elementwise, numerically stable: max(x, 0) - x t + log(1 + exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
