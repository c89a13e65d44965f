"""Fixed-size random minibatch sampling (counterpart of
``afigan_tpu/ops/sampling.py``): d2's ``subsample_labels`` as a fixed-size
index array plus a validity mask, chosen by the top-k of random keys.

``jax.lax.top_k`` becomes a stable descending sort (the largest first, the
lowest index first among equals: ``top_k``'s tie order). The two uniform
draws in [0.1, 1) come from a ``torch.Generator`` or are handed in
(``draws``): JAX's random bits cannot be reproduced, so tests feed both
packages the same draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def uniform_draws(shape, generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two uniform key arrays of ``subsample_labels`` in [0.1, 1)."""
    def one():
        u = torch.rand(shape, generator=generator, device=device)
        return 0.1 + 0.9 * u
    return one(), one()


def draw(source, shape, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The subsample's keys from ``source``: None (torch's default
    generator), a ``torch.Generator``, or a callable (shape, device) →
    (positive, negative) keys, which tests use to fix them."""
    if source is None or isinstance(source, torch.Generator):
        return uniform_draws(shape, source, device)
    return source(shape, device)


def _top_k(x, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def subsample_labels(labels, num_samples: int, positive_fraction: float,
                     bg_label: int = 0, draws=None):
    """labels (..., N): -1 ignore, ``bg_label`` background, else foreground.
    Returns (idx (..., num_samples) int64 into labels, arbitrary where
    invalid; valid (..., num_samples) bool). num_pos = min(#pos,
    int(num_samples * positive_fraction)), num_neg = min(#neg, num_samples -
    num_pos), both uniformly chosen. ``draws``: the (positive, negative)
    uniform keys shaped like labels, or their source (``draw``)."""
    if not isinstance(draws, tuple):
        draws = draw(draws, labels.shape, labels.device)
    rp, rn = draws
    neg_one = torch.tensor(-1.0, device=labels.device)
    pos_mask = (labels != -1) & (labels != bg_label)
    neg_mask = labels == bg_label
    # d2's cap is int(num_samples * positive_fraction) exactly; the sort
    # takes at least one
    cap_pos = int(num_samples * positive_fraction)
    k_pos = max(cap_pos, 1)
    pos_scores, pos_idx = _top_k(torch.where(pos_mask, rp, neg_one), k_pos)
    pos_sel = pos_scores > 0 if cap_pos > 0 else torch.zeros_like(pos_scores, dtype=torch.bool)
    num_pos = pos_sel.sum(dim=-1, keepdim=True)
    num_neg = torch.minimum(neg_mask.sum(dim=-1, keepdim=True), num_samples - num_pos)
    neg_scores, neg_idx = _top_k(torch.where(neg_mask, rn, neg_one), num_samples)
    ar = torch.arange(num_samples, device=labels.device)
    neg_sel = (neg_scores > 0) & (ar < num_neg)
    # compact the (cap + num_samples) candidates into num_samples slots:
    # positives first, then negatives, the lowest index first among equals
    all_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    score = torch.cat([pos_sel.float() * 2.0, neg_sel.float()], dim=-1)
    top, sel = _top_k(score, num_samples)
    return torch.gather(all_idx, -1, sel), top > 0
