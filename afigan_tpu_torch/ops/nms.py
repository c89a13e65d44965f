"""Fixed-shape non-maximum suppression (counterpart of
``afigan_tpu/ops/nms.py``, which is XLA code in the JAX package).

Scores are sorted descending with a STABLE sort (lowest index first among
ties; invalid entries last). Then, by the device of the boxes:

- CPU tensors: the JAX package's blocked algorithm in plain torch, so keep
  masks are equal entry for entry. Blocks of ``block_size``: inside a block
  suppression is resolved by the self-suppression fixpoint, and a resolved
  block suppresses every later box in one vectorized step. The host reads
  the device once per block and once per fixpoint sweep.
- CUDA tensors: ``ops/kernels/nms.py`` (``csrc/nms.cu``), greedy NMS in
  score order, the fixpoint's unique solution, with no host sync. A build or
  launch failure raises; there is no fallback to the loop.

``stop_after`` stops once that many boxes are kept; keep decisions have a
prefix property, so the top ``stop_after`` survivors are exact. The tail
of the mask is left unresolved (the loop, as in JAX) or False (the kernel).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import pairwise_iou
from .kernels.nms import nms_keep_sorted

_NEG_INF = -1.0e10
_BLOCK_SIZE = 128


def nms_keep_mask(boxes, scores, iou_threshold: float, valid=None,
                  block_size: int = _BLOCK_SIZE, stop_after: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (order (N,) int64 score-descending, keep_sorted (N,) bool)."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    s = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
    order = torch.sort(-s, stable=True).indices
    if dev.type == "cuda":
        keep = nms_keep_sorted(boxes[None], valid[None], order[None], iou_threshold,
                               stop_after)[0]
    else:
        keep = blocked_keep(boxes[order], valid[order].clone(), iou_threshold,
                            block_size, stop_after)
    return order, keep


def blocked_keep(boxes_s, keep, iou_threshold: float, block_size: int = _BLOCK_SIZE,
                 stop_after: int = 0):
    """The plain blocked loop over sorted boxes (N, 4) and their validity
    ``keep`` (N,) bool, which it updates in place and returns."""
    n = boxes_s.shape[0]
    dev = boxes_s.device
    bs = min(block_size, n)
    nb = -(-n // bs)
    col = torch.arange(bs, device=dev)
    upper = col[None, :] > col[:, None]
    pos = torch.arange(n, device=dev)
    kept = 0
    for k in range(nb):
        if stop_after > 0 and kept >= stop_after:
            break
        start = min(k * bs, n - bs)
        blk_keep = keep[start:start + bs]
        iou_bn = pairwise_iou(boxes_s[start:start + bs], boxes_s)  # (bs, N)
        supp = (iou_bn[:, start:start + bs] > iou_threshold) & upper
        kb = blk_keep
        while True:
            kb_new = blk_keep & ~torch.any(kb[:, None] & supp, dim=0)
            if torch.equal(kb_new, kb):
                break
            kb = kb_new
        keep[start:start + bs] = kb
        later = pos >= start + bs
        keep &= ~(torch.any(kb[:, None] & (iou_bn > iou_threshold), dim=0) & later)
        if stop_after > 0:
            fresh = (start + col) >= k * bs
            kept += int((kb & fresh).sum())
    return keep


def nms_padded(boxes, scores, iou_threshold: float, max_out: int, valid=None,
               block_size: int = _BLOCK_SIZE):
    """Top-``max_out`` survivors: (boxes (K,4), scores (K,), idx (K,),
    valid (K,)), padded with invalid entries."""
    order, keep_sorted = nms_keep_mask(boxes, scores, iou_threshold, valid,
                                       block_size, stop_after=max_out)
    n = keep_sorted.shape[0]
    k = min(max_out, n)
    # survivors to the front in score order (stable, like lax.top_k)
    sel = torch.sort(keep_sorted.to(torch.int32), descending=True,
                     stable=True).indices[:k]
    out_valid = keep_sorted[sel]
    orig = order[sel]
    out_boxes = boxes[orig]
    out_scores = torch.where(out_valid, scores[orig],
                             torch.full_like(scores[orig], _NEG_INF))
    if k < max_out:
        pad = max_out - k
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros((pad, 4))])
        out_scores = torch.cat([out_scores, out_scores.new_full((pad,), _NEG_INF)])
        orig = torch.cat([orig, orig.new_zeros((pad,))])
        out_valid = torch.cat([out_valid, out_valid.new_zeros((pad,))])
    return out_boxes, out_scores, orig, out_valid


def batched_nms_padded(boxes, scores, idxs, iou_threshold: float,
                       max_out: int, valid=None,
                       block_size: int = _BLOCK_SIZE):
    """Category-aware NMS via the coordinate-offset trick."""
    if boxes.shape[0] == 0:
        raise ValueError("batched_nms_padded requires non-empty input")
    max_coord = boxes.max() + 1.0
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord)[:, None]
    _, osc, oi, ov = nms_padded(shifted, scores, iou_threshold, max_out, valid,
                                block_size)
    return boxes[oi], osc, oi, ov
