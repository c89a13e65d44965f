"""Multi-level ROIAlign poolers (counterpart of ``afigan_tpu/ops/roi_align.py``).

Same numerics as the JAX package's poolers: a fixed S x S sampling grid
per bin (default 2x2), ``aligned=True`` (ROIAlignV2, -0.5 pixel shift),
d2 border handling, and FPN level routing at canonical size 224 / level 4.
All take per-level (B, H_l, W_l, C) maps and (B, R, 4) boxes and return
(B, R, P, P, C) float32. Routing, window geometry and the interpolation
products are plain torch (XLA code outside the kernels in JAX).

``pool_rois`` is the ``TPU.POOLER_IMPL`` dispatch of every head:

=========  ==============================================================
pallas     ``multilevel_roi_align_pallas``: ``ops/kernels/roi_pool.py``
           (``csrc/roi_pool.cu`` on the card, forward and backward), exact
           for every ROI, any C
windowed   ``multilevel_roi_align_windowed``: one window per ROI out of the
           row-concatenated pyramid (``ops/kernels/window_gather.py``,
           ``csrc/window_gather.cu`` on the card) and two interpolation
           products; at most ``overflow_slots`` ROIs per image whose samples
           leave the window are recomputed exactly
fast       ``multilevel_roi_align_fast``: the windowed forward; under
           autograd the backward of JAX's custom VJP, the exact point
           scatter of every sample (``_pooler_scatter_bwd``)
gather     ``multilevel_roi_align``: the plain per-point gather
=========  ==============================================================

``fast`` has a training route, picked by mode (grad enabled and a level that
requires grad), never by a failure: ``WindowedPool``, whose forward is the
windowed one (run with grad off, so its copy kernel launches on the card) and
whose backward is the exact pool's, ``roi_pool_backward`` (``csrc/roi_pool.cu``
on the card). ``windowed`` under autograd differentiates its products (JAX's
``windowed``) on CPU tensors; on the card its copy kernel refuses autograd.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .kernels import roi_pool as pool_kernel
from .kernels.roi_pool import RoIPool, roi_pool_plain
from .kernels.window_gather import gather_windows

POOLER_IMPLS = ("pallas", "fast", "windowed", "gather")


def assign_boxes_to_levels(boxes, min_level: int, max_level: int,
                           canonical_size: float = 224.0,
                           canonical_level: int = 4):
    """FPN level router (d2 assign_boxes_to_levels) → int level - min_level."""
    area = torch.clamp((boxes[..., 2] - boxes[..., 0])
                       * (boxes[..., 3] - boxes[..., 1]), min=0.0)
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).to(torch.int32) - min_level


def _route(features, boxes, strides):
    min_level = int(math.log2(strides[0]))
    boxes = boxes.float()
    return boxes, assign_boxes_to_levels(boxes, min_level,
                                         min_level + len(features) - 1)


def multilevel_roi_align_pallas(features: Sequence[torch.Tensor], boxes,
                                strides: Sequence[int], output_size: int,
                                sampling_ratio: int = 2, aligned: bool = True):
    """The pool kernel on CUDA tensors (its plain version on CPU tensors),
    differentiable in the levels: under autograd its backward is the pool's
    backward kernel (``RoIPool``; the boxes get no gradient)."""
    boxes, levels = _route(features, boxes.detach(), strides)
    return RoIPool.apply(boxes, levels, tuple(strides), output_size, sampling_ratio,
                         aligned, *features)


def multilevel_roi_align(features: Sequence[torch.Tensor], boxes,
                         strides: Sequence[int], output_size: int,
                         sampling_ratio: int = 2, aligned: bool = True):
    """The per-point gather form, plain torch on any device."""
    boxes, levels = _route(features, boxes, strides)
    return roi_pool_plain(list(features), boxes, levels, strides, output_size,
                          sampling_ratio, aligned)


def default_window(features: Sequence[torch.Tensor]) -> int:
    """Window edge of the windowed pooler: 48, or the coarsest level's larger
    side + 2 if that is more, rounded up to a multiple of 8."""
    top_extent = max(features[-1].shape[1], features[-1].shape[2]) + 2
    return int(math.ceil(max(48, top_extent) / 8) * 8)


def _axis_matrix(coords, size, win_start, window: int, p: int, s: int):
    """(N, P*S) absolute sample coords → (N, P, window) interpolation matrix
    (the S samples of a bin averaged) and the per-ROI largest window-relative
    coordinate. d2 border handling: a sample outside [-1, size] weighs zero,
    the others clamp to [0, size - 1]."""
    sz = size[:, None].to(coords.dtype)
    valid = (coords >= -1.0) & (coords <= sz)
    cl = torch.minimum(torch.clamp(coords, min=0.0), sz - 1)
    rel = cl - win_start[:, None].to(coords.dtype)
    k = torch.arange(window, dtype=coords.dtype, device=coords.device)
    a = torch.clamp(1.0 - torch.abs(rel[:, :, None] - k), min=0.0)
    a = a * valid[:, :, None]
    return a.reshape(-1, p, s, window).mean(dim=2), rel.max(dim=1).values


def _window_geometry(feats, boxes, strides, p: int, s: int, aligned: bool, window: int):
    """Per flattened ROI (N = B*R): level (B, R), row base of its level in the
    concatenated pyramid, window starts (wy, wx), the two interpolation
    matrices (N, P, window) in float32, and whether its clamped sample span
    leaves the window (B, R)."""
    b, r = boxes.shape[:2]
    n, dev = b * r, boxes.device
    heights = [f.shape[1] for f in feats]
    widths = [f.shape[2] for f in feats]
    pad_h = [max(h, window) for h in heights]
    row_base = [sum(pad_h[:i]) for i in range(len(feats))]
    boxes, levels = _route(feats, boxes, strides)
    bx = boxes.reshape(n, 4)
    lv = levels.reshape(n).long()

    def per_roi(values, dt):
        return torch.tensor(values, dtype=dt, device=dev)[lv]

    scales = per_roi([1.0 / st for st in strides], torch.float32)
    lvl_h, lvl_w = per_roi(heights, torch.int64), per_roi(widths, torch.int64)

    off = 0.5 if aligned else 0.0
    x1, y1 = bx[:, 0] * scales - off, bx[:, 1] * scales - off
    x2, y2 = bx[:, 2] * scales - off, bx[:, 3] * scales - off
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev)[None, :] + 0.5) / s
            ).reshape(-1)
    ys = y1[:, None] + grid[None, :] * (roi_h / p)[:, None]
    xs = x1[:, None] + grid[None, :] * (roi_w / p)[:, None]

    def win_start(coords, size):  # clamped so that the window stays in the level
        lo = torch.floor(coords.min(dim=1).values).long() - 1
        hi = torch.clamp(size - window, min=0)
        return torch.minimum(torch.clamp(lo, min=0), hi)

    wy, wx = win_start(ys, lvl_h), win_start(xs, lvl_w)
    ry, max_rel_y = _axis_matrix(ys, lvl_h, wy, window, p, s)
    rx, max_rel_x = _axis_matrix(xs, lvl_w, wx, window, p, s)
    overflow = ((max_rel_y > window - 1.0) | (max_rel_x > window - 1.0)).reshape(b, r)
    return levels, per_roi(row_base, torch.int64), wy, wx, ry, rx, overflow


def multilevel_roi_align_windowed(features: Sequence[torch.Tensor], boxes,
                                  strides: Sequence[int], output_size: int,
                                  sampling_ratio: int = 2, aligned: bool = True,
                                  window: int = 0, overflow_slots: int = 64,
                                  return_overflow: bool = False):
    """ROIAlign as one (window, window, C) copy per ROI and two interpolation
    products, ``out[n] = Ry[n] @ win[n] @ Rx[n]^T``: the counterpart of the JAX
    ``multilevel_roi_align_windowed``, batched over images (the batch is one
    window extraction: images are stacked along the rows of the concatenated
    pyramid). The levels are laid under one another, each zero-padded to width
    Wmax and height >= window; rows past a level's height get zero weight.

    Per image, the first ``overflow_slots`` ROIs whose clamped sample span
    leaves the window are recomputed exactly by ``roi_pool``; further ones keep
    their truncated values, as in JAX. With ``return_overflow`` the result is
    (pooled, overflow (B, R) bool), every ROI whose span leaves the window.
    """
    feats = list(features)
    b, _, _, c = feats[0].shape
    r = boxes.shape[1]
    n = b * r
    p, s = output_size, sampling_ratio
    dtype, dev = feats[0].dtype, feats[0].device
    if n == 0:
        out = torch.zeros((b, r, p, p, c), dtype=torch.float32, device=dev)
        return (out, out.new_zeros((b, r), dtype=torch.bool)) if return_overflow else out
    if window <= 0:
        window = default_window(feats)
    wmax = max(max(f.shape[2] for f in feats), window)
    sum_h = sum(max(f.shape[1], window) for f in feats)
    concat = torch.zeros((b, sum_h, wmax, c), dtype=dtype, device=dev)
    base = 0
    for f in feats:
        concat[:, base:base + f.shape[1], :f.shape[2]] = f
        base += max(f.shape[1], window)

    boxes = boxes.float()
    levels, lvl_base, wy, wx, ry, rx, overflow = _window_geometry(
        feats, boxes, strides, p, s, aligned, window)
    image = torch.arange(b, device=dev).repeat_interleave(r)
    windows = gather_windows(concat.view(b * sum_h, wmax, c),
                             lvl_base + wy + image * sum_h, wx, window)
    # first product accumulates in float32 and rounds to the feature dtype;
    # the second runs on those values in float32 (products of bfloat16 values
    # are exact there) and is returned in float32
    tmp = torch.bmm(ry.to(dtype), windows.view(n, window, window * c))
    out = torch.matmul(rx.to(dtype).float()[:, None], tmp.view(n, p, window, c).float())
    out = out.reshape(b, r, p, p, c)

    if overflow_slots > 0:
        k = min(int(overflow_slots), r)
        # overflowing ROIs first, the lowest index first among equals
        sel = torch.sort(overflow.to(torch.int32), dim=1, descending=True,
                         stable=True).indices[:, :k]
        sel_boxes = torch.gather(boxes, 1, sel[:, :, None].expand(b, k, 4))
        # through the module, as the pallas route's RoIPool calls it
        corrected = pool_kernel.roi_pool(feats, sel_boxes, torch.gather(levels, 1, sel),
                                         strides, p, s, aligned)
        rows = torch.arange(b, device=dev)[:, None]
        take = torch.gather(overflow, 1, sel)[:, :, None, None, None]
        out[rows, sel] = torch.where(take, corrected, out[rows, sel])
    return (out, overflow) if return_overflow else out


class WindowedPool(torch.autograd.Function):
    """The ``fast`` pooler under autograd (JAX's ``_fast_fwd`` / ``_fast_bwd``):
    the windowed forward (autograd runs it with grad off, so the copy and the
    overflow pool launch their kernels on the card); the backward the exact
    pool's adjoint, ``roi_pool_backward`` (the kernel on the card, the plain
    scatter on the CPU). The boxes get no gradient."""

    @staticmethod
    def forward(ctx, boxes, strides, output_size, sampling_ratio, aligned, *features):
        ctx.save_for_backward(boxes, *features)
        ctx.args = (tuple(strides), output_size, sampling_ratio, aligned)
        return multilevel_roi_align_windowed(features, boxes, strides, output_size,
                                             sampling_ratio, aligned)

    @staticmethod
    def backward(ctx, grad):
        boxes, *features = ctx.saved_tensors
        strides = ctx.args[0]
        boxes, levels = _route(features, boxes, strides)
        grads = pool_kernel.roi_pool_backward(features, boxes, levels, grad.float(), *ctx.args)
        return (None,) * 5 + tuple(grads)


def multilevel_roi_align_fast(features: Sequence[torch.Tensor], boxes,
                              strides: Sequence[int], output_size: int,
                              sampling_ratio: int = 2, aligned: bool = True):
    """The counterpart of JAX's ``multilevel_roi_align_fast``: the windowed
    forward, and on the training route ``WindowedPool``'s scatter backward."""
    if torch.is_grad_enabled() and any(f.requires_grad for f in features):
        return WindowedPool.apply(boxes.detach(), tuple(strides), output_size,
                                  sampling_ratio, aligned, *features)
    return multilevel_roi_align_windowed(features, boxes, strides, output_size,
                                         sampling_ratio, aligned)


def pool_rois(impl: str, features: Sequence[torch.Tensor], boxes,
              strides: Sequence[int], output_size: int, sampling_ratio: int = 2,
              aligned: bool = True):
    """``TPU.POOLER_IMPL`` → pooler. ``pallas`` takes any channel count (the
    JAX package's fall-back to ``fast`` at C % 128 != 0 is a TPU layout rule);
    ``fast`` and ``windowed`` are one function at inference."""
    if impl == "pallas":
        fn = multilevel_roi_align_pallas
    elif impl == "fast":
        fn = multilevel_roi_align_fast
    elif impl == "windowed":
        fn = multilevel_roi_align_windowed
    elif impl == "gather":
        fn = multilevel_roi_align
    else:
        raise ValueError(f"TPU.POOLER_IMPL {impl!r}: one of {POOLER_IMPLS}")
    return fn(features, boxes, strides, output_size, sampling_ratio, aligned)
