"""Greedy NMS keep mask on the card: ``csrc/nms.cu``.

Not the port of a TPU kernel: ``afigan_tpu/ops/nms.py::nms_keep_mask`` is
XLA code in the JAX package. Its plain version is the blocked loop of
``ops/nms.py`` (``nms_keep_sorted_plain`` here applies it image by image),
and ``ops/nms.py`` routes CPU tensors there and CUDA tensors here. This
entry launches the kernel or raises; it never falls back to the loop.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import LAUNCHES


def nms_keep_sorted(boxes, valid, order, iou_threshold: float, stop_after: int = 0):
    """boxes (B, N, 4) float32; valid (B, N) bool; order (B, N) int64, each
    image's stable score-descending permutation (invalid boxes last) → keep
    (B, N) bool in sorted order: greedy NMS, ``IoU > iou_threshold``
    suppresses, invalid boxes never suppress. With ``stop_after > 0`` the
    walk stops once that many boxes are kept and later entries are False.
    CUDA tensors only: one C call, two kernel launches, no host sync."""
    devs = {t.device.type for t in (boxes, valid, order)}
    if devs != {"cuda"} or len({t.device for t in (boxes, valid, order)}) != 1:
        raise ValueError(f"nms_keep_sorted launches a CUDA kernel: tensors on {devs}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be float32 (B, N, 4), got {tuple(boxes.shape)} "
                         f"{boxes.dtype}")
    b, n = boxes.shape[:2]
    if tuple(valid.shape) != (b, n) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be bool {(b, n)}, got {tuple(valid.shape)} {valid.dtype}")
    if tuple(order.shape) != (b, n) or order.dtype != torch.int64:
        raise ValueError(f"order must be int64 {(b, n)}, got {tuple(order.shape)} {order.dtype}")
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    if b * n == 0:
        return keep
    words = -(-n // 64)
    mask = torch.empty((b, n, words), dtype=torch.int64, device=boxes.device)
    bx, vd, od = boxes.contiguous(), valid.contiguous(), order.contiguous()
    rc = _build.load("nms").nms_forward(
        bx.data_ptr(), vd.data_ptr(), od.data_ptr(), float(iou_threshold), b, n,
        int(stop_after), mask.data_ptr(), keep.data_ptr(), _build.stream_ptr())
    _build.check(rc, "nms_forward")
    LAUNCHES["nms"] += 1
    return keep


def nms_keep_sorted_plain(boxes, valid, order, iou_threshold: float, stop_after: int = 0):
    """``nms_keep_sorted``'s function by the blocked plain loop, image by
    image, on any device (the tests' and ``chip_smoke.py``'s reference on the
    card). Where ``stop_after`` ends the loop early, the tail of the mask is
    left unresolved instead of False."""
    from .. import nms

    return torch.stack([nms.blocked_keep(boxes[i][order[i]], valid[i][order[i]].clone(),
                                         iou_threshold, stop_after=stop_after)
                        for i in range(boxes.shape[0])])
