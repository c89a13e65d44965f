"""Seeded inputs of the NMS contract (numpy only; not collected by pytest).

Shared by the CPU tests (the blocked loop against a greedy loop) and the
tests on the card (``csrc/nms.cu`` against the blocked loop). Each case is
(boxes (N, 4) float32, scores (N,) float32, valid (N,) bool, class or level
index (N,) int32, IoU threshold, max_out).
"""

import numpy as np


def _scatter(rng, n, canvas, clusters):
    """Boxes in jittered clusters over a canvas (h, w), so that many pairs
    overlap above any threshold: sizes 8-600 px, aspect up to 4:1."""
    h, w = canvas
    ctr = rng.rand(clusters, 2) * [w, h]
    size = np.exp(rng.rand(clusters) * np.log(600 / 8)) * 8
    ar = np.exp((rng.rand(clusters) * 2 - 1) * np.log(4))
    k = rng.randint(0, clusters, n)
    bw = size[k] * np.sqrt(ar[k]) * np.exp(rng.randn(n) * 0.1)
    bh = size[k] / np.sqrt(ar[k]) * np.exp(rng.randn(n) * 0.1)
    cx = ctr[k, 0] + rng.randn(n) * 0.1 * bw
    cy = ctr[k, 1] + rng.randn(n) * 0.1 * bh
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1).astype(np.float32)


def _at_threshold(rng, groups):
    """IoU 0.6 exactly in float32 (inter 3 / union 5, width-4 boxes one
    apart), which must not suppress at a threshold of 0.6 (nor in a float64
    comparison with 0.6, which float32(0.6) exceeds), and 3.5 / 4.5, which
    must: three boxes a group, the groups apart."""
    x = rng.randint(0, 1000, groups).astype(np.float32)
    y = (np.arange(groups) * 4).astype(np.float32)
    rows = []
    for dx in (0.0, 1.0, 0.5):
        rows.append(np.stack([x + dx, y, x + dx + 4, y + 1], 1))
    return np.stack(rows, 1).reshape(-1, 4).astype(np.float32)


def nms_case(name, seed=0):
    rng = np.random.RandomState(seed)
    if name.startswith("n"):  # n1, n63, ...: ragged sizes around the 64-box tile
        n = int(name[1:])
        boxes = _scatter(rng, n, (200, 300), max(1, n // 8))
        scores = np.round(rng.rand(n), 2).astype(np.float32)
        return boxes, scores, rng.rand(n) > 0.1, np.zeros(n, np.int32), 0.5, n
    if name == "ties":  # few distinct scores
        n = 300
        boxes = _scatter(rng, n, (200, 300), 30)
        scores = np.round(rng.rand(n), 1).astype(np.float32)
        return boxes, scores, rng.rand(n) > 0.1, np.zeros(n, np.int32), 0.5, n
    if name == "all_invalid":
        n = 100
        boxes = _scatter(rng, n, (200, 300), 10)
        return (boxes, rng.rand(n).astype(np.float32), np.zeros(n, bool),
                np.zeros(n, np.int32), 0.5, n)
    if name == "at_threshold":
        boxes = _at_threshold(rng, 70)
        n = len(boxes)
        # the first box of a group ranks before the third (ties: lower index
        # first), so each group keeps its first two boxes
        scores = np.round(rng.rand(n // 3, 3), 2).astype(np.float32)
        scores[:, 0] = scores.max(1)
        return boxes, scores.reshape(-1), np.ones(n, bool), np.zeros(n, np.int32), 0.6, n
    if name == "class_offsets":  # overlapping boxes of 5 classes
        n = 700
        boxes = _scatter(rng, n, (200, 300), 20)
        scores = np.round(rng.rand(n), 2).astype(np.float32)
        return (boxes, scores, rng.rand(n) > 0.2, rng.randint(0, 5, n).astype(np.int32),
                0.5, 100)
    # the main paths' sizes at an 832x1344 canvas: RPN 1000 a level over p2-p6
    # (819 anchors on p6), its level as the index; FCOS 1000 a level over p3-p7;
    # the detection candidate pool of the box head
    if name == "rpn":
        n = 4 * 1000 + 819
        boxes = _scatter(rng, n, (832, 1344), 300)
        scores = np.round(rng.randn(n), 3).astype(np.float32)
        lv = np.repeat(np.arange(5), [1000, 1000, 1000, 1000, 819]).astype(np.int32)
        return boxes, scores, rng.rand(n) > 0.02, lv, 0.7, 1000
    if name == "fcos":
        n = 5000
        boxes = _scatter(rng, n, (832, 1344), 200)
        scores = np.round(rng.rand(n), 3).astype(np.float32)
        return (boxes, scores, rng.rand(n) > 0.5, rng.randint(0, 80, n).astype(np.int32),
                0.6, 100)
    if name == "detection":
        n = 4096
        boxes = _scatter(rng, n, (832, 1344), 100)
        scores = np.round(rng.rand(n), 3).astype(np.float32)
        return (boxes, scores, scores > 0.3, rng.randint(0, 80, n).astype(np.int32), 0.5, 100)
    raise KeyError(name)


CPU_CASES = ("n1", "n63", "n64", "n65", "n300", "ties", "all_invalid", "at_threshold")
CARD_CASES = ("rpn", "fcos", "detection", "ties", "n65", "n1000", "all_invalid",
              "at_threshold", "class_offsets")


def greedy_keep(boxes_sorted, valid_sorted, iou_threshold, stop_after=0):
    """Greedy NMS over boxes already in score order, in numpy float32 with
    the IoU of ``ops/boxes.py::pairwise_iou`` operation for operation."""
    b = boxes_sorted.astype(np.float32)
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[..., 0] * wh[..., 1]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area[:, None] + area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / np.maximum(union, np.float32(1e-12)), np.float32(0))
    thr = np.float32(iou_threshold)
    n = len(b)
    keep = np.zeros(n, bool)
    for i in range(n):
        if valid_sorted[i] and not (keep[:i] & (iou[:i, i] > thr)).any():
            keep[i] = True
            if stop_after and keep.sum() >= stop_after:
                break
    return keep
