"""Test-time augmentation, multi-scale + flip (counterpart of
``afigan_tpu/engine/tta.py``, d2 ``GeneralizedRCNNWithTTA`` semantics).

The detector runs at every ``TEST.AUG.MIN_SIZES`` (capped by
``TEST.AUG.MAX_SIZE``), and on the horizontal flip of each under
``TEST.AUG.FLIP``. Every pass's detections are mapped back to the original
image (``rescale_boxes``, then ``hflip_boxes`` at the original width for a
flipped pass) and accumulated per image, scale outer and the unflipped pass
before the flipped one: the merge sorts stably by score, so that order breaks
its ties. The merge is a class-aware NMS (``batched_nms_padded``, on a CUDA
tensor ``csrc/nms.cu``) keeping ``TEST.DETECTIONS_PER_IMAGE``. With
``MODEL.MASK_ON`` the mask branch then runs on the merged boxes under every
(scale, flip) pass and the mask probabilities are averaged (a flipped pass's
masks mirrored back on their last axis) before they are pasted.

The loop order is the JAX package's: scales outer, images inner, items of
one canvas batched ``TPU.TTA_BATCH`` at a time (capped by
``TPU.TTA_PIXEL_BUDGET``; a partial batch is padded with its first item,
whose extra results are dropped). Each batch's results come to the host once.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.coco import read_image
from ..data.loader import choose_bucket, required_size_divisibility
from ..data.transforms import hflip_boxes, test_transform
from ..evaluation import CocoEvaluator
from ..models.box_head import Detections
from ..ops.image_list import pad_to_canvas
from ..ops.nms import batched_nms_padded
from .inference import paste_masks, rescale_boxes

logger = logging.getLogger("afigan_tpu_torch")


def _canvas(cfg, h: int, w: int) -> Tuple[int, int]:
    return choose_bucket(h, w, cfg.TPU.IMAGE_BUCKETS, required_size_divisibility(cfg))


def _tta_variants(cfg, img) -> List[Tuple[np.ndarray, bool]]:
    """All (resized image, flipped) variants of ``img``: one resize per
    MIN_SIZE, the flip a mirror of it."""
    oh, ow = img.shape[:2]
    out = []
    for min_size in cfg.TEST.AUG.MIN_SIZES:
        resized = test_transform(oh, ow, min_size, cfg.TEST.AUG.MAX_SIZE).apply_image(img)
        out.append((resized, False))
        if cfg.TEST.AUG.FLIP:
            out.append((np.ascontiguousarray(resized[:, ::-1]), True))
    return out


def _scaled_boxes(boxes: np.ndarray, rh: int, rw: int, oh: int, ow: int,
                  flipped: bool) -> np.ndarray:
    """Merged boxes (original coordinates) → one pass's resized image,
    flipped at its width for a flipped pass."""
    sb = boxes.copy()
    sb[:, 0::2] *= rw / ow
    sb[:, 1::2] *= rh / oh
    return hflip_boxes(sb, rw) if flipped else sb


def _forward(model, images: np.ndarray, sizes, given_dets: Optional[Detections] = None):
    """One batch on the model's device: (Detections, masks or None)."""
    dev = next(model.parameters()).device
    images = torch.as_tensor(np.ascontiguousarray(images)).to(dev)
    sizes = torch.as_tensor(np.asarray(sizes, np.int32)).to(dev)
    with torch.inference_mode():
        if given_dets is None:
            return model(images, sizes)
        given = Detections(*(torch.as_tensor(a).to(dev) for a in given_dets))
        return model(images, sizes, given_dets=given)


def averaged_tta_masks(cfg, model, img, merged_boxes, merged_scores, merged_classes,
                       merged_valid, variants=None) -> Tuple[np.ndarray, int]:
    """The mask branch on the MERGED boxes under every (scale, flip) variant,
    probabilities averaged: ((D, S, S), number of variants). ``variants``:
    [(resized image, flipped)] already built for the detection passes."""
    oh, ow = img.shape[:2]
    variants = _tta_variants(cfg, img) if variants is None else variants
    if not variants:
        raise ValueError("TEST.AUG.MIN_SIZES must be non-empty for TTA")
    prob_sum = None
    for image_v, flipped in variants:
        rh, rw = image_v.shape[:2]
        padded = pad_to_canvas(image_v.astype(np.float32), _canvas(cfg, rh, rw))
        sb = _scaled_boxes(merged_boxes, rh, rw, oh, ow, flipped)
        dets = tuple(a[None] for a in (sb, merged_scores, merged_classes, merged_valid))
        _, masks = _forward(model, padded[None], [[rh, rw]], dets)
        m = masks[0].float().cpu().numpy()  # (D, S, S) probabilities
        if flipped:  # a flipped pass's mask is the mirror of the original crop
            m = m[:, :, ::-1]
        prob_sum = m if prob_sum is None else prob_sum + m
    return prob_sum / len(variants), len(variants)


def tta_batch_for_canvas(cfg, canvas) -> int:
    """Images per TTA batch at this canvas: TPU.TTA_BATCH capped so that
    batch * canvas pixels <= TPU.TTA_PIXEL_BUDGET (at least 1)."""
    cap = max(1, int(cfg.TPU.TTA_BATCH))
    budget = int(cfg.TPU.TTA_PIXEL_BUDGET)
    return max(1, min(cap, budget // (int(canvas[0]) * int(canvas[1]))))


class _BatchedDispatcher:
    """Groups same-canvas items into batches of ``tta_batch_for_canvas``
    and hands each item's share of a batch's results to ``done_fn`` in the
    order the batches run. At most one partial batch per canvas is held."""

    def __init__(self, cfg, run_fn: Callable, done_fn: Callable):
        self._cfg = cfg
        self._run = run_fn    # (canvas, images (B,H,W,3), sizes (B,2), metas) → host result
        self._done = done_fn  # (meta, the item's result)
        self._buf: Dict[Tuple[int, int], Tuple[list, list, list]] = {}

    def add(self, canvas, padded, size_hw, meta) -> None:
        metas, imgs, sizes = self._buf.setdefault(tuple(canvas), ([], [], []))
        metas.append(meta)
        imgs.append(padded)
        sizes.append(size_hw)
        if len(metas) >= tta_batch_for_canvas(self._cfg, canvas):
            self._flush(tuple(canvas))

    def _flush(self, canvas) -> None:
        metas, imgs, sizes = self._buf.pop(canvas)
        n_real = len(metas)
        while len(imgs) < tta_batch_for_canvas(self._cfg, canvas):
            imgs.append(imgs[0])
            sizes.append(sizes[0])
            metas.append(metas[0])
        out = self._run(canvas, np.stack(imgs), np.asarray(sizes, np.int32), metas)
        for j, meta in enumerate(metas[:n_real]):
            self._done(meta, [a[j] for a in out])

    def finish(self) -> None:
        for canvas in list(self._buf):
            self._flush(canvas)


def _sweep(cfg, records, run_fn, done_fn, item_fn) -> None:
    """Scales outer, images inner: each image read and resized once a scale,
    its unflipped pass before its flipped one. ``item_fn(i, (rh, rw),
    flipped)`` → the item's meta."""
    flips = (False, True) if cfg.TEST.AUG.FLIP else (False,)
    disp = _BatchedDispatcher(cfg, run_fn, done_fn)
    for min_size in cfg.TEST.AUG.MIN_SIZES:
        for i, rec in enumerate(records):
            img = read_image(rec["file_name"], cfg.INPUT.FORMAT)
            oh, ow = img.shape[:2]
            resized = test_transform(oh, ow, min_size, cfg.TEST.AUG.MAX_SIZE).apply_image(img)
            rh, rw = resized.shape[:2]
            canvas = _canvas(cfg, rh, rw)
            for flipped in flips:
                image_v = np.ascontiguousarray(resized[:, ::-1]) if flipped else resized
                padded = pad_to_canvas(image_v.astype(np.float32), canvas)
                disp.add(canvas, padded, (rh, rw), item_fn(i, (oh, ow), (rh, rw), flipped))
    disp.finish()


def _host(dets: Detections) -> List[np.ndarray]:
    return [dets.boxes.float().cpu().numpy(), dets.scores.float().cpu().numpy(),
            dets.classes.cpu().numpy(), dets.valid.cpu().numpy()]


def run_tta_inference(cfg, model, dataset, max_images: Optional[int] = None
                      ) -> Dict[str, Dict[str, float]]:
    """Multi-scale + flip TTA evaluation of ``model`` (on its own device)
    over ``dataset``: COCO bbox (and, with MASK_ON, segm) AP."""
    if cfg.MODEL.KEYPOINT_ON:  # d2 GeneralizedRCNNWithTTA has no keypoint TTA
        raise ValueError("TTA for keypoints is not supported")
    tasks = ("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",)
    evaluator = CocoEvaluator(dataset, tasks=tasks)
    records = list(dataset.records)[:max_images]
    n_rec = len(records)
    acc = [([], [], [], []) for _ in range(n_rec)]  # boxes / scores / classes / valid
    orig_hw: List[Tuple[int, int]] = [(0, 0)] * n_rec

    # ---- detection sweep ----
    def det_item(i, ohw, rhw, flipped):
        orig_hw[i] = ohw
        return i, rhw, flipped

    def det_done(meta, dets):
        i, (rh, rw), flipped = meta
        oh, ow = orig_hw[i]
        boxes = rescale_boxes(dets[0], (rh, rw), (oh, ow))
        if flipped:
            boxes = hflip_boxes(boxes, ow)
        for store, a in zip(acc[i], [boxes] + dets[1:]):
            store.append(a)

    _sweep(cfg, records, lambda canvas, imgs, sizes, metas: _host(_forward(model, imgs, sizes)[0]),
           det_done, det_item)

    # ---- per-image merge: class-aware NMS over every pass's detections ----
    dev = next(model.parameters()).device
    merged = []
    for n in range(n_rec):
        boxes, scores, classes, valid = (np.concatenate(a) for a in acc[n])
        b, s, c, v = (torch.as_tensor(a).to(dev) for a in (boxes, scores, classes, valid))
        mb, ms, mi, mv = batched_nms_padded(b, s, c, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                                            cfg.TEST.DETECTIONS_PER_IMAGE, valid=v)
        mi = mi.cpu().numpy()
        merged.append((mb.cpu().numpy(), ms.cpu().numpy(), classes[mi], mv.cpu().numpy()))

    # ---- mask fusion sweep over the merged boxes ----
    full_masks: List[Optional[list]] = [None] * n_rec
    if cfg.MODEL.MASK_ON:
        prob_sum: List[Optional[np.ndarray]] = [None] * n_rec
        n_aug = [0] * n_rec

        def mask_item(i, ohw, rhw, flipped):
            (oh, ow), (rh, rw) = ohw, rhw
            mb, ms, mc, mv = merged[i]
            return i, flipped, (_scaled_boxes(mb, rh, rw, oh, ow, flipped), ms, mc, mv)

        def mask_run(canvas, imgs, sizes, metas):
            dets = tuple(np.stack([m[2][k] for m in metas]) for k in range(4))
            return [_forward(model, imgs, sizes, dets)[1].float().cpu().numpy()]

        def mask_done(meta, out):
            i, flipped, _ = meta
            m = out[0][:, :, ::-1] if flipped else out[0]
            prob_sum[i] = m if prob_sum[i] is None else prob_sum[i] + m
            n_aug[i] += 1

        _sweep(cfg, records, mask_run, mask_done, mask_item)
        for i in range(n_rec):
            oh, ow = orig_hw[i]
            full_masks[i] = paste_masks(prob_sum[i] / max(n_aug[i], 1), merged[i][0],
                                        merged[i][3], oh, ow)

    for n, rec in enumerate(records):
        mb, ms, mc, mv = merged[n]
        evaluator.process([rec["image_id"]], mb[None], ms[None], mc[None], mv[None],
                          masks=None if full_masks[n] is None else [full_masks[n]])
    results = evaluator.evaluate()
    for task, metrics in results.items():
        logger.info(f"TTA {task}: " + "  ".join(f"{k}={v:.2f}" for k, v in metrics.items()))
    return results
