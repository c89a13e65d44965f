"""Inference runner and host-side postprocessing (counterpart of
``afigan_tpu/engine/inference.py``): ``predict`` on one collated batch,
``rescale_boxes``, ``rescale_keypoints``, ``paste_masks`` (torch bilinear,
no cv2) and ``run_inference`` feeding the port's numpy ``CocoEvaluator``
(bbox, segm with masks, keypoints with ``MODEL.KEYPOINT_ON`` under
``TEST.KEYPOINT_OKS_SIGMAS``); distributed, each rank infers its stripe of
the records and the evaluator gathers."""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger("afigan_tpu_torch")


def rescale_boxes(boxes: np.ndarray, resized_hw, orig_hw) -> np.ndarray:
    sy = orig_hw[0] / max(resized_hw[0], 1)
    sx = orig_hw[1] / max(resized_hw[1], 1)
    out = boxes.copy()
    out[:, 0::2] = np.clip(out[:, 0::2] * sx, 0, orig_hw[1])
    out[:, 1::2] = np.clip(out[:, 1::2] * sy, 0, orig_hw[0])
    return out


def rescale_keypoints(keypoints: np.ndarray, resized_hw, orig_hw) -> np.ndarray:
    """(D, K, 3) [x, y, score] on the resized canvas → original image coords
    (unclipped, as in JAX)."""
    out = keypoints.copy()
    out[..., 0] *= orig_hw[1] / max(resized_hw[1], 1)
    out[..., 1] *= orig_hw[0] / max(resized_hw[0], 1)
    return out


def paste_masks(masks, boxes: np.ndarray, valid: np.ndarray, orig_h: int,
                orig_w: int, threshold: float = 0.5) -> List[Optional[np.ndarray]]:
    """(D, S, S) probabilities + (D, 4) boxes in original coords →
    full-size uint8 masks (None where invalid): bilinear resize into the
    integer box extent (align_corners=False), threshold 0.5."""
    masks = torch.as_tensor(masks).float()
    out = []
    for i in range(masks.shape[0]):
        if not valid[i]:
            out.append(None)
            continue
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
        x2i, y2i = min(int(np.ceil(x2)), orig_w), min(int(np.ceil(y2)), orig_h)
        full = np.zeros((orig_h, orig_w), np.uint8)
        if x2i > x1i and y2i > y1i:
            m = F.interpolate(masks[i][None, None], size=(y2i - y1i, x2i - x1i),
                              mode="bilinear", align_corners=False)[0, 0]
            full[y1i:y2i, x1i:x2i] = (m >= threshold).cpu().numpy()
        out.append(full)
    return out


def predict(model, batch: Dict):
    """One collated batch (``image`` (B,H,W,3) raw pixels, ``image_sizes``
    (B,2)) → (Detections of (B, D, ...) tensors, masks (B, D, S, S) or None)
    on the model's device."""
    dev = next(model.parameters()).device
    images = torch.as_tensor(np.ascontiguousarray(batch["image"])).to(dev)
    sizes = torch.as_tensor(np.asarray(batch["image_sizes"])).to(dev)
    with torch.inference_mode():
        return model(images, sizes)


def run_inference(cfg, model, dataset, batch_size: int = 1) -> Dict[str, Dict[str, float]]:
    """inference_on_dataset + COCOEvaluator.evaluate: rank r infers
    ``records[r::world]`` and every rank evaluates the predictions of all
    (the same results on every rank); one process infers every record."""
    from ..data import build_test_loader
    from ..evaluation import CocoEvaluator
    from ..parallel import rank, world_size

    tasks = ("bbox",) + (("segm",) if cfg.MODEL.MASK_ON else ()) + (
        ("keypoints",) if cfg.MODEL.KEYPOINT_ON else ())
    evaluator = CocoEvaluator(dataset, tasks=tasks,
                              oks_sigmas=list(cfg.TEST.KEYPOINT_OKS_SIGMAS) or None)
    records = dataset.records[rank()::world_size()]
    for batch in build_test_loader(cfg, dataset, batch_size, records=records):
        dets, masks = predict(model, batch)
        boxes = dets.boxes.float().cpu().numpy()
        scores = dets.scores.float().cpu().numpy()
        classes = dets.classes.cpu().numpy()
        valid = dets.valid.cpu().numpy()
        kps = None if dets.keypoints is None else dets.keypoints.float().cpu().numpy()
        for i in range(boxes.shape[0]):
            if int(batch["image_id"][i]) < 0:  # final-batch padding
                continue
            orig_h, orig_w = batch["orig_sizes"][i]
            img_boxes = rescale_boxes(boxes[i], batch["image_sizes"][i], (orig_h, orig_w))
            full = None
            if masks is not None:
                full = [paste_masks(masks[i], img_boxes, valid[i], orig_h, orig_w)]
            img_kps = None
            if kps is not None:
                img_kps = rescale_keypoints(kps[i], batch["image_sizes"][i],
                                            (orig_h, orig_w))[None]
            evaluator.process([batch["image_id"][i]], img_boxes[None],
                              scores[i][None], classes[i][None], valid[i][None],
                              masks=full, keypoints=img_kps)
    results = evaluator.evaluate()
    for task, metrics in results.items():
        logger.info(f"{task}: " + "  ".join(f"{k}={v:.2f}" for k, v in metrics.items()))
    return results
