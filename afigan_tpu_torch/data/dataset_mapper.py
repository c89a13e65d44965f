"""Training mapper: a dataset record → one sample's numpy arrays (the port's
own copy of ``afigan_tpu/data/dataset_mapper.py``, stage 3: one scale, no
crop or colour jitter).

One sampled transform (resize + flip) per record, from the mapper's
``np.random.RandomState(seed)`` in the JAX package's order, and the GT padded
to static shapes: ``TPU.MAX_GT_BOXES`` boxes (xyxy in transformed-image
coords, clipped, the degenerate ones dropped before the cap) with classes and
a validity mask, and with masks on, each instance rasterised once into a
(``TPU.MASK_CANVAS``)^2 canvas covering its transformed box (the model
crop-resizes it to the mask head's size).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..evaluation.rle import decode_rle, polygons_to_mask
from .coco import read_image
from .transforms import ResolvedTransform, sample_train_transform


def rasterize_to_canvas(segm, box, canvas: int, tf: ResolvedTransform) -> np.ndarray:
    """One instance's segmentation (polygons or RLE, original coords) as a
    (canvas, canvas) float32 patch over its transformed box."""
    import cv2

    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-3)
    h = max(y2 - y1, 1e-3)
    if segm is None:
        return np.zeros((canvas, canvas), np.float32)
    if isinstance(segm, dict):  # RLE
        m = tf.apply_image(decode_rle(segm).astype(np.float32), interp="nearest")[:, :, 0]
        sx, sy = w / canvas, h / canvas
        mat = np.array([[sx, 0.0, x1 + 0.5 * sx - 0.5],
                        [0.0, sy, y1 + 0.5 * sy - 0.5]], np.float32)
        return cv2.warpAffine(m, mat, (canvas, canvas),
                              flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    shifted = []
    for p in tf.apply_polygons(segm):
        p = np.asarray(p, np.float64).reshape(-1, 2)
        p[:, 0] = (p[:, 0] - x1) / w * canvas
        p[:, 1] = (p[:, 1] - y1) / h * canvas
        shifted.append(p.reshape(-1).tolist())
    return polygons_to_mask(shifted, canvas, canvas).astype(np.float32)


class DatasetMapper:
    """record → {image (unpadded, uint8), gt {boxes, classes, valid[, masks]},
    sizes, transform}."""

    def __init__(self, cfg, is_train: bool = True, seed: int = 0):
        if not is_train:
            raise ValueError("the eval mapper is data/loader.py::map_record")
        if cfg.INPUT.CROP.ENABLED or cfg.INPUT.COLOR_JITTER.ENABLED or cfg.MODEL.KEYPOINT_ON:
            raise NotImplementedError("INPUT.CROP, INPUT.COLOR_JITTER and keypoints are not "
                                      "ported yet (ROADMAP queue 1)")
        self.fmt = cfg.INPUT.FORMAT
        self.min_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN
        self.sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING
        self.max_gt = cfg.TPU.MAX_GT_BOXES
        self.mask_canvas = cfg.TPU.MASK_CANVAS
        self.mask_on = cfg.MODEL.MASK_ON
        self.rng = np.random.RandomState(seed)

    def __call__(self, record: Dict) -> Dict:
        img = record.get("image")
        if img is None:
            img = read_image(record["file_name"], self.fmt)
        h, w = img.shape[:2]
        tf = sample_train_transform(self.rng, h, w, self.min_sizes, self.max_size,
                                    self.sampling)
        return {"image": tf.apply_image(img), "image_id": record.get("image_id", 0),
                "orig_height": h, "orig_width": w, "transform": tf,
                "gt": self._make_gt(record, tf)}

    def _make_gt(self, record: Dict, tf: ResolvedTransform) -> Dict:
        objs = [o for o in record.get("annotations", []) if not o.get("iscrowd", 0)]
        boxes = np.zeros((self.max_gt, 4), np.float32)
        classes = np.zeros((self.max_gt,), np.int32)
        valid = np.zeros((self.max_gt,), bool)
        if objs:
            tb = tf.apply_boxes(np.asarray([o["bbox"] for o in objs], np.float32))
            tb[:, 0::2] = np.clip(tb[:, 0::2], 0, tf.new_w)
            tb[:, 1::2] = np.clip(tb[:, 1::2], 0, tf.new_h)
            keep = (tb[:, 2] > tb[:, 0] + 1e-3) & (tb[:, 3] > tb[:, 1] + 1e-3)
            # the degenerate ones go before the capacity cap
            sel = np.flatnonzero(keep)[: self.max_gt]
            objs = [objs[i] for i in sel]
            n = len(objs)
            boxes[:n] = tb[sel]
            classes[:n] = [o["category_id"] for o in objs]
            valid[:n] = keep[sel]
        gt = {"boxes": boxes, "classes": classes, "valid": valid}
        if self.mask_on:
            masks = np.zeros((self.max_gt, self.mask_canvas, self.mask_canvas), np.float32)
            for i, o in enumerate(objs):
                if valid[i] and o.get("segmentation") is not None:
                    masks[i] = rasterize_to_canvas(o["segmentation"], boxes[i],
                                                   self.mask_canvas, tf)
            gt["masks"] = masks
        return gt
