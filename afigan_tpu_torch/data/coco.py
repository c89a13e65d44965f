"""COCO-format dataset loading + catalog — pure-python, no pycocotools
(the port's copy of ``afigan_tpu/data/coco.py``).

Covers the reference's data layer responsibilities (SURVEY §2.2 "Data" and
afigan/engine/afigan_utils.py): COCO instances-json parsing, contiguous
category-id remapping, crowd/empty filtering, and the DatasetCatalog-style
name registry ("coco_2017_train" → json + image root).

Each record mirrors the d2 dataset-dict contract:
    {"file_name", "image_id", "height", "width",
     "annotations": [{"bbox" (XYXY), "category_id" (contiguous),
                      "segmentation", "iscrowd", "area"}]}
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List

import numpy as np

_CATALOG: Dict[str, Callable[[], "CocoDataset"]] = {}


def register_dataset(name: str, factory: Callable[[], "CocoDataset"]) -> None:
    _CATALOG[name] = factory


def get_dataset(name: str) -> "CocoDataset":
    if name not in _CATALOG:
        raise KeyError(f"Dataset {name} not registered; have {sorted(_CATALOG)}")
    return _CATALOG[name]()


class CocoDataset:
    """Parsed COCO instances annotations."""

    def __init__(self, json_file: str, image_root: str,
                 filter_empty: bool = True):
        self.json_file = json_file
        self.image_root = image_root
        with open(json_file) as f:
            coco = json.load(f)

        self.cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_id_to_contiguous = {c: i for i, c in enumerate(self.cat_ids)}
        self.contiguous_to_cat_id = {i: c for c, i in self.cat_id_to_contiguous.items()}
        self.class_names = [
            c["name"] for c in sorted(coco.get("categories", []), key=lambda c: c["id"])
        ]
        # left/right keypoint identity swap for horizontal flip (d2
        # create_keypoint_hflip_indices, derived from category keypoint
        # names: "left_X" <-> "right_X")
        self.keypoint_hflip_indices = None
        for c in coco.get("categories", []):
            names = c.get("keypoints")
            if names:
                idx = list(range(len(names)))
                for i, n in enumerate(names):
                    if n.startswith("left_"):
                        other = "right_" + n[len("left_"):]
                    elif n.startswith("right_"):
                        other = "left_" + n[len("right_"):]
                    else:
                        continue
                    if other in names:
                        idx[i] = names.index(other)
                self.keypoint_hflip_indices = idx
                break

        anns_by_img: Dict[int, List[Dict]] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.annotations = coco.get("annotations", [])  # raw, for evaluation GT
        self.img_ids = [im["id"] for im in coco.get("images", [])]
        self.img_hw = {
            im["id"]: (im["height"], im["width"]) for im in coco.get("images", [])
        }

        self.records: List[Dict] = []
        for im in coco.get("images", []):
            anns = anns_by_img.get(im["id"], [])
            objs = []
            for a in anns:
                if a.get("ignore", 0):
                    continue
                x, y, w, h = a["bbox"]
                if w <= 0 or h <= 0:
                    continue
                obj = {
                    "bbox": [x, y, x + w, y + h],  # XYXY
                    "category_id": self.cat_id_to_contiguous[a["category_id"]],
                    "segmentation": a.get("segmentation"),
                    "iscrowd": a.get("iscrowd", 0),
                    "area": a.get("area", w * h),
                }
                if "keypoints" in a:
                    # d2 load_coco_json: +0.5 shifts pixel indices to
                    # continuous coords (visibility untouched) — hflip's
                    # `w - x` mirror is exact only for shifted coords
                    obj["keypoints"] = [
                        v if i % 3 == 2 else v + 0.5
                        for i, v in enumerate(a["keypoints"])
                    ]
                objs.append(obj)
            # d2's only-crowd filter counts PRE-pruning annotations
            # (degenerate boxes are dropped by the mapper, not at load):
            # an image whose only non-crowd ann has w<=0 stays in the set
            if filter_empty and not any(
                not a.get("ignore", 0) and a.get("iscrowd", 0) == 0
                for a in anns
            ):
                continue
            self.records.append(
                {
                    "file_name": os.path.join(self.image_root, im["file_name"]),
                    "image_id": im["id"],
                    "height": im["height"],
                    "width": im["width"],
                    "annotations": objs,
                }
            )

    def __len__(self):
        return len(self.records)


def register_coco_instances(name: str, json_file: str, image_root: str,
                            filter_empty: bool = True) -> None:
    """d2 register_coco_instances equivalent (lazy parse, cached)."""
    cache = {}

    def factory():
        if "ds" not in cache:
            cache["ds"] = CocoDataset(json_file, image_root, filter_empty)
        return cache["ds"]

    register_dataset(name, factory)


def register_default_datasets(root: str = "datasets") -> None:
    """Register the standard COCO 2017 splits if present on disk."""
    pairs = {
        "coco_2017_train": ("annotations/instances_train2017.json", "train2017"),
        "coco_2017_val": ("annotations/instances_val2017.json", "val2017"),
    }
    for name, (ann, imgs) in pairs.items():
        json_file = os.path.join(root, "coco", ann)
        image_root = os.path.join(root, "coco", imgs)
        if os.path.isfile(json_file):
            register_coco_instances(name, json_file, image_root,
                                    filter_empty="train" in name)


def read_image(path: str, fmt: str = "BGR") -> np.ndarray:
    """Image IO with EXIF transpose (ref afigan_utils.py:36-70)."""
    from PIL import Image, ImageOps

    with Image.open(path) as img:
        img = ImageOps.exif_transpose(img)
        img = img.convert("RGB")
        arr = np.asarray(img)
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)
