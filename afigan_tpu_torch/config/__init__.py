"""Configuration for the PyTorch/CUDA port.

The port's own copy of the JAX package's config system
(``afigan_tpu/config``): ``node.py`` is the yacs-style ``CfgNode`` with YAML
``_BASE_`` inheritance and dotted overrides, ``defaults.py`` the full default
tree, with the ``TPU`` section kept key for key so that the repo's YAML files
load unchanged, plus a ``CUDA`` node for the port's own keys. A CPU test
holds the two packages' trees equal on every YAML of ``configs/inference``.
"""

from __future__ import annotations

from pathlib import Path

from .defaults import get_default_cfg
from .node import CfgNode

CONFIGS = Path(__file__).resolve().parents[2] / "configs"

# the ported inference paths
R50_FPN_YAML = "inference/AFI-GAN_maskrcnn_R_50_FPN.yaml"
SWIN_BIFPN_YAML = "inference/AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml"
CENTERMASK_YAML = "inference/AFI-GAN_centermask_R_50_BiFPN.yaml"


def get_cfg() -> CfgNode:
    """A fresh copy of the default config (with the ``CUDA`` node)."""
    return get_default_cfg()


def cfg_from_yaml(name: str) -> CfgNode:
    """The defaults merged with ``configs/<name>`` of this checkout."""
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIGS / name))
    return cfg


def main_path_cfg() -> CfgNode:
    """Inference config of Mask R-CNN R-50-FPN + AFI."""
    return cfg_from_yaml(R50_FPN_YAML)


def swin_path_cfg() -> CfgNode:
    """Inference config of Cascade R-CNN Swin + BiFPN(AFI), the flagship."""
    return cfg_from_yaml(SWIN_BIFPN_YAML)


def centermask_path_cfg() -> CfgNode:
    """Inference config of CenterMask (FCOS + SAG mask head) R-50-BiFPN(AFI),
    the 160-channel pyramid."""
    return cfg_from_yaml(CENTERMASK_YAML)


# d2's COCO-Keypoints/Base-Keypoint-RCNN-FPN.yaml edits of an R-CNN FPN config:
# the keypoint branch for the mask branch, one class, 17 keypoints through
# 8 x 512 convs, box smooth-L1 beta 0.5, 1500 proposals in training
KEYPOINT_EDITS = [
    "MODEL.KEYPOINT_ON", "True", "MODEL.MASK_ON", "False",
    "MODEL.ROI_HEADS.NUM_CLASSES", "1", "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA", "0.5",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "1500", "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "17",
    "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(512, 512, 512, 512, 512, 512, 512, 512)"]
# the JAX package's own C4 shape over an FPN pyramid (its test_rcnn_e2e.py):
# the RPN and the Res5 heads on p4, d2's C4 anchors (one level, sizes 32-512),
# a 14x14 pool
RES5_EDITS = [
    "MODEL.ROI_HEADS.NAME", "Res5ROIHeads", "MODEL.ROI_HEADS.IN_FEATURES", "('p4',)",
    "MODEL.RPN.IN_FEATURES", "('p4',)",
    "MODEL.ANCHOR_GENERATOR.SIZES", "((32, 64, 128, 256, 512),)",
    "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "14"]


def keypoint_path_cfg() -> CfgNode:
    """Keypoint R-CNN R-50-FPN(AFI): the main path's YAML with
    ``KEYPOINT_EDITS``."""
    cfg = main_path_cfg()
    cfg.merge_from_list(list(KEYPOINT_EDITS))
    return cfg


def res5_path_cfg() -> CfgNode:
    """The Res5 (C4) ROI heads over the main path's FPN(AF interpolator)
    pyramid: its YAML with ``RES5_EDITS`` (res5 2048/512 inside the head,
    masks from its output)."""
    cfg = main_path_cfg()
    cfg.merge_from_list(list(RES5_EDITS))
    return cfg


__all__ = ["CfgNode", "get_cfg", "get_default_cfg", "cfg_from_yaml",
           "main_path_cfg", "swin_path_cfg", "centermask_path_cfg", "keypoint_path_cfg",
           "res5_path_cfg", "KEYPOINT_EDITS", "RES5_EDITS"]
