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


__all__ = ["CfgNode", "get_cfg", "get_default_cfg", "cfg_from_yaml",
           "main_path_cfg", "swin_path_cfg", "centermask_path_cfg"]
