"""Config → model (counterpart of ``afigan_tpu/models/build.py``).

Ported registry entries: ``build_resnet_fpn_sr_backbone`` /
``build_resnet_fpn_backbone`` (ResNet + FPN with the AF interpolator /
nearest top-down), ``build_swint_bifpn_sr_backbone`` /
``build_swint_bifpn_backbone`` (Swin + BiFPN) and
``build_resnet_bifpn_sr_backbone`` / ``build_resnet_bifpn_backbone`` (ResNet +
BiFPN), under ``GeneralizedRCNN`` with ``StandardROIHeads`` or
``CascadeROIHeads``, ``FCOS`` or ``CenterMask``. Every other name raises
``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .bifpn import BiFPN
from .cascade_roi_heads import CascadeROIHeads
from .centermask import CenterMask
from .fcos import FCOS
from .fpn import FPN
from .meta_arch import GeneralizedRCNN
from .resnet import build_resnet
from .roi_heads import StandardROIHeads
from .swin import build_swin

_TODO = "not ported yet (ROADMAP Queue 1 item 12, the breadth families)"
_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32,
            "p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


# name → (bottom-up, pyramid, top-down interpolator)
_BACKBONES = {"build_resnet_fpn_sr_backbone": ("resnet", "fpn", "afi"),
              "build_resnet_fpn_backbone": ("resnet", "fpn", "nearest"),
              "build_swint_bifpn_sr_backbone": ("swin", "bifpn", "afi"),
              "build_swint_bifpn_backbone": ("swin", "bifpn", "nearest"),
              "build_resnet_bifpn_sr_backbone": ("resnet", "bifpn", "afi"),
              "build_resnet_bifpn_backbone": ("resnet", "bifpn", "nearest")}


def pyramid_channels(cfg) -> int:
    pyramid = _BACKBONES.get(cfg.MODEL.BACKBONE.NAME, ("", "fpn"))[1]
    return (cfg.MODEL.BIFPN if pyramid == "bifpn" else cfg.MODEL.FPN).OUT_CHANNELS


def build_backbone(cfg, device=None) -> nn.Module:
    name = cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        raise NotImplementedError(f"backbone {name!r} {_TODO}")
    bottom, pyramid, interp = _BACKBONES[name]
    afi = dict(afi_n_rdb=cfg.MODEL.AFI.N_RDB, afi_growth_rate=cfg.MODEL.AFI.GROWTH_RATE,
               afi_residual_scale=cfg.MODEL.AFI.RESIDUAL_SCALE)
    if bottom == "swin":
        bottom_up = build_swin(cfg, device)
        chans = bottom_up.out_channels
    else:
        bottom_up = build_resnet(cfg, device)
        r = cfg.MODEL.RESNETS
        chans = {f"res{s}": r.RES2_OUT_CHANNELS * 2 ** (s - 2) for s in range(2, 6)}
    if pyramid == "bifpn":
        bf = cfg.MODEL.BIFPN
        return BiFPN(bottom_up, in_channels=chans, in_features=tuple(bf.IN_FEATURES),
                     out_channels=bf.OUT_CHANNELS, fpn_repeat=bf.FPN_REPEAT, norm=bf.NORM,
                     interp=interp, device=device, **afi)
    return FPN(
        bottom_up, in_channels=chans, in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
        in_strides=tuple(_STRIDES[f] for f in cfg.MODEL.FPN.IN_FEATURES),
        out_channels=cfg.MODEL.FPN.OUT_CHANNELS, norm=cfg.MODEL.FPN.NORM,
        fuse_type=cfg.MODEL.FPN.FUSE_TYPE, interp=interp,
        top_block=cfg.MODEL.FPN.TOP_BLOCK,
        top_block_in_feature=cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE, device=device, **afi)


def build_roi_heads(cfg, device=None) -> StandardROIHeads:
    rh, bh, mh = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_MASK_HEAD
    if rh.NAME not in ("StandardROIHeads", "CascadeROIHeads") or cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError(f"ROI heads {rh.NAME!r} / keypoints {_TODO}")
    if cfg.MODEL.MASK_ON and mh.NORM:
        raise NotImplementedError(f"a mask head with norm {mh.NORM!r} {_TODO}")
    common = dict(
        in_channels=pyramid_channels(cfg), num_classes=rh.NUM_CLASSES,
        in_features=tuple(rh.IN_FEATURES),
        strides=tuple(_STRIDES[f] for f in rh.IN_FEATURES),
        box_pooler_resolution=bh.POOLER_RESOLUTION, box_num_conv=bh.NUM_CONV,
        box_conv_dim=bh.CONV_DIM, box_num_fc=bh.NUM_FC, box_fc_dim=bh.FC_DIM,
        box_norm=bh.NORM, bbox_reg_weights=tuple(bh.BBOX_REG_WEIGHTS),
        cls_agnostic_bbox_reg=bh.CLS_AGNOSTIC_BBOX_REG, mask_on=cfg.MODEL.MASK_ON,
        mask_pooler_resolution=mh.POOLER_RESOLUTION, mask_num_conv=mh.NUM_CONV,
        mask_conv_dim=mh.CONV_DIM, cls_agnostic_mask=mh.CLS_AGNOSTIC_MASK,
        score_thresh=rh.SCORE_THRESH_TEST, nms_thresh=rh.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        sampling_ratio=max(bh.POOLER_SAMPLING_RATIO, 2),
        aligned=bh.POOLER_TYPE != "ROIAlign", pooler_impl=cfg.TPU.POOLER_IMPL,
        batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE, positive_fraction=rh.POSITIVE_FRACTION,
        iou_threshold=rh.IOU_THRESHOLDS[0], append_gt=rh.PROPOSAL_APPEND_GT,
        smooth_l1_beta=bh.SMOOTH_L1_BETA, device=device)
    if rh.NAME == "CascadeROIHeads":
        return CascadeROIHeads(
            cascade_bbox_reg_weights=tuple(
                tuple(w) for w in cfg.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS),
            **common)
    return StandardROIHeads(**common)


def _fcos_kwargs(cfg, device) -> dict:
    f = cfg.MODEL.FCOS
    return dict(
        in_channels=pyramid_channels(cfg), num_classes=f.NUM_CLASSES,
        in_features=tuple(f.IN_FEATURES), fpn_strides=tuple(f.FPN_STRIDES),
        num_convs=f.NUM_CONVS, norm=f.NORM, prior_prob=f.PRIOR_PROB,
        centerness_on_reg=f.CENTERNESS_ON_REG, use_scale=f.USE_SCALE,
        thresh_with_ctr=f.THRESH_WITH_CTR, score_thresh=f.INFERENCE_TH_TEST,
        nms_thresh=f.NMS_TH, pre_nms_topk=f.PRE_NMS_TOPK_TEST,
        post_nms_topk=f.POST_NMS_TOPK_TEST, pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=compute_dtype(cfg), device=device)


def build_fcos(cfg, device=None) -> FCOS:
    return FCOS(build_backbone(cfg, device), **_fcos_kwargs(cfg, device))


def build_centermask(cfg, device=None) -> CenterMask:
    return CenterMask(
        build_backbone(cfg, device),
        mask_pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
        pooler_impl=cfg.TPU.POOLER_IMPL, **_fcos_kwargs(cfg, device))


def _build_rcnn(cfg, device) -> GeneralizedRCNN:
    rpn = cfg.MODEL.RPN
    return GeneralizedRCNN(
        build_backbone(cfg, device), build_roi_heads(cfg, device),
        rpn_in_features=tuple(rpn.IN_FEATURES),
        rpn_strides=tuple(_STRIDES[f] for f in rpn.IN_FEATURES),
        anchor_sizes=tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
        anchor_aspect_ratios=tuple(
            tuple(a) for a in cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS),
        anchor_offset=cfg.MODEL.ANCHOR_GENERATOR.OFFSET,
        rpn_channels=pyramid_channels(cfg),
        rpn_bbox_reg_weights=tuple(rpn.BBOX_REG_WEIGHTS),
        pre_nms_topk=rpn.PRE_NMS_TOPK_TEST, post_nms_topk=rpn.POST_NMS_TOPK_TEST,
        pre_nms_topk_train=rpn.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=rpn.POST_NMS_TOPK_TRAIN, rpn_nms_thresh=rpn.NMS_THRESH,
        rpn_iou_thresholds=tuple(rpn.IOU_THRESHOLDS),
        rpn_batch_size_per_image=rpn.BATCH_SIZE_PER_IMAGE,
        rpn_positive_fraction=rpn.POSITIVE_FRACTION, rpn_smooth_l1_beta=rpn.SMOOTH_L1_BETA,
        rpn_loss_weight=rpn.LOSS_WEIGHT,
        rpn_min_size=cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        dtype=compute_dtype(cfg), device=device)


def build_model(cfg, device="cuda", generator: Optional[torch.Generator] = None,
                train: bool = False) -> nn.Module:
    """META_ARCHITECTURE (``GeneralizedRCNN``, ``FCOS``, ``CenterMask``) → an
    eval-mode model on ``device``: the GPU unless the caller asks for ``"cpu"``.
    Without a GPU the default raises; nothing carries on silently on the CPU.
    With ``generator``, weights are drawn from it (the JAX package's init
    distributions); otherwise they are torch's defaults, to be replaced by
    ``load_state_dict``. ``train`` returns it in training mode (only
    ``GeneralizedRCNN`` with standard ROI heads trains so far)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            'build_model: no CUDA device found; pass device="cpu" to run the plain '
            "PyTorch versions on the CPU")
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch in ("FCOS", "CenterMask"):
        model = (build_fcos if arch == "FCOS" else build_centermask)(cfg, device)
    elif arch == "GeneralizedRCNN":
        model = _build_rcnn(cfg, device)
    else:
        raise NotImplementedError(f"META_ARCHITECTURE {arch!r} {_TODO}")
    if train and (arch != "GeneralizedRCNN"
                  or cfg.MODEL.ROI_HEADS.NAME != "StandardROIHeads"):
        raise NotImplementedError(
            f"training {arch} / {cfg.MODEL.ROI_HEADS.NAME} is not ported yet (ROADMAP "
            "queue 1, the breadth families)")
    if generator is not None:
        model.init_weights(generator)
    return model.train(train)
