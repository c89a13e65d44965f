"""Config → model (counterpart of ``afigan_tpu/models/build.py``).

Ported registry entries: ``build_resnet_fpn_sr_backbone`` /
``build_resnet_fpn_backbone`` (ResNet + FPN with the AF interpolator /
nearest top-down), ``build_resnet_pafpn_sr_backbone`` /
``build_resnet_pafpn_backbone`` (ResNet + PAFPN),
``build_resnest_fpn_sr_backbone`` / ``build_resnest_pafpn_sr_backbone``
(ResNeSt + FPN / PAFPN), ``build_swint_bifpn_sr_backbone`` /
``build_swint_bifpn_backbone`` (Swin + BiFPN) and
``build_resnet_bifpn_sr_backbone`` / ``build_resnet_bifpn_backbone`` (ResNet +
BiFPN), under ``GeneralizedRCNN`` (or ``GeneralizedRCNN_AFExtractor``, the
same model returning its features too) with ``StandardROIHeads`` or
``CascadeROIHeads`` (with the keypoint branch under ``MODEL.KEYPOINT_ON``) or
``Res5ROIHeads``, ``FCOS`` or ``CenterMask``; the guide of stages 1-2,
``RCNN_FPN_only`` over ``MODEL.GUIDE_BACKBONE.NAME`` (``build_guide_model``).
In a training build (``train``) every BN and SyncBN trains
(``layers.unfreeze_batch_norms``) and a Swin takes its DropPath rates.
``ProposalNetwork`` raises ``NotImplementedError`` naming its ROADMAP item.
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
from .layers import unfreeze_batch_norms
from .meta_arch import GeneralizedRCNN, RCNN_FPN_only
from .pafpn import PAFPN
from .res5_roi_heads import Res5ROIHeads
from .resnest import build_resnest
from .resnet import build_resnet
from .roi_heads import StandardROIHeads
from .swin import build_swin

_TODO = "not ported yet (ROADMAP queue 1)"
_STRIDES = {"res2": 4, "res3": 8, "res4": 16, "res5": 32,
            "p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64, "p7": 128}


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32


# name → (bottom-up, pyramid, top-down interpolator)
_BACKBONES = {"build_resnet_fpn_sr_backbone": ("resnet", "fpn", "afi"),
              "build_resnet_fpn_backbone": ("resnet", "fpn", "nearest"),
              "build_resnet_pafpn_sr_backbone": ("resnet", "pafpn", "afi"),
              "build_resnet_pafpn_backbone": ("resnet", "pafpn", "nearest"),
              "build_resnest_fpn_sr_backbone": ("resnest", "fpn", "afi"),
              "build_resnest_pafpn_sr_backbone": ("resnest", "pafpn", "afi"),
              "build_swint_bifpn_sr_backbone": ("swin", "bifpn", "afi"),
              "build_swint_bifpn_backbone": ("swin", "bifpn", "nearest"),
              "build_resnet_bifpn_sr_backbone": ("resnet", "bifpn", "afi"),
              "build_resnet_bifpn_backbone": ("resnet", "bifpn", "nearest")}


def pyramid_channels(cfg) -> int:
    pyramid = _BACKBONES.get(cfg.MODEL.BACKBONE.NAME, ("", "fpn"))[1]
    return (cfg.MODEL.BIFPN if pyramid == "bifpn" else cfg.MODEL.FPN).OUT_CHANNELS


def build_backbone(cfg, device=None, name: Optional[str] = None,
                   train: bool = False) -> nn.Module:
    """``name`` (default ``MODEL.BACKBONE.NAME``) → bottom-up + pyramid;
    ``train``: a training build (a Swin's DropPath)."""
    name = name or cfg.MODEL.BACKBONE.NAME
    if name not in _BACKBONES:
        # every name of the JAX package's BACKBONE_REGISTRY is ported
        raise KeyError(f"Unknown backbone: {name}; have {sorted(_BACKBONES)}")
    bottom, pyramid, interp = _BACKBONES[name]
    afi = dict(afi_n_rdb=cfg.MODEL.AFI.N_RDB, afi_growth_rate=cfg.MODEL.AFI.GROWTH_RATE,
               afi_residual_scale=cfg.MODEL.AFI.RESIDUAL_SCALE)
    if bottom == "swin":
        bottom_up = build_swin(cfg, device, train)
        chans = bottom_up.out_channels
    else:
        bottom_up = (build_resnest if bottom == "resnest" else build_resnet)(cfg, device)
        r = cfg.MODEL.RESNETS
        chans = {f"res{s}": r.RES2_OUT_CHANNELS * 2 ** (s - 2) for s in range(2, 6)}
    if pyramid == "bifpn":
        bf = cfg.MODEL.BIFPN
        return BiFPN(bottom_up, in_channels=chans, in_features=tuple(bf.IN_FEATURES),
                     out_channels=bf.OUT_CHANNELS, fpn_repeat=bf.FPN_REPEAT, norm=bf.NORM,
                     interp=interp, device=device, **afi)
    fpn = dict(in_channels=chans, in_features=tuple(cfg.MODEL.FPN.IN_FEATURES),
               in_strides=tuple(_STRIDES[f] for f in cfg.MODEL.FPN.IN_FEATURES),
               out_channels=cfg.MODEL.FPN.OUT_CHANNELS, norm=cfg.MODEL.FPN.NORM,
               fuse_type=cfg.MODEL.FPN.FUSE_TYPE, interp=interp, device=device, **afi)
    if pyramid == "pafpn":  # p6 by max pool whatever FPN.TOP_BLOCK says, as in JAX
        return PAFPN(bottom_up, **fpn)
    return FPN(bottom_up, top_block=cfg.MODEL.FPN.TOP_BLOCK,
               top_block_in_feature=cfg.MODEL.FPN.TOP_BLOCK_IN_FEATURE, **fpn)


def build_roi_heads(cfg, device=None) -> nn.Module:
    rh, bh, mh = cfg.MODEL.ROI_HEADS, cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_MASK_HEAD
    kh = cfg.MODEL.ROI_KEYPOINT_HEAD
    if rh.NAME == "Res5ROIHeads":
        if cfg.MODEL.KEYPOINT_ON:
            raise ValueError("KEYPOINT_ON requires Standard/Cascade ROI heads "
                             "(d2 keypoint models are FPN-based)")
        r = cfg.MODEL.RESNETS
        # the pool's stride is the head's default 16, as the JAX build leaves it
        return Res5ROIHeads(
            pyramid_channels(cfg), num_classes=rh.NUM_CLASSES, in_feature=rh.IN_FEATURES[0],
            pooler_resolution=bh.POOLER_RESOLUTION, norm=r.NORM,
            stride_in_1x1=r.STRIDE_IN_1X1, mask_on=cfg.MODEL.MASK_ON,
            batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE,
            positive_fraction=rh.POSITIVE_FRACTION, iou_threshold=rh.IOU_THRESHOLDS[0],
            append_gt=rh.PROPOSAL_APPEND_GT, bbox_reg_weights=tuple(bh.BBOX_REG_WEIGHTS),
            smooth_l1_beta=bh.SMOOTH_L1_BETA, score_thresh=rh.SCORE_THRESH_TEST,
            nms_thresh=rh.NMS_THRESH_TEST, detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
            device=device)
    if rh.NAME not in ("StandardROIHeads", "CascadeROIHeads"):
        raise KeyError(f"Unknown ROI heads: {rh.NAME}")
    common = dict(
        in_channels=pyramid_channels(cfg), num_classes=rh.NUM_CLASSES,
        in_features=tuple(rh.IN_FEATURES),
        strides=tuple(_STRIDES[f] for f in rh.IN_FEATURES),
        box_pooler_resolution=bh.POOLER_RESOLUTION, box_num_conv=bh.NUM_CONV,
        box_conv_dim=bh.CONV_DIM, box_num_fc=bh.NUM_FC, box_fc_dim=bh.FC_DIM,
        box_norm=bh.NORM, bbox_reg_weights=tuple(bh.BBOX_REG_WEIGHTS),
        cls_agnostic_bbox_reg=bh.CLS_AGNOSTIC_BBOX_REG, mask_on=cfg.MODEL.MASK_ON,
        mask_pooler_resolution=mh.POOLER_RESOLUTION, mask_num_conv=mh.NUM_CONV,
        mask_conv_dim=mh.CONV_DIM, mask_norm=mh.NORM,
        cls_agnostic_mask=mh.CLS_AGNOSTIC_MASK, keypoint_on=cfg.MODEL.KEYPOINT_ON,
        keypoint_pooler_resolution=kh.POOLER_RESOLUTION,
        keypoint_conv_dims=tuple(kh.CONV_DIMS), num_keypoints=kh.NUM_KEYPOINTS,
        keypoint_loss_weight=kh.LOSS_WEIGHT,
        keypoint_normalize_by_visible=kh.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS,
        keypoint_sampling_ratio=max(kh.POOLER_SAMPLING_RATIO, 2),
        keypoint_aligned=kh.POOLER_TYPE != "ROIAlign",
        score_thresh=rh.SCORE_THRESH_TEST, nms_thresh=rh.NMS_THRESH_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        sampling_ratio=max(bh.POOLER_SAMPLING_RATIO, 2),
        aligned=bh.POOLER_TYPE != "ROIAlign", pooler_impl=cfg.TPU.POOLER_IMPL,
        batch_size_per_image=rh.BATCH_SIZE_PER_IMAGE, positive_fraction=rh.POSITIVE_FRACTION,
        iou_threshold=rh.IOU_THRESHOLDS[0], append_gt=rh.PROPOSAL_APPEND_GT,
        smooth_l1_beta=bh.SMOOTH_L1_BETA, device=device)
    if rh.NAME == "CascadeROIHeads":
        cas = cfg.MODEL.ROI_BOX_CASCADE_HEAD
        return CascadeROIHeads(
            cascade_bbox_reg_weights=tuple(tuple(w) for w in cas.BBOX_REG_WEIGHTS),
            cascade_ious=tuple(cas.IOUS), **common)
    return StandardROIHeads(**common)


def _fcos_kwargs(cfg, device) -> dict:
    f = cfg.MODEL.FCOS
    return dict(
        in_channels=pyramid_channels(cfg), num_classes=f.NUM_CLASSES,
        in_features=tuple(f.IN_FEATURES), fpn_strides=tuple(f.FPN_STRIDES),
        sizes_of_interest=tuple(f.SIZES_OF_INTEREST), num_convs=f.NUM_CONVS,
        norm=f.NORM, prior_prob=f.PRIOR_PROB, center_sample=f.CENTER_SAMPLE,
        pos_radius=f.POS_RADIUS, centerness_on_reg=f.CENTERNESS_ON_REG,
        use_scale=f.USE_SCALE, thresh_with_ctr=f.THRESH_WITH_CTR,
        score_thresh=f.INFERENCE_TH_TEST, nms_thresh=f.NMS_TH,
        pre_nms_topk=f.PRE_NMS_TOPK_TEST, post_nms_topk=f.POST_NMS_TOPK_TEST,
        score_thresh_train=f.INFERENCE_TH_TRAIN, pre_nms_topk_train=f.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=f.POST_NMS_TOPK_TRAIN, pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=compute_dtype(cfg), device=device)


def build_fcos(cfg, device=None, train: bool = False) -> FCOS:
    return FCOS(build_backbone(cfg, device, train=train), **_fcos_kwargs(cfg, device))


def build_centermask(cfg, device=None, train: bool = False) -> CenterMask:
    return CenterMask(
        build_backbone(cfg, device, train=train),
        mask_pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
        pooler_impl=cfg.TPU.POOLER_IMPL, max_fg=min(cfg.TPU.MAX_GT_BOXES, 64),
        **_fcos_kwargs(cfg, device))


def _build_rcnn(cfg, device, return_features=False, train=False) -> GeneralizedRCNN:
    rpn = cfg.MODEL.RPN
    return GeneralizedRCNN(
        build_backbone(cfg, device, train=train), build_roi_heads(cfg, device),
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
        dtype=compute_dtype(cfg), return_features=return_features, device=device)


def check_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" without a GPU raises: nothing
    carries on silently on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'{what}: no CUDA device found; pass device="cpu" to run the plain '
            "PyTorch versions on the CPU")
    return device


def build_model(cfg, device="cuda", generator: Optional[torch.Generator] = None,
                train: bool = False) -> nn.Module:
    """META_ARCHITECTURE (``GeneralizedRCNN``, ``GeneralizedRCNN_AFExtractor``,
    ``FCOS``, ``CenterMask``) → an eval-mode model on ``device``: the GPU unless the caller asks for ``"cpu"``.
    Without a GPU the default raises; nothing carries on silently on the CPU.
    With ``generator``, weights are drawn from it (the JAX package's init
    distributions); otherwise they are torch's defaults, to be replaced by
    ``load_state_dict``. ``train`` builds the training model (BN / SyncBN
    that train, FCOS's ``_TRAIN`` thresholds, a Swin's DropPath at
    ``MODEL.SWINT.DROP_PATH_RATE``) in training mode."""
    device = check_device(device, "build_model")
    arch = cfg.MODEL.META_ARCHITECTURE
    rcnn = ("GeneralizedRCNN", "GeneralizedRCNN_AFExtractor")
    if arch in ("FCOS", "CenterMask"):
        model = (build_fcos if arch == "FCOS" else build_centermask)(cfg, device, train)
    elif arch in rcnn:
        model = _build_rcnn(cfg, device, return_features=arch == rcnn[1], train=train)
    else:
        raise NotImplementedError(f"META_ARCHITECTURE {arch!r} (ProposalNetwork) {_TODO}")
    if generator is not None:
        model.init_weights(generator)
    if train:
        unfreeze_batch_norms(model)
    return model.train(train)


def trains_batch_norm(cfg) -> bool:
    """Whether ``build_model(cfg, train=True)`` holds batch norm that trains
    (a BN / SyncBN norm on one of the modules it builds), from the config
    alone, before anything is built."""
    bottom, pyramid, _ = _BACKBONES.get(cfg.MODEL.BACKBONE.NAME, ("", "fpn", ""))
    norms = [cfg.MODEL.BIFPN.NORM if pyramid == "bifpn" else cfg.MODEL.FPN.NORM]
    if bottom != "swin":
        norms.append(cfg.MODEL.RESNETS.NORM)
    if cfg.MODEL.META_ARCHITECTURE in ("FCOS", "CenterMask"):
        norms.append(cfg.MODEL.FCOS.NORM)
    else:
        if cfg.MODEL.ROI_BOX_HEAD.NUM_CONV:
            norms.append(cfg.MODEL.ROI_BOX_HEAD.NORM)
        if cfg.MODEL.MASK_ON and cfg.MODEL.ROI_HEADS.NAME != "Res5ROIHeads":
            norms.append(cfg.MODEL.ROI_MASK_HEAD.NORM)
    return any(n in ("BN", "SyncBN") for n in norms)


def build_guide_model(cfg, device="cuda", generator: Optional[torch.Generator] = None
                      ) -> RCNN_FPN_only:
    """GUIDE_ARCHITECTURE (``RCNN_FPN_only``) over ``MODEL.GUIDE_BACKBONE.NAME``:
    the frozen teacher of stages 1-2, in eval mode with no trainable
    parameter, on ``device`` (the GPU unless the caller asks for the CPU)."""
    device = check_device(device, "build_guide_model")
    arch = cfg.MODEL.GUIDE_ARCHITECTURE or "RCNN_FPN_only"
    if arch != "RCNN_FPN_only":
        raise KeyError(f"Unknown GUIDE_ARCHITECTURE: {arch}")
    model = RCNN_FPN_only(build_backbone(cfg, device, name=cfg.MODEL.GUIDE_BACKBONE.NAME),
                          pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
                          pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=compute_dtype(cfg),
                          device=device)
    if generator is not None:
        model.init_weights(generator)
    model.requires_grad_(False)
    return model.eval()
