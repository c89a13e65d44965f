"""The narrow configs and batches of the port's trainer tests (no JAX import:
the tests on the card use it too; not collected by pytest)."""

# a narrow Mask R-CNN R-50-FPN(AFI) for the stage 1-3 trainers and CLIs on
# tests/fixtures.py's tiny COCO (96x128 images, 128x128 canvas)
GAN_TINY = [
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "16",
    "MODEL.AFI.IN_CHANNELS", "16", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "4",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "16",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    # the half scale sees shorter sides of 48-56: every box stays valid
    "INPUT.MIN_SIZE_TRAIN", "(96, 112)", "INPUT.MAX_SIZE_TRAIN", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)", "TPU.MAX_GT_BOXES", "8", "TPU.MASK_CANVAS", "28",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001", "SOLVER.CHECKPOINT_PERIOD", "2",
    "SEED", "3",
]

# the FCOS R-50-BiFPN step-2 YAML at narrow widths (the BiFPN and D of
# tests/test_stage2_fcos_bifpn.py, a ResNet-50 at an eighth of its widths)
FCOS_NARROW = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2",
    "MODEL.AFI.IN_CHANNELS", "32", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]

# the CenterMask R-50-BiFPN YAML trained as the JAX bench does (AF interpolator
# not frozen) at the same widths; its FCOS decode of training at threshold 0
# with 64 / 16 candidates, so that the mask branch samples the head's own
# detections; 8 GT slots (max_fg 8)
CENTERMASK_NARROW = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI_FREEZE", "False",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.BIFPN.OUT_CHANNELS", "32",
    "MODEL.BIFPN.FPN_REPEAT", "2", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3",
    "MODEL.FCOS.INFERENCE_TH_TRAIN", "0.0", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "64",
    "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "16", "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
    "TPU.MAX_GT_BOXES", "8", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]

# the Cascade Mask R-CNN ResNeSt-PAFPN YAML trained as the JAX bench's s101
# mode does (AF interpolator not frozen) at the widths of chip_smoke.py's
# narrow_resnest_cfg (depth 50, res2 32, 8 a group, pyramid and heads at 32,
# fc 64, 3 classes), one dense block, RPN 64 / 32 proposals, 16 anchors and 16
# ROIs sampled an image; SyncBN everywhere, FREEZE_AT 2
CASCADE_NARROW = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI_FREEZE", "False",
    "MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "32",
    "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.ROI_BOX_HEAD.CONV_DIM", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "MODEL.ROI_MASK_HEAD.CONV_DIM", "32", "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]

# the Swin-BiFPN(AF interpolator) cascade YAML trained with the AF
# interpolator (MODEL.AFI_FREEZE False) at the JAX flagship test's tiny widths
# (tests/test_swin_bifpn_flagship.py::_cfg: embed 24, heads 1-2-4-8, window 4,
# BiFPN 2 x 32 with BN, one dense block, a 1-conv BN box head, no masks) with
# depths 1-2-2-1, so that shifted blocks with masks run on maps wider than a
# window; RPN 64 / 32 proposals, 16 anchors and 16 ROIs sampled an image
SWIN_NARROW = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI_FREEZE", "False",
    "MODEL.SWINT.EMBED_DIM", "24", "MODEL.SWINT.DEPTHS", "(1, 2, 2, 1)",
    "MODEL.SWINT.NUM_HEADS", "(1, 2, 4, 8)", "MODEL.SWINT.WINDOW_SIZE", "4",
    "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2", "MODEL.BIFPN.NORM", "BN",
    "MODEL.AFI.IN_CHANNELS", "32", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.ROI_BOX_HEAD.NUM_CONV", "1", "MODEL.ROI_BOX_HEAD.NORM", "BN",
    "MODEL.ROI_MASK_HEAD.NORM", "BN", "MODEL.MASK_ON", "False",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "TEST.DETECTIONS_PER_IMAGE", "8", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]


def fcos_stage2_batch(gt):
    """A collated dual-scale batch of two 256x512 images, their 2x2-mean
    halves (128x256) and the half-scale GT ``gt`` (boxes, classes, valid). On
    a 128x128 half p7 would be one pixel an image, and D's batch norm over
    the batch's two values a channel is ill-conditioned (the summation order
    alone moves D's losses and update by percents); at 128x256 it normalises
    four. Each image is noise over a ramp of its own direction, so that those
    values differ."""
    import numpy as np

    img = np.random.RandomState(5).rand(2, 256, 512, 3).astype(np.float32) * 127
    img[0] += 128 * np.linspace(0.0, 1.0, 512, dtype=np.float32)[None, :, None]
    img[1] += 128 * np.linspace(1.0, 0.0, 256, dtype=np.float32)[:, None, None]
    boxes, classes, valid = gt
    return {"image": img, "image_x0.5": img.reshape(2, 128, 2, 256, 2, 3).mean(axis=(2, 4)),
            "image_sizes_x0.5": np.asarray([[128, 256]] * 2, np.int32),
            "gt_x0.5": {"boxes": boxes, "classes": classes, "valid": valid}}


def centermask_batch():
    """Two 128x256 images, 8 GT slots with 4 valid boxes each, 28x28 masks."""
    import numpy as np

    rs = np.random.RandomState(3)
    b, m = 2, 8
    boxes = np.zeros((b, m, 4), np.float32)
    boxes[:, :4] = [[8, 8, 60, 48], [30, 40, 100, 90], [120, 10, 200, 120], [150, 60, 250, 126]]
    boxes[1, :4] += 4.0
    return {"image": (rs.rand(b, 128, 256, 3) * 255).astype(np.float32),
            "image_sizes": np.asarray([[128, 256]] * b, np.int32),
            "gt": {"boxes": boxes, "classes": rs.randint(0, 3, (b, m)).astype(np.int32),
                   "valid": np.arange(m)[None].repeat(b, 0) < 4,
                   "masks": (rs.rand(b, m, 28, 28) > 0.5).astype(np.float32)}}
