"""The narrow stage 1-3 config of the port's trainer tests (no JAX import:
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
