"""Default configuration tree (the port's copy of
``afigan_tpu/config/defaults.py``; a CPU test holds the two equal).

Mirrors every detectron2-v0.1.1 key the reference consults plus the
AFI-GAN additions (ref: afigan/config/defaults.py:5-94), so the
reference's YAML config zoo loads verbatim through our CfgNode.

Notes vs the reference:
  * ``MODEL.SRF_FREEZE`` is defined here only so the Swin-BiFPN YAML
    loads (ref quirk Q5: configs/inference/AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml:32
    sets a key never read by code); the real flag is ``MODEL.AFI_FREEZE``.
  * The JAX package's ``TPU`` section is kept key for key (the port reads
    its compute dtype and padding buckets); the port's own keys go under
    ``CUDA``.
"""

from .node import CfgNode as CN

_C = CN()

_C.VERSION = 2
_C.OUTPUT_DIR = "./output"
_C.SEED = -1
_C.CUDNN_BENCHMARK = False  # accepted for config-compat; meaningless on TPU

# ---------------------------------------------------------------------------
# MODEL
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.DEVICE = "tpu"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.WEIGHTS = ""
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.LOAD_PROPOSALS = False
# BGR means/stds of the d2 zoo default (ImageNet, caffe2 style)
_C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

# AFI-GAN additions (ref afigan/config/defaults.py:5-11)
_C.MODEL.GUIDE_ARCHITECTURE = ""
_C.MODEL.GUIDE_WEIGHTS = ""
_C.MODEL.AFI_GEN_WEIGHTS = ""
_C.MODEL.AFI_DIS_WEIGHTS = ""
_C.MODEL.AF_EXTRACTOR_WEIGHTS = ""
_C.MODEL.AFI_FREEZE = False
_C.MODEL.SRF_FREEZE = False  # quirk Q5: accepted, never read

# AFI interpolator hyper-params (hard-coded in the reference:
# generator_rdb.py:75 and n_residual_dense_blocks=3 at fpn_sr.py:65)
_C.MODEL.AFI = CN()
_C.MODEL.AFI.IN_CHANNELS = 256
_C.MODEL.AFI.N_RDB = 3
_C.MODEL.AFI.GROWTH_RATE = 32
_C.MODEL.AFI.RESIDUAL_SCALE = 0.2
_C.MODEL.AFI.ADV_LOSS_WEIGHT = 1.0e-3  # ref stage1_trainer.py:411
# Pallas fused-RDB kernel (ops/pallas/afi_rdb.py): numerics-exact
# (interpret-mode tested), but this environment's remote Mosaic compile
# helper SIGKILLs on it — default off until the compile path is fixed.
_C.MODEL.AFI.FUSED_KERNEL = False

_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
_C.MODEL.BACKBONE.FREEZE_AT = 2

_C.MODEL.GUIDE_BACKBONE = CN()
_C.MODEL.GUIDE_BACKBONE.NAME = "build_resnet_fpn_backbone"
_C.MODEL.GUIDE_BACKBONE.FREEZE_AT = 2

_C.MODEL.FPN = CN()
_C.MODEL.FPN.IN_FEATURES = []
_C.MODEL.FPN.OUT_CHANNELS = 256
_C.MODEL.FPN.NORM = ""
_C.MODEL.FPN.FUSE_TYPE = "sum"
# "maxpool" (RCNN p6) or "p6p7" (RetinaNet/FCOS extra convs)
_C.MODEL.FPN.TOP_BLOCK = "maxpool"
_C.MODEL.FPN.TOP_BLOCK_IN_FEATURE = "p5"

_C.MODEL.BIFPN = CN()
_C.MODEL.BIFPN.IN_FEATURES = []
_C.MODEL.BIFPN.OUT_CHANNELS = 256
_C.MODEL.BIFPN.FPN_REPEAT = 3
_C.MODEL.BIFPN.NORM = "SyncBN"
_C.MODEL.BIFPN.FUSE_TYPE = "sum"

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 50
_C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
_C.MODEL.RESNETS.DEFORM_MODULATED = False
_C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1
# ResNeSt additions (ref afigan/config/defaults.py:32-41)
_C.MODEL.RESNETS.RADIX = 1
_C.MODEL.RESNETS.BOTTLENECK_WIDTH = 64
_C.MODEL.RESNETS.DEEP_STEM = False
_C.MODEL.RESNETS.AVD = False
_C.MODEL.RESNETS.AVG_DOWN = False

_C.MODEL.SWINT = CN()
_C.MODEL.SWINT.EMBED_DIM = 96
_C.MODEL.SWINT.OUT_FEATURES = ["stage2", "stage3", "stage4", "stage5"]
_C.MODEL.SWINT.DEPTHS = [2, 2, 6, 2]
_C.MODEL.SWINT.NUM_HEADS = [3, 6, 12, 24]
_C.MODEL.SWINT.WINDOW_SIZE = 7
_C.MODEL.SWINT.MLP_RATIO = 4
_C.MODEL.SWINT.DROP_PATH_RATE = 0.2
_C.MODEL.SWINT.APE = False

_C.MODEL.ANCHOR_GENERATOR = CN()
_C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
_C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
_C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
_C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

_C.MODEL.PROPOSAL_GENERATOR = CN()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

_C.MODEL.RPN = CN()
_C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
_C.MODEL.RPN.IN_FEATURES = ["res4"]
_C.MODEL.RPN.BOUNDARY_THRESH = -1
_C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
_C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
_C.MODEL.RPN.LOSS_WEIGHT = 1.0
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)

_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
_C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.NAME = ""
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
_C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
_C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NORM = ""
_C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

_C.MODEL.ROI_BOX_CASCADE_HEAD = CN()
_C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)
_C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = (0.5, 0.6, 0.7)

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
_C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASK_HEAD.NORM = ""
_C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
_C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

# Keypoint R-CNN head (d2 v0.1.1 KRCNNConvDeconvUpsampleHead defaults —
# the substrate behind the reference evaluator's OKS keypoint task,
# ref afigan/evaluation/coco_evaluation.py:477-511)
_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [512, 512, 512, 512, 512, 512, 512, 512]
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
_C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
_C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
_C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"

# FCOS head (BASELINE.json target config; external codebase in the reference,
# first-class citizen here)
_C.MODEL.FCOS = CN()
_C.MODEL.FCOS.NUM_CLASSES = 80
_C.MODEL.FCOS.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
_C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
_C.MODEL.FCOS.NUM_CONVS = 4
_C.MODEL.FCOS.PRIOR_PROB = 0.01
_C.MODEL.FCOS.INFERENCE_TH_TRAIN = 0.05
_C.MODEL.FCOS.INFERENCE_TH_TEST = 0.05
_C.MODEL.FCOS.NMS_TH = 0.6
_C.MODEL.FCOS.PRE_NMS_TOPK_TRAIN = 1000
_C.MODEL.FCOS.PRE_NMS_TOPK_TEST = 1000
_C.MODEL.FCOS.POST_NMS_TOPK_TRAIN = 100
_C.MODEL.FCOS.POST_NMS_TOPK_TEST = 100
_C.MODEL.FCOS.LOC_LOSS_TYPE = "giou"
_C.MODEL.FCOS.SIZES_OF_INTEREST = [64, 128, 256, 512]
_C.MODEL.FCOS.CENTER_SAMPLE = True
_C.MODEL.FCOS.POS_RADIUS = 1.5
_C.MODEL.FCOS.NORM = "GN"
_C.MODEL.FCOS.USE_SCALE = True
_C.MODEL.FCOS.THRESH_WITH_CTR = False
_C.MODEL.FCOS.CENTERNESS_ON_REG = True

# ---------------------------------------------------------------------------
# INPUT / DATASETS / DATALOADER
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.CROP = CN({"ENABLED": False})
_C.INPUT.CROP.TYPE = "relative_range"
_C.INPUT.CROP.SIZE = [0.9, 0.9]
# Framework extension: d2-style color jitter (BlendTransform weights
# sampled uniformly from the [lo, hi] ranges; ref transform_gen.py:312-417
# RandomContrast/RandomBrightness/RandomSaturation)
_C.INPUT.COLOR_JITTER = CN({"ENABLED": False})
_C.INPUT.COLOR_JITTER.BRIGHTNESS = [0.9, 1.1]
_C.INPUT.COLOR_JITTER.CONTRAST = [0.9, 1.1]
_C.INPUT.COLOR_JITTER.SATURATION = [0.9, 1.1]
_C.INPUT.FORMAT = "BGR"
_C.INPUT.MASK_FORMAT = "polygon"

_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()
_C.DATASETS.PROPOSAL_FILES_TRAIN = ()
_C.DATASETS.PROPOSAL_FILES_TEST = ()
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000
# Root dir holding COCO-format datasets (reference reads $DETECTRON2_DATASETS)
_C.DATASETS.ROOT = "datasets"

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
_C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
_C.DATALOADER.REPEAT_THRESHOLD = 0.0
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

# ---------------------------------------------------------------------------
# SOLVER
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.BIAS_LR_FACTOR = 1.0
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
_C.SOLVER.OPTIMIZER = "SGD"
_C.SOLVER.AMP = CN({"ENABLED": False})
_C.SOLVER.CLIP_GRADIENTS = CN({"ENABLED": False})
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0

# ---------------------------------------------------------------------------
# TEST
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EVAL_PERIOD = 0
_C.TEST.KEYPOINT_OKS_SIGMAS = []
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.AUG = CN({"ENABLED": False})
_C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
_C.TEST.AUG.MAX_SIZE = 4000
_C.TEST.AUG.FLIP = True
_C.TEST.PRECISE_BN = CN({"ENABLED": False})
_C.TEST.PRECISE_BN.NUM_ITER = 200

# ---------------------------------------------------------------------------
# TPU: the JAX package's section, kept key for key so that the repo's YAML
# files and command-line overrides load unchanged. The port reads
# COMPUTE_DTYPE and IMAGE_BUCKETS; the other keys select implementations
# of the JAX package and are not read here (the port always runs its CUDA
# kernels on the card and their plain versions on the CPU).
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Compute dtype inside models ("bfloat16" or "float32"); params stay fp32.
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Padding buckets for static image shapes: each (H, W) canvas; images are
# resized per INPUT.* then padded up to the smallest bucket that fits
# (rounded up to the model's size divisibility).
_C.TPU.IMAGE_BUCKETS = [[704, 704], [704, 1152], [1152, 704], [832, 1344], [1344, 832]]
_C.TPU.MAX_GT_BOXES = 100
_C.TPU.MASK_CANVAS = 112
_C.TPU.REMAT = False
_C.TPU.REMAT_MODE = "full"
_C.TPU.GRAD_ACCUM = 1
_C.TPU.APPROX_TOPK = True
_C.TPU.POOLER_IMPL = "pallas"
_C.TPU.SWIN_ATTN_IMPL = "xla"
_C.TPU.SWIN_LN_IMPL = "auto"
_C.TPU.SWIN_QKV_LAYOUT = "split"
_C.TPU.SWIN_SCORES_DTYPE = "bfloat16"
_C.TPU.TTA_BATCH = 1
_C.TPU.TTA_PIXEL_BUDGET = 4_500_000
_C.TPU.MESH_AXES = ["data"]
_C.TPU.MESH_SHAPE = [-1]

# ---------------------------------------------------------------------------
# CUDA: the port's own keys (none yet)
# ---------------------------------------------------------------------------
_C.CUDA = CN()


def get_default_cfg() -> CN:
    return _C.clone()
