"""Shared set-up of the slice-level port tests (not collected by pytest).

The configuration is tests/test_golden_regression.py's, built from the
repo's configs/Base-RCNN-FPN-AFIGAN.yaml, with the AF interpolator at its
main-path depth (3 dense blocks) and growth rate 8.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Under pytest-xdist each worker process has its own torch thread pool, one
# thread a core by default: six workers beside XLA's own pools oversubscribe
# the cores many times over (a port CLI test took 6 s alone and 257 s in the
# suite). Every worker imports this module when it collects the port's tests,
# so each gets its share of the cores here, and at least two threads: torch's
# single-threaded CPU convolutions sum in another order, which moves a
# gradient of tests/test_torch_port_train_step.py past its bound.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(2, (os.cpu_count() or 1) // _WORKERS))

GOLDEN_OVERRIDES = [
    "MODEL.MASK_ON", "True",
    "MODEL.RESNETS.DEPTH", "50",
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "TEST.DETECTIONS_PER_IMAGE", "16",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
    "MODEL.AFI.N_RDB", "3",
    "MODEL.AFI.GROWTH_RATE", "8",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)",
]


def golden_cfg():
    from afigan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/Base-RCNN-FPN-AFIGAN.yaml"))
    cfg.merge_from_list(list(GOLDEN_OVERRIDES))
    return cfg


def small_cfg():
    """The full main-path tree (ResNet-50, FPN, AFI with 3 RDBs, RPN, box and
    mask heads) of the inference YAML at narrow widths, float32."""
    from afigan_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/inference/AFI-GAN_maskrcnn_R_50_FPN.yaml"))
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.FPN.OUT_CHANNELS = 16
    cfg.MODEL.AFI.GROWTH_RATE = 8
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 32
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 16
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    return cfg


SWIN_OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32",
    # the JAX model through its Pallas kernels (interpret mode on the CPU),
    # which the port follows
    "TPU.SWIN_ATTN_IMPL", "pallas",
    "TPU.SWIN_LN_IMPL", "pallas",
    "MODEL.SWINT.EMBED_DIM", "24",
    "MODEL.SWINT.DEPTHS", "(2, 2, 2, 2)",
    "MODEL.SWINT.NUM_HEADS", "(1, 2, 4, 8)",
    "MODEL.SWINT.WINDOW_SIZE", "4",
    "MODEL.BIFPN.OUT_CHANNELS", "32",
    "MODEL.BIFPN.FPN_REPEAT", "2",
    "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.ROI_BOX_HEAD.CONV_DIM", "32",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "TEST.DETECTIONS_PER_IMAGE", "16",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "256",
    "TPU.IMAGE_BUCKETS", "((128, 256),)",
]


def swin_cfg():
    """The flagship YAML (Cascade R-CNN, Swin + BiFPN(AFI)) at narrow widths:
    embed 24, depths 2-2-2-2, window 4, BiFPN 2 x 32 channels, float32."""
    from afigan_tpu_torch.config import swin_path_cfg

    cfg = swin_path_cfg()
    cfg.merge_from_list(list(SWIN_OVERRIDES))
    return cfg


FCOS_OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.FPN.OUT_CHANNELS", "32",
    "MODEL.BIFPN.OUT_CHANNELS", "32",
    "MODEL.BIFPN.FPN_REPEAT", "2",
    "MODEL.AFI.N_RDB", "1",
    "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.FCOS.NUM_CLASSES", "3",
    "MODEL.FCOS.NUM_CONVS", "1",
    "MODEL.FCOS.INFERENCE_TH_TEST", "0.0",
    "MODEL.FCOS.PRE_NMS_TOPK_TEST", "128",
    "MODEL.FCOS.POST_NMS_TOPK_TEST", "16",
    "TEST.DETECTIONS_PER_IMAGE", "16",
    "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)",
]


def fcos_cfg(yaml_name):
    """One of the FCOS / CenterMask inference YAMLs at narrow widths (the
    golden FCOS test's settings: one tower conv, 3 classes, threshold 0, 128
    candidates per level, 16 detections), float32, 128x128 canvas."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(f"inference/{yaml_name}")
    cfg.merge_from_list(list(FCOS_OVERRIDES))
    return cfg


def jax_and_port(cfg, canvas=(128, 128), edit=None):
    """(JAX model, its PRNGKey(0) variables, the port model with the same
    weights through ``variables_to_state_dict``). ``edit`` maps the numpy
    variables to the ones both models get."""
    from afigan_tpu.models import build_model as jax_build
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.utils.converters import variables_to_state_dict

    jm = jax_build(cfg, train=False)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *canvas, 3), jnp.float32),
        jnp.asarray([list(canvas)], jnp.int32)))()
    if edit is not None:
        variables = edit(jax.tree.map(np.asarray, variables))
    sd = variables_to_state_dict(jax.tree.map(np.asarray, variables))
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jm, variables, tm, sd


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_template(jm, canvas):
    """The JAX model's variables as zeros of their shapes, from
    ``jax.eval_shape`` of its init: nothing is compiled or run."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *canvas, 3), jnp.float32),
        jnp.asarray([list(canvas)], jnp.int32)))
    return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def port_and_jax(cfg, canvas=(128, 128), seed=0, predictor_scale=30.0, cls_scale=3.0):
    """(JAX model, its variables, the port model) with one set of weights,
    drawn the other way round from ``jax_and_port``: the port's init from a
    seeded ``torch.Generator``; every 1-D entry (norm statistics and affine,
    biases, fusion weights) moved off its init by a seeded numpy draw
    (variances stay positive); the box regression and mask predictors scaled
    by ``predictor_scale`` and the class scores by ``cls_scale``, so that
    boxes, masks and scores depend on the features without saturating; then into the JAX tree by the JAX package's own
    ``state_dict_to_variables`` against the JAX model's template, every
    leaf filled and no key left over. No JAX init is compiled."""
    import functools

    from afigan_tpu.models import build_model as jax_build
    from afigan_tpu.utils.converters import state_dict_to_variables, translate_d2_key
    from afigan_tpu_torch.models import build_model

    tm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in tm.state_dict().items():
        a = v.numpy().copy()
        if a.ndim == 1:
            d = 0.2 * rng.rand(*a.shape).astype(np.float32)
            a = a + d if k.endswith("running_var") else a + d - 0.1
        elif k.endswith(("bbox_pred.weight", "mask_head.predictor.weight")):
            a = a * predictor_scale
        elif k.endswith("cls_score.weight"):
            a = a * cls_scale
        sd[k] = a
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    jm = jax_build(cfg, train=False)
    template = jax_template(jm, canvas)
    variables, report = state_dict_to_variables(
        sd, template=template, translate=functools.partial(
            translate_d2_key, frozen_bn=cfg.MODEL.RESNETS.NORM == "FrozenBN"))
    assert not report["unmatched"] and not report["mismatched"], report
    n_leaves = sum(1 for coll in template.values() for _ in _leaves(coll))
    assert len(report["matched"]) == n_leaves == len(sd)
    return jm, variables, tm


BREADTH_OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.RESNETS.DEPTH", "50",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.FPN.OUT_CHANNELS", "16",
    "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.ROI_BOX_HEAD.CONV_DIM", "16",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "32",
    "MODEL.ROI_MASK_HEAD.CONV_DIM", "16",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
    "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "128",
    "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
    "TEST.DETECTIONS_PER_IMAGE", "16",
    "INPUT.MIN_SIZE_TEST", "96",
    "INPUT.MAX_SIZE_TEST", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)",
]


def breadth_cfg(yaml_name, *overrides):
    """One of the PAFPN / ResNeSt inference YAMLs at narrow widths (depth
    50, pyramid 16 channels, growth 8, 3 classes) and the golden test's
    settings (every class scored, 128/64 proposals, 16 detections), float32,
    128x128 canvas; ``overrides`` are merged last."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(f"inference/{yaml_name}")
    cfg.merge_from_list(list(BREADTH_OVERRIDES) + list(overrides))
    return cfg


def assert_detections_match(got, got_masks, want, want_masks):
    """Batch entry 0 at the golden tolerances: valid and classes equal,
    scores 1e-3, boxes 0.05 px; each mask's sum of probabilities 5e-3
    relative."""
    jv, tv = np.asarray(want.valid[0]), got.valid[0].numpy()
    assert jv.sum() > 0
    np.testing.assert_array_equal(tv, jv, "valid")
    np.testing.assert_array_equal(got.classes[0].numpy()[tv], np.asarray(want.classes[0])[jv],
                                  "classes")
    np.testing.assert_allclose(got.scores[0].numpy()[tv], np.asarray(want.scores[0])[jv],
                               rtol=0, atol=1e-3, err_msg="scores")
    np.testing.assert_allclose(got.boxes[0].numpy()[tv], np.asarray(want.boxes[0])[jv],
                               rtol=0, atol=0.05, err_msg="boxes(px)")
    assert (got_masks is None) == (want_masks is None)
    if want_masks is not None:
        ws = np.asarray(want_masks[0]).sum(axis=(1, 2))[jv]
        gs = got_masks[0].sum(dim=(1, 2)).numpy()[tv]
        np.testing.assert_allclose(gs, ws, rtol=5e-3, atol=0, err_msg="mask sums")


def keypoint_scene_coco(root, num_images=4, hw=(96, 128)):
    """The validation tool's generated scenes (3 keypoints an object) as a
    COCO set under ``root``, with the keypoints named so that a flip swaps
    the last two, and the second of every third object invisible: (json,
    image dir)."""
    import json

    from afigan_tpu_torch.tools.validate_training import make_scene_coco

    json_path, img_dir = make_scene_coco(str(root), num_images=num_images, hw=hw)
    with open(json_path) as f:
        js = json.load(f)
    for c in js["categories"]:
        c["keypoints"] = ["center", "left_corner", "right_corner"]
    for a in js["annotations"][::3]:
        a["keypoints"][5] = 0
    with open(json_path, "w") as f:
        json.dump(js, f)
    return json_path, img_dir
