"""Port BiFPN, cascade ROI heads and the Swin-BiFPN-Cascade slice vs the JAX
package, float32 on the CPU.

Same numpy inputs and the same weights (JAX init, perturbed so that batch-norm
statistics and fusion weights are off their defaults, carried by
``variables_to_state_dict``). Modules: rtol = atol = 1e-4 (f32 convs in another
summation order). Slice: the narrow model of ``torch_port_common.swin_cfg`` on
a 128x256 canvas, detections at the golden test's tolerances (valid and
classes equal, scores 1e-3, boxes 0.05 px), the JAX model through its Pallas
Swin kernels in interpret mode.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from afigan_tpu.models.bifpn import BiFPN as JaxBiFPN
from afigan_tpu.models.bifpn import _maxpool_same_s2 as jax_maxpool
from afigan_tpu.models.cascade_roi_heads import CascadeROIHeads as JaxCascade
from afigan_tpu.models.layers import SeparableConv as JaxSeparableConv
from afigan_tpu.models.rpn import RPNOutput as JaxRPNOutput
from afigan_tpu.utils.converters import state_dict_to_variables, translate_d2_key
from afigan_tpu_torch.data import required_size_divisibility
from afigan_tpu_torch.engine.inference import predict
from afigan_tpu_torch.models.bifpn import BiFPN, _maxpool_same_s2
from afigan_tpu_torch.models.cascade_roi_heads import CascadeROIHeads
from afigan_tpu_torch.models.layers import SeparableConv
from afigan_tpu_torch.models.rpn import RPNOutput
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import jax_and_port, swin_cfg


def _perturb(variables, seed=0):
    """Every 1-D leaf (norm scale/bias/mean/var, conv bias, fusion weights)
    moved off its init; variances stay positive."""
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        d = 0.2 * rng.rand(*a.shape).astype(np.float32)
        return a + d if path[-1].key == "var" else a + d - 0.1

    return jax.tree_util.tree_map_with_path(f, variables)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _load(module, sd, prefix):
    own = {k[len(prefix):]: torch.tensor(v) for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(own, strict=True)


@pytest.mark.parametrize("hw", [(8, 12), (7, 11), (2, 2)])
def test_maxpool_same_s2_matches_jax(hw):
    # negative maps: the zero padding wins the max at the right / bottom edge
    x = -np.random.RandomState(0).rand(2, *hw, 3).astype(np.float32) - 0.5
    got = _maxpool_same_s2(torch.from_numpy(x))
    want = jax_maxpool(jnp.asarray(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if hw[0] % 2 == 0 and hw[1] % 2 == 0:  # the last window reaches the padding
        assert (got.numpy()[:, -1, -1] == 0).all()


@pytest.mark.parametrize("norm", ["", "BN", "SyncBN"])
def test_separable_conv_matches_jax(norm):
    x = np.random.RandomState(1).randn(2, 9, 13, 16).astype(np.float32)
    jm = JaxSeparableConv(24, 3, norm=norm, bn_eps=1e-3, bn_momentum=0.99)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jm.apply(variables, jnp.asarray(x))
    tm = SeparableConv(16, 24, norm, bn_eps=1e-3)
    sd = variables_to_state_dict({
        coll: {"backbone": {"pyramid": {"layer0_conv3_up": tree}}}
        for coll, tree in variables.items()})
    _load(tm, sd, "backbone.BiFPNLayer_0_conv3_up.")
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), want)


class _Features(nn.Module):
    """A bottom-up network that hands its input (a feature dict) on."""

    def forward(self, feats):
        return feats


@pytest.mark.parametrize("interp,sizes", [
    # every level halves exactly (the 128-divisible canvas): the pool gives
    # floor(H/2) and the upsampling 2h, so an odd level fits neither package
    ("afi", [(16, 32), (8, 16), (4, 8)]),
    ("afi", [(32, 16), (16, 8), (8, 4)]),
    ("nearest", [(16, 48), (8, 24), (4, 12)]),
])
def test_bifpn_matches_jax(interp, sizes):
    rng = np.random.RandomState(2)
    chans = {"stage3": 12, "stage4": 20, "stage5": 28}
    feats = {f: rng.randn(2, *hw, c).astype(np.float32)
             for (f, c), hw in zip(chans.items(), sizes)}
    jm = JaxBiFPN(out_channels=16, fpn_repeat=2, norm="SyncBN", interp=interp,
                  afi_n_rdb=3, afi_growth_rate=8)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jfeats))())
    want = jax.jit(lambda v: jm.apply(v, jfeats))(variables)
    tm = BiFPN(_Features(), chans, out_channels=16, fpn_repeat=2, norm="SyncBN",
               interp=interp, afi_n_rdb=3, afi_growth_rate=8)
    sd = variables_to_state_dict(
        {c: {"backbone": {"pyramid": t}} for c, t in variables.items()})
    _load(tm, sd, "backbone.")
    assert "BiFPNLayer_1_p7_w2" in tm.state_dict()
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in feats.items()})
    assert list(got) == list(want) == ["p3", "p4", "p5", "p6", "p7"]
    for lvl in got:
        _close(got[lvl], want[lvl])


def test_bifpn_rejects_canvas_not_divisible_by_128():
    tm = BiFPN(_Features(), {"stage3": 4, "stage4": 4, "stage5": 4}, out_channels=8,
               fpn_repeat=1, norm="", interp="nearest")
    feats = {f"stage{i + 3}": torch.zeros(1, h, h, 4) for i, h in enumerate((12, 6, 3))}
    with pytest.raises(ValueError, match="128-divisible"):
        tm(feats)
    cfg = swin_cfg()
    assert required_size_divisibility(cfg) == 128
    cfg.MODEL.BACKBONE.NAME = "build_resnet_fpn_sr_backbone"
    assert required_size_divisibility(cfg) == 64


def test_cascade_roi_heads_inference_matches_jax():
    rng = np.random.RandomState(3)
    strides, c, b, k = (8, 16, 32, 64), 16, 2, 40
    feats = {f"p{i + 3}": rng.randn(b, 128 // s, 192 // s, c).astype(np.float32)
             for i, s in enumerate(strides)}
    xy = rng.rand(b, k, 2) * [150.0, 90.0]
    wh = np.exp(rng.rand(b, k, 2) * np.log(16)) * 8
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(b, k) > 0.1
    scores = rng.randn(b, k).astype(np.float32)
    sizes = np.asarray([[128, 192], [120, 170]], np.int32)
    kw = dict(num_classes=5, in_features=tuple(feats), strides=strides,
              box_num_conv=2, box_conv_dim=24, box_num_fc=1, box_fc_dim=32,
              cls_agnostic_bbox_reg=True, score_thresh=0.0, detections_per_image=20)
    weights = ((10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0))
    jm = JaxCascade(box_norm="SyncBN", pooler_impl="gather",
                    cascade_bbox_reg_weights=weights, **kw)
    jargs = ({f: jnp.asarray(v) for f, v in feats.items()},
             JaxRPNOutput(jnp.asarray(props), jnp.asarray(scores), jnp.asarray(valid)),
             jnp.asarray(sizes))
    variables = jax.jit(lambda: jm.init(jax.random.PRNGKey(0), *jargs))()
    # the init's 0.01 / 0.001 predictor weights barely move the boxes: scale
    # them up so that every stage refines and reclassifies
    variables = _perturb(jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a) * (30.0 if "box_predictor" in p[1].key else 1.0),
        variables), seed=1)
    want, _ = jax.jit(lambda v: jm.apply(v, *jargs))(variables)
    tm = CascadeROIHeads(in_channels=c, box_norm="SyncBN",
                         cascade_bbox_reg_weights=weights, **kw)
    sd = variables_to_state_dict({coll: {"roi_heads": t} for coll, t in variables.items()})
    assert "roi_heads.box_head.2.conv2.norm.running_var" in sd
    _load(tm, sd, "roi_heads.")
    with torch.no_grad():
        got, masks = tm({f: torch.from_numpy(v) for f, v in feats.items()},
                        RPNOutput(*(torch.from_numpy(a) for a in (props, scores, valid))),
                        torch.from_numpy(sizes))
    assert masks is None
    jv, tv = np.asarray(want.valid), got.valid.numpy()
    assert jv.sum() >= 20
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(got.classes.numpy()[tv], np.asarray(want.classes)[jv])
    np.testing.assert_allclose(got.scores.numpy()[tv], np.asarray(want.scores)[jv],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.boxes.numpy()[tv], np.asarray(want.boxes)[jv],
                               rtol=0, atol=1e-2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def slice_models():
    cfg = swin_cfg()
    return cfg, jax_and_port(cfg, canvas=(128, 256))


def test_swin_slice_converters_round_trip(slice_models):
    _, (_, variables, tm, sd) = slice_models
    for key in ("backbone.bottom_up.layers.2.blocks.1.attn.relative_position_bias_table",
                "backbone.bottom_up.layers.0.downsample.reduction.weight",
                "backbone.before_bifpn.top_block.p6.norm.running_mean",
                "backbone.BiFPNLayer_1_conv4_down.depthwise.weight",
                "backbone.BiFPNLayer_0_p7_w2",
                "roi_heads.box_head.2.conv4.norm.running_var",
                "roi_heads.box_predictor.1.bbox_pred.weight"):
        assert key in sd, key
    variables = jax.tree.map(np.asarray, variables)
    back, report = state_dict_to_variables(
        {k: v.numpy() for k, v in tm.state_dict().items()}, template=variables,
        translate=functools.partial(translate_d2_key, frozen_bn=False))
    assert not report["unmatched"] and not report["mismatched"]
    n = 0
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables[coll]):
            node = back[coll]
            for p in path:
                node = node[p]
            np.testing.assert_array_equal(node, leaf, err_msg="/".join(path))
            n += 1
    assert n == len(report["matched"]) == len(sd)


def test_swin_slice_detections_match_jax(slice_models):
    cfg, (jm, variables, tm, _) = slice_models
    assert cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads" and not cfg.MODEL.MASK_ON
    rng = np.random.RandomState(42)
    img = rng.rand(1, 128, 256, 3).astype(np.float32) * 255.0
    sizes = np.asarray([[96, 250]], np.int32)
    dets, masks = jax.jit(lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(sizes)))(
        variables)
    td, tmasks = predict(tm, {"image": img, "image_sizes": sizes})
    assert masks is None and tmasks is None
    jv, tv = np.asarray(dets.valid[0]), td.valid[0].numpy()
    assert jv.sum() > 0
    np.testing.assert_array_equal(tv, jv, "valid")
    np.testing.assert_array_equal(td.classes[0].numpy()[tv], np.asarray(dets.classes[0])[jv],
                                  "classes")
    np.testing.assert_allclose(td.scores[0].numpy()[tv], np.asarray(dets.scores[0])[jv],
                               rtol=0, atol=1e-3, err_msg="scores")
    np.testing.assert_allclose(td.boxes[0].numpy()[tv], np.asarray(dets.boxes[0])[jv],
                               rtol=0, atol=0.05, err_msg="boxes(px)")
    assert tuple(td.boxes.shape) == (1, 16, 4)


def test_swin_slice_run_inference_matches_jax(slice_models, tmp_path):
    """The eval loop on the Swin path: the port's loader pads to the
    128-divisible canvas, and its evaluator sees the JAX run's predictions
    (same images and categories, boxes within 0.05 px, scores within 1e-3)."""
    from afigan_tpu.data.coco import CocoDataset as JaxDataset
    from afigan_tpu.engine.inference import run_inference as jax_run_inference
    from afigan_tpu.evaluation.coco_eval import CocoEvaluator as JaxEvaluator
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.engine.inference import run_inference
    from afigan_tpu_torch.evaluation import CocoEvaluator
    from tests.fixtures import make_tiny_coco

    cfg, (jm, variables, tm, _) = slice_models
    json_path, img_dir = make_tiny_coco(str(tmp_path), num_images=2, hw=(96, 200))
    seen = {}

    def capture(cls, key):
        orig = cls.evaluate

        def evaluate(self):
            seen[key] = list(self.predictions)
            return orig(self)
        return evaluate

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxEvaluator, "evaluate", capture(JaxEvaluator, "jax"))
        mp.setattr(CocoEvaluator, "evaluate", capture(CocoEvaluator, "port"))
        want = jax_run_inference(cfg, jm, variables, JaxDataset(json_path, img_dir))
        got = run_inference(cfg, tm, CocoDataset(json_path, img_dir), batch_size=2)
    assert set(got) == set(want) == {"bbox"}
    np.testing.assert_allclose(got["bbox"]["AP"], want["bbox"]["AP"], rtol=0, atol=1e-3)
    assert len(seen["port"]) == len(seen["jax"]) == 2 * 16
    for g, w in zip(seen["port"], seen["jax"]):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.05)
        assert abs(g["score"] - w["score"]) <= 1e-3
