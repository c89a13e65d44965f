"""Port ResNeSt, the normed mask head and the Cascade Mask R-CNN
ResNeSt-FPN / -PAFPN detectors against the JAX package, float32 on the CPU.

Modules (``SplAtConv2d`` at radix 2 with cardinality 1 and 2 and at radix 1,
the bottleneck with AVD and the average-pooled shortcut, the deep stem, the
mask head with SyncBN, the depth-50 bottom-up inside the detector): the JAX
module's weights, every 1-D leaf moved off its init, carried by the port's
``variables_to_state_dict``; ``max|port - jax| <= 1e-4 max|jax| + 1e-5``.
Depth 101: the port's state-dict keys and shapes equal the converted JAX
template's (no JAX forward). Detectors: both ResNeSt YAMLs at narrow widths
(``torch_port_common.breadth_cfg``, depth 50: ResNeSt has stems only for 50,
101 and 152), one set of weights in both packages (``port_and_jax``),
detections at the golden tolerances and mask sums at 5e-3 relative.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models import build_model as jax_build
from afigan_tpu.models.mask_head import MaskRCNNConvUpsampleHead as JaxMaskHead
from afigan_tpu.models.resnest import DeepStem as JaxDeepStem
from afigan_tpu.models.resnest import ResNeStBottleneck as JaxBottleneck
from afigan_tpu.models.resnest import SplAtConv2d as JaxSplAt
from afigan_tpu_torch.engine.inference import predict
from afigan_tpu_torch.models import build_model
from afigan_tpu_torch.models.mask_head import MaskRCNNConvUpsampleHead
from afigan_tpu_torch.models.resnest import DeepStem, ResNeStBottleneck, SplAtConv2d
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import (assert_detections_match, breadth_cfg, jax_template,
                                     port_and_jax)

YAMLS = ("AFI-GAN_cascade_mask_rcnn_ResNeSt101_FPN.yaml",
         "AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml")


def _perturb(variables, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        d = 0.2 * rng.rand(*a.shape).astype(np.float32)
        return a + d if path[-1].key == "var" else a + d - 0.1

    return jax.tree_util.tree_map_with_path(f, variables)


def _close_rel(got, want, rel=1e-4, abs_=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + abs_, (err, np.abs(want).max())


def _check_module(jm, tm, x, wrap, prefix):
    """Init ``jm`` on ``x``, perturb, convert the tree placed at ``wrap``
    through ``variables_to_state_dict``, load the keys under ``prefix`` into
    ``tm`` (all of them, strictly) and compare the outputs."""
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    sd = variables_to_state_dict({c: wrap(t) for c, t in variables.items()})
    assert all(k.startswith(prefix) for k in sd)
    tm.load_state_dict({k[len(prefix):]: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close_rel(got, want)
    return sd


def _in_block(tree, stage="res3", name="conv2"):
    return {"backbone": {"bottom_up": {f"{stage}/block0": {name: tree} if name else tree}}}


@pytest.mark.parametrize("radix,card,stride", [(2, 1, 1), (2, 2, 1), (2, 2, 2), (1, 2, 1)])
def test_splat_conv_matches_jax(radix, card, stride):
    """Cardinality 2 puts the fc2 output in the grouped conv's [card][r][c/card]
    layout, which the rSoftMax must transpose back to the chunks'
    [r][card][c/card] (the YAMLs use cardinality 1, where both coincide)."""
    x = np.random.RandomState(2).randn(2, 9, 11, 16).astype(np.float32)
    jm = JaxSplAt(channels=16, kernel_size=3, stride=stride, groups=card, radix=radix,
                  norm="SyncBN")
    tm = SplAtConv2d(16, 16, 3, stride, groups=card, radix=radix, norm="SyncBN")
    sd = _check_module(jm, tm, x, _in_block, "backbone.bottom_up.res3.0.conv2.")
    assert {k.split(".")[5] for k in sd} == {"conv", "bn0", "fc1", "bn1", "fc2"}


@pytest.mark.parametrize("stride,avd,avg_down,radix", [
    (2, True, True, 2), (2, False, False, 2), (1, True, True, 2), (2, True, True, 1)])
def test_bottleneck_matches_jax(stride, avd, avg_down, radix):
    x = np.random.RandomState(3).randn(2, 10, 14, 16).astype(np.float32)
    kw = dict(stride=stride, num_groups=1, norm="SyncBN", stride_in_1x1=False, radix=radix,
              avd=avd, avg_down=avg_down)
    jm = JaxBottleneck(out_channels=32, bottleneck_channels=8, **kw)
    tm = ResNeStBottleneck(16, 32, 8, **kw)
    sd = _check_module(jm, tm, x, lambda t: _in_block(t, name=None),
                       "backbone.bottom_up.res3.0.")
    assert "backbone.bottom_up.res3.0.shortcut.norm.running_var" in sd


def test_deep_stem_matches_jax():
    x = np.random.RandomState(4).randn(2, 32, 48, 3).astype(np.float32)
    sd = _check_module(JaxDeepStem(stem_width=8, norm="SyncBN"), DeepStem(8, "SyncBN"), x,
                       lambda t: {"backbone": {"bottom_up": {"stem": t}}},
                       "backbone.bottom_up.stem.")
    assert "backbone.bottom_up.stem.conv1_3.norm.running_mean" in sd


def test_mask_head_with_norm_matches_jax():
    x = np.random.RandomState(5).randn(5, 14, 14, 16).astype(np.float32)
    jm = JaxMaskHead(num_classes=3, num_conv=2, conv_dim=16, norm="SyncBN")
    tm = MaskRCNNConvUpsampleHead(16, 3, num_conv=2, conv_dim=16, norm="SyncBN")
    sd = _check_module(jm, tm, x, lambda t: {"roi_heads": {"mask_head": t}},
                       "roi_heads.mask_head.")
    assert "roi_heads.mask_head.mask_fcn2.norm.running_var" in sd
    assert "roi_heads.mask_head.mask_fcn2.bias" not in sd


def test_depth101_state_dict_keys_match_the_converter():
    """The JAX ResNeSt-101 cascade mask model's variables (shapes only, from
    ``jax.eval_shape``) through the port's converter give exactly the port
    model's keys and shapes: nothing missing, nothing unused."""
    cfg = breadth_cfg(YAMLS[1], "MODEL.RESNETS.DEPTH", "101")
    template = jax_template(jax_build(cfg, train=False), (128, 128))
    sd = variables_to_state_dict(template)
    own = build_model(cfg, device="cpu").state_dict()
    assert sd.keys() == own.keys()
    for k, v in own.items():
        assert sd[k].shape == tuple(v.shape), k
    assert "backbone.bottom_up.res4.22.conv2.fc2.bias" in own  # 23 res4 blocks
    assert "backbone.bottom_up.res4.23.conv1.weight" not in own
    assert own["backbone.bottom_up.stem.conv1_3.weight"].shape[0] == 128  # stem width 64


@functools.lru_cache(maxsize=None)
def _detector(yaml):
    cfg = breadth_cfg(yaml)
    return cfg, port_and_jax(cfg)


def _image():
    rng = np.random.RandomState(42)
    return (rng.rand(1, 128, 128, 3).astype(np.float32) * 255.0,
            np.asarray([[96, 128]], np.int32))


def test_resnest50_bottom_up_matches_jax():
    cfg, (jm, variables, tm) = _detector(YAMLS[0])
    img, _ = _image()
    x = (img - np.asarray(cfg.MODEL.PIXEL_MEAN, np.float32)) / np.asarray(
        cfg.MODEL.PIXEL_STD, np.float32)
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x),
                                      method=lambda m, y: m.backbone.bottom_up(y)))(variables)
    with torch.no_grad():
        got = tm.backbone.bottom_up(torch.from_numpy(x))
    assert list(got) == ["res2", "res3", "res4", "res5"]
    for k in got:
        _close_rel(got[k], want[k])


@pytest.mark.parametrize("yaml", YAMLS)
def test_cascade_mask_resnest_matches_jax(yaml):
    cfg, (jm, variables, tm) = _detector(yaml)
    assert cfg.MODEL.ROI_HEADS.NAME == "CascadeROIHeads" and cfg.MODEL.MASK_ON
    assert cfg.MODEL.ROI_MASK_HEAD.NORM == cfg.MODEL.FPN.NORM == "SyncBN"
    img, sizes = _image()
    dets, masks = jax.jit(lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(sizes)))(
        variables)
    td, tmasks = predict(tm, {"image": img, "image_sizes": sizes})
    assert_detections_match(td, tmasks, dets, masks)
