"""Port FCOS and CenterMask vs the JAX package, float32 on the CPU.

Same numpy inputs and the same weights (JAX init, 0- and 1-D leaves moved off
their defaults, carried by ``variables_to_state_dict`` and loaded with
``strict=True``). Modules (GroupNorm, the ``p6p7`` top block, ``FCOSHead``,
``compute_locations``, the FCOS decode, ``SAGMaskHead``): rtol = atol = 1e-4,
f32 convs in another summation order. Slices: the three inference YAMLs
(FCOS R-50-FPN, FCOS R-50-BiFPN, CenterMask R-50-BiFPN) at the narrow size of
``torch_port_common.fcos_cfg`` on a 128x128 canvas: valid and classes equal,
scores 1e-4, boxes 0.05 px, masks 1e-3, the CenterMask port under
``TPU.POOLER_IMPL`` pallas, windowed and gather.

Ties: the port takes each level's candidates with a stable descending sort,
which puts the lowest index first among equal scores as ``lax.top_k`` does, so
the decode is compared slot by slot, rejected (score 0) candidates included.
"""

import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from afigan_tpu.models.centermask import SAGMaskHead as JaxSAGMaskHead
from afigan_tpu.models.fcos import FCOS as JaxFCOS
from afigan_tpu.models.fcos import FCOSHead as JaxFCOSHead
from afigan_tpu.models.fcos import compute_locations as jax_locations
from afigan_tpu.models.fpn import FPN as JaxFPN
from afigan_tpu.models.layers import get_norm as jax_get_norm
from afigan_tpu_torch.config import centermask_path_cfg
from afigan_tpu_torch.data import required_size_divisibility
from afigan_tpu_torch.engine.inference import predict
from afigan_tpu_torch.models import build_model
from afigan_tpu_torch.models.centermask import CenterMask, SAGMaskHead
from afigan_tpu_torch.models.fcos import FCOS, FCOSHead, compute_locations, fcos_inference
from afigan_tpu_torch.models.fpn import FPN
from afigan_tpu_torch.models.layers import get_norm
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import FCOS_OVERRIDES, REPO, fcos_cfg, jax_and_port


def _perturb(variables, seed=0):
    """Every 0- and 1-D leaf (norm scale and bias, conv bias, level scales)
    moved off its init."""
    rng = np.random.RandomState(seed)

    def f(a):
        a = np.asarray(a)
        if a.ndim > 1:
            return a
        return np.asarray(a + 0.4 * rng.rand(*a.shape) - 0.2, np.float32)

    return jax.tree.map(f, variables)


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _load(module, sd, prefix):
    own = {k[len(prefix):]: torch.tensor(v) for k, v in sd.items() if k.startswith(prefix)}
    module.load_state_dict(own, strict=True)


@pytest.mark.parametrize("c,hw", [(160, (9, 13)), (64, (6, 5)), (32, (1, 1))])
def test_group_norm_matches_jax(c, hw):
    # 160 channels are 5 per group; a 1x1 map of 32 channels is one value per group
    x = np.random.RandomState(0).randn(2, *hw, c).astype(np.float32) * 2 + 0.5
    jm = jax_get_norm("GN", c)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = get_norm("GN", c)
    assert tm.num_groups == 32 and tm.eps == 1e-5
    tm.load_state_dict({"weight": torch.tensor(np.asarray(variables["params"]["scale"])),
                        "bias": torch.tensor(np.asarray(variables["params"]["bias"]))})
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(variables, jnp.asarray(x)))
        # bfloat16 in, bfloat16 out, statistics in float32
        got = tm(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        get_norm("LN", c)


class _Features(nn.Module):
    """A bottom-up network that hands its input (a feature dict) on."""

    def forward(self, feats):
        return feats


@pytest.mark.parametrize("interp,src", [("nearest", "p5"), ("nearest", "res5"), ("afi", "p5")])
def test_fpn_p6p7_matches_jax(interp, src):
    rng = np.random.RandomState(1)
    chans = {"res3": 12, "res4": 20, "res5": 28}
    feats = {f: rng.randn(2, *hw, c).astype(np.float32)
             for (f, c), hw in zip(chans.items(), [(16, 24), (8, 12), (4, 6)])}
    kw = dict(in_features=tuple(chans), in_strides=(8, 16, 32), out_channels=16,
              interp=interp, top_block="p6p7", top_block_in_feature=src, afi_n_rdb=1,
              afi_growth_rate=8)
    jm = JaxFPN(**kw)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jfeats))())
    want = jax.jit(lambda v: jm.apply(v, jfeats))(variables)
    tm = FPN(_Features(), chans, **kw)
    sd = variables_to_state_dict({"params": {"backbone": {"pyramid": variables["params"]}}})
    assert sd["backbone.top_block.p6.weight"].shape == (16, chans.get(src, 16), 3, 3)
    _load(tm, sd, "backbone.")
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in feats.items()})
    assert list(got) == list(want) == ["p3", "p4", "p5", "p6", "p7"]
    assert tuple(got["p7"].shape) == (2, 1, 2, 16)
    for lvl in got:
        _close(got[lvl], want[lvl])


@pytest.mark.parametrize("norm,on_reg", [("GN", True), ("GN", False), ("", True)])
def test_fcos_head_matches_jax(norm, on_reg):
    rng = np.random.RandomState(2)
    c = 32
    feats = [rng.randn(2, h, w, c).astype(np.float32)
             for h, w in [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]]
    jm = JaxFCOSHead(num_classes=3, num_convs=2, in_channels=c, norm=norm,
                     centerness_on_reg=on_reg)
    jf = [jnp.asarray(f) for f in feats]
    variables = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jf))())
    # the init's 0.01 weights leave every output at its bias
    variables = jax.tree.map(lambda a: a * 20.0 if np.ndim(a) == 4 else a, variables)
    want = jax.jit(lambda v: jm.apply(v, jf))(variables)
    tm = FCOSHead(c, 3, 2, norm, centerness_on_reg=on_reg)
    sd = variables_to_state_dict({"params": {"fcos_head": variables["params"]}})
    pre = "proposal_generator.fcos_head."
    assert (pre + "cls_tower.3.weight" in sd) == (norm == "GN")  # else conv 1 is module 2
    assert pre + "scales.4.scale" in sd
    _load(tm, sd, pre)
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats])
    for g_l, w_l in zip(got, want):
        assert len(g_l) == 5
        for g, w in zip(g_l, w_l):
            _close(g, w)
    assert all(float(r.min()) >= 0 for r in got[1]) and float(got[1][0].max()) > 0


def test_fcos_head_init_bias_is_the_prior():
    tm = FCOSHead(32, 3, 1)
    tm.init_weights(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(tm.cls_logits.bias.detach().numpy(), -np.log(99.0), rtol=1e-6)
    assert float(tm.bbox_pred.bias.detach().abs().max()) == 0
    assert 0.005 < float(tm.cls_tower[0].weight.detach().std()) < 0.015


def test_compute_locations_matches_jax():
    shapes, strides = [(5, 7), (3, 4), (1, 1)], (8, 16, 128)
    for g, w in zip(compute_locations(shapes, strides), jax_locations(shapes, strides)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert compute_locations([(2, 3)], (8,))[0].tolist()[:4] == [
        [4.0, 4.0], [12.0, 4.0], [20.0, 4.0], [4.0, 12.0]]


@pytest.mark.parametrize("with_ctr", [False, True])
def test_fcos_decode_matches_jax_slot_by_slot(with_ctr):
    """A threshold that rejects most candidates: their scores tie at 0 and the
    stable sort must order them as ``lax.top_k`` does."""
    rng = np.random.RandomState(3)
    b, nc, strides = 2, 3, (8, 16, 32)
    shapes = [(12, 16), (6, 8), (3, 4)]
    logits = [rng.randn(b, h, w, nc).astype(np.float32) for h, w in shapes]
    regs = [np.abs(rng.randn(b, h, w, 4)).astype(np.float32) * 3 for h, w in shapes]
    ctrs = [rng.randn(b, h, w, 1).astype(np.float32) for h, w in shapes]
    sizes = np.asarray([[96, 128], [90, 100]], np.int32)
    kw = dict(num_classes=nc, fpn_strides=strides, thresh_with_ctr=with_ctr,
              score_thresh=0.8 if with_ctr else 0.9, pre_nms_topk=40, nms_thresh=0.6, post_nms_topk=20)
    jm = JaxFCOS(backbone=None, **kw)
    want, none = jm._inference([jnp.asarray(a) for a in logits], [jnp.asarray(a) for a in regs],
                               [jnp.asarray(a) for a in ctrs], jax_locations(shapes, strides),
                               jnp.asarray(sizes))
    assert none is None
    got = fcos_inference([torch.from_numpy(a) for a in logits],
                         [torch.from_numpy(a) for a in regs],
                         [torch.from_numpy(a) for a in ctrs],
                         compute_locations(shapes, strides), torch.from_numpy(sizes), **kw)
    valid = np.asarray(want.valid)
    assert 0 < valid.sum() < valid.size  # both kept and padded slots
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-4)


def test_sag_mask_head_matches_jax():
    x = np.random.RandomState(4).randn(5, 14, 14, 12).astype(np.float32)
    jm = JaxSAGMaskHead(num_classes=3, num_conv=2, conv_dim=16)
    variables = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))())
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(x)))(variables)
    tm = SAGMaskHead(12, 3, num_conv=2, conv_dim=16)
    sd = variables_to_state_dict({"params": {"mask_head": variables["params"]}})
    assert sd["roi_heads.mask_head.spatialAtt.conv.weight"].shape == (1, 2, 3, 3)
    assert sd["roi_heads.mask_head.deconv.weight"].shape == (16, 16, 2, 2)
    _load(tm, sd, "roi_heads.mask_head.")
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == (5, 28, 28, 3)
    _close(got, want)


def test_converter_raises_on_an_unknown_leaf():
    with pytest.raises(KeyError, match="fcos_head/iou_pred"):
        variables_to_state_dict({"params": {"fcos_head": {"iou_pred": {"conv": {
            "kernel": np.zeros((3, 3, 4, 1), np.float32)}}}}})
    with pytest.raises(KeyError, match="mask_head/sam/gate"):
        variables_to_state_dict({"params": {"mask_head": {"sam": {"gate": np.zeros(3)}}}})


def _edit(variables):
    """Biases and scales off their init, and a mask predictor large enough for
    the mask probabilities to leave 0.5."""
    variables = _perturb(variables, seed=1)
    head = variables["params"].get("mask_head")
    if head is not None:
        head["predictor"]["conv"]["kernel"] = head["predictor"]["conv"]["kernel"] * 300.0
    return variables


SLICES = {"fcos_fpn": "AFI-GAN_fcos_R_50_FPN.yaml", "fcos_bifpn": "AFI-GAN_fcos_R_50_BiFPN.yaml",
          "centermask": "AFI-GAN_centermask_R_50_BiFPN.yaml"}


@functools.lru_cache(maxsize=None)
def _slice(name):
    """(cfg, JAX model, variables, port model, state dict, one image and its
    size, the JAX model's output on it), built once per model."""
    cfg = fcos_cfg(SLICES[name])
    jm, variables, tm, sd = jax_and_port(cfg, edit=_edit)  # a strict load
    rng = np.random.RandomState(42)
    img = rng.rand(1, 128, 128, 3).astype(np.float32) * 255.0
    sizes = np.asarray([[96, 128]], np.int32)
    want = jax.jit(lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(sizes)))(variables)
    return cfg, jm, variables, tm, sd, (img, sizes), want


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_builds_from_the_yaml(name):
    cfg, _, _, tm, sd, _, _ = _slice(name)
    assert type(tm) is (CenterMask if name == "centermask" else FCOS)
    assert required_size_divisibility(cfg) == (64 if name == "fcos_fpn" else 128)
    assert set(sd) == set(tm.state_dict())
    for key in ("backbone.bottom_up.res3.0.conv1.weight",
                "proposal_generator.fcos_head.cls_tower.1.bias",
                "proposal_generator.fcos_head.scales.4.scale"):
        assert key in sd, key
    own = {"fcos_fpn": "backbone.top_block.p7.weight",
           "fcos_bifpn": "backbone.BiFPNLayer_1_conv4_down.norm.running_var",
           "centermask": "roi_heads.mask_head.spatialAtt.conv.bias"}[name]
    assert own in sd
    assert tm.backbone.bottom_up.out_features == ("res3", "res4", "res5")


def _check_detections(td, dets):
    jv, tv = np.asarray(dets.valid[0]), td.valid[0].numpy()
    assert jv.sum() == 16 and tuple(td.boxes.shape) == (1, 16, 4)
    np.testing.assert_array_equal(tv, jv, "valid")
    np.testing.assert_array_equal(td.classes[0].numpy()[tv], np.asarray(dets.classes[0])[jv])
    np.testing.assert_allclose(td.scores[0].numpy()[tv], np.asarray(dets.scores[0])[jv],
                               rtol=0, atol=1e-4, err_msg="scores")
    np.testing.assert_allclose(td.boxes[0].numpy()[tv], np.asarray(dets.boxes[0])[jv],
                               rtol=0, atol=0.05, err_msg="boxes(px)")
    return jv, tv


@pytest.mark.parametrize("name", ["fcos_fpn", "fcos_bifpn"])
def test_fcos_slice_detections_match_jax(name):
    _, _, _, tm, _, (img, sizes), (dets, masks) = _slice(name)
    td, tmasks = predict(tm, {"image": img, "image_sizes": sizes})
    _check_detections(td, dets)
    assert masks is None and tmasks is None


@pytest.mark.parametrize("impl", ["pallas", "fast", "windowed", "gather"])
def test_centermask_slice_matches_jax(impl, monkeypatch):
    """One JAX run (``pallas``, which the JAX package itself turns into its
    windowed pooler at 32 channels) against the port under each pooler."""
    _, jm, _, tm, _, (img, sizes), (dets, masks) = _slice("centermask")
    assert jm.pooler_impl == "pallas"
    monkeypatch.setattr(tm, "pooler_impl", impl)
    td, tmasks = predict(tm, {"image": img, "image_sizes": sizes})
    jv, tv = _check_detections(td, dets)
    assert tuple(tmasks.shape) == (1, 16, 28, 28)
    want = np.asarray(masks[0])[jv]
    assert want.std() > 0.05  # not all 0.5
    np.testing.assert_allclose(tmasks[0].numpy()[tv], want, rtol=0, atol=1e-3, err_msg="masks")


def test_build_centermask_honors_pooler_impl():
    cfg = fcos_cfg(SLICES["centermask"])
    assert build_model(cfg, device="cpu").pooler_impl == "pallas"
    cfg.TPU.POOLER_IMPL = "gather"
    assert build_model(cfg, device="cpu").pooler_impl == "gather"
    cfg.TPU.POOLER_IMPL = "dma"
    with pytest.raises(ValueError, match="POOLER_IMPL"):
        build_model(cfg, device="cpu")
    full = centermask_path_cfg()
    assert full.MODEL.META_ARCHITECTURE == "CenterMask" and full.MODEL.MASK_ON
    assert (full.MODEL.BIFPN.OUT_CHANNELS, full.MODEL.BIFPN.FPN_REPEAT) == (160, 6)


@pytest.mark.parametrize("name", list(SLICES))
def test_full_width_model_builds(name):
    """The three YAMLs as they are, on the meta device (no memory, no init)."""
    from afigan_tpu_torch.config import cfg_from_yaml

    tm = build_model(cfg_from_yaml("inference/" + SLICES[name]), device="meta")
    n = sum(p.numel() for p in tm.parameters())
    assert 30e6 < n < 45e6
    assert len(tm.proposal_generator.fcos_head.cls_tower) == 12  # 4 x (conv, GN, ReLU)
    assert tm.decode["post_nms_topk"] == 100 and tm.decode["score_thresh"] == 0.05


def test_centermask_run_inference_and_cli_match_jax(tmp_path):
    """The eval loop with ``bbox`` and ``segm``: the port's loader, paste and
    evaluator against the JAX package's on the tiny-COCO fixture; then
    ``python -m afigan_tpu_torch.run_net --eval-only`` on the CenterMask YAML."""
    from afigan_tpu.data.coco import CocoDataset as JaxDataset
    from afigan_tpu.engine.inference import run_inference as jax_run_inference
    from afigan_tpu.evaluation.coco_eval import CocoEvaluator as JaxEvaluator
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.engine.inference import run_inference
    from afigan_tpu_torch.evaluation import CocoEvaluator
    from tests.fixtures import make_tiny_coco

    cfg, jm, variables, tm, sd, _, _ = _slice("centermask")
    json_path, img_dir = make_tiny_coco(str(tmp_path), num_images=2, hw=(96, 128))
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
    assert set(got) == set(want) == {"bbox", "segm"}
    for task in want:
        np.testing.assert_allclose(got[task]["AP"], want[task]["AP"], rtol=0, atol=1e-3)
    assert len(seen["port"]) == len(seen["jax"]) == 2 * 16
    for g, w in zip(seen["port"], seen["jax"]):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.05)
        assert abs(g["score"] - w["score"]) <= 1e-4
        assert g["segmentation"]["size"] == w["segmentation"]["size"]

    # the CLI on the same data and weights, through the windowed pooler
    coco = tmp_path / "datasets" / "coco"
    (coco / "annotations").mkdir(parents=True)
    shutil.copy(json_path, coco / "annotations" / "instances_val2017.json")
    shutil.copytree(img_dir, coco / "val2017")
    weights = tmp_path / "model.pth"
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, weights)
    out = subprocess.run(
        [sys.executable, "-m", "afigan_tpu_torch.run_net", "--config-file",
         os.path.join(REPO, "configs/inference", SLICES["centermask"]), "--eval-only",
         "--device", "cpu", *FCOS_OVERRIDES, "TPU.POOLER_IMPL", "windowed",
         "MODEL.WEIGHTS", str(weights), "DATASETS.ROOT", str(tmp_path / "datasets")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"bbox", "segm"}
    for task in got:
        np.testing.assert_allclose(res[task]["AP"], got[task]["AP"], rtol=0, atol=1e-3)
