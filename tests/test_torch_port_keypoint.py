"""Keypoint R-CNN in the port against the JAX package, float32 on the CPU.

The keypoint transform and the mapper's keypoint GT (a flip through the
dataset's ``keypoint_hflip_indices``) equal JAX's exactly. The head's logits
through ``variables_to_state_dict``, ``keypoints_to_heatmap`` (integer
outputs equal), ``keypoint_rcnn_loss`` under both normalisers (and its
gradient) and ``heatmaps_to_keypoints`` equal JAX's at 1e-5 of the largest
entry. A narrow Keypoint R-CNN R-50-FPN(AFI) (FPN 16, one dense block, 2
keypoint convs of 16, 3 keypoints) equals JAX's ``build_model(train=False)``:
detections at the golden tolerances of ``test_torch_port_slice.py`` and
keypoints within 0.05 px and scores within 1e-3; ``run_inference``'s COCO
keypoint results and the keypoints it hands the evaluator (in original image
coordinates) equal JAX's. One stage-3 step equals ``make_stage3_train_step``:
every loss, ``loss_keypoint`` included, at 1e-4 relative and every parameter
after it at 1e-6 absolute (the bounds of ``test_torch_port_train_step.py``).
``validate_training --family keypoint --tiny`` runs on the CPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models import keypoint_head as jkh
from afigan_tpu_torch.models import keypoint_head as kh
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import (assert_detections_match, jax_and_port, keypoint_scene_coco,
                                     small_cfg)
from tests.torch_port_train_common import (jax_stage3_step, keypoint_det_batch,
                                           port_stage3_step)

K = 3


def _rel(got, want, rel=1e-5):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=rel * max(float(np.abs(want).max()), 1e-30))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hflip", [False, True], ids=["kept", "flipped"])
def test_apply_keypoints_equals_jax(hflip):
    from afigan_tpu.data.transforms import ResolvedTransform as JaxTransform
    from afigan_tpu_torch.data.transforms import ResolvedTransform

    rng = np.random.RandomState(0)
    kp = (rng.rand(6, 4, 3) * [140.0, 100.0, 1.0]).astype(np.float32)
    kp[..., 2] = rng.randint(0, 3, size=(6, 4))
    idx = [0, 2, 1, 3]
    want = JaxTransform(96, 128, 72, 96, hflip).apply_keypoints(kp, hflip_indices=idx)
    got = ResolvedTransform(96, 128, 72, 96, hflip).apply_keypoints(kp, hflip_indices=idx)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 2] == 0).any() and (got[..., 2] > 0).any()
    if hflip:
        with pytest.raises(ValueError, match="keypoint_hflip_indices"):
            ResolvedTransform(96, 128, 72, 96, True).apply_keypoints(kp)


def test_mapper_keypoint_gt_equals_jax(tmp_path):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu.data.coco import CocoDataset as JaxDataset
    from afigan_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper

    json_path, img_dir = keypoint_scene_coco(tmp_path)
    jds, ds = JaxDataset(json_path, img_dir), CocoDataset(json_path, img_dir)
    assert ds.keypoint_hflip_indices == [0, 2, 1] == jds.keypoint_hflip_indices
    cfgs = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_list(["MODEL.KEYPOINT_ON", "True", "MODEL.MASK_ON", "True",
                             "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "3",
                             "INPUT.MIN_SIZE_TRAIN", "(64, 80)", "INPUT.MAX_SIZE_TRAIN", "128",
                             "TPU.MAX_GT_BOXES", "8", "TPU.MASK_CANVAS", "16"])
        cfgs.append(cfg)
    jm = JaxMapper(cfgs[0], is_train=True, seed=3,
                   keypoint_hflip_indices=jds.keypoint_hflip_indices)
    pm = DatasetMapper(cfgs[1], is_train=True, seed=3,
                       keypoint_hflip_indices=ds.keypoint_hflip_indices)
    flips = set()
    for _ in range(3):
        for jr, pr in zip(jds.records, ds.records):
            a, b = jm(jr), pm(pr)
            flips.add(b["transform"].hflip)
            assert list(b["gt"]) == list(a["gt"])
            for k in a["gt"]:
                np.testing.assert_array_equal(b["gt"][k], a["gt"][k], err_msg=k)
    assert flips == {True, False}


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------

def test_head_logits_equal_jax():
    head = jkh.KRCNNConvDeconvUpsampleHead(num_keypoints=K, conv_dims=(16, 16))
    x = np.random.RandomState(1).randn(5, 14, 14, 16).astype(np.float32)
    variables = head.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(head.apply(variables, jnp.asarray(x)))
    sd = variables_to_state_dict({"params": {"roi_heads": {"keypoint_head": variables["params"]}}})
    port = kh.KRCNNConvDeconvUpsampleHead(16, K, (16, 16))
    port.load_state_dict({k.split("keypoint_head.")[1]: torch.tensor(v) for k, v in sd.items()},
                         strict=True)
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    assert got.shape == want.shape == (5, 56, 56, K)
    _rel(got, want)


def _rois_and_keypoints(r=8, s=14, seed=2):
    rng = np.random.RandomState(seed)
    xy = rng.rand(r, 2) * 60
    wh = 4 + rng.rand(r, 2) * 40
    rois = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    u = rng.rand(r, K, 2) * 1.3 - 0.15  # some outside their ROI
    kp = np.zeros((r, K, 3), np.float32)
    kp[..., :2] = rois[:, None, :2] + u * wh[:, None]
    kp[0, 0, :2] = rois[0, 2:]  # on the right and bottom edges: the last cell
    kp[..., 2] = rng.randint(0, 3, size=(r, K))
    return rois, kp


def test_keypoints_to_heatmap_equals_jax():
    rois, kp = _rois_and_keypoints()
    jl, jv = jkh.keypoints_to_heatmap(jnp.asarray(kp), jnp.asarray(rois), 56)
    tl, tv = kh.keypoints_to_heatmap(torch.tensor(kp), torch.tensor(rois), 56)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.any() and not tv.all() and int(tl[0, 0]) == 56 * 56 - 1


@pytest.mark.parametrize("by_visible", [True, False], ids=["visible", "constant"])
def test_keypoint_loss_and_its_gradient_equal_jax(by_visible):
    rois, kp = _rois_and_keypoints()
    logits = np.random.RandomState(4).randn(len(rois), 56, 56, K).astype(np.float32) * 3
    roi_valid = np.arange(len(rois)) % 4 != 3
    args = dict(normalize_by_visible=by_visible, loss_weight=0.7, normalizer=32.0)

    def jloss(lg):
        return jkh.keypoint_rcnn_loss(lg, jnp.asarray(kp), jnp.asarray(rois),
                                      jnp.asarray(roi_valid), **args)

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = kh.keypoint_rcnn_loss(lg, torch.tensor(kp), torch.tensor(rois),
                                torch.tensor(roi_valid), **args)
    got.backward()
    _rel(got.item(), float(want))
    _rel(lg.grad.numpy(), np.asarray(want_g))
    if not by_visible:
        with pytest.raises(ValueError, match="normalizer"):
            kh.keypoint_rcnn_loss(lg, torch.tensor(kp), torch.tensor(rois),
                                  torch.tensor(roi_valid), normalize_by_visible=False)


def test_heatmaps_to_keypoints_equals_jax():
    rois, _ = _rois_and_keypoints()
    logits = np.random.RandomState(5).randn(len(rois), 56, 56, K).astype(np.float32) * 2
    want = np.asarray(jkh.heatmaps_to_keypoints(jnp.asarray(logits), jnp.asarray(rois)))
    got = kh.heatmaps_to_keypoints(torch.tensor(logits), torch.tensor(rois)).numpy()
    assert got.shape == (len(rois), K, 3)
    _rel(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def keypoint_cfg():
    """The narrow main-path tree with the keypoint branch for the mask branch
    (the validation tool's keypoint family at the golden test's settings)."""
    cfg = small_cfg()
    cfg.merge_from_list([
        "MODEL.MASK_ON", "False", "MODEL.KEYPOINT_ON", "True", "MODEL.AFI.N_RDB", "1",
        "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", str(K),
        "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(16, 16)",
        "MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
        "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "128", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
        "TEST.DETECTIONS_PER_IMAGE", "16", "TEST.KEYPOINT_OKS_SIGMAS", "(0.079, 0.05, 0.05)",
        "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
        "TPU.IMAGE_BUCKETS", "((128, 128),)"])
    return cfg


@functools.lru_cache(maxsize=None)
def _models():
    return jax_and_port(keypoint_cfg())


def test_keypoint_model_inference_equals_jax():
    jm, variables, tm, _ = _models()
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.asarray([[128, 128], [96, 128]], np.int32)
    want, _ = jax.jit(lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(sizes)))(variables)
    with torch.no_grad():
        got, masks = tm(torch.tensor(img), torch.tensor(sizes))
    assert masks is None and tuple(got.keypoints.shape) == (2, 16, K, 3)
    for i in range(2):
        sub = lambda d: type(d)(*(None if t is None else t[i:i + 1] for t in d))  # noqa: E731
        assert_detections_match(sub(got), None, sub(want), None)
        v = np.asarray(want.valid[i])
        gk, wk = got.keypoints[i].numpy()[v], np.asarray(want.keypoints[i])[v]
        np.testing.assert_allclose(gk[..., :2], wk[..., :2], rtol=0, atol=0.05)
        np.testing.assert_allclose(gk[..., 2], wk[..., 2], rtol=0, atol=1e-3)


def test_keypoint_coco_results_equal_jax(tmp_path, monkeypatch):
    from afigan_tpu.data.coco import CocoDataset as JaxDataset
    from afigan_tpu.engine.inference import run_inference as jax_run_inference
    from afigan_tpu.evaluation import coco_eval as jax_eval
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.engine.inference import run_inference
    from afigan_tpu_torch.evaluation import coco_eval

    json_path, img_dir = keypoint_scene_coco(tmp_path)
    jm, variables, tm, _ = _models()
    seen = {}
    for name, mod in (("jax", jax_eval), ("port", coco_eval)):
        real = mod.CocoEvaluator.process

        def process(self, *a, keypoints=None, _real=real, _name=name, **k):
            seen.setdefault(_name, []).append(np.asarray(keypoints))
            return _real(self, *a, keypoints=keypoints, **k)

        monkeypatch.setattr(mod.CocoEvaluator, "process", process)
    cfg = keypoint_cfg()
    want = jax_run_inference(cfg, jm, variables, JaxDataset(json_path, img_dir))
    got = run_inference(cfg, tm, CocoDataset(json_path, img_dir))
    assert set(got) == set(want) == {"bbox", "keypoints"}
    for task in want:
        assert set(got[task]) == set(want[task])
        for k, v in want[task].items():
            assert np.isnan(v) == np.isnan(got[task][k]) and (
                np.isnan(v) or abs(got[task][k] - v) <= 1e-3), (task, k)
    assert len(seen["port"]) == len(seen["jax"]) == 4
    for g, w in zip(seen["port"], seen["jax"]):
        assert g.shape == w.shape == (1, 16, K, 3)
        # original image coords: the 96x128 scenes fill the canvas unscaled
        np.testing.assert_allclose(g[..., :2], w[..., :2], rtol=0, atol=0.05)


def test_stage3_step_equals_jax():
    extra = ("MODEL.MASK_ON", "False", "MODEL.KEYPOINT_ON", "True",
             "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", str(K),
             "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(16, 16)")
    batch = keypoint_det_batch(K)
    params, want, jafter = jax_stage3_step(extra, batch)
    got, before, after = port_stage3_step(params, extra, batch)
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_keypoint",
            "diag_fg_frac", "total_loss")
    assert set(keys) <= set(want) and "loss_mask" not in got
    assert got["loss_keypoint"] > 0
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    want_sd = variables_to_state_dict({"params": jafter})
    moved = [k for k in after if "keypoint_head" in k and not torch.equal(before[k], after[k])]
    assert len(moved) == 6
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=0, atol=1e-6, err_msg=k)


def test_validate_training_keypoint_family_tiny(tmp_path):
    import json

    from afigan_tpu_torch.tools import validate_training

    rc = validate_training.main(["--family", "keypoint", "--tiny", "--iters", "4",
                                 "--device", "cpu", "--out", str(tmp_path)])
    summary = json.load(open(tmp_path / "summary.json"))
    assert summary["family"] == "keypoint" and list(summary["stages"]) == ["3"]
    assert set(summary["stages"]["3"]) >= {"loss_cls", "loss_box_reg", "loss_keypoint"}
    assert rc in (0, 1) and (rc == 0) == summary["ok"]
    lines = [json.loads(x) for x in open(tmp_path / "s3" / "metrics.json")]
    assert all(np.isfinite(r["loss_keypoint"]) for r in lines)


def test_refusals():
    """Stage 2 with keypoints raises; the Res5 heads refuse keypoints as
    JAX's build does; TTA refuses keypoints."""
    from afigan_tpu.models.build import build_roi_heads as jax_build_roi_heads
    from afigan_tpu_torch.config import res5_path_cfg
    from afigan_tpu_torch.engine.stage2 import init_stage2_state
    from afigan_tpu_torch.engine.tta import run_tta_inference
    from afigan_tpu_torch.models.build import build_roi_heads

    cfg = keypoint_cfg()
    with pytest.raises(NotImplementedError, match="KEYPOINT_ON"):
        init_stage2_state(cfg, device="cpu")
    r5 = res5_path_cfg()
    r5.MODEL.KEYPOINT_ON = True
    raised = []
    for fn in (jax_build_roi_heads, build_roi_heads):
        with pytest.raises(ValueError) as e:
            fn(r5)
        raised.append(str(e.value))
    assert raised[0] == raised[1]
    with pytest.raises(ValueError, match="keypoints"):
        run_tta_inference(cfg, None, None)
