"""Port test-time augmentation (``afigan_tpu_torch/engine/tta.py``) against
``afigan_tpu.engine.tta`` on the CPU, float32.

Two images of 64x96 (``tests.fixtures.make_tiny_coco``) at ``TEST.AUG.MIN_SIZES
(48, 64)`` with flips, ``MAX_SIZE`` 128, one 64x128 canvas; the narrow R-50
Mask R-CNN and the narrow Cascade Mask R-CNN ResNeSt-FPN of
``torch_port_common.breadth_cfg`` with one set of weights in both packages
(``port_and_jax``). Compared: the evaluators' predictions (merged boxes
0.05 px, scores 1e-3, equal images and categories), the averaged mask
probabilities of every valid merged box (each mask's sum 5e-3 relative, and
elementwise at the modules' ``1e-4 max|jax| + 1e-5``) and AP 1e-3. Merged
detections come from flipped passes too, so that a flip that is off by a
pixel or a mask left unmirrored fails. Batched (``TPU.TTA_BATCH 2``) equals batch 1 at the same tolerances;
``tta_batch_for_canvas`` and the variants equal the JAX package's.
"""

import functools

import numpy as np
import pytest

from afigan_tpu.data.coco import CocoDataset as JaxDataset
from afigan_tpu.engine import inference as jax_inference
from afigan_tpu.engine import tta as jax_tta
from afigan_tpu.evaluation.coco_eval import CocoEvaluator as JaxEvaluator
from afigan_tpu_torch.data.coco import CocoDataset, read_image
from afigan_tpu_torch.engine import tta
from afigan_tpu_torch.evaluation import CocoEvaluator
from tests.fixtures import make_tiny_coco
from tests.torch_port_common import breadth_cfg, port_and_jax

TTA = ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(48, 64)", "TEST.AUG.MAX_SIZE",
       "128", "TEST.AUG.FLIP", "True", "TPU.IMAGE_BUCKETS", "((64, 128),)"]
MODELS = {"r50": "AFI-GAN_maskrcnn_R_50_FPN.yaml",
          "cascade": "AFI-GAN_cascade_mask_rcnn_ResNeSt101_FPN.yaml"}


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg = breadth_cfg(MODELS[name], *TTA)
    return cfg, port_and_jax(cfg, canvas=(64, 128))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return make_tiny_coco(str(tmp_path_factory.mktemp("tta")), num_images=2, hw=(64, 96))


def _run(fn, evaluator_cls, module):
    """``fn()`` with the evaluator's predictions and every pasted (averaged)
    mask stack captured: (results, predictions, [(probs, valid)] per image)."""
    seen = {"masks": []}
    evaluate, paste = evaluator_cls.evaluate, module.paste_masks

    def capture_eval(self):
        seen["preds"] = list(self.predictions)
        return evaluate(self)

    def capture_paste(masks, boxes, valid, *a, **k):
        seen["masks"].append((np.asarray(masks), np.asarray(valid)))
        return paste(masks, boxes, valid, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluator_cls, "evaluate", capture_eval)
        mp.setattr(module, "paste_masks", capture_paste)
        return fn(), seen["preds"], seen["masks"]


def _assert_same(got, want):
    (res_g, preds_g, masks_g), (res_w, preds_w, masks_w) = got, want
    assert set(res_g) == set(res_w) == {"bbox", "segm"}
    for task in res_w:
        np.testing.assert_allclose(res_g[task]["AP"], res_w[task]["AP"], rtol=0, atol=1e-3)
    assert len(preds_g) == len(preds_w) == 2 * 16
    for g, w in zip(preds_g, preds_w):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.05)
        assert abs(g["score"] - w["score"]) <= 1e-3
    assert len(masks_g) == len(masks_w) == 2
    for (mg, vg), (mw, vw) in zip(masks_g, masks_w):
        np.testing.assert_array_equal(vg, vw)
        assert mg.shape == mw.shape == (16, 28, 28)
        np.testing.assert_allclose(mg[vg].sum(axis=(1, 2)), mw[vw].sum(axis=(1, 2)),
                                   rtol=5e-3, atol=0)
        # elementwise too: a sum does not see a mirrored mask
        assert np.abs(mg[vg] - mw[vw]).max() <= 1e-4 * np.abs(mw[vw]).max() + 1e-5


@pytest.mark.parametrize("name", list(MODELS))
def test_run_tta_inference_matches_jax(name, coco, monkeypatch):
    cfg, (jm, variables, tm) = _models(name)
    json_path, img_dir = coco
    passes = []  # the (scale, flip) pass of each merged detection, 16 slots a pass
    nms = tta.batched_nms_padded

    def spy(*a, **k):
        out = nms(*a, **k)
        passes.extend((out[2][out[3]] // 16).tolist())
        return out

    monkeypatch.setattr(tta, "batched_nms_padded", spy)
    want = _run(lambda: jax_tta.run_tta_inference(
        cfg, jm, variables, JaxDataset(json_path, img_dir)), JaxEvaluator, jax_inference)
    got = _run(lambda: tta.run_tta_inference(
        cfg, tm, CocoDataset(json_path, img_dir)), CocoEvaluator, tta)
    _assert_same(got, want)
    # the scaled predictor moves the probabilities off its init's flat 0.5
    assert np.ptp(got[2][0][0]) > 0.02
    # some merged detection comes from a flipped pass (odd pass index)
    assert any(p % 2 for p in passes)


def test_batched_tta_equals_batch_one(coco, monkeypatch):
    cfg, (_, _, tm) = _models("r50")
    json_path, img_dir = coco
    one = _run(lambda: tta.run_tta_inference(cfg, tm, CocoDataset(
        json_path, img_dir)), CocoEvaluator, tta)
    cfg2 = cfg.clone()
    cfg2.TPU.TTA_BATCH = 2
    assert tta.tta_batch_for_canvas(cfg2, (64, 128)) == 2
    calls = []
    forward = tta._forward
    monkeypatch.setattr(tta, "_forward", lambda m, imgs, *a: calls.append(len(imgs))
                        or forward(m, imgs, *a))
    two = _run(lambda: tta.run_tta_inference(cfg2, tm, CocoDataset(
        json_path, img_dir)), CocoEvaluator, tta)
    # 2 scales x 2 flips x 2 images, detection and mask sweeps, two items a batch
    assert calls == [2] * 8
    _assert_same(two, one)


def test_averaged_tta_masks_equals_the_sweep(coco, monkeypatch):
    """The one-image entry point gives the batched mask sweep's average."""
    cfg, (_, _, tm) = _models("r50")
    json_path, img_dir = coco
    ds = CocoDataset(json_path, img_dir)
    merged = {}
    nms = tta.batched_nms_padded

    def keep(*a, **k):
        out = nms(*a, **k)
        merged.setdefault("first", (a[2].numpy(), [o.numpy() for o in out]))
        return out

    monkeypatch.setattr(tta, "batched_nms_padded", keep)
    _, _, masks = _run(lambda: tta.run_tta_inference(cfg, tm, ds),
                       CocoEvaluator, tta)
    classes, (mb, ms, mi, mv) = merged["first"]
    img = read_image(ds.records[0]["file_name"], cfg.INPUT.FORMAT)
    avg, n = tta.averaged_tta_masks(cfg, tm, img, mb, ms, classes[mi], mv)
    assert n == 4
    np.testing.assert_allclose(avg, masks[0][0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch,budget,canvas", [
    (1, 4_500_000, (832, 1344)), (4, 4_500_000, (832, 1344)), (8, 4_500_000, (640, 896)),
    (4, 1_000_000, (1280, 1664)), (0, 10, (64, 64)), (3, 4_500_000, (64, 128))])
def test_tta_batch_for_canvas_matches_jax(batch, budget, canvas):
    cfg = breadth_cfg(MODELS["r50"], "TPU.TTA_BATCH", str(batch),
                      "TPU.TTA_PIXEL_BUDGET", str(budget))
    assert tta.tta_batch_for_canvas(cfg, canvas) == jax_tta.tta_batch_for_canvas(cfg, canvas)


def test_tta_variants_match_jax(coco):
    cfg = breadth_cfg(MODELS["r50"], *TTA)
    json_path, img_dir = coco
    img = read_image(CocoDataset(json_path, img_dir).records[1]["file_name"], "BGR")
    got, want = tta._tta_variants(cfg, img), jax_tta._tta_variants(cfg, img)
    assert [f for _, f in got] == [f for _, f in want] == [False, True, False, True]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)
