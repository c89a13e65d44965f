"""The eval path: port ``run_inference`` and ``python -m
afigan_tpu_torch.run_net --eval-only`` against the JAX ``run_inference``.

Same JAX-initialised weights (converted; the CLI reads them from a torch
``.pth`` through MODEL.WEIGHTS) on tests/fixtures.py::make_tiny_coco; bbox
and segm AP / AP50 must agree within 1e-3. Random weights score 0 AP on
the fixture (as the pinned golden does), so the predictions handed to the
evaluator are compared too: same images and categories, boxes within
0.05 px, scores within 1e-3, pasted-mask areas within 0.1 % of the image.
Pasted masks (torch bilinear) are also held against the JAX package's cv2
paste at <= 0.1 % of pixels. ``load_weights`` (MODEL.WEIGHTS) refuses a
checkpoint that lacks any of the model's keys.
"""

import json
import logging
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from afigan_tpu.data.coco import CocoDataset
from afigan_tpu.engine.inference import paste_masks as jax_paste
from afigan_tpu.engine.inference import run_inference as jax_run_inference
from afigan_tpu.evaluation.coco_eval import CocoEvaluator
from afigan_tpu.evaluation.rle import rle_area
from afigan_tpu_torch.data.coco import CocoDataset as PortDataset
from afigan_tpu_torch.engine.inference import paste_masks, run_inference
from afigan_tpu_torch.evaluation import CocoEvaluator as PortEvaluator
from afigan_tpu_torch.run_net import load_weights
from tests.fixtures import make_tiny_coco
from tests.torch_port_common import GOLDEN_OVERRIDES, REPO, golden_cfg, jax_and_port


def _ap(res):
    return np.array([res["bbox"]["AP"], res["bbox"]["AP50"],
                     res["segm"]["AP"], res["segm"]["AP50"]], np.float64)


def _with_predictions(fn, evaluator=CocoEvaluator):
    """Run ``fn`` and return (its result, the predictions that ``evaluator``,
    the JAX package's or the port's own, evaluated)."""
    seen = []
    orig = evaluator.evaluate

    def evaluate(self):
        seen.extend(self.predictions)
        return orig(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(evaluator, "evaluate", evaluate)
        return fn(), seen


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("portcoco")
    json_path, img_dir = make_tiny_coco(str(root / "raw"), num_images=4, hw=(96, 128))
    cfg = golden_cfg()
    jm, variables, tm, sd = jax_and_port(cfg)
    want, preds = _with_predictions(lambda: jax_run_inference(
        cfg, jm, variables, CocoDataset(json_path, img_dir)))
    return root, json_path, img_dir, cfg, tm, sd, _ap(want), preds


def test_run_inference_ap_matches_jax(setup):
    _, json_path, img_dir, cfg, tm, _, want, want_preds = setup
    # batches of 3 over 4 images: the last batch is padded, as the JAX loader pads
    got, preds = _with_predictions(lambda: run_inference(
        cfg, tm, PortDataset(json_path, img_dir), batch_size=3), PortEvaluator)
    np.testing.assert_allclose(_ap(got), want, rtol=0, atol=1e-3,
                               err_msg="AP [bbox AP, bbox AP50, segm AP, segm AP50]")
    assert len(preds) == len(want_preds) == 4 * 16
    for g, w in zip(preds, want_preds):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=0.05)
        assert abs(g["score"] - w["score"]) <= 1e-3
        assert abs(rle_area(g["segmentation"]) - rle_area(w["segmentation"])) <= 1e-3 * 96 * 128


def test_run_net_cli_ap_matches_jax(setup):
    root, json_path, img_dir, _, _, sd, want, _ = setup
    coco = root / "datasets" / "coco"
    (coco / "annotations").mkdir(parents=True)
    shutil.copy(json_path, coco / "annotations" / "instances_val2017.json")
    shutil.copytree(img_dir, coco / "val2017")
    weights = root / "model.pth"
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, weights)
    cfg_file = root / "cfg.yaml"
    cfg_file.write_text(f'_BASE_: "{REPO}/configs/Base-RCNN-FPN-AFIGAN.yaml"\n')
    out = subprocess.run(
        [sys.executable, "-m", "afigan_tpu_torch.run_net", "--config-file",
         str(cfg_file), "--eval-only", "--device", "cpu", *GOLDEN_OVERRIDES,
         "MODEL.WEIGHTS", str(weights), "DATASETS.ROOT", str(root / "datasets")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    np.testing.assert_allclose(_ap(res), want, rtol=0, atol=1e-3)
    assert "jax" not in out.stderr


def test_load_weights_needs_every_model_key(setup, tmp_path, caplog):
    *_, tm, sd, _, _ = setup
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    key = next(k for k in sd if ".srf_module.Generators.0.1.RDBs." in k)
    partial = tmp_path / "partial.pth"
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items() if k != key}}, partial)
    with pytest.raises(KeyError, match=re.escape(key)):
        load_weights(tm, str(partial))
    extra = tmp_path / "extra.pth"
    torch.save({"model": {**{k: torch.tensor(v) for k, v in sd.items()},
                          "roi_heads.box_head.momentum": torch.zeros(3)}}, extra)
    with caplog.at_level(logging.WARNING):
        load_weights(tm, str(extra))
    assert "roi_heads.box_head.momentum" in caplog.text
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_paste_masks_matches_cv2_paste():
    rng = np.random.RandomState(0)
    masks = rng.rand(6, 28, 28).astype(np.float32)
    xy = rng.rand(6, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(6, 2) * 70 + 3], 1).astype(np.float32)
    boxes[5] = [-5.5, 10.2, 150.0, 99.0]  # clipped to the image
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    got = paste_masks(masks, boxes, valid, 96, 128)
    want = jax_paste(masks, boxes, valid, 96, 128)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        assert (g != w).mean() <= 1e-3
