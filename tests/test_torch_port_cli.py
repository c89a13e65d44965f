"""The port's eval CLI against the JAX CLI's contract.

``python -m afigan_tpu_torch.run_net`` runs test-time augmentation
(``engine/tta.py::run_tta_inference``) for a config with ``TEST.AUG.ENABLED``,
as the JAX CLI does, and plain inference otherwise; either way it verifies
``TEST.EXPECTED_RESULTS`` after inference with the port's own copy of
``verify_results``, which must behave as the JAX package's on the same rows.
Every inference YAML of the repo builds in the port at full width.
"""

import math
import os
from types import SimpleNamespace

import pytest

from afigan_tpu.engine.testing import verify_results as jax_verify_results
from afigan_tpu_torch import run_net
from afigan_tpu_torch.engine.testing import verify_results
from tests.torch_port_common import REPO

RESULTS = {"bbox": {"AP": 41.5, "AP50": 62.0}, "segm": {"AP": 37.4}}

# (rows of TEST.EXPECTED_RESULTS, raise_on_failure)
CASES = {
    "pass": ([["bbox", "AP", 41.4, 0.2], ["segm", "AP", 37.4, 0.0]], True),
    "fail_raises": ([["bbox", "AP", 40.0, 0.5], ["segm", "AP", 37.4, 0.1]], True),
    "missing_task": ([["keypoints", "AP", 60.0, 1.0]], True),
    "nan": ([["bbox", "AP50", 62.0, 1.0]], True),
    "fail_logged_only": ([["bbox", "AP", 40.0, 0.5], ["keypoints", "AP", 1.0, 1.0]], False),
    "nothing_to_verify": ([], True),
}


def _outcome(fn, rows, raise_on_failure, results):
    cfg = SimpleNamespace(TEST=SimpleNamespace(EXPECTED_RESULTS=rows))
    try:
        return ("returned", fn(cfg, results, raise_on_failure=raise_on_failure))
    except RuntimeError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("case", list(CASES))
def test_verify_results_equals_jax(case):
    rows, raise_on_failure = CASES[case]
    results = {t: dict(m) for t, m in RESULTS.items()}
    if case == "nan":
        results["bbox"]["AP50"] = math.nan
    got = _outcome(verify_results, rows, raise_on_failure, results)
    want = _outcome(jax_verify_results, rows, raise_on_failure, results)
    assert got == want
    expect_raise = case in ("fail_raises", "missing_task", "nan")
    assert got[0] == ("raised" if expect_raise else "returned")
    if case == "fail_logged_only":
        assert got == ("returned", False)


def test_tta_config_runs_tta_inference_then_verifies(monkeypatch):
    """The flagship TTA YAML goes to ``run_tta_inference`` (not the
    single-scale ``run_inference``) with the built model, and its results to
    ``verify_results``."""
    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.engine import inference, testing, tta
    from afigan_tpu_torch.models import build

    calls = []

    def refuse(*a, **k):
        raise AssertionError("single-scale inference under TEST.AUG.ENABLED")

    def fake_tta(cfg, model, dataset):
        calls.append(("tta", cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.FLIP, model))
        return {"bbox": {"AP": 57.3}}

    model = object()
    monkeypatch.setattr(coco, "register_default_datasets", lambda root: None)
    monkeypatch.setattr(coco, "get_dataset", lambda name: [])
    monkeypatch.setattr(build, "build_model", lambda cfg, device, generator: model)
    monkeypatch.setattr(inference, "run_inference", refuse)
    monkeypatch.setattr(tta, "run_tta_inference", fake_tta)
    monkeypatch.setattr(testing, "verify_results",
                        lambda cfg, results: calls.append(("verify", results)))
    args = run_net.parse_args([
        "--config-file",
        os.path.join(REPO, "configs/inference/AFI-GAN_cascade_rcnn_swinL_BiFPN_ST_TTA.yaml"),
        "--eval-only", "--device", "cpu"])
    assert run_net.main(args) == {"bbox": {"AP": 57.3}}
    sizes = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
    assert calls == [("tta", sizes, True, model), ("verify", {"bbox": {"AP": 57.3}})]


INFERENCE_YAMLS = sorted(os.listdir(os.path.join(REPO, "configs", "inference")))


@pytest.mark.parametrize("yaml", INFERENCE_YAMLS)
def test_every_inference_yaml_builds_at_full_width(yaml):
    """``build_model(cfg, device="cpu")`` at the YAML's own widths, depths and
    heads: none of the nine raises."""
    import torch

    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.models import build_model

    assert len(INFERENCE_YAMLS) == 9
    cfg = cfg_from_yaml(f"inference/{yaml}")
    with torch.no_grad():
        model = build_model(cfg, device="cpu")
    assert not model.training
    n = sum(p.numel() for p in model.parameters())
    assert n > 2e7, n
    if "ResNeSt101" in yaml:
        assert len(model.backbone.bottom_up.res4) == 23
        assert model.roi_heads.mask_head.mask_fcn1.norm is not None
    if "PAFPN" in yaml:
        assert type(model.backbone).__name__ == "PAFPN"


def test_cli_verifies_expected_results(monkeypatch):
    """After inference ``main`` holds the results against
    ``TEST.EXPECTED_RESULTS`` and raises on a failed row."""
    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.engine import inference
    from afigan_tpu_torch.models import build

    monkeypatch.setattr(coco, "register_default_datasets", lambda root: None)
    monkeypatch.setattr(coco, "get_dataset", lambda name: [])
    monkeypatch.setattr(build, "build_model", lambda cfg, device, generator: None)
    monkeypatch.setattr(inference, "run_inference",
                        lambda cfg, model, dataset: {"bbox": {"AP": 12.0}})
    cfg_file = os.path.join(REPO, "configs/inference/AFI-GAN_maskrcnn_R_50_FPN.yaml")
    ok = run_net.parse_args(["--config-file", cfg_file, "--eval-only", "--device", "cpu",
                             "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 12.0, 0.1]]"])
    assert run_net.main(ok) == {"bbox": {"AP": 12.0}}
    bad = run_net.parse_args(["--config-file", cfg_file, "--eval-only", "--device", "cpu",
                              "TEST.EXPECTED_RESULTS", "[['bbox', 'AP', 40.0, 0.1]]"])
    with pytest.raises(RuntimeError, match="bbox/AP"):
        run_net.main(bad)


def test_stage3_cli_trains_the_resnest_pafpn_cascade(tmp_path):
    """``python -m afigan_tpu_torch.stage3_train --device cpu`` takes the
    Cascade Mask R-CNN ResNeSt-PAFPN YAML (``MODEL.AFI_FREEZE False``, the
    JAX bench's s101 mode) at narrow widths for two iterations on a tiny
    COCO: finite losses of the three stages in ``metrics.json``, each stage's
    foreground fraction logged, and a ``model_0000002.pth`` whose keys load
    strictly into ``build_model(train=False)``."""
    import json
    import shutil

    import numpy as np
    import torch

    from afigan_tpu_torch import stage3_train
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.utils.converters import load_state_dict
    from tests.fixtures import make_tiny_coco
    from tests.torch_port_gan_tiny import CASCADE_NARROW

    root, out = tmp_path / "root", tmp_path / "out"
    json_path, img_dir = make_tiny_coco(str(tmp_path / "raw"), num_images=2, hw=(96, 128))
    os.makedirs(root / "coco" / "annotations")
    shutil.copy(json_path, root / "coco" / "annotations" / "instances_train2017.json")
    shutil.copytree(img_dir, root / "coco" / "train2017")
    yaml = os.path.join(REPO, "configs/inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml")
    opts = [*CASCADE_NARROW, "INPUT.MIN_SIZE_TRAIN", "(64, 72)", "INPUT.MAX_SIZE_TRAIN", "128",
            "TPU.IMAGE_BUCKETS", "((128, 128),)", "TPU.MAX_GT_BOXES", "8",
            "TPU.MASK_CANVAS", "28", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2",
            "SOLVER.CHECKPOINT_PERIOD", "2", "DATASETS.TEST", "()", "SEED", "3",
            "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(out)]
    trainer = stage3_train.main(stage3_train.parse_args(
        ["--config-file", yaml, "--device", "cpu", *opts]))
    assert type(trainer.model.roi_heads).__name__ == "CascadeROIHeads" and trainer.model.training
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    assert lines[-1]["iteration"] == 1
    for r in lines:
        assert all(np.isfinite(r[f"{k}_stage{s}"]) for s in range(3)
                   for k in ("loss_cls", "loss_box_reg"))
        assert np.isfinite(r["total_loss"]) and np.isfinite(r["loss_mask"])
        assert all(f"diag_fg_frac_stage{s}" in r for s in range(3))
    saved = load_state_dict(str(out / "model_0000002.pth"))
    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.merge_from_list(opts)
    model = build_model(cfg, device="cpu")
    assert not model.training
    model.load_state_dict({k: torch.as_tensor(v) for k, v in saved.items()}, strict=True)
    key = "backbone.bottom_up.res3.0.conv2.bn1.running_var"
    assert not np.allclose(saved[key], 1.0)  # the batch statistics trained
