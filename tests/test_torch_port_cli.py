"""The port's eval CLI against the JAX CLI's contract.

``python -m afigan_tpu_torch.run_net`` refuses a config with
``TEST.AUG.ENABLED`` (the JAX CLI runs test-time augmentation there, which
the port does not have yet) before it builds any model, and it verifies
``TEST.EXPECTED_RESULTS`` after inference with the port's own copy of
``verify_results``, which must behave as the JAX package's on the same rows.
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


def test_tta_config_raises_before_any_model_is_built(monkeypatch):
    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.models import build

    def refuse(*a, **k):
        raise AssertionError("reached past the TTA check")

    monkeypatch.setattr(build, "build_model", refuse)
    monkeypatch.setattr(coco, "register_default_datasets", refuse)
    args = run_net.parse_args([
        "--config-file",
        os.path.join(REPO, "configs/inference/AFI-GAN_cascade_rcnn_swinL_BiFPN_ST_TTA.yaml"),
        "--eval-only", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        run_net.main(args)


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
