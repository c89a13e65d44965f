"""The port's tools (``afigan_tpu_torch/tools/`` and ``utils/profiling.py``)
against the JAX package's ``tools/``, on the CPU at tiny sizes.

- ``validate_training``: ``make_scene_coco`` gives the JAX tool's images
  (decoded) and JSON for a seed; the judges give the JAX tool's checks and
  verdicts on hand-made ``metrics.json`` files (falling, rising then falling,
  spiky, NaN); ``_cfg`` gives the JAX tool's config key for key; ``--tiny
  --iters 8 --device cpu`` runs the three r50 stages with the stage 1 -> 2 -> 3
  hand-off through the trainers' files and writes ``summary.json``.
- ``generate_pseudo_labels``: the JAX tool and the port's on the same
  ``.msgpack`` weights (the golden R-50-FPN Mask R-CNN) and three scene
  images give the same JSON: ids, categories and count equal, boxes within
  0.05 px, scores within 1e-3, equal RLE masks and areas.
- ``convert_checkpoint``: a d2 ``.pkl`` detector and stage 1's ``.msgpack``
  G and D into ``.pth`` files that load strictly with the same values.
- ``ProfilerHook``: the trace holds the window's iterations and no other.

The JAX tools are imported by file path, here only.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from afigan_tpu_torch.tools import convert_checkpoint, generate_pseudo_labels
from afigan_tpu_torch.tools import validate_training as vt
from tests.torch_port_common import GOLDEN_OVERRIDES, REPO, golden_cfg, port_and_jax


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JVT = _jax_tool("validate_training")


def test_scene_coco_equals_jax(tmp_path):
    from PIL import Image

    outs = [mod.make_scene_coco(str(tmp_path / name), num_images=3, hw=(96, 128), seed=4)
            for name, mod in (("jax", JVT), ("port", vt))]
    (jj, jdir), (pj, pdir) = outs
    with open(jj) as f, open(pj) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got["annotations"]) >= 9
    for im in want["images"]:
        a = np.asarray(Image.open(os.path.join(jdir, im["file_name"])))
        b = np.asarray(Image.open(os.path.join(pdir, im["file_name"])))
        assert a.shape == (96, 128, 3)
        np.testing.assert_array_equal(b, a, im["file_name"])


def _write_metrics(out_dir, n, case):
    """``n`` writer records of every key the judges read, shaped by ``case``."""
    rs = np.random.RandomState(len(case))
    t = np.linspace(0, 1, n)
    shapes = {"falling": 2.0 - 1.5 * t,
              "rise_then_fall": np.where(t < 0.3, 0.1 + 3 * t, 1.0 - 0.8 * (t - 0.3)),
              "spiky": 1.0 - 0.5 * t + np.where(rs.rand(n) > 0.7, 2.0, 0.0),
              "nan": np.where(t > 0.6, np.nan, 1.0 - 0.3 * t)}
    base = shapes[case]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "metrics.json"), "w") as f:
        for i in range(n):
            rec = {"iteration": 20 * i + 19}
            for j, key in enumerate(("loss_cls", "loss_box_reg", "loss_mask", "loss_fcos_cls",
                                     "loss_fcos_loc", "loss_fcos_ctr", "g_loss", "d_loss",
                                     "total_loss")):
                rec[key] = float(base[i] * (1 + 0.1 * j))
            for lvl in ("p2", "p3"):
                rec[f"content_loss_{lvl}"] = float(500 * base[i])
                rec[f"adv_loss_{lvl}"] = float(0.7 + 0.1 * base[i])
            for s in range(3):
                rec[f"loss_cls_stage{s}"] = float(base[::-1][i] if s == 2 else base[i])
                rec[f"loss_box_reg_stage{s}"] = float(base[i] * (s + 1))
            f.write(json.dumps(rec) + "\n")


# the full judges' verdicts: stage 1, then stages 2 and 3 for each family of
# DET_KEYS (rcnn, cascade, cascade_nomask, fcos, centermask, keypoint_rcnn;
# the records hold no loss_keypoint, so keypoint_rcnn never passes). A spike
# in 3 of 12 records leaves the medians and the quarter means falling
_FALLING = [True] + [True] * 5 + [False] + [True] * 5 + [False]
EXPECTED_VERDICTS = {
    "falling": _FALLING, "spiky": _FALLING,
    "rise_then_fall": [False, False, True, True, False, False, False,
                       False, True, True, False, False, False],
    "nan": [False] * 13}


@pytest.mark.parametrize("case", ["falling", "rise_then_fall", "spiky", "nan"])
def test_judges_equal_jax(case, tmp_path):
    out = str(tmp_path / case)
    _write_metrics(out, 12, case)
    verdicts = []
    for tiny in (False, True):
        for stage in ("1", "2", "3"):
            for det in (vt.DET_KEYS if stage != "1" else [None]):
                args = (out, tiny) if stage == "1" else (out, tiny, det)
                want = getattr(JVT, f"_judge_stage{stage}")(*args)
                got = getattr(vt, f"_judge_stage{stage}")(*args)
                assert json.dumps(got) == json.dumps(want), (stage, det, tiny)
                verdicts.append(bool(got[1]))
    # tiny mode judges finiteness only; the full judges tell the cases apart
    full, tiny = verdicts[:len(verdicts) // 2], verdicts[len(verdicts) // 2:]
    assert full == EXPECTED_VERDICTS[case], full
    assert all(tiny) == (case != "nan")


YAML_CASES = [(os.path.basename(y), tiny) for y in (
    vt.STEP1_YAML, *vt.STEP2_YAMLS.values(), *vt.STEP3_YAMLS.values()) for tiny in (False, True)]
YAML_PATHS = {os.path.basename(y): y for y in (vt.STEP1_YAML, *vt.STEP2_YAMLS.values(),
                                                 *vt.STEP3_YAMLS.values())}


@pytest.mark.parametrize("yaml,tiny", YAML_CASES)
def test_cfg_equals_jax(yaml, tiny, tmp_path):
    path = YAML_PATHS[yaml]
    assert path == os.path.join(REPO, os.path.relpath(path, REPO))
    want = JVT._cfg(path, str(tmp_path), 150, tiny)
    got = vt._cfg(path, str(tmp_path), 150, tiny)
    got.pop("CUDA", None)  # the port's own node
    assert got.dump() == want.dump()


def test_validate_training_tiny_runs_three_r50_stages(tmp_path, monkeypatch):
    from afigan_tpu_torch.engine import trainers

    loaded = []
    for cls, meth in ((trainers.AFExtractorTrainer, "load_afigen_weight"),
                      (trainers.TargetDetectorTrainer, "load_af_extractor_weight")):
        real = getattr(cls, meth)
        monkeypatch.setattr(cls, meth, lambda self, path, real=real: (
            loaded.append(os.path.relpath(path, tmp_path)), real(self, path))[1])
    out = str(tmp_path)
    assert vt.main(["--tiny", "--iters", "8", "--device", "cpu", "--out", out]) == 0
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert summary["ok"] and set(summary["stages"]) == set(summary["timing"]) == {"1", "2", "3"}
    assert summary["device"] == "cpu" and summary["timing"]["3"]["median_iter_s"] > 0
    assert loaded == [os.path.join("s1", "G_0", "model_0000008.pth"),
                      os.path.join("s2", "AFExtractor", "model_0000008.pth")]
    for s, key in (("1", "content_loss_p2"), ("2", "loss_cls"), ("3", "total_loss")):
        recs = [json.loads(line) for line in open(tmp_path / f"s{s}" / "metrics.json")]
        assert recs[-1]["iteration"] == 7 and np.isfinite(recs[-1][key])
    # the verdicts again from the files; the keypoint family is a stage-3
    # family
    assert vt.main(["--tiny", "--iters", "8", "--out", out, "--rejudge"]) == 0
    assert vt.parse_args(["--family", "keypoint"]).stages == "3"
    with pytest.raises(SystemExit):
        vt.parse_args(["--family", "keypoint", "--stages", "1,2,3"])
    with pytest.raises(SystemExit):
        vt.parse_args(["--family", "s101", "--stages", "1,2,3"])


PSEUDO_IMAGES = 3


@pytest.fixture(scope="module")
def golden_msgpack(tmp_path_factory):
    """The golden detector's weights as the JAX package writes them, and the
    JAX model with its variables."""
    from flax import serialization

    tmp = tmp_path_factory.mktemp("golden")
    cfg = golden_cfg()
    jm, variables, tm = port_and_jax(cfg)
    path = tmp / "model_final.msgpack"
    path.write_bytes(serialization.to_bytes(variables))
    return str(path), tm


def test_pseudo_labels_equal_jax(golden_msgpack, tmp_path, monkeypatch):
    weights, _ = golden_msgpack
    _, img_dir = vt.make_scene_coco(str(tmp_path / "scenes"), num_images=PSEUDO_IMAGES,
                                    hw=(96, 128), seed=2)
    common = ["--config-file", os.path.join(REPO, "configs", "Base-RCNN-FPN-AFIGAN.yaml"),
              "--weights", weights, "--image-dir", img_dir, "--score-thresh", "0.3"]
    jax_out, port_out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["generate_pseudo_labels.py", *common, "--output", jax_out,
                                      *GOLDEN_OVERRIDES])
    _jax_tool("generate_pseudo_labels").main()
    seen = []
    generate_pseudo_labels.main([*common, "--output", port_out, "--device", "cpu",
                                 *GOLDEN_OVERRIDES], after_image=seen.append)
    with open(jax_out) as f, open(port_out) as g:
        want, got = json.load(f), json.load(g)
    assert seen == [f"scene_{i}.jpg" for i in range(PSEUDO_IMAGES)]
    assert got["images"] == want["images"] and got["categories"] == want["categories"]
    assert [im["id"] for im in got["images"]] == [(1 << 24) + i for i in range(1, 4)]
    ga, wa = got["annotations"], want["annotations"]
    assert len(ga) == len(wa) and 0 < len(wa) < 16 * PSEUDO_IMAGES
    for a, b in zip(ga, wa):
        for k in ("id", "image_id", "category_id", "iscrowd", "segmentation"):
            assert a[k] == b[k], (k, a["id"])
        np.testing.assert_allclose(a["bbox"], b["bbox"], rtol=0, atol=0.05)
        np.testing.assert_allclose(a["score"], b["score"], rtol=0, atol=1e-3)
        assert a["area"] == b["area"] > 0
    assert ga[0]["id"] == 1 << 28


def test_convert_checkpoint_from_pkl(tmp_path):
    """A d2 ``.pkl`` of the golden detector (``{"model": name -> array}``)
    into the port's ``.pth``: every key matched, strict load, same values."""
    from afigan_tpu_torch.models import build_model

    cfg = golden_cfg()
    own = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1)).state_dict()
    src = tmp_path / "model_final.pkl"
    with open(src, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in own.items()}, "__author__": "d2"}, f)
    dst = str(tmp_path / "model.pth")
    report = convert_checkpoint.convert(cfg, str(src), dst, "detector")
    assert len(report["matched"]) == len(own)
    assert not (report["unmatched"] or report["missing"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(dst, weights_only=False)["model"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, own[k]), k


@pytest.mark.parametrize("kind", ["generator", "discriminator"])
def test_convert_checkpoint_from_msgpack(kind, tmp_path):
    """Stage 1's ``G_0`` / ``D_0`` trees of the JAX trainer into ``.pth``
    files through the command line: every entry equal to the converter's."""
    from afigan_tpu.engine.checkpoint import save_checkpoint
    from afigan_tpu_torch.utils.converters import load_state_dict
    from tests.test_torch_port_msgpack import _stage1_trees

    tree = _stage1_trees()[kind == "discriminator"]
    src = save_checkpoint(str(tmp_path), "model_0000100", tree)
    dst = str(tmp_path / f"{kind}.pth")
    assert convert_checkpoint.main([
        "--config-file", os.path.join(REPO, "configs", "step1_afigan_training",
                                      "step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"),
        "--input", src, "--output", dst, "--kind", kind, "MODEL.AFI.IN_CHANNELS", "16",
        "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8"]) == 0
    want = load_state_dict(src, kind)
    got = torch.load(dst, weights_only=False)["model"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)


def test_profiler_hook_traces_the_window_only(tmp_path):
    from afigan_tpu_torch.engine.train_loop import TrainLoop
    from afigan_tpu_torch.utils.profiling import ProfilerHook, annotate, step_timer

    def names(path):
        with open(path) as f:
            return {e["name"] for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "user_annotation"}

    def run(loop):
        def step():
            with annotate(f"iteration_{loop.storage.iter}"):
                torch.ones(8).sum()
            return {"total_loss": 0.0}
        return step

    hook = ProfilerHook(str(tmp_path), start_iter=2, num_iters=2)
    assert not hook.cuda
    loop = TrainLoop(6, [hook])
    loop.run(run(loop))
    assert hook.path == str(tmp_path / "trace_iter2-4.json")
    assert {n for n in names(hook.path) if n.startswith("iteration_")} == {
        "iteration_2", "iteration_3"}
    # a window from the first iteration past the last: after_train closes it
    tail = ProfilerHook(str(tmp_path / "tail"), start_iter=0, num_iters=10)
    loop = TrainLoop(3, [tail])
    loop.run(run(loop))
    assert {n for n in names(tail.path) if n.startswith("iteration_")} == {
        "iteration_0", "iteration_1", "iteration_2"}
    with step_timer() as t:
        pass
    assert t["seconds"] >= 0.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_tools_default_to_the_gpu_and_refuse_without_one(golden_msgpack, tmp_path):
    """Both tools that run a model mean the GPU: without one they raise
    before any work, and only ``--device cpu`` runs on the CPU."""
    weights, _ = golden_msgpack
    assert vt.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        vt.main(["--tiny", "--iters", "2", "--out", str(tmp_path / "v")])
    assert not (tmp_path / "v").exists()
    args = ["--config-file", os.path.join(REPO, "configs", "Base-RCNN-FPN-AFIGAN.yaml"),
            "--weights", weights, "--image-dir", str(tmp_path), "--output",
            str(tmp_path / "p.json")]
    assert generate_pseudo_labels.parse_args(args).device == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        generate_pseudo_labels.main(args)
