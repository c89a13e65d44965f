"""The port stands on its own: nothing under ``afigan_tpu_torch/`` nor
``chip_smoke.py`` imports jax, flax or the JAX package, or reaches a file of
the JAX package by path; importing the port loads none of them. The port's
copies of the JAX package's numpy host code are held against the originals:
equal config trees from every inference YAML, equal AP from both evaluators
on the same predictions, equal dataset records and resize numerics.
"""

import ast
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from tests.fixtures import make_tiny_coco
from tests.torch_port_common import REPO

FORBIDDEN = ("jax", "jaxlib", "flax", "afigan_tpu")
# a "file.py:line" citation, optionally with the function and a note:
# "afigan_tpu/ops/nms.py:36::nms_keep_mask (XLA code, not a Pallas kernel)"
CITATION = re.compile(r"^afigan_tpu/[\w/]+\.py:\d+(::\w+ \([\w ,]+\))?$")
PORT_FILES = sorted(
    glob.glob(os.path.join(REPO, "afigan_tpu_torch", "**", "*.py"), recursive=True)
) + [os.path.join(REPO, "chip_smoke.py")]
SUBPACKAGES = ["afigan_tpu_torch." + m for m in (
    "config", "data", "data.loader", "engine.inference", "evaluation", "models",
    "models.swin", "models.bifpn", "models.cascade_roi_heads", "ops.kernels.layer_norm",
    "ops.kernels.window_attention", "ops.kernels.afi_generator", "ops.kernels.roi_pool",
    "ops.kernels.window_gather", "ops.roi_align", "models.fcos", "models.centermask",
    "utils.converters", "run_net", "ops.kernels.nms", "ops.nms", "engine.testing",
    "ops.matcher", "ops.sampling", "ops.losses", "ops.image_list", "engine.solver",
    "engine.stage3", "engine.events", "engine.train_loop", "engine.checkpoint",
    "engine.trainers", "data.dataset_mapper", "stage3_train", "tools.frozen_bn",
    "models.afi.discriminator", "engine.stage1", "engine.stage2", "stage1_train",
    "stage2_train", "models.pafpn", "models.resnest", "engine.tta", "parallel",
    "parallel.dist", "engine.launch", "engine.precise_bn", "utils.msgpack_tree",
    "utils.profiling", "tools.convert_checkpoint", "tools.validate_training",
    "tools.generate_pseudo_labels", "models.keypoint_head", "models.res5_roi_heads")]


def _violations(path):
    tree = ast.parse(open(path).read(), path)
    doc_nodes = {id(n.body[0].value) for n in ast.walk(tree)
                 if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                 and n.body and isinstance(n.body[0], ast.Expr)
                 and isinstance(n.body[0].value, ast.Constant)}
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"line {node.lineno}: import of {name}")
        # a string that names the JAX package as a path component or module
        # (docstrings may cite the file each module is the counterpart of, and
        # a "file.py:line" citation of a TPU kernel opens nothing)
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in doc_nodes and not CITATION.match(node.value)):
            parts = node.value.replace("\\", "/").replace(".", "/").split("/")
            if "afigan_tpu" in parts:
                bad.append(f"line {node.lineno}: string {node.value!r}")
    return bad


def test_port_files_found():
    assert len(PORT_FILES) > 35
    assert any(p.endswith("models/swin.py") for p in PORT_FILES)
    assert any(p.endswith("parallel/dist.py") for p in PORT_FILES)
    assert any(p.endswith("engine/launch.py") for p in PORT_FILES)
    assert any(p.endswith("models/keypoint_head.py") for p in PORT_FILES)
    assert any(p.endswith("models/res5_roi_heads.py") for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    assert _violations(path) == []


def test_the_check_sees_imports_and_paths(tmp_path):
    src = tmp_path / "m.py"
    src.write_text('"""cites afigan_tpu/config in its docstring."""\n'
                   "import os\nfrom afigan_tpu.config import get_cfg\nimport jax.numpy as jnp\n"
                   "def f():\n    import flax\n"
                   "    return os.path.join('..', 'afigan_tpu', 'data', 'coco.py')\n"
                   "P = 'afigan_tpu/data/coco.py'\nCITE = 'afigan_tpu/ops/pallas/roi_pool.py:81'\nOK = 'afigan_tpu_torch/csrc/roi_pool.cu'\n"
                   "NOTE = 'afigan_tpu/ops/nms.py:36::nms_keep_mask (XLA code, not a Pallas kernel)'\n"
                   "BAD = 'afigan_tpu/ops/nms.py:36 and more'\n")
    got = _violations(str(src))
    assert len(got) == 6, got


def test_importing_the_port_loads_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {SUBPACKAGES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "inference", "*.yaml")))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_same_yaml_gives_equal_config(path):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    overrides = ["MODEL.AFI.N_RDB", "1", "TPU.IMAGE_BUCKETS", "((128, 256),)",
                 "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)"]
    dumps = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(path)
        cfg.merge_from_list(list(overrides))
        cfg.pop("CUDA", None)  # the port's own node
        dumps.append(cfg.dump())
    assert len(dumps[0]) > 5000
    assert dumps[0] == dumps[1]


def _predictions(dataset, rng):
    """Ground truth jittered into detections: AP strictly between 0 and 100."""
    preds = {}
    for ann in dataset.annotations:
        x, y, w, h = ann["bbox"]
        box = np.array([x, y, x + w, y + h]) + rng.randn(4) * 4.0
        preds.setdefault(ann["image_id"], []).append(
            (box, rng.rand(), dataset.cat_id_to_contiguous[ann["category_id"]]))
    return preds


def test_both_evaluators_give_equal_ap(tmp_path):
    from afigan_tpu.data.coco import CocoDataset as JaxDataset
    from afigan_tpu.evaluation import CocoEvaluator as JaxEvaluator
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.evaluation import CocoEvaluator

    json_path, img_dir = make_tiny_coco(str(tmp_path), num_images=6, hw=(96, 128))
    results = []
    for ds_cls, ev_cls in ((JaxDataset, JaxEvaluator), (CocoDataset, CocoEvaluator)):
        ds = ds_cls(json_path, img_dir)
        preds = _predictions(ds, np.random.RandomState(0))
        h, w = 96, 128
        ev = ev_cls(ds, tasks=("bbox", "segm"))
        for img_id, dets in preds.items():
            boxes = np.stack([d[0] for d in dets])[None]
            masks = []
            for box, _, _ in dets:
                m = np.zeros((h, w), np.uint8)
                x1, y1, x2, y2 = np.clip(box, 0, [w, h, w, h]).astype(int)
                m[y1:y2, x1:x2] = 1
                masks.append(m)
            ev.process([img_id], boxes, np.array([[d[1] for d in dets]]),
                       np.array([[d[2] for d in dets]]), np.ones((1, len(dets)), bool),
                       masks=[masks])
        results.append(ev.evaluate())
    want, got = results
    assert 1.0 < want["bbox"]["AP"] < 99.0
    assert want.keys() == got.keys() == {"bbox", "segm"}
    for task in want:
        assert want[task].keys() == got[task].keys()
        for k in want[task]:
            np.testing.assert_allclose(got[task][k], want[task][k], rtol=0, atol=1e-9,
                                       err_msg=f"{task}/{k}")


def test_data_copies_match_originals(tmp_path):
    from afigan_tpu.data import coco as jcoco, transforms as jtransforms
    from afigan_tpu_torch.data import coco, transforms

    json_path, img_dir = make_tiny_coco(str(tmp_path), num_images=3, hw=(96, 128))
    want, got = jcoco.CocoDataset(json_path, img_dir), coco.CocoDataset(json_path, img_dir)
    assert got.img_ids == want.img_ids and got.cat_ids == want.cat_ids
    assert len(got.records) == len(want.records) == 3
    for g, w in zip(got.records, want.records):
        assert g["file_name"] == w["file_name"] and len(g["annotations"]) == len(w["annotations"])
    img = coco.read_image(got.records[0]["file_name"], "BGR")
    np.testing.assert_array_equal(img, jcoco.read_image(want.records[0]["file_name"], "BGR"))
    for hw in ((96, 128), (480, 640), (1000, 333)):
        a = transforms.test_transform(*hw, 800, 1333)
        b = jtransforms.test_transform(*hw, 800, 1333)
        assert (a.new_h, a.new_w) == (b.new_h, b.new_w)
    np.testing.assert_array_equal(
        transforms.test_transform(96, 128, 64, 100).apply_image(img),
        jtransforms.test_transform(96, 128, 64, 100).apply_image(img))
