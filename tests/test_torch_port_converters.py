"""One set of weights for both packages, and one config.

* ``variables_to_state_dict`` (flax → d2 names) loads strictly into the
  port's Mask R-CNN R-50-FPN+AFI, and the port's ``state_dict()`` maps back
  through the JAX package's ``state_dict_to_variables`` to identical arrays.
* ``main_path_cfg()`` equals ``get_cfg()`` merged with the R-50 inference
  YAML on every key.
* Importing the port leaves jax, flax and cv2 unimported.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models import build_model as jax_build
from afigan_tpu.utils.converters import state_dict_to_variables
from afigan_tpu_torch.config import get_cfg, main_path_cfg
from afigan_tpu_torch.models import build_model
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import REPO, small_cfg
from tests.torch_port_gan_tiny import GAN_TINY


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converters_round_trip_full_tree():
    cfg = small_cfg()
    jm = jax_build(cfg, train=False)
    variables = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                        jnp.zeros((1, 64, 64, 3)),
                                        jnp.asarray([[64, 64]], jnp.int32)))()
    variables = jax.tree.map(np.asarray, variables)
    sd = variables_to_state_dict(variables)
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    # every generator weight of the reference Sequential layout is present
    assert "backbone.srf_module.Generators.0.1.RDBs.2.conv4.0.weight" in sd
    assert "backbone.srf_module.Generators.0.1.RDBs.2.conv5.weight" in sd

    back, report = state_dict_to_variables(
        {k: v.numpy() for k, v in model.state_dict().items()}, template=variables)
    assert not report["unmatched"] and not report["mismatched"]
    leaves = list(_leaves(variables["params"]))
    assert len(report["matched"]) == len(leaves)
    for path, leaf in leaves:
        node = back["params"]
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node, leaf, err_msg="/".join(path))


def _stage_cfg(yaml):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, yaml))
    cfg.merge_from_list(list(GAN_TINY))
    return cfg


def _build_model(device=None):
    model = build_model(small_cfg(), **({} if device is None else {"device": device}))
    return next(model.parameters()).device


def _trainer(name, yaml):
    def make(device=None):
        from afigan_tpu_torch.engine import trainers

        t = getattr(trainers, name)(_stage_cfg(yaml),
                                    **({} if device is None else {"device": device}))
        return t.device
    return make


def _cli(module, yaml):
    def run(device=None):
        import importlib
        import types

        from afigan_tpu_torch.data import coco

        mod = importlib.import_module(f"afigan_tpu_torch.{module}")
        # no iteration: the loader never reads the (empty) dataset
        coco.register_dataset("refusal_empty", lambda: types.SimpleNamespace(records=[]))
        argv = ["--config-file", os.path.join(REPO, yaml), *GAN_TINY, "SOLVER.MAX_ITER", "0",
                "DATASETS.TRAIN", "('refusal_empty',)"]
        args = mod.parse_args(argv if device is None else ["--device", device, *argv])
        if device is None:
            assert args.device == "cuda"
        return mod.main(args).device
    return run


S1 = "configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
S2 = "configs/step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"
ENTRY_POINTS = {
    "build_model": _build_model,
    "AFIGANTrainer": _trainer("AFIGANTrainer", S1),
    "AFExtractorTrainer": _trainer("AFExtractorTrainer", S2),
    "stage1_train": _cli("stage1_train", S1),
    "stage2_train": _cli("stage2_train", S2),
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_gpu_and_refuse_without_one(entry, monkeypatch, tmp_path):
    """``build_model(cfg)``, ``run_net``, the stage-1 and stage-2 trainers and
    their CLIs mean the GPU: without one they raise, and only an explicit
    ``device="cpu"`` builds on the CPU."""
    from afigan_tpu_torch.run_net import parse_args

    monkeypatch.chdir(tmp_path)  # the CLIs' OUTPUT_DIR
    assert parse_args(["--config-file", "x.yaml"]).device == "cuda"
    fn = ENTRY_POINTS[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()
    assert torch.device(fn("cpu")).type == "cpu"


def _cfg_pairs(plain, full, prefix=""):
    for k, v in plain.items():
        if isinstance(v, dict):
            yield from _cfg_pairs(v, full[k], prefix + k + ".")
        else:
            yield prefix + k, v, full[k]


def _norm(v):
    return [_norm(x) for x in v] if isinstance(v, (list, tuple)) else v


def test_main_path_cfg_equals_yaml():
    full = get_cfg()
    full.merge_from_file(os.path.join(REPO, "configs/inference/AFI-GAN_maskrcnn_R_50_FPN.yaml"))
    pairs = list(_cfg_pairs(main_path_cfg(), full))
    assert len(pairs) > 60
    for key, mine, ref in pairs:
        assert _norm(mine) == _norm(ref), key


@pytest.mark.parametrize("module", [
    "afigan_tpu_torch",
    "afigan_tpu_torch.models",
    "afigan_tpu_torch.ops.kernels.afi_generator",
    "afigan_tpu_torch.ops.kernels.roi_pool",
    "afigan_tpu_torch.engine.inference",
    "afigan_tpu_torch.data",
])
def test_port_imports_no_jax(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in ('jax', 'flax', 'cv2') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
