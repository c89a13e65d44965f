"""What a data-parallel rank relies on besides the collectives, on the CPU.

- The launch device guard: every ctypes wrapper under
  ``afigan_tpu_torch/ops/kernels/`` takes the stream of its launch from
  ``_build.stream_ptr(*tensors)``, which raises when a CUDA tensor of the
  launch lies on another card than the current one (a rank on card k that
  never called ``torch.cuda.set_device`` would launch on card 0 with card
  k's pointers). Held by patching the device query, and by reading every
  wrapper: each function that loads a kernel library passes the launch's
  tensors to the guard, and no launch takes the stream without it.
- Stage 2's DropPath stream: ``AFExtractorTrainer`` seeds its own
  ``drop_path`` generator (seed + 2, as ``TargetDetectorTrainer``), and
  ``stage2.train_step(..., drop_path=)`` draws a Swin detector's masks from
  it: two trainers of one seed draw the same masks, some kept and some
  dropped, and torch's default generator does not move.
"""

import ast
import glob
import os
import types

import numpy as np
import pytest
import torch

from afigan_tpu_torch.ops.kernels import _build
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import SWIN_NARROW, fcos_stage2_batch, port_draws

WRAPPERS = sorted(p for p in glob.glob(os.path.join(REPO, "afigan_tpu_torch", "ops", "kernels",
                                                    "*.py"))
                  if not os.path.basename(p).startswith("_"))


def _fake(index):
    return types.SimpleNamespace(device=torch.device("cuda", index))


def test_stream_ptr_refuses_a_tensor_on_another_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=1234))
    assert _build.stream_ptr(_fake(0), None, torch.zeros(1)) == 1234
    with pytest.raises(RuntimeError, match="set_device"):
        _build.stream_ptr(_fake(0), _fake(1))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert _build.stream_ptr(_fake(1)) == 1234
    with pytest.raises(RuntimeError, match="on cuda:0"):
        _build.stream_ptr(_fake(0))
    with pytest.raises(TypeError):
        _build.stream_ptr()


def _calls(node, attr):
    return [n for n in ast.walk(node) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == attr
            and isinstance(n.func.value, ast.Name) and n.func.value.id == "_build"]


@pytest.mark.parametrize("path", WRAPPERS, ids=os.path.basename)
def test_every_launch_passes_its_tensors_to_the_guard(path):
    tree = ast.parse(open(path).read(), path)
    launchers = [f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
                 and _calls(f, "load")]
    for f in launchers:
        guarded = _calls(f, "stream_ptr")
        assert guarded, f"{f.name} loads a kernel library and takes no guarded stream"
        assert all(c.args for c in guarded), f"{f.name}: stream_ptr() without the tensors"
    assert all(c.args for c in _calls(tree, "stream_ptr"))


def test_every_kernel_wrapper_is_read():
    names = {os.path.basename(p) for p in WRAPPERS}
    assert {"afi_generator.py", "layer_norm.py", "nms.py", "roi_pool.py",
            "window_attention.py", "window_gather.py", "deform_conv.py"} <= names
    launches = sum(len(_calls(ast.parse(open(p).read()), "load")) for p in WRAPPERS)
    # conv3x3, subpixel, rdb chain, upsample, LN, NMS, pool x2, attn, gather,
    # the deformable conv's sampling and adjoint
    assert launches == 12


SWIN_STAGE2 = [*SWIN_NARROW, "MODEL.GUIDE_ARCHITECTURE", "RCNN_FPN_only",
               "MODEL.GUIDE_BACKBONE.NAME", "build_swint_bifpn_backbone",
               "MODEL.SWINT.DROP_PATH_RATE", "0.3", "SEED", "3"]


def test_stage2_draws_droppath_masks_from_the_trainers_stream(monkeypatch, tmp_path):
    """Two ``AFExtractorTrainer``s of a narrow Swin-BiFPN detector (the Swin
    cascade YAML at ``SWIN_NARROW``'s widths, DropPath 0.3, a Swin-BiFPN
    guide) from one seed: one stage-2 step each through their own
    ``drop_path`` stream draws the same masks, both kept and dropped
    branches, and the same losses; torch's default generator stays."""
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.engine import stage2
    from afigan_tpu_torch.engine.trainers import AFExtractorTrainer
    from afigan_tpu_torch.models import swin

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "inference",
                                     "AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml"))
    cfg.merge_from_list(SWIN_STAGE2 + ["OUTPUT_DIR", str(tmp_path)])
    gt = (np.asarray([[[8, 8, 60, 48], [30, 40, 100, 90]]] * 2, np.float32),
          np.zeros((2, 2), np.int32), np.ones((2, 2), bool))
    inputs = stage2.batch_to_device(fcos_stage2_batch(gt), "cpu")
    masks = []
    real = swin.drop_path_keep

    def record(source, shape, keep, device):
        assert isinstance(source, torch.Generator)
        masks[-1].append(real(source, shape, keep, device))
        return masks[-1][-1]

    monkeypatch.setattr(swin, "drop_path_keep", record)
    runs = []
    for _ in range(2):
        trainer = AFExtractorTrainer(cfg, device="cpu")
        assert trainer.drop_path.initial_seed() == 3 + 2
        masks.append([])
        state = torch.random.get_rng_state()
        metrics = stage2.train_step(cfg, trainer.state, inputs, port_draws, trainer.drop_path)
        assert torch.equal(torch.random.get_rng_state(), state)
        assert np.isfinite(metrics["total_loss"])
        runs.append(metrics)
    assert len(masks[0]) == len(masks[1]) > 4
    for a, b in zip(*masks):
        assert torch.equal(a, b)
    drawn = torch.cat([m.flatten() for m in masks[0]])
    assert drawn.any() and not drawn.all()
    for k, v in runs[0].items():  # CPU reductions may sum in another order
        np.testing.assert_allclose(runs[1][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
