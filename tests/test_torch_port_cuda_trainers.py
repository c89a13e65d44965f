"""The trainers' weight hand-offs between stages, on the card.

A stage-1 generator and discriminator go into the stage-2 trainer
(``MODEL.AFI_GEN_WEIGHTS`` through ``transplant_generator``,
``MODEL.AFI_DIS_WEIGHTS``), and a stage-2 detector's AF interpolator goes
into the stage-3 trainer (``MODEL.AF_EXTRACTOR_WEIGHTS`` through
``transplant_afi_between_detectors``), each trainer built with
``device="cuda"``, its default. What moved must equal the checkpoint to the
bit; every other entry keeps the value of the same trainer built without
the file. The narrow Mask R-CNN R-50-FPN(AFI) of
``tests/torch_port_gan_tiny.py::GAN_TINY``.

Then one stage-2 step of the FCOS R-50-BiFPN step-2 YAML and one stage-3
step of CenterMask R-50-BiFPN on the card against the same step on the CPU,
from the same weights (FrozenBN calibrated on the batch), at the narrow widths
of ``tests/torch_port_gan_tiny.py`` in float32 with TF32 off: the metrics at
1e-4 relative, the batch-norm statistics after the step at 1e-4 of each
tensor's largest entry, the parameters after the step at 1e-5 absolute (lr
0.001); CenterMask launches its pool forward and backward once and NMS
twice on the card.

Marked ``cuda``: they skip without an NVIDIA GPU, where the same chain runs on
the CPU in ``tests/test_torch_port_dual_scale.py``. Run them on the card with
``python -m pytest tests/test_torch_port_cuda_trainers.py -q``.
"""

import os

import pytest
import torch

from afigan_tpu_torch.config import get_cfg
from afigan_tpu_torch.engine import stage1, stage2, stage3
from afigan_tpu_torch.engine.checkpoint import AFI_PREFIX, save_checkpoint
from afigan_tpu_torch.engine.trainers import AFExtractorTrainer, TargetDetectorTrainer
# bare, as in test_torch_port_cuda.py; the helper imports no JAX, which the
# card's machine need not have
from torch_port_gan_tiny import (CENTERMASK_NARROW, FCOS_NARROW, GAN_TINY, centermask_batch,
                                  fcos_stage2_batch)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP1 = "configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
STEP2 = "configs/step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"
STEP3 = "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"
STEP2_FCOS = "configs/step2_af_extractor_training/step2_af_extractor_fcos_R_50_BiFPN.yaml"
CENTERMASK = "configs/inference/AFI-GAN_centermask_R_50_BiFPN.yaml"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the trainers' default device")


def _cfg(yaml, out, *extra):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, yaml))
    cfg.merge_from_list([*GAN_TINY, "DATASETS.ROOT", str(out), "OUTPUT_DIR", str(out), *extra])
    return cfg


def _fill(state, seed):
    """Every floating entry of ``state`` (a module's state dict) set to seeded
    uniform noise in [0, 1), unlike any initialisation's."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for v in state.values():
            if v.is_floating_point():
                v.copy_(torch.rand(v.shape, generator=gen))


def _check_moved(got, base, want):
    """``got``'s entries under ``want``'s names equal ``want``'s, and differ
    from ``base``'s; every other entry equals ``base``'s."""
    assert want and set(want) <= set(got)
    for k, v in got.items():
        assert v.is_cuda, k
        if k in want:
            assert torch.equal(v.cpu(), want[k]), k
            assert not torch.equal(base[k].cpu(), want[k]), k
        else:
            assert torch.equal(v, base[k]), k


def test_stage2_trainer_takes_stage1_weights_on_the_card(cuda, tmp_path):
    s1 = stage1.init_stage1_state(_cfg(STEP1, tmp_path / "s1"), device="cpu")
    _fill(s1.generator.state_dict(), 1)
    _fill(s1.discriminator.state_dict(), 2)
    g_path = save_checkpoint(str(tmp_path / "s1" / "G_0"), 2, s1.generator)
    d_path = save_checkpoint(str(tmp_path / "s1" / "D_0"), 2, s1.discriminator)

    base = AFExtractorTrainer(_cfg(STEP2, tmp_path / "base"))
    t2 = AFExtractorTrainer(_cfg(STEP2, tmp_path / "s2", "MODEL.AFI_GEN_WEIGHTS", g_path,
                                 "MODEL.AFI_DIS_WEIGHTS", d_path))
    _check_moved(t2.model.state_dict(), base.model.state_dict(),
                 {AFI_PREFIX + k: v for k, v in s1.generator.state_dict().items()})
    _check_moved(t2.state.discriminator.state_dict(), base.state.discriminator.state_dict(),
                 s1.discriminator.state_dict())


def test_stage3_trainer_takes_a_stage2_af_interpolator_on_the_card(cuda, tmp_path):
    s2 = stage2.init_stage2_state(_cfg(STEP2, tmp_path / "s2"), device="cpu")
    det = s2.model.state_dict()
    _fill(det, 3)
    path = save_checkpoint(str(tmp_path / "s2" / "AFExtractor"), 2, s2.model)

    base = TargetDetectorTrainer(_cfg(STEP3, tmp_path / "base"))
    t3 = TargetDetectorTrainer(_cfg(STEP3, tmp_path / "s3", "MODEL.AF_EXTRACTOR_WEIGHTS", path))
    _check_moved(t3.model.state_dict(), base.model.state_dict(),
                 {k: v for k, v in det.items() if k.startswith(AFI_PREFIX)})


@pytest.fixture
def no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _fixed_draws(shape, device):
    """Subsample keys keyed by the number of labels, the same on both devices."""
    import numpy as np

    keys = np.random.RandomState(1000 + shape[-1]).rand(2, shape[-1]).astype(np.float32)
    return tuple(torch.from_numpy(np.broadcast_to(0.1 + 0.9 * k, shape).copy()).to(device)
                 for k in keys)


def _card_and_cpu(init, modules, calibrate, step):
    """``step(state, device)`` on the CPU and on the card from one set of
    weights: [(metrics, {name: tensor} after the step on the CPU, launches)]
    for the CPU, then the card."""
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    out, weights = [], None
    for dev in ("cpu", "cuda"):
        state = init(dev)
        if weights is None:
            for module, images in calibrate(state):
                calibrate_frozen_bn(module, images)
            weights = [{k: v.clone() for k, v in m.state_dict().items()}
                       for m in modules(state)]
        else:
            for m, w in zip(modules(state), weights):
                m.load_state_dict(w)
        reset_launches()
        metrics = step(state, dev)
        after = {f"{i}.{k}": v.cpu() for i, m in enumerate(modules(state))
                 for k, v in m.state_dict().items()}
        out.append((metrics, after, dict(LAUNCHES)))
    return out


def _check_equal(cpu, card):
    (mc, ac, _), (mg, ag, _) = cpu, card
    assert set(mc) == set(mg)
    for k, v in mc.items():
        assert abs(mg[k] - v) <= 1e-4 * abs(v) + 1e-7, (k, mg[k], v)
    for k, v in ac.items():
        err = float((ag[k] - v).abs().max()) if v.numel() else 0.0
        if "running_" in k:
            assert err <= 1e-4 * float(v.abs().max()), k
        else:
            assert err <= 1e-5, (k, err)


def test_fcos_stage2_step_on_the_card_equals_the_cpu(cuda, no_tf32, tmp_path):
    import numpy as np

    cfg = _cfg(STEP2_FCOS, tmp_path, *FCOS_NARROW)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, 1] = [8, 8, 40, 40]
    boxes[:, 2] = [20, 24, 100, 110]
    batch = fcos_stage2_batch((boxes, np.array([[0, 1, 2, 0]] * 2, np.int32),
                               np.array([[False, True, True, False]] * 2)))

    def init(dev):
        return stage2.init_stage2_state(cfg, dev, torch.Generator().manual_seed(1))

    cpu, card = _card_and_cpu(
        init, lambda st: (st.model, st.discriminator, st.guide),
        lambda st: ((st.model, torch.from_numpy(batch["image_x0.5"])),
                    (st.guide, torch.from_numpy(batch["image"]))),
        lambda st, dev: stage2.train_step(cfg, st, stage2.batch_to_device(batch, dev)))
    _check_equal(cpu, card)
    assert {"loss_fcos_cls", "adv_loss_p7", "d_loss"} <= set(card[0])
    assert not any(card[2].values())  # FCOS pools nothing and decodes nothing in training


def test_centermask_stage3_step_on_the_card_equals_the_cpu(cuda, no_tf32, tmp_path):
    cfg = _cfg(CENTERMASK, tmp_path, *CENTERMASK_NARROW)
    batch = centermask_batch()

    def init(dev):
        return stage3.init_stage3_state(cfg, dev, torch.Generator().manual_seed(1))

    cpu, card = _card_and_cpu(
        init, lambda st: (st.model,), lambda st: ((st.model, torch.from_numpy(batch["image"])),),
        lambda st, dev: stage3.train_step(cfg, st, stage3.batch_to_device(batch, dev),
                                          _fixed_draws))
    _check_equal(cpu, card)
    assert card[0]["loss_mask"] > 0
    launched = card[2]
    assert (launched["roi_pool"], launched["roi_pool_bwd"], launched["nms"]) == (1, 1, 2)
