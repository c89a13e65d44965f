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

Marked ``cuda``: they skip without an NVIDIA GPU, where the same chain runs on
the CPU in ``tests/test_torch_port_dual_scale.py``. Run them on the card with
``python -m pytest tests/test_torch_port_cuda_trainers.py -q``.
"""

import os

import pytest
import torch

from afigan_tpu_torch.config import get_cfg
from afigan_tpu_torch.engine import stage1, stage2
from afigan_tpu_torch.engine.checkpoint import AFI_PREFIX, save_checkpoint
from afigan_tpu_torch.engine.trainers import AFExtractorTrainer, TargetDetectorTrainer
# bare, as in test_torch_port_cuda.py; the helper imports no JAX, which the
# card's machine need not have
from torch_port_gan_tiny import GAN_TINY

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP1 = "configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
STEP2 = "configs/step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"
STEP3 = "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"


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
