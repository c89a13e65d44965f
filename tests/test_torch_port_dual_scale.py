"""The port's dual-scale data of stages 1-2 and the stage 1 → 2 → 3 chain, on
the CPU.

Data against the JAX package with the same seed, on tests/fixtures.py's tiny
COCO: the training mapper with ``dual_scale`` (the x0.5 replay of each sampled
transform, and ``gt_x0.5`` on the full-resolution pass's instance selection
with its mask canvases) and the collate step (``image_x0.5`` on the half
canvas, ``image_sizes_x0.5``, ``gt_x0.5``, and no full-resolution ``gt``),
equal to the last bit; the loader's first batches.

The chain (the counterpart of tests/test_trainer_stage12.py): the CLIs
``python -m afigan_tpu_torch.stage1_train`` / ``stage2_train`` /
``stage3_train`` (their ``main``) with ``--device cpu`` train a narrow Mask
R-CNN R-50-FPN(AFI) two iterations each on that COCO laid out under
``DATASETS.ROOT``: stage 1 writes ``G_0/`` and ``D_0/``, stage 2 takes that G
into its AF interpolator and that D (statistics too), evaluates at half
resolution and writes ``AFExtractor/`` and ``Disc/``, stage 3 takes the
stage-2 AF interpolator; ``--resume`` continues each of stages 1-2 from its
checkpoints.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from afigan_tpu.data.coco import CocoDataset as JaxDataset
from afigan_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from afigan_tpu.data.loader import collate_batch as jax_collate
from afigan_tpu_torch import stage1_train, stage2_train, stage3_train
from afigan_tpu_torch.data.coco import CocoDataset
from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
from afigan_tpu_torch.data.loader import build_train_loader, collate_batch
from afigan_tpu_torch.engine.checkpoint import latest_checkpoint
from afigan_tpu_torch.utils.converters import load_state_dict
from tests.fixtures import make_tiny_coco
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import GAN_TINY

STEP1 = "configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
STEP2 = "configs/step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"
STEP3 = "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """The tiny COCO as ``DATASETS.ROOT`` lays out coco_2017_{train,val}."""
    root = tmp_path_factory.mktemp("dualcoco")
    json_path, img_dir = make_tiny_coco(str(root / "raw"), num_images=4, hw=(96, 128))
    os.makedirs(root / "coco" / "annotations")
    for split in ("train2017", "val2017"):
        shutil.copy(json_path, root / "coco" / "annotations" / f"instances_{split}.json")
        shutil.copytree(img_dir, root / "coco" / split)
    return root, json_path, img_dir


def _cfgs(yaml=STEP2):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(REPO, yaml))
        cfg.merge_from_list(list(GAN_TINY))
        out.append(cfg)
    return out


def test_dual_scale_mapper_and_collate_equal_jax(coco_root):
    _, json_path, img_dir = coco_root
    jcfg, cfg = _cfgs()
    jds, ds = JaxDataset(json_path, img_dir), CocoDataset(json_path, img_dir)
    jm = JaxMapper(jcfg, is_train=True, dual_scale=True, seed=11)
    pm = DatasetMapper(cfg, is_train=True, seed=11, dual_scale=True)
    flips, jsamples, psamples = set(), [], []
    for _ in range(3):  # several epochs of draws
        for jr, pr in zip(jds.records, ds.records):
            a, b = jm(jr), pm(pr)
            for k in ("image", "image_x0.5"):
                assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
            for scale in ("gt", "gt_x0.5"):
                for k in ("boxes", "classes", "valid", "masks"):
                    np.testing.assert_array_equal(b[scale][k], a[scale][k],
                                                  err_msg=f"{scale} {k}")
            # one instance selection, one set of canvases, both scales
            assert b["gt_x0.5"]["masks"] is b["gt"]["masks"]
            np.testing.assert_array_equal(b["gt_x0.5"]["classes"], b["gt"]["classes"])
            h, w = b["image"].shape[:2]
            assert b["image_x0.5"].shape[:2] == (h // 2, w // 2)
            flips.add(b["transform"].hflip)
            jsamples.append(a)
            psamples.append(b)
    assert flips == {True, False}
    assert any(s["gt_x0.5"]["valid"].any() for s in psamples)
    for i in range(0, len(psamples), 2):
        want = jax_collate(jsamples[i:i + 2], jcfg.TPU.IMAGE_BUCKETS, 64, dual_scale=True)
        got = collate_batch(psamples[i:i + 2], cfg.TPU.IMAGE_BUCKETS, 64, dual_scale=True)
        assert set(got) == set(want) and "gt" not in got
        assert got["image_x0.5"].shape[1:3] == (64, 64)
        for k in ("image", "image_sizes", "image_x0.5", "image_sizes_x0.5"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in want["gt_x0.5"]:
            np.testing.assert_array_equal(got["gt_x0.5"][k], want["gt_x0.5"][k], err_msg=k)


def test_dual_scale_loader_batches(coco_root):
    _, json_path, img_dir = coco_root
    cfg = _cfgs()[1]
    loader = build_train_loader(cfg, CocoDataset(json_path, img_dir), seed=2, dual_scale=True)
    single = build_train_loader(cfg, CocoDataset(json_path, img_dir), seed=2)
    for _ in range(2):
        b, s = next(loader), next(single)
        assert b["image"].shape == (2, 128, 128, 3) and b["image_x0.5"].shape == (2, 64, 64, 3)
        # the same draws: the full-resolution stream is the single-scale loader's
        np.testing.assert_array_equal(b["image"], s["image"])
        np.testing.assert_array_equal(b["image_sizes_x0.5"], s["image_sizes"] // 2)
        assert "gt" in s and "gt" not in b and b["gt_x0.5"]["masks"].shape == (2, 8, 28, 28)


def _args(mod, yaml, root, out, *extra):
    return mod.parse_args(["--config-file", os.path.join(REPO, yaml), "--device", "cpu", *GAN_TINY,
                           "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(out), *extra])


def _lines(out):
    return [json.loads(line) for line in open(out / "metrics.json")]


def test_stage1_to_stage2_to_stage3_chain(coco_root, tmp_path):
    root = coco_root[0]
    # stage 1
    s1 = tmp_path / "s1"
    t1 = stage1_train.main(_args(stage1_train, STEP1, root, s1, "SOLVER.MAX_ITER", "2"))
    lines = _lines(s1)
    assert lines[-1]["iteration"] == 1
    assert all(np.isfinite(r["g_loss"]) and np.isfinite(r["d_loss"]) for r in lines)
    assert {"adv_loss_p6", "content_loss_p2", "d_loss_p4", "lr"} <= set(lines[-1])
    g_ckpt, d_ckpt = s1 / "G_0" / "model_0000002.pth", s1 / "D_0" / "model_0000002.pth"
    assert latest_checkpoint(str(s1 / "G_0")) == str(g_ckpt) and d_ckpt.is_file()
    g_saved = {k: v.clone() for k, v in t1.state.generator.state_dict().items()}
    d_saved = {k: v.clone() for k, v in t1.state.discriminator.state_dict().items()}
    assert any("running_var" in k for k in d_saved)

    # stage 2, from the stage-1 G and D, with the half-resolution evaluation
    s2 = tmp_path / "s2"
    t2 = stage2_train.main(_args(
        stage2_train, STEP2, root, s2, "SOLVER.MAX_ITER", "0", "MODEL.AFI_GEN_WEIGHTS",
        str(g_ckpt), "MODEL.AFI_DIS_WEIGHTS", str(d_ckpt)))
    for k, v in g_saved.items():
        assert torch.equal(t2.model.state_dict()["backbone.srf_module." + k], v), k
    assert all(torch.equal(t2.state.discriminator.state_dict()[k], v) for k, v in d_saved.items())
    assert not t2.state.d_optimizer.state_dict()["state"]  # D's optimizer starts afresh
    t2 = stage2_train.main(_args(
        stage2_train, STEP2, root, s2, "SOLVER.MAX_ITER", "2", "MODEL.AFI_GEN_WEIGHTS",
        str(g_ckpt), "MODEL.AFI_DIS_WEIGHTS", str(d_ckpt), "TEST.EVAL_PERIOD", "2",
        "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128"))
    last = _lines(s2)[-1]
    assert np.isfinite(last["total_loss"]) and {"loss_mask", "d_loss", "adv_loss_p2"} <= set(last)
    assert "bbox/AP" in last and "segm/AP" in last
    assert t2.model.training and t2.model.return_features
    det_ckpt = s2 / "AFExtractor" / "model_0000002.pth"
    assert det_ckpt.is_file() and (s2 / "Disc" / "model_0000002.pth").is_file()

    # --resume continues stage 2 (detector and D) from iteration 2 to 3
    t2r = stage2_train.main(stage2_train.parse_args(
        ["--resume", "--config-file", os.path.join(REPO, STEP2), "--device", "cpu", *GAN_TINY,
         "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(s2), "SOLVER.MAX_ITER", "3"]))
    assert (s2 / "AFExtractor" / "model_0000003.pth").is_file()
    assert t2r.state.scheduler.last_epoch == 3 and t2r.state.d_scheduler.last_epoch == 3
    assert _lines(s2)[-1]["iteration"] == 2

    # stage 3 takes the stage-2 AF interpolator, and only it
    s3 = tmp_path / "s3"
    t3 = stage3_train.main(_args(stage3_train, STEP3, root, s3, "SOLVER.MAX_ITER", "0",
                                 "MODEL.AF_EXTRACTOR_WEIGHTS", str(det_ckpt)))
    saved = load_state_dict(str(det_ckpt))
    afi = [k for k in saved if k.startswith("backbone.srf_module.")]
    assert afi
    for k in afi:
        np.testing.assert_array_equal(t3.model.state_dict()[k].numpy(), saved[k], err_msg=k)


def test_stage1_resume(coco_root, tmp_path):
    root, out = coco_root[0], tmp_path / "s1"
    stage1_train.main(_args(stage1_train, STEP1, root, out, "SOLVER.MAX_ITER", "2"))
    t = stage1_train.main(stage1_train.parse_args(
        ["--resume", "--config-file", os.path.join(REPO, STEP1), "--device", "cpu", *GAN_TINY,
         "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(out), "SOLVER.MAX_ITER", "3"]))
    assert (out / "G_0" / "model_0000003.pth").is_file()
    assert (out / "D_0" / "model_0000003.pth").is_file()
    assert t.state.g_scheduler.last_epoch == 3 and t.state.d_scheduler.last_epoch == 3
    assert _lines(out)[-1]["iteration"] == 2
