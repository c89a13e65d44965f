"""The port's training data path and stage-3 CLI, on the CPU.

Data against the JAX package with the same seed, on tests/fixtures.py's tiny
COCO: the training transform's draws, the mapped images, padded GT boxes,
classes, validity and rasterised mask canvases (equal), the collated batch,
``batch_images`` and the sampler's order. The CLI ``python -m
afigan_tpu_torch.stage3_train`` (its ``main``) with ``--device cpu`` trains a
narrow Mask R-CNN R-50-FPN(AFI) for two iterations on that COCO laid out
under ``DATASETS.ROOT``: finite ``total_loss`` lines in ``metrics.json`` (with
the periodic COCO evaluation), a ``model_0000002.pth`` that resume reads back
(and a third iteration from it), the default device refusing to run without
a GPU, and ``MODEL.AF_EXTRACTOR_WEIGHTS`` loading only the AF interpolator's
keys.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from afigan_tpu.data.coco import CocoDataset as JaxDataset
from afigan_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
from afigan_tpu.data.loader import TrainingSampler as JaxSampler
from afigan_tpu.data.loader import collate_batch as jax_collate
from afigan_tpu_torch import stage3_train
from afigan_tpu_torch.data.coco import CocoDataset
from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
from afigan_tpu_torch.data.loader import TrainingSampler, collate_batch
from afigan_tpu_torch.engine.checkpoint import latest_checkpoint, load_checkpoint
from tests.fixtures import make_tiny_coco
from tests.torch_port_common import REPO

TINY = [
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "16",
    "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "4",
    "MODEL.ROI_BOX_HEAD.FC_DIM", "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "16",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "32", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
    "INPUT.MIN_SIZE_TRAIN", "(64, 72)", "INPUT.MAX_SIZE_TRAIN", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)", "TPU.MAX_GT_BOXES", "8", "TPU.MASK_CANVAS", "28",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001", "SOLVER.CHECKPOINT_PERIOD", "2",
    "SEED", "3",
]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """The tiny COCO as ``DATASETS.ROOT`` lays out coco_2017_train."""
    root = tmp_path_factory.mktemp("traincoco")
    json_path, img_dir = make_tiny_coco(str(root / "raw"), num_images=4, hw=(96, 128))
    os.makedirs(root / "coco" / "annotations")
    for split in ("train2017", "val2017"):
        shutil.copy(json_path, root / "coco" / "annotations" / f"instances_{split}.json")
        shutil.copytree(img_dir, root / "coco" / split)
    return root, json_path, img_dir


def _cfgs():
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(REPO, "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"))
        cfg.merge_from_list(list(TINY))
        out.append(cfg)
    return out


def test_mapper_and_collate_equal_jax(coco_root):
    _, json_path, img_dir = coco_root
    jcfg, cfg = _cfgs()
    jds, ds = JaxDataset(json_path, img_dir), CocoDataset(json_path, img_dir)
    jm, pm = JaxMapper(jcfg, is_train=True, seed=5), DatasetMapper(cfg, is_train=True, seed=5)
    flips = set()
    jsamples, psamples = [], []
    for _ in range(3):  # several epochs of draws
        for jr, pr in zip(jds.records, ds.records):
            a, b = jm(jr), pm(pr)
            assert np.array_equal(a["image"], b["image"])
            for k in ("boxes", "classes", "valid", "masks"):
                np.testing.assert_array_equal(b["gt"][k], a["gt"][k], err_msg=k)
            flips.add(b["transform"].hflip)
            assert b["transform"].new_h in (64, 72) or b["transform"].new_w in (64, 72)
            jsamples.append(a)
            psamples.append(b)
    assert flips == {True, False}
    assert any(s["gt"]["masks"].sum() > 0 for s in psamples)
    for i in range(0, len(psamples), 2):
        want = jax_collate(jsamples[i:i + 2], jcfg.TPU.IMAGE_BUCKETS, 64)
        got = collate_batch(psamples[i:i + 2], cfg.TPU.IMAGE_BUCKETS, 64)
        for k in ("image", "image_sizes"):
            np.testing.assert_array_equal(got[k], want[k])
        for k in want["gt"]:
            np.testing.assert_array_equal(got["gt"][k], want["gt"][k])


def test_sampler_order_equals_jax():
    jit, it = iter(JaxSampler(7, seed=4)), iter(TrainingSampler(7, seed=4))
    assert [next(it) for _ in range(30)] == [next(jit) for _ in range(30)]


def _args_list(root, out, *extra):
    return ["--config-file", os.path.join(REPO, "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"),
            "--device", "cpu", *TINY, "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(out), *extra]


def _args(root, out, *extra):
    return stage3_train.parse_args(_args_list(root, out, *extra))


def test_cli_trains_checkpoints_and_resumes(coco_root, tmp_path):
    root = coco_root[0]
    out = tmp_path / "out"
    # with the periodic evaluation of TEST.EVAL_PERIOD on coco_2017_val
    trainer = stage3_train.main(_args(root, out, "SOLVER.MAX_ITER", "2", "TEST.EVAL_PERIOD", "2",
                                      "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "128"))
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    assert lines and all(np.isfinite(r["total_loss"]) for r in lines)
    assert lines[-1]["iteration"] == 1 and "loss_mask" in lines[-1] and "lr" in lines[-1]
    assert "bbox/AP" in lines[-1] and "segm/AP" in lines[-1]
    assert trainer.model.training
    ckpt = out / "model_0000002.pth"
    assert ckpt.is_file() and latest_checkpoint(str(out)) == str(ckpt)
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    # the checkpoint reads back into a fresh trainer: model, optimizer, iteration
    fresh = stage3_train.main(_args(root, tmp_path / "other", "SOLVER.MAX_ITER", "0"))
    assert load_checkpoint(str(ckpt), fresh.model, fresh.state.optimizer) == 2
    assert all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())
    assert fresh.state.optimizer.state_dict()["state"]
    # --resume continues from iteration 2 to 3
    t3 = stage3_train.main(stage3_train.parse_args(
        ["--resume", *_args_list(root, out, "SOLVER.MAX_ITER", "3")]))
    assert (out / "model_0000003.pth").is_file()
    last = [json.loads(line) for line in open(out / "metrics.json")][-1]
    assert last["iteration"] == 2 and np.isfinite(last["total_loss"])
    assert t3.state.scheduler.last_epoch == 3


def test_default_device_refuses_without_a_gpu(coco_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = stage3_train.parse_args(_args_list(coco_root[0], tmp_path)[:2] + TINY)
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stage3_train.main(args)


def test_af_extractor_weights_load_only_the_generator(coco_root, tmp_path):
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer

    root = coco_root[0]
    _, cfg = _cfgs()
    cfg.merge_from_list(["DATASETS.ROOT", str(root), "OUTPUT_DIR", str(tmp_path / "a")])
    base = TargetDetectorTrainer(cfg, device="cpu")
    donor = {k: v + 1.0 if v.is_floating_point() else v
             for k, v in base.model.state_dict().items()}
    path = tmp_path / "stage2.pth"
    torch.save({"model": donor}, path)
    cfg.MODEL.AF_EXTRACTOR_WEIGHTS = str(path)
    loaded = TargetDetectorTrainer(cfg, device="cpu")
    before, after = base.model.state_dict(), loaded.model.state_dict()
    afi = [k for k in before if k.startswith("backbone.srf_module.")]
    assert afi
    for k in before:
        assert torch.equal(after[k], donor[k] if k in afi else before[k]), k


def test_batch_images_equals_jax():
    from afigan_tpu.ops.image_list import batch_images as jax_batch_images
    from afigan_tpu_torch.ops.image_list import batch_images, pad_to_canvas

    rng = np.random.RandomState(2)
    images = [rng.randint(0, 255, size=s, dtype=np.uint8) for s in [(60, 90, 3), (70, 40, 3)]]
    buckets = ((64, 64), (128, 128), (64, 128))
    for div in (32, 64):
        got, want = batch_images(images, buckets, div), jax_batch_images(images, buckets, div)
        assert got[0].shape == want[0].shape
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(ValueError):
        pad_to_canvas(images[0], (32, 32))
