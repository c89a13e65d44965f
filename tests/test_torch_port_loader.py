"""The port's threaded training loader against the JAX package's, on the CPU.

``afigan_tpu_torch/data/loader.py::PrefetchingLoader`` draws each record's
random numbers on its producer thread in sampler order and maps the records
on a pool of ``DATALOADER.NUM_WORKERS`` threads. Its batches must be bit-equal
to the same loader with one worker and to JAX's ``PrefetchingLoader`` with
one worker (whose draws, from one shared ``RandomState``, are then in sampler
order too) over more than two epochs, at one and at two scales, with and
without keypoints (a dataset whose keypoint names make the flip swap two of
them). A mapper's failure surfaces on ``next`` as JAX's ``RuntimeError``
with the cause chained; ``close`` leaves no producer thread alive, and a
trainer closes its loader when ``train`` ends, by return or by exception.
"""

import os
import threading

import numpy as np
import pytest
import torch

from afigan_tpu.data.coco import CocoDataset as JaxDataset
from afigan_tpu.data.loader import build_train_loader as jax_build_train_loader
from afigan_tpu_torch.data.coco import CocoDataset
from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
from afigan_tpu_torch.data.loader import PrefetchingLoader, build_train_loader
from tests.torch_port_common import REPO, keypoint_scene_coco

EPOCH_BATCHES = 2  # 4 images, 2 a batch
BATCHES = 2 * EPOCH_BATCHES + 1

OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.ROI_HEADS.NUM_CLASSES", "3",
    "MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "3",
    "INPUT.MIN_SIZE_TRAIN", "(64, 72, 80)", "INPUT.MAX_SIZE_TRAIN", "128",
    "TPU.IMAGE_BUCKETS", "((128, 128),)", "TPU.MAX_GT_BOXES", "8", "TPU.MASK_CANVAS", "16",
    "SOLVER.IMS_PER_BATCH", "2",
]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Four generated scenes with 3 keypoints an object, a flip swapping the
    last two, some of them invisible."""
    return keypoint_scene_coco(tmp_path_factory.mktemp("loader"))


def _cfgs(keypoints, workers):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(REPO, "configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"))
        cfg.merge_from_list(OVERRIDES + ["MODEL.KEYPOINT_ON", str(keypoints),
                                         "DATALOADER.NUM_WORKERS", str(workers)])
        out.append(cfg)
    return out


def _take(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _assert_equal(got, want, where):
    assert set(got) == set(want), where
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_equal(got[k], v, f"{where}/{k}")
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=f"{where}/{k}")


@pytest.mark.parametrize("dual_scale", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("keypoints", [False, True], ids=["boxes", "keypoints"])
def test_threaded_batches_equal_serial_and_jax(scenes, dual_scale, keypoints):
    json_path, img_dir = scenes
    jcfg, cfg4 = _cfgs(keypoints, 4)
    cfg1 = _cfgs(keypoints, 1)[1]
    jcfg.DATALOADER.NUM_WORKERS = 1
    want = _take(jax_build_train_loader(jcfg, JaxDataset(json_path, img_dir),
                                        dual_scale=dual_scale, seed=7), BATCHES)
    serial = _take(build_train_loader(cfg1, CocoDataset(json_path, img_dir), seed=7,
                                      dual_scale=dual_scale), BATCHES)
    threaded = _take(build_train_loader(cfg4, CocoDataset(json_path, img_dir), seed=7,
                                        dual_scale=dual_scale), BATCHES)
    gt_key = "gt_x0.5" if dual_scale else "gt"
    for i in range(BATCHES):
        _assert_equal(serial[i], want[i], f"serial batch {i}")
        _assert_equal(threaded[i], want[i], f"threaded batch {i}")
        assert ("keypoints" in want[i][gt_key]) == keypoints
    # the records were drawn flipped and not flipped
    draws = DatasetMapper(cfg1, seed=7)
    assert {draws.draw().hflip for _ in range(2 * BATCHES)} == {True, False}
    if keypoints:  # visible keypoints reached the batches, invisible ones are zeroed
        kp = np.concatenate([b[gt_key]["keypoints"] for b in want])
        assert (kp[..., 2] > 0).any() and (kp[..., 2] == 0).any()
        assert not ((kp[..., 2] == 0) & kp[..., :2].any(-1)).any()


class _Failing:
    """A mapper whose third record fails."""

    def __init__(self):
        self.n = 0

    def draw(self):
        return None

    def map(self, record, draw):
        self.n += 1
        if self.n == 3:
            raise ValueError("bad record")
        return record


def test_mapper_failure_surfaces_on_next():
    loader = PrefetchingLoader([{"i": i} for i in range(4)], iter(range(4)), _Failing(), 2,
                               list, num_workers=1)
    try:
        assert next(loader) == [{"i": 0}, {"i": 1}]
        with pytest.raises(RuntimeError, match="data-loader producer thread failed") as e:
            next(loader)
        assert isinstance(e.value.__cause__, ValueError)
        with pytest.raises(StopIteration):
            next(loader)
    finally:
        loader.close()
    assert not loader.thread.is_alive()


class _Echo:
    def draw(self):
        return 0

    def map(self, record, draw):
        return record


def _forever():
    while True:
        yield 0


def test_close_leaves_no_producer_alive():
    """The producer blocks on its full queue until ``close``."""
    loader = PrefetchingLoader([1], _forever(), _Echo(), 2, list, num_workers=4)
    assert next(loader) == [1, 1]
    loader.close()
    assert not loader.thread.is_alive()
    assert not any(t.name.startswith("loader-") for t in threading.enumerate())
    with pytest.raises(StopIteration):
        next(loader)


def test_nothing_runs_before_the_first_next():
    """A loader that is never read (a run of zero iterations over an empty
    dataset, whose sampler never yields) starts no thread and closes."""
    def empty_forever():
        while True:
            yield from ()

    loader = PrefetchingLoader([], empty_forever(), _Echo(), 2, list)
    assert loader.thread.ident is None
    loader.close()
    assert not loader.thread.is_alive()


def test_a_sampler_that_ends_ends_the_iteration():
    loader = PrefetchingLoader([1, 2, 3], iter([0, 1, 2]), _Echo(), 2, list)
    assert list(loader) == [[1, 2]]
    loader.close()


@pytest.mark.parametrize("ending", ["return", "raise"])
def test_trainer_closes_its_loader(monkeypatch, tmp_path, ending):
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.engine import trainers

    loaders = []

    def build(*a, **k):
        loaders.append(PrefetchingLoader([{"x": 1}], _forever(), _Echo(), 1, list))
        return loaders[-1]

    monkeypatch.setattr(trainers, "build_train_loader", build)
    monkeypatch.setattr(trainers.coco, "get_dataset", lambda name: None)
    cfg = get_cfg()
    cfg.SOLVER.MAX_ITER = 3
    cfg.DATASETS.TRAIN = ("none",)
    cfg.OUTPUT_DIR = str(tmp_path)
    class Bare(trainers._Trainer):
        def _parts(self):  # no checkpoint
            return ()

    trainer = Bare.__new__(Bare)
    trainer.cfg, trainer.output_dir, trainer.seed = cfg, str(tmp_path), 0
    trainer.device = torch.device("cpu")
    calls = []

    def step(batch):
        calls.append(batch)
        if ending == "raise" and len(calls) == 2:
            raise ValueError("step failed")
        return {"total_loss": 1.0}

    if ending == "raise":
        with pytest.raises(ValueError, match="step failed"):
            trainer._run("t", 0, lambda it: 0.0, step, dual_scale=False, evaluate=False)
    else:
        trainer._run("t", 0, lambda it: 0.0, step, dual_scale=False, evaluate=False)
    assert len(loaders) == 1 and not loaders[0].thread.is_alive()
    assert len(calls) == (2 if ending == "raise" else 3)
