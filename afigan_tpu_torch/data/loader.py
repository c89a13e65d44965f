"""Data loading for the port (counterpart of ``afigan_tpu/data/loader.py``
and the eval part of ``dataset_mapper.py``).

The eval mapper (read, resize shortest edge), the collate step (pad to a
``TPU.IMAGE_BUCKETS`` canvas rounded up to the model's size divisibility,
stack; with the padded GT of training samples, and with ``dual_scale`` the x0.5
stream on the half canvas) in numpy, equal to the JAX package's; d2's infinite shuffled ``TrainingSampler``; and
``build_train_loader``, a plain iterator of collated training batches (no
worker threads or prefetch: the train step's device time dwarfs the host's
mapping at these batch sizes).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from . import coco, transforms


def required_size_divisibility(cfg, dual_scale: bool = False) -> int:
    """Canvas divisibility the model family needs: BiFPN carries a
    stride-128 p7 and exact-2x up/down paths between levels, so 128; the
    FPN families (p6 top) 64. ``dual_scale`` (stages 1-2): the detector sees
    the half canvas, so a BiFPN needs the full canvas 256-divisible; the FPN
    families keep 64."""
    if "bifpn" in cfg.MODEL.BACKBONE.NAME.lower():
        return 256 if dual_scale else 128
    return 64


def choose_bucket(h: int, w: int, buckets: Sequence[Sequence[int]],
                  size_divisibility: int = 64) -> Tuple[int, int]:
    """Smallest-area bucket (rounded up to the divisibility) that fits."""
    d = size_divisibility
    rounded = [(int(np.ceil(bh / d) * d), int(np.ceil(bw / d) * d))
               for bh, bw in buckets]
    fitting = [(ch, cw) for ch, cw in rounded if ch >= h and cw >= w]
    if fitting:
        return min(fitting, key=lambda s: s[0] * s[1])
    return int(np.ceil(h / d) * d), int(np.ceil(w / d) * d)


def map_record(cfg, record: Dict) -> Dict:
    """Eval DatasetMapper: read (BGR), resize shortest edge, keep uint8."""
    img = record.get("image")
    if img is None:
        img = coco.read_image(record["file_name"], cfg.INPUT.FORMAT)
    h, w = img.shape[:2]
    tf = transforms.test_transform(h, w, cfg.INPUT.MIN_SIZE_TEST,
                                   cfg.INPUT.MAX_SIZE_TEST)
    return {"image": tf.apply_image(img), "image_id": record.get("image_id", 0),
            "orig_height": h, "orig_width": w}


def _pad_stack(imgs: List[np.ndarray], ch: int, cw: int) -> np.ndarray:
    canvas = np.zeros((len(imgs), ch, cw, imgs[0].shape[2]), imgs[0].dtype)
    for k, im in enumerate(imgs):
        canvas[k, : im.shape[0], : im.shape[1]] = im
    return canvas


def _sizes(imgs: List[np.ndarray]) -> np.ndarray:
    return np.asarray([[i.shape[0], i.shape[1]] for i in imgs], np.int32)


def _stack_gt(gts: List[Dict]) -> Dict:
    return {k: np.stack([g[k] for g in gts]) for k in gts[0]}


def collate_batch(samples: List[Dict], buckets, size_divisibility: int = 64,
                  dual_scale: bool = False) -> Dict:
    """Pad and stack mapped samples. With ``dual_scale``: ``image_x0.5`` on
    the half canvas, ``image_sizes_x0.5``, ``gt_x0.5``, and no full-resolution
    ``gt`` (stages 1-2 read only the half-scale GT)."""
    imgs = [s["image"] for s in samples]
    ch, cw = choose_bucket(max(i.shape[0] for i in imgs),
                           max(i.shape[1] for i in imgs), buckets, size_divisibility)
    batch = {
        "image": _pad_stack(imgs, ch, cw),
        "image_sizes": _sizes(imgs),
        "image_id": np.asarray([s["image_id"] for s in samples]),
        "orig_sizes": np.asarray([[s["orig_height"], s["orig_width"]]
                                  for s in samples], np.int32),
    }
    if "gt" in samples[0] and not dual_scale:
        batch["gt"] = _stack_gt([s["gt"] for s in samples])
    if dual_scale:
        halves = [s["image_x0.5"] for s in samples]
        batch["image_x0.5"] = _pad_stack(halves, ch // 2, cw // 2)
        batch["image_sizes_x0.5"] = _sizes(halves)
        if "gt_x0.5" in samples[0]:
            batch["gt_x0.5"] = _stack_gt([s["gt_x0.5"] for s in samples])
    return batch


class TrainingSampler:
    """Infinite shuffled index stream, one ``np.random.RandomState(seed +
    epoch)`` permutation an epoch (d2 semantics, one process)."""

    def __init__(self, size: int, seed: int = 0, shuffle: bool = True):
        self.size = size
        self.seed = seed
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            idx = np.arange(self.size)
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            yield from idx.tolist()
            epoch += 1


def build_train_loader(cfg, dataset, seed: int = 0, dual_scale: bool = False
                       ) -> Iterator[Dict]:
    """Collated training batches of ``SOLVER.IMS_PER_BATCH`` images, forever;
    with ``dual_scale`` (stages 1-2) each with its x0.5 replay."""
    from .dataset_mapper import DatasetMapper

    if cfg.DATALOADER.SAMPLER_TRAIN != "TrainingSampler":
        raise NotImplementedError(f"DATALOADER.SAMPLER_TRAIN {cfg.DATALOADER.SAMPLER_TRAIN!r} "
                                  "is not ported yet")
    mapper = DatasetMapper(cfg, is_train=True, seed=seed, dual_scale=dual_scale)
    div = required_size_divisibility(cfg, dual_scale)
    sampler = iter(TrainingSampler(len(dataset.records), seed))
    while True:
        idxs = [next(sampler) for _ in range(cfg.SOLVER.IMS_PER_BATCH)]
        yield collate_batch([mapper(dataset.records[i]) for i in idxs],
                            cfg.TPU.IMAGE_BUCKETS, div, dual_scale)


def build_test_loader(cfg, dataset, batch_size: int = 1) -> Iterator[Dict]:
    """Sequential eval batches; the last batch is padded by repetition with
    ``image_id`` -1 on the padding (as the JAX loader)."""
    div = required_size_divisibility(cfg)
    buf = []
    for rec in dataset.records:
        buf.append(map_record(cfg, rec))
        if len(buf) == batch_size:
            yield collate_batch(buf, cfg.TPU.IMAGE_BUCKETS, div)
            buf = []
    if buf:
        n_real = len(buf)
        buf += [buf[-1]] * (batch_size - n_real)
        batch = collate_batch(buf, cfg.TPU.IMAGE_BUCKETS, div)
        batch["image_id"][n_real:] = -1
        yield batch
