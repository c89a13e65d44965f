"""Data loading for the port (counterpart of ``afigan_tpu/data/loader.py``
and the eval part of ``dataset_mapper.py``).

The eval mapper (read, resize shortest edge), the collate step (pad to a
``TPU.IMAGE_BUCKETS`` canvas rounded up to the model's size divisibility,
stack; with the padded GT of training samples, and with ``dual_scale`` the x0.5
stream on the half canvas) in numpy, equal to the JAX package's; d2's infinite shuffled ``TrainingSampler``,
striped over ranks; and ``build_train_loader``, a ``PrefetchingLoader`` of
collated training batches of the rank's share of ``SOLVER.IMS_PER_BATCH``: a
producer thread draws each record's random numbers in sampler order, a pool
of ``DATALOADER.NUM_WORKERS`` threads maps the records (decode, resize, GT),
and a queue keeps ``PREFETCH`` (2) batches ready ahead of the train step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

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
    epoch)`` permutation an epoch, of which shard ``shard_id`` of
    ``num_shards`` takes every ``num_shards``-th index from its own (d2
    semantics; JAX's multi-process stripes)."""

    def __init__(self, size: int, seed: int = 0, shard_id: int = 0, num_shards: int = 1,
                 shuffle: bool = True):
        self.size = size
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.shuffle = shuffle

    def __iter__(self) -> Iterator[int]:
        epoch = 0
        while True:
            idx = np.arange(self.size)
            if self.shuffle:
                np.random.RandomState(self.seed + epoch).shuffle(idx)
            yield from idx[self.shard_id::self.num_shards].tolist()
            epoch += 1


class PrefetchingLoader:
    """Collated batches from a producer thread (JAX's ``PrefetchingLoader``):
    it takes ``batch_size`` indices from ``sampler``, draws each record's
    random numbers (``mapper.draw``) in that order, maps the records on a pool
    of ``max(1, num_workers)`` threads (``mapper.map``), collates them and
    puts the batch on a queue of ``PREFETCH`` batches. The draws stay in sampler
    order, so the batches are those of the serial mapper for any pool size.

    The producer starts at the first ``next`` (a loader that is never read,
    as in a run of zero iterations, reads no record). A mapper or collate
    failure is raised on the consumer's ``next`` as ``RuntimeError("data-loader
    producer thread failed")`` from the cause; a sampler that ends ends the
    iteration. ``close()`` stops the producer (joined) and the pool."""

    PREFETCH = 2  # batches queued ahead of the consumer, as in JAX
    _POLL_S = 0.1  # how often a producer blocked on a full queue looks at the stop flag

    def __init__(self, records: Sequence[Dict], sampler: Iterator[int], mapper,
                 batch_size: int, collate: Callable[[List[Dict]], Dict],
                 num_workers: int = 4):
        self.records = records
        self.sampler = iter(sampler)
        self.mapper = mapper
        self.batch_size = batch_size
        self.collate = collate
        # NUM_WORKERS 0 is d2's serial convention; the map already runs off the
        # training thread, so one pool thread is its equivalent
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers),
                                       thread_name_prefix="loader-map")
        self.q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._done = False
        self.thread = threading.Thread(target=self._producer, name="loader-producer",
                                       daemon=True)

    def _put(self, item) -> bool:
        """``item`` onto the queue unless the loader is closed meanwhile."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self) -> None:
        try:
            while not self._stop.is_set():
                idxs = [next(self.sampler) for _ in range(self.batch_size)]
                draws = [self.mapper.draw() for _ in idxs]
                mapped = list(self.pool.map(
                    lambda a: self.mapper.map(self.records[a[0]], a[1]), zip(idxs, draws)))
                if not self._put(self.collate(mapped)):
                    return
        except StopIteration:
            pass
        except BaseException as e:  # surfaced on the consumer, never a clean stop
            self._exc = e
        self._put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        if self._done:
            raise StopIteration
        if self.thread.ident is None:
            self.thread.start()
        batch = self.q.get()
        if batch is None:
            self._done = True
            if self._exc is not None:
                raise RuntimeError("data-loader producer thread failed") from self._exc
            raise StopIteration
        return batch

    def close(self) -> None:
        """Stop the producer and the pool; batches not taken are dropped."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get_nowait()
            except queue.Empty:
                pass
            self.thread.join(timeout=self._POLL_S)
        self.pool.shutdown(wait=True, cancel_futures=True)
        self._done = True


def build_train_loader(cfg, dataset, seed: int = 0, dual_scale: bool = False,
                       shard_id: int = 0, num_shards: int = 1) -> PrefetchingLoader:
    """Collated training batches of ``SOLVER.IMS_PER_BATCH // num_shards``
    images from shard ``shard_id``'s stripe of the records, forever, mapped on
    ``DATALOADER.NUM_WORKERS`` threads; with ``dual_scale`` (stages 1-2) each
    with its x0.5 replay; with ``MODEL.KEYPOINT_ON`` the keypoints, flipped
    through the dataset's ``keypoint_hflip_indices``. Raises at once, as JAX
    asserts, where ``num_shards`` does not divide the batch. The caller
    closes it."""
    from .dataset_mapper import DatasetMapper

    if cfg.SOLVER.IMS_PER_BATCH % num_shards != 0:
        raise AssertionError("SOLVER.IMS_PER_BATCH must be divisible by the number of hosts "
                             "(ref stage1_trainer.py:577-589)")
    if cfg.DATALOADER.SAMPLER_TRAIN != "TrainingSampler":
        raise NotImplementedError(f"DATALOADER.SAMPLER_TRAIN {cfg.DATALOADER.SAMPLER_TRAIN!r} "
                                  "is not ported yet")
    mapper = DatasetMapper(cfg, is_train=True, seed=seed, dual_scale=dual_scale,
                           keypoint_hflip_indices=getattr(dataset, "keypoint_hflip_indices",
                                                          None))
    div = required_size_divisibility(cfg, dual_scale)
    sampler = TrainingSampler(len(dataset.records), seed, shard_id, num_shards)
    return PrefetchingLoader(
        dataset.records, sampler, mapper, cfg.SOLVER.IMS_PER_BATCH // num_shards,
        lambda samples: collate_batch(samples, cfg.TPU.IMAGE_BUCKETS, div, dual_scale),
        cfg.DATALOADER.NUM_WORKERS)


def build_test_loader(cfg, dataset, batch_size: int = 1, records=None) -> Iterator[Dict]:
    """Sequential eval batches of ``records`` (default: all the dataset's;
    a distributed evaluation passes the rank's stripe); the last batch is
    padded by repetition with ``image_id`` -1 on the padding (as the JAX
    loader)."""
    div = required_size_divisibility(cfg)
    buf = []
    for rec in dataset.records if records is None else records:
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
