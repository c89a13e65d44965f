"""Metrics and logging of the training loop (counterpart of
``afigan_tpu/engine/events.py``): ``EventStorage`` with windowed medians, a
terminal printer and ``metrics.json`` lines. One process: no cross-host
reduction. TensorBoard is not written."""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

# the training loop's logger: it writes to the terminal and log.txt and does
# not propagate, so it is a child of the package's logger, whose other
# children (the eval CLI, inference) keep propagating
TRAIN_LOGGER = "afigan_tpu_torch.train"
logger = logging.getLogger(TRAIN_LOGGER)


class EventStorage:
    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._history = defaultdict(lambda: deque(maxlen=window))
        self._latest: Dict[str, float] = {}

    def put_scalar(self, name: str, value) -> None:
        v = float(value)
        self._history[name].append(v)
        self._latest[name] = v

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def median(self, name: str) -> float:
        h = sorted(self._history[name])
        return h[len(h) // 2] if h else float("nan")

    def step(self) -> None:
        self.iter += 1


class CommonMetricPrinter:
    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last: Optional[tuple] = None

    def write(self, storage: EventStorage) -> None:
        now, it = time.perf_counter(), storage.iter
        speed = ""
        if self._last is not None and it > self._last[1]:
            s_per_it = (now - self._last[0]) / (it - self._last[1])
            speed = (f" time: {s_per_it:.4f}s/it "
                     f"eta: {s_per_it * (self.max_iter - it) / 3600:.2f}h")
        self._last = (now, it)
        losses = "  ".join(f"{k}: {storage.median(k):.4g}"
                           for k in sorted(storage.latest()) if "loss" in k)
        lr = storage.latest().get("lr")
        lr_s = f" lr: {lr:.2e}" if lr is not None else ""
        logger.info(f"iter: {it}/{self.max_iter}  {losses}{lr_s}{speed}")


class JSONWriter:
    """One JSON line of the latest scalars per write."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        self._f.write(json.dumps({"iteration": storage.iter, **storage.latest()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def setup_logger(name: str = TRAIN_LOGGER, output_dir: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    """A named logger to the terminal and, with ``output_dir``, to log.txt."""
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    fmt = logging.Formatter("[%(asctime)s %(name)s]: %(message)s", "%m/%d %H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in lg.handlers):
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        lg.addHandler(h)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "log.txt"))
        if not any(getattr(h, "baseFilename", None) == path for h in lg.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            lg.addHandler(fh)
    return lg
