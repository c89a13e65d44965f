"""Host training loop and hooks (counterpart of
``afigan_tpu/engine/train_loop.py``): the d2 TrainerBase shape, a NaN guard
that raises ``FloatingPointError`` on a non-finite total loss (the
reference's only failure detector; recovery is a restart with resume)."""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

from .events import CommonMetricPrinter, EventStorage, JSONWriter


class Hook:
    def before_train(self, loop): ...
    def after_step(self, loop): ...
    def after_train(self, loop): ...


class IterationTimer(Hook):
    def before_train(self, loop):
        self._start = time.perf_counter()

    def after_step(self, loop):
        now = time.perf_counter()
        loop.storage.put_scalar("iter_time", now - self._start)
        self._start = now


class LRLogger(Hook):
    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def after_step(self, loop):
        loop.storage.put_scalar("lr", self.schedule(loop.storage.iter))


class PeriodicCheckpointer(Hook):
    def __init__(self, save_fn: Callable[[int], None], period: int):
        self.save_fn = save_fn
        self.period = period

    def after_step(self, loop):
        it = loop.storage.iter + 1
        if self.period > 0 and (it % self.period == 0 or it == loop.max_iter):
            self.save_fn(it)


class EvalHook(Hook):
    def __init__(self, eval_fn: Callable[..., Dict], period: int):
        self.eval_fn = eval_fn
        self.period = period

    def after_step(self, loop):
        it = loop.storage.iter + 1
        if self.period > 0 and (it % self.period == 0 or it == loop.max_iter):
            for task, metrics in (self.eval_fn(final=it == loop.max_iter) or {}).items():
                for k, v in metrics.items():
                    loop.storage.put_scalar(f"{task}/{k}", v)


class PeriodicWriter(Hook):
    def __init__(self, writers, period: int = 20):
        self.writers = writers
        self.period = period

    def after_step(self, loop):
        if (loop.storage.iter + 1) % self.period == 0 or loop.storage.iter == loop.max_iter - 1:
            for w in self.writers:
                w.write(loop.storage)

    def after_train(self, loop):
        for w in self.writers:
            if hasattr(w, "close"):
                w.close()


def default_writers(output_dir: str, max_iter: int):
    return [CommonMetricPrinter(max_iter), JSONWriter(f"{output_dir}/metrics.json")]


class TrainLoop:
    """Drives ``run_step`` (→ a dict of float metrics) to ``max_iter``."""

    def __init__(self, max_iter: int, hooks: Optional[List[Hook]] = None,
                 start_iter: int = 0):
        self.max_iter = max_iter
        self.hooks = hooks or []
        self.storage = EventStorage(start_iter)

    def run(self, run_step: Callable[[], Dict[str, float]]) -> None:
        for h in self.hooks:
            h.before_train(self)
        try:
            while self.storage.iter < self.max_iter:
                metrics = run_step()
                total = metrics.get("total_loss")
                if total is not None and not math.isfinite(total):
                    raise FloatingPointError(
                        f"Loss became infinite or NaN at iteration={self.storage.iter}!\n"
                        f"metrics = {metrics}")
                for k, v in metrics.items():
                    self.storage.put_scalar(k, v)
                for h in self.hooks:
                    h.after_step(self)
                self.storage.step()
        finally:
            for h in self.hooks:
                h.after_train(self)
