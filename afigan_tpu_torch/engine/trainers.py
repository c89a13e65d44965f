"""Stage-3 trainer of the port (counterpart of
``afigan_tpu/engine/trainers.py::TargetDetectorTrainer``): the plain detector
fine-tune with the pre-trained AF interpolator, on one device.

``MODEL.WEIGHTS`` initialises the detector (an ImageNet backbone or a whole
detector: the keys the file shares with the model, shapes checked);
``MODEL.AF_EXTRACTOR_WEIGHTS`` keeps only the AF interpolator's keys of a
stage-2 checkpoint (the reference's ``remain_only_AFI_names``). ``train``
runs ``SOLVER.MAX_ITER`` steps of ``engine/stage3.py::train_step`` over
``data/loader.py::build_train_loader`` with the timer, learning-rate,
checkpoint (``SOLVER.CHECKPOINT_PERIOD``, ``model_%07d.pth``), evaluation
(``TEST.EVAL_PERIOD``) and writer hooks; ``resume=True`` restarts from the
output directory's last checkpoint. The default device is the GPU, and
without one the trainer raises: only ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..data import build_train_loader, coco
from ..utils.converters import load_state_dict
from .checkpoint import remain_only_afi_names, resume, save_checkpoint
from .events import TRAIN_LOGGER, setup_logger
from .stage3 import batch_to_device, init_stage3_state, train_step
from .train_loop import (EvalHook, IterationTimer, LRLogger, PeriodicCheckpointer,
                         PeriodicWriter, TrainLoop, default_writers)

logger = logging.getLogger(TRAIN_LOGGER)


def load_matching(model: torch.nn.Module, state, what: str) -> None:
    """Load the entries of ``state`` (name → array) that the model has, with
    equal shapes; log what either side lacks; raise if nothing matches."""
    own = model.state_dict()
    shared = {k: v for k, v in state.items() if k in own}
    for k, v in shared.items():
        if tuple(np.shape(v)) != tuple(own[k].shape):
            raise ValueError(f"{what}: {k} has shape {np.shape(v)}, the model "
                             f"{tuple(own[k].shape)}")
    if not shared:
        raise KeyError(f"{what}: no key in common with the model")
    missing = sorted(own.keys() - shared.keys())
    if missing:
        logger.info("%s: %d of the model's keys not in the file, left as they are: %s",
                    what, len(missing), missing[:8])
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in shared.items()},
                          strict=False)


class TargetDetectorTrainer:
    """Stage 3 (ref stage3_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('TargetDetectorTrainer: no CUDA device found; pass '
                               'device="cpu" to train on the CPU')
        self.cfg = cfg
        self.output_dir = cfg.OUTPUT_DIR
        setup_logger(TRAIN_LOGGER, self.output_dir)
        coco.register_default_datasets(cfg.DATASETS.ROOT)
        seed = max(cfg.SEED, 0)
        self.state = init_stage3_state(cfg, self.device, torch.Generator().manual_seed(seed))
        # the source of the RPN's and the ROI heads' subsample keys
        self.sampling = torch.Generator(device=self.device).manual_seed(seed + 1)
        if cfg.MODEL.WEIGHTS:
            load_matching(self.model, load_state_dict(cfg.MODEL.WEIGHTS), cfg.MODEL.WEIGHTS)
        if cfg.MODEL.AF_EXTRACTOR_WEIGHTS:
            self.load_af_extractor_weight(cfg.MODEL.AF_EXTRACTOR_WEIGHTS)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def load_af_extractor_weight(self, path: str) -> None:
        """Only the AF interpolator's keys of a stage-2 detector checkpoint,
        all of them: the rest of the model keeps its weights."""
        afi = remain_only_afi_names(load_state_dict(path))
        own = {k for k in self.model.state_dict() if k.startswith("backbone.srf_module.")}
        if set(afi) != own:
            raise KeyError(f"{path}: the AF interpolator's keys differ from the model's: "
                           f"{sorted(set(afi) ^ own)[:8]}")
        load_matching(self.model, afi, path)

    def save(self, iteration: int) -> str:
        return save_checkpoint(self.output_dir, iteration, self.model, self.state.optimizer)

    def resume(self) -> int:
        """Model, optimizer and the schedule's position from the last
        checkpoint of the output directory; its iteration (0 if none)."""
        start = resume(self.output_dir, self.model, self.state.optimizer)
        sched = self.state.scheduler
        sched.last_epoch = start
        for group, base in zip(self.state.optimizer.param_groups, sched.base_lrs):
            group["lr"] = base * sched.lr_lambdas[0](start)
        return start

    def evaluate(self, final: bool = True):
        from ..data.coco import get_dataset
        from .inference import run_inference
        from .testing import verify_results

        self.model.eval()
        try:
            results = run_inference(self.cfg, self.model, get_dataset(self.cfg.DATASETS.TEST[0]))
        finally:
            self.model.train()
        verify_results(self.cfg, results, raise_on_failure=final)
        return results

    def train(self, resume: bool = False) -> None:
        cfg = self.cfg
        start = self.resume() if resume else 0
        loader = build_train_loader(cfg, coco.get_dataset(cfg.DATASETS.TRAIN[0]),
                                    seed=max(cfg.SEED, 0))
        hooks = [IterationTimer(), LRLogger(self.state.schedule)]
        if cfg.TEST.EVAL_PERIOD > 0 and cfg.DATASETS.TEST:
            hooks.append(EvalHook(self.evaluate, cfg.TEST.EVAL_PERIOD))
        hooks += [PeriodicCheckpointer(self.save, cfg.SOLVER.CHECKPOINT_PERIOD),
                  PeriodicWriter(default_writers(self.output_dir, cfg.SOLVER.MAX_ITER))]
        loop = TrainLoop(cfg.SOLVER.MAX_ITER, hooks, start)

        def run_step():
            t0 = time.perf_counter()
            batch = next(loader)
            data_time = time.perf_counter() - t0
            inputs = batch_to_device(batch, self.device)
            metrics = train_step(cfg, self.state, inputs, self.sampling)
            metrics["data_time"] = data_time
            return metrics

        logger.info("stage 3: iterations %d..%d on %s", start, cfg.SOLVER.MAX_ITER, self.device)
        loop.run(run_step)
