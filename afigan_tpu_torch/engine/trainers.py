"""The three stage trainers of the port (counterpart of
``afigan_tpu/engine/trainers.py``), on one device.

Stage 1, ``AFIGANTrainer``: the generator G and the discriminator D against
the frozen guide (``engine/stage1.py``) on dual-scale batches.
``MODEL.GUIDE_WEIGHTS`` initialises the guide, ``MODEL.AFI_GEN_WEIGHTS`` G
and ``MODEL.AFI_DIS_WEIGHTS`` D (parameters and statistics); checkpoints go
to ``G_0/`` and ``D_0/`` under the output directory.

Stage 2, ``AFExtractorTrainer``: the detector returning its pyramid (an
R-CNN or FCOS), D and the guide (``engine/stage2.py``) on dual-scale batches. ``MODEL.WEIGHTS``
initialises the detector, ``MODEL.AFI_GEN_WEIGHTS`` (a stage-1 G) its AF
interpolator through ``transplant_generator``, ``MODEL.AFI_DIS_WEIGHTS`` D
without its optimizer state; checkpoints go to ``AFExtractor/`` and
``Disc/``; ``TEST.EVAL_PERIOD`` evaluates the detector at half resolution,
through its own inference (FCOS's for the FCOS YAML).

Stage 3, ``TargetDetectorTrainer``: the plain detector fine-tune with the
pre-trained AF interpolator. ``MODEL.WEIGHTS`` initialises the detector (an
ImageNet backbone or a whole detector: the keys the file shares with the
model, shapes checked); ``MODEL.AF_EXTRACTOR_WEIGHTS`` takes only the AF
interpolator's keys of a stage-2 checkpoint (the reference's
``remain_only_AFI_names``); checkpoints ``model_%07d.pth`` in the output
directory.

Each ``train`` runs ``SOLVER.MAX_ITER`` steps over
``data/loader.py::build_train_loader`` with the timer, learning-rate,
checkpoint (``SOLVER.CHECKPOINT_PERIOD``), evaluation (stages 2 and 3,
``TEST.EVAL_PERIOD``) and writer hooks; ``resume=True`` restarts each model,
its optimizer and its schedule from its directory's last checkpoint. The
default device is the GPU, and without one a trainer raises: only
``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..data import build_train_loader, coco
from ..models.build import check_device, trains_batch_norm
from ..utils.converters import load_state_dict
from . import stage1, stage2
from .checkpoint import (remain_only_afi_names, resume, save_checkpoint,
                         transplant_afi_between_detectors, transplant_generator)
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


def load_afi(model: torch.nn.Module, state) -> None:
    """The AF interpolator's entries of ``state`` (a transplant's result,
    whose keys and shapes it has checked against the model) into the model,
    every one of them; the rest of the model keeps its weights."""
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in remain_only_afi_names(state).items()}, strict=False)


def refuse_precise_bn(cfg) -> None:
    """The JAX trainers recompute the detector's batch-norm statistics every
    ``TEST.EVAL_PERIOD`` (PreciseBN) when ``TEST.PRECISE_BN.ENABLED`` is set
    and the model has batch norm that trains; the port has no PreciseBN yet,
    so it raises there, from the config before anything is built, rather
    than train on other statistics."""
    if (cfg.TEST.PRECISE_BN.ENABLED and cfg.TEST.EVAL_PERIOD > 0
            and trains_batch_norm(cfg)):
        raise NotImplementedError(
            "TEST.PRECISE_BN.ENABLED with batch norm that trains: PreciseBN is not ported "
            "yet (ROADMAP queue 1 #6)")


def _set_schedule(scheduler, optimizer, it: int) -> None:
    """The schedule's position at iteration ``it`` (a resume)."""
    scheduler.last_epoch = it
    for group, base in zip(optimizer.param_groups, scheduler.base_lrs):
        group["lr"] = base * scheduler.lr_lambdas[0](it)


class _Trainer:
    """What the stages share: device, logger, datasets, seed, checkpoints
    (``_parts``: each model's directory, optimizer and schedule), the loop."""

    def __init__(self, cfg, device):
        self.device = check_device(device, type(self).__name__)
        self.cfg = cfg
        self.output_dir = cfg.OUTPUT_DIR
        setup_logger(TRAIN_LOGGER, self.output_dir)
        coco.register_default_datasets(cfg.DATASETS.ROOT)
        self.seed = max(cfg.SEED, 0)

    def _load(self, module, path: str) -> None:
        load_matching(module, load_state_dict(path), path)

    def _eval_cfg(self):
        return self.cfg

    def evaluate(self, final: bool = True):
        """COCO evaluation of the detector (``TEST.EVAL_PERIOD``), in eval
        mode and returning detections only, at ``_eval_cfg``'s sizes."""
        from ..data.coco import get_dataset
        from .inference import run_inference
        from .testing import verify_results

        cfg, model = self._eval_cfg(), self.model
        features = model.return_features
        model.eval()
        model.return_features = False
        try:
            results = run_inference(cfg, model, get_dataset(cfg.DATASETS.TEST[0]))
        finally:
            model.return_features = features
            model.train()
        verify_results(self.cfg, results, raise_on_failure=final)
        return results

    def _parts(self):
        """((directory, model, optimizer, scheduler), ...), the first the
        model whose iteration a resume takes."""
        raise NotImplementedError

    def save(self, iteration: int) -> None:
        for directory, model, opt, _ in self._parts():
            save_checkpoint(directory, iteration, model, opt)

    def resume(self) -> int:
        """Every model, optimizer and schedule position from its directory's
        last checkpoint; the first model's iteration (0 if none)."""
        start = None
        for directory, model, opt, sched in self._parts():
            it = resume(directory, model, opt)
            start = it if start is None else start
            _set_schedule(sched, opt, start)
        return start

    def _run(self, name: str, start: int, schedule, step, dual_scale: bool,
             evaluate: bool) -> None:
        """``SOLVER.MAX_ITER`` iterations of ``step(batch) → metrics`` over
        the training loader, with the shared hooks (``evaluate``: the
        periodic evaluation too)."""
        cfg = self.cfg
        loader = build_train_loader(cfg, coco.get_dataset(cfg.DATASETS.TRAIN[0]),
                                    seed=self.seed, dual_scale=dual_scale)
        extra = []
        if evaluate and cfg.TEST.EVAL_PERIOD > 0 and cfg.DATASETS.TEST:
            extra.append(EvalHook(self.evaluate, cfg.TEST.EVAL_PERIOD))
        hooks = [IterationTimer(), LRLogger(schedule), *extra,
                 PeriodicCheckpointer(self.save, cfg.SOLVER.CHECKPOINT_PERIOD),
                 PeriodicWriter(default_writers(self.output_dir, cfg.SOLVER.MAX_ITER))]
        loop = TrainLoop(cfg.SOLVER.MAX_ITER, hooks, start)

        def run_step():
            t0 = time.perf_counter()
            batch = next(loader)
            data_time = time.perf_counter() - t0
            metrics = step(batch)
            metrics["data_time"] = data_time
            return metrics

        logger.info("%s: iterations %d..%d on %s", name, start, cfg.SOLVER.MAX_ITER,
                    self.device)
        loop.run(run_step)


class AFIGANTrainer(_Trainer):
    """Stage 1 (ref stage1_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.state = stage1.init_stage1_state(cfg, self.device,
                                              torch.Generator().manual_seed(self.seed))
        for path, module in ((cfg.MODEL.GUIDE_WEIGHTS, self.state.guide),
                             (cfg.MODEL.AFI_GEN_WEIGHTS, self.state.generator),
                             (cfg.MODEL.AFI_DIS_WEIGHTS, self.state.discriminator)):
            if path:
                self._load(module, path)

    def _parts(self):
        st = self.state
        return ((os.path.join(self.output_dir, "G_0"), st.generator, st.g_optimizer,
                 st.g_scheduler),
                (os.path.join(self.output_dir, "D_0"), st.discriminator, st.d_optimizer,
                 st.d_scheduler))

    def train(self, resume: bool = False) -> None:
        start = self.resume() if resume else 0

        def step(batch):
            return stage1.train_step(self.cfg, self.state,
                                     stage1.batch_to_device(batch, self.device))

        self._run("stage 1", start, self.state.schedule, step, dual_scale=True, evaluate=False)


class AFExtractorTrainer(_Trainer):
    """Stage 2 (ref stage2_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        refuse_precise_bn(cfg)
        super().__init__(cfg, device)
        self.state = stage2.init_stage2_state(cfg, self.device,
                                              torch.Generator().manual_seed(self.seed))
        # the source of the RPN's and the ROI heads' subsample keys
        self.sampling = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        if cfg.MODEL.GUIDE_WEIGHTS:
            self._load(self.state.guide, cfg.MODEL.GUIDE_WEIGHTS)
        if cfg.MODEL.WEIGHTS:
            self._load(self.model, cfg.MODEL.WEIGHTS)
        if cfg.MODEL.AFI_GEN_WEIGHTS:
            self.load_afigen_weight(cfg.MODEL.AFI_GEN_WEIGHTS)
        if cfg.MODEL.AFI_DIS_WEIGHTS:
            # D's parameters and statistics; its optimizer state is not
            # restored (ref stage2_trainer.py:112-119)
            self._load(self.state.discriminator, cfg.MODEL.AFI_DIS_WEIGHTS)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def load_afigen_weight(self, path: str) -> None:
        """A stage-1 G into the detector's AF interpolator, every key."""
        load_afi(self.model, transplant_generator(self.model.state_dict(),
                                                  load_state_dict(path)))

    def _parts(self):
        st = self.state
        return ((os.path.join(self.output_dir, "AFExtractor"), st.model, st.optimizer,
                 st.scheduler),
                (os.path.join(self.output_dir, "Disc"), st.discriminator, st.d_optimizer,
                 st.d_scheduler))

    def _eval_cfg(self):
        """The evaluation at half resolution, the scale the detector trains at
        (``INPUT.MIN/MAX_SIZE_TEST`` halved)."""
        cfg = self.cfg.clone()
        cfg.defrost()
        cfg.INPUT.MIN_SIZE_TEST = int(round(cfg.INPUT.MIN_SIZE_TEST * 0.5))
        cfg.INPUT.MAX_SIZE_TEST = int(round(cfg.INPUT.MAX_SIZE_TEST * 0.5))
        cfg.freeze()
        return cfg

    def train(self, resume: bool = False) -> None:
        start = self.resume() if resume else 0

        def step(batch):
            return stage2.train_step(self.cfg, self.state,
                                     stage2.batch_to_device(batch, self.device),
                                     self.sampling)

        self._run("stage 2", start, self.state.schedule, step, dual_scale=True, evaluate=True)


class TargetDetectorTrainer(_Trainer):
    """Stage 3 (ref stage3_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        refuse_precise_bn(cfg)
        super().__init__(cfg, device)
        seed = self.seed
        self.state = init_stage3_state(cfg, self.device, torch.Generator().manual_seed(seed))
        # the sources of the RPN's and the ROI heads' subsample keys and of a
        # Swin's DropPath masks (JAX's "sampling" and "dropout" streams);
        # neither is saved with a checkpoint
        self.sampling = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.drop_path = torch.Generator(device=self.device).manual_seed(seed + 2)
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
        load_afi(self.model, transplant_afi_between_detectors(self.model.state_dict(),
                                                              load_state_dict(path)))

    def _parts(self):
        st = self.state
        return ((self.output_dir, st.model, st.optimizer, st.scheduler),)

    def train(self, resume: bool = False) -> None:
        start = self.resume() if resume else 0

        def step(batch):
            return train_step(self.cfg, self.state, batch_to_device(batch, self.device),
                              self.sampling, self.drop_path)

        self._run("stage 3", start, self.state.schedule, step, dual_scale=False, evaluate=True)
