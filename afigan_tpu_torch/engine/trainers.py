"""The three stage trainers of the port (counterpart of
``afigan_tpu/engine/trainers.py``), each on its rank's device.

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
``data/loader.py::build_train_loader`` (closed when ``train`` ends, by return
or by exception; PreciseBN's loader too) with the timer, learning-rate,
checkpoint (``SOLVER.CHECKPOINT_PERIOD``), evaluation (stages 2 and 3,
``TEST.EVAL_PERIOD``) and writer hooks; with ``TEST.PRECISE_BN.ENABLED`` and a
period, stages 2 and 3 recompute the statistics of their batch norm that
trains (``engine/precise_bn.py``) at every evaluation period and at the last
iteration, before the evaluation; ``resume=True`` restarts each model,
its optimizer and its schedule from its directory's last checkpoint. The
default device is the GPU, and without one a trainer raises: only
``device="cpu"`` runs on the CPU.

Under a process group (``engine/launch.py``: one process a rank) every rank
builds the same seeded models and random streams; after every weight is
loaded, rank 0's parameters and buffers are broadcast to the others. Each
rank trains on its own stripe of the records (``IMS_PER_BATCH`` divided by
the world size a step), the steps take the means of the gradients and the
metrics over ranks, ``data_time`` is the largest over ranks, and only rank
0 writes checkpoints, ``metrics.json`` and ``log.txt``. A resume loads the
same files on every rank and asserts that they start from one iteration;
the evaluation runs on every rank over its stripe of the test records and
gathers the predictions (``run_inference``).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data import build_train_loader, coco
from ..models.build import check_device
from ..models.swin import drop_path_source
from ..parallel import (assert_uniform_across_processes, broadcast_module_, cross_process_max,
                        is_main, rank, world_size)
from ..utils.converters import load_state_dict
from . import stage1, stage2
from .checkpoint import (remain_only_afi_names, resume, save_checkpoint,
                         transplant_afi_between_detectors, transplant_generator)
from .events import TRAIN_LOGGER, setup_logger
from .precise_bn import batch_norms, precise_bn_hook, update_bn_stats
from .stage3 import batch_to_device, init_stage3_state, train_step
from .train_loop import (EvalHook, IterationTimer, LRLogger, PeriodicCheckpointer,
                         PeriodicWriter, TrainLoop, default_writers)

logger = logging.getLogger(TRAIN_LOGGER)


def load_matching(model: torch.nn.Module, state, what: str) -> Dict[str, List[str]]:
    """Load the entries of ``state`` (name → array) that the model has, with
    equal shapes; log what either side lacks; raise if a shared key's shape
    differs or nothing matches. Returns the keys loaded (``matched``), the
    file's keys the model lacks (``unmatched``) and the model's keys the file
    lacks (``missing``)."""
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
    return {"matched": list(shared), "unmatched": [k for k in state if k not in own],
            "missing": missing}


def load_afi(model: torch.nn.Module, state) -> None:
    """The AF interpolator's entries of ``state`` (a transplant's result,
    whose keys and shapes it has checked against the model) into the model,
    every one of them; the rest of the model keeps its weights."""
    model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                           for k, v in remain_only_afi_names(state).items()}, strict=False)


def _set_schedule(scheduler, optimizer, it: int) -> None:
    """The schedule's position at iteration ``it`` (a resume)."""
    scheduler.last_epoch = it
    for group, base in zip(optimizer.param_groups, scheduler.base_lrs):
        group["lr"] = base * scheduler.lr_lambdas[0](it)


class _Trainer:
    """What the stages share: device, logger, datasets, seed, checkpoints
    (``_parts``: each model's directory, optimizer and schedule), the loop."""

    def __init__(self, cfg, device):
        device = check_device(device, type(self).__name__)
        if device.type == "cuda" and device.index is None:
            # the rank's card, which engine/launch.py made current
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.cfg = cfg
        self.output_dir = cfg.OUTPUT_DIR
        setup_logger(TRAIN_LOGGER, self.output_dir if is_main() else None)
        coco.register_default_datasets(cfg.DATASETS.ROOT)
        self.seed = max(cfg.SEED, 0)

    def _load(self, module, path: str, kind: str = "detector") -> None:
        load_matching(module, load_state_dict(path, kind), path)

    @staticmethod
    def _replicate(*modules) -> None:
        """Rank 0's weights on every rank, after every load."""
        for m in modules:
            broadcast_module_(m)

    def _eval_cfg(self):
        return self.cfg

    def evaluate(self, final: bool = True):
        """COCO evaluation of the detector (``TEST.EVAL_PERIOD``), in eval
        mode and returning detections only, at ``_eval_cfg``'s sizes; under a
        process group every rank infers its stripe and gets the results of
        all."""
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

    def _precise_bn_inputs(self, batch):
        """PreciseBN's images, sizes and GT from a training batch."""
        raise NotImplementedError

    def run_precise_bn(self, num_iter: int, dual_scale: bool) -> int:
        """The detector's batch-norm statistics as the mean of ``num_iter``
        training-mode forwards' (JAX's ``run_precise_bn``): batches of the
        rank's stripe from a loader seeded ``SEED + 999`` (dual-scale as the
        stage trains), the subsample keys from ``SEED + 777`` and a Swin's
        DropPath masks from ``SEED + 778`` (JAX's sampling key and its dropout
        fold). Returns the forwards run."""
        cfg = self.cfg
        loader = build_train_loader(cfg, coco.get_dataset(cfg.DATASETS.TRAIN[0]),
                                    seed=self.seed + 999, dual_scale=dual_scale,
                                    shard_id=rank(), num_shards=world_size())
        sampling = torch.Generator(device=self.device).manual_seed(self.seed + 777)
        drop_path = torch.Generator(device=self.device).manual_seed(self.seed + 778)

        def forward(batch):
            images, sizes, gt = self._precise_bn_inputs(batch)
            with drop_path_source(self.model, drop_path):
                self.model(images, sizes, gt, draws=sampling)

        try:
            n = update_bn_stats(self.model, forward, loader, num_iter)
        finally:
            loader.close()
        logger.info("PreciseBN: %d batch norms from %d forwards", len(batch_norms(self.model)), n)
        return n

    def save(self, iteration: int) -> None:
        for directory, model, opt, _ in self._parts():
            save_checkpoint(directory, iteration, model, opt)

    def resume(self) -> int:
        """Every model, optimizer and schedule position from its directory's
        last checkpoint; the first model's iteration (0 if none), which every
        rank must share."""
        start = None
        for directory, model, opt, sched in self._parts():
            it = resume(directory, model, opt)
            start = it if start is None else start
            _set_schedule(sched, opt, start)
        assert_uniform_across_processes(start, "the resumed iteration")
        return start

    def _run(self, name: str, start: int, schedule, step, dual_scale: bool,
             evaluate: bool) -> None:
        """``SOLVER.MAX_ITER`` iterations of ``step(batch) → metrics`` over
        the rank's training loader, with the shared hooks (``evaluate``: the
        periodic evaluation too; the checkpointer and the writers on rank 0
        only)."""
        cfg = self.cfg
        loader = build_train_loader(cfg, coco.get_dataset(cfg.DATASETS.TRAIN[0]),
                                    seed=self.seed, dual_scale=dual_scale,
                                    shard_id=rank(), num_shards=world_size())
        hooks = [IterationTimer(), LRLogger(schedule)]
        precise_bn = (precise_bn_hook(cfg, self.model,
                                      functools.partial(self.run_precise_bn,
                                                        dual_scale=dual_scale))
                      if evaluate else None)
        if precise_bn is not None:  # before the evaluation, which sees its statistics
            hooks.append(precise_bn)
        if evaluate and cfg.TEST.EVAL_PERIOD > 0 and cfg.DATASETS.TEST:
            hooks.append(EvalHook(self.evaluate, cfg.TEST.EVAL_PERIOD))
        if is_main():
            hooks += [PeriodicCheckpointer(self.save, cfg.SOLVER.CHECKPOINT_PERIOD),
                      PeriodicWriter(default_writers(self.output_dir, cfg.SOLVER.MAX_ITER))]
        loop = TrainLoop(cfg.SOLVER.MAX_ITER, hooks, start)

        def run_step():
            t0 = time.perf_counter()
            batch = next(loader)
            data_time = cross_process_max(time.perf_counter() - t0)
            metrics = step(batch)
            metrics["data_time"] = data_time
            return metrics

        logger.info("%s: iterations %d..%d on %s (rank %d of %d)", name, start,
                    cfg.SOLVER.MAX_ITER, self.device, rank(), world_size())
        try:
            loop.run(run_step)
        finally:  # by return or by exception: no producer thread outlives train()
            loader.close()


class AFIGANTrainer(_Trainer):
    """Stage 1 (ref stage1_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        self.state = stage1.init_stage1_state(cfg, self.device,
                                              torch.Generator().manual_seed(self.seed))
        for path, module, kind in (
                (cfg.MODEL.GUIDE_WEIGHTS, self.state.guide, "detector"),
                (cfg.MODEL.AFI_GEN_WEIGHTS, self.state.generator, "generator"),
                (cfg.MODEL.AFI_DIS_WEIGHTS, self.state.discriminator, "discriminator")):
            if path:
                self._load(module, path, kind)
        self._replicate(self.state.generator, self.state.discriminator, self.state.guide)

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
        super().__init__(cfg, device)
        self.state = stage2.init_stage2_state(cfg, self.device,
                                              torch.Generator().manual_seed(self.seed))
        # the sources of the RPN's and the ROI heads' subsample keys and of a
        # Swin's DropPath masks, as stage 3's; the same on every rank (JAX
        # hands every shard the same keys)
        self.sampling = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        self.drop_path = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        if cfg.MODEL.GUIDE_WEIGHTS:
            self._load(self.state.guide, cfg.MODEL.GUIDE_WEIGHTS)
        if cfg.MODEL.WEIGHTS:
            self._load(self.model, cfg.MODEL.WEIGHTS)
        if cfg.MODEL.AFI_GEN_WEIGHTS:
            self.load_afigen_weight(cfg.MODEL.AFI_GEN_WEIGHTS)
        if cfg.MODEL.AFI_DIS_WEIGHTS:
            # D's parameters and statistics; its optimizer state is not
            # restored (ref stage2_trainer.py:112-119)
            self._load(self.state.discriminator, cfg.MODEL.AFI_DIS_WEIGHTS, "discriminator")
        self._replicate(self.model, self.state.discriminator, self.state.guide)

    @property
    def model(self) -> torch.nn.Module:
        return self.state.model

    def load_afigen_weight(self, path: str) -> None:
        """A stage-1 G into the detector's AF interpolator, every key."""
        load_afi(self.model, transplant_generator(self.model.state_dict(),
                                                  load_state_dict(path, "generator")))

    def _parts(self):
        st = self.state
        return ((os.path.join(self.output_dir, "AFExtractor"), st.model, st.optimizer,
                 st.scheduler),
                (os.path.join(self.output_dir, "Disc"), st.discriminator, st.d_optimizer,
                 st.d_scheduler))

    def _precise_bn_inputs(self, batch):
        # the half-resolution images the detector trains on (JAX :423-433)
        inputs = stage2.batch_to_device(batch, self.device)
        return inputs["image_x0.5"], inputs["image_sizes_x0.5"], inputs["gt_x0.5"]

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
                                     self.sampling, self.drop_path)

        self._run("stage 2", start, self.state.schedule, step, dual_scale=True, evaluate=True)


class TargetDetectorTrainer(_Trainer):
    """Stage 3 (ref stage3_trainer.py)."""

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device)
        seed = self.seed
        self.state = init_stage3_state(cfg, self.device, torch.Generator().manual_seed(seed))
        # the sources of the RPN's and the ROI heads' subsample keys and of a
        # Swin's DropPath masks (JAX's "sampling" and "dropout" streams),
        # the same on every rank; neither is saved with a checkpoint
        self.sampling = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.drop_path = torch.Generator(device=self.device).manual_seed(seed + 2)
        if cfg.MODEL.WEIGHTS:
            load_matching(self.model, load_state_dict(cfg.MODEL.WEIGHTS), cfg.MODEL.WEIGHTS)
        if cfg.MODEL.AF_EXTRACTOR_WEIGHTS:
            self.load_af_extractor_weight(cfg.MODEL.AF_EXTRACTOR_WEIGHTS)
        self._replicate(self.model)

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

    def _precise_bn_inputs(self, batch):
        inputs = batch_to_device(batch, self.device)
        return inputs["image"], inputs["image_sizes"], inputs["gt"]

    def train(self, resume: bool = False) -> None:
        start = self.resume() if resume else 0

        def step(batch):
            return train_step(self.cfg, self.state, batch_to_device(batch, self.device),
                              self.sampling, self.drop_path)

        self._run("stage 3", start, self.state.schedule, step, dual_scale=False, evaluate=True)
