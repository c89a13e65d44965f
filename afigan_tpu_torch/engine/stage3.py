"""Stage 3: the target-detector fine-tune (counterpart of
``afigan_tpu/engine/stage3.py``). The detector in training mode, the frozen
parameters per ``BACKBONE.FREEZE_AT`` / ``MODEL.AFI_FREEZE``, and one train
step: the losses, ``total_loss`` (the sum of every loss but the ``diag_``
monitors), the backward (the ROI pooler's backward kernel on the card), an
optimizer step and a schedule step. ``TPU.GRAD_ACCUM`` runs the batch as that
many micro-batches and averages gradients and losses. Two random streams
feed the forward, as JAX's ``sampling`` and ``dropout`` keys: ``draws`` for
the subsamples (``ops/sampling.py::draw``) and ``drop_path`` for a Swin's
DropPath masks (``models/swin.py::drop_path_keep``), each consumed micro-batch
after micro-batch. Under a process group each rank steps on its own images:
the gradients, after the last micro-batch, and the metrics are the means
over ranks (``parallel/dist.py``), as JAX ``pmean``s them in its
``shard_map``. ``TPU.REMAT`` and ``TPU.APPROX_TOPK`` are not read.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import build_model
from ..models.roi_heads import GroundTruth
from ..models.swin import drop_path_source
from ..parallel import mean_grads_, mean_metrics
from .solver import build_optimizer, clip_gradients, freeze, frozen_predicates


class Stage3State(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    schedule: object


def init_stage3_state(cfg, device="cuda", generator: Optional[torch.Generator] = None
                      ) -> Stage3State:
    """The detector in training mode on ``device`` (weights from
    ``generator``, if given), frozen per the config, and its optimizer."""
    model = build_model(cfg, device=device, generator=generator, train=True)
    freeze(model, frozen_predicates(cfg))
    opt, sched, schedule = build_optimizer(cfg, model)
    return Stage3State(model, opt, sched, schedule)


def batch_to_device(batch: Dict, device) -> Dict:
    """A collated numpy batch → the model's inputs on ``device``."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device, non_blocking=True)

    g = batch["gt"]
    gt = GroundTruth(t(g["boxes"]), t(g["classes"]).long(), t(g["valid"]),
                     t(g["masks"]) if "masks" in g else None,
                     t(g["keypoints"]) if "keypoints" in g else None)
    return {"image": t(batch["image"]), "image_sizes": t(batch["image_sizes"]), "gt": gt}


def _slice(inputs: Dict, lo: int, hi: int) -> Dict:
    gt = inputs["gt"]
    return {"image": inputs["image"][lo:hi], "image_sizes": inputs["image_sizes"][lo:hi],
            "gt": GroundTruth(*(None if v is None else v[lo:hi] for v in gt))}


def loss_and_grads(cfg, model, inputs: Dict, draws=None, drop_path=None
                   ) -> Dict[str, torch.Tensor]:
    """Forward and backward of one batch (over ``TPU.GRAD_ACCUM`` micro-batches,
    gradients and losses averaged); the gradients are left in ``.grad``.
    ``draws`` / ``drop_path``: the sources of the subsample keys and of the
    DropPath masks. Returns the detached losses with ``total_loss``."""
    accum = max(1, int(cfg.TPU.GRAD_ACCUM))
    b = inputs["image"].shape[0]
    if b % accum:
        raise ValueError(f"TPU.GRAD_ACCUM={accum} must divide the batch of {b}")
    sums: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        mb = _slice(inputs, i * b // accum, (i + 1) * b // accum) if accum > 1 else inputs
        with drop_path_source(model, drop_path):
            losses = model(mb["image"], mb["image_sizes"], mb["gt"], draws=draws)
        total = sum(v for k, v in losses.items() if not k.startswith("diag_"))
        (total / accum).backward()
        for k, v in {"total_loss": total, **losses}.items():
            sums[k] = sums.get(k, 0.0) + v.detach() / accum
    return sums


def train_step(cfg, state: Stage3State, inputs: Dict, draws=None, drop_path=None
               ) -> Dict[str, float]:
    """One step: losses and gradients, their means over ranks, clipping,
    optimizer and schedule step. Returns the metrics as floats (one device
    sync)."""
    model, opt = state.model, state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    opt.zero_grad(set_to_none=True)
    metrics = loss_and_grads(cfg, model, inputs, draws, drop_path)
    mean_grads_(params)
    clip_gradients(cfg, params)
    opt.step()
    state.scheduler.step()
    metrics = mean_metrics(metrics)
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))
