"""Solver (counterpart of ``afigan_tpu/engine/solver.py``): d2's
WarmupMultiStepLR, the frozen parameters, and SGD (or AdamW) as
``torch.optim`` parameter groups that reproduce the JAX package's optax
chain step for step:

- weight decay added to the gradient before momentum: ``WEIGHT_DECAY_NORM``
  for the parameters of a norm module (checked before the bias name, as d2
  does), ``WEIGHT_DECAY_BIAS`` for the other biases, ``WEIGHT_DECAY`` for the
  rest; momentum ``MOMENTUM`` with no dampening;
- ``BIAS_LR_FACTOR`` on the learning rate of the non-norm biases;
- the schedule's count starts at 0 on the first step;
- frozen parameters (``BACKBONE.FREEZE_AT``: stem, res2, ...;
  ``MODEL.AFI_FREEZE``: the AF interpolator) get ``requires_grad=False`` and
  are in no group. FrozenBN's statistics and affine terms are buffers in the
  port, frozen by construction (the JAX package masks them in its params).

``SOLVER.CLIP_GRADIENTS`` ("value" or "norm", over the trainable gradients,
before the decay, as optax's chain) is applied by the train step through
``clip_gradients``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from ..models.layers import FrozenBatchNorm2d

NORM_TYPES = (nn.GroupNorm, nn.LayerNorm, nn.BatchNorm2d, FrozenBatchNorm2d)


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                              warmup_factor: float = 1.0 / 1000, warmup_iters: int = 1000,
                              warmup_method: str = "linear") -> Callable[[int], float]:
    """d2 WarmupMultiStepLR: iteration (0 at the first step) → learning rate."""
    steps = tuple(int(s) for s in steps)
    if warmup_method not in ("linear", "constant"):
        raise ValueError(warmup_method)

    def schedule(it: int) -> float:
        wf = 1.0
        if it < warmup_iters:
            if warmup_method == "linear":
                alpha = it / max(warmup_iters, 1)
                wf = warmup_factor * (1 - alpha) + alpha
            else:
                wf = warmup_factor
        return base_lr * wf * gamma ** sum(1 for s in steps if it >= s)

    return schedule


def backbone_freeze_predicate(freeze_at: int) -> Callable[[str], bool]:
    """d2 BACKBONE.FREEZE_AT: 1 freezes the stem, 2 also res2, ..."""
    frozen = (["stem"] if freeze_at >= 1 else []) + [
        f"res{s}" for s in range(2, 6) if freeze_at >= s]

    def pred(name: str) -> bool:
        return any(f".{part}." in f".{name}" for part in frozen)

    return pred


def afi_freeze_predicate(name: str) -> bool:
    """MODEL.AFI_FREEZE: freeze the AF interpolator (``srf_module``)."""
    return ".srf_module." in f".{name}"


def frozen_predicates(cfg) -> List[Callable[[str], bool]]:
    preds = []
    if cfg.MODEL.BACKBONE.FREEZE_AT > 0:
        preds.append(backbone_freeze_predicate(cfg.MODEL.BACKBONE.FREEZE_AT))
    if cfg.MODEL.AFI_FREEZE:
        preds.append(afi_freeze_predicate)
    return preds


def freeze(model: nn.Module, predicates: Sequence[Callable[[str], bool]]) -> List[str]:
    """``requires_grad=False`` on every parameter a predicate names; returns
    their names."""
    names = []
    for name, p in model.named_parameters():
        if any(pred(name) for pred in predicates):
            p.requires_grad_(False)
            names.append(name)
    return names


def norm_parameter_names(model: nn.Module) -> set:
    """The parameters of norm modules (d2 classifies by module type)."""
    return {f"{mod_name}.{n}" if mod_name else n
            for mod_name, mod in model.named_modules() if isinstance(mod, NORM_TYPES)
            for n, _ in mod.named_parameters(recurse=False)}


def parameter_groups(cfg, model: nn.Module) -> List[Dict]:
    """The trainable parameters by (weight decay, learning-rate factor)."""
    s = cfg.SOLVER
    norms = norm_parameter_names(model)
    adamw = s.OPTIMIZER.upper() == "ADAMW"
    groups: Dict[Tuple[float, float], Dict] = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        is_norm, is_bias = name in norms, name.endswith(".bias")
        if adamw:
            # the Swin detection convention: no decay for norms, biases, the
            # relative position bias tables and the absolute position embedding
            skip = (is_norm or is_bias or "relative_position_bias_table" in name
                    or "absolute_pos_embed" in name)
            decay = 0.0 if skip else s.WEIGHT_DECAY
        else:
            decay = s.WEIGHT_DECAY_NORM if is_norm else (
                s.WEIGHT_DECAY_BIAS if is_bias else s.WEIGHT_DECAY)
        factor = s.BIAS_LR_FACTOR if is_bias and not is_norm else 1.0
        g = groups.setdefault((float(decay), float(factor)), {
            "params": [], "names": [], "weight_decay": float(decay),
            "lr_factor": float(factor)})
        g["params"].append(p)
        g["names"].append(name)
    return list(groups.values())


def build_optimizer(cfg, model: nn.Module, base_lr: float = None):
    """SOLVER.* → (optimizer, its LambdaLR scheduler, the schedule). Freeze
    the model first (``freeze``): frozen parameters are in no group."""
    s = cfg.SOLVER
    lr = s.BASE_LR if base_lr is None else base_lr
    factor = warmup_multistep_schedule(1.0, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                       s.WARMUP_ITERS, s.WARMUP_METHOD)

    def schedule(it: int) -> float:
        return lr * factor(it)

    groups = parameter_groups(cfg, model)
    for g in groups:
        g["lr"] = lr * g["lr_factor"]
    if s.OPTIMIZER.upper() == "ADAMW":
        opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif s.OPTIMIZER.upper() == "SGD":
        opt = torch.optim.SGD(groups, lr=lr, momentum=s.MOMENTUM, dampening=0.0,
                              nesterov=False)
    else:
        raise ValueError(f"SOLVER.OPTIMIZER {s.OPTIMIZER!r}")
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    return opt, sched, schedule


def clip_gradients(cfg, params) -> None:
    """SOLVER.CLIP_GRADIENTS over the trainable gradients (optax.clip /
    clip_by_global_norm)."""
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.ENABLED:
        return
    params = [p for p in params if p.grad is not None]
    if c.CLIP_TYPE == "value":
        torch.nn.utils.clip_grad_value_(params, c.CLIP_VALUE)
    else:
        torch.nn.utils.clip_grad_norm_(params, c.CLIP_VALUE)
