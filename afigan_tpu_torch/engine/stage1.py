"""Stage 1: AFI-GAN adversarial training on one device (counterpart of
``afigan_tpu/engine/stage1.py``).

The frozen guide (``RCNN_FPN_only``) gives p2..p6 of the full-resolution
images (``hr``) and of their x0.5 replay (``lr``); the generator G upsamples
each ``lr`` level to ``hr``'s size, and the discriminator D tells them apart:

- D step: Σ over levels of BCE(D(hr), 1) + BCE(D(G(lr)), 0) (mean-reduced
  logit BCE, both maps cropped to their common size), then D's optimizer and
  schedule step;
- G step, against the *updated* D: Σ over levels of ``ADV_LOSS_WEIGHT`` ·
  BCE(D(G(lr)), 1) + L1(G(lr), hr). The adversarial term reaches G (the
  reference's detached logits, quirk Q3, are fixed as in the JAX package); D
  takes no gradient. Then G's optimizer and schedule step.

D's batch-norm statistics move on every call, in this order: real then fake
per level in the D step, then once per level in the G step (the JAX step
threads ``stats`` so). ``SOLVER.CLIP_GRADIENTS`` applies to each optimizer's
gradients, as in the JAX package's optax chains. No mesh: one device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..models.afi import AFIGenerator, PatchDiscriminator
from ..models.build import build_guide_model, check_device, compute_dtype
from ..ops.losses import bce_with_logits
from .solver import build_optimizer, clip_gradients

LEVELS = ("p2", "p3", "p4", "p5", "p6")


class Stage1State(NamedTuple):
    generator: AFIGenerator
    discriminator: PatchDiscriminator
    guide: torch.nn.Module
    g_optimizer: torch.optim.Optimizer
    g_scheduler: torch.optim.lr_scheduler.LambdaLR
    d_optimizer: torch.optim.Optimizer
    d_scheduler: torch.optim.lr_scheduler.LambdaLR
    schedule: object


def bce_mean(logits: torch.Tensor, target: float) -> torch.Tensor:
    x = logits.float()
    return bce_with_logits(x, torch.full_like(x, target)).mean()


def crop_pair(a: torch.Tensor, b: torch.Tensor):
    """Both NHWC maps cropped to their common height and width."""
    h, w = min(a.shape[1], b.shape[1]), min(a.shape[2], b.shape[2])
    return a[:, :h, :w], b[:, :h, :w]


def build_discriminator(cfg, device, generator: Optional[torch.Generator] = None
                        ) -> PatchDiscriminator:
    d = PatchDiscriminator(cfg.MODEL.AFI.IN_CHANNELS, dtype=compute_dtype(cfg), device=device)
    if generator is not None:
        d.init_weights(generator)
    return d.train()


def init_stage1_state(cfg, device="cuda", generator: Optional[torch.Generator] = None
                      ) -> Stage1State:
    """G and D in training mode, the frozen guide, and one optimizer (with
    its schedule) each, on ``device``; weights from ``generator`` if given."""
    device = check_device(device, "init_stage1_state")
    guide = build_guide_model(cfg, device, generator)
    a = cfg.MODEL.AFI
    g = AFIGenerator(a.IN_CHANNELS, a.N_RDB, a.GROWTH_RATE, a.RESIDUAL_SCALE, device=device)
    if generator is not None:
        g.init_weights(generator)
    g.train()
    d = build_discriminator(cfg, device, generator)
    g_opt, g_sched, schedule = build_optimizer(cfg, g)
    d_opt, d_sched, _ = build_optimizer(cfg, d)
    return Stage1State(g, d, guide, g_opt, g_sched, d_opt, d_sched, schedule)


def batch_to_device(batch: Dict, device) -> Dict:
    """The two image streams of a collated dual-scale batch on ``device``."""
    return {k: torch.as_tensor(np.ascontiguousarray(batch[k])).to(device, non_blocking=True)
            for k in ("image", "image_x0.5")}


def d_step(cfg, state, real, fake, levels=LEVELS) -> Dict[str, torch.Tensor]:
    """Σ over levels of BCE(D(real), 1) + BCE(D(fake), 0) on the detached
    fakes, its backward into D alone, D's optimizer and schedule step; D's
    gradients are dropped after the step. Returns the detached losses, the
    sum under ``d_loss``."""
    d, opt = state.discriminator, state.d_optimizer
    opt.zero_grad(set_to_none=True)
    total, metrics = 0.0, {}
    for name, r, f in zip(levels, real, fake):
        r, f = crop_pair(r, f.detach())
        lvl = bce_mean(d(r), 1.0) + bce_mean(d(f), 0.0)
        metrics[f"d_loss_{name}"] = lvl.detach()
        total = total + lvl
    total.backward()
    clip_gradients(cfg, d.parameters())
    opt.step()
    state.d_scheduler.step()
    # the G step leaves D's parameters alone: nothing stale reaches the next D step
    opt.zero_grad(set_to_none=True)
    return {"d_loss": total.detach(), **metrics}


def gan_loss(cfg, state, real, fake, levels=LEVELS):
    """Σ over levels of ``ADV_LOSS_WEIGHT`` · BCE(D(fake), 1) + L1(fake, real)
    through the (updated) discriminator, differentiable in ``fake``; D's
    statistics move. Returns (the sum, the detached per-level terms)."""
    d, adv_w = state.discriminator, cfg.MODEL.AFI.ADV_LOSS_WEIGHT
    total, metrics = 0.0, {}
    for name, r, f in zip(levels, real, fake):
        f, r = crop_pair(f, r)
        adv = bce_mean(d(f), 1.0)
        content = (f.float() - r.float()).abs().mean()
        metrics[f"adv_loss_{name}"] = adv.detach()
        metrics[f"content_loss_{name}"] = content.detach()
        total = total + adv_w * adv + content
    return total, metrics


def step_tensors(cfg, state: Stage1State, inputs: Dict) -> Dict[str, torch.Tensor]:
    """One step, the metrics left on the device. record_function ranges name
    its parts in a torch.profiler trace: guide, generator, d_step, g_step."""
    g = state.generator
    with record_function("guide"), torch.no_grad():
        hr_feats = state.guide(inputs["image"])
        lr_feats = state.guide(inputs["image_x0.5"])
    hr = [hr_feats[k] for k in LEVELS]
    # G(lr) once per level, under autograd. The JAX step evaluates it twice
    # with the same parameters (under stop_gradient for the D step, then
    # differentiated for the G step); the D step here takes .detach() of the
    # one forward: the same values, and five generator forwards a step fewer.
    with record_function("generator"):
        fake = [g(lr_feats[k]) for k in LEVELS]
    with record_function("d_step"):
        d_metrics = d_step(cfg, state, hr, fake)
    with record_function("g_step"):
        state.g_optimizer.zero_grad(set_to_none=True)
        g_loss, g_metrics = gan_loss(cfg, state, hr, fake)
        # gradients into G's parameters only: D's stay None
        g_loss.backward(inputs=[p for p in g.parameters() if p.requires_grad])
        clip_gradients(cfg, g.parameters())
        state.g_optimizer.step()
        state.g_scheduler.step()
    return {"d_loss": d_metrics.pop("d_loss"), "g_loss": g_loss.detach(), **d_metrics,
            **g_metrics}


def to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The metrics as floats, in one device sync."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def train_step(cfg, state: Stage1State, inputs: Dict) -> Dict[str, float]:
    """One stage-1 step; the metrics under the JAX package's names
    (``d_loss``, ``g_loss``, ``d_loss_{lvl}``, ``adv_loss_{lvl}``,
    ``content_loss_{lvl}``) as floats."""
    return to_floats(step_tensors(cfg, state, inputs))
