"""Stage 2: multi-scale AF-extractor training (counterpart of
``afigan_tpu/engine/stage2.py``).

The detector (``GeneralizedRCNN_AFExtractor``, or ``FCOS`` over a BiFPN:
the detector returning its pyramid too) trains on the x0.5 images against
the x0.5 GT, and its pyramid (whose top-down path runs the AF interpolator)
is held by the discriminator against the frozen guide's full-resolution
pyramid resized by half, on the levels both have (``gan_levels``: p2-p6 for
the R-CNN FPNs, p3-p7 for a BiFPN):

- "real": each coupled level of the guide on ``image``, in float32, resized to
  (h//2, w//2) with ``antialias=True``. ``jax.image.resize(..., "linear")``,
  which the JAX step uses, anti-aliases when it shrinks; torch's bilinear
  resize does so only when asked (without it the two differ by up to 2 on a
  13x21 map, with it by 1e-7);
- one detector forward on ``image_x0.5`` / ``image_sizes_x0.5`` / ``gt_x0.5``
  (the RPN's and the ROI heads' subsample keys from ``draws``, as in stage 3):
  its losses and its pyramid ("fake", in float32);
- the D step on the detached fakes (``engine/stage1.py::d_step``), D's
  optimizer step;
- one backward of Σ non-``diag_`` detector losses + Σ over levels of
  ``ADV_LOSS_WEIGHT`` · BCE(D(fake), 1) + L1(fake, real) through the updated
  D into the detector's trainable parameters (D takes no gradient): the JAX
  step's single forward with ``jax.vjp``, without a second forward; then the
  detector's clipping, optimizer and schedule step.

The detector is frozen per ``BACKBONE.FREEZE_AT`` and ``MODEL.AFI_FREEZE``
(FrozenBN statistics are buffers); its BN / SyncBN norms (a BiFPN's) train
and move their running statistics in the forward. The guide stays in eval
mode with frozen norms. A Swin detector draws its DropPath masks from
``drop_path`` (``models/swin.py::drop_path_source``), as stage 3 does. Under a
process group each rank steps on its own images: D's gradients are the means
over ranks before D's step, the detector's before its step, and so are the
metrics (``parallel/dist.py``), as JAX ``pmean``s them. ``TPU.REMAT`` and
``TPU.APPROX_TOPK`` are not read.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..models import build_guide_model, build_model
from ..models.afi import PatchDiscriminator
from ..models.build import check_device
from ..models.layers import to_nchw, to_nhwc
from ..models.roi_heads import GroundTruth
from ..models.swin import drop_path_source
from ..parallel import mean_grads_
from .solver import build_optimizer, clip_gradients, freeze, frozen_predicates
from .stage1 import build_discriminator, d_step, gan_loss, to_floats


def gan_levels(cfg) -> tuple:
    """Pyramid levels the GAN couples: the intersection of the detector's and
    the guide's (p2-p6 for the RCNN FPNs, p3-p7 for BiFPN and the p6p7 top
    block), as ``afigan_tpu/engine/stage2.py::gan_levels``."""
    smap = {"res2": 2, "res3": 3, "res4": 4, "res5": 5,
            "stage2": 2, "stage3": 3, "stage4": 4, "stage5": 5}

    def levels_of(name: str) -> tuple:
        if "bifpn" in name:
            return ("p3", "p4", "p5", "p6", "p7")
        unknown = [f for f in cfg.MODEL.FPN.IN_FEATURES if f not in smap]
        if unknown:
            raise ValueError(
                f"stage-2 GAN coupling: unknown FPN.IN_FEATURES {unknown} "
                f"(known: {sorted(smap)})")
        out = [f"p{smap[f]}" for f in cfg.MODEL.FPN.IN_FEATURES]
        tb = cfg.MODEL.FPN.TOP_BLOCK
        if tb == "p6p7":
            out += ["p6", "p7"]
        elif tb == "maxpool":
            out += ["p6"]
        elif tb != "":
            raise ValueError(f"stage-2 GAN coupling: unknown FPN.TOP_BLOCK {tb!r} "
                             "(known: '', 'maxpool', 'p6p7')")
        return tuple(out)

    det = levels_of(cfg.MODEL.BACKBONE.NAME)
    guide = levels_of(cfg.MODEL.GUIDE_BACKBONE.NAME or "")
    return tuple(lvl for lvl in det if lvl in guide)


class Stage2State(NamedTuple):
    model: torch.nn.Module
    discriminator: PatchDiscriminator
    guide: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    d_optimizer: torch.optim.Optimizer
    d_scheduler: torch.optim.lr_scheduler.LambdaLR
    schedule: object


def init_stage2_state(cfg, device="cuda", generator: Optional[torch.Generator] = None
                      ) -> Stage2State:
    """The detector in training mode returning its features, frozen per the
    config, D and the frozen guide, and an optimizer (with its schedule) for
    the detector and one for D, on ``device``; weights from ``generator``."""
    device = check_device(device, "init_stage2_state")
    if cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError("stage 2 with MODEL.KEYPOINT_ON is not ported yet "
                                  "(ROADMAP queue 1)")
    model = build_model(cfg, device=device, generator=generator, train=True)
    model.return_features = True
    freeze(model, frozen_predicates(cfg))
    d = build_discriminator(cfg, device, generator)
    guide = build_guide_model(cfg, device, generator)
    opt, sched, schedule = build_optimizer(cfg, model)
    d_opt, d_sched, _ = build_optimizer(cfg, d)
    return Stage2State(model, d, guide, opt, sched, d_opt, d_sched, schedule)


def batch_to_device(batch: Dict, device) -> Dict:
    """A collated dual-scale batch → the step's inputs on ``device``: the
    full-resolution images (the guide's), the x0.5 images, sizes and GT."""
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device, non_blocking=True)

    g = batch["gt_x0.5"]
    gt = GroundTruth(t(g["boxes"]), t(g["classes"]).long(), t(g["valid"]),
                     t(g["masks"]) if "masks" in g else None)
    return {"image": t(batch["image"]), "image_x0.5": t(batch["image_x0.5"]),
            "image_sizes_x0.5": t(batch["image_sizes_x0.5"]), "gt_x0.5": gt}


def half_resize(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) → float32 (B, H//2, W//2, C), bilinear with half-pixel
    centres and anti-aliasing: ``jax.image.resize(f, ..., "linear")``."""
    b, h, w, c = f.shape[0], f.shape[1] // 2, f.shape[2] // 2, f.shape[3]
    if h == 0 or w == 0:  # a 1-pixel side: an empty map, as jax.image.resize gives
        return f.new_zeros((b, h, w, c), dtype=torch.float32)
    return to_nhwc(F.interpolate(to_nchw(f.float()), size=(h, w), mode="bilinear",
                                 align_corners=False, antialias=True))


def step_tensors(cfg, state: Stage2State, inputs: Dict, draws=None, drop_path=None
                 ) -> Dict[str, torch.Tensor]:
    """One step, the metrics left on the device. ``draws`` / ``drop_path``:
    the sources of the subsample keys and of a Swin's DropPath masks.
    record_function ranges name its parts in a torch.profiler trace: guide,
    detector (the forward), d_step, g_step (the GAN loss, the backward, the
    optimizer)."""
    levels = gan_levels(cfg)
    with record_function("guide"), torch.no_grad():
        guide_feats = state.guide(inputs["image"])
        real = [half_resize(guide_feats[k]) for k in levels]
    del guide_feats
    with record_function("detector"), drop_path_source(state.model, drop_path):
        losses, feats = state.model(inputs["image_x0.5"], inputs["image_sizes_x0.5"],
                                    inputs["gt_x0.5"], draws=draws)
        fake = [feats[k].float() for k in levels]
    with record_function("d_step"):
        d_metrics = d_step(cfg, state, real, fake, levels=levels)
    with record_function("g_step"):
        gan, g_metrics = gan_loss(cfg, state, real, fake, levels)
        det = sum(v for k, v in losses.items() if not k.startswith("diag_"))
        total = det + gan
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        # one backward through the updated D into the detector; D takes none
        params = [p for g in opt.param_groups for p in g["params"]]
        total.backward(inputs=params)
        mean_grads_(params)
        clip_gradients(cfg, params)
        opt.step()
        state.scheduler.step()
    return {"total_loss": total.detach(), "d_loss": d_metrics.pop("d_loss"),
            **{k: v.detach() for k, v in losses.items()}, **d_metrics, **g_metrics}


def train_step(cfg, state: Stage2State, inputs: Dict, draws=None, drop_path=None
               ) -> Dict[str, float]:
    """One stage-2 step; the metrics under the JAX package's names
    (``total_loss``, ``d_loss``, the detector's losses, ``d_loss_{lvl}``,
    ``adv_loss_{lvl}``, ``content_loss_{lvl}``) as floats."""
    return to_floats(step_tensors(cfg, state, inputs, draws, drop_path))
