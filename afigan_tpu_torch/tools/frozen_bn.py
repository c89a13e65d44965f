"""FrozenBN statistics for a randomly initialised ResNet, for runs without
pre-trained weights (``chip_smoke.py``'s train phases, the training tests).

A stage-3 run starts from ImageNet weights (``MODEL.WEIGHTS``), which carry
real FrozenBN statistics. With random weights and FrozenBN at identity the
ResNet-50's features reach 1e4: the first SGD steps diverge, and the deep
gradients are so ill-conditioned that float32 summation order alone moves
them by percents between two frameworks. ``calibrate_frozen_bn`` gives each
FrozenBN the scale of its input on one batch (mean 0, variance E[x^2]: a
centred channel of near-equal values would turn rounding noise into
features) and each bottleneck's last norm a small scale (the small-gamma
residual init), so the random backbone has unit-scale features as a trained
one would.
"""

from __future__ import annotations

import torch

from ..models.layers import FrozenBatchNorm2d
from ..models.resnet import BottleneckBlock


def calibrate_frozen_bn(model, images, residual_gamma: float = 0.1) -> int:
    """One pass of ``model.backbone.bottom_up`` over ``images`` (B, H, W, 3)
    raw pixels, setting every FrozenBN's statistics layer by layer; returns
    the number of FrozenBN modules set."""
    last = {m.conv3.norm for m in model.modules() if isinstance(m, BottleneckBlock)}

    def pre(mod, args):
        mod.running_mean.zero_()
        mod.running_var.copy_(args[0].float().square().mean(dim=(0, 1, 2)))
        if mod in last:
            mod.weight.fill_(residual_gamma)

    handles = [m.register_forward_pre_hook(pre) for m in model.modules()
               if isinstance(m, FrozenBatchNorm2d)]
    try:
        with torch.no_grad():
            x = (images.float() - model.pixel_mean) / model.pixel_std
            model.backbone.bottom_up(x.to(model.dtype))
    finally:
        for h in handles:
            h.remove()
    return len(handles)
