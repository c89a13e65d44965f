"""Feature-patch discriminator — counterpart of
``afigan_tpu/models/afi/discriminator.py``: a PatchGAN over pyramid feature
maps. Three blocks of 3x3 conv (bias) + batch norm + LeakyReLU 0.2 at widths
2C, 4C, 4C (512, 1024, 1024 for C 256), then a 1-channel 3x3 conv (bias): one
real/fake logit per position. Weights ``c2_msra_fill``, zero biases.

State-dict names are d2's (``Discriminators.0.{0,1,2}.0`` the conv with its
norm as ``.norm``, ``Discriminators.0.3.0`` the output conv), the names
``afigan_tpu.utils.converters.translate_discriminator_key`` maps 1:1. The norm
is ``models/layers.py::BatchNorm2d`` (flax's statistics and update): the JAX
package's "SyncBN", which on one device is plain batch norm over the batch.
Parameters and statistics are float32; the input is cast to ``dtype`` (the
compute dtype, ``TPU.COMPUTE_DTYPE``) and the logits come out in it.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import BatchNorm2d, Conv2d, init_weight


class PatchDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 256, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        widths = [in_channels * min(2 ** n, 4) for n in range(1, 4)]
        blocks, c = [], in_channels
        for w in widths:
            conv = Conv2d(c, w, 3, padding=1, device=device)
            conv.norm = BatchNorm2d(w, device=device)
            blocks.append(nn.Sequential(conv, nn.LeakyReLU(0.2)))
            c = w
        blocks.append(nn.Sequential(Conv2d(c, 1, 3, padding=1, device=device)))
        self.Discriminators = nn.ModuleList([nn.Sequential(*blocks)])

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_weight(m.weight, "msra", gen)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        """(B, H, W, C) → (B, H, W, 1) patch logits in ``dtype``."""
        return self.Discriminators[0](x.to(self.dtype))
