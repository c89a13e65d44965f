"""BiFPN with AF-interpolator upsampling (counterpart of
``afigan_tpu/models/bifpn.py``): a p3-p7 pyramid on three bottom-up stages.

As in the JAX package and the reference: the fusion weights are used raw (no
relu, no normalisation); every 2x upsampling of every layer goes through ONE
shared AF interpolator (4 calls per layer) and is cropped to the target size;
downsampling is a 3x3/s2 max pool over a map zero-padded right and bottom (the
zeros take part in the max); and the bottom-up pass of every layer reads the
BeforeBiFPN laterals as its skip inputs. Like ``FPN``, the module owns its
bottom-up network and is the model's ``backbone``. d2 keys:
``bottom_up.*``, ``before_bifpn.{lateral3..5,p4_skip,p5_skip}.{0,1}``,
``before_bifpn.top_block.p6.{conv,norm}``,
``BiFPNLayer_{l}_conv{i}_{up,down}.{depthwise,pointwise,norm}``,
``BiFPNLayer_{l}_p{i}_w{1,2}``, ``srf_module.*``. Every norm is built with eps
1e-3 and flax momentum 0.99 (torch 0.01), which batch norm that trains reads
(``layers.unfreeze_batch_norms``), as the reference's.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from .afi import AFIGenerator
from .layers import (Conv2d, SeparableConv, get_norm, init_weight, nearest_upsample_x2,
                     to_nchw, to_nhwc)

BN_EPS, BN_MOMENTUM = 1e-3, 0.99  # the reference's BiFPN batch norms (flax momentum)


def _maxpool_same_s2(x):
    """MaxPool2d(3, 2, 'static_same') of the reference: zero-pad right and
    bottom by 1, then a VALID 3x3/s2 max pool (output floor(H/2))."""
    x = F.pad(to_nchw(x), (0, 1, 0, 1))
    return to_nhwc(F.max_pool2d(x, 3, 2))


def _swish(x):
    return x * torch.sigmoid(x)


class _ConvNorm(nn.Module):
    """1x1 conv (bias) + norm under the keys ``conv`` and ``norm``."""

    def __init__(self, in_ch, out_ch, norm, device=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1, device=device)
        n = get_norm(norm, out_ch, BN_EPS, BN_MOMENTUM)
        self.norm = None if n is None else n.to(device)

    def forward(self, x):
        y = self.conv(x)
        return y if self.norm is None else self.norm(y)


def _lateral(in_ch, out_ch, norm, device):
    """1x1 conv (bias) + norm under the keys ``0`` and ``1``."""
    mods = [Conv2d(in_ch, out_ch, 1, device=device)]
    n = get_norm(norm, out_ch, BN_EPS, BN_MOMENTUM)
    if n is not None:
        mods.append(n.to(device))
    return nn.Sequential(*mods)


class BeforeBiFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_ch: int, norm: str, device=None):
        super().__init__()
        c3, c4, c5 = in_channels
        self.lateral3 = _lateral(c3, out_ch, norm, device)
        self.lateral4 = _lateral(c4, out_ch, norm, device)
        self.lateral5 = _lateral(c5, out_ch, norm, device)
        self.p4_skip = _lateral(c4, out_ch, norm, device)
        self.p5_skip = _lateral(c5, out_ch, norm, device)
        self.top_block = nn.Module()
        self.top_block.p6 = _ConvNorm(c5, out_ch, norm, device)

    def convs(self):
        return [m[0] for m in (self.lateral3, self.lateral4, self.lateral5,
                               self.p4_skip, self.p5_skip)] + [self.top_block.p6.conv]


class BiFPN(nn.Module):
    def __init__(self, bottom_up: nn.Module, in_channels: Dict[str, int],
                 in_features: Sequence[str] = ("stage3", "stage4", "stage5"),
                 out_channels: int = 256, fpn_repeat: int = 7, norm: str = "SyncBN",
                 interp: str = "afi", afi_n_rdb: int = 3, afi_growth_rate: int = 32,
                 afi_residual_scale: float = 0.2, device=None):
        super().__init__()
        if interp not in ("afi", "nearest") or len(in_features) != 3:
            raise ValueError("BiFPN takes three bottom-up features and interp "
                             "'afi' or 'nearest'")
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        self.fpn_repeat = fpn_repeat
        self.interp = interp
        self.before_bifpn = BeforeBiFPN([in_channels[f] for f in self.in_features],
                                        out_channels, norm, device)
        sep = dict(norm=norm, bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM, device=device)
        for l in range(fpn_repeat):
            for idx in (6, 5, 4, 3):
                self.add_module(f"BiFPNLayer_{l}_conv{idx}_up",
                                SeparableConv(out_channels, out_channels, **sep))
                setattr(self, f"BiFPNLayer_{l}_p{idx}_w1",
                        nn.Parameter(torch.ones(2, device=device)))
            for idx in (4, 5, 6, 7):
                self.add_module(f"BiFPNLayer_{l}_conv{idx}_down",
                                SeparableConv(out_channels, out_channels, **sep))
                setattr(self, f"BiFPNLayer_{l}_p{idx}_w2",
                        nn.Parameter(torch.ones(2 if idx == 7 else 3, device=device)))
        if interp == "afi":
            self.srf_module = AFIGenerator(out_channels, afi_n_rdb, afi_growth_rate,
                                           afi_residual_scale, device=device)

    def init_weights(self, gen: torch.Generator) -> None:
        self.bottom_up.init_weights(gen)
        for conv in self.before_bifpn.convs():
            init_weight(conv.weight, "xavier", gen)
            nn.init.zeros_(conv.bias)
        for m in self.modules():
            if isinstance(m, SeparableConv):
                for conv in (m.depthwise, m.pointwise):  # lecun normal
                    fan_in = conv.weight[0].numel()
                    init_weight(conv.weight, f"normal{(1.0 / fan_in) ** 0.5}", gen)
                nn.init.zeros_(m.pointwise.bias)
        if self.interp == "afi":
            self.srf_module.init_weights(gen)

    def _up(self, x, target_hw):
        if self.interp == "afi":
            with record_function("afi_generator"):
                y = self.srf_module(x)
        else:
            y = nearest_upsample_x2(x)
        return y[:, : target_hw[0], : target_hw[1]]

    def _fuse(self, name: str, inputs):
        w = getattr(self, name)
        return sum(x * wi.to(x.dtype) for x, wi in zip(inputs, w))

    def _node(self, l, idx, direction, inputs):
        fused = self._fuse(f"BiFPNLayer_{l}_p{idx}_w{1 if direction == 'up' else 2}",
                           inputs)
        return getattr(self, f"BiFPNLayer_{l}_conv{idx}_{direction}")(_swish(fused))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalised images → {"p3": ..., "p7": ...} NHWC."""
        bottom_up = self.bottom_up(x)
        c3, c4, c5 = (bottom_up[f] for f in self.in_features)
        # p3..p7 halve and double exactly only on a 128-divisible canvas
        if c5.shape[1] % 4 or c5.shape[2] % 4:
            raise ValueError(
                f"BiFPN needs a 128-divisible input canvas (c5 {tuple(c5.shape[1:3])} "
                "must be divisible by 4); pad images with "
                "choose_bucket(..., required_size_divisibility(cfg)); a dual-scale "
                "stream's full canvas with required_size_divisibility(cfg, dual_scale=True)")
        bb = self.before_bifpn
        p4_skip, p5_skip = bb.p4_skip(c4), bb.p5_skip(c5)
        p6_in = _maxpool_same_s2(bb.top_block.p6(c5))
        laterals = (bb.lateral3(c3), bb.lateral4(c4), bb.lateral5(c5), p6_in,
                    _maxpool_same_s2(p6_in))
        feats = laterals
        for l in range(self.fpn_repeat):
            p3, p4, p5, p6, p7 = feats
            # ---- top-down ----
            p6_up = self._node(l, 6, "up", [p6, self._up(p7, p6.shape[1:3])])
            p5_up = self._node(l, 5, "up", [p5, self._up(p6_up, p5.shape[1:3])])
            p4_up = self._node(l, 4, "up", [p4, self._up(p5_up, p4.shape[1:3])])
            p3_up = self._node(l, 3, "up", [p3, self._up(p4_up, p3.shape[1:3])])
            # ---- bottom-up: the skips always read the BeforeBiFPN laterals ----
            skip4 = p4_skip if l == 0 else laterals[1]
            skip5 = p5_skip if l == 0 else laterals[2]
            p4_out = self._node(l, 4, "down", [skip4, p4_up, _maxpool_same_s2(p3_up)])
            p5_out = self._node(l, 5, "down", [skip5, p5_up, _maxpool_same_s2(p4_out)])
            p6_out = self._node(l, 6, "down",
                                [laterals[3], p6_up, _maxpool_same_s2(p5_out)])
            p7_out = self._node(l, 7, "down", [laterals[4], _maxpool_same_s2(p6_out)])
            feats = (p3_up, p4_out, p5_out, p6_out, p7_out)
        return {f"p{i + 3}": f for i, f in enumerate(feats)}
