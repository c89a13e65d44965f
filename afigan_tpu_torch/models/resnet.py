"""ResNet-50/101/152 bottom-up (d2 structure and key names), NHWC.

Counterpart of ``afigan_tpu/models/resnet.py`` at depths 50, 101 and 152
(bottleneck blocks; the basic-block depths 18 and 34 are not ported): 7x7/s2 stem +
3x3/s2 max pool, res2..res5 bottleneck stages, FrozenBN, stride on the
1x1 conv (``STRIDE_IN_1X1``). Keys: ``stem.conv1.*``,
``res{s}.{i}.{conv1,conv2,conv3,shortcut}.*``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, init_weight, to_nchw, to_nhwc

RESNET_STAGES = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch, out_ch, bottleneck_ch, stride=1, norm="FrozenBN",
                 stride_in_1x1=True, dilation=1, device=None):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        kw = dict(bias=False, norm=norm, device=device)
        self.conv1 = Conv2d(in_ch, bottleneck_ch, 1, stride=s1, **kw)
        self.conv2 = Conv2d(bottleneck_ch, bottleneck_ch, 3, stride=s3,
                            padding=dilation, dilation=dilation, **kw)
        self.conv3 = Conv2d(bottleneck_ch, out_ch, 1, **kw)
        if in_ch != out_ch or stride != 1:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride=stride, **kw)
        else:
            self.shortcut = None

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class BasicStem(nn.Module):
    def __init__(self, in_ch=3, out_ch=64, norm="FrozenBN", device=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 7, stride=2, padding=3, bias=False,
                            norm=norm, device=device)

    def forward(self, x):
        y = F.relu(self.conv1(x))
        # 3x3/s2 max pool, padding 1 (pads with -inf like flax max_pool)
        return to_nhwc(F.max_pool2d(to_nchw(y), 3, 2, 1))


class ResNet(nn.Module):
    """Returns {"res2": ..., "res5": ...} NHWC features."""

    def __init__(self, depth=50, norm="FrozenBN", stem_out_channels=64,
                 res2_out_channels=256, num_groups=1, width_per_group=64,
                 stride_in_1x1=True, res5_dilation=1,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 device=None):
        super().__init__()
        if depth not in RESNET_STAGES or num_groups != 1:
            raise NotImplementedError(
                f"ResNet depth {depth} / {num_groups} groups: only depths "
                f"{sorted(RESNET_STAGES)} with one group are ported (ROADMAP queue 1 #5)")
        self.out_features = tuple(out_features)
        self.stem = BasicStem(3, stem_out_channels, norm, device)
        in_ch = stem_out_channels
        out_ch = res2_out_channels
        bott = num_groups * width_per_group
        self.stage_names = []
        max_stage = max(int(f[3:]) for f in self.out_features)
        for idx, stage in enumerate(range(2, 6)):
            if stage > max_stage:
                break
            first_stride = 1 if stage == 2 else 2
            dil = res5_dilation if stage == 5 else 1
            if stage == 5 and res5_dilation == 2:
                first_stride = 1
            blocks = []
            for b in range(RESNET_STAGES[depth][idx]):
                blocks.append(BottleneckBlock(
                    in_ch, out_ch, bott, first_stride if b == 0 else 1, norm,
                    stride_in_1x1, dil, device))
                in_ch = out_ch
            name = f"res{stage}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_weight(m.weight, "msra", gen)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.stem(x)
        out = {}
        for name in self.stage_names:
            y = getattr(self, name)(y)
            if name in self.out_features:
                out[name] = y
        return out


def build_resnet(cfg, device=None) -> ResNet:
    r = cfg.MODEL.RESNETS
    return ResNet(
        depth=r.DEPTH, norm=r.NORM, stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS, num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP, stride_in_1x1=r.STRIDE_IN_1X1,
        res5_dilation=r.RES5_DILATION, out_features=tuple(r.OUT_FEATURES),
        device=device,
    )
