"""ResNeSt bottom-up (split-attention ResNet), NHWC — counterpart of
``afigan_tpu/models/resnest.py``:

* ``DeepStem``: three 3x3 convs (stride 2, 1, 1; widths w, w, 2w with w 32
  at depth 50 and 64 at 101/152) and the 3x3/s2 max pool;
* ``SplAtConv2d``: a grouped conv to ``channels * radix`` (groups
  ``cardinality * radix``), norm and ReLU; the radix chunks (chunk k is
  channels ``[k*c, (k+1)*c)``) summed, averaged over the map, ``fc1`` (groups
  ``cardinality``) with norm and ReLU, ``fc2`` to ``c * radix``, and an
  rSoftMax over the radix in the grouped conv's ``[card][r][c/card]`` layout,
  transposed back to the chunks' ``[r][card][c/card]`` (a sigmoid gate at
  radix 1);
* ``ResNeStBottleneck``: 1x1, split-attention 3x3, 3x3 average pool of the
  stride after it (AVD, ``count_include_pad`` off), 1x1; the shortcut where the
  width changes, average-pooled by the stride first under AVG_DOWN;
* ``build_resnest``: deep stem, AVD and AVG_DOWN implied by radix > 1.

Norms at eval: BN / SyncBN are batch norm over the running statistics
(``layers.get_norm``). d2 / ResNeSt keys: ``stem.conv1_{1,2,3}``,
``res{s}.{i}.{conv1,conv3,shortcut}``, ``res{s}.{i}.conv2.{conv,bn0,fc1,bn1,fc2}``.
The deformable conv (``DEFORM_ON_PER_STAGE``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, get_norm, init_weight, to_nchw, to_nhwc
from .resnet import RESNET_STAGES

_STEM_WIDTH = {50: 32, 101: 64, 152: 64}


def avg_pool(x, window: int, stride: int, padding: int):
    """NHWC average pool over the window's in-image cells (flax
    ``avg_pool(count_include_pad=False)``)."""
    return to_nhwc(F.avg_pool2d(to_nchw(x), window, stride, padding,
                                count_include_pad=False))


class SplAtConv2d(nn.Module):
    def __init__(self, in_ch: int, channels: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, groups: int = 1, radix: int = 2,
                 reduction_factor: int = 4, norm: str = "BN", device=None):
        super().__init__()
        self.radix, self.cardinality, self.channels = radix, groups, channels
        inter = max(in_ch * radix // reduction_factor, 32)
        self.conv = Conv2d(in_ch, channels * radix, kernel_size, stride, dilation, dilation,
                           groups * radix, bias=False, device=device)
        self.bn0 = get_norm(norm, channels * radix)
        self.fc1 = Conv2d(channels, inter, 1, groups=groups, device=device)
        self.bn1 = get_norm(norm, inter)
        self.fc2 = Conv2d(inter, channels * radix, 1, groups=groups, device=device)
        if device is not None:
            self.to(device)

    def forward(self, x):
        r, card, c = self.radix, self.cardinality, self.channels
        y = self.conv(x)
        y = F.relu(y if self.bn0 is None else self.bn0(y))
        b, h, w, _ = y.shape
        splits = y.reshape(b, h, w, r, c)
        gap = splits.sum(dim=3).mean(dim=(1, 2), keepdim=True)  # (B, 1, 1, c)
        gap = self.fc1(gap)
        gap = F.relu(gap if self.bn1 is None else self.bn1(gap))
        atten = self.fc2(gap)  # (B, 1, 1, c * r) in the grouped conv's layout
        if r == 1:
            return torch.sigmoid(atten) * y
        a = torch.softmax(atten.reshape(b, card, r, c // card).float(), dim=2).to(y.dtype)
        a = a.transpose(1, 2).reshape(b, 1, 1, r, c)
        return (a * splits).sum(dim=3)


class ResNeStBottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, bottleneck_ch: int, stride: int = 1,
                 num_groups: int = 1, norm: str = "FrozenBN", stride_in_1x1: bool = False,
                 dilation: int = 1, radix: int = 2, bottleneck_width: int = 64,
                 avd: bool = True, avg_down: bool = True, device=None):
        super().__init__()
        group_width = int(bottleneck_ch * (bottleneck_width / 64.0)) * num_groups
        self.stride = stride
        self.avd = avd and stride > 1
        self.avg_down = avg_down
        self.radix = radix
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        s3 = 1 if self.avd else s3
        kw = dict(bias=False, norm=norm, device=device)
        self.conv1 = Conv2d(in_ch, group_width, 1, stride=s1, **kw)
        if radix > 1:
            self.conv2 = SplAtConv2d(group_width, group_width, 3, s3, dilation, num_groups,
                                     radix, norm=norm, device=device)
        else:
            self.conv2 = Conv2d(group_width, group_width, 3, stride=s3, padding=dilation,
                                dilation=dilation, groups=num_groups, **kw)
        self.conv3 = Conv2d(group_width, out_ch, 1, **kw)
        self.shortcut = None
        if in_ch != out_ch:
            self.shortcut = Conv2d(in_ch, out_ch, 1, stride=1 if avg_down else stride, **kw)

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = self.conv2(out)
        if self.radix == 1:
            out = F.relu(out)
        if self.avd:
            out = avg_pool(out, 3, self.stride, 1)
        out = self.conv3(out)
        sc = x
        if self.shortcut is not None:
            if self.avg_down and self.stride > 1:
                sc = avg_pool(sc, self.stride, self.stride, 0)
            sc = self.shortcut(sc)
        return F.relu(out + sc)


class DeepStem(nn.Module):
    def __init__(self, stem_width: int = 64, norm: str = "FrozenBN", device=None):
        super().__init__()
        kw = dict(padding=1, bias=False, norm=norm, device=device)
        self.conv1_1 = Conv2d(3, stem_width, 3, stride=2, **kw)
        self.conv1_2 = Conv2d(stem_width, stem_width, 3, **kw)
        self.conv1_3 = Conv2d(stem_width, stem_width * 2, 3, **kw)

    def forward(self, x):
        y = F.relu(self.conv1_1(x))
        y = F.relu(self.conv1_2(y))
        y = F.relu(self.conv1_3(y))
        return to_nhwc(F.max_pool2d(to_nchw(y), 3, 2, 1))


class ResNeSt(nn.Module):
    """Returns {"res2": ..., "res5": ...} NHWC features. The deep stem is
    always used, as in the JAX module."""

    def __init__(self, depth: int = 101, norm: str = "FrozenBN", radix: int = 2,
                 bottleneck_width: int = 64, avd: bool = True, avg_down: bool = True,
                 num_groups: int = 1, width_per_group: int = 64,
                 stride_in_1x1: bool = False, res5_dilation: int = 1,
                 res2_out_channels: int = 256,
                 out_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 device=None):
        super().__init__()
        if depth not in _STEM_WIDTH:
            raise NotImplementedError(f"ResNeSt depth {depth}: one of {sorted(_STEM_WIDTH)}")
        self.out_features = tuple(out_features)
        stem_width = _STEM_WIDTH[depth]
        self.stem = DeepStem(stem_width, norm, device)
        in_ch, out_ch = stem_width * 2, res2_out_channels
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
                blocks.append(ResNeStBottleneck(
                    in_ch, out_ch, bott, first_stride if b == 0 else 1, num_groups, norm,
                    stride_in_1x1, dil, radix, bottleneck_width, avd, avg_down, device))
                in_ch = out_ch
            name = f"res{stage}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            out_ch *= 2
            bott *= 2

    def init_weights(self, gen: torch.Generator) -> None:
        """c2_msra_fill on every conv (split-attention fc1/fc2 included),
        zero biases; norms keep their identity statistics."""
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_weight(m.weight, "msra", gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.stem(x)
        out = {}
        for name in self.stage_names:
            y = getattr(self, name)(y)
            if name in self.out_features:
                out[name] = y
        return out


def build_resnest(cfg, device=None) -> ResNeSt:
    r = cfg.MODEL.RESNETS
    if any(r.DEFORM_ON_PER_STAGE):
        raise NotImplementedError(
            "MODEL.RESNETS.DEFORM_ON_PER_STAGE: the deformable conv is not ported yet "
            "(ROADMAP queue 1 #5, ops/deform_conv.py)")
    radix = r.RADIX
    return ResNeSt(
        depth=r.DEPTH, norm=r.NORM, radix=radix, bottleneck_width=r.BOTTLENECK_WIDTH,
        avd=r.AVD or radix > 1, avg_down=r.AVG_DOWN or radix > 1,
        num_groups=r.NUM_GROUPS, width_per_group=r.WIDTH_PER_GROUP,
        stride_in_1x1=r.STRIDE_IN_1X1, res5_dilation=r.RES5_DILATION,
        res2_out_channels=r.RES2_OUT_CHANNELS, out_features=tuple(r.OUT_FEATURES),
        device=device)
