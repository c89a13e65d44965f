"""Feature Pyramid Network with a pluggable top-down interpolator —
counterpart of ``afigan_tpu/models/fpn.py`` (``interp`` "afi", "nearest"
or "bilinear"; top block ``maxpool``, d2's ``LastLevelMaxPool`` p6, or
``p6p7``, the two stride-2 convs of ``LastLevelP6P7`` on ``top_block_in_feature``
for the FCOS heads; ``norm`` after every lateral and output conv, which then
has no bias). As in d2, the FPN owns its bottom-up network and is the
model's ``backbone``: keys ``bottom_up.*``, ``fpn_lateral{s}``,
``fpn_output{s}``, ``top_block.{p6,p7}``, ``srf_module.*``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from .afi import AFIGenerator
from .layers import (Conv2d, bilinear_upsample_x2, init_weight, max_pool_stride2,
                     nearest_upsample_x2)

_INTERP = {"afi": None, "nearest": nearest_upsample_x2,
           "bilinear": bilinear_upsample_x2}


class FPN(nn.Module):
    def __init__(self, bottom_up: nn.Module, in_channels: Dict[str, int],
                 in_features: Sequence[str] = ("res2", "res3", "res4", "res5"),
                 in_strides: Sequence[int] = (4, 8, 16, 32),
                 out_channels: int = 256, norm: str = "",
                 fuse_type: str = "sum", interp: str = "afi",
                 top_block: str = "maxpool", top_block_in_feature: str = "p5",
                 afi_n_rdb: int = 3,
                 afi_growth_rate: int = 32, afi_residual_scale: float = 0.2,
                 device=None):
        super().__init__()
        self.bottom_up = bottom_up
        if top_block not in ("maxpool", "p6p7") or interp not in _INTERP:
            raise ValueError(f"FPN: top block {top_block!r} / interp {interp!r}: one of "
                             f"maxpool, p6p7 / {sorted(_INTERP)}")
        self.in_features = tuple(in_features)
        self.stages = [int(math.log2(s)) for s in in_strides]
        self.fuse_type = fuse_type
        self.interp = interp
        self.top_block_kind = top_block
        self.top_block_in_feature = top_block_in_feature
        conv = dict(bias=not norm, norm=norm, device=device)
        for f, s in zip(self.in_features, self.stages):
            self._add_level(s, in_channels[f], out_channels, conv)
        if top_block == "p6p7":
            src = in_channels.get(top_block_in_feature, out_channels)
            self.top_block = nn.Module()
            self.top_block.p6 = Conv2d(src, out_channels, 3, stride=2, padding=1,
                                       device=device)
            self.top_block.p7 = Conv2d(out_channels, out_channels, 3, stride=2,
                                       padding=1, device=device)
        if interp == "afi":
            self.srf_module = AFIGenerator(out_channels, afi_n_rdb,
                                           afi_growth_rate, afi_residual_scale,
                                           device=device)

    def _add_level(self, s: int, in_ch: int, c: int, conv: dict) -> None:
        self.add_module(f"fpn_lateral{s}", Conv2d(in_ch, c, 1, **conv))
        self.add_module(f"fpn_output{s}", Conv2d(c, c, 3, padding=1, **conv))

    def init_weights(self, gen: torch.Generator) -> None:
        self.bottom_up.init_weights(gen)
        for name, m in self.named_children():
            if name != "bottom_up" and isinstance(m, Conv2d):
                init_weight(m.weight, "xavier", gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        if self.top_block_kind == "p6p7":
            for m in (self.top_block.p6, self.top_block.p7):
                init_weight(m.weight, "xavier", gen)
                nn.init.zeros_(m.bias)
        if self.interp == "afi":
            self.srf_module.init_weights(gen)

    def _up(self, x):
        if self.interp != "afi":
            return _INTERP[self.interp](x)
        with record_function("afi_generator"):
            return self.srf_module(x)

    def _top_down(self, bottom_up) -> List[torch.Tensor]:
        """The laterals merged from the coarsest level down, each coarser sum
        upsampled and cropped to the lateral's shape → the merged maps, finest
        first."""
        feats = [bottom_up[f] for f in self.in_features][::-1]
        rev = self.stages[::-1]
        prev = getattr(self, f"fpn_lateral{rev[0]}")(feats[0])
        merged = [prev]
        for feat, stage in zip(feats[1:], rev[1:]):
            lateral = getattr(self, f"fpn_lateral{stage}")(feat)
            top_down = self._up(prev)[:, : lateral.shape[1], : lateral.shape[2]]
            prev = lateral + top_down
            if self.fuse_type == "avg":
                prev = prev / 2
            merged.insert(0, prev)
        return merged

    def _outputs(self, merged) -> List[torch.Tensor]:
        return [getattr(self, f"fpn_output{s}")(m) for s, m in zip(self.stages, merged)]

    def forward(self, x) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) normalised images → NHWC {"p2": ..., "p6": ...}, or
        p3..p7 on res3-res5 with the ``p6p7`` top block."""
        bottom_up = self.bottom_up(x)
        results = self._outputs(self._top_down(bottom_up))
        out = {f"p{s}": r for s, r in zip(self.stages, results)}
        last = self.stages[-1]
        if self.top_block_kind == "maxpool":
            out[f"p{last + 1}"] = max_pool_stride2(out[f"p{last}"])
        else:
            name = self.top_block_in_feature
            p6 = self.top_block.p6(bottom_up[name] if name in bottom_up else out[name])
            out[f"p{last + 1}"] = p6
            out[f"p{last + 2}"] = self.top_block.p7(F.relu(p6))
        return out
