"""Path-Aggregation FPN (counterpart of ``afigan_tpu/models/pafpn.py``,
the reference's ``PAFPN_AFIGAN``): the FPN's top-down pass (laterals plus
the pluggable 2x interpolator, no output convs yet), then a bottom-up
augmentation ``n2 = td2``, ``n_{k+1} = td_{k+1} + relu(downsample(n_k))``
with stride-2 3x3 convs (halved under ``fuse_type`` "avg" like the top-down
sums), output convs on n2..n5 and p6 by LastLevelMaxPool. d2 keys
``fpn_lateral{s}``, ``pafpn_output{s}``, ``pafpn_downsample{s}`` (every
level but the finest), ``srf_module.*``.
"""

from __future__ import annotations

from typing import List

import torch.nn.functional as F

from .fpn import FPN
from .layers import Conv2d


class PAFPN(FPN):
    """``FPN`` with the bottom-up augmentation in place of its output convs;
    ``build_backbone`` gives it the default top block, maxpool, as the JAX
    package's registry does."""

    def _add_level(self, s: int, in_ch: int, c: int, conv: dict) -> None:
        self.add_module(f"fpn_lateral{s}", Conv2d(in_ch, c, 1, **conv))
        if s != self.stages[0]:
            self.add_module(f"pafpn_downsample{s}",
                            Conv2d(c, c, 3, stride=2, padding=1, **conv))
        self.add_module(f"pafpn_output{s}", Conv2d(c, c, 3, padding=1, **conv))

    def _outputs(self, merged) -> List:
        pa = merged[0]
        results = [getattr(self, f"pafpn_output{self.stages[0]}")(pa)]
        for inter, stage in zip(merged[1:], self.stages[1:]):
            pa = inter + F.relu(getattr(self, f"pafpn_downsample{stage}")(pa))
            if self.fuse_type == "avg":
                pa = pa / 2
            results.append(getattr(self, f"pafpn_output{stage}")(pa))
        return results
