"""Shared layer primitives (PyTorch, NHWC at every public function).

Counterpart of ``afigan_tpu/models/layers.py``. Modules take and return
NHWC tensors like the JAX package; each convolution views its input as
NCHW (a ``permute``, which is ``torch.channels_last`` memory) for
``F.conv2d`` and returns NHWC again. Parameters are kept in float32 and
cast to the activation dtype at use (the JAX package's ``param_dtype=
float32`` / ``dtype=COMPUTE_DTYPE`` split).

State-dict names follow d2: ``conv.weight``, ``conv.bias``, and a norm
submodule ``conv.norm.{weight,bias,running_mean,running_var}``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Initializers (the JAX package's distributions; exact values differ)
# ---------------------------------------------------------------------------

def _fans(w: torch.Tensor, transposed: bool = False):
    rf = w[0, 0].numel() if w.dim() > 2 else 1
    if transposed:  # torch ConvTranspose weight is (in, out, kh, kw)
        return w.shape[0] * rf, w.shape[1] * rf
    return w.shape[1] * rf, w.shape[0] * rf  # (fan_in, fan_out)


def normal_(w, std, gen):
    with torch.no_grad():
        w.copy_(torch.randn(w.shape, generator=gen, dtype=torch.float32) * std)


def uniform_(w, limit, gen):
    with torch.no_grad():
        u = torch.rand(w.shape, generator=gen, dtype=torch.float32)
        w.copy_((2.0 * u - 1.0) * limit)


def init_weight(w: torch.Tensor, kind: str, gen: torch.Generator,
                transposed: bool = False) -> None:
    """kind: 'msra' (c2_msra_fill), 'xavier' (c2_xavier_fill),
    'kaiming0.1' (AFI generator), or 'normal<std>'."""
    fan_in, fan_out = _fans(w, transposed)
    if kind == "msra":
        normal_(w, math.sqrt(2.0 / fan_out), gen)
    elif kind == "xavier":
        uniform_(w, math.sqrt(3.0 / fan_in), gen)
    elif kind == "kaiming0.1":
        normal_(w, 0.1 * math.sqrt(2.0 / fan_in), gen)
    elif kind.startswith("normal"):
        normal_(w, float(kind[len("normal"):]), gen)
    else:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Norm
# ---------------------------------------------------------------------------

class FrozenBatchNorm2d(nn.Module):
    """d2 FrozenBatchNorm2d: (x - mean) / sqrt(var + eps) * w + b, folded
    into one multiply-add in float32 and cast to the activation dtype.
    ``bn_momentum``: where the module stands for BN / SyncBN (``get_norm``),
    the flax momentum of the batch norm that ``unfreeze_batch_norms`` puts in
    its place in a training build; None for FrozenBN, which never trains."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 bn_momentum: Optional[float] = None):
        super().__init__()
        self.eps = eps
        self.bn_momentum = bn_momentum
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):  # NHWC
        mul = self.weight * torch.rsqrt(self.running_var + self.eps)
        add = self.bias - self.running_mean * mul
        return x * mul.to(x.dtype) + add.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """torch GroupNorm over NHWC, statistics and affine in float32 (as flax
    computes them for bfloat16 inputs), cast back to the activation dtype."""

    def forward(self, x):
        # torch.group_norm: F.group_norm refuses a group of one value (a 1x1 map)
        y = torch.group_norm(to_nchw(x).float(), self.num_groups, self.weight, self.bias,
                             self.eps)
        return to_nhwc(y).to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """Batch norm over NHWC with flax ``nn.BatchNorm``'s statistics: the
    discriminator's norm, and BN / SyncBN (plain batch norm on one device) in
    a training build (``unfreeze_batch_norms``). In training mode it normalises by the
    batch's statistics and moves the running ones by ``momentum`` (torch's
    convention: 0.1 is flax's 0.9) towards them, taking the *biased* batch
    variance as flax does:
    torch's own update takes the unbiased one, n/(n-1) times larger. The
    statistics and the normalisation are torch's (float32 statistics, float32
    affine, output in the activation's dtype). No ``num_batches_tracked``
    (flax keeps none)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 device=None):
        super().__init__(num_features, eps, momentum, device=device)
        self.num_batches_tracked = None

    @classmethod
    def from_frozen(cls, frozen: FrozenBatchNorm2d) -> "BatchNorm2d":
        """The batch norm that trains in place of a frozen BN / SyncBN: its
        eps, torch momentum 1 - its flax ``bn_momentum``, its values."""
        bn = cls(frozen.weight.numel(), frozen.eps, 1.0 - frozen.bn_momentum,
                 device=frozen.weight.device)
        bn.load_state_dict(frozen.state_dict())
        return bn

    def _load_from_state_dict(self, *args, **kwargs):
        # torch's BatchNorm adds a ``num_batches_tracked`` entry to a state
        # dict without version metadata; there is none here
        nn.Module._load_from_state_dict(self, *args, **kwargs)

    def forward(self, x):  # NHWC
        # torch.batch_norm / native_batch_norm: F.batch_norm refuses one value
        # a channel (a 1x1 map of one image), which flax normalises to the bias
        x = to_nchw(x)
        if not self.training:
            return to_nhwc(torch.batch_norm(x, self.weight, self.bias, self.running_mean,
                                            self.running_var, False, 0.0, self.eps, True))
        # one reduction gives the normalisation and the running update: the
        # biased variance is recovered from the saved 1/sqrt(var + eps)
        y, mean, invstd = torch.native_batch_norm(x, self.weight, self.bias, None, None, True,
                                                  0.0, self.eps)
        with torch.no_grad():
            var = (invstd.double().pow(-2) - self.eps).clamp_min(0.0).float()
            self.running_mean.lerp_(mean.float(), self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return to_nhwc(y)


def get_norm(norm: str, features: int, bn_eps: float = 1e-5, bn_momentum: float = 0.9
             ) -> Optional[nn.Module]:
    """'' | 'FrozenBN' | 'BN' | 'SyncBN' | 'GN' (``afigan_tpu/models/layers.py::
    get_norm``). BN and SyncBN (one device: plain batch norm) are built as
    the frozen module over the running statistics, with ``bn_eps`` and d2's
    BatchNorm keys (weight, bias, running_mean, running_var), marked with
    the flax momentum ``bn_momentum`` of their running update:
    ``unfreeze_batch_norms`` makes them batch norm that trains in a training
    build. GN is 32 groups at eps 1e-5."""
    if not norm:
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm2d(features)
    if norm in ("BN", "SyncBN"):
        return FrozenBatchNorm2d(features, eps=bn_eps, bn_momentum=bn_momentum)
    if norm == "GN":
        return GroupNorm(32, features, eps=1e-5)
    raise ValueError(f"unknown norm {norm!r}")


def unfreeze_batch_norms(model: nn.Module) -> int:
    """Puts ``BatchNorm2d.from_frozen`` in place of every frozen BN / SyncBN
    of ``model`` (FrozenBN stays): the training build's norms, as the JAX
    package's ``get_norm(..., train=True)``. Returns how many."""
    n = 0
    for parent in list(model.modules()):
        for name, m in list(parent.named_children()):
            if isinstance(m, FrozenBatchNorm2d) and m.bn_momentum is not None:
                setattr(parent, name, BatchNorm2d.from_frozen(m))
                n += 1
    return n


# ---------------------------------------------------------------------------
# Convs
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """d2 Conv2d (+ optional norm) over NHWC; activation left to callers."""

    def __init__(self, in_ch, out_ch, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, bias=True, norm: str = "",
                 bn_eps: float = 1e-5, bn_momentum: float = 0.9, device=None):
        super().__init__(in_ch, out_ch, kernel_size, stride, padding,
                         dilation, groups, bias, device=device)
        n = get_norm(norm, out_ch, bn_eps, bn_momentum)
        if n is not None:
            self.norm = n.to(device)
        else:
            self.norm = None

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(to_nchw(x), self.weight.to(x.dtype), b, self.stride,
                     self.padding, self.dilation, self.groups)
        y = to_nhwc(y)
        if self.norm is not None:
            y = self.norm(y)
        return y


class SeparableConv(nn.Module):
    """Depthwise 3x3 (stride 1: 'static_same' padding is 1 on every side, no
    bias) + pointwise 1x1 (bias) + optional norm: the BiFPN primitive
    (``afigan_tpu/models/layers.py::SeparableConv``). d2 keys ``depthwise``,
    ``pointwise``, ``norm``."""

    def __init__(self, channels: int, out_ch: int, norm: str = "",
                 bn_eps: float = 1e-5, bn_momentum: float = 0.9, device=None):
        super().__init__()
        self.depthwise = Conv2d(channels, channels, 3, padding=1, groups=channels,
                                bias=False, device=device)
        self.pointwise = Conv2d(channels, out_ch, 1, device=device)
        n = get_norm(norm, out_ch, bn_eps, bn_momentum)
        self.norm = None if n is None else n.to(device)

    def forward(self, x):
        y = self.pointwise(self.depthwise(x))
        return y if self.norm is None else self.norm(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    """torch ConvTranspose2d over NHWC (the JAX ``ConvTranspose``)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose2d(to_nchw(x), self.weight.to(x.dtype), b,
                               self.stride, self.padding)
        return to_nhwc(y)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

def bilinear_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, half-pixel centers with edge clamp (torch
    align_corners=False == ``jax.image.resize(..., "linear")``)."""
    y = F.interpolate(to_nchw(x), scale_factor=2, mode="bilinear",
                      align_corners=False)
    return to_nhwc(y)


def nearest_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def max_pool_stride2(x: torch.Tensor) -> torch.Tensor:
    """kernel-1 stride-2 max pool == strided subsample."""
    return x[:, ::2, ::2, :]

