"""(Modulated) deformable convolution (counterpart of
``afigan_tpu/ops/deform_conv.py``, which is XLA code in the JAX package, not
a Pallas kernel).

For every output position and kernel tap the input is sampled bilinearly at
``p + p_k + offset_k`` (zeros outside the map), optionally scaled by the
modulation mask, and the (tap, channel) axis is contracted with the kernel in
one matrix product. Float32 inside whatever the inputs' dtype, as the JAX
caller casts.

Always through ``ops/kernels/deform_conv.py::DeformConv2dFunction``, with grad
on or off: on CUDA tensors its sampling and its adjoint are the kernels of
``csrc/deform_conv.cu`` (no fallback to the gather on the card), on CPU
tensors their plain torch versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.deform_conv import DeformConv2dFunction


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                  dilation: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) NHWC; offsets (B, Ho, Wo, 2K), (dy, dx) per tap in
    torch's (row-major) tap order; weight (Cout, Cin, kh, kw) OIHW; mask
    (B, Ho, Wo, K) or None → float32 (B, Ho, Wo, Cout)."""
    return DeformConv2dFunction.apply(x, offsets, weight, mask, stride, padding, dilation)
