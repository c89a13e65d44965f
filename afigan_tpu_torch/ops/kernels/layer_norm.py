"""LayerNorm over the last axis: the port of
``afigan_tpu/ops/pallas/layer_norm.py::fused_layer_norm``.

On a CUDA tensor: ``csrc/layer_norm.cu`` (one warp per row, one read and one
write of the row). On a CPU tensor: the plain version below, the same
formula op for op (f32 mean and E[x^2], ``var = max(0, E[x^2] - mean^2)``),
which is not ``F.layer_norm``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._build import LAUNCHES


def fused_layer_norm_plain(x, scale, bias, eps: float = 1e-5,
                           out_dtype: Optional[torch.dtype] = None):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * scale.float()) + bias.float()
    return y.to(out_dtype or x.dtype)


def fused_layer_norm(x, scale, bias, eps: float = 1e-5,
                     out_dtype: Optional[torch.dtype] = None):
    """x (..., C) float32 or bfloat16; scale, bias (C,) → (..., C) in
    ``out_dtype`` (default: x's)."""
    devs = {t.device.type for t in (x, scale, bias)}
    if devs == {"cpu"}:
        return fused_layer_norm_plain(x, scale, bias, eps, out_dtype)
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    out_dtype = out_dtype or x.dtype
    c = x.shape[-1]
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale {tuple(scale.shape)} / bias {tuple(bias.shape)} != {(c,)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty(x.shape, device=x.device, dtype=out_dtype)
    rows = x.numel() // c
    if rows == 0:
        return out
    sc = scale.detach().float().contiguous()
    bi = bias.detach().float().contiguous()
    lib = _build.load("layer_norm")
    rc = lib.layer_norm_forward(x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                                out.data_ptr(), rows, c, float(eps),
                                _build.dtype_code(x), _build.dtype_code(out_dtype),
                                _build.stream_ptr())
    _build.check(rc, "layer_norm_forward")
    LAUNCHES["layer_norm"] += 1
    return out
