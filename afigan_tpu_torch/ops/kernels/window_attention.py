"""Swin window attention: the port of
``afigan_tpu/ops/pallas/window_attention.py::fused_window_attention``.

    softmax(q k^T * scale + bias[h] (+ mask[i % NW])) v

with f32 scores, the probabilities rounded to the model dtype before the
product with v, and f32 accumulation. On a CUDA tensor:
``csrc/window_attention.cu`` (bfloat16 on the tensor cores, float32 on the
CUDA cores; the scores never reach device memory). On a CPU tensor: the
plain version below.

q, k and v may be views: the kernel reads them through their window, head
and token strides (the head dimension contiguous), so ``models/swin.py``
passes slices of the packed output of its qkv linear, and the result is a
(BNW, NH, N, D) view of a (BNW, N, NH, D) buffer, the layout the output
projection reads.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import LAUNCHES

HEAD_DIM = 32   # the kernel's head dimension (every Swin stage)
MAX_TOKENS = 160  # the kernel's largest window (N = 144 at window 12)


def fused_window_attention_plain(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                                 *, scale: float):
    bnw, nh, n, _ = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bnw // nw, nw, nh, n, n) + mask.float()[None, :, None]
             ).reshape(bnw, nh, n, n)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def fused_window_attention(q, k, v, bias, mask: Optional[torch.Tensor] = None,
                           *, scale: float):
    """q, k, v: (BNW, NH, N, D) float32 or bfloat16, contiguous or views with
    the last stride 1 and a 16-byte-aligned base and strides; bias (NH, N, N);
    mask None or (NW, N, N) with NW dividing BNW, window i using mask[i % NW]
    (the batched layout of ``window_partition``). Returns (BNW, NH, N, D) in
    q's dtype; on the card a view of a (BNW, N, NH, D) buffer."""
    tensors = [t for t in (q, k, v, bias, mask) if t is not None]
    devs = {t.device.type for t in tensors}
    if q.dim() != 4:
        raise ValueError(f"q must be (BNW, NH, N, D), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} vs q {tuple(q.shape)} {q.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last dimension must be contiguous, got strides "
                             f"{t.stride()}")
    if devs == {"cpu"}:
        return fused_window_attention_plain(q, k, v, bias, mask, scale=scale)
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    dcode = _build.dtype_code(q)
    bnw, nh, n, d = q.shape
    if d != HEAD_DIM or not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} and up to {MAX_TOKENS} "
                         f"tokens a window, got D={d}, N={n}")
    if tuple(bias.shape) != (nh, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} != {(nh, n, n)}")
    nw = 1
    if mask is not None:
        nw = mask.shape[0]
        if tuple(mask.shape) != (nw, n, n) or bnw % nw:
            raise ValueError(f"mask {tuple(mask.shape)} for {bnw} windows of {n} tokens")
        mask = mask.float().contiguous()
    bias = bias.float().contiguous()
    out = torch.empty((bnw, n, nh, d), device=q.device, dtype=q.dtype).permute(0, 2, 1, 3)
    if bnw == 0:
        return out
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        st = t.stride()[:3]
        if t.data_ptr() % 16 or any((x * t.element_size()) % 16 for x in st):
            raise ValueError(f"{name}: base and strides must be multiples of 16 bytes, got "
                             f"offset {t.data_ptr() % 16}, strides {t.stride()}")
        strides += [st[0], st[1], st[2]]
    lib = _build.load("window_attention")
    rc = lib.window_attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      bias.data_ptr(), _build.ptr(mask), out.data_ptr(),
                                      (ctypes.c_longlong * 12)(*strides), bnw, nh, n, d, nw,
                                      float(scale), dcode,
                                      _build.stream_ptr())
    _build.check(rc, "window_attention_forward")
    LAUNCHES["window_attention"] += 1
    return out
