"""Multi-level ROIAlign pool: the port of
``afigan_tpu/ops/pallas/roi_pool.py::fused_window_pool`` (as driven by
``afigan_tpu/ops/roi_align.py::multilevel_roi_align_pallas``), and its
backward, the port of that function's custom VJP
(``_pallas_pool_bwd_dense``, XLA code in the JAX package).

On a CUDA tensor: ``csrc/roi_pool.cu``, which samples the level maps in
place (no window, no pyramid concat, no overflow pass): a block per ROI and
group of output rows, 16-byte loads and stores over channel vectors where C
allows. On a CPU tensor:
the gather formulation of ``afigan_tpu/ops/roi_align.py::
multilevel_roi_align`` / ``_bilinear_gather``, batched over images.

``roi_pool_backward`` gives the level maps' gradient (the boxes get none): on
CUDA tensors ``csrc/roi_pool.cu::roi_pool_backward`` (float32 atomics into one
zeroed buffer, cast once to the levels' dtype); on CPU tensors
``roi_pool_backward_plain``, ``torch.autograd.grad`` through the gather (an
indexed scatter). ``RoIPool`` joins the two under autograd.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from ._build import LAUNCHES

# (output rows a block, threads a block) of the kernel; 0 lets
# ``csrc/roi_pool.cu::roi_pool_forward`` pick them from the shapes. Tests
# and ``tools/kernel_sweep.py`` set them to time or check another split.
SPLIT = (0, 0)


def _sample_coords(boxes, scales, p: int, s: int, aligned: bool):
    """(N, 4) boxes, (N,) scales → (N, P, P, S, S) y and x sample coords."""
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * scales - off
    y1 = boxes[:, 1] * scales - off
    x2 = boxes[:, 2] * scales - off
    y2 = boxes[:, 3] * scales - off
    rw, rh = x2 - x1, y2 - y1
    if not aligned:
        rw = torch.clamp(rw, min=1.0)
        rh = torch.clamp(rh, min=1.0)
    bw, bh = rw / p, rh / p
    pg = torch.arange(p, dtype=boxes.dtype, device=boxes.device)
    sg = (torch.arange(s, dtype=boxes.dtype, device=boxes.device) + 0.5) / s
    ys = y1[:, None, None, None, None] + (
        pg[None, :, None, None, None] + sg[None, None, None, :, None]
    ) * bh[:, None, None, None, None]
    xs = x1[:, None, None, None, None] + (
        pg[None, None, :, None, None] + sg[None, None, None, None, :]
    ) * bw[:, None, None, None, None]
    n = boxes.shape[0]
    return ys.expand(n, p, p, s, s), xs.expand(n, p, p, s, s)


def roi_pool_plain(features: Sequence[torch.Tensor], boxes, levels,
                   strides: Sequence[int], output_size: int,
                   sampling_ratio: int = 2, aligned: bool = True):
    """Gather formulation (the JAX ``_bilinear_gather``), batched over B."""
    b, r = boxes.shape[:2]
    c = features[0].shape[-1]
    dev = boxes.device
    hs = torch.tensor([f.shape[1] for f in features], device=dev)
    ws = torch.tensor([f.shape[2] for f in features], device=dev)
    sizes = hs * ws
    offs = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum())
    flat = torch.cat([f.reshape(b, -1, c) for f in features], dim=1)
    flat = flat.reshape(b * total, c)

    n = b * r
    bx = boxes.reshape(n, 4).float()
    lv = levels.reshape(n).long()
    scales = torch.tensor([1.0 / st for st in strides], dtype=torch.float32,
                          device=dev)[lv]
    ys, xs = _sample_coords(bx, scales, output_size, sampling_ratio, aligned)
    shp = (n, 1, 1, 1, 1)
    h = hs[lv].reshape(shp)
    w = ws[lv].reshape(shp)
    base = (offs[lv] + torch.arange(b, device=dev).repeat_interleave(r) * total
            ).reshape(shp)

    empty = (ys < -1.0) | (ys > h.float()) | (xs < -1.0) | (xs > w.float())
    y = torch.clamp(ys, min=0.0)
    x = torch.clamp(xs, min=0.0)
    y_low = torch.minimum(torch.floor(y).long(), h - 1)
    x_low = torch.minimum(torch.floor(x).long(), w - 1)
    y_high = torch.minimum(y_low + 1, h - 1)
    x_high = torch.minimum(x_low + 1, w - 1)
    y = torch.minimum(y, (h - 1).float())
    x = torch.minimum(x, (w - 1).float())
    ly = y - y_low.float()
    lx = x - x_low.float()
    hy, hx = 1.0 - ly, 1.0 - lx

    def take(yy, xx):
        return flat[(base + yy * w + xx).reshape(-1)].reshape(*yy.shape, c).float()

    out = ((hy * hx)[..., None] * take(y_low, x_low)
           + (hy * lx)[..., None] * take(y_low, x_high)
           + (ly * hx)[..., None] * take(y_high, x_low)
           + (ly * lx)[..., None] * take(y_high, x_high))
    out = torch.where(empty[..., None], torch.zeros((), device=dev), out)
    p = output_size
    return out.mean(dim=(3, 4)).reshape(b, r, p, p, c)


def roi_pool(features: Sequence[torch.Tensor], boxes, levels,
             strides: Sequence[int], output_size: int,
             sampling_ratio: int = 2, aligned: bool = True):
    """features: per level (B, H_l, W_l, C) NHWC; boxes (B, R, 4) float32
    image coords; levels (B, R) int level index in [0, len(features)), as
    ``ops/roi_align.py::assign_boxes_to_levels`` gives it → (B, R, P, P, C)
    float32."""
    feats = list(features)
    devs = {t.device.type for t in (*feats, boxes, levels)}
    if devs == {"cpu"}:
        return roi_pool_plain(feats, boxes, levels, strides, output_size,
                              sampling_ratio, aligned)
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    _build.refuse_grad("roi_pool", *feats, boxes)
    f0 = feats[0]
    dcode = _build.dtype_code(f0)
    b, c = f0.shape[0], f0.shape[-1]
    if len(feats) != len(strides) or not 1 <= len(feats) <= 8:
        raise ValueError("one stride per level, 1..8 levels")
    for i, f in enumerate(feats):
        if f.dtype != f0.dtype or f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {i}: {tuple(f.shape)} {f.dtype} vs level 0")
        if not f.is_contiguous():
            raise ValueError(f"level {i} must be contiguous NHWC")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[0] != b \
            or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be float32 (B, R, 4), got {tuple(boxes.shape)}")
    r = boxes.shape[1]
    if tuple(levels.shape) != (b, r):
        raise ValueError(f"levels {tuple(levels.shape)} != {(b, r)}")
    p = output_size
    out = torch.empty((b, r, p, p, c), device=f0.device, dtype=torch.float32)
    if b * r == 0:
        return out
    bx = boxes.contiguous()
    lv = levels.to(torch.int32).contiguous()
    nl = len(feats)
    lib = _build.load("roi_pool")
    rc = lib.roi_pool_forward(
        (ctypes.c_void_p * nl)(*[f.data_ptr() for f in feats]),
        (ctypes.c_int * nl)(*[int(f.shape[1]) for f in feats]),
        (ctypes.c_int * nl)(*[int(f.shape[2]) for f in feats]),
        (ctypes.c_float * nl)(*[1.0 / s for s in strides]),
        nl, bx.data_ptr(), lv.data_ptr(), out.data_ptr(),
        b * r, r, c, p, sampling_ratio, int(bool(aligned)), dcode, *SPLIT,
        _build.stream_ptr())
    _build.check(rc, "roi_pool_forward")
    LAUNCHES["roi_pool"] += 1
    return out


def roi_pool_backward_plain(features: Sequence[torch.Tensor], boxes, levels, grad,
                            strides: Sequence[int], output_size: int,
                            sampling_ratio: int = 2, aligned: bool = True):
    """``torch.autograd.grad`` of ``roi_pool_plain``'s output against ``grad``
    with respect to the levels: one tensor per level, in its dtype. The levels
    go in as float32 copies (the same values: the pool reads bfloat16 as
    float32), so the gather's scatter sums in float32 and rounds once, as the
    JAX adjoint does (``acc.astype(f.dtype)``)."""
    with torch.enable_grad():
        leaves = [f.detach().float().requires_grad_(True) for f in features]
        out = roi_pool_plain(leaves, boxes, levels, strides, output_size,
                             sampling_ratio, aligned)
        grads = torch.autograd.grad(out, leaves, grad)
    return [g.to(f.dtype) for g, f in zip(grads, features)]


def roi_pool_backward(features: Sequence[torch.Tensor], boxes, levels, grad,
                      strides: Sequence[int], output_size: int,
                      sampling_ratio: int = 2, aligned: bool = True):
    """Gradient of ``roi_pool``'s (B, R, P, P, C) float32 output, ``grad``,
    with respect to each level (B, H_l, W_l, C), returned in the levels' dtype.
    Only the levels' shapes, dtype and device are read on the card."""
    feats = list(features)
    devs = {t.device.type for t in (*feats, boxes, levels, grad)}
    if devs == {"cpu"}:
        return roi_pool_backward_plain(feats, boxes, levels, grad, strides, output_size,
                                       sampling_ratio, aligned)
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    f0 = feats[0]
    dcode = _build.dtype_code(f0)
    b, c = f0.shape[0], f0.shape[-1]
    if len(feats) != len(strides) or not 1 <= len(feats) <= 8:
        raise ValueError("one stride per level, 1..8 levels")
    for i, f in enumerate(feats):
        if f.dtype != f0.dtype or f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level {i}: {tuple(f.shape)} {f.dtype} vs level 0")
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[0] != b \
            or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be float32 (B, R, 4), got {tuple(boxes.shape)}")
    r, p = boxes.shape[1], output_size
    if tuple(levels.shape) != (b, r):
        raise ValueError(f"levels {tuple(levels.shape)} != {(b, r)}")
    if grad.dtype != torch.float32 or tuple(grad.shape) != (b, r, p, p, c):
        raise ValueError(f"grad must be float32 {(b, r, p, p, c)}, got "
                         f"{tuple(grad.shape)} {grad.dtype}")
    if b * r == 0:  # nothing to scatter: no launch
        return [torch.zeros_like(f) for f in feats]
    sizes = [f.numel() for f in feats]
    offs = [sum(sizes[:i]) for i in range(len(feats))]
    acc = torch.zeros(sum(sizes), device=f0.device, dtype=torch.float32)
    out = acc if dcode == 0 else torch.empty(sum(sizes), device=f0.device, dtype=f0.dtype)
    g = grad.contiguous()
    bx = boxes.contiguous()
    lv = levels.to(torch.int32).contiguous()
    nl = len(feats)
    lib = _build.load("roi_pool")
    rc = lib.roi_pool_backward(
        acc.data_ptr(), (ctypes.c_longlong * nl)(*offs),
        (ctypes.c_int * nl)(*[int(f.shape[1]) for f in feats]),
        (ctypes.c_int * nl)(*[int(f.shape[2]) for f in feats]),
        (ctypes.c_float * nl)(*[1.0 / s for s in strides]),
        nl, bx.data_ptr(), lv.data_ptr(), g.data_ptr(),
        None if dcode == 0 else out.data_ptr(), sum(sizes), b * r, r, c, p,
        sampling_ratio, int(bool(aligned)), dcode, *SPLIT, _build.stream_ptr())
    _build.check(rc, "roi_pool_backward")
    LAUNCHES["roi_pool_bwd"] += 1
    return [out[o:o + n].view(f.shape) for o, n, f in zip(offs, sizes, feats)]


class RoIPool(torch.autograd.Function):
    """``roi_pool`` under autograd: the forward is the pool (kernel or plain
    version by device), the backward ``roi_pool_backward``; the boxes and the
    levels get no gradient (JAX's custom VJP returns zeros for the boxes: the
    detector stops the proposals' gradient)."""

    @staticmethod
    def forward(ctx, boxes, levels, strides, output_size, sampling_ratio, aligned,
                *features):
        ctx.save_for_backward(boxes, levels, *features)
        ctx.args = (tuple(strides), output_size, sampling_ratio, aligned)
        return roi_pool(features, boxes, levels, strides, output_size, sampling_ratio,
                        aligned)

    @staticmethod
    def backward(ctx, grad):
        boxes, levels, *features = ctx.saved_tensors
        grads = roi_pool_backward(features, boxes, levels, grad.float(), *ctx.args)
        return (None,) * 6 + tuple(grads)
