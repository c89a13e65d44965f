"""Multi-level ROIAlign pool: the port of
``afigan_tpu/ops/pallas/roi_pool.py::fused_window_pool`` (as driven by
``afigan_tpu/ops/roi_align.py::multilevel_roi_align_pallas``).

On a CUDA tensor: ``csrc/roi_pool.cu``, which samples the level maps in
place (no window, no pyramid concat, no overflow pass): a block per ROI and
group of output rows, 16-byte loads and stores over channel vectors where C
allows. On a CPU tensor:
the gather formulation of ``afigan_tpu/ops/roi_align.py::
multilevel_roi_align`` / ``_bilinear_gather``, batched over images.
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
