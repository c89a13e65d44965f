"""The (modulated) deformable conv's sampling and its adjoint on the card:
``csrc/deform_conv.cu``.

Not the port of a TPU kernel: ``afigan_tpu/ops/deform_conv.py::deform_conv2d``
is XLA code in the JAX package (four corner gathers and one einsum), trained
through XLA's autodiff. The conv is split as JAX writes it:

* ``deform_im2col``: the float32 columns (B*Ho*Wo, K*Cin), each output
  pixel's bilinear samples at ``p + p_k + offset_k`` (zeros outside the map),
  times the modulation mask, in (tap, channel) order, which is that of
  ``weight.permute(2, 3, 1, 0).reshape(K*Cin, Cout)``. The kernel samples a
  tile of output pixels at a time from x's window staged in shared memory
  (the adjoint's 4x8 tile and window); a corner outside the window is read
  from device memory, and the launches count those corners
  (``im2col_spill_counts``);
* the product of the columns with that matrix, ``torch.matmul`` in float32
  (the JAX einsum);
* ``deform_col2im``: from the columns' gradient, the gradients of x, of the
  offsets and of the mask, as ``jax.vjp`` of the JAX function gives them
  (``floor`` without a gradient: the forward difference at an integer
  coordinate; corners outside the map contribute nothing). The kernel sums
  x's gradient a tile of output pixels at a time over a window of cells,
  from the tile's column gradient staged in shared memory (4x8 pixels,
  ``csrc/deform_conv.cu``); a corner outside its tile's window goes to x's
  gradient in device memory directly, and the launches count those corners
  (``spill_counts``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version, explicit torch code: the four gathers for the
columns, ``index_add_`` and sums over the channels for the adjoint (not
autograd of the forward, so that it is a statement of JAX's VJP of its own).
``DeformConv2dFunction`` joins them under autograd. It saves the columns for
the backward instead of sampling again: one ``deform_conv`` launch a forward
and one ``deform_conv_bwd`` launch a backward, at the price of keeping the
float32 columns (3.5 GB a batch of 2 for the 30 convs of the deformable
ResNeSt-101 at 832x1344) until the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build
from ._build import LAUNCHES

# device → int64 (2,): corners inside the map that fell outside their tile's
# window, and all corners inside the map, over the adjoint's launches
_SPILL = {}


def out_size(h: int, w: int, kh: int, kw: int, stride: int, padding: int,
             dilation: int) -> Tuple[int, int]:
    return ((h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1,
            (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1)


def sample_grid(offsets, h: int, w: int, kh: int, kw: int, stride: int, padding: int,
                dilation: int):
    """offsets (B, Ho, Wo, 2K), (dy, dx) per tap in row-major tap order →
    (y0, x0) int64 corners and (ly, lx) float32 fractions, each (B, Ho, Wo, K):
    the sample point ``(oy*stride - pad + ky*dil + dy, ox*stride - pad +
    kx*dil + dx)`` in float32, its floor and what is left of it."""
    b, ho, wo = offsets.shape[:3]
    k = kh * kw
    dev = offsets.device
    f32 = torch.float32
    oy = torch.arange(ho, dtype=f32, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=f32, device=dev) * stride - padding
    ky = torch.arange(kh, dtype=f32, device=dev) * dilation
    kx = torch.arange(kw, dtype=f32, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(ho, wo, kh, kw)
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(ho, wo, kh, kw)
    off = offsets.float().reshape(b, ho, wo, k, 2)
    sy = base_y.reshape(ho, wo, k) + off[..., 0]
    sx = base_x.reshape(ho, wo, k) + off[..., 1]
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    return y0f.long(), x0f.long(), sy - y0f, sx - x0f


def _corners(x, y0, x0):
    """The four corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) of each
    sample: [(flat index into (B*H*W), inside the map)], (B, Ho, Wo, K) each."""
    b, h, w = x.shape[:3]
    img = torch.arange(b, device=x.device).reshape(b, 1, 1, 1) * (h * w)
    out = []
    for iy, ix in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        out.append((img + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1), inside))
    return out


def _take(flat, idx, inside):
    """(B*H*W, C) float32 rows at idx (B, Ho, Wo, K), zero outside the map →
    (B, Ho, Wo, K, C)."""
    v = flat[idx.reshape(-1)].reshape(*idx.shape, flat.shape[1])
    return torch.where(inside[..., None], v, v.new_zeros(()))


def deform_im2col_plain(x, offsets, mask=None, kernel_size=(3, 3), stride: int = 1,
                        padding: int = 1, dilation: int = 1):
    """``deform_im2col``'s function in torch: x (B, H, W, C) NHWC, offsets
    (B, Ho, Wo, 2K), mask (B, Ho, Wo, K) or None → float32 (B*Ho*Wo, K*C)."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    y0, x0, ly, lx = sample_grid(offsets, h, w, kh, kw, stride, padding, dilation)
    flat = x.float().reshape(b * h * w, c)
    (i00, in00), (i01, in01), (i10, in10), (i11, in11) = _corners(x, y0, x0)
    sampled = (_take(flat, i00, in00) * ((1 - ly) * (1 - lx))[..., None]
               + _take(flat, i01, in01) * ((1 - ly) * lx)[..., None]
               + _take(flat, i10, in10) * (ly * (1 - lx))[..., None]
               + _take(flat, i11, in11) * (ly * lx)[..., None])
    if mask is not None:
        sampled = sampled * mask.float()[..., None]
    return sampled.reshape(-1, kh * kw * c)


def deform_col2im_plain(grad_cols, x, offsets, mask=None, kernel_size=(3, 3),
                        stride: int = 1, padding: int = 1, dilation: int = 1):
    """``deform_col2im``'s function in torch: grad_cols (B*Ho*Wo, K*C) float32
    → (grad_x (B, H, W, C), grad_offsets (B, Ho, Wo, 2K), grad_mask
    (B, Ho, Wo, K) or None), all float32. ``jax.vjp`` of the JAX function,
    written out: with gm = g * mask, each corner's value moves the sample by
    its bilinear weight (``index_add_`` into x's gradient, nothing for a
    corner outside the map); the offsets move it by gm times the derivative
    of the bilinear form in ly / lx (``floor`` has none), summed over the
    channels; the mask by g times the unmasked sample."""
    b, h, w, c = x.shape
    kh, kw = kernel_size
    k = kh * kw
    y0, x0, ly, lx = sample_grid(offsets, h, w, kh, kw, stride, padding, dilation)
    ho, wo = y0.shape[1:3]
    flat = x.float().reshape(b * h * w, c)
    corners = _corners(x, y0, x0)
    v00, v01, v10, v11 = (_take(flat, i, inside) for i, inside in corners)
    g = grad_cols.float().reshape(b, ho, wo, k, c)
    gm = g if mask is None else g * mask.float()[..., None]
    hy, hx = (1 - ly)[..., None], (1 - lx)[..., None]
    ly_, lx_ = ly[..., None], lx[..., None]
    d_ly = (gm * (hx * (v10 - v00) + lx_ * (v11 - v01))).sum(-1)
    d_lx = (gm * (hy * (v01 - v00) + ly_ * (v11 - v10))).sum(-1)
    grad_off = torch.stack([d_ly, d_lx], dim=-1).reshape(b, ho, wo, 2 * k)
    grad_mask = None
    if mask is not None:
        sampled = v00 * hy * hx + v01 * hy * lx_ + v10 * ly_ * hx + v11 * ly_ * lx_
        grad_mask = (g * sampled).sum(-1)
    grad_x = torch.zeros((b * h * w, c), dtype=torch.float32, device=x.device)
    for (idx, inside), wt in zip(corners, (hy * hx, hy * lx_, ly_ * hx, ly_ * lx_)):
        contrib = torch.where(inside[..., None], gm * wt, gm.new_zeros(()))
        grad_x.index_add_(0, idx.reshape(-1), contrib.reshape(-1, c))
    return grad_x.reshape(b, h, w, c), grad_off, grad_mask


def _check(x, offsets, mask, kernel_size, stride, padding, dilation):
    """The dtypes, shapes and layouts the kernels take → (B, H, W, C,
    Ho, Wo); raises on anything else."""
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous NHWC (B, H, W, C), got {tuple(x.shape)} "
                         f"strides {x.stride()}")
    b, h, w, c = x.shape
    kh, kw = kernel_size
    if min(kh, kw, stride, dilation) < 1 or padding < 0:
        raise ValueError(f"kernel {kernel_size}, stride {stride}, padding {padding}, "
                         f"dilation {dilation}")
    ho, wo = out_size(h, w, kh, kw, stride, padding, dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output pixel for a {h}x{w} map")
    if tuple(offsets.shape) != (b, ho, wo, 2 * kh * kw):
        raise ValueError(f"offsets must be {(b, ho, wo, 2 * kh * kw)}, got "
                         f"{tuple(offsets.shape)}")
    if mask is not None and tuple(mask.shape) != (b, ho, wo, kh * kw):
        raise ValueError(f"mask must be {(b, ho, wo, kh * kw)}, got {tuple(mask.shape)}")
    for t in (x, offsets, mask):
        if t is not None:
            _build.dtype_code(t)
    return b, h, w, c, ho, wo


def _devices(*tensors):
    devs = {t.device.type for t in tensors if t is not None}
    if devs - {"cpu", "cuda"} or len(devs) != 1:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    return devs.pop()


def _strided(t):
    """(pointer, 4 element strides, dtype code) of an offsets or mask tensor,
    or nulls."""
    if t is None:
        return (None, 0, 0, 0, 0, 0)
    return (t.data_ptr(), *t.stride(), _build.dtype_code(t))


def deform_im2col(x, offsets, mask=None, kernel_size=(3, 3), stride: int = 1,
                  padding: int = 1, dilation: int = 1):
    """x (B, H, W, C) NHWC float32 or bf16 (contiguous on the card); offsets
    (B, Ho, Wo, 2K) (dy, dx) per tap in row-major tap order, float32 or bf16,
    any strides (the kernel reads them through their strides: the model's
    ``pred[..., :18]`` view is not copied); mask (B, Ho, Wo, K) or None, the
    same → the float32 columns (B*Ho*Wo, K*C). CUDA tensors: one launch of
    ``csrc/deform_conv.cu::deform_im2col``, equal to the plain version bit
    for bit; CPU tensors: ``deform_im2col_plain``."""
    if _devices(x, offsets, mask) == "cpu":
        return deform_im2col_plain(x, offsets, mask, kernel_size, stride, padding, dilation)
    b, h, w, c, ho, wo = _check(x, offsets, mask, kernel_size, stride, padding, dilation)
    kh, kw = kernel_size
    cols = torch.empty((b * ho * wo, kh * kw * c), dtype=torch.float32, device=x.device)
    rc = _build.load("deform_conv").deform_im2col(
        x.data_ptr(), _build.dtype_code(x), *_strided(offsets), *_strided(mask),
        cols.data_ptr(), b, h, w, c, ho, wo, kh, kw, stride, padding, dilation,
        _build.stream_ptr(x, offsets, mask, cols))
    _build.check(rc, "deform_im2col")
    LAUNCHES["deform_conv"] += 1
    return cols


def deform_col2im(grad_cols, x, offsets, mask=None, kernel_size=(3, 3), stride: int = 1,
                  padding: int = 1, dilation: int = 1):
    """The gradients of ``deform_im2col``'s columns, ``grad_cols`` (B*Ho*Wo,
    K*C) float32, with respect to x, the offsets and the mask: (grad_x
    (B, H, W, C), grad_offsets (B, Ho, Wo, 2K), grad_mask (B, Ho, Wo, K) or
    None), all float32 (the caller rounds them to its inputs' dtypes).
    CUDA tensors: one launch of ``csrc/deform_conv.cu::deform_col2im`` (x's
    gradient summed a tile's window at a time, then with float32 atomics
    into a zeroed scratch, so it differs from the plain version by summation
    order); CPU tensors: ``deform_col2im_plain``."""
    if _devices(grad_cols, x, offsets, mask) == "cpu":
        return deform_col2im_plain(grad_cols, x, offsets, mask, kernel_size, stride, padding,
                                   dilation)
    b, h, w, c, ho, wo = _check(x, offsets, mask, kernel_size, stride, padding, dilation)
    kh, kw = kernel_size
    k = kh * kw
    if grad_cols.dtype != torch.float32 or tuple(grad_cols.shape) != (b * ho * wo, k * c) \
            or not grad_cols.is_contiguous():
        raise ValueError(f"grad_cols must be contiguous float32 {(b * ho * wo, k * c)}, got "
                         f"{tuple(grad_cols.shape)} {grad_cols.dtype}")
    dev = x.device
    grad_x = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    grad_off = torch.empty((b, ho, wo, 2 * k), dtype=torch.float32, device=dev)
    grad_mask = None if mask is None else torch.empty((b, ho, wo, k), dtype=torch.float32,
                                                      device=dev)
    spill = _spill_counter(dev)
    rc = _build.load("deform_conv").deform_col2im(
        x.data_ptr(), _build.dtype_code(x), *_strided(offsets), *_strided(mask),
        grad_cols.data_ptr(), grad_x.data_ptr(), grad_off.data_ptr(), _build.ptr(grad_mask),
        b, h, w, c, ho, wo, kh, kw, stride, padding, dilation, spill.data_ptr(),
        _build.stream_ptr(grad_cols, x, offsets, mask, grad_x, grad_off, grad_mask, spill))
    _build.check(rc, "deform_col2im")
    LAUNCHES["deform_conv_bwd"] += 1
    return grad_x, grad_off, grad_mask


def _card(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _spill_counter(device):
    device = _card(device)
    t = _SPILL.get(device)
    if t is None:
        t = _SPILL[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return t


def reset_spill(device) -> None:
    """Zero the adjoint's corner counts on ``device``."""
    _spill_counter(device).zero_()


def spill_counts(device) -> Tuple[int, int]:
    """(corners inside the map that fell outside their tile's window, all
    corners inside the map) over the adjoint's launches on ``device`` since
    ``reset_spill``: the share that took device-memory atomics (reads the
    card)."""
    spilled, corners = _spill_counter(device).tolist()
    return int(spilled), int(corners)


def im2col_spill_counts(device, reset: bool = False) -> Tuple[int, int]:
    """(corners inside the map that fell outside their tile's window, all
    corners inside the map) over the sampling kernel's launches on
    ``device`` since the counts were last reset: the share that the kernel
    read from device memory instead of its staged window (reads the card;
    ``reset`` zeroes them after the reading)."""
    device = _card(device)
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        _build.check(_build.load("deform_conv").deform_im2col_spill(
            counts.data_ptr(), int(reset), _build.stream_ptr(counts)), "deform_im2col_spill")
    spilled, corners = counts.tolist()
    return int(spilled), int(corners)


def reset_im2col_spill(device) -> None:
    """Zero the sampling kernel's corner counts on ``device``."""
    im2col_spill_counts(device, reset=True)


def weight_matrix(weight):
    """OIHW (Cout, Cin, kh, kw) → float32 (kh*kw*Cin, Cout), the columns'
    (tap, channel) order."""
    cout, cin, kh, kw = weight.shape
    return weight.float().permute(2, 3, 1, 0).reshape(kh * kw * cin, cout)


class DeformConv2dFunction(torch.autograd.Function):
    """The deformable conv under autograd: the forward is ``deform_im2col``
    then ``cols @ weight_matrix(weight)`` (``torch.matmul``, float32); the
    backward ``grad_cols = grad_out @ wmat^T`` and ``grad_w = cols^T @
    grad_out`` (``torch.matmul``), then ``deform_col2im``. The columns are
    saved, not sampled again. Gradients come back in their inputs' dtypes.
    ``deform_im2col`` and ``deform_col2im`` are looked up in this module at
    each call (tests and ``chip_smoke.py`` wrap them)."""

    @staticmethod
    def forward(ctx, x, offsets, weight, mask, stride, padding, dilation):
        cout, _, kh, kw = weight.shape
        cols = deform_im2col(x, offsets, mask, (kh, kw), stride, padding, dilation)
        ho, wo = offsets.shape[1:3]
        out = torch.matmul(cols, weight_matrix(weight)).view(x.shape[0], ho, wo, cout)
        ctx.save_for_backward(x, offsets, weight, mask, cols)
        ctx.conf = (stride, padding, dilation)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        x, offsets, weight, mask, cols = ctx.saved_tensors
        stride, padding, dilation = ctx.conf
        cout, cin, kh, kw = weight.shape
        g = grad_out.float().reshape(-1, cout)
        gx = goff = gw = gmask = None
        if ctx.needs_input_grad[2]:
            gw = torch.matmul(cols.t(), g).reshape(kh, kw, cin, cout).permute(3, 2, 0, 1)
            gw = gw.to(weight.dtype)
        if any(ctx.needs_input_grad[i] for i in (0, 1, 3)):
            grad_cols = torch.matmul(g, weight_matrix(weight).t())
            gx, goff, gmask = deform_col2im(grad_cols, x, offsets, mask, (kh, kw), stride,
                                            padding, dilation)
            gx, goff = gx.to(x.dtype), goff.to(offsets.dtype)
            gmask = None if gmask is None else gmask.to(mask.dtype)
        return gx, goff, gw, gmask, None, None, None


def deform_conv2d_plain(x, offsets, weight, mask=None, stride: int = 1, padding: int = 1,
                        dilation: int = 1):
    """The whole conv in plain torch (the columns, then the product), whose
    autograd is the reference of ``DeformConv2dFunction``'s backward."""
    cout, _, kh, kw = weight.shape
    ho, wo = offsets.shape[1:3]
    cols = deform_im2col_plain(x, offsets, mask, (kh, kw), stride, padding, dilation)
    return torch.matmul(cols, weight_matrix(weight)).view(x.shape[0], ho, wo, cout)
