"""AF-interpolator kernels: the generator chain, one dense block on its own,
and the conv-upsample tail.

Port of ``afigan_tpu/ops/pallas/afi_chain.py::fused_generator_chain``,
``afigan_tpu/ops/pallas/afi_rdb.py::fused_rdb`` and
``afigan_tpu/ops/pallas/afi_upsample.py::fused_upsample``. Public
functions take NHWC activations (the JAX functions' layout) and the
module's torch-layout weights (conv OIHW, transposed conv IOHW).

On a CUDA tensor every convolution is a launch of a hand-written kernel
(``csrc/afi_conv3x3.cu``, ``csrc/afi_upsample.cu``); on a CPU tensor the
plain PyTorch version (``F.conv2d`` over a real ``torch.cat``,
``F.conv_transpose2d``, ``F.interpolate``) runs instead. Nothing else
selects between them, and there is no fallback on CUDA.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build
from ._build import LAUNCHES

# ---------------------------------------------------------------------------
# one 3x3 conv with the fused epilogue
# ---------------------------------------------------------------------------


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv3x3_plain(srcs, weight, bias=None, leaky=False, res1=None, s1=1.0,
                  res2=None, s2=1.0, skip=None):
    """out = [res2 + s2*] ([res1 + s1*] act(conv(cat(srcs)) + bias)) [+ up2(skip)]."""
    x = srcs[0] if len(srcs) == 1 else torch.cat(list(srcs), dim=-1)
    dt = x.dtype
    v = F.conv2d(_nchw(x), weight.to(dt), None if bias is None else bias.to(dt),
                 padding=1)
    v = _nhwc(v)
    if leaky:
        v = F.leaky_relu(v, 0.2)
    if res1 is not None:
        v = res1 + s1 * v
    if res2 is not None:
        v = res2 + s2 * v
    if skip is not None:
        up = F.interpolate(_nchw(skip), scale_factor=2, mode="bilinear",
                           align_corners=False)
        v = v + _nhwc(up)
    return v.contiguous()


def _check_act(t, like, name):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name}: device/dtype {t.device}/{t.dtype} != "
                         f"{like.device}/{like.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous NHWC")


def _kernel_layout(w9, dtype):
    """(..., 9, Cin, Cout) tap-major weights → the layout the kernel for
    ``dtype`` reads: as is for the float32 kernel; (..., 9, Cout, Cin), k
    contiguous (the tensor-core B operand), for the bfloat16 kernel."""
    w9 = w9.to(dtype)
    if dtype == torch.bfloat16:
        w9 = w9.transpose(-1, -2)
    return w9.contiguous()


def _on_cpu(tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


def conv3x3(srcs: Sequence[torch.Tensor], weight, bias=None, leaky=False,
            res1=None, s1=1.0, res2=None, s2=1.0, skip=None,
            counter: str = "afi_chain"):
    """3x3 stride-1 zero-padded conv of the channel concatenation of
    ``srcs`` (NHWC, up to 5) with ``weight`` (Cout, sum Cin, 3, 3), plus
    the fused epilogue of ``conv3x3_plain``. Returns NHWC (B, H, W, Cout)."""
    srcs = list(srcs)
    if _on_cpu([*srcs, weight, bias, res1, res2, skip]):
        return conv3x3_plain(srcs, weight, bias, leaky, res1, s1, res2, s2, skip)
    x0 = srcs[0]
    dcode = _build.dtype_code(x0)
    if not 1 <= len(srcs) <= 5:
        raise ValueError(f"1..5 sources, got {len(srcs)}")
    b, h, w, _ = x0.shape
    for i, s in enumerate(srcs):
        _check_act(s, x0, f"srcs[{i}]")
        if s.dim() != 4 or tuple(s.shape[:3]) != (b, h, w):
            raise ValueError(f"srcs[{i}] shape {tuple(s.shape)} vs {(b, h, w)}")
    cin = sum(int(s.shape[-1]) for s in srcs)
    cout = int(weight.shape[0])
    if tuple(weight.shape) != (cout, cin, 3, 3):
        raise ValueError(f"weight {tuple(weight.shape)} != {(cout, cin, 3, 3)}")
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(cout,)}")
    out = torch.empty((b, h, w, cout), device=x0.device, dtype=x0.dtype)
    for name, r in (("res1", res1), ("res2", res2)):
        if r is not None:
            _check_act(r, x0, name)
            if r.shape != out.shape:
                raise ValueError(f"{name} shape {tuple(r.shape)} != {tuple(out.shape)}")
    if skip is not None:
        _check_act(skip, x0, "skip")
        if h % 2 or w % 2 or tuple(skip.shape) != (b, h // 2, w // 2, cout):
            raise ValueError(f"skip shape {tuple(skip.shape)} for output {(b, h, w, cout)}")
    wk = _kernel_layout(weight.permute(2, 3, 1, 0).reshape(9, cin, cout), x0.dtype)
    bk = None if bias is None else bias.to(x0.dtype).contiguous()
    lib = _build.load("afi_conv3x3")
    ptrs = (ctypes.c_void_p * 5)(*[s.data_ptr() for s in srcs])
    chans = (ctypes.c_int * 5)(*[int(s.shape[-1]) for s in srcs])
    rc = lib.afi_conv3x3(ptrs, chans, len(srcs), wk.data_ptr(), _build.ptr(bk),
                         _build.ptr(res1), float(s1), _build.ptr(res2), float(s2),
                         _build.ptr(skip), out.data_ptr(), b, h, w, cout,
                         int(bool(leaky)), dcode, _build.stream_ptr())
    _build.check(rc, "afi_conv3x3")
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# ConvTranspose(k6, s2, p2) as 4 subpixel phases
# ---------------------------------------------------------------------------

# output parity d reads the flipped kernel's taps m with m = pp - d (mod 2),
# pp = k - 1 - p = 3 (afi_upsample.py: sel = {0: [1,3,5], 1: [0,2,4]})
_SEL = {0: [1, 3, 5], 1: [0, 2, 4]}


def phase_kernels(w_iohw: torch.Tensor) -> torch.Tensor:
    """(Cin, Cout, 6, 6) ConvTranspose weight → (4, 9, Cin, Cout) phase
    kernels, phase = 2*dy + dx."""
    wf = torch.flip(w_iohw.permute(2, 3, 0, 1), (0, 1))  # flipped HWIO
    phases = []
    for dy in (0, 1):
        for dx in (0, 1):
            wp = wf[_SEL[dy]][:, _SEL[dx]]  # (3, 3, Cin, Cout)
            phases.append(wp.reshape(9, *wp.shape[2:]))
    return torch.stack(phases)


def subpixel_deconv_plain(x, w_iohw, bias, leaky=True):
    dt = x.dtype
    y = F.conv_transpose2d(_nchw(x), w_iohw.to(dt),
                           None if bias is None else bias.to(dt),
                           stride=2, padding=2)
    y = _nhwc(y)
    if leaky:
        y = F.leaky_relu(y, 0.2)
    return y.contiguous()


def subpixel_deconv(x, w_iohw, bias, leaky=True, counter="afi_upsample"):
    """ConvTranspose2d(k=6, s=2, p=2) (+ bias, LReLU): (B,H,W,Cin) →
    (B,2H,2W,Cout), computed as 4 dense 3x3 phase convolutions."""
    if _on_cpu([x, w_iohw, bias]):
        return subpixel_deconv_plain(x, w_iohw, bias, leaky)
    dcode = _build.dtype_code(x)
    if not x.is_contiguous() or x.dim() != 4:
        raise ValueError("x must be contiguous NHWC")
    b, h, w, cin = x.shape
    if tuple(w_iohw.shape[0:1]) != (cin,) or tuple(w_iohw.shape[2:]) != (6, 6):
        raise ValueError(f"weight {tuple(w_iohw.shape)} for Cin={cin}, k=6")
    cout = int(w_iohw.shape[1])
    if bias is not None and tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} != {(cout,)}")
    wk = _kernel_layout(phase_kernels(w_iohw), x.dtype)
    bk = None if bias is None else bias.to(x.dtype).contiguous()
    out = torch.empty((b, 2 * h, 2 * w, cout), device=x.device, dtype=x.dtype)
    lib = _build.load("afi_upsample")
    rc = lib.afi_subpixel_deconv(x.data_ptr(), wk.data_ptr(), _build.ptr(bk),
                                 out.data_ptr(), b, h, w, cin, cout,
                                 int(bool(leaky)), dcode, _build.stream_ptr())
    _build.check(rc, "afi_subpixel_deconv")
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# the two JAX-kernel counterparts
# ---------------------------------------------------------------------------


def _rdb(conv, y, ws, rs, res2=None, s2=1.0):
    """One residual dense block: four convs + LReLU over the growing list of
    sources (the dense concat, never materialised by the kernel), then
    y + rs * conv5; ``res2 + s2 *`` that where the caller folds an outer
    residual in."""
    feats = [y]
    for w_ in ws[:4]:
        feats.append(conv(feats, w_, None, leaky=True))
    return conv(feats, ws[4], None, leaky=False, res1=y, s1=rs, res2=res2, s2=s2)


def _chain(conv, x, head_w, head_b, rdb_weights, residual_scale):
    if not rdb_weights:
        raise ValueError("the chain needs at least one dense block")
    head = conv([x.contiguous()], head_w, head_b, leaky=True)
    y = head
    for i, ws in enumerate(rdb_weights):
        last = i == len(rdb_weights) - 1
        # the last block also folds the RiR residual in
        y = _rdb(conv, y, ws, residual_scale, head if last else None, residual_scale)
    return y


def fused_rdb(x, weights, residual_scale=0.2, outer=None, outer_scale=1.0):
    """One residual dense block (the port of
    ``afigan_tpu/ops/pallas/afi_rdb.py::fused_rdb``): x (B, H, W, C);
    weights [w1..w5], w_i (G, C+(i-1)G, 3, 3), w5 (C, C+4G, 3, 3) →
    y = x + residual_scale * conv5(cat(x, c1..c4)), or
    outer + outer_scale * y where the caller folds an outer residual (the
    RiR's) into the last conv's epilogue. Five launches of the conv kernel
    on the card."""
    conv = functools.partial(conv3x3, counter="afi_rdb")
    return _rdb(conv, x.contiguous(), list(weights), residual_scale, outer, outer_scale)


def fused_rdb_plain(x, weights, residual_scale=0.2, outer=None, outer_scale=1.0):
    """The plain version on any device: ``F.conv2d`` over real concats."""
    return _rdb(conv3x3_plain, x, list(weights), residual_scale, outer, outer_scale)


def fused_generator_chain(x, head_w, head_b, rdb_weights, residual_scale=0.2):
    """head conv + n residual dense blocks + RiR residual.

    x: (B, H, W, C); head_w (C, C, 3, 3), head_b (C,); rdb_weights: per
    block [w1..w5], w_i (G, C+(i-1)G, 3, 3), w5 (C, C+4G, 3, 3).
    Returns r = head + s * RDB_n(..RDB_1(head)) (fused_upsample's input).
    """
    return _chain(conv3x3, x, head_w, head_b, rdb_weights, residual_scale)


def fused_generator_chain_plain(x, head_w, head_b, rdb_weights, residual_scale=0.2):
    """The plain version on any device: ``F.conv2d`` over real concats."""
    return _chain(conv3x3_plain, x, head_w, head_b, rdb_weights, residual_scale)


def fused_upsample(r, x, wmid, bmid, wup, bup, wtail, btail):
    """mid conv+LReLU → ConvTranspose(k6,s2,p2)+LReLU → tail conv + bilinear
    x2 skip of ``x``: (B,H,W,C) → (B,2H,2W,C)."""
    r = r.contiguous()
    x = x.contiguous()
    y = conv3x3([r], wmid, bmid, leaky=True, counter="afi_upsample")
    z = subpixel_deconv(y, wup, bup, leaky=True)
    return conv3x3([z], wtail, btail, leaky=False, skip=x, counter="afi_upsample")


def fused_upsample_plain(r, x, wmid, bmid, wup, bup, wtail, btail):
    """The plain version on any device (conv2d → conv_transpose2d → conv2d
    + F.interpolate bilinear skip)."""
    y = conv3x3_plain([r], wmid, bmid, leaky=True)
    z = subpixel_deconv_plain(y, wup, bup, leaky=True)
    return conv3x3_plain([z], wtail, btail, leaky=False, skip=x)
