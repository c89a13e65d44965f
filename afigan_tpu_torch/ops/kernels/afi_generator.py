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

``conv3x3`` and ``subpixel_deconv`` are one launch each. The three JAX-kernel
counterparts enqueue all their launches (16, 5 and 3) from one call into the
library, which repeats the wiring of ``_chain`` / ``_rdb`` below on the host
in C: between two launches of a small pyramid level the interpreter would
otherwise take longer than the kernel. The weights reach the kernels tap-major
(``lay_out_conv``, ``lay_out_deconv``); ``models/afi/generator.py`` keeps them
so (``lay_out_generator``) and passes them as ``laid``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import _build
from ._build import LAUNCHES

# The bfloat16 kernel's tiling: -1 lets the launcher pick it from the shapes
# (csrc/afi_conv_common.cuh::launch_conv3x3); tests and sweeps set an index of
# its table to force one.
TILING = -1

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


def lay_out_conv(weight, bias, dtype):
    """A conv's torch-layout (Cout, Cin, 3, 3) weight and (Cout,) bias or
    None → (tap-major kernel weight, bias in ``dtype``), what ``conv3x3``
    hands the kernel."""
    cout, cin = weight.shape[:2]
    wk = _kernel_layout(weight.detach().permute(2, 3, 1, 0).reshape(9, cin, cout), dtype)
    return wk, None if bias is None else bias.detach().to(dtype).contiguous()


def lay_out_deconv(w_iohw, bias, dtype):
    """A ConvTranspose2d(k6, s2, p2) weight (Cin, Cout, 6, 6) → (the four
    phase kernels (4, 9, ..) in the kernel's layout, bias in ``dtype``)."""
    wk = _kernel_layout(phase_kernels(w_iohw.detach()), dtype)
    return wk, None if bias is None else bias.detach().to(dtype).contiguous()


class GeneratorLayout(NamedTuple):
    """A generator's weights as the kernels read them, each entry a (weight,
    bias) pair of ``lay_out_conv`` / ``lay_out_deconv``."""
    head: tuple
    rdbs: list  # per block, five pairs
    mid: tuple
    up: tuple
    tail: tuple

    def upsample(self):
        return self.mid, self.up, self.tail


def lay_out_generator(head_w, head_b, rdb_weights, wmid, bmid, wup, bup, wtail, btail,
                      dtype) -> GeneratorLayout:
    """Every weight of a generator, torch layout → kernel layout for
    ``dtype``. The module keeps the result between forwards; the public
    functions below take its parts as ``laid`` and otherwise lay out on every
    call."""
    return GeneratorLayout(
        head=lay_out_conv(head_w, head_b, dtype),
        rdbs=[[lay_out_conv(w, None, dtype) for w in ws] for ws in rdb_weights],
        mid=lay_out_conv(wmid, bmid, dtype),
        up=lay_out_deconv(wup, bup, dtype),
        tail=lay_out_conv(wtail, btail, dtype))


def _check_laid(wk, bk, shape9, bias, x):
    """A laid-out (weight, bias) pair against the conv it is passed for:
    ``shape9`` is (..., 9, Cin, Cout), the float32 kernel's layout."""
    want = shape9 if x.dtype == torch.float32 else (*shape9[:-2], shape9[-1], shape9[-2])
    if (tuple(wk.shape) != tuple(want) or wk.dtype != x.dtype or wk.device != x.device
            or not wk.is_contiguous()):
        raise ValueError(f"laid-out weight {tuple(wk.shape)} {wk.dtype} on {wk.device}, "
                         f"expected {tuple(want)} {x.dtype} on {x.device}")
    if (bk is None) != (bias is None) or (bk is not None and (
            bk.dtype != x.dtype or bk.device != x.device or bk.shape != bias.shape)):
        raise ValueError("laid-out bias does not match the conv's bias")


def _on_cpu(tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {devs}")


def conv3x3(srcs: Sequence[torch.Tensor], weight, bias=None, leaky=False,
            res1=None, s1=1.0, res2=None, s2=1.0, skip=None,
            counter: str = "afi_chain", laid=None):
    """3x3 stride-1 zero-padded conv of the channel concatenation of
    ``srcs`` (NHWC, up to 5) with ``weight`` (Cout, sum Cin, 3, 3), plus
    the fused epilogue of ``conv3x3_plain``. Returns NHWC (B, H, W, Cout).
    ``laid``: ``lay_out_conv(weight, bias, dtype)`` made ahead, for the card."""
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
    wk, bk = lay_out_conv(weight, bias, x0.dtype) if laid is None else laid
    _check_laid(wk, bk, (9, cin, cout), bias, x0)
    lib = _build.load("afi_conv3x3")
    ptrs = (ctypes.c_void_p * 5)(*[s.data_ptr() for s in srcs])
    chans = (ctypes.c_int * 5)(*[int(s.shape[-1]) for s in srcs])
    rc = lib.afi_conv3x3(ptrs, chans, len(srcs), wk.data_ptr(), _build.ptr(bk),
                         _build.ptr(res1), float(s1), _build.ptr(res2), float(s2),
                         _build.ptr(skip), out.data_ptr(), b, h, w, cout,
                         int(bool(leaky)), dcode, TILING, _build.stream_ptr())
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


def subpixel_deconv(x, w_iohw, bias, leaky=True, counter="afi_upsample", laid=None):
    """ConvTranspose2d(k=6, s=2, p=2) (+ bias, LReLU): (B,H,W,Cin) →
    (B,2H,2W,Cout), computed as 4 dense 3x3 phase convolutions. ``laid``:
    ``lay_out_deconv(w_iohw, bias, dtype)`` made ahead, for the card."""
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
    wk, bk = lay_out_deconv(w_iohw, bias, x.dtype) if laid is None else laid
    _check_laid(wk, bk, (4, 9, cin, cout), bias, x)
    out = torch.empty((b, 2 * h, 2 * w, cout), device=x.device, dtype=x.dtype)
    lib = _build.load("afi_upsample")
    rc = lib.afi_subpixel_deconv(x.data_ptr(), wk.data_ptr(), _build.ptr(bk),
                                 out.data_ptr(), b, h, w, cin, cout,
                                 int(bool(leaky)), dcode, TILING, _build.stream_ptr())
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
    """The chain's wiring over one-conv calls: the plain version's, and the
    reference that the card's one-call route (``_rdb_chain_card``) repeats in
    ``csrc/afi_conv3x3.cu::afi_rdb_chain``."""
    if not rdb_weights:
        raise ValueError("the chain needs at least one dense block")
    head = conv([x.contiguous()], head_w, head_b, leaky=True)
    y = head
    for i, ws in enumerate(rdb_weights):
        last = i == len(rdb_weights) - 1
        # the last block also folds the RiR residual in
        y = _rdb(conv, y, ws, residual_scale, head if last else None, residual_scale)
    return y


def _workspace(like, shapes):
    """One allocation for tensors of ``shapes``, each starting on a multiple
    of 8 elements (16 bytes in bfloat16): (the flat buffer, the address of
    each part). The parts are handed to the library as addresses; a caller
    views only the part it returns (``_part``)."""
    sizes = [-(-math.prod(shp) // 8) * 8 for shp in shapes]
    flat = torch.empty(sum(sizes), device=like.device, dtype=like.dtype)
    base, elt = flat.data_ptr(), flat.element_size()
    starts = [0]
    for n in sizes[:-1]:
        starts.append(starts[-1] + n)
    return flat, starts, [base + at * elt for at in starts]


def _part(flat, start, shape):
    return flat[start:start + math.prod(shape)].view(shape)


def _rdb_chain_card(x, head, rdb_weights, rs, outer, outer_scale, laid_head, laid_rdbs,
                    counter):
    """The card's route of ``fused_generator_chain`` (``head`` = (weight,
    bias)) and ``fused_rdb`` (``head`` None): every launch of the run from one
    call into the library (``csrc/afi_conv3x3.cu::afi_rdb_chain``), the same
    kernel and the same wiring as ``_chain`` over ``conv3x3``, without the
    interpreter's time between two launches."""
    dcode = _build.dtype_code(x)
    x = x.contiguous()
    if x.dim() != 4:
        raise ValueError(f"x must be NHWC (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if not rdb_weights:
        raise ValueError("the chain needs at least one dense block")
    g = int(rdb_weights[0][0].shape[0])
    if laid_rdbs is None:
        laid_rdbs = [[lay_out_conv(w_, None, x.dtype) for w_ in ws] for ws in rdb_weights]
    shapes, ptrs = [], []
    if head is not None:
        if tuple(head[0].shape) != (c, c, 3, 3) or tuple(head[1].shape) != (c,):
            raise ValueError(f"head conv {tuple(head[0].shape)}, {tuple(head[1].shape)} for C={c}")
        if laid_head is None:
            laid_head = lay_out_conv(*head, x.dtype)
        _check_laid(*laid_head, (9, c, c), head[1], x)
        shapes.append((b, h, w, c))
    for ws, pairs in zip(rdb_weights, laid_rdbs):
        if len(ws) != 5 or len(pairs) != 5:
            raise ValueError("a dense block has five convs")
        for i, (w_, (wk, bk)) in enumerate(zip(ws, pairs)):
            cout = g if i < 4 else c
            if tuple(w_.shape) != (cout, c + i * g, 3, 3):
                raise ValueError(f"conv{i + 1} weight {tuple(w_.shape)} != "
                                 f"{(cout, c + i * g, 3, 3)}")
            _check_laid(wk, bk, (9, c + i * g, cout), None, x)
            ptrs.append(wk.data_ptr())
        shapes += [(b, h, w, g)] * 4 + [(b, h, w, c)]
    if outer is not None:
        _check_act(outer, x, "outer")
        if outer.shape != x.shape:
            raise ValueError(f"outer shape {tuple(outer.shape)} != {tuple(x.shape)}")
    flat, starts, bufs = _workspace(x, shapes)
    lib = _build.load("afi_conv3x3")
    rc = lib.afi_rdb_chain(
        x.data_ptr(), None if head is None else laid_head[0].data_ptr(),
        None if head is None else laid_head[1].data_ptr(),
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_void_p * len(bufs))(*bufs), len(rdb_weights),
        float(rs), _build.ptr(outer), float(outer_scale), b, h, w, c, g, dcode, TILING,
        _build.stream_ptr())
    _build.check(rc, "afi_rdb_chain")
    LAUNCHES[counter] += len(bufs)
    return _part(flat, starts[-1], shapes[-1])


def _flat(rdb_weights):
    return [w_ for ws in rdb_weights for w_ in ws]


def fused_rdb(x, weights, residual_scale=0.2, outer=None, outer_scale=1.0, laid=None):
    """One residual dense block (the port of
    ``afigan_tpu/ops/pallas/afi_rdb.py::fused_rdb``): x (B, H, W, C);
    weights [w1..w5], w_i (G, C+(i-1)G, 3, 3), w5 (C, C+4G, 3, 3) →
    y = x + residual_scale * conv5(cat(x, c1..c4)), or
    outer + outer_scale * y where the caller folds an outer residual (the
    RiR's) into the last conv's epilogue. Five launches of the conv kernel
    on the card. ``laid``: one entry of ``GeneratorLayout.rdbs``."""
    weights = list(weights)
    if _on_cpu([x, outer, *weights]):
        return fused_rdb_plain(x, weights, residual_scale, outer, outer_scale)
    return _rdb_chain_card(x, None, [weights], residual_scale, outer, outer_scale, None,
                           None if laid is None else [laid], "afi_rdb")


def fused_rdb_plain(x, weights, residual_scale=0.2, outer=None, outer_scale=1.0):
    """The plain version on any device: ``F.conv2d`` over real concats."""
    return _rdb(conv3x3_plain, x, list(weights), residual_scale, outer, outer_scale)


def fused_generator_chain(x, head_w, head_b, rdb_weights, residual_scale=0.2, laid=None):
    """head conv + n residual dense blocks + RiR residual.

    x: (B, H, W, C); head_w (C, C, 3, 3), head_b (C,); rdb_weights: per
    block [w1..w5], w_i (G, C+(i-1)G, 3, 3), w5 (C, C+4G, 3, 3).
    Returns r = head + s * RDB_n(..RDB_1(head)) (fused_upsample's input).
    ``laid``: the ``GeneratorLayout`` of these weights. On the card 16
    launches of the conv kernel (with three blocks), enqueued by one call.
    """
    rdb_weights = [list(ws) for ws in rdb_weights]
    if _on_cpu([x, head_w, head_b, *_flat(rdb_weights)]):
        return fused_generator_chain_plain(x, head_w, head_b, rdb_weights, residual_scale)
    return _rdb_chain_card(x, (head_w, head_b), rdb_weights, residual_scale, None, 1.0,
                           None if laid is None else laid.head,
                           None if laid is None else laid.rdbs, "afi_chain")


def fused_generator_chain_plain(x, head_w, head_b, rdb_weights, residual_scale=0.2):
    """The plain version on any device: ``F.conv2d`` over real concats."""
    return _chain(conv3x3_plain, x, head_w, head_b, rdb_weights, residual_scale)


def fused_upsample(r, x, wmid, bmid, wup, bup, wtail, btail, laid=None):
    """mid conv+LReLU → ConvTranspose(k6,s2,p2)+LReLU → tail conv + bilinear
    x2 skip of ``x``: (B,H,W,C) → (B,2H,2W,C). ``laid``: the laid-out (mid,
    up, tail) pairs, ``GeneratorLayout.upsample()``. On the card three
    launches (the conv kernel, its 4-phase mode, the conv kernel), enqueued
    by one call."""
    weights = (wmid, bmid, wup, bup, wtail, btail)
    if _on_cpu([r, x, *weights]):
        return fused_upsample_plain(r, x, *weights)
    dcode = _build.dtype_code(x)
    r, x = r.contiguous(), x.contiguous()
    _check_act(r, x, "r")
    if x.dim() != 4 or r.shape != x.shape:
        raise ValueError(f"r {tuple(r.shape)} and x {tuple(x.shape)} must be one NHWC shape")
    b, h, w, c = x.shape
    for name, w_, shp in (("mid", wmid, (c, c, 3, 3)), ("up", wup, (c, c, 6, 6)),
                          ("tail", wtail, (c, c, 3, 3))):
        if tuple(w_.shape) != shp:
            raise ValueError(f"{name} weight {tuple(w_.shape)} != {shp}")
    for name, b_ in (("mid", bmid), ("up", bup), ("tail", btail)):
        if b_ is None or tuple(b_.shape) != (c,):
            raise ValueError(f"{name} bias must be ({c},)")
    mid, up, tail = laid or (lay_out_conv(wmid, bmid, x.dtype), lay_out_deconv(wup, bup, x.dtype),
                             lay_out_conv(wtail, btail, x.dtype))
    _check_laid(*mid, (9, c, c), bmid, x)
    _check_laid(*up, (4, 9, c, c), bup, x)
    _check_laid(*tail, (9, c, c), btail, x)
    _flat_yz, _, (y, z) = _workspace(x, [(b, h, w, c), (b, 2 * h, 2 * w, c)])
    out = torch.empty((b, 2 * h, 2 * w, c), device=x.device, dtype=x.dtype)
    lib = _build.load("afi_upsample")
    rc = lib.afi_upsample_forward(r.data_ptr(), x.data_ptr(), mid[0].data_ptr(),
                                  mid[1].data_ptr(), up[0].data_ptr(), up[1].data_ptr(),
                                  tail[0].data_ptr(), tail[1].data_ptr(), y, z,
                                  out.data_ptr(), b, h, w, c, dcode, TILING,
                                  _build.stream_ptr())
    _build.check(rc, "afi_upsample_forward")
    LAUNCHES["afi_upsample"] += 3
    return out


def fused_upsample_plain(r, x, wmid, bmid, wup, bup, wtail, btail):
    """The plain version on any device (conv2d → conv_transpose2d → conv2d
    + F.interpolate bilinear skip)."""
    y = conv3x3_plain([r], wmid, bmid, leaky=True)
    z = subpixel_deconv_plain(y, wup, bup, leaky=True)
    return conv3x3_plain([z], wtail, btail, leaky=False, skip=x)
