"""AF interpolator (generator) — counterpart of
``afigan_tpu/models/afi/generator.py``.

    bilinear x2 skip
  + [ conv3x3+LReLU → ResidualInResidual(n_rdb x RDB) → conv3x3+LReLU
      → ConvTranspose(k=6, s=2, p=2)+LReLU → conv3x3 ]

Parameters carry the d2 reference's names (``Generators.0.0.0`` head,
``.1.RDBs.{i}.conv{1..4}.0`` / ``.conv5`` dense convs, ``.2.0`` mid,
``.3.0`` transposed conv, ``.4.0`` tail), so
``afigan_tpu.utils.converters`` maps them 1:1.

Inference goes through ``ops/kernels/afi_generator.py`` (hand-written CUDA
kernels on the card, the plain PyTorch versions on the CPU), split as the JAX
package's fused path splits it: with three dense blocks
``fused_generator_chain`` + ``fused_upsample``; with any other number the
head conv (the same conv kernel), one ``fused_rdb`` per block with the RiR
residual folded into the last block's epilogue, then ``fused_upsample``. On
the card neither branch runs a library convolution or a residual in torch.
``MODEL.AFI.FUSED_KERNEL`` is not read.

Training (the module in training mode, autograd recording for its weights
or its input) takes the unfused route instead: the module's own convolutions under
autograd, the counterpart of ``afigan_tpu/models/afi/generator.py::_unfused``.
The JAX package never trains through its Pallas kernels either
(``afigan_tpu/models/build.py::_use_fused_afi`` is false when training), and
the kernels are forward-only: their wrappers raise under autograd.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.kernels.afi_generator import (GeneratorLayout, conv3x3, fused_generator_chain,
                                          fused_rdb, fused_upsample, lay_out_generator)
from ..layers import bilinear_upsample_x2, init_weight, to_nchw, to_nhwc


def _conv(m, x, **kw):
    """An ``nn.Conv2d`` / ``nn.ConvTranspose2d`` of the module over NHWC, its
    float32 weights cast to the activation dtype (the JAX ``param_dtype``
    float32 / ``dtype`` compute split)."""
    fn = F.conv_transpose2d if isinstance(m, nn.ConvTranspose2d) else F.conv2d
    b = None if m.bias is None else m.bias.to(x.dtype)
    return to_nhwc(fn(to_nchw(x), m.weight.to(x.dtype), b, m.stride, m.padding, **kw))


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    def __init__(self, channels: int, growth_rate: int, device=None):
        super().__init__()
        c, g = channels, growth_rate
        for i in range(4):
            self.add_module(f"conv{i + 1}", nn.Sequential(
                nn.Conv2d(c + i * g, g, 3, 1, 1, bias=False, device=device)))
        self.conv5 = nn.Conv2d(c + 4 * g, c, 3, 1, 1, bias=False, device=device)

    def weights(self):
        return [getattr(self, f"conv{i + 1}")[0].weight for i in range(4)] + [
            self.conv5.weight]


class ResidualInResidual(nn.Module):
    def __init__(self, channels, n_rdb, growth_rate, device=None):
        super().__init__()
        self.RDBs = nn.ModuleList(
            [ResidualDenseBlock(channels, growth_rate, device) for _ in range(n_rdb)])


class AFIGenerator(nn.Module):
    """Learned 2x feature upsampler (the ``srf_module``): NHWC (B,H,W,C) →
    (B,2H,2W,C)."""

    def __init__(self, in_channels=256, n_rdb=3, growth_rate=32,
                 residual_scale=0.2, device=None):
        super().__init__()
        c = in_channels
        if n_rdb < 1:
            raise ValueError("the generator needs at least one dense block")
        self.residual_scale = residual_scale

        def conv():
            return nn.Conv2d(c, c, 3, 1, 1, device=device)

        body = nn.ModuleList([
            nn.Sequential(conv()),
            ResidualInResidual(c, n_rdb, growth_rate, device),
            nn.Sequential(conv()),
            nn.Sequential(nn.ConvTranspose2d(c, c, 6, 2, 2, device=device)),
            nn.Sequential(conv()),
        ])
        self.Generators = nn.ModuleList([body])
        self._laid = self._laid_key = self._weights_kept = None

    def init_weights(self, gen: torch.Generator) -> None:
        """kaiming normal x0.1, zero bias (ref generator_rdb.py:57-62)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                init_weight(m.weight, "kaiming0.1", gen,
                            transposed=isinstance(m, nn.ConvTranspose2d))
                if m.bias is not None:
                    nn.init.zeros_(m.bias)

    def _apply(self, fn, *args, **kwargs):
        # a move or a cast may replace the parameters themselves
        self._laid = self._laid_key = self._weights_kept = None
        return super()._apply(fn, *args, **kwargs)

    def _weights(self):
        """(head weight, head bias, [per block w1..w5], mid, up, tail weights
        and biases), collected once: the module's structure is fixed."""
        if self._weights_kept is None:
            head, rir, mid, up, tail = self.Generators[0]
            self._weights_kept = (
                head[0].weight, head[0].bias, [blk.weights() for blk in rir.RDBs],
                mid[0].weight, mid[0].bias, up[0].weight, up[0].bias,
                tail[0].weight, tail[0].bias)
        return self._weights_kept

    def laid_out(self, dtype) -> GeneratorLayout:
        """The weights as the kernels read them in ``dtype``, laid out once
        and kept: rebuilt when any parameter was written in place
        (``load_state_dict`` and every other in-place write bump its
        ``_version``), moved or cast (its storage changes), or when another
        ``dtype`` is asked for."""
        head_w, head_b, rdbs, *rest = self._weights()
        params = (head_w, head_b, *(w for ws in rdbs for w in ws), *rest)
        key = (dtype, *((p._version, p.data_ptr()) for p in params))
        if self._laid_key != key:
            with torch.no_grad():
                self._laid = lay_out_generator(*self._weights(), dtype)
            self._laid_key = key
        return self._laid

    def _unfused(self, x):
        """The training route: the JAX ``_unfused`` wiring over the module's
        layers, differentiable under autograd."""
        head, rir, mid, up, tail = self.Generators[0]
        rs = self.residual_scale
        h = y = _lrelu(_conv(head[0], x))
        for blk in rir.RDBs:
            feats = [y]
            for i in range(4):
                feats.append(_lrelu(_conv(getattr(blk, f"conv{i + 1}")[0],
                                          torch.cat(feats, dim=-1))))
            y = y + _conv(blk.conv5, torch.cat(feats, dim=-1)) * rs
        y = h + y * rs
        y = _lrelu(_conv(mid[0], y))
        y = _lrelu(_conv(up[0], y))
        return _conv(tail[0], y) + bilinear_upsample_x2(x.float()).to(x.dtype)

    def forward(self, x):
        # recording for the weights, or for the input behind a frozen
        # generator (MODEL.AFI_FREEZE still trains the layers before it)
        if self.training and torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            return self._unfused(x)
        head_w, head_b, rdb_ws, *up_ws = self._weights()
        rs = self.residual_scale
        # the plain versions on the CPU read the torch layout itself
        laid = self.laid_out(x.dtype) if x.is_cuda else None
        if len(rdb_ws) == 3:
            r = fused_generator_chain(x, head_w, head_b, rdb_ws, rs, laid=laid)
        else:
            # the head conv is outside the dense-block kernel: one more
            # launch of the conv kernel, counted with the path it serves
            h = y = conv3x3([x.contiguous()], head_w, head_b, leaky=True, counter="afi_rdb",
                            laid=laid and laid.head)
            for i, ws in enumerate(rdb_ws[:-1]):
                y = fused_rdb(y, ws, rs, laid=laid and laid.rdbs[i])
            # r = h + rs * RDB_n(y): the RiR residual rides on the last conv
            r = fused_rdb(y, rdb_ws[-1], rs, outer=h, outer_scale=rs,
                          laid=laid and laid.rdbs[-1])
        return fused_upsample(r, x, *up_ws, laid=laid and laid.upsample())
