"""Swin Transformer backbone (counterpart of ``afigan_tpu/models/swin.py``):
NHWC tensors, window partition by reshape/permute, shifted-window masks and
the relative-position index built with numpy per feature-map size.

Two routes, picked by the mode (never by a failure), as the JAX module picks
its ``attn_impl`` / LayerNorm branch by ``train``:

- inference (eval mode, or nothing recorded by autograd): every LayerNorm
  goes through ``ops/kernels/layer_norm.py`` and every window attention
  through ``ops/kernels/window_attention.py``, the hand-written CUDA kernels
  on the card (forward only), their plain versions on the CPU;
- training (training mode while autograd records): JAX's training graph in
  torch ops under autograd: the attention as its XLA "split" branch with
  float32 scores, the relative-position bias gathered from its table on
  every call, LayerNorm as its jnp branch. DropPath (per-image stochastic
  depth, ``np.linspace(0, rate, sum(depths))`` over the blocks) is active in
  training mode only.

The JAX package's switches ``TPU.SWIN_ATTN_IMPL``, ``SWIN_LN_IMPL``,
``SWIN_QKV_LAYOUT`` and ``SWIN_SCORES_DTYPE`` are not read. State-dict keys
are the reference's (``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
``layers.{i}.downsample.reduction``, ``norm{i}``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.kernels.layer_norm import fused_layer_norm
from ..ops.kernels.window_attention import fused_window_attention
from .layers import Conv2d, Linear


def _rel_pos_index(window_size: int) -> np.ndarray:
    """(ws*ws, ws*ws) index into the (2w-1)^2 relative bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _sw_attn_mask(hp: int, wp: int, window_size: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) additive mask (0 / -100) for shifted windows."""
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for h in (slice(0, -window_size), slice(-window_size, -shift), slice(-shift, None)):
        for w in (slice(0, -window_size), slice(-window_size, -shift),
                  slice(-shift, None)):
            img_mask[h, w] = cnt
            cnt += 1
    mask = img_mask.reshape(hp // window_size, window_size, wp // window_size, window_size)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    attn_mask = mask[:, None, :] - mask[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _mask_on(device: torch.device, hp: int, wp: int, ws: int, shift: int) -> torch.Tensor:
    """The shift mask on ``device``, kept between forwards (47 MB at the
    first stage of an 896x1408 canvas with window 12)."""
    return torch.as_tensor(_sw_attn_mask(hp, wp, ws, shift), device=device)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(x: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def _records(module: nn.Module, x: torch.Tensor) -> bool:
    """The training route: training mode while autograd records, for the
    module's weights or for its input (``models/afi/generator.py`` decides
    the same way)."""
    return module.training and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in module.parameters()))


class FusedLayerNorm(nn.LayerNorm):
    """LayerNorm with f32 statistics, E[x^2] - mean^2 clamped at 0 (the JAX
    ``FusedLayerNorm``); output in the input's dtype. An ``nn.LayerNorm``, so
    that the solver's norm groups hold it (JAX classes ``norm*`` and
    ``patch_norm`` as norms by name)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__(dim, eps=eps, device=device)

    def forward(self, x):
        if not _records(self, x):
            return fused_layer_norm(x.contiguous(), self.weight, self.bias, self.eps)
        # the JAX module's jnp branch, op for op, under autograd (the range
        # names its kernels in a profile)
        with record_function("swin_layer_norm"):
            xf = x.float()
            mean = xf.mean(dim=-1, keepdim=True)
            var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, 0.0)
            return ((xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                    + self.bias).to(x.dtype)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, device=device)
        self.proj = Linear(dim, dim, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.as_tensor(_rel_pos_index(window_size).reshape(-1), device=device),
            persistent=False)
        self._bias, self._bias_key = None, None

    def bias(self) -> torch.Tensor:
        """The (NH, N, N) float32 relative-position bias as the kernel reads
        it. It depends on the weights only, so it is gathered once and kept;
        a change of the table (``load_state_dict`` and every other in-place
        write bump its ``_version``; a move or a cast replaces its storage)
        rebuilds it. Detached from the table, for the kernel's route (the
        training route gathers its own: ``train_bias``)."""
        table = self.relative_position_bias_table
        key = (table._version, table.data_ptr(), table.device, table.dtype)
        if self._bias_key != key:
            n = self.window_size ** 2
            with torch.no_grad():
                b = table.detach()[self.relative_position_index].float()
                self._bias = b.reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()
            self._bias_key = key
        return self._bias

    def train_bias(self) -> torch.Tensor:
        """The (NH, N, N) float32 bias gathered from the table under autograd
        (the training route: the table trains)."""
        n = self.window_size ** 2
        b = self.relative_position_bias_table[self.relative_position_index]
        return b.reshape(n, n, self.num_heads).permute(2, 0, 1).float()

    def forward(self, x, mask):
        """x: (nW*B, N, C); mask: (num_windows, N, N) or None."""
        bnw, n, c = x.shape
        nh = self.num_heads
        # q, k, v as (bnw, nh, n, hd) views of the packed linear output; the
        # kernel reads them in place and writes (bnw, n, nh, hd)
        q, k, v = self.qkv(x).reshape(bnw, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        if _records(self, x):
            out = self._split_attention(q, k, v, mask)
        else:
            out = fused_window_attention(q, k, v, self.bias(), mask, scale=self.scale)
        return self.proj(out.permute(0, 2, 1, 3).reshape(bnw, n, c))

    def _split_attention(self, q, k, v, mask):
        """The training route: JAX's XLA "split" branch (``swin.py:193-205``,
        float32 scores in training). q is scaled in the model dtype before
        q kᵀ, which is taken in the model dtype: in bfloat16 the scores round
        to bfloat16 (f32 accumulation, one rounding of the result, as XLA's
        einsum of bf16 operands) before the float32 cast. Bias and mask are
        added and the softmax taken in float32; the probabilities round to
        the model dtype before the product with v. The range names the
        route's kernels in a profile (``chip_smoke.py::route_device_ms``)."""
        bnw, nh, n, _ = q.shape
        with record_function("swin_attention"):
            s = torch.matmul(q * self.scale, k.transpose(-1, -2)).float() + self.train_bias()[None]
            if mask is not None:
                nw = mask.shape[0]
                s = (s.reshape(bnw // nw, nw, nh, n, n) + mask[None, :, None]
                     ).reshape(bnw, nh, n, n)
            return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, device=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, device=device)
        self.fc2 = Linear(hidden, dim, device=device)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) gelu


def drop_path_keep(source, shape, keep: float, device) -> torch.Tensor:
    """DropPath's boolean keep mask of ``shape`` from ``source``: None
    (torch's default generator), a ``torch.Generator`` on ``device`` (uniform
    draws below ``keep``, as ``jax.random.bernoulli``), or a callable
    (shape, keep, device) → mask, which tests use to hand masks in."""
    if source is None or isinstance(source, torch.Generator):
        return torch.rand(shape, generator=source, device=device) < keep
    return source(shape, keep, device)


class DropPath(nn.Module):
    """Stochastic depth (the JAX ``DropPath``): in training mode at ``rate >
    0``, each image's branch kept with probability ``1 - rate`` and scaled by
    its inverse, ``where(mask, x / keep, 0)`` in x's dtype (keep and
    ``x / keep`` each rounded to it, as in JAX); identity otherwise, drawing
    nothing. Its keep masks come from ``source`` (``drop_path_keep``;
    ``drop_path_source`` sets it on every DropPath of a model for a call)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.source = None

    def forward(self, x):
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = drop_path_keep(self.source, (x.shape[0],) + (1,) * (x.dim() - 1), keep,
                              x.device)
        # JAX's weakly typed ``x / keep`` rounds keep to x's dtype first
        div = torch.tensor(keep, dtype=x.dtype).item()
        return torch.where(mask, x / div, x.new_zeros(()))


@contextlib.contextmanager
def drop_path_source(model: nn.Module, source):
    """While entered, every ``DropPath`` of ``model`` draws its keep masks
    from ``source``; the JAX call order is the model's: block by block,
    ``drop_path1`` before ``drop_path2``. A no-op for a model without one."""
    mods = [m for m in model.modules() if isinstance(m, DropPath)]
    saved = [m.source for m in mods]
    for m in mods:
        m.source = source
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.source = s


class SwinBlock(nn.Module):
    """(B, H, W, C) -> same. The window size is fixed: maps are padded up
    to multiples of it, and the shift stays on even where the map is
    smaller than a window (the detection Swin of the reference)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, drop_path: float = 0.0,
                 device=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = FusedLayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, device)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = FusedLayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), device)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x):
        b, h, w, c = x.shape
        ws, shift = self.window_size, self.shift_size
        y = self.norm1(x)
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = _mask_on(x.device, hp, wp, ws, shift)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, b, hp, wp)
        if shift > 0:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + self.drop_path1(y[:, :h, :w])
        return x + self.drop_path2(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.norm = FusedLayerNorm(4 * dim, device=device)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False, device=device)

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return F.linear(self.norm(y), self.reduction.weight.to(x.dtype))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch_norm: bool, device=None):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, 4, stride=4, device=device)
        self.norm = FusedLayerNorm(embed_dim, device=device) if patch_norm else None

    def forward(self, x):
        h, w = x.shape[1:3]
        if h % 4 or w % 4:
            x = F.pad(x, (0, 0, 0, (-w) % 4, 0, (-h) % 4))
        y = self.proj(x)
        return y if self.norm is None else self.norm(y)


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, downsample,
                 drop_paths=None, device=None):
        super().__init__()
        drop_paths = drop_paths if drop_paths is not None else [0.0] * depth
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, window_size,
                      0 if d % 2 == 0 else window_size // 2, mlp_ratio, drop_paths[d],
                      device)
            for d in range(depth)])
        self.downsample = PatchMerging(dim, device) if downsample else None


class SwinTransformer(nn.Module):
    """Images (B, H, W, 3) → {"stage2".."stage5"} NHWC maps, each through its
    own LayerNorm (``norm{i}``). ``drop_path_rate``: the last block's DropPath
    rate, ``np.linspace(0, rate, sum(depths))`` over the blocks in order."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, patch_norm: bool = True,
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4", "stage5"),
                 drop_path_rate: float = 0.0, device=None):
        super().__init__()
        self.out_features = tuple(out_features)
        self.out_channels = {f"stage{i + 2}": embed_dim * 2 ** i
                             for i in range(len(depths))}
        self.patch_embed = PatchEmbed(embed_dim, patch_norm, device)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        starts = np.cumsum([0, *depths])
        self.layers = nn.ModuleList([
            BasicLayer(embed_dim * 2 ** i, depth, num_heads[i], window_size, mlp_ratio,
                       i < len(depths) - 1, dpr[starts[i]:starts[i + 1]], device)
            for i, depth in enumerate(depths)])
        for i in range(len(depths)):
            if f"stage{i + 2}" in self.out_features:
                self.add_module(f"norm{i}", FusedLayerNorm(embed_dim * 2 ** i,
                                                           device=device))

    def init_weights(self, gen: torch.Generator) -> None:
        """Linears and bias tables normal(0.02) clipped at two standard
        deviations, zero bias; LayerNorms at 1 / 0; the patch conv at
        sqrt(1 / fan_in) (the scales of the JAX package's initialisers)."""
        def trunc_(w, std):
            with torch.no_grad():
                w.copy_(torch.randn(w.shape, generator=gen).clamp_(-2.0, 2.0) * std)

        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc_(m.weight, 0.02)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                trunc_(m.relative_position_bias_table, 0.02)
        proj = self.patch_embed.proj
        trunc_(proj.weight, (1.0 / proj.weight[0].numel()) ** 0.5)
        nn.init.zeros_(proj.bias)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = self.patch_embed(x)
        out = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                y = blk(y)
            name = f"stage{i + 2}"
            if name in self.out_features:
                out[name] = getattr(self, f"norm{i}")(y)
            if layer.downsample is not None:
                y = layer.downsample(y)
        return out


def build_swin(cfg, device=None, train: bool = False) -> SwinTransformer:
    """MODEL.SWINT.* → the Swin; a training build (``train``) takes
    ``DROP_PATH_RATE``, an inference build none (JAX's ``train=False``)."""
    s = cfg.MODEL.SWINT
    return SwinTransformer(
        embed_dim=s.EMBED_DIM, depths=tuple(s.DEPTHS), num_heads=tuple(s.NUM_HEADS),
        window_size=s.WINDOW_SIZE, mlp_ratio=float(s.MLP_RATIO),
        out_features=tuple(s.OUT_FEATURES),
        drop_path_rate=float(s.DROP_PATH_RATE) if train else 0.0, device=device)
