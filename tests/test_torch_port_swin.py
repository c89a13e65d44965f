"""Port Swin (LayerNorm and window-attention kernels, the backbone) vs the
JAX package, float32 on the CPU.

The port's wrappers run their plain versions on CPU tensors; the JAX side
runs its Pallas kernels in interpret mode (``interpret=True``, and
``attn_impl="pallas"``, ``ln_impl="pallas"`` for the backbone), as
tests/test_pallas_swin_kernels.py does. Same numpy inputs and, for the
backbone, the same weights (JAX init → ``variables_to_state_dict``'s Swin
names). Tolerances: kernels 1e-5 absolute on O(1) values; backbone 2e-4 of
each stage's standard deviation (24 f32 blocks of different summation order).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models import swin as jswin
from afigan_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_layer_norm
from afigan_tpu.ops.pallas.window_attention import fused_window_attention as jax_attention
from afigan_tpu_torch.models import swin as tswin
from afigan_tpu_torch.ops.kernels.layer_norm import fused_layer_norm, fused_layer_norm_plain
from afigan_tpu_torch.ops.kernels.window_attention import (fused_window_attention,
                                                           fused_window_attention_plain)
from afigan_tpu_torch.utils.converters import translate_path


@pytest.mark.parametrize("shape", [(64, 24), (2, 5, 7, 192), (67, 48), (3, 3072)])
def test_layer_norm_matches_pallas_interpret(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3 + 1.5).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    want = jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          interpret=True)
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = fused_layer_norm(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(got, fused_layer_norm_plain(*args))
    # the output dtype is a parameter, as the JAX kernel's
    assert fused_layer_norm(*args, out_dtype=torch.bfloat16).dtype == torch.bfloat16


def test_layer_norm_constant_row_has_zero_variance():
    """On a constant row E[x^2] - mean^2 is rounding noise of either sign in
    f32; the clamp at 0 keeps rsqrt finite, and the output stays at the bias
    to within that noise times rsqrt(eps) in both packages."""
    x = np.full((4, 192), 1000.1, np.float32)
    scale, bias = np.ones(192, np.float32), np.full(192, 0.5, np.float32)
    got = fused_layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)))
    want = jax_layer_norm(*(jnp.asarray(a) for a in (x, scale, bias)), interpret=True)
    for y in (got.numpy(), np.asarray(want)):
        assert np.isfinite(y).all()
        assert np.abs(y - 0.5).max() < 0.1


@pytest.mark.parametrize("n,nw", [(16, 0), (16, 6), (49, 0), (49, 4)])
def test_window_attention_matches_pallas_interpret(n, nw):
    rng = np.random.RandomState(n + nw)
    bnw, nh, d = 12, 3, 32
    q, k, v = (rng.randn(bnw, nh, n, d).astype(np.float32) for _ in range(3))
    bias = rng.randn(nh, n, n).astype(np.float32)
    mask = None
    if nw:
        mask = np.where(rng.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
        mask[:, np.arange(n), np.arange(n)] = 0.0
    scale = d ** -0.5
    want = jax_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                         None if mask is None else jnp.asarray(mask), scale=scale,
                         interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_window_attention(*args, tmask, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(got, fused_window_attention_plain(*args, tmask, scale=scale))


def test_window_helpers_equal():
    for ws in (4, 7, 12):
        np.testing.assert_array_equal(tswin._rel_pos_index(ws), jswin._rel_pos_index(ws))
    np.testing.assert_array_equal(tswin._sw_attn_mask(12, 16, 4, 2),
                                  jswin._sw_attn_mask(12, 16, 4, 2))
    x = np.random.RandomState(0).randn(2, 8, 12, 5).astype(np.float32)
    jw = jswin.window_partition(jnp.asarray(x), 4)
    tw = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tswin.window_reverse(tw, 4, 2, 8, 12).numpy(), x)


EMBED, DEPTHS, HEADS, WS = 16, (2, 2, 2), (2, 4, 8), 4


def _swin_pair(x):
    kw = dict(embed_dim=EMBED, depths=DEPTHS, num_heads=HEADS, window_size=WS,
              out_features=("stage2", "stage3", "stage4"))
    jm = jswin.SwinTransformer(drop_path_rate=0.0, attn_impl="pallas", ln_impl="pallas",
                               **kw)
    # init at a larger size than some applies: the parameter shapes must not
    # depend on the resolution
    params = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, 40, 56, 3))))()["params"]
    params = jax.tree.map(np.asarray, params)
    # LayerNorm parameters off their 1 / 0 init
    rng = np.random.RandomState(1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    tm = tswin.SwinTransformer(**kw)
    sd = {}
    for path, leaf in _leaves(params):
        key, tf = translate_path(("backbone", "bottom_up") + path, {})
        sd[key[len("backbone.bottom_up."):]] = torch.tensor(tf(leaf))
    tm.load_state_dict(sd, strict=True)
    want = jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x)))(params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    return got, want


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# 40x56 -> a 10x14 patch grid: not a multiple of the window (pads to 12x16)
# and larger than it, so shifted blocks use their masks; 16x24 -> stage-3 and
# stage-4 maps smaller than a window; 30x45 -> input and merges padded
@pytest.mark.parametrize("hw", [(40, 56), (16, 24), (30, 45)])
def test_swin_transformer_matches_jax(hw):
    x = np.random.RandomState(30).randn(1, *hw, 3).astype(np.float32)
    got, want = _swin_pair(x)
    assert set(got) == set(want) == {"stage2", "stage3", "stage4"}
    for stage in got:
        w = np.asarray(want[stage], np.float32)
        g = got[stage].numpy()
        assert g.shape == w.shape
        err = float(np.abs(g - w).max()) / max(float(np.std(w)), 1e-3)
        assert err < 2e-4, f"{stage}: normalised max err {err:.2e}"
