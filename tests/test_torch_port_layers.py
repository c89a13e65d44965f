"""Port layers and backbones vs the JAX package, float32 on the CPU.

* The resizing primitives of ``models/layers.py`` against the JAX ones
  (bilinear x2 with half-pixel centers and edge clamp, nearest x2, the
  stride-2 subsample of the p6 max pool), odd sizes included.
* ``build_backbone`` for both ported registry names (FPN with the AF
  interpolator, FPN with nearest top-down) at narrow widths: p2..p6 equal to
  the JAX backbone's on the same weights, with FrozenBN statistics made
  non-trivial. rtol = atol = 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from afigan_tpu.models import layers as jax_layers
from afigan_tpu.models.build import build_backbone as jax_build_backbone
from afigan_tpu_torch.models import layers
from afigan_tpu_torch.models.build import build_backbone
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import small_cfg


@pytest.mark.parametrize("fn", ["bilinear_upsample_x2", "nearest_upsample_x2",
                                "max_pool_stride2"])
@pytest.mark.parametrize("shape", [(1, 5, 7, 3), (2, 4, 6, 8)])
def test_resize_matches_jax(fn, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = getattr(jax_layers, fn)(jnp.asarray(x))
    got = getattr(layers, fn)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (1, 1, 4, 2), (1, 5, 7, 3), (2, 4, 6, 8)])
def test_bilinear_upsample_x2_gradient(shape):
    """The gather-form adjoint against jax.vjp of the JAX resize and against
    torch's own (scatter) backward of ``F.interpolate``, one-pixel sides
    included; the forward keeps ``F.interpolate``'s bits."""
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(shape[0], 2 * shape[1], 2 * shape[2], shape[3]).astype(np.float32)
    _, vjp = jax.vjp(jax_layers.bilinear_upsample_x2, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = layers.bilinear_upsample_x2(xt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=1e-5)
    x64 = torch.from_numpy(x).double().requires_grad_(True)
    plain = F.interpolate(x64.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                          align_corners=False)
    plain.backward(torch.from_numpy(g).double().permute(0, 3, 1, 2))
    got64 = torch.from_numpy(x).double().requires_grad_(True)
    layers.bilinear_upsample_x2(got64).backward(torch.from_numpy(g).double())
    np.testing.assert_allclose(got64.grad.numpy(), x64.grad.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(y.detach().permute(0, 3, 1, 2),
                       F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                                     mode="bilinear", align_corners=False))


def _perturb_norms(params, rng):
    """FrozenBN leaves of a JAX init are mean 0 / var 1; give them values."""
    def f(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "mean":
            return leaf + 0.1 * rng.randn(*leaf.shape).astype(np.float32)
        if name == "var":
            return leaf * (1.0 + 0.5 * rng.rand(*leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(f, params)


@pytest.mark.parametrize("name", ["build_resnet_fpn_sr_backbone", "build_resnet_fpn_backbone"])
def test_backbone_features_match_jax(name):
    cfg = small_cfg()
    cfg.MODEL.BACKBONE.NAME = name
    rng = np.random.RandomState(7)
    x = rng.randn(2, 64, 96, 3).astype(np.float32)
    jb = jax_build_backbone(cfg)
    params = _perturb_norms(jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    sd = variables_to_state_dict({"params": {"backbone": params}})
    tb = build_backbone(cfg)
    tb.load_state_dict({k[len("backbone."):]: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    want = jb.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tb(torch.from_numpy(x))
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
