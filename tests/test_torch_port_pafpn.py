"""Port PAFPN and the Mask R-CNN R-50-PAFPN detector against the JAX
package, float32 on the CPU.

The module: the same numpy features through ``afigan_tpu.models.pafpn.PAFPN``
and the port's ``PAFPN`` with the JAX init's weights (every 1-D leaf moved off
its init) carried by ``variables_to_state_dict``, for the AF interpolator and
nearest top-down, with and without a norm, both fuse types, on even and odd
level sizes; ``max|port - jax| <= 1e-4 max|jax| + 1e-5`` per level. The
detector: ``AFI-GAN_maskrcnn_R_50_PAFPN.yaml`` at narrow widths
(``torch_port_common.breadth_cfg``), one set of weights in both packages
(``port_and_jax``), detections at the golden tolerances (valid and classes
equal, scores 1e-3, boxes 0.05 px) and each mask's probability sum at 5e-3
relative.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn

from afigan_tpu.models.pafpn import PAFPN as JaxPAFPN
from afigan_tpu_torch.engine.inference import predict
from afigan_tpu_torch.models.pafpn import PAFPN
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import assert_detections_match, breadth_cfg, port_and_jax


def _perturb(variables, seed=0):
    rng = np.random.RandomState(seed)

    def f(path, a):
        a = np.asarray(a)
        if a.ndim != 1:
            return a
        d = 0.2 * rng.rand(*a.shape).astype(np.float32)
        return a + d if path[-1].key == "var" else a + d - 0.1

    return jax.tree_util.tree_map_with_path(f, variables)


def _close_rel(got, want, rel=1e-4, abs_=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + abs_, (err, np.abs(want).max())


class _Features(nn.Module):
    def forward(self, feats):
        return feats


@pytest.mark.parametrize("interp,norm,fuse,sizes", [
    ("afi", "", "sum", [(16, 24), (8, 12), (4, 6), (2, 3)]),
    ("afi", "SyncBN", "avg", [(15, 17), (8, 9), (4, 5), (2, 3)]),
    ("nearest", "", "sum", [(15, 17), (8, 9), (4, 5), (2, 3)]),
    ("nearest", "SyncBN", "avg", [(16, 24), (8, 12), (4, 6), (2, 3)]),
])
def test_pafpn_matches_jax(interp, norm, fuse, sizes):
    rng = np.random.RandomState(1)
    chans = {"res2": 8, "res3": 12, "res4": 20, "res5": 28}
    feats = {f: rng.randn(2, *hw, c).astype(np.float32)
             for (f, c), hw in zip(chans.items(), sizes)}
    kw = dict(out_channels=16, norm=norm, fuse_type=fuse, interp=interp, afi_n_rdb=3,
              afi_growth_rate=8)
    jm = JaxPAFPN(**kw)
    jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = _perturb(jax.jit(lambda: jm.init(jax.random.PRNGKey(0), jfeats))())
    want = jax.jit(lambda v: jm.apply(v, jfeats))(variables)
    tm = PAFPN(_Features(), chans, **kw)
    sd = variables_to_state_dict({c: {"backbone": {"pyramid": t}}
                                  for c, t in variables.items()})
    own = tm.state_dict()
    assert sd.keys() == {f"backbone.{k}" for k in own}
    assert "backbone.pafpn_downsample3.weight" in sd and "backbone.pafpn_downsample2.weight" \
        not in sd and not any(k.startswith("backbone.fpn_output") for k in sd)
    tm.load_state_dict({k[len("backbone."):]: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in feats.items()})
    assert list(got) == list(want) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in got:
        _close_rel(got[lvl], want[lvl])


@functools.lru_cache(maxsize=None)
def _detector():
    cfg = breadth_cfg("AFI-GAN_maskrcnn_R_50_PAFPN.yaml")
    return cfg, port_and_jax(cfg)


def test_r50_pafpn_builds_the_jax_structure():
    """Both converters agree on every key: the port's weights reach every JAX
    leaf (``port_and_jax`` asserts it) and come back through the port's
    ``variables_to_state_dict`` to the same keys and values."""
    cfg, (_, variables, tm) = _detector()
    assert type(tm.backbone).__name__ == "PAFPN"
    back = variables_to_state_dict(jax.tree.map(np.asarray, variables))
    own = tm.state_dict()
    assert back.keys() == own.keys()
    for k, v in own.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)


def test_r50_pafpn_detector_matches_jax():
    cfg, (jm, variables, tm) = _detector()
    assert cfg.MODEL.MASK_ON and cfg.MODEL.BACKBONE.NAME == "build_resnet_pafpn_sr_backbone"
    rng = np.random.RandomState(42)
    img = rng.rand(1, 128, 128, 3).astype(np.float32) * 255.0
    sizes = np.asarray([[96, 128]], np.int32)
    dets, masks = jax.jit(lambda v: jm.apply(v, jnp.asarray(img), jnp.asarray(sizes)))(
        variables)
    td, tmasks = predict(tm, {"image": img, "image_sizes": sizes})
    assert_detections_match(td, tmasks, dets, masks)
