"""The pooler's backward against the JAX package's custom VJP, float32 on the
CPU: ``jax.vjp`` of ``multilevel_roi_align_pallas`` (its Pallas forward in
interpret mode, its dense adjoint ``_pallas_pool_bwd_dense``) against the
port's ``multilevel_roi_align_pallas`` under ``torch.autograd`` (its
``RoIPool``, whose backward on CPU tensors is the plain version: autograd
through the gather, summed in float32). C 256 (the R-50 pyramid) and 160 (the
BiFPN's), P 7 and 14, ROIs inside, elongated and partly outside the map.
Tolerance: 1e-5 of the largest gradient entry (float32 sums in another
order). The boxes get no gradient in either package.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.ops.roi_align import multilevel_roi_align_pallas as jax_pool
from afigan_tpu_torch.ops.kernels import LAUNCHES
from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool_backward, roi_pool_backward_plain
from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels, multilevel_roi_align_pallas

STRIDES = (4, 8, 16, 32)


def _inputs(c, p, seed=0):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, 64 // s, 96 // s, c).astype(np.float32) for s in STRIDES]
    xy = rng.rand(2, 9, 2) * [80, 50]
    wh = rng.rand(2, 9, 2) * [60, 40] + 2
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [2, 20, 94, 30]      # elongated
    boxes[1, 1] = [-10, -8, 20, 30]    # partly outside
    grad = rng.randn(2, 9, p, p, c).astype(np.float32)
    return feats, boxes, grad


@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("c", [256, 160])
def test_pooler_backward_equals_jax_vjp(c, p):
    feats, boxes, grad = _inputs(c, p)
    out_j, vjp = jax.vjp(lambda f, b: jax_pool(f, b, STRIDES, p, 2, True),
                         tuple(jnp.asarray(f) for f in feats), jnp.asarray(boxes))
    dfeats_j, dboxes_j = vjp(jnp.asarray(grad))
    leaves = [torch.tensor(f, requires_grad=True) for f in feats]
    tboxes = torch.tensor(boxes, requires_grad=True)
    out = multilevel_roi_align_pallas(leaves, tboxes, STRIDES, p)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(out, leaves, torch.tensor(grad))
    scale = max(float(np.abs(np.asarray(d)).max()) for d in dfeats_j)
    for g, w in zip(got, dfeats_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale)
    assert float(np.abs(np.asarray(dboxes_j)).max()) == 0.0
    out2 = multilevel_roi_align_pallas(leaves, tboxes, STRIDES, p)
    out2.sum().backward()
    assert tboxes.grad is None


def test_backward_entry_on_the_cpu_is_the_plain_version():
    """On CPU tensors ``roi_pool_backward`` runs the plain version and
    launches nothing; the plain version keeps the levels' dtype."""
    feats, boxes, grad = _inputs(16, 7, seed=1)
    tf = [torch.tensor(f).to(torch.bfloat16) for f in feats]
    tb = torch.tensor(boxes)
    lv = assign_boxes_to_levels(tb, 2, 5)
    n0 = LAUNCHES["roi_pool_bwd"]
    got = roi_pool_backward(tf, tb, lv, torch.tensor(grad), STRIDES, 7)
    assert LAUNCHES["roi_pool_bwd"] == n0
    want = roi_pool_backward_plain(tf, tb, lv, torch.tensor(grad), STRIDES, 7)
    assert all(g.dtype == torch.bfloat16 and torch.equal(g, w) for g, w in zip(got, want))
