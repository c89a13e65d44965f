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


def test_backward_splits_fit_the_launcher(monkeypatch):
    """Every split that ``tools/kernel_sweep.py roi_pool_bwd`` sweeps (and the
    CUDA tests force) is one the launcher takes on the vector path: a block of
    a multiple of 32 threads, at most 256. On CPU tensors the split is not
    read: the plain version runs."""
    from afigan_tpu_torch.ops.kernels import roi_pool as rp
    from afigan_tpu_torch.tools.kernel_sweep import bwd_splits

    splits = bwd_splits()
    assert len(splits) == len(set(splits)) >= 20
    for th, tw, cc in splits:
        threads = th * (tw // (8 if tw % 8 == 0 else 4)) * (cc // 4)
        assert tw % 4 == 0 and cc % 4 == 0 and threads % 32 == 0 and threads <= 256
    feats, boxes, grad = _inputs(8, 7, seed=2)
    tf = [torch.tensor(f) for f in feats]
    tb = torch.tensor(boxes)
    lv = assign_boxes_to_levels(tb, 2, 5)
    want = roi_pool_backward_plain(tf, tb, lv, torch.tensor(grad), STRIDES, 7)
    monkeypatch.setattr(rp, "BWD_SPLIT", splits[0])
    got = roi_pool_backward(tf, tb, lv, torch.tensor(grad), STRIDES, 7)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_pool_calls_round_trip(tmp_path):
    """``tools/kernel_sweep.py roi_pool_bwd`` sweeps the pool's backward calls
    of one train step as ``chip_smoke.py`` captures and saves them: one call
    under autograd is recorded with its arguments, and after saving and
    loading (zero level maps of the saved shapes) the backward on them gives
    the levels' gradient that autograd gave."""
    from afigan_tpu_torch.tools.kernel_sweep import (capture_pool_backward, load_pool_calls,
                                                     save_pool_calls)

    feats, boxes, grad = _inputs(8, 7, seed=3)
    leaves = [torch.tensor(f).to(torch.bfloat16).requires_grad_(True) for f in feats]

    def step():
        out = multilevel_roi_align_pallas(leaves, torch.tensor(boxes), STRIDES, 7)
        out.backward(torch.tensor(grad))

    calls = capture_pool_backward(step)
    assert len(calls) == 1 and tuple(calls[0][4:]) == (STRIDES, 7, 2, True)
    save_pool_calls(calls, tmp_path / "calls.pt")
    (lf, lb, llv, lg, *rest), = load_pool_calls(tmp_path / "calls.pt", "cpu")
    assert [f.shape for f in lf] == [f.shape for f in leaves]
    assert all(f.dtype == torch.bfloat16 and not f.any() for f in lf)
    assert torch.equal(lb, calls[0][1]) and torch.equal(lg, torch.tensor(grad))
    got = roi_pool_backward(lf, lb, llv, lg, *rest)
    assert all(torch.equal(g, f.grad) for g, f in zip(got, leaves))
    (lf32, *_), = load_pool_calls(tmp_path / "calls.pt", "cpu", torch.float32)
    assert all(f.dtype == torch.float32 for f in lf32)
