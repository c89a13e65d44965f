"""The port's training ops against the JAX package's, float32 on the CPU, on
the same numpy inputs: box deltas and overlaps, the Matcher, the subsample
(the same uniform draws; its invariants also under the port's own
generator), the losses, the RPN's anchor labels and losses, proposal
sampling, the Fast R-CNN losses, the mask targets and loss, and the AF
interpolator's training route. Tolerances: exact where the computation is a
selection (labels, indices, masks), 1e-6 relative for elementwise float32
math, 1e-5 for sums and products.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models import box_head as jbox
from afigan_tpu.models import mask_head as jmask
from afigan_tpu.models import roi_heads as jrh
from afigan_tpu.models import rpn as jrpn
from afigan_tpu.ops import boxes as jboxes
from afigan_tpu.ops import losses as jlosses
from afigan_tpu.ops.matcher import Matcher as JaxMatcher
from afigan_tpu_torch.models import box_head, mask_head, roi_heads, rpn
from afigan_tpu_torch.ops import boxes, losses
from afigan_tpu_torch.ops.matcher import Matcher
from afigan_tpu_torch.ops.sampling import subsample_labels, uniform_draws
from tests.torch_port_train_common import fixed_draws, patch_jax_sampler, port_draws


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(rng, n, size=100.0, min_wh=2.0):
    xy = rng.rand(n, 2) * size
    wh = rng.rand(n, 2) * size * 0.5 + min_wh
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_overlaps_and_deltas_equal_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 13), _boxes(rng, 7)
    b[3] = [5, 5, 5, 9]  # empty: zero area
    for name in ("pairwise_intersection", "pairwise_iou", "pairwise_ioa"):
        got = getattr(boxes, name)(_t(a), _t(b)).numpy()
        want = np.asarray(getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=name)
    for weights in [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)]:
        got = boxes.Box2BoxTransform(weights).get_deltas(_t(a[:7]), _t(b)).numpy()
        want = np.asarray(jboxes.Box2BoxTransform(weights).get_deltas(a[:7], b))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        # get_deltas inverts apply_deltas
        back = boxes.Box2BoxTransform(weights).apply_deltas(_t(got), _t(a[:7])).numpy()
        np.testing.assert_allclose(np.delete(back, 3, 0), np.delete(b, 3, 0), atol=1e-3)


@pytest.mark.parametrize("low_quality", [False, True])
def test_matcher_equals_jax(low_quality):
    rng = np.random.RandomState(1)
    gt, anchors = _boxes(rng, 6), _boxes(rng, 300)
    gt[4] = anchors[17]  # an exact match and a tie across two rows
    gt[5] = anchors[17]
    iou = np.asarray(jboxes.pairwise_iou(gt, anchors))
    valid = np.array([True, True, False, True, True, True])
    args = ([0.3, 0.7], [0, -1, 1], low_quality)
    m_j, l_j = JaxMatcher(*args)(jnp.asarray(iou), jnp.asarray(valid))
    m_p, l_p = Matcher(*args)(_t(iou), _t(valid))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(l_p.numpy(), np.asarray(l_j))
    assert set(np.unique(l_p.numpy())) == {-1, 0, 1}


@pytest.mark.parametrize("n,num,frac", [(400, 64, 0.25), (80, 64, 0.5), (300, 16, 0.01)])
def test_subsample_with_the_same_draws_equals_jax(monkeypatch, n, num, frac):
    rng = np.random.RandomState(n)
    labels = rng.choice([-1, 0, 0, 0, 1], size=n).astype(np.int32)
    patch_jax_sampler(monkeypatch)
    idx_j, valid_j = jrpn.subsample_labels(jax.random.PRNGKey(0), jnp.asarray(labels), num,
                                           frac, 0)
    idx_p, valid_p = subsample_labels(_t(labels).long(), num, frac, 0,
                                      draws=port_draws((n,), "cpu"))
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(idx_p.numpy()[valid_p.numpy()],
                                  np.asarray(idx_j)[np.asarray(valid_j)])
    assert fixed_draws(n).shape == (2, n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subsample_invariants_under_the_generator(seed):
    """Under a torch.Generator: d2's counts, distinct indices, the right
    labels, and batched rows that are independent draws."""
    rng = np.random.RandomState(seed)
    labels = torch.from_numpy(rng.choice([-1, 0, 0, 1], size=(2, 500))).long()
    gen = torch.Generator().manual_seed(seed)
    idx, valid = subsample_labels(labels, 128, 0.25, 0, draws=gen)
    for i in range(2):
        sel = idx[i][valid[i]]
        lab = labels[i][sel]
        n_pos, n_neg = int((labels[i] == 1).sum()), int((labels[i] == 0).sum())
        want_pos = min(n_pos, 32)
        assert int((lab == 1).sum()) == want_pos
        assert int((lab == 0).sum()) == min(n_neg, 128 - want_pos)
        assert len(set(sel.tolist())) == len(sel) and not bool((lab == -1).any())
        # positives fill the first slots
        assert bool((lab[:want_pos] == 1).all())
    d1 = uniform_draws((4,), torch.Generator().manual_seed(0))
    assert all(bool(((d >= 0.1) & (d < 1.0)).all()) for d in d1)


def test_losses_equal_jax():
    rng = np.random.RandomState(2)
    x, t = rng.randn(50).astype(np.float32) * 4, rng.rand(50).astype(np.float32)
    np.testing.assert_allclose(losses.bce_with_logits(_t(x), _t(t)).numpy(),
                               np.asarray(jlosses.bce_with_logits(x, t)), rtol=1e-6, atol=1e-7)
    for beta in (0.0, 0.1, 1.0):
        np.testing.assert_allclose(losses.smooth_l1(_t(x), _t(t), beta).numpy(),
                                   np.asarray(jlosses.smooth_l1(x, t, beta)), rtol=1e-6,
                                   atol=1e-7)


def _gt(rng, b, m, n_valid, size=100.0):
    gt_boxes = np.stack([_boxes(rng, m, size, 8.0) for _ in range(b)])
    valid = np.zeros((b, m), bool)
    valid[:, :n_valid] = True
    classes = rng.randint(0, 3, size=(b, m)).astype(np.int32)
    return gt_boxes, classes, valid


def test_rpn_labels_and_losses_equal_jax(monkeypatch):
    rng = np.random.RandomState(3)
    b, n = 2, 600
    anchors = _boxes(rng, n, 120.0, 4.0)
    gt_boxes, _, gt_valid = _gt(rng, b, 5, 3)
    gt_boxes[0, 1] = anchors[7] + 1.0  # a strong positive
    logits = rng.randn(b, n).astype(np.float32)
    deltas = (rng.randn(b, n, 4) * 0.3).astype(np.float32)
    patch_jax_sampler(monkeypatch)
    jm = JaxMatcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    lab_j, mi_j = jax.vmap(lambda gb, gv: jrpn.label_anchors(
        jax.random.PRNGKey(0), jnp.asarray(anchors), gb, gv, 64, 0.5, jm))(
        jnp.asarray(gt_boxes), jnp.asarray(gt_valid))
    pm = Matcher([0.3, 0.7], [0, -1, 1], allow_low_quality_matches=True)
    lab_p, mi_p = rpn.label_anchors(_t(anchors), _t(gt_boxes), _t(gt_valid), 64, 0.5, pm,
                                    draws=port_draws((b, n), "cpu"))
    np.testing.assert_array_equal(lab_p.numpy(), np.asarray(lab_j))
    np.testing.assert_array_equal(mi_p.numpy(), np.asarray(mi_j))
    assert int((lab_p == 1).sum()) > 0
    b2b = (1.0, 1.0, 1.0, 1.0)
    want = jrpn.rpn_losses(lab_j, mi_j, jnp.asarray(gt_boxes), jnp.asarray(anchors),
                           jnp.asarray(logits), jnp.asarray(deltas),
                           jboxes.Box2BoxTransform(b2b), 64, 0.0)
    got = rpn.rpn_losses(lab_p, mi_p, _t(gt_boxes), _t(anchors), _t(logits), _t(deltas),
                         boxes.Box2BoxTransform(b2b), 64, 0.0)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_proposal_sampling_equals_jax(monkeypatch):
    rng = np.random.RandomState(4)
    b, k, m = 2, 80, 6
    props = np.stack([_boxes(rng, k, 100.0, 6.0) for _ in range(b)])
    pvalid = rng.rand(b, k) > 0.1
    gt_boxes, classes, valid = _gt(rng, b, m, 4)
    props[1, :4] = gt_boxes[1, :4] + 0.5  # foreground proposals
    patch_jax_sampler(monkeypatch)
    want = jax.vmap(lambda pb, pv, gb, gc, gv: jrh.sample_proposals_single(
        jax.random.PRNGKey(0), pb, pv, jrh.GroundTruth(gb, gc, gv), 32, 0.25,
        JaxMatcher([0.5], [0, 1]), 3, True))(
        *(jnp.asarray(a) for a in (props, pvalid, gt_boxes, classes, valid)))
    got = roi_heads.sample_proposals(
        _t(props), _t(pvalid), roi_heads.GroundTruth(_t(gt_boxes), _t(classes).long(),
                                                     _t(valid)),
        32, 0.25, Matcher([0.5], [0, 1]), 3, True, draws=port_draws((b, k + m), "cpu"))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    for f in ("boxes", "gt_classes", "gt_idx"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[v], np.asarray(getattr(want, f))[v],
                                      err_msg=f)
    assert int((got.gt_classes[got.valid] < 3).sum()) > 0


@pytest.mark.parametrize("agnostic", [False, True])
def test_fast_rcnn_losses_equal_jax(agnostic):
    rng = np.random.RandomState(5)
    r, c = 40, 4
    logits = rng.randn(r, c + 1).astype(np.float32)
    deltas = rng.randn(r, 4 if agnostic else 4 * c).astype(np.float32)
    gt_classes = rng.randint(0, c + 1, size=r).astype(np.int32)
    gt_deltas = rng.randn(r, 4).astype(np.float32)
    valid = rng.rand(r) > 0.2
    want = jbox.fast_rcnn_losses(*(jnp.asarray(a) for a in (logits, deltas, gt_classes,
                                                             gt_deltas, valid)), c, 0.0)
    got = box_head.fast_rcnn_losses(_t(logits), _t(deltas), _t(gt_classes), _t(gt_deltas),
                                    _t(valid), c, 0.0)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("agnostic", [False, True])
def test_mask_targets_and_loss_equal_jax(agnostic):
    rng = np.random.RandomState(6)
    m, r, s, c = 5, 12, 28, 3
    gt_masks = (rng.rand(m, 32, 32) > 0.5).astype(np.float32)
    gt_boxes = _boxes(rng, m, 100.0, 10.0)
    idx = rng.randint(0, m, size=r).astype(np.int32)
    rois = gt_boxes[idx] + rng.randn(r, 4).astype(np.float32) * 4
    want_t = jmask.crop_and_resize_masks(jnp.asarray(gt_masks), jnp.asarray(gt_boxes),
                                         jnp.asarray(rois), jnp.asarray(idx), s)
    got_t = mask_head.crop_and_resize_masks(_t(gt_masks), _t(gt_boxes), _t(rois),
                                            _t(idx).long(), s)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-5)
    logits = rng.randn(r, s, s, 1 if agnostic else c).astype(np.float32)
    classes = rng.randint(0, c, size=r).astype(np.int32)
    fg = rng.rand(r) > 0.3
    want = jmask.mask_loss(jnp.asarray(logits), want_t, jnp.asarray(classes),
                           jnp.asarray(fg), c)
    got = mask_head.mask_loss(_t(logits), got_t, _t(classes), _t(fg), c)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_generator_training_route_is_differentiable_and_equal():
    """In training mode under autograd the AF interpolator runs its unfused
    route: the same output as the inference route, and a gradient for every
    weight; a frozen generator still passes a gradient to its input."""
    from afigan_tpu_torch.models.afi import AFIGenerator

    for n_rdb in (1, 3):
        gen = AFIGenerator(16, n_rdb, 8)
        gen.init_weights(torch.Generator().manual_seed(n_rdb))
        x = torch.randn(2, 6, 7, 16, requires_grad=True)
        gen.eval()
        with torch.no_grad():
            want = gen(x)
        gen.train()
        y = gen(x)
        torch.testing.assert_close(y.detach(), want, rtol=1e-5, atol=1e-6)
        y.square().sum().backward()
        assert all(p.grad is not None and float(p.grad.abs().sum()) > 0
                   for p in gen.parameters())
        gen.requires_grad_(False)
        x.grad = None
        gen(x).sum().backward()
        assert x.grad is not None and float(x.grad.abs().sum()) > 0
