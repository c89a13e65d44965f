"""Port NMS, proposal generation and box inference vs the JAX package.

Fixed-shape contracts must agree entry for entry on the same numpy
inputs: NMS keep masks (ties, ``stop_after``, N not a block multiple),
``generate_proposals`` (exact top-k, lowest index first among ties) and
``fast_rcnn_inference_single``. float32 on the CPU.

The NMS contract that ``csrc/nms.cu`` implements on the card is pinned here
too: the blocked loop (the CPU route of ``ops/nms.py``) equals a greedy loop
in score order on the resolved prefix of its keep mask, and ``nms_padded``
equals the greedy survivors entry for entry, at ragged sizes around the
64-box tile, ties, all-invalid input and IoUs exactly at the threshold.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models.box_head import fast_rcnn_inference_single as jax_frcnn
from afigan_tpu.models.rpn import generate_proposals as jax_proposals
from afigan_tpu.ops import Box2BoxTransform as JaxB2B
from afigan_tpu.ops.anchors import AnchorGenerator as JaxAnchors
from afigan_tpu.ops.nms import batched_nms_padded as jax_bnms
from afigan_tpu.ops.nms import nms_keep_mask as jax_keep
from afigan_tpu_torch.models.box_head import fast_rcnn_inference_single
from afigan_tpu_torch.models.rpn import generate_proposals
from afigan_tpu_torch.ops.anchors import AnchorGenerator
from afigan_tpu_torch.ops.boxes import Box2BoxTransform
from afigan_tpu_torch.ops.kernels import LAUNCHES
from afigan_tpu_torch.ops.kernels.nms import nms_keep_sorted, nms_keep_sorted_plain
from afigan_tpu_torch.ops.nms import batched_nms_padded, nms_keep_mask, nms_padded
from torch_port_nms_cases import CPU_CASES, greedy_keep, nms_case


def _boxes(rng, n, extent=200.0):
    xy = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * 60 + 1
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("n,block,stop_after", [
    (300, 128, 0),     # non-block-multiple, fully resolved
    (300, 128, 40),    # early exit: exact prefix, unresolved tail as JAX
    (257, 64, 0),
    (50, 128, 0),      # fewer boxes than one block
])
def test_nms_keep_mask_matches_jax(n, block, stop_after):
    rng = np.random.RandomState(n + block)
    boxes = _boxes(rng, n, extent=120.0)
    scores = np.round(rng.rand(n), 2).astype(np.float32)  # many ties
    valid = rng.rand(n) > 0.1
    order_j, keep_j = jax_keep(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                               jnp.asarray(valid), block_size=block,
                               stop_after=stop_after)
    order_t, keep_t = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                                    0.5, torch.from_numpy(valid), block_size=block,
                                    stop_after=stop_after)
    np.testing.assert_array_equal(order_t.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))


def test_batched_nms_padded_matches_jax():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 200)
    scores = np.round(rng.rand(200), 2).astype(np.float32)
    idxs = rng.randint(0, 4, 200).astype(np.int32)
    valid = rng.rand(200) > 0.2
    want = jax_bnms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(idxs), 0.6,
                    250, jnp.asarray(valid))  # max_out > n: padded output
    got = batched_nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores),
                             torch.from_numpy(idxs), 0.6, 250, torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _greedy(case):
    boxes, scores, valid, _, thr, _ = nms_case(case)
    order = np.argsort(-np.where(valid, scores, np.float32(-1e10)), kind="stable")
    return boxes, scores, valid, thr, order, greedy_keep(boxes[order], valid[order], thr)


@pytest.mark.parametrize("stop_after", [0, 7])
@pytest.mark.parametrize("case", CPU_CASES)
def test_blocked_nms_equals_greedy_loop(case, stop_after):
    """The blocked fixpoint's keep mask is greedy NMS on its resolved prefix
    (all of it without ``stop_after``; up to the stop_after-th kept box with
    it), and the CPU route launches no kernel."""
    boxes, scores, valid, thr, order, want = _greedy(case)
    n0 = LAUNCHES["nms"]
    got_order, got = nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr,
                                   torch.from_numpy(valid), stop_after=stop_after)
    assert LAUNCHES["nms"] == n0
    np.testing.assert_array_equal(got_order.numpy(), order)
    upto = len(want)
    if stop_after and want.sum() >= stop_after:
        upto = int(np.flatnonzero(want)[stop_after - 1]) + 1
    np.testing.assert_array_equal(got.numpy()[:upto], want[:upto])
    if case == "at_threshold":  # IoU == threshold keeps both, 3.5/4.5 suppresses
        assert want.sum() == 2 * len(boxes) // 3


@pytest.mark.parametrize("stop_after", [0, 7])
@pytest.mark.parametrize("case", CPU_CASES)
def test_nms_padded_equals_greedy_survivors(case, stop_after):
    """``nms_padded`` returns the greedy survivors in score order, then the
    suppressed boxes in score order as invalid padding, then zero entries
    past N: boxes, scores, index and validity entry for entry."""
    boxes, scores, valid, thr, order, keep = _greedy(case)
    n = len(boxes)
    max_out = stop_after or n + 3
    k = min(max_out, n)
    sel = np.concatenate([np.flatnonzero(keep), np.flatnonzero(~keep)])[:k]
    idx, ok = order[sel], keep[sel]
    want = [boxes[idx], np.where(ok, scores[idx], np.float32(-1e10)), idx, ok]
    pad = max_out - k
    want = [np.concatenate([want[0], np.zeros((pad, 4), np.float32)]),
            np.concatenate([want[1], np.full(pad, -1e10, np.float32)]),
            np.concatenate([want[2], np.zeros(pad, np.int64)]),
            np.concatenate([want[3], np.zeros(pad, bool)])]
    got = nms_padded(torch.from_numpy(boxes), torch.from_numpy(scores), thr, max_out,
                     torch.from_numpy(valid))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", CPU_CASES)
def test_nms_keep_sorted_plain_is_the_cpu_route(case):
    """The kernel entry's plain counterpart, over a batch of two images,
    equals the CPU route of ``nms_keep_mask`` image by image."""
    boxes, scores, valid, _, thr, _ = nms_case(case)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    s2 = torch.from_numpy(scores[::-1].copy())
    orders, keeps = zip(*(nms_keep_mask(b, s, thr, v) for s in (torch.from_numpy(scores), s2)))
    got = nms_keep_sorted_plain(torch.stack([b, b]), torch.stack([v, v]), torch.stack(orders),
                                thr)
    assert torch.equal(got, torch.stack(keeps))


def test_nms_kernel_entry_raises_on_cpu_tensors():
    """The kernel's entry never falls back to the loop: CPU tensors raise."""
    boxes, _, valid, _, thr, _ = nms_case("n65")
    order = torch.arange(len(boxes))[None]
    n0 = LAUNCHES["nms"]
    with pytest.raises(ValueError, match="CUDA"):
        nms_keep_sorted(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], order,
                        thr)
    assert LAUNCHES["nms"] == n0


def test_generate_proposals_matches_jax():
    rng = np.random.RandomState(2)
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    strides = [4, 8, 16, 32, 64]
    sizes = [[32], [64], [128], [256], [512]]
    ars = [[0.5, 1.0, 2.0]]
    logits = [np.round(rng.randn(2, h, w, 3), 1).astype(np.float32) for h, w in shapes]
    deltas = [(rng.randn(2, h, w, 12) * 0.3).astype(np.float32) for h, w in shapes]
    image_sizes = np.asarray([[60, 90], [64, 96]], np.int32)
    janch = JaxAnchors(sizes, ars, strides)(shapes)
    want = jax_proposals(janch, [jnp.asarray(x) for x in logits],
                         [jnp.asarray(x) for x in deltas], jnp.asarray(image_sizes),
                         JaxB2B((1.0, 1.0, 1.0, 1.0)), 200, 100, 0.7)
    tanch = AnchorGenerator(sizes, ars, strides)(shapes)
    got = generate_proposals(tanch, [torch.from_numpy(x) for x in logits],
                             [torch.from_numpy(x) for x in deltas],
                             torch.from_numpy(image_sizes),
                             Box2BoxTransform((1.0, 1.0, 1.0, 1.0)), 200, 100, 0.7)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.proposals.numpy(), np.asarray(want.proposals),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_fast_rcnn_inference_single_matches_jax():
    rng = np.random.RandomState(3)
    r, c = 60, 5
    props = _boxes(rng, r, extent=80.0)
    deltas = (rng.randn(r, c * 4) * 0.2).astype(np.float32)
    logits = np.round(rng.randn(r, c + 1) * 2, 1).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    pvalid = rng.rand(r) > 0.1
    size = np.asarray([100, 120], np.int32)
    jb = np.asarray(JaxB2B((10.0, 10.0, 5.0, 5.0)).apply_deltas(
        jnp.asarray(deltas), jnp.asarray(props))).reshape(r, c, 4)
    tb = Box2BoxTransform((10.0, 10.0, 5.0, 5.0)).apply_deltas(
        torch.from_numpy(deltas), torch.from_numpy(props)).reshape(r, c, 4)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=1e-4)
    want = jax_frcnn(jnp.asarray(jb), jnp.asarray(probs), jnp.asarray(size),
                     jnp.asarray(pvalid), 0.05, 0.5, 20)
    got = fast_rcnn_inference_single(torch.from_numpy(jb), torch.from_numpy(probs),
                                     torch.from_numpy(size), torch.from_numpy(pvalid),
                                     0.05, 0.5, 20)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
