"""Hand-written CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without an NVIDIA GPU (a CUDA kernel has no
interpret mode). Run them on the card with
``python -m pytest tests/test_torch_port_cuda.py -q``; ``chip_smoke.py``
runs the same comparisons at the main path's full shapes. float32 with
TF32 off: max|kernel - plain| <= 1e-4 * max|plain| + 1e-5; bfloat16:
<= 3e-2 * max|plain| for the generator (its 16 chained convs round to bf16
between stages, in another order than cuDNN's). Channel counts that are not
multiples of 8 take the bf16 kernel's element-by-element loads. LayerNorm
and window attention: 1e-2 * max|plain| in bfloat16 (one rounding of the
output), at row lengths and window sizes on and off the vector paths. The
window extractor is a copy: exact equality, at the CenterMask mask-pool shape,
the R-50 box-pool shape and a ragged one (C = 100 in a view at an odd offset,
which takes the element-by-element loop). The generator and the pooler also run
at 160 channels, the BiFPN pyramid of the FCOS / CenterMask configurations.
The pooler runs at C in {20, 160, 256, 257} (16-byte vectors and the
one-channel path), P 7 and 14, ``aligned`` both ways, on elongated ROIs and
ROIs partly or wholly outside the map, and every launch split gives the
same bits. The NMS kernel must equal the blocked plain loop on the card
entry for entry (``nms_padded`` / ``batched_nms_padded`` outputs, the keep
mask up to the ``max_out``-th kept box) at the main paths' sizes (RPN 4819,
the training RPN 8819 stopping at 2000 kept, the Res5 path's one level 2000,
FCOS 5000, detection 4096), ties, ragged N around the tile, a block's share
and the largest cluster's, all-invalid input, IoUs at the threshold and
class offsets; the kernel's cluster plan covers every box, and the largest
N one cluster holds runs while one more box raises. The deformable conv's
sampling must equal the plain gather bit for bit (float32 and bf16 x,
offsets read through the strides of a view, a mask or none, fractional and
integer offsets, C on and off the vector paths); its adjoint each gradient
within 1e-4 of its largest entry (float32 atomics sum in another order than
``index_add_``), also at C not a multiple of its 16-channel chunk
(``CHUNK`` in ``csrc/deform_conv.cu``), at stride and dilation 2, with the
channels split over clusters of 2 to 8 blocks, and where one tile's corners
fall both inside and outside its window (the spill path, counted);
and ``DeformConv2dFunction`` on the card against autograd of the plain conv.
The sampling kernel also on tiles that the map's edge cuts (a map smaller
than one tile), at C = 10, 36 and 1030, stride and dilation 2, and where
every corner lies outside its tile's window or outside the map; its count of
the corners it read from device memory instead of its window equals
``_spill_plain``'s, from the same tile and halo.
"""

import ctypes

import numpy as np
import pytest
import torch

from afigan_tpu_torch.ops import nms as nms_mod
from afigan_tpu_torch.ops.kernels import LAUNCHES, _build
from afigan_tpu_torch.ops.kernels import afi_generator as ag
from afigan_tpu_torch.ops.kernels import deform_conv as dc
from afigan_tpu_torch.ops.kernels import roi_pool as rp
from afigan_tpu_torch.ops.kernels.layer_norm import fused_layer_norm, fused_layer_norm_plain
from afigan_tpu_torch.ops.kernels.nms import nms_keep_sorted, nms_keep_sorted_plain
from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool, roi_pool_plain
from afigan_tpu_torch.ops.kernels.window_attention import (fused_window_attention,
                                                           fused_window_attention_plain)
from afigan_tpu_torch.ops.kernels.window_gather import (check_starts, gather_windows,
                                                        gather_windows_plain)
from afigan_tpu_torch.ops.roi_align import (assign_boxes_to_levels, multilevel_roi_align,
                                            multilevel_roi_align_windowed)
# bare: pytest puts tests/ on the path, and a ``tests`` package installed
# elsewhere would shadow this directory as a namespace package
from torch_port_nms_cases import CARD_CASES, nms_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = prev


TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (3e-2, 0.0)}
DTYPES = [torch.float32, torch.bfloat16]


def _close(got, want, dtype=torch.float32):
    rel, ab = TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.abs().max()) + ab, err


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,g,hw", [(64, 16, (13, 18)), (64, 16, (24, 40)), (20, 12, (13, 18)),
                                    (160, 32, (14, 22))])
def test_chain_kernel_matches_plain(dev, c, g, hw, dtype):
    rng = np.random.RandomState(0)
    x = _t(rng, 2, *hw, c).to(dev, dtype)
    head = (_t(rng, c, c, 3, 3, scale=0.05).to(dev), _t(rng, c, scale=0.01).to(dev))
    rdbs = [[_t(rng, g if i < 4 else c, c + i * g, 3, 3, scale=0.05).to(dev)
             for i in range(5)] for _ in range(3)]
    n0 = LAUNCHES["afi_chain"]
    got = ag.fused_generator_chain(x, *head, rdbs)
    assert LAUNCHES["afi_chain"] == n0 + 16
    _close(got, ag.fused_generator_chain_plain(x, *head, rdbs), dtype)
    # the one call launches what the wiring over single launches does
    assert torch.equal(got, ag._chain(ag.conv3x3, x, *head, rdbs, 0.2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hw", [(64, (13, 18)), (64, (24, 40)), (20, (13, 18)),
                                  (160, (14, 22))])
def test_upsample_kernel_matches_plain(dev, c, hw, dtype):
    rng = np.random.RandomState(1)
    r, x = _t(rng, 2, *hw, c).to(dev, dtype), _t(rng, 2, *hw, c).to(dev, dtype)
    w = [_t(rng, c, c, 3, 3, scale=0.05), _t(rng, c, scale=0.01),
         _t(rng, c, c, 6, 6, scale=0.03), _t(rng, c, scale=0.01),
         _t(rng, c, c, 3, 3, scale=0.05), _t(rng, c, scale=0.01)]
    w = [t.to(dev) for t in w]
    n0 = LAUNCHES["afi_upsample"]
    got = ag.fused_upsample(r, x, *w)
    assert LAUNCHES["afi_upsample"] == n0 + 3
    _close(got, ag.fused_upsample_plain(r, x, *w), dtype)
    z = ag.subpixel_deconv(ag.conv3x3([r], w[0], w[1], leaky=True), w[2], w[3])
    assert torch.equal(got, ag.conv3x3([z], w[4], w[5], skip=x))


def _pool_inputs(rng, dev, c, dtype=torch.float32):
    strides = (4, 8, 16, 32)
    feats = [_t(rng, 2, 128 // s, 192 // s, c).to(dev, dtype) for s in strides]
    xy = rng.rand(2, 30, 2) * [170, 110]
    wh = rng.rand(2, 30, 2) * [120, 90] + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(dev)
    return strides, feats, boxes


def _hard_rois(rng, dev):
    """(2, 12, 4) ROIs on a 128x192 canvas: elongated (up to 12:1), partly
    outside the map on every side, and wholly outside it."""
    boxes = [[5, 40, 185, 55], [90, 2, 100, 126], [-30, -20, 40, 30], [150, 100, 230, 160],
             [-60, 10, -10, 50], [200, 140, 260, 190], [60, -90, 120, -40], [0, 0, 192, 128],
             [-5, 60, 70, 66], [100, 120, 180, 200], [10, 10, 14, 13], [-1, -1, 0.5, 0.5]]
    b = np.asarray(boxes, np.float32)
    jitter = rng.rand(2, *b.shape).astype(np.float32)
    return torch.from_numpy(b[None] + jitter).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("c", [20, 160, 256, 257])
def test_roi_pool_kernel_matches_plain(dev, c, p, aligned, dtype):
    strides, feats, boxes = _pool_inputs(np.random.RandomState(2), dev, c, dtype)
    boxes = torch.cat([boxes, _hard_rois(np.random.RandomState(c + p), dev)], dim=1)
    lv = assign_boxes_to_levels(boxes, 2, 5)
    n0 = LAUNCHES["roi_pool"]
    got = roi_pool(feats, boxes, lv, strides, p, 2, aligned)
    assert LAUNCHES["roi_pool"] == n0 + 1
    want = roi_pool_plain(feats, boxes, lv, strides, p, 2, aligned)
    _close(got, want, dtype)
    # the wholly outside ROIs pool to zeros in both
    assert float(want[:, 34:37].abs().max()) == 0.0 and float(got[:, 34:37].abs().max()) == 0.0


@pytest.mark.parametrize("c,p", [(256, 7), (160, 14), (20, 14)])
def test_roi_pool_kernel_splits_agree(dev, monkeypatch, c, p):
    """Every split of the launch (output rows and threads a block) computes
    each output element by the same operations: equal bits."""
    strides, feats, boxes = _pool_inputs(np.random.RandomState(3), dev, c, torch.bfloat16)
    lv = assign_boxes_to_levels(boxes, 2, 5)
    want = roi_pool(feats, boxes, lv, strides, p)
    for split in [(1, 64), (2, 128), (3, 256), (p, 512), (p, 1024)]:
        monkeypatch.setattr(rp, "SPLIT", split)
        assert torch.equal(roi_pool(feats, boxes, lv, strides, p), want), split


def _nms_inputs(case, dev):
    boxes, scores, valid, idxs, thr, max_out = nms_case(case)
    return (*(torch.from_numpy(a).to(dev) for a in (boxes, scores, valid, idxs)), thr,
            max_out)


def _kept_prefix(keep, count):
    """Length of the prefix of a keep mask that holds its first ``count``
    kept entries (all of it where it keeps fewer)."""
    where = torch.nonzero(keep).flatten()
    return keep.numel() if where.numel() < count else int(where[count - 1]) + 1


@pytest.mark.parametrize("case", CARD_CASES)
def test_nms_kernel_equals_plain(dev, monkeypatch, case):
    boxes, scores, valid, idxs, thr, max_out = _nms_inputs(case, dev)
    n0 = LAUNCHES["nms"]
    got = nms_mod.batched_nms_padded(boxes, scores, idxs, thr, max_out, valid)
    got_full = nms_mod.nms_keep_mask(boxes, scores, thr, valid)
    got_stop = nms_mod.nms_keep_mask(boxes, scores, thr, valid, stop_after=max_out)
    got_pad = nms_mod.nms_padded(boxes, scores, thr, max_out, valid)
    assert LAUNCHES["nms"] == n0 + 4
    monkeypatch.setattr(nms_mod, "nms_keep_sorted", nms_keep_sorted_plain)
    want = nms_mod.batched_nms_padded(boxes, scores, idxs, thr, max_out, valid)
    want_full = nms_mod.nms_keep_mask(boxes, scores, thr, valid)
    want_stop = nms_mod.nms_keep_mask(boxes, scores, thr, valid, stop_after=max_out)
    want_pad = nms_mod.nms_padded(boxes, scores, thr, max_out, valid)
    assert LAUNCHES["nms"] == n0 + 4
    for g, w in [*zip(got, want), *zip(got_pad, want_pad), *zip(got_full, want_full)]:
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert torch.equal(got_stop[0], want_stop[0])
    upto = _kept_prefix(want_full[1], max_out)
    assert torch.equal(got_stop[1][:upto], want_stop[1][:upto])


@pytest.mark.parametrize("case", ["rpn", "rpn_train", "fcos", "all_invalid"])
def test_nms_calls_make_no_host_sync(dev, case):
    """Under ``set_sync_debug_mode("error")`` any operation that makes the
    host wait on the card raises: the NMS route on CUDA tensors has none."""
    boxes, scores, valid, idxs, thr, max_out = _nms_inputs(case, dev)
    nms_mod.batched_nms_padded(boxes, scores, idxs, thr, max_out, valid)  # build, load
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nms_mod.batched_nms_padded(boxes, scores, idxs, thr, max_out, valid)
        nms_mod.nms_padded(boxes, scores, thr, max_out, valid)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()


def test_nms_kernel_batch_entry(dev):
    """The C entry over a batch of images equals one call per image."""
    cases = [_nms_inputs(c, dev) for c in ("fcos", "detection")]
    n = 4096
    boxes = torch.stack([c[0][:n] for c in cases])
    valid = torch.stack([c[2][:n] for c in cases])
    order = torch.stack([torch.sort(-torch.where(c[2][:n], c[1][:n], -1e10), stable=True).indices
                         for c in cases])
    both = nms_keep_sorted(boxes, valid, order, 0.6)
    for i in range(2):
        assert torch.equal(both[i], nms_keep_sorted(boxes[i:i + 1], valid[i:i + 1],
                                                    order[i:i + 1], 0.6)[0])


# the main paths' largest NMS inputs: the training RPN over p2-p6 at
# 832x1344 (2000 a level, 819 on p6) and at the Swin's 896x1408 (924 on p6),
# the test pools (1000 a level), FCOS's 5 levels, the detection pool, the
# Res5 path's one level, a TTA merge (18 passes x 100)
NMS_PATH_SIZES = (8819, 8924, 4819, 4924, 5000, 4096, 2000, 1800)


def _nms_plan(n, stop_after=0):
    """``csrc/nms.cu::nms_plan``: (blocks in the cluster, 64-box tiles a
    block, kept boxes of history), or None where it refuses n."""
    out = (ctypes.c_int * 3)()
    rc = _build.load("nms").nms_plan(n, stop_after, ctypes.addressof(out))
    return None if rc else tuple(out)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 127, 129, 255, 257, 1000, 4095, 4097,
                               *NMS_PATH_SIZES])
def test_nms_plan_covers_every_box(dev, n):
    """``csrc/nms.cu``'s cluster for n boxes: 1 to 16 blocks, every box on a
    block, no block without a tile, no share larger than need be; with the
    paths' stops (1000 or 2000 kept, 100 detections) room for the history."""
    tiles = -(-n // 64)
    cluster, per_block, history = _nms_plan(n)
    assert 1 <= cluster <= 16 and cluster <= tiles
    assert cluster * per_block * 64 >= n and (per_block - 1) * cluster < tiles
    assert history == 0
    for stop in (100, 1000, 2000):
        assert _nms_plan(n, stop) == (cluster, per_block, stop)


def test_nms_plan_limit(dev):
    """The largest N exceeds every path's pool; above it the plan raises."""
    n = _build.load("nms").nms_max_n()
    assert n > max(NMS_PATH_SIZES)
    assert _nms_plan(n)[0] == 16
    assert _nms_plan(0) is None and _nms_plan(n + 1) is None


def test_nms_kernel_at_the_largest_n(dev):
    """``nms_max_n()`` boxes (16 blocks, each its shared memory nearly full)
    equal the plain loop; one box more raises before any launch."""
    n = _build.load("nms").nms_max_n()
    rng = np.random.RandomState(7)
    xy = rng.rand(n, 2) * [1344, 832]
    wh = np.exp(rng.rand(n, 2) * np.log(200 / 4)) * 4
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], 1).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(n) > 0.05).to(dev)
    scores = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
    order = torch.sort(-torch.where(valid, scores, -1e10), stable=True).indices
    got = nms_keep_sorted(boxes[None], valid[None], order[None], 0.7)
    assert torch.equal(got, nms_keep_sorted_plain(boxes[None], valid[None], order[None], 0.7))
    one_more = torch.zeros((1, n + 1, 4), device=dev)
    n0 = LAUNCHES["nms"]
    with pytest.raises(ValueError, match="at most"):
        nms_keep_sorted(one_more, torch.ones((1, n + 1), dtype=torch.bool, device=dev),
                        torch.arange(n + 1, device=dev)[None], 0.7)
    assert LAUNCHES["nms"] == n0


# (R, window, C, sumH, Wmax, a view at an odd element offset)
GATHER_SHAPES = [(200, 48, 160, 416, 176, False), (2000, 48, 256, 432, 336, False),
                 (7, 16, 100, 40, 33, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,window,c,sum_h,wmax,odd", GATHER_SHAPES)
def test_window_gather_kernel_equals_plain(dev, r, window, c, sum_h, wmax, odd, dtype):
    rng = np.random.RandomState(6)
    n = sum_h * wmax * c
    buf = torch.from_numpy(rng.randn(n + 1).astype(np.float32)).to(dev, dtype)
    concat = buf[1:].view(sum_h, wmax, c) if odd else buf[:n].view(sum_h, wmax, c)
    rows = torch.from_numpy(rng.randint(0, sum_h - window + 1, size=(r,))).to(dev)
    cols = torch.from_numpy(rng.randint(0, wmax - window + 1, size=(r,))).to(dev)
    rows[0], cols[0] = sum_h - window, wmax - window
    n0 = LAUNCHES["window_gather"]
    check_starts(concat, rows, cols, window)
    got = gather_windows(concat, rows, cols, window)
    assert LAUNCHES["window_gather"] == n0 + 1
    assert got.dtype == dtype and tuple(got.shape) == (r, window, window, c)
    assert torch.equal(got, gather_windows_plain(concat, rows, cols, window))


def test_window_gather_wrapper_checks(dev):
    x = torch.zeros(20, 20, 8, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    n0 = LAUNCHES["window_gather"]
    assert tuple(gather_windows(x, none, none, 8).shape) == (0, 8, 8, 8)
    assert LAUNCHES["window_gather"] == n0  # R = 0: no launch
    one = torch.tensor([13], device=dev)
    with pytest.raises(ValueError, match="leave"):
        check_starts(x, one, one, 8)
    with pytest.raises(ValueError, match="contiguous"):
        gather_windows(x.transpose(0, 1), one, one, 4)
    with pytest.raises(ValueError, match="devices"):
        gather_windows(x, one.cpu(), one.cpu(), 4)
    with pytest.raises(TypeError):
        gather_windows(x.half(), one, one, 4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [160, 256])
def test_windowed_pooler_on_the_card(dev, c, dtype):
    """One window_gather launch and one roi_pool launch (the overflow pass) a
    call; against the per-point gather on the same tensors."""
    strides, feats, boxes = _pool_inputs(np.random.RandomState(7), dev, c, dtype)
    n0, n1 = LAUNCHES["window_gather"], LAUNCHES["roi_pool"]
    got = multilevel_roi_align_windowed(feats, boxes, strides, 14)
    assert (LAUNCHES["window_gather"], LAUNCHES["roi_pool"]) == (n0 + 1, n1 + 1)
    want = multilevel_roi_align(feats, boxes, strides, 14)
    rel, ab = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 0.0)}[dtype]
    err = float((got - want).abs().max())
    assert err <= rel * float(want.abs().max()) + ab, err


@pytest.mark.parametrize("dtype", DTYPES)
def test_rdb_kernel_matches_plain(dev, dtype):
    rng = np.random.RandomState(3)
    c, g = 64, 16
    x = _t(rng, 2, 13, 18, c).to(dev, dtype)
    ws = [_t(rng, g if i < 4 else c, c + i * g, 3, 3, scale=0.05).to(dev) for i in range(5)]
    n0 = LAUNCHES["afi_rdb"]
    got = ag.fused_rdb(x, ws)
    assert LAUNCHES["afi_rdb"] == n0 + 5
    _close(got, ag.fused_rdb_plain(x, ws), dtype)
    assert torch.equal(got, ag._rdb(ag.conv3x3, x, ws, 0.2))
    outer = _t(rng, 2, 13, 18, c).to(dev, dtype)
    folded = ag.fused_rdb(x, ws, 0.2, outer=outer, outer_scale=0.5)
    _close(folded, ag.fused_rdb_plain(x, ws, 0.2, outer=outer, outer_scale=0.5), dtype)


# one bf16 rounding of an O(1..10) output; float32 as the other kernels
LN_ATTN_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 0.0)}


def _close_to(got, want, dtype):
    rel, ab = LN_ATTN_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * float(want.float().abs().max()) + ab, err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 9, 13, 192), (67, 3072), (33, 100), (5, 7)])
def test_layer_norm_kernel_matches_plain(dev, shape, dtype):
    rng = np.random.RandomState(4)
    x = (_t(rng, *shape) * 2 + 1.5).to(dev, dtype)
    scale, bias = _t(rng, shape[-1]).to(dev), _t(rng, shape[-1]).to(dev)
    n0 = LAUNCHES["layer_norm"]
    got = fused_layer_norm(x, scale, bias)
    assert LAUNCHES["layer_norm"] == n0 + 1 and got.dtype == dtype
    _close_to(got, fused_layer_norm_plain(x, scale, bias), dtype)
    got32 = fused_layer_norm(x, scale, bias, out_dtype=torch.float32)
    _close_to(got32, fused_layer_norm_plain(x, scale, bias, out_dtype=torch.float32),
              torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nw", [(144, 0), (144, 6), (49, 4), (16, 3), (1, 0)])
def test_window_attention_kernel_matches_plain(dev, n, nw, dtype):
    rng = np.random.RandomState(5)
    bnw, nh, d = 12, 3, 32
    q, k, v = (_t(rng, bnw, nh, n, d).to(dev, dtype) for _ in range(3))
    bias = _t(rng, nh, n, n).to(dev)
    mask = None
    if nw:
        m = np.where(rng.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
        mask = torch.from_numpy(m).to(dev)
    n0 = LAUNCHES["window_attention"]
    got = fused_window_attention(q, k, v, bias, mask, scale=d ** -0.5)
    assert LAUNCHES["window_attention"] == n0 + 1
    _close_to(got, fused_window_attention_plain(q, k, v, bias, mask, scale=d ** -0.5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,nw,bnw,nh", [(144, 0, 10, 3), (144, 5, 10, 3), (49, 0, 7, 2),
                                         (49, 7, 7, 2), (144, 3, 1140, 6)])
def test_window_attention_on_views_of_packed_qkv(dev, n, nw, bnw, nh, dtype):
    """q, k, v as views of one packed (BNW, N, 3, NH, D) tensor, as the Swin
    block passes them; the result is a view of a (BNW, N, NH, D) buffer.
    1140 x 6 is the first Swin stage's grid."""
    rng = np.random.RandomState(8)
    d = 32
    q, k, v = _t(rng, bnw, n, 3, nh, d).to(dev, dtype).permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous()
    bias = _t(rng, nh, n, n).to(dev)
    mask = None
    if nw:
        bnw_ok = bnw % nw == 0
        assert bnw_ok
        m = np.where(rng.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
        mask = torch.from_numpy(m).to(dev)
    got = fused_window_attention(q, k, v, bias, mask, scale=d ** -0.5)
    assert got.shape == q.shape and got.permute(0, 2, 1, 3).is_contiguous()
    want = fused_window_attention_plain(q, k, v, bias, mask, scale=d ** -0.5)
    _close_to(got, want, dtype)
    # the same numbers from contiguous copies
    again = fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), bias, mask,
                                   scale=d ** -0.5)
    assert torch.equal(got, again)


def test_window_attention_raises_on_views_it_cannot_read(dev):
    q = torch.zeros(4, 2, 16, 64, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(2, 16, 16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fused_window_attention(q[..., ::2], q[..., ::2], q[..., ::2], bias, scale=1.0)
    odd = torch.zeros(4 * 2 * 16 * 32 + 1, device=dev, dtype=torch.bfloat16)[1:]
    odd = odd.view(4, 2, 16, 32)
    with pytest.raises(ValueError, match="16 bytes"):
        fused_window_attention(odd, odd, odd, bias, scale=1.0)


# one bf16 launch against the float32 plain conv on the same bf16 values: the
# kernel accumulates in float32 and rounds once (chip_smoke.py's STAGE bound)
def _one_rounding(k, ref):
    err = (k.float() - ref).abs()
    return float((err / (2.0 ** -8 * ref.abs() + 1e-4 * ref.abs().max())).max())


# the conv kernel's four tilings: (H, W) small or not against one wave of
# blocks, cout wide (C) or a growth conv's (32)
HWS = [(7, 11), (26, 42), (104, 168)]
# (H, W), C, sources, cout (None: C), tiling (-1: the launcher's own pick):
# every shape on the launcher's pick, then each entry of its table forced on a
# wide conv over 5 sources and on a growth conv with the ragged loader
CONV_CASES = [(hw, c, ns, co, -1) for hw in HWS for c in (100, 160, 256)
              for ns, co in [(1, None), (3, 32), (5, None), (2, 32)]]
CONV_CASES += [(hw, c, ns, co, t) for t in range(5) for hw in HWS
               for c, ns, co in [(160, 5, None), (100, 3, 32)]]
# the warpgroup-MMA kernel (16x16 pixels x 128 channels a block): wide convs
CONV_CASES += [(hw, c, ns, None, 5) for hw in HWS[1:] for c, ns in [(160, 5), (256, 1)]]


@pytest.mark.parametrize("hw,c,n_src,cout,tiling", CONV_CASES)
def test_conv_kernel_tilings_one_rounding(dev, monkeypatch, hw, c, n_src, cout, tiling):
    """Every epilogue term, 1-5 sources, on the launcher's own tile choice and
    on each entry of its table; C = 100 takes the element-by-element loader
    (its 100 + 32i concat is off 16 bytes)."""
    monkeypatch.setattr(ag, "TILING", tiling)
    rng = np.random.RandomState(10)
    cout = cout or c
    bt = 1 if hw[0] > 100 else 2
    chans = [c] + [32] * (n_src - 1)
    cin = sum(chans)
    srcs = [_t(rng, bt, *hw, ci).to(dev, torch.bfloat16) for ci in chans]
    w = _t(rng, cout, cin, 3, 3, scale=(2.0 / (9 * cin)) ** 0.5).to(dev)
    bias = _t(rng, cout, scale=0.1).to(dev)
    r1, r2 = (_t(rng, bt, *hw, cout).to(dev, torch.bfloat16) for _ in range(2))
    even = hw[0] % 2 == 0 and hw[1] % 2 == 0
    skip = _t(rng, bt, hw[0] // 2, hw[1] // 2, cout).to(dev, torch.bfloat16) if even else None
    kw = dict(leaky=True, res1=r1, s1=0.2, res2=r2, s2=0.5, skip=skip)
    got = ag.conv3x3(srcs, w, bias, **kw)

    def f32(t):
        return None if t is None else t.to(torch.bfloat16).float()

    ref = ag.conv3x3_plain([f32(s) for s in srcs], f32(w), f32(bias), leaky=True,
                           res1=f32(r1), s1=0.2, res2=f32(r2), s2=0.5, skip=f32(skip))
    assert _one_rounding(got, ref) <= 1.0
    # the pre-laid weights give the same launch
    laid = ag.lay_out_conv(w, bias, torch.bfloat16)
    assert torch.equal(got, ag.conv3x3(srcs, w, bias, laid=laid, **kw))


@pytest.mark.parametrize("hw,c,tiling", [(hw, c, -1) for hw in HWS[:2] + [(52, 84)]
                                         for c in (100, 160, 256)]
                         + [((26, 42), 160, t) for t in range(6)])
def test_deconv_kernel_tilings_one_rounding(dev, monkeypatch, hw, c, tiling):
    """The 4-phase mode on the launcher's tile choices and on each entry of
    its table, pairs stored over channels."""
    monkeypatch.setattr(ag, "TILING", tiling)
    rng = np.random.RandomState(11)
    x = _t(rng, 2, *hw, c).to(dev, torch.bfloat16)
    w = _t(rng, c, c, 6, 6, scale=(2.0 / (9 * c)) ** 0.5).to(dev)
    bias = _t(rng, c, scale=0.1).to(dev)
    got = ag.subpixel_deconv(x, w, bias)
    ref = ag.subpixel_deconv_plain(x.float(), w.to(torch.bfloat16).float(),
                                   bias.to(torch.bfloat16).float())
    assert _one_rounding(got, ref) <= 1.0
    laid = ag.lay_out_deconv(w, bias, torch.bfloat16)
    assert torch.equal(got, ag.subpixel_deconv(x, w, bias, laid=laid))


def test_generator_module_keeps_its_layout_on_the_card(dev):
    """The module lays its weights out once per (device, dtype), and again
    after its weights change; its output equals the wrappers' own layout."""
    from afigan_tpu_torch.models.afi import AFIGenerator

    gen = AFIGenerator(64, 3, 16, device=dev)
    gen.init_weights(torch.Generator().manual_seed(0))
    x = _t(np.random.RandomState(12), 2, 13, 18, 64).to(dev, torch.bfloat16)
    with torch.inference_mode():
        y0 = gen(x)
        laid = gen._laid
        assert gen(x) is not None and gen._laid is laid
        head_w, head_b, rdbs, *up = gen._weights()
        r = ag.fused_generator_chain(x, head_w, head_b, rdbs, 0.2)
        assert torch.equal(y0, ag.fused_upsample(r, x, *up))
    with torch.no_grad():
        gen.Generators[0][0][0].weight.mul_(2.0)
    with torch.inference_mode():
        assert gen(x) is not None and gen._laid is not laid
        assert not torch.equal(gen(x), y0)


def test_wrappers_raise_on_mixed_devices(dev):
    """Mixed devices, and shapes the kernels do not take."""
    x = torch.zeros(1, 4, 4, 8, device=dev)
    with pytest.raises(ValueError):
        ag.conv3x3([x], torch.zeros(8, 8, 3, 3))
    with pytest.raises(ValueError):
        fused_layer_norm(x, torch.ones(8), torch.zeros(8))
    q = torch.zeros(2, 1, 16, 16, device=dev)  # head dimension 16
    with pytest.raises(ValueError):
        fused_window_attention(q, q, q, torch.zeros(1, 16, 16, device=dev), scale=1.0)
    boxes = torch.zeros(1, 8, 4, device=dev)
    order = torch.arange(8, device=dev)[None]
    with pytest.raises(ValueError):
        nms_keep_sorted(boxes, torch.ones(1, 8, dtype=torch.bool), order, 0.5)


# ---------------------------------------------------------------------------
# the pool's backward and the forward-only kernels under autograd
# ---------------------------------------------------------------------------

# the backward sums in float32 in another order than autograd's scatter
# (hits by ROI, then bins): float32 at 1e-4 * max|plain| + 1e-5 as the
# forward; bfloat16 levels round once from the float32 sums, one bf16 step
# (2^-8) at most, so 1e-2 * max|plain| compared through a float32 copy. The
# order is fixed: two runs, and every launch split, give the same bits
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 0.0)}


def _bwd_close(got, want, dtype):
    rel, ab = BWD_TOL[dtype]
    assert len(got) == len(want)
    scale = max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= rel * scale + ab, (err, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("c", [20, 160, 256, 257])
def test_roi_pool_backward_kernel_matches_plain(dev, c, p, dtype):
    rng = np.random.RandomState(5)
    strides, feats, boxes = _pool_inputs(rng, dev, c, dtype)
    boxes = torch.cat([boxes, _hard_rois(np.random.RandomState(c + p), dev)], dim=1)
    lv = assign_boxes_to_levels(boxes, 2, 5)
    grad = _t(rng, *boxes.shape[:2], p, p, c).to(dev)
    n0 = LAUNCHES["roi_pool_bwd"]
    got = rp.roi_pool_backward(feats, boxes, lv, grad, strides, p)
    assert LAUNCHES["roi_pool_bwd"] == n0 + 1
    want = rp.roi_pool_backward_plain(feats, boxes, lv, grad, strides, p)
    _bwd_close(got, want, dtype)
    _same_bits(got, rp.roi_pool_backward(feats, boxes, lv, grad, strides, p))
    # a gradient with one ROI's contribution left out must fail the bound
    short = rp.roi_pool_backward_plain(feats, boxes[:, 1:], lv[:, 1:], grad[:, 1:],
                                       strides, p)
    with pytest.raises(AssertionError):
        _bwd_close(got, short, dtype)


def _same_bits(got, again):
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _bwd_hard_rois(rng, dev):
    """(2, 62, 4) ROIs on a 128x192 canvas (p2-p5: 32x48 down to 4x6) and
    their levels: a whole-map ROI on each level (larger than a tile), 8:1
    and 1:8 ROIs, tiny ROIs whose samples all fall in one pixel, ROIs partly
    and wholly outside the level, and 40 ROIs piled on one p2 tile."""
    boxes = [[0, 0, 192, 128]] * 4 + [
        [10, 40, 170, 60], [80, 0, 96, 128], [50.2, 50.1, 50.9, 50.8], [7.1, 3.3, 7.4, 3.5],
        [-30, -20, 40, 30], [150, 100, 230, 160], [-60, 10, -10, 50], [200, 140, 260, 190],
        [60, -90, 120, -40], [185, 120, 200, 135]]
    levels = [0, 1, 2, 3] + [0, 0, 0, 0, 0, 1, 0, 1, 2, 0]
    for k in range(40):
        boxes.append([100 + 0.1 * k, 60 + 0.05 * k, 112 + 0.1 * k, 70 + 0.05 * k])
        levels.append(0)
    b = np.asarray(boxes, np.float32)[None] + 0.1 * rng.rand(2, len(boxes), 4)
    lv = np.broadcast_to(np.asarray(levels, np.int64), (2, len(boxes)))
    return (torch.from_numpy(b.astype(np.float32)).to(dev),
            torch.from_numpy(lv.copy()).to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [7, 14])
@pytest.mark.parametrize("c", [20, 160, 256, 257])
def test_roi_pool_backward_hard_rois(dev, c, p, dtype):
    """ROIs larger than a tile (a whole-map ROI on every level, elongated
    8:1), tiny ones, ROIs partly and wholly outside the level and many piled
    on one tile: the plain version's gradient, the same bits twice, and zeros
    where no ROI reaches (the wholly outside ROIs add nothing)."""
    rng = np.random.RandomState(c + 3 * p)
    strides, feats, _ = _pool_inputs(rng, dev, c, dtype)
    boxes, lv = _bwd_hard_rois(rng, dev)
    grad = _t(rng, *boxes.shape[:2], p, p, c).to(dev)
    got = rp.roi_pool_backward(feats, boxes, lv, grad, strides, p)
    want = rp.roi_pool_backward_plain(feats, boxes, lv, grad, strides, p)
    _bwd_close(got, want, dtype)
    _same_bits(got, rp.roi_pool_backward(feats, boxes, lv, grad, strides, p))
    outside = torch.zeros_like(grad)
    outside[:, 10:13] = grad[:, 10:13]
    assert all(float(g.float().abs().max()) == 0.0 for g in rp.roi_pool_backward(
        feats, boxes, lv, outside, strides, p))


def _bwd_threads(split, vec):
    th, tw, cc = split
    return th * (tw // (8 if tw % 8 == 0 else 4)) * (cc // vec)


@pytest.mark.parametrize("c,p", [(256, 7), (256, 14), (160, 14), (20, 7), (257, 7)])
def test_roi_pool_backward_splits_agree(dev, monkeypatch, c, p):
    """Every split that ``tools/kernel_sweep.py roi_pool_bwd`` sweeps (the
    scalar path at C = 257 takes those whose block stays within 256
    threads), forced through ``BWD_SPLIT``, gives the default's bits, which
    are the plain version's gradient."""
    from afigan_tpu_torch.tools.kernel_sweep import bwd_splits

    rng = np.random.RandomState(11)
    strides, feats, boxes = _pool_inputs(rng, dev, c, torch.bfloat16)
    hard, hard_lv = _bwd_hard_rois(rng, dev)
    boxes = torch.cat([boxes, hard], dim=1)
    lv = torch.cat([assign_boxes_to_levels(boxes[:, :30], 2, 5), hard_lv], dim=1)
    grad = _t(rng, *boxes.shape[:2], p, p, c).to(dev)
    want = rp.roi_pool_backward(feats, boxes, lv, grad, strides, p)
    _bwd_close(want, rp.roi_pool_backward_plain(feats, boxes, lv, grad, strides, p),
               torch.bfloat16)
    vec = 4 if c % 4 == 0 else 1
    splits = [sp for sp in bwd_splits() if _bwd_threads(sp, vec) <= 256]
    assert len(splits) >= 10
    for split in splits:
        monkeypatch.setattr(rp, "BWD_SPLIT", split)
        _same_bits(want, rp.roi_pool_backward(feats, boxes, lv, grad, strides, p))
    monkeypatch.setattr(rp, "BWD_SPLIT", (8, 6, 128))  # tile columns not a multiple of 4
    with pytest.raises(RuntimeError, match="roi_pool_backward"):
        rp.roi_pool_backward(feats, boxes, lv, grad, strides, p)


@pytest.mark.parametrize("dtype", DTYPES)
def test_roi_pool_backward_unaligned_grad(dev, dtype):
    """A gradient that is a view at an odd element offset takes the scalar
    path (no 16-byte loads), with the same result as the aligned copy."""
    rng = np.random.RandomState(12)
    strides, feats, boxes = _pool_inputs(rng, dev, 32, dtype)
    lv = assign_boxes_to_levels(boxes, 2, 5)
    grad = _t(rng, *boxes.shape[:2], 7, 7, 32).to(dev)
    buf = torch.empty(grad.numel() + 1, device=dev)
    buf[1:] = grad.flatten()
    view = buf[1:].view(grad.shape)
    assert view.data_ptr() % 16 != 0
    got = rp.roi_pool_backward(feats, boxes, lv, view, strides, 7)
    _bwd_close(got, rp.roi_pool_backward_plain(feats, boxes, lv, grad, strides, 7), dtype)
    _bwd_close(got, rp.roi_pool_backward(feats, boxes, lv, grad, strides, 7), dtype)


def test_roi_pool_backward_without_rois(dev):
    strides, feats, boxes = _pool_inputs(np.random.RandomState(6), dev, 32, torch.bfloat16)
    empty = boxes[:, :0]
    lv = assign_boxes_to_levels(empty, 2, 5)
    grad = torch.zeros(2, 0, 7, 7, 32, device=dev)
    n0 = LAUNCHES["roi_pool_bwd"]
    got = rp.roi_pool_backward(feats, empty, lv, grad, strides, 7)
    assert LAUNCHES["roi_pool_bwd"] == n0  # no launch
    assert all(g.dtype == torch.bfloat16 and float(g.float().abs().max()) == 0.0 for g in got)


def test_pooler_under_autograd_on_the_card(dev):
    """``multilevel_roi_align_pallas`` under autograd: the forward and the
    backward kernel, and level gradients equal to the plain gather's."""
    from afigan_tpu_torch.ops.roi_align import multilevel_roi_align_pallas

    strides, feats, boxes = _pool_inputs(np.random.RandomState(7), dev, 64)
    grad = _t(np.random.RandomState(8), 2, 30, 7, 7, 64).to(dev)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    n0, b0 = LAUNCHES["roi_pool"], LAUNCHES["roi_pool_bwd"]
    out = multilevel_roi_align_pallas(leaves, boxes, strides, 7)
    got = torch.autograd.grad(out, leaves, grad)
    assert (LAUNCHES["roi_pool"], LAUNCHES["roi_pool_bwd"]) == (n0 + 1, b0 + 1)
    plain = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(multilevel_roi_align(plain, boxes, strides, 7), plain, grad)
    _bwd_close(got, want, torch.float32)


def test_fast_pooler_training_route_on_the_card(dev):
    """``multilevel_roi_align_fast`` under autograd (``WindowedPool``): one
    window_gather and one overflow roi_pool launch forward, one roi_pool_bwd
    launch backward; the forward equals the windowed pooler's on the same
    tensors, the level gradients the plain gather's."""
    from afigan_tpu_torch.ops.roi_align import multilevel_roi_align_fast

    strides, feats, boxes = _pool_inputs(np.random.RandomState(7), dev, 64)
    grad = _t(np.random.RandomState(8), 2, 30, 7, 7, 64).to(dev)
    leaves = [f.clone().requires_grad_(True) for f in feats]
    n0 = {k: LAUNCHES[k] for k in ("window_gather", "roi_pool", "roi_pool_bwd")}
    out = multilevel_roi_align_fast(leaves, boxes, strides, 7)
    got = torch.autograd.grad(out, leaves, grad)
    assert {k: LAUNCHES[k] - n for k, n in n0.items()} == {
        "window_gather": 1, "roi_pool": 1, "roi_pool_bwd": 1}
    with torch.no_grad():
        torch.testing.assert_close(out, multilevel_roi_align_windowed(feats, boxes, strides, 7),
                                   rtol=0, atol=0)
    plain = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(multilevel_roi_align(plain, boxes, strides, 7), plain, grad)
    _bwd_close(got, want, torch.float32)


def test_forward_only_kernels_raise_under_autograd(dev):
    """A forward-only wrapper called under grad mode with an input that
    requires grad raises instead of dropping the graph; under no_grad it runs."""
    x = torch.randn(1, 8, 8, 16, device=dev, requires_grad=True)
    w = torch.randn(16, 16, 3, 3, device=dev)
    with pytest.raises(RuntimeError, match="autograd"):
        ag.conv3x3([x], w)
    with pytest.raises(RuntimeError, match="autograd"):
        fused_layer_norm(x, torch.ones(16, device=dev), torch.zeros(16, device=dev))
    strides, feats, boxes = _pool_inputs(np.random.RandomState(9), dev, 16)
    feats[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="autograd"):
        roi_pool(feats, boxes, assign_boxes_to_levels(boxes, 2, 5), strides, 7)
    with torch.no_grad():
        assert ag.conv3x3([x], w).shape == (1, 8, 8, 16)


def test_generator_in_training_mode_gets_gradients_on_the_card(dev):
    """In training mode under autograd the generator takes its unfused route
    (cuDNN under autograd, as the JAX package trains it), launches none of the
    generator kernels, and every weight gets a gradient; under inference_mode
    the kernels run as before."""
    from afigan_tpu_torch.models.afi import AFIGenerator

    gen = AFIGenerator(32, 3, 8, device=dev)
    gen.init_weights(torch.Generator().manual_seed(0))
    x = _t(np.random.RandomState(13), 2, 13, 18, 32).to(dev)
    before = {k: LAUNCHES[k] for k in ("afi_chain", "afi_upsample", "afi_rdb")}
    gen.train()
    y_train = gen(x)
    y_train.square().sum().backward()
    assert {k: LAUNCHES[k] for k in before} == before
    assert all(p.grad is not None and float(p.grad.abs().sum()) > 0 for p in gen.parameters())
    with torch.inference_mode():
        y = gen(x)
    assert LAUNCHES["afi_chain"] == before["afi_chain"] + 16
    _close(y, y_train.detach())


def _dcn_inputs(rng, dev, dtype, c, integer, modulated, h=13, w=18):
    """x (2, h, w, c); offsets a bf16 / float32 view of a (2, h, w, 27)
    tensor's first 18 channels (fractional in [-3, 3), or integers that
    land on and beyond the border); a float32 sigmoid mask or None."""
    x = _t(rng, 2, h, w, c).to(dev, dtype)
    pred = torch.zeros(2, h, w, 27, device=dev, dtype=dtype)
    off = (rng.randint(-h - 1, h + 2, (2, h, w, 18)) if integer
           else rng.uniform(-3, 3, (2, h, w, 18)))
    pred[..., :18] = torch.from_numpy(off.astype(np.float32)).to(dev, dtype)
    mask = (torch.sigmoid(_t(rng, 2, h, w, 9)).to(dev) if modulated else None)
    return x, pred[..., :18], mask


@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("c", [16, 12, 5, 36, 70])
@pytest.mark.parametrize("dtype", DTYPES)
def test_deform_conv_kernels_equal_plain(dev, dtype, c, integer, modulated):
    rng = np.random.RandomState(c + 2 * integer + modulated)
    x, off, mask = _dcn_inputs(rng, dev, dtype, c, integer, modulated)
    assert not off.is_contiguous()
    n0, b0 = LAUNCHES["deform_conv"], LAUNCHES["deform_conv_bwd"]
    cols = dc.deform_im2col(x, off, mask)
    assert LAUNCHES["deform_conv"] == n0 + 1
    assert torch.equal(cols, dc.deform_im2col_plain(x, off, mask))
    g = _t(rng, *cols.shape).to(dev)
    got = dc.deform_col2im(g, x, off, mask)
    want = dc.deform_col2im_plain(g, x, off, mask)
    torch.cuda.synchronize()
    assert LAUNCHES["deform_conv_bwd"] == b0 + 1
    for k, w in zip(got, want):
        if w is None:
            assert k is None
            continue
        err = float((k - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


# the sampling kernel's tile and window (``TILE_H``, ``TILE_W`` and ``HALO``
# in csrc/deform_conv.cu), for the exact count of the corners it reads from
# device memory instead of its staged window
DCN_TILE, DCN_HALO = (4, 8), 2


def _spill_plain(off, h, w, stride, dilation):
    """(corners inside the map outside their tile's window, all corners
    inside the map) of a 3x3 sampling at ``off`` over an h x w map."""
    th, tw = DCN_TILE
    _, ho, wo, _ = off.shape
    y0, x0, _, _ = dc.sample_grid(off.float().cpu(), h, w, 3, 3, stride, dilation, dilation)
    wy0 = ((torch.arange(ho) // th) * th * stride - dilation - DCN_HALO)[:, None, None]
    wx0 = ((torch.arange(wo) // tw) * tw * stride - dilation - DCN_HALO)[None, :, None]
    wh = (th - 1) * stride + 2 * dilation + 2 + 2 * DCN_HALO
    ww = (tw - 1) * stride + 2 * dilation + 2 + 2 * DCN_HALO
    spilled = corners = 0
    for dy in (0, 1):
        for dx in (0, 1):
            y, x = y0 + dy, x0 + dx
            inmap = (y >= 0) & (y < h) & (x >= 0) & (x < w)
            inwin = (y >= wy0) & (y < wy0 + wh) & (x >= wx0) & (x < wx0 + ww)
            corners += int(inmap.sum())
            spilled += int((inmap & ~inwin).sum())
    return spilled, corners


def _im2col_counted(x, off, mask, conv):
    """The sampling kernel's columns, its launch counted, and its corner
    counts (spilled, all inside the map)."""
    dev = x.device
    dc.reset_im2col_spill(dev)
    n0 = LAUNCHES["deform_conv"]
    cols = dc.deform_im2col(x, off, mask, *conv)
    assert LAUNCHES["deform_conv"] == n0 + 1
    return cols, dc.im2col_spill_counts(dev)


@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,stride,dilation", [
    ((3, 5), 16, 1, 1),      # a map smaller than one 4x8 tile
    ((13, 18), 36, 1, 1),    # neither side a multiple of the tile; bf16 one channel a lane
    ((9, 14), 10, 1, 1),     # C % 4 != 0: one channel a lane
    ((9, 14), 1030, 1, 1),   # C not a multiple of the block's channel group
    ((27, 35), 64, 2, 1),
    ((27, 35), 64, 1, 2),
    ((15, 17), 24, 2, 2),
])
def test_deform_im2col_tiles_equal_plain(dev, hw, c, stride, dilation, dtype, modulated):
    """The sampling kernel bit for bit against the plain gather on ragged
    tiles, channel counts off the vector width and off the group, stride
    and dilation 2, float32 and bf16 x, a mask or none, the offsets a view
    of a (B, Ho, Wo, 27) tensor: fractional offsets in [-3, 3), whose
    corners outside their tile's window the kernel counts exactly, and zero
    offsets, whose corners all lie in the window."""
    rng = np.random.RandomState(70 + c + 3 * stride + dilation)
    (h, w), conv = hw, ((3, 3), stride, dilation, dilation)
    ho, wo = dc.out_size(h, w, 3, 3, stride, dilation, dilation)
    x = _t(rng, 2, h, w, c).to(dev, dtype)
    pred = torch.zeros(2, ho, wo, 27, device=dev, dtype=dtype)
    mask = torch.sigmoid(_t(rng, 2, ho, wo, 9)).to(dev) if modulated else None
    for fractional in (True, False):
        if fractional:
            pred[..., :18] = torch.from_numpy(
                rng.uniform(-3, 3, (2, ho, wo, 18)).astype(np.float32)).to(dev, dtype)
        else:
            pred.zero_()
        off = pred[..., :18]
        assert not off.is_contiguous()
        cols, counts = _im2col_counted(x, off, mask, conv)
        assert torch.equal(cols, dc.deform_im2col_plain(x, off, mask, *conv))
        assert counts == _spill_plain(off, h, w, stride, dilation)
        if not fractional:
            assert counts[0] == 0 < counts[1]


@pytest.mark.parametrize("where", ["outside_window", "outside_map"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_deform_im2col_far_corners(dev, where, dtype):
    """Every corner outside its tile's window but inside the map (each
    sample moved half the map's height away: read from device memory, all
    counted), or every corner outside the map (zero columns, none
    counted); bit for bit against the plain gather, with a mask."""
    rng = np.random.RandomState(80)
    h, w, c = 21, 29, 40
    x = _t(rng, 2, h, w, c).to(dev, dtype)
    oy = torch.arange(h, dtype=torch.float32)[None, :, None, None, None]
    ky = (torch.arange(3, dtype=torch.float32) - 1)[None, None, None, :, None]
    off = torch.zeros(2, h, w, 3, 3, 2)
    if where == "outside_window":
        # rows oy < 11 sample 10 rows below, the others 11 rows above: 7 or
        # more rows past the 11-row window of any 4-row tile
        target = torch.where(oy < 11, oy + 10.25, oy - 10.75)
        off[..., 0] = (target - oy - ky).expand(2, h, w, 3, 3)
        off[..., 1] = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, 3, 3)).astype(np.float32))
    else:
        off[..., 0] = float(h + 5)
        off[..., 1] = torch.from_numpy(rng.uniform(-1, 1, (2, h, w, 3, 3)).astype(np.float32))
    pred = torch.zeros(2, h, w, 27, device=dev, dtype=dtype)
    pred[..., :18] = off.reshape(2, h, w, 18).to(dev, dtype)
    offv = pred[..., :18]
    mask = torch.sigmoid(_t(rng, 2, h, w, 9)).to(dev)
    conv = ((3, 3), 1, 1, 1)
    cols, (spilled, corners) = _im2col_counted(x, offv, mask, conv)
    assert torch.equal(cols, dc.deform_im2col_plain(x, offv, mask, *conv))
    assert (spilled, corners) == _spill_plain(offv, h, w, 1, 1)
    if where == "outside_window":
        assert spilled == corners > 0
    else:
        assert corners == 0 and not bool(cols.any())


def _adjoint_close(got, want):
    for k, w in zip(got, want):
        if w is None:
            assert k is None
            continue
        err = float((k - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_deform_adjoint_spill_path(dev, dtype, stride, dilation):
    """Zero offsets but for one tap in five, which lands 2 to 12 cells
    away: one 8x8 tile holds corners inside its window and corners outside
    it (counted as spilled), at stride and dilation 1 and 2."""
    rng = np.random.RandomState(50 + 2 * stride + dilation)
    h, w, c = 27, 35, 36
    x = _t(rng, 2, h, w, c).to(dev, dtype)
    ho, wo = dc.out_size(h, w, 3, 3, stride, dilation, dilation)
    off = np.zeros((2, ho, wo, 18), np.float32)
    far = rng.rand(2, ho, wo, 9) < 0.2
    jump = rng.uniform(2, 12, (2, ho, wo, 9, 2)) * rng.choice([-1, 1], (2, ho, wo, 9, 2))
    off.reshape(2, ho, wo, 9, 2)[far] = jump[far]
    off = torch.from_numpy(off).to(dev, dtype)
    mask = torch.sigmoid(_t(rng, 2, ho, wo, 9)).to(dev)
    g = _t(rng, 2 * ho * wo, 9 * c).to(dev)
    dc.reset_spill(dev)
    got = dc.deform_col2im(g, x, off, mask, (3, 3), stride, dilation, dilation)
    spilled, corners = dc.spill_counts(dev)
    assert 0 < spilled < corners
    _adjoint_close(got, dc.deform_col2im_plain(g, x, off, mask, (3, 3), stride, dilation,
                                               dilation))


@pytest.mark.parametrize("c", [129, 256, 520, 1030])
def test_deform_adjoint_channel_splits(dev, c):
    """Channels split over a cluster of blocks a tile (128 a block at least,
    up to 8 blocks): 129 on two blocks, the second holding one channel and
    no vectors; 256 on two, 520 on five, 1030 on eight of 144, the last
    short; fractional offsets, bf16 x, a mask."""
    rng = np.random.RandomState(60 + c)
    x, off, mask = _dcn_inputs(rng, dev, torch.bfloat16, c, False, True, h=9, w=14)
    g = _t(rng, 2 * 9 * 14, 9 * c).to(dev)
    _adjoint_close(dc.deform_col2im(g, x, off, mask), dc.deform_col2im_plain(g, x, off, mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_deform_conv_function_on_the_card_equals_autograd_of_plain(dev, dtype):
    """Stride 2 and dilation 2: the output bit for bit (the same columns, the
    same product), every gradient within 1e-4 of its largest entry after
    both round to their inputs' dtype (bf16: one bf16 step, 1e-2)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(40)
    x = _t(rng, 2, 15, 17, 16).to(dev, dtype).requires_grad_()
    # 15x17 at stride 2, padding 2, dilation 2: an 8x9 output
    off = _t(rng, 2, 8, 9, 18, scale=2.0).to(dev, dtype).requires_grad_()
    mask = torch.sigmoid(_t(rng, 2, 8, 9, 9)).to(dev).requires_grad_()
    weight = _t(rng, 24, 16, 3, 3, scale=0.1).to(dev).requires_grad_()
    args = (x, off, weight, mask)
    out = dc.DeformConv2dFunction.apply(*args, 2, 2, 2)
    cot = _t(rng, *out.shape).to(dev)
    got = torch.autograd.grad(out, args, cot)
    ref = dc.deform_conv2d_plain(*args, 2, 2, 2)
    want = torch.autograd.grad(ref, args, cot)
    assert torch.equal(out, ref)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert float((g.float() - w.float()).abs().max()) <= rel * float(w.float().abs().max())


def test_deform_conv_wrappers_raise_on_mixed_devices(dev):
    x = torch.zeros(1, 5, 5, 4, device=dev)
    off = torch.zeros(1, 5, 5, 18)
    with pytest.raises(ValueError, match="devices"):
        dc.deform_im2col(x, off)
    with pytest.raises(ValueError, match="contiguous"):
        dc.deform_im2col(x.permute(0, 2, 1, 3), off.to(dev))
