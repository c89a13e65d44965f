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
output), at row lengths and window sizes on and off the vector paths.
"""

import numpy as np
import pytest
import torch

from afigan_tpu_torch.ops.kernels import LAUNCHES
from afigan_tpu_torch.ops.kernels import afi_generator as ag
from afigan_tpu_torch.ops.kernels.layer_norm import fused_layer_norm, fused_layer_norm_plain
from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool, roi_pool_plain
from afigan_tpu_torch.ops.kernels.window_attention import (fused_window_attention,
                                                           fused_window_attention_plain)
from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels

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
@pytest.mark.parametrize("c,g,hw", [(64, 16, (13, 18)), (64, 16, (24, 40)), (20, 12, (13, 18))])
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,hw", [(64, (13, 18)), (64, (24, 40)), (20, (13, 18))])
def test_upsample_kernel_matches_plain(dev, c, hw, dtype):
    rng = np.random.RandomState(1)
    r, x = _t(rng, 2, *hw, c).to(dev, dtype), _t(rng, 2, *hw, c).to(dev, dtype)
    w = [_t(rng, c, c, 3, 3, scale=0.05), _t(rng, c, scale=0.01),
         _t(rng, c, c, 6, 6, scale=0.03), _t(rng, c, scale=0.01),
         _t(rng, c, c, 3, 3, scale=0.05), _t(rng, c, scale=0.01)]
    w = [t.to(dev) for t in w]
    got = ag.fused_upsample(r, x, *w)
    _close(got, ag.fused_upsample_plain(r, x, *w), dtype)


@pytest.mark.parametrize("c,p", [(256, 7), (160, 14)])
def test_roi_pool_kernel_matches_plain(dev, c, p):
    rng = np.random.RandomState(2)
    strides = (4, 8, 16, 32)
    feats = [_t(rng, 2, 128 // s, 192 // s, c).to(dev) for s in strides]
    xy = rng.rand(2, 30, 2) * [170, 110]
    wh = rng.rand(2, 30, 2) * [120, 90] + 1
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)).to(dev)
    lv = assign_boxes_to_levels(boxes, 2, 5)
    _close(roi_pool(feats, boxes, lv, strides, p), roi_pool_plain(feats, boxes, lv, strides, p))


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
