"""Port window extractor, windowed pooler and ``TPU.POOLER_IMPL`` dispatch vs
the JAX package, on the CPU.

``gather_windows_plain`` (what the wrapper runs on a CPU tensor) must equal
the Pallas kernel in interpret mode bit for bit: both are copies. The port's
``multilevel_roi_align_windowed`` is held against the JAX function, vmapped
over images as the heads call it, with ``use_dma_gather`` off and on (on, the
JAX window is 8 wider and its column starts are rounded down: the same sums
in another layout), float32, atol 1e-5 (two f32 products summed in another
order). Boxes include border-crossing, sub-pixel, outside and elongated ROIs;
with ``overflow_slots=4`` and more than four overflowing ROIs per image, the
ones past the budget keep their truncated values in both packages.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.ops.pallas.window_gather import gather_windows as jax_gather_windows
from afigan_tpu.ops.roi_align import (multilevel_roi_align as jax_gather,
                                      multilevel_roi_align_windowed as jax_windowed)
from afigan_tpu_torch.models.centermask import CenterMask
from afigan_tpu_torch.models.roi_heads import StandardROIHeads
from afigan_tpu_torch.ops.kernels import LAUNCHES
from afigan_tpu_torch.ops.kernels.window_gather import gather_windows, gather_windows_plain
from afigan_tpu_torch.ops.roi_align import (POOLER_IMPLS, default_window,
                                            multilevel_roi_align,
                                            multilevel_roi_align_pallas,
                                            multilevel_roi_align_windowed, pool_rois)

STRIDES = (4, 8, 16, 32)
CANVAS = (256, 384)


def _slices(concat, rows, cols, window):
    c = concat.shape[-1]
    return jax.vmap(lambda r0, c0: jax.lax.dynamic_slice(
        concat, (r0, c0, 0), (window, window, c)))(rows, cols)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_pallas_interpret_bit_for_bit(dtype):
    # the Pallas kernel's contract: window and column starts multiples of 8
    rng = np.random.RandomState(0)
    c, window = 32, 16
    x = rng.randn(80, 64, c).astype(np.float32)
    rows = rng.randint(0, 80 - window, size=(9,)).astype(np.int32)
    cols = (rng.randint(0, (64 - window) // 8, size=(9,)) * 8).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = jax_gather_windows(jx, jnp.asarray(rows), jnp.asarray(cols), window,
                              interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gather_windows_plain(tx, torch.from_numpy(rows), torch.from_numpy(cols), window)
    assert got.dtype == tx.dtype and tuple(got.shape) == (9, window, window, c)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("c,window", [(100, 16), (160, 48), (3, 5)])
def test_plain_equals_dynamic_slice_at_any_start(c, window):
    # what the TPU kernel does not take: odd column starts, windows and
    # channel counts off the tiling
    rng = np.random.RandomState(1)
    x = rng.randn(70, 61, c).astype(np.float32)
    rows = rng.randint(0, 70 - window + 1, size=(7,)).astype(np.int32)
    cols = rng.randint(0, 61 - window + 1, size=(7,)).astype(np.int32)
    rows[0], cols[0] = 70 - window, 61 - window  # the last window that fits
    want = _slices(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(cols), window)
    n0 = LAUNCHES["window_gather"]
    got = gather_windows(torch.from_numpy(x), torch.from_numpy(rows),
                         torch.from_numpy(cols), window)
    assert LAUNCHES["window_gather"] == n0  # a CPU tensor launches no kernel
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_empty_and_out_of_range_starts():
    x = torch.zeros(20, 20, 4)
    none = torch.zeros(0, dtype=torch.int32)
    assert tuple(gather_windows(x, none, none, 8).shape) == (0, 8, 8, 4)
    for rows, cols in (([13], [0]), ([0], [13]), ([-1], [0])):
        with pytest.raises(ValueError, match="leave"):
            gather_windows(x, torch.tensor(rows), torch.tensor(cols), 8)
    with pytest.raises(ValueError, match="devices"):
        gather_windows(x.to("meta"), torch.tensor([0]), torch.tensor([0]), 8)


def _inputs(c, n, seed, n_long=1):
    rng = np.random.RandomState(seed)
    b = 2
    feats = [rng.randn(b, CANVAS[0] // s, CANVAS[1] // s, c).astype(np.float32)
             for s in STRIDES]
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        xy = rng.rand(n, 2) * [CANVAS[1] - 40, CANVAS[0] - 40]
        wh = np.exp(rng.rand(n, 2) * np.log(30)) * 6
        boxes[i] = np.concatenate([xy, xy + wh], 1)
    boxes[0, 0] = [-6, -4, 30, 22]          # crosses the top-left border
    boxes[0, 1] = [350, 230, 400, 270]      # crosses the bottom-right border
    boxes[1, 0] = [50, 50, 50.5, 50.4]      # sub-pixel
    boxes[1, 1] = [-40, -40, -10, -10]      # fully outside
    boxes[1, 2] = [0, 0, 384, 256]          # the whole canvas, on the coarsest level
    for i in range(b):                      # elongated: wider than the window on their level
        for j in range(n_long):
            y0 = 20 + 30 * j + 7 * i
            boxes[i, n - 1 - j] = [3 + j, y0, 375 - 2 * j, y0 + 10 + j]
    return feats, boxes


def _jax_pool(fn, feats, boxes, p, **kw):
    return np.asarray(jax.vmap(lambda *a: fn(list(a[:-1]), a[-1], list(STRIDES), p, 2, **kw))(
        *[jnp.asarray(f) for f in feats], jnp.asarray(boxes)))


def _port_pool(fn, feats, boxes, p, *args, **kw):
    return fn([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), STRIDES, p,
              2, *args, **kw).numpy()


@pytest.mark.parametrize("dma", [False, True], ids=["dynamic_slice", "dma_gather"])
@pytest.mark.parametrize("c,p,aligned", [(160, 14, True), (256, 7, True), (160, 7, False)])
def test_windowed_pooler_matches_jax(c, p, aligned, dma):
    feats, boxes = _inputs(c, 12, seed=p + c)
    want = _jax_pool(jax_windowed, feats, boxes, p, aligned=aligned, use_dma_gather=dma)
    got = _port_pool(multilevel_roi_align_windowed, feats, boxes, p, aligned)
    assert got.shape == (2, 12, p, p, c) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # one elongated ROI per image overflows the window and is recomputed: the
    # result is the per-point gather's for every ROI
    exact = _jax_pool(jax_gather, feats, boxes, p, aligned=aligned)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-4)


def test_windowed_pooler_overflow_budget_matches_jax():
    feats, boxes = _inputs(160, 14, seed=9, n_long=6)
    want = _jax_pool(jax_windowed, feats, boxes, 7, overflow_slots=4)
    got = _port_pool(multilevel_roi_align_windowed, feats, boxes, 7, True, 0, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    exact = _jax_pool(jax_gather, feats, boxes, 7)
    wrong = np.abs(got - exact).max(axis=(2, 3, 4)) > 1e-3
    # six overflow per image (ROIs 8-13), four slots: the lowest indices are
    # recomputed, the two of highest index stay truncated
    assert wrong.sum(axis=1).tolist() == [2, 2]
    assert wrong[:, 12:14].all()
    no_fix, over = multilevel_roi_align_windowed(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), STRIDES, 7,
        overflow_slots=0, return_overflow=True)
    assert over.sum(dim=1).tolist() == [6, 6] and bool(over[:, 8:].all())
    no_fix = no_fix.numpy()
    assert (np.abs(no_fix - exact).max(axis=(2, 3, 4)) > 1e-3).sum(axis=1).tolist() == [6, 6]


def test_window_size_follows_the_coarsest_level():
    def lvl(h, w):
        return torch.zeros(1, h, w, 1)

    assert default_window([lvl(112, 176), lvl(28, 44)]) == 48
    assert default_window([lvl(200, 200), lvl(50, 60)]) == 64
    # a window taller than every level: levels are padded to its height
    feats = [torch.randn(1, 8, 12, 4), torch.randn(1, 4, 6, 4)]
    boxes = torch.tensor([[[2.0, 3.0, 40.0, 28.0], [0.0, 0.0, 90.0, 60.0]]])
    got = multilevel_roi_align_windowed(feats, boxes, (8, 16), 7)
    np.testing.assert_allclose(got.numpy(), multilevel_roi_align(feats, boxes, (8, 16), 7).numpy(),
                               rtol=0, atol=1e-5)


def test_pooler_impl_dispatch():
    feats, boxes = _inputs(16, 10, seed=4, n_long=0)
    tf = [torch.from_numpy(f) for f in feats]
    tb = torch.from_numpy(boxes)
    assert POOLER_IMPLS == ("pallas", "fast", "windowed", "gather")
    outs = {impl: pool_rois(impl, tf, tb, STRIDES, 7).numpy() for impl in POOLER_IMPLS}
    want = multilevel_roi_align_pallas(tf, tb, STRIDES, 7).numpy()
    np.testing.assert_array_equal(outs["pallas"], want)
    np.testing.assert_array_equal(outs["fast"], outs["windowed"])
    np.testing.assert_array_equal(outs["gather"], multilevel_roi_align(tf, tb, STRIDES, 7).numpy())
    for impl in POOLER_IMPLS:  # no ROI overflows: the four agree
        np.testing.assert_allclose(outs[impl], want, rtol=0, atol=1e-5, err_msg=impl)
    with pytest.raises(ValueError, match="POOLER_IMPL"):
        pool_rois("dma", tf, tb, STRIDES, 7)
    with pytest.raises(ValueError, match="POOLER_IMPL"):
        StandardROIHeads(16, pooler_impl="dma")
    with pytest.raises(ValueError, match="POOLER_IMPL"):
        CenterMask(torch.nn.Identity(), 32, pooler_impl="dma")


@pytest.mark.parametrize("impl", POOLER_IMPLS)
def test_roi_heads_pool_through_the_configured_pooler(impl):
    """``build_roi_heads`` hands ``TPU.POOLER_IMPL`` to the heads, whose
    ``_pool`` goes through ``pool_rois``."""
    from afigan_tpu_torch.models import build as port_build
    from tests.torch_port_common import small_cfg

    cfg = small_cfg()
    cfg.TPU.POOLER_IMPL = impl
    heads = port_build.build_roi_heads(cfg, device="cpu")
    assert heads.pooler_impl == impl
    feats, boxes = _inputs(16, 10, seed=5, n_long=0)
    fd = {f"p{i + 2}": torch.from_numpy(f) for i, f in enumerate(feats)}
    got = heads._pool(fd, torch.from_numpy(boxes), 7)
    want = pool_rois(impl, list(fd.values()), torch.from_numpy(boxes), STRIDES, 7)
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1, 7, 7, 16).numpy())
