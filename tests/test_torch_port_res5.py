"""The Res5 (C4) ROI heads and the windowed pooler's training route in the
port against the JAX package, float32 on the CPU.

The ``fast`` pooler under autograd (``ops/roi_align.py::WindowedPool``, the
counterpart of JAX's custom VJP ``_fast_fwd`` / ``_fast_bwd``) gives JAX's
forward and JAX's gradient into every level (``jax.vjp`` of
``multilevel_roi_align_fast``, with ROIs whose samples leave their window)
at 1e-5 of the largest entry; ``windowed`` under autograd gives the gradient
of autodiff through JAX's windowed form. The route is picked by mode: the
window copy goes through ``gather_windows`` (the kernel on the card) both
ways, and only when a level requires grad does the backward run through the
pool's ``roi_pool_backward`` (the kernel on the card). A narrow Res5 model (the port's ``res5_path_cfg`` at FPN 16 over a
narrow ResNet-50, one dense block; res5 2048/512 as JAX's head fixes it)
equals JAX's ``build_model(train=False)`` at the golden tolerances of
``test_torch_port_slice.py``, and one stage-3 step equals
``make_stage3_train_step`` (losses at 1e-4 relative, parameters after it at
1e-6 absolute, the bounds of ``test_torch_port_train_step.py``).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.ops.roi_align import (multilevel_roi_align_fast as jax_fast,
                                     multilevel_roi_align_windowed as jax_windowed)
from afigan_tpu_torch.ops import roi_align as ra
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import assert_detections_match, jax_and_port
from tests.torch_port_train_common import det_batch, jax_stage3_step, port_stage3_step

STRIDES = (4, 8, 16, 32)


N_ROIS, N_LONG = 80, 70


def _pyramid(seed=0, c=8):
    """Four levels of a 128x256 image and 80 ROIs, 70 of them long and thin
    (their samples leave the 48-cell window on p2): past the 64 overflow
    slots the windowed forward keeps truncated values, and the fast
    pooler's scatter backward still takes every sample."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(1, 128 // s, 256 // s, c).astype(np.float32) for s in STRIDES]
    boxes = np.concatenate([rng.rand(N_ROIS, 2) * [200, 90], np.zeros((N_ROIS, 2))], axis=1)
    boxes[:, 2:] = boxes[:, :2] + 4 + rng.rand(N_ROIS, 2) * [56, 36]
    y = rng.rand(N_LONG) * 100
    boxes[:N_LONG] = np.stack([rng.rand(N_LONG) * 8, y, 212 + rng.rand(N_LONG) * 40,
                               y + 8 + rng.rand(N_LONG) * 12], 1)
    return feats, boxes[None].astype(np.float32)


def _rel(got, want, rel=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("impl", ["fast", "windowed"])
def test_windowed_training_route_equals_jax_vjp(impl):
    feats, boxes = _pyramid()
    g = np.random.RandomState(1).randn(N_ROIS, 7, 7, 8).astype(np.float32)
    jfn = jax_fast if impl == "fast" else jax_windowed
    jout, vjp = jax.vjp(lambda *f: jfn(tuple(f) if impl == "fast" else list(f),
                                       jnp.asarray(boxes[0]), STRIDES, 7, 2, True),
                        *(jnp.asarray(f[0]) for f in feats))
    jgrads = vjp(jnp.asarray(g))
    levels = [torch.tensor(f, requires_grad=True) for f in feats]
    out = ra.pool_rois(impl, levels, torch.tensor(boxes), STRIDES, 7, 2, True)
    _, overflow = ra.multilevel_roi_align_windowed([f.detach() for f in levels],
                                                   torch.tensor(boxes), STRIDES, 7,
                                                   return_overflow=True)
    assert int(overflow.sum()) > 64
    _rel(out.detach().numpy()[0], np.asarray(jout))
    out.backward(torch.tensor(g)[None])
    for lv, jg in zip(levels, jgrads):
        _rel(lv.grad.numpy()[0], np.asarray(jg), 1e-5)


def test_route_is_picked_by_mode(monkeypatch):
    """``gather_windows`` copies the windows on both routes; under no_grad
    nothing is differentiable, under autograd the backward goes through
    ``roi_pool_backward`` once and every level that requires grad gets a
    gradient, nonzero where ROIs are routed; the same forward values both
    ways."""
    from afigan_tpu_torch.ops.kernels import roi_pool as rp

    feats, boxes = _pyramid(2)
    calls = {"gather": 0, "backward": 0}
    real_gather, real_bwd = ra.gather_windows, rp.roi_pool_backward

    def gather(*a, **k):
        calls["gather"] += 1
        return real_gather(*a, **k)

    def backward(*a, **k):
        calls["backward"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(ra, "gather_windows", gather)
    monkeypatch.setattr(rp, "roi_pool_backward", backward)
    levels = [torch.tensor(f).requires_grad_(True) for f in feats]
    with torch.no_grad():
        a = ra.pool_rois("fast", levels, torch.tensor(boxes), STRIDES, 7)
    assert calls["gather"] == 1 and not a.requires_grad
    b = ra.pool_rois("fast", levels, torch.tensor(boxes), STRIDES, 7)
    assert calls["gather"] == 2 and b.requires_grad
    torch.testing.assert_close(b.detach(), a, rtol=0, atol=0)
    b.sum().backward()
    assert calls == {"gather": 2, "backward": 1}
    routed = set(ra._route(levels, torch.tensor(boxes), STRIDES)[1].flatten().tolist())
    assert routed and all(lv.grad is not None for lv in levels)
    assert all((levels[i].grad.abs().sum() > 0) == (i in routed) for i in range(len(levels)))


def res5_cfg():
    """``res5_path_cfg`` (the RPN and the heads on p4) over a narrow
    ResNet-50 + FPN 16 (one dense block), the golden test's settings."""
    from afigan_tpu_torch.config import res5_path_cfg

    cfg = res5_path_cfg()
    cfg.merge_from_list([
        "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
        "MODEL.FPN.OUT_CHANNELS", "16", "MODEL.AFI.GROWTH_RATE", "8", "MODEL.AFI.N_RDB", "1",
        "MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
        "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
        "MODEL.RPN.PRE_NMS_TOPK_TEST", "128", "MODEL.RPN.POST_NMS_TOPK_TEST", "64",
        "TEST.DETECTIONS_PER_IMAGE", "16", "INPUT.MIN_SIZE_TEST", "96",
        "INPUT.MAX_SIZE_TEST", "128", "TPU.IMAGE_BUCKETS", "((128, 128),)"])
    return cfg


@functools.lru_cache(maxsize=None)
def _models():
    return jax_and_port(res5_cfg())


def test_res5_keys_are_d2s():
    _, _, tm, sd = _models()
    heads = {k.split(".")[1] for k in sd if k.startswith("roi_heads.")}
    assert heads == {"res5", "box_predictor", "mask_head"}
    assert {f"roi_heads.res5.{i}.conv1.weight" for i in range(3)} <= set(sd)
    assert {"roi_heads.res5.0.shortcut.weight", "roi_heads.mask_head.deconv.weight",
            "roi_heads.mask_head.predictor.weight"} <= set(sd)
    assert tuple(tm.roi_heads.res5[2].conv3.weight.shape) == (2048, 512, 1, 1)


def test_res5_inference_equals_jax():
    jm, variables, tm, _ = _models()
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    sizes = np.asarray([[128, 128], [96, 128]], np.int32)
    want, want_masks = jax.jit(lambda v: jm.apply(v, jnp.asarray(img),
                                                  jnp.asarray(sizes)))(variables)
    with torch.no_grad():
        got, masks = tm(torch.tensor(img), torch.tensor(sizes))
    assert tuple(masks.shape) == (2, 16, 14, 14)
    for i in range(2):
        sub = lambda d: type(d)(*(None if t is None else t[i:i + 1] for t in d))  # noqa: E731
        assert_detections_match(sub(got), masks[i:i + 1], sub(want),
                                np.asarray(want_masks)[i:i + 1])


RES5_STEP = ("MODEL.ROI_HEADS.NAME", "Res5ROIHeads", "MODEL.ROI_HEADS.IN_FEATURES", "('p4',)",
             "MODEL.RPN.IN_FEATURES", "('p4',)", "MODEL.ANCHOR_GENERATOR.SIZES", "((16, 32),)",
             "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "14")


def test_res5_stage3_step_equals_jax():
    batch = det_batch()
    params, want, jafter = jax_stage3_step(RES5_STEP, batch)
    got, before, after = port_stage3_step(params, RES5_STEP, batch)
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
            "total_loss")
    assert set(keys) <= set(want) and got["loss_box_reg"] > 0 and got["loss_mask"] > 0
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    want_sd = variables_to_state_dict({"params": jafter})
    moved = {k for k in after if not torch.equal(before[k], after[k])}
    # the gradient reaches the pyramid through the pooler's scatter
    assert {"roi_heads.res5.0.conv1.weight", "roi_heads.mask_head.deconv.weight",
            "backbone.fpn_output4.weight", "backbone.fpn_lateral4.weight"} <= moved
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want_sd[k], rtol=0, atol=1e-6, err_msg=k)
