"""Cascade Mask R-CNN training in the port against the JAX package, float32 on
the CPU.

(a) ``CascadeROIHeads.losses`` alone against the JAX head in training mode,
on given pyramid features, proposals and GT (two 64x96 images, 32 channels,
4-conv box heads and the mask head with batch norm that trains, 16 ROIs an
image). The proposals are the GT boxes moved to IoUs of 0.3-0.95 with them,
several between 0.5 and 0.7, so that the rematch of stages 1 and 2 turns
stage-0 foreground into background; four proposals an image are invalid and
too few are valid to fill the 16 slots, so some sampled slots are invalid.
A second case sets ``ROI_BOX_CASCADE_HEAD.IOUS`` to (0.4, 0.55, 0.65): the
stage-0 matcher reads them. Compared: every loss and
``diag_fg_frac_stage{k}`` at 1e-4 relative, the gradients into the feature
maps and into the heads' parameters at 1e-3 of each tensor's largest entry
(or 1e-5 of the largest of all), the heads' running statistics after the
call at 1e-6 absolute plus 1e-5 relative. The JAX head runs eagerly (see
``_head_runs``).

(b) One stage-3 step of the cascade YAML's model at narrow widths
(``torch_port_gan_tiny.CASCADE_NARROW``: SyncBN everywhere and training,
FREEZE_AT 2, the AF interpolator trained as the JAX bench's ``s101`` mode)
over a ResNet-50 bottom-up with SyncBN (the PAFPN YAML's
``build_resnet_pafpn_sr_backbone``), on two 64x64 images, against
``make_stage3_train_step``, with the subsample keys fixed on both sides
(``patch_jax_sampler`` / ``port_draws``). Not over the ResNeSt: the
split-attention's ``bn1`` normalises each channel over the two images'
pooled values, and some channel of some block always holds two near-equal
values, whose variance flax computes as E[x^2] - E[x]^2 in float32: at these
widths that cancellation moves the JAX res5 by 0.32 of its largest entry 7
from the float64 answer, the port's (two-pass) by 0.0087. ResNeSt's
training-mode modules are held against JAX one by one instead (c). The
port's seeded weights (every 1-D entry moved off its init by a seeded draw,
the box regressions 30x, each bottleneck's last norm at about 0.1) reach the
JAX tree through the inverse of the port's converter; the JAX gradients come
back through the same converter. PR 7's tolerances: the losses at 1e-4
relative; after the SGD step (lr 0.001) every parameter at 1e-6 absolute and
every running statistic (the frozen stem's and res2's included: they still
normalise by batch statistics and update them, as in JAX) at 1e-6 absolute
plus 1e-5 relative; the frozen parameters bit for bit; each trainable
gradient at 1e-3 of its largest entry or 1e-5 of the largest of all. A
gradient that misses that bound is held instead to 3e-2 of its largest
entry, and only where the port's own gradient misses that bound too when
the images are scaled by 1 + 1e-5, 1 + 3e-5 or 1 + 1e-4. The two packages' pyramids
differ by 1e-5 of their largest entry (the JAX one 9e-6 from float64, the
port's 1.6e-6), and a ReLU of the 4-conv box heads or of the ResNet whose
input lies that close to zero moves whole gradients: the port's own
gradients move by 1-2 % of their largest entry under a 1e-5 scale of the
images and by 1e-5 under 1e-6. The predictors, the mask head and the RPN
head hold PR 7's bound; the test prints the tensors that needed the spread.
(The head alone, on equal features, holds PR 7's bound everywhere: (a).)

(b2) The same step over the cascade YAML's ResNeSt with ResNeSt's public
DCN setting, modulated deformable convs in res3-res5 (the 13 blocks of depth
50), at radix 1 with the deep stem, AVD and the average-pooled shortcut set
explicitly (radix 2 puts the split attention's ``bn1`` back into res2, and
(b)'s cancellation with it), on ``step_batch`` with full GT masks
(``dcn_step_batch``), twice: with the offset predictors as initialised
(zero: every sample on a pixel, where the offsets' gradient is the forward
difference) and with their weights moved off zero. Every loss at 1e-4
relative, the gradients up to the ROI heads by (b)'s rule, the deformable
convs' (offset predictors and weights) among them and non-zero; every
parameter and statistic after the step as in (b). The deformable conv runs through ``DeformConv2dFunction`` (the plain
sampling, the products, the plain adjoint), which the card shares with
the kernels.

(c) ``SplAtConv2d`` (radix 2, cardinality 1 and 2), the bottleneck (AVD,
average-pooled shortcut) and the deep stem in training mode against the
flax modules, eagerly, on two images the second of which is offset by a
per-channel amount of scale 8: outputs at ``1e-4 max|jax| + 1e-5``, the
gradients of the input and of every parameter at 1e-3 of each tensor's
largest entry or 1e-5 of the largest of all, the running statistics after
the call at 1e-6 absolute plus 1e-5 relative. ``bn1`` over two values a
channel passes its input a gradient of (1 - d^2 / (d^2 + eps)) times its
output's, d the half difference of the two: a cancellation that rounding
decides where the two images' pooled values are close; with the offset they
are not.

Also: both Swin cascade YAMLs and both ResNeSt cascade YAMLs build for
training (the Swin's DropPath rates, nothing frozen), the weight decay of the
heads' batch norms, and FREEZE_AT on ResNeSt's names.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import afigan_tpu.engine.stage3 as jstage3
from afigan_tpu.models import build_model as jax_build_model
from afigan_tpu.models.build import build_roi_heads as jax_build_roi_heads
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu.models.rpn import RPNOutput as JaxRPNOutput
from afigan_tpu_torch.engine import stage3
from afigan_tpu_torch.engine.solver import parameter_groups
from afigan_tpu_torch.models import build_model, cascade_roi_heads
from afigan_tpu_torch.models.build import build_roi_heads
from afigan_tpu_torch.models.layers import BatchNorm2d, unfreeze_batch_norms
from afigan_tpu_torch.models.roi_heads import GroundTruth
from afigan_tpu_torch.models.rpn import RPNOutput
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import CASCADE_NARROW
from tests.torch_port_train_common import (GradsInState, patch_jax_sampler, port_draws,
                                           to_jax_variables)

PAFPN_YAML = f"{REPO}/configs/inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml"
STAGES = range(3)
STEP_LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_mask", "total_loss") + tuple(
    f"{k}_stage{s}" for s in STAGES
    for k in ("loss_cls", "loss_box_reg", "diag_fg_frac"))


def cascade_cfgs(extra=(), yaml=PAFPN_YAML):
    """(JAX config, port config) of ``yaml`` at the narrow widths."""
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(yaml)
        cfg.merge_from_list(list(CASCADE_NARROW) + list(extra))
        out.append(cfg)
    return out


def _perturb(state_dict, seed):
    """Every 1-D entry moved off its init by a seeded draw (variances up),
    the box regressions 30x, and each bottleneck's last norm scaled to about
    0.1 (the small-gamma residual init, as ``tools/frozen_bn.py`` sets it:
    random residual branches at full scale make the deep gradients so
    ill-conditioned that float32 summation order alone moves them by
    percents): in place."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in state_dict.items():
            if v.dim() == 1:
                d = torch.from_numpy(0.2 * rs.rand(*v.shape).astype(np.float32))
                v.add_(d if k.endswith("running_var") else d - 0.1)
                if k.endswith("conv3.norm.weight") and ".res" in k:
                    v.mul_(0.1)
            elif k.endswith("bbox_pred.weight"):
                v.mul_(30.0)


def _jax_gt(g):
    return JaxGroundTruth(*(jnp.asarray(g[k]) for k in ("boxes", "classes", "valid", "masks")))


def _assert_grads_equal(grads, want):
    """Each gradient at 1e-3 of its largest entry, or 1e-5 of the largest
    entry of all where a tensor's sums cancel to far below their terms."""
    assert grads and set(grads) <= set(want), sorted(set(grads) - set(want))[:4]
    top = max(float(np.abs(want[n]).max()) for n in grads)
    for name, g in grads.items():
        w = want[name]
        err = float(np.abs(g - w).max())
        assert err <= max(1e-3 * float(np.abs(w).max()), 1e-5 * top), (name, err)


# ---------------------------------------------------------------------------
# (a) the head alone
# ---------------------------------------------------------------------------

HEAD_IMAGE = (64, 96)
HEAD_C = 32
# IoU of each proposal with its GT box: 0.3-0.95, several between 0.5 and 0.7
HEAD_IOUS = (0.95, 0.8, 0.72, 0.66, 0.62, 0.58, 0.55, 0.52, 0.45, 0.3)
# a positive fraction of 0.75, so that the cap of sampled foreground does not
# hide what the stage-0 IoU admits
HEAD_CASES = {"default": (), "ious": ("MODEL.ROI_BOX_CASCADE_HEAD.IOUS", "(0.4, 0.55, 0.65)")}
HEAD_EXTRA = ("MODEL.ROI_HEADS.POSITIVE_FRACTION", "0.75")


def _shrunk(box, iou):
    """``box`` shrunk about its centre to an IoU of ``iou`` with it."""
    x0, y0, x1, y1 = box
    s = np.sqrt(iou)
    cx, cy, w, h = (x0 + x1) / 2, (y0 + y1) / 2, (x1 - x0) * s, (y1 - y0) * s
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def head_inputs():
    """Features (B, H/s, W/s, C) of p2-p5, proposals (B, 16, 4) with 4 invalid
    an image, the GT (B, 4) with 3 valid and their 28x28 masks."""
    rs = np.random.RandomState(11)
    h, w = HEAD_IMAGE
    feats = {f"p{i}": rs.randn(2, h >> i, w >> i, HEAD_C).astype(np.float32)
             for i in range(2, 6)}
    gt = np.zeros((2, 4, 4), np.float32)
    gt[:, :3] = [[4, 6, 40, 44], [30, 10, 90, 40], [50, 30, 80, 62]]
    gt[1] += 2.0
    props, valid = np.zeros((2, 16, 4), np.float32), np.zeros((2, 16), bool)
    for b in range(2):
        for j, iou in enumerate(HEAD_IOUS):
            props[b, j] = _shrunk(gt[b, j % 3], iou)
        props[b, 10:12] = [[60, 2, 94, 20], [2, 48, 30, 63]]  # background
        props[b, 12:] = rs.rand(4, 4) * 40  # invalid
        valid[b, :12] = True
    return {"features": feats, "proposals": props, "valid": valid,
            "scores": rs.randn(2, 16).astype(np.float32),
            "image_sizes": np.asarray([HEAD_IMAGE] * 2, np.int32),
            "gt": {"boxes": gt, "classes": np.asarray([[0, 2, 1, 0], [1, 1, 2, 0]], np.int32),
                   "valid": np.arange(4)[None].repeat(2, 0) < 3,
                   "masks": (rs.rand(2, 4, 28, 28) > 0.5).astype(np.float32)}}


@functools.lru_cache(maxsize=None)
def _head_runs(case):
    """The port's ``CascadeROIHeads.losses`` and the JAX head's training call
    from one set of weights: (port losses, port gradients, port running
    statistics after, JAX losses, JAX gradients, JAX statistics after, the
    port's stage-0 sample), the gradients by name (``features.p{i}`` and the
    heads' state-dict keys)."""
    jcfg, cfg = cascade_cfgs(HEAD_EXTRA + HEAD_CASES[case])
    inp = head_inputs()
    heads = build_roi_heads(cfg, device="cpu")
    heads.init_weights(torch.Generator().manual_seed(2))
    unfreeze_batch_norms(heads)
    heads.train()
    _perturb(heads.state_dict(), 3)
    before = {f"roi_heads.{k}": v.numpy().copy() for k, v in heads.state_dict().items()}

    feats = {k: torch.from_numpy(v).requires_grad_() for k, v in inp["features"].items()}
    g = inp["gt"]
    gt = GroundTruth(torch.from_numpy(g["boxes"]), torch.from_numpy(g["classes"]).long(),
                     torch.from_numpy(g["valid"]), torch.from_numpy(g["masks"]))
    sampled = []
    real = cascade_roi_heads.sample_proposals
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cascade_roi_heads, "sample_proposals",
                   lambda *a, **kw: sampled.append(real(*a, **kw)) or sampled[-1])
        losses = heads.losses(feats, RPNOutput(torch.from_numpy(inp["proposals"]),
                                           torch.from_numpy(inp["scores"]),
                                               torch.from_numpy(inp["valid"])),
                              torch.from_numpy(inp["image_sizes"]), gt, port_draws)
    sum(v for k, v in losses.items() if not k.startswith("diag_")).backward()
    grads = {f"features.{k}": v.grad.numpy() for k, v in feats.items()}
    grads.update({f"roi_heads.{n}": p.grad.numpy() for n, p in heads.named_parameters()
                  if p.grad is not None})
    after = {f"roi_heads.{k}": v.numpy() for k, v in heads.state_dict().items()}

    jm = jax_build_roi_heads(jcfg, train=True)
    jfeats = {k: jnp.asarray(v) for k, v in inp["features"].items()}
    jprops = JaxRPNOutput(jnp.asarray(inp["proposals"]), jnp.asarray(inp["scores"]),
                          jnp.asarray(inp["valid"]))
    jsizes, jgt, key = jnp.asarray(inp["image_sizes"]), _jax_gt(g), jax.random.PRNGKey(4)
    template = jax.eval_shape(lambda: jm.init(
        {"params": key, "sampling": key}, jfeats, jprops, jsizes, jgt))
    variables = to_jax_variables({c: {"roi_heads": t} for c, t in template.items()}, before)
    variables = {c: t["roi_heads"] for c, t in variables.items()}

    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)

        def loss_fn(params, fs):
            out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                fs, jprops, jsizes, jgt, rngs={"sampling": key},
                                mutable=["batch_stats"])
            return sum(v for k, v in out.items() if not k.startswith("diag_")), (out, mut)

        # eagerly (2 s): under jax.jit, XLA's CPU build of this head moves the
        # stage-0 gradients of two ROIs by 1-2 % of the largest entry off the
        # float64 answer, which the eager run and the port both give to 1e-8
        (_, (jlosses, mut)), (gp, gf) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True)(variables["params"], jfeats)
    finally:
        mp.undo()
    np_tree = functools.partial(jax.tree.map, np.asarray)
    jgrads = {f"features.{k}": np.asarray(v) for k, v in gf.items()}
    jgrads.update(variables_to_state_dict({"params": {"roi_heads": np_tree(gp)}}))
    jafter = variables_to_state_dict({"params": {"roi_heads": np_tree(variables["params"])},
                                      "batch_stats": {"roi_heads": np_tree(
                                          mut["batch_stats"])}})
    return ({k: float(v) for k, v in losses.items()}, grads, after,
            {k: float(v) for k, v in jlosses.items()}, jgrads, jafter, sampled[0])


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_cascade_head_losses_equal_jax(case):
    got, _, _, want, _, _, sampled = _head_runs(case)
    names = {f"{k}_stage{s}" for s in STAGES
             for k in ("loss_cls", "loss_box_reg", "diag_fg_frac")} | {"loss_mask"}
    assert set(got) == set(want) == names
    for k in names:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7, err_msg=k)
    # the rematch at 0.6 / 0.7 turns stage-0 foreground into background, and
    # the later stages still regress on something
    fg = [got[f"diag_fg_frac_stage{s}"] for s in STAGES]
    assert fg[0] > fg[1] > fg[2] > 0, fg
    assert all(got[f"loss_box_reg_stage{s}"] > 0 for s in STAGES)
    # 12 valid proposals and 3 GT an image for 16 slots: an invalid slot each
    assert sampled.valid.sum(dim=1).tolist() == [15, 15]


def test_cascade_stage0_matcher_reads_the_cascade_ious():
    default, ious = _head_runs("default")[0], _head_runs("ious")[0]
    assert ious["diag_fg_frac_stage0"] > default["diag_fg_frac_stage0"]


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_cascade_head_gradients_equal_jax(case):
    _, grads, _, _, jgrads, _, _ = _head_runs(case)
    assert {f"features.p{i}" for i in range(2, 6)} <= set(grads)
    for s in STAGES:  # every stage's head and the mask head train
        assert f"roi_heads.box_head.{s}.conv1.norm.weight" in grads
        assert f"roi_heads.box_predictor.{s}.bbox_pred.weight" in grads
    assert "roi_heads.mask_head.mask_fcn1.norm.weight" in grads
    _assert_grads_equal(grads, jgrads)


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_cascade_head_statistics_equal_jax(case):
    _, _, after, _, _, jafter, _ = _head_runs(case)
    stats = [k for k in after if "running_" in k]
    # 4 box-head convs x 3 stages + 4 mask convs, mean and variance each
    assert len(stats) == 2 * (4 * 3 + 4)
    for k in stats:
        np.testing.assert_allclose(after[k], jafter[k], rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# (b) one whole step
# ---------------------------------------------------------------------------

def step_batch():
    """Two 64x64 images, each noise over a ramp of its own direction and
    brightness, 4 GT slots with 3 valid boxes each, 28x28 masks."""
    rs = np.random.RandomState(5)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, :3] = [[6, 6, 40, 34], [20, 22, 60, 58], [36, 4, 62, 30]]
    boxes[1] += 1.0
    img = rs.rand(2, 64, 64, 3).astype(np.float32) * 127
    img[0] += 128 * np.linspace(0.0, 1.0, 64, dtype=np.float32)[None, :, None]
    img[1] += 64 * np.linspace(1.0, 0.0, 64, dtype=np.float32)[:, None, None]
    return {"image": img,
            "image_sizes": np.asarray([[64, 64]] * 2, np.int32),
            "gt": {"boxes": boxes, "classes": np.asarray([[0, 1, 2, 0], [2, 0, 1, 0]], np.int32),
                   "valid": np.arange(4)[None].repeat(2, 0) < 3,
                   "masks": (rs.rand(2, 4, 28, 28) > 0.5).astype(np.float32)}}


# the image scale of the port's own gradient spread, and its cap (see (b))
SPREAD_SCALES, SPREAD_CAP = (1e-5, 3e-5, 1e-4), 3e-2
# the step's bottom-up: a ResNet-50 at the same widths with SyncBN (see (b))
STEP_EXTRA = ("MODEL.BACKBONE.NAME", "build_resnet_pafpn_sr_backbone",
              "MODEL.RESNETS.STEM_OUT_CHANNELS", "16")


def _port_step(cfg, state, batch, scale=1.0):
    """One port train step on ``batch`` with its images scaled by ``scale``:
    (metrics, {name: gradient} of the trainable parameters)."""
    batch = dict(batch, image=batch["image"] * np.float32(scale))
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().numpy().copy()))
        for n, p in state.model.named_parameters() if p.requires_grad]
    try:
        metrics = stage3.train_step(cfg, state, stage3.batch_to_device(batch, "cpu"),
                                    draws=port_draws)
    finally:
        for h in hooks:
            h.remove()
    return metrics, grads


@functools.lru_cache(maxsize=None)
def _step_runs():
    return _steps(STEP_EXTRA)


def _steps(extra, prepare=None, batch=None):
    """The port's step and ``make_stage3_train_step`` from one set of
    weights (``prepare``: a change to the port's state dict before both take
    it) on ``batch`` (``step_batch()`` by default): (port state dict before,
    port metrics, port gradients, port state dict after, JAX metrics, JAX
    gradients, JAX state dict after, the port's gradients with the images
    scaled by 1 + each of ``SPREAD_SCALES``)."""
    jcfg, cfg = cascade_cfgs(extra)
    batch = step_batch() if batch is None else batch
    state = stage3.init_stage3_state(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    _perturb(state.model.state_dict(), 0)
    if prepare is not None:
        prepare(state.model.state_dict())
    before = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}

    det = jax_build_model(jcfg, train=True)
    k = jax.random.PRNGKey(0)
    gt = _jax_gt(batch["gt"])
    template = jax.eval_shape(lambda: det.init(
        {"params": k, "sampling": k, "dropout": k}, jnp.zeros((1, 64, 64, 3)),
        jnp.asarray([[64, 64]], jnp.int32), jax.tree.map(lambda a: a[:1], gt)))
    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        real_build = jstage3.build_optimizer
        mp.setattr(jstage3, "build_optimizer", lambda *a, **kw: (
            lambda tx, sched: (GradsInState(tx), sched))(*real_build(*a, **kw)))
        variables = to_jax_variables(template, before)
        tx, _ = jstage3.build_optimizer(jcfg, variables["params"],
                                        jstage3._frozen_predicates(jcfg))
        jstate = jstage3.Stage3State(variables["params"], variables["batch_stats"],
                                     tx.init(variables["params"]), jnp.zeros((), jnp.int32))
        new, jmetrics = jstage3.make_stage3_train_step(jcfg)(
            jstate, {"image": jnp.asarray(batch["image"]),
                     "image_sizes": jnp.asarray(batch["image_sizes"]), "gt": gt},
            jax.random.PRNGKey(1))
    finally:
        mp.undo()
    np_tree = functools.partial(jax.tree.map, np.asarray)

    spread = {}
    for scale in SPREAD_SCALES:
        moved = stage3.init_stage3_state(cfg, device="cpu")
        moved.model.load_state_dict({k_: torch.from_numpy(v) for k_, v in before.items()})
        spread[scale] = _port_step(cfg, moved, batch, 1.0 + scale)[1]
    metrics, grads = _port_step(cfg, state, batch)
    after = {k_: v.numpy() for k_, v in state.model.state_dict().items()}
    return (before, metrics, grads, after, {k_: float(v) for k_, v in jmetrics.items()},
            variables_to_state_dict({"params": np_tree(new.opt[1])}),
            variables_to_state_dict({"params": np_tree(new.params),
                                     "batch_stats": np_tree(new.stats)}), spread)


@pytest.mark.parametrize("name", STEP_LOSSES)
def test_cascade_step_losses_equal_jax(name):
    _, got, _, _, want, _, _, _ = _step_runs()
    assert set(got) == set(want) == set(STEP_LOSSES)
    assert np.isfinite(got[name])
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-7)
    if name.startswith("diag_fg_frac"):  # every stage regresses on something
        assert got[name] > 0


def _assert_step_grads_equal(grads, jgrads, spread):
    """Each trainable gradient at 1e-3 of its largest entry (or 1e-5 of the
    largest of all), or where the port's own gradient moves past that bound
    under a change of the images' scale, at ``SPREAD_CAP``; the heads that
    the loss reaches first at the first bound.
    Returns {name: note} of the gradients held to the cap."""
    assert not any(".stem." in n or ".res2." in n for n in grads)
    assert set(grads) <= set(jgrads)
    top = max(float(np.abs(jgrads[n]).max()) for n in grads)
    spread_used = {}
    for name, g in grads.items():
        w = jgrads[name]
        largest = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        pr7 = max(1e-3 * largest, 1e-5 * top)
        if err <= pr7:
            continue
        # an ill-conditioned gradient: the port's own moves past PR 7's bound
        # under a change of the images' scale
        own = max(float(np.abs(g - s_[name]).max()) for s_ in spread.values())
        spread_used[name] = f"err {err / largest:.2e}, own spread {own / largest:.2e}"
        assert own > pr7 and err <= SPREAD_CAP * largest, (name, spread_used[name])
    print(f"{len(spread_used)} of {len(grads)} ill-conditioned gradients held to 3e-2:",
          spread_used)
    # the heads that the loss reaches first hold PR 7's bound
    assert not any(n.startswith(("roi_heads.box_predictor", "roi_heads.mask_head",
                                 "proposal_generator")) for n in spread_used), spread_used
    return spread_used


def test_cascade_step_gradients_equal_jax():
    _, _, grads, _, _, jgrads, _, spread = _step_runs()
    for part in ("bottom_up.res3.0.conv2.norm.weight", "bottom_up.res5.2.conv3.weight",
                 "pafpn_output3.norm.weight", "srf_module.Generators.0.0.0.weight",
                 "box_head.2.conv4.norm.weight", "box_predictor.1.bbox_pred.weight",
                 "mask_head.mask_fcn4.norm.weight", "rpn_head.conv.weight"):
        assert any(n.endswith(part) for n in grads), part
    _assert_step_grads_equal(grads, jgrads, spread)


def _assert_step_state_equal(before, grads, after, want):
    """After the SGD step: every parameter at 1e-6 absolute, every running
    statistic (the frozen stem's and res2's, which still train theirs) at
    1e-6 absolute plus 1e-5 relative, the frozen parameters bit for bit."""
    assert set(after) == set(want)
    stats = [k for k in after if "running_" in k]
    frozen = [k for k in after if k not in stats and (".stem." in k or ".res2." in k)]
    assert frozen and any(".stem." in k for k in stats) and any(".res2." in k for k in stats)
    for k, v in after.items():
        if k in stats:
            # every batch norm trains its statistics, the frozen stem's too
            assert not np.array_equal(v, before[k]), k
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        elif k in frozen:
            np.testing.assert_array_equal(v, before[k], err_msg=k)
            np.testing.assert_array_equal(want[k], before[k], err_msg=k)
        else:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
            if not np.array_equal(v, before[k]):
                assert k in grads, k


def test_cascade_step_parameters_and_statistics_equal_jax():
    before, _, grads, after, _, _, want, _ = _step_runs()
    _assert_step_state_equal(before, grads, after, want)


# ---------------------------------------------------------------------------
# (b2) one whole step of the cascade over the deformable ResNeSt
# ---------------------------------------------------------------------------

# the cascade YAML's own ResNeSt bottom-up with ResNeSt's public DCN setting,
# modulated deformable 3x3 convs in res3-res5 (chip_smoke.py's
# narrow_dcn_cfg): their conv2 is the deformable conv, so the split
# attention's bn1 (see (b)) is left only in the frozen res2
DCN_EXTRA = ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", "[False, True, True, True]",
             "MODEL.RESNETS.DEFORM_MODULATED", "True", "MODEL.RESNETS.RADIX", "1",
             "MODEL.RESNETS.DEEP_STEM", "True", "MODEL.RESNETS.AVD", "True",
             "MODEL.RESNETS.AVG_DOWN", "True")
DCN_PARAMS = ("conv2_offset.weight", "conv2_offset.bias", "conv2.weight")


def _offsets_at_zero(state_dict):
    """The offset predictors as initialised (weight and bias zero: every
    sample on a pixel, the mask 0.5): ``_perturb`` moved their biases."""
    with torch.no_grad():
        for k, v in state_dict.items():
            if ".conv2_offset." in k:
                v.zero_()


def _offsets_moved(state_dict):
    """The offset predictors' weights at a seeded scale that moves the taps
    by a fraction of a pixel to a few pixels (their biases as ``_perturb``
    left them)."""
    rs = np.random.RandomState(12)
    with torch.no_grad():
        for k, v in state_dict.items():
            if k.endswith("conv2_offset.weight"):
                v.copy_(torch.from_numpy(0.05 * rs.randn(*v.shape).astype(np.float32)))


DCN_OFFSETS = {"zero": _offsets_at_zero, "moved": _offsets_moved}


def dcn_step_batch():
    """``step_batch`` with every GT mask full. Its random binary masks,
    resampled to the ROIs, give mask targets on the 0.5 threshold, which the
    two frameworks' ROIs (1e-5 apart over this bottom-up) split differently:
    the mask predictor's gradient then moves by 2 % between them while the
    port's own spread is 3e-5. Full masks leave the mask head at 1e-6."""
    batch = step_batch()
    batch["gt"]["masks"] = np.ones_like(batch["gt"]["masks"])
    return batch


@functools.lru_cache(maxsize=None)
def _dcn_step_runs(offsets):
    return _steps(DCN_EXTRA, DCN_OFFSETS[offsets], dcn_step_batch())


def _dcn_params(names):
    return sorted(n for n in names if ".bottom_up.res" in n and n.endswith(DCN_PARAMS)
                  and ".conv2.conv." not in n)


@pytest.mark.parametrize("name", STEP_LOSSES)
@pytest.mark.parametrize("offsets", list(DCN_OFFSETS))
def test_dcn_cascade_step_losses_equal_jax(offsets, name):
    _, got, _, _, want, _, _, _ = _dcn_step_runs(offsets)
    assert set(got) == set(want) == set(STEP_LOSSES)
    assert np.isfinite(got[name])
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("offsets", list(DCN_OFFSETS))
def test_dcn_cascade_step_gradients_equal_jax(offsets):
    """The gradients up to the ROI heads (the bottom-up, the pyramid, the AF
    interpolator, the RPN head) by (b)'s rule, the 13 deformable convs'
    offset predictors (weight and bias) and weights among them, each
    non-zero: at zero offsets too, where the offsets' gradient is the
    forward difference of the map. (b)'s rule and not its first bound alone:
    at the suite's two torch threads the port's own gradients of the moved
    offsets' bottom-up move by 1-24 % of their largest entry under the
    image scales (a sample lies 3.4e-5 from an integer coordinate, where the
    bilinear form's slope jumps, and the 1 + 1e-4 scale can carry it
    across), and JAX's lie 1.0-2.3e-3 from the port's there. The ROI heads' gradients are (a)'s
    and (b)'s subject: at zero offsets one input of stage 0's ``fc1`` ReLU
    lies 6.5e-6 from zero, inside the two frameworks' 1e-5 difference and
    outside the port's own spread, and moves ``fc1.bias``'s gradient by
    1.8 %."""
    before, _, grads, _, _, jgrads, _, spread = _dcn_step_runs(offsets)
    dcn = _dcn_params(grads)
    assert len(dcn) == 3 * 13, dcn  # res3-res5 of the depth-50 ResNeSt: 4 + 6 + 3 blocks
    offset_weights = [n for n in before if n.endswith("conv2_offset.weight")]
    assert any(before[n].any() for n in offset_weights) == (offsets == "moved")
    before_heads = {n: g for n, g in grads.items() if not n.startswith("roi_heads.")}
    assert any(n.startswith("proposal_generator.") for n in before_heads)
    _assert_step_grads_equal(before_heads, jgrads, spread)
    assert all(np.abs(jgrads[n]).max() > 0 and np.abs(grads[n]).max() > 0 for n in dcn)


@pytest.mark.parametrize("offsets", list(DCN_OFFSETS))
def test_dcn_cascade_step_parameters_and_statistics_equal_jax(offsets):
    before, _, grads, after, _, _, want, _ = _dcn_step_runs(offsets)
    _assert_step_state_equal(before, grads, after, want)
    moved = [n for n in _dcn_params(after) if not np.array_equal(after[n], before[n])]
    assert len(moved) == 3 * 13, moved


# ---------------------------------------------------------------------------
# (c) ResNeSt's modules in training mode
# ---------------------------------------------------------------------------

def _module_input(shape, seed):
    """Noise whose second image is offset by a per-channel amount of scale
    8, so that the two images' pooled values differ in every channel (see
    (c) of the module docstring)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    x[1] += 8.0 * rs.randn(shape[-1]).astype(np.float32)
    return x


def _train_module_runs(jm, tm, x, wrap, prefix):
    """``jm`` (training mode) initialised on ``x``, every 1-D leaf moved off
    its init, into ``tm`` through the port's converter; one forward and
    backward of ``sum(out * w)`` in each: (port, JAX) each a dict of the
    output, the input gradient, the parameter gradients and the running
    statistics after, by state-dict key."""
    rs = np.random.RandomState(7)
    variables = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    sd = variables_to_state_dict({c: wrap(t) for c, t in variables.items()})
    assert all(k.startswith(prefix) for k in sd)
    tm_sd = {k[len(prefix):]: torch.tensor(v) for k, v in sd.items()}
    _perturb(tm_sd, 8)
    tm.load_state_dict(tm_sd, strict=True)
    unfreeze_batch_norms(tm)
    tm.train()
    variables = {c: t_ for c, t_ in to_jax_variables(
        {c: wrap(t_) for c, t_ in variables.items()},
        {prefix + k: v.numpy() for k, v in tm_sd.items()}).items()}
    unwrap = functools.partial(_unwrap, wrap)
    variables = {c: unwrap(t_) for c, t_ in variables.items()}

    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx)
    w = rs.randn(*out.shape).astype(np.float32)
    (out * torch.from_numpy(w)).sum().backward()
    named = lambda d: {prefix + k: v for k, v in d.items()}  # noqa: E731
    got = {"out": out.detach().numpy(), "x": tx.grad.numpy(),
           **named({n: p.grad.numpy() for n, p in tm.named_parameters()}),
           **named({k: v.numpy() for k, v in tm.state_dict().items() if "running_" in k})}

    def loss(params, xx):
        y, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (jy, stats)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    want = {"out": np.asarray(jy), "x": np.asarray(gx),
            **variables_to_state_dict({"params": wrap(np_tree(gp))}),
            **{k: v for k, v in variables_to_state_dict(
                {"params": wrap(np_tree(variables["params"])),
                 "batch_stats": wrap(np_tree(stats))}).items() if "running_" in k}}
    return got, want


def _unwrap(wrap, tree):
    """The inverse of ``wrap`` (a function nesting a tree under fixed keys)."""
    probe = wrap("leaf")
    while probe != "leaf":
        (key, probe), = probe.items()
        tree = tree[key]
    return tree


def _in_block(tree, name="conv2"):
    return {"backbone": {"bottom_up": {"res3/block0": {name: tree} if name else tree}}}


def _assert_module_equal(got, want):
    assert set(got) == set(want)
    w = want["out"]
    assert np.abs(got["out"] - w).max() <= 1e-4 * np.abs(w).max() + 1e-5
    stats = [k for k in got if "running_" in k]
    assert stats
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    grads = set(got) - set(stats) - {"out"}
    top = max(float(np.abs(want[k]).max()) for k in grads)
    for k in grads:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= max(1e-3 * float(np.abs(want[k]).max()), 1e-5 * top), (k, err)


@pytest.mark.parametrize("card,stride", [(1, 1), (2, 2)])
def test_splat_conv_trains_as_jax(card, stride):
    from afigan_tpu.models.resnest import SplAtConv2d as JaxSplAt
    from afigan_tpu_torch.models.resnest import SplAtConv2d

    x = _module_input((2, 9, 11, 16), 2)
    jm = JaxSplAt(channels=16, kernel_size=3, stride=stride, groups=card, radix=2,
                  norm="SyncBN", train=True)
    tm = SplAtConv2d(16, 16, 3, stride, groups=card, radix=2, norm="SyncBN")
    got, want = _train_module_runs(jm, tm, x, _in_block,
                                          "backbone.bottom_up.res3.0.conv2.")
    assert {k.split(".")[5] for k in got if "." in k} == {"conv", "bn0", "fc1", "bn1", "fc2"}
    _assert_module_equal(got, want)


def test_bottleneck_trains_as_jax():
    from afigan_tpu.models.resnest import ResNeStBottleneck as JaxBottleneck
    from afigan_tpu_torch.models.resnest import ResNeStBottleneck

    x = _module_input((2, 10, 14, 16), 3)
    kw = dict(stride=2, num_groups=1, norm="SyncBN", stride_in_1x1=False, radix=2,
              avd=True, avg_down=True)
    jm = JaxBottleneck(out_channels=32, bottleneck_channels=8, train=True, **kw)
    tm = ResNeStBottleneck(16, 32, 8, **kw)
    got, want = _train_module_runs(jm, tm, x, lambda t_: _in_block(t_, None),
                                          "backbone.bottom_up.res3.0.")
    assert "backbone.bottom_up.res3.0.shortcut.norm.running_var" in got
    _assert_module_equal(got, want)


def test_deep_stem_trains_as_jax():
    from afigan_tpu.models.resnest import DeepStem as JaxDeepStem
    from afigan_tpu_torch.models.resnest import DeepStem

    x = _module_input((2, 32, 48, 3), 4)
    got, want = _train_module_runs(
        JaxDeepStem(stem_width=8, norm="SyncBN", train=True), DeepStem(8, "SyncBN"), x,
        lambda t_: {"backbone": {"bottom_up": {"stem": t_}}}, "backbone.bottom_up.stem.")
    assert "backbone.bottom_up.stem.conv1_3.norm.running_mean" in got
    _assert_module_equal(got, want)


# ---------------------------------------------------------------------------
# builds, raises and the solver
# ---------------------------------------------------------------------------

SWIN_YAMLS = ("AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml",
              "AFI-GAN_cascade_rcnn_swinL_BiFPN_ST_TTA.yaml")
RESNEST_YAMLS = ("AFI-GAN_cascade_mask_rcnn_ResNeSt101_FPN.yaml",
                 "AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml")


# the Swin YAMLs' depths (2-2-18-2) and window (12) at narrow widths
SWIN_NARROW_WIDTHS = ("MODEL.SWINT.EMBED_DIM", "24", "MODEL.SWINT.NUM_HEADS", "(1, 2, 4, 8)",
                      "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2",
                      "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
                      "MODEL.ROI_BOX_HEAD.CONV_DIM", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64")


@pytest.mark.parametrize("yaml", SWIN_YAMLS)
def test_swin_yamls_build_for_training(yaml):
    """Both Swin cascade YAMLs (at narrow widths, their depths and window
    kept) build for training: the model in training mode, its 24 blocks'
    DropPath rates ``np.linspace(0, DROP_PATH_RATE, 24)`` (0.2), no parameter
    frozen under ``FREEZE_AT -1`` with the AF interpolator trained; the
    BiFPN's SyncBN counts as batch norm that trains; PreciseBN is off in the
    YAML, so the trainers' PreciseBN hook is None there (as JAX's), and on
    with an evaluation period it refreshes the BiFPN's statistics."""
    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.engine.precise_bn import PreciseBNHook, batch_norms, precise_bn_hook
    from afigan_tpu_torch.models.build import trains_batch_norm
    from afigan_tpu_torch.models.swin import DropPath

    cfg = cfg_from_yaml(f"inference/{yaml}")
    cfg.merge_from_list(list(SWIN_NARROW_WIDTHS) + ["MODEL.AFI_FREEZE", "False"])
    assert cfg.MODEL.BACKBONE.FREEZE_AT == -1 and cfg.MODEL.SWINT.DROP_PATH_RATE == 0.2
    # the BiFPN's SyncBN trains: PreciseBN has statistics to refresh
    assert trains_batch_norm(cfg) and cfg.MODEL.BIFPN.NORM == "SyncBN"
    assert not cfg.TEST.PRECISE_BN.ENABLED
    model = stage3.init_stage3_state(cfg, device="cpu").model
    assert precise_bn_hook(cfg, model, print) is None
    on = cfg.clone()
    on.merge_from_list(["TEST.PRECISE_BN.ENABLED", "True", "TEST.EVAL_PERIOD", "5"])
    assert isinstance(precise_bn_hook(on, model, print), PreciseBNHook)
    assert {b.sync for b in batch_norms(model)} == {True}
    assert model.training and all(m.training for m in model.modules())
    blocks = [b for layer in model.backbone.bottom_up.layers for b in layer.blocks]
    want = np.linspace(0, 0.2, 24)
    assert len(blocks) == 24 and len([m for m in model.modules()
                                      if isinstance(m, DropPath)]) == 48
    np.testing.assert_array_equal([b.drop_path1.rate for b in blocks], want)
    np.testing.assert_array_equal([b.drop_path2.rate for b in blocks], want)
    assert all(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("yaml", RESNEST_YAMLS)
def test_resnest_cascade_yamls_build_for_training(yaml):
    """Both ResNeSt cascade YAMLs build for training (at narrow widths) with
    the cascade IoUs of ``ROI_BOX_CASCADE_HEAD.IOUS`` and batch norm that
    trains, the box heads' in the solver's norm group; FREEZE_AT 2 freezes
    the deep stem and res2 by their ResNeSt names; the YAML leaves PreciseBN
    off, so the trainers' PreciseBN hook is None there (as JAX's)."""
    from afigan_tpu_torch.engine.precise_bn import batch_norms, precise_bn_hook

    cfg = cascade_cfgs(yaml=f"{REPO}/configs/inference/{yaml}")[1]
    assert not cfg.TEST.PRECISE_BN.ENABLED
    state = stage3.init_stage3_state(cfg, device="cpu")
    model = state.model
    assert batch_norms(model) and precise_bn_hook(cfg, model, print) is None
    heads = model.roi_heads
    assert [m.thresholds[1] for m in heads.stage_matchers] == list(
        cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS)
    assert isinstance(model.get_submodule("backbone.bottom_up.res4.0.conv2.bn1"), BatchNorm2d)
    assert isinstance(model.get_submodule("roi_heads.box_head.2.conv1.norm"), BatchNorm2d)
    decay = {n: g["weight_decay"] for g in parameter_groups(cfg, model) for n in g["names"]}
    for s in STAGES:
        assert decay[f"roi_heads.box_head.{s}.conv4.norm.weight"] == cfg.SOLVER.WEIGHT_DECAY_NORM
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert "backbone.bottom_up.stem.conv1_2.weight" in frozen
    assert "backbone.bottom_up.res2.0.conv2.bn0.weight" in frozen
    assert all(".stem." in n or ".res2." in n for n in frozen)
    assert model.get_submodule("backbone.bottom_up.res3.0.conv2.fc1").weight.requires_grad
