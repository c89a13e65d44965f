"""FCOS training in the port against the JAX package, float32 on the CPU.

The targets (``fcos_targets`` against ``fcos_targets_single`` under
``jax.vmap``: centre sampling on and off, a location inside two boxes of
equal area, an invalid GT in slot 0), the focal and GIoU losses (values and
gradients against ``jax.grad``, finite and zero at background locations), and
``FCOS._losses`` on the p3-p7 shapes of a 128x128 canvas with its gradients:
exact in the integers, 1e-5 relative in the values, gradients at 1e-5 of
their largest entry.

Then one stage-2 step of the FCOS R-50-BiFPN step-2 YAML against
``make_stage2_train_step``, at the narrow widths of
``tests/test_stage2_fcos_bifpn.py`` (BiFPN 2 x 32 channels with one dense
block of growth 8 in the AF interpolator, D at 32 channels, one tower conv)
and a ResNet-50 at an eighth of its widths, 3 classes, lr 0.001 with no
warm-up; the guide sees two 256x512 images, the detector their 128x256
halves with five valid GT boxes and an invalid slot 0 (at 128x128 p7 is one
pixel: ``tests/torch_port_gan_tiny.py::fcos_stage2_batch``). The port's seeded
weights (FrozenBN statistics calibrated on the images, every 1-D entry moved
off its init, the BiFPN batch norms' running statistics included) reach the
JAX tree through the inverse of the port's converter; no JAX init is
compiled. Tolerances: every metric at 1e-4 relative; after the step the
detector's parameters at 1e-6 absolute, the BiFPN batch norms' running
statistics (moved by the step: flax momentum 0.99) at 1e-6 absolute plus
1e-5 relative, D's parameters by their update and its statistics at 1e-5.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import afigan_tpu.engine.stage2 as jstage2
from afigan_tpu.models.fcos import FCOS as JaxFCOS
from afigan_tpu.models.fcos import _giou_loss, _sigmoid_focal, compute_locations
from afigan_tpu.models.fcos import fcos_targets_single
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu_torch.engine import stage2
from afigan_tpu_torch.models.fcos import fcos_losses, fcos_targets, giou_loss, sigmoid_focal
from afigan_tpu_torch.models.layers import BatchNorm2d
from afigan_tpu_torch.models.roi_heads import GroundTruth
from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
from afigan_tpu_torch.utils.converters import (_discriminator_key, discriminator_state_dict,
                                               variables_to_state_dict)
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import FCOS_NARROW, fcos_stage2_batch
from tests.torch_port_train_common import to_jax_variables

STEP2_FCOS_YAML = (f"{REPO}/configs/step2_af_extractor_training/"
                   "step2_af_extractor_fcos_R_50_BiFPN.yaml")
STRIDES = (8, 16, 32, 64, 128)
SHAPES = [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]  # p3-p7 of a 128x128 canvas
# slot 0 invalid; a 32x32 and a 24x24 box sharing their centre region; a
# p4-sized box; two 16x16 boxes of equal area over one location (a tie)
GT_BOXES = np.array([[0, 0, 0, 0], [8, 8, 40, 40], [12, 12, 36, 36], [20, 24, 100, 110],
                     [40, 40, 56, 56], [44, 44, 60, 60]], np.float32)
GT_CLASSES = np.array([2, 0, 1, 2, 1, 0], np.int32)
GT_VALID = np.array([False, True, True, True, True, True])


def fcos_cfgs():
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(STEP2_FCOS_YAML)
        cfg.merge_from_list(list(FCOS_NARROW))
        out.append(cfg)
    return out


def _flat_locations():
    """(locations, level ranges, strides) of all levels, the JAX package's."""
    locs = [np.asarray(x) for x in compute_locations(SHAPES, STRIDES)]
    soi = [-1, 64, 128, 256, 512, 1e8]
    ranges = np.concatenate([np.tile([[soi[i], soi[i + 1]]], (len(x), 1))
                             for i, x in enumerate(locs)]).astype(np.float32)
    strides = np.concatenate([np.full(len(x), s, np.float32) for s, x in zip(STRIDES, locs)])
    return np.concatenate(locs), ranges, strides


def _gt(batch=2):
    boxes = np.stack([GT_BOXES, GT_BOXES[[0, 3, 2, 1, 5, 4]] + 4.0][:batch])
    classes = np.stack([GT_CLASSES, GT_CLASSES[::-1]][:batch])
    valid = np.stack([GT_VALID, GT_VALID][:batch])
    return boxes, classes, valid


@pytest.mark.parametrize("center_sample", [True, False])
def test_targets_equal_jax(center_sample):
    locs, ranges, strides = _flat_locations()
    boxes, classes, valid = _gt()
    want = jax.vmap(lambda b, c, v: fcos_targets_single(
        jnp.asarray(locs), jnp.asarray(ranges), jnp.asarray(strides),
        JaxGroundTruth(b, c, v), center_sample, 1.5))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    got = fcos_targets(torch.from_numpy(locs), torch.from_numpy(ranges),
                       torch.from_numpy(strides),
                       GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes).long(),
                                   torch.from_numpy(valid)), center_sample, 1.5)
    labels, matched = got[0].numpy(), got[2].numpy()
    np.testing.assert_array_equal(labels, np.asarray(want[0]))
    np.testing.assert_array_equal(matched, np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-5)
    # the case the inputs are there for: positives of several boxes and of
    # two levels; background takes index 0, the invalid slot
    assert (labels >= 0).sum() > 4 and set(matched[labels >= 0].ravel()) >= {1, 2, 3}
    assert (matched[labels < 0] == 0).all() and 0 not in matched[labels >= 0]
    tie = (labels[0] >= 0) & (matched[0] >= 4)
    if center_sample:  # the location both 16x16 boxes hold goes to the first
        assert tie.any() and 4 in matched[0][tie]


def test_focal_and_giou_equal_jax_with_gradients():
    rng = np.random.RandomState(0)
    logits = (rng.randn(64, 3) * 3).astype(np.float32)
    logits[0, 0] = 0.0  # jnp.maximum's tie
    onehot = (rng.rand(64, 3) > 0.7).astype(np.float32)
    want, jg = jax.value_and_grad(lambda x: _sigmoid_focal(x, jnp.asarray(onehot)).sum())(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = sigmoid_focal(x, torch.from_numpy(onehot)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)

    # distances: positives with real targets, background rows with a box's
    # distances seen from outside it (negative), some predictions at 0 (ReLU)
    pred = (rng.rand(64, 4) * 40).astype(np.float32)
    pred[:8] = 0.0
    target = (rng.rand(64, 4) * 40).astype(np.float32)
    target[32:] -= 60.0
    pos = np.arange(64) < 32
    ctr = rng.rand(64).astype(np.float32)

    def jloss(p):
        return jnp.sum(jnp.where(jnp.asarray(pos), _giou_loss(p, jnp.asarray(target)) *
                                 jnp.asarray(ctr), 0.0))

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    g = giou_loss(p, torch.from_numpy(target))
    assert torch.isfinite(g).all()
    got = torch.where(torch.from_numpy(pos), g * torch.from_numpy(ctr),
                      torch.zeros_like(g)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(p.grad).all() and (p.grad[~torch.from_numpy(pos)] == 0).all()
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(
        _giou_loss(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-5, atol=1e-5)


def test_fcos_losses_equal_jax_with_gradients():
    """``FCOS._losses`` of the JAX module (3 classes, the YAML's sizes of
    interest) on random head outputs at the p3-p7 shapes of a 128x128 canvas:
    the three losses and their gradients with respect to every output."""
    rng = np.random.RandomState(1)
    lg = [(rng.randn(2, h, w, 3) * 2).astype(np.float32) for h, w in SHAPES]
    rg = [rng.rand(2, h, w, 4).astype(np.float32) * 3 for h, w in SHAPES]
    ct = [rng.randn(2, h, w, 1).astype(np.float32) for h, w in SHAPES]
    boxes, classes, valid = _gt()
    jm = JaxFCOS(backbone=None, num_classes=3)
    locs = compute_locations(SHAPES, STRIDES)
    jgt = JaxGroundTruth(jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))

    def jfn(lg, rg, ct):
        losses = jm._losses(lg, rg, ct, locs, jgt)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(a) for a in lg], [jnp.asarray(a) for a in rg],
        [jnp.asarray(a) for a in ct])
    ins = [[torch.from_numpy(a).requires_grad_() for a in arrs] for arrs in (lg, rg, ct)]
    got = fcos_losses(*ins, [torch.from_numpy(np.array(x)) for x in locs],
                      GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes).long(),
                                  torch.from_numpy(valid)),
                      num_classes=3, fpn_strides=STRIDES, sizes_of_interest=(64, 128, 256, 512),
                      center_sample=True, pos_radius=1.5)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for tins, jg in zip(ins, jgrads):
        for t, g in zip(tins, jg):
            g = np.asarray(g)
            assert torch.isfinite(t.grad).all()
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                       atol=1e-5 * max(float(np.abs(g).max()), 1e-6))


# ---------------------------------------------------------------------------
# one stage-2 step of the FCOS step-2 YAML
# ---------------------------------------------------------------------------

def _perturb(module, seed):
    """Every 1-D entry of the module's state moved off its value by a seeded
    draw (variances stay positive)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in module.state_dict().items():
            if v.dim() == 1:
                d = torch.from_numpy(0.2 * rng.rand(*v.shape).astype(np.float32))
                v.add_(d if k.endswith("running_var") else d - 0.1)


@functools.lru_cache(maxsize=None)
def _runs():
    """The port's step and the JAX step from one set of weights: (port
    state dicts before, port metrics, port state after, JAX metrics, JAX
    detector variables and D variables after), numpy where JAX."""
    jcfg, cfg = fcos_cfgs()
    batch = fcos_stage2_batch(_gt())
    state = stage2.init_stage2_state(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    calibrate_frozen_bn(state.model, torch.from_numpy(batch["image_x0.5"]))
    calibrate_frozen_bn(state.guide, torch.from_numpy(batch["image"]))
    for i, m in enumerate((state.model, state.guide, state.discriminator)):
        _perturb(m, i)
    sd = {k: {n: v.numpy().copy() for n, v in m.state_dict().items()}
          for k, m in (("det", state.model), ("guide", state.guide),
                       ("D", state.discriminator))}

    g = batch["gt_x0.5"]
    gt = JaxGroundTruth(jnp.asarray(g["boxes"]), jnp.asarray(g["classes"]),
                        jnp.asarray(g["valid"]))
    det, disc, guide = jstage2.make_stage2_models(jcfg)
    k = jax.random.PRNGKey(0)
    det_t = jax.eval_shape(lambda: det.init({"params": k, "sampling": k, "dropout": k},
                                            jnp.zeros((1, 128, 256, 3)),
                                            jnp.asarray([[128, 256]], jnp.int32),
                                            jax.tree.map(lambda a: a[:1], gt)))
    d_t = jax.eval_shape(lambda: disc.init(k, jnp.zeros((1, 32, 32, 32))))
    g_t = jax.eval_shape(lambda: guide.init(k, jnp.zeros((1, 256, 512, 3))))
    det_v = to_jax_variables(det_t, sd["det"])
    guide_v = to_jax_variables(g_t, sd["guide"])
    d_v = to_jax_variables(d_t, sd["D"], _discriminator_key)
    dtx, _ = jstage2.build_optimizer(jcfg, det_v["params"], jstage2._det_frozen_predicates(jcfg))
    ddx, _ = jstage2.build_optimizer(jcfg, d_v["params"])
    jstate = jstage2.Stage2State(det_v["params"], det_v["batch_stats"],
                                 dtx.init(det_v["params"]), d_v["params"], d_v["batch_stats"],
                                 ddx.init(d_v["params"]), jnp.zeros((), jnp.int32))
    new, jmetrics = jstage2.make_stage2_train_step(jcfg)(
        jstate, guide_v,
        {"image": jnp.asarray(batch["image"]), "image_x0.5": jnp.asarray(batch["image_x0.5"]),
         "image_sizes_x0.5": jnp.asarray(batch["image_sizes_x0.5"]), "gt": gt},
        jax.random.PRNGKey(1))
    np_tree = functools.partial(jax.tree.map, np.asarray)

    metrics = stage2.train_step(cfg, state, stage2.batch_to_device(batch, "cpu"))
    after = {k: {n: v.numpy() for n, v in m.state_dict().items()}
             for k, m in (("det", state.model), ("D", state.discriminator))}
    return (sd, metrics, after, {k: float(v) for k, v in jmetrics.items()},
            {"params": np_tree(new.det_params), "batch_stats": np_tree(new.det_stats)},
            {"params": np_tree(new.d_params), "batch_stats": np_tree(new.d_stats)})


def test_stage2_step_metrics_equal_jax():
    _, got, _, want, _, _ = _runs()
    assert set(got) == set(want)
    for k in ("loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr", "d_loss", "total_loss",
              *(f"{m}_p{i}" for m in ("adv_loss", "content_loss", "d_loss")
                for i in range(3, 8))):
        assert k in got, k
    for k, w in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)


def test_stage2_detector_and_bn_statistics_after_one_step_equal_jax():
    sd, _, after, _, jdet, _ = _runs()
    want = variables_to_state_dict(jdet)
    got, before = after["det"], sd["det"]
    assert set(got) == set(want)
    stats = [k for k in got if k.startswith("backbone.") and "running_" in k
             and "bottom_up" not in k]
    # 5 laterals, p6 and 2 layers x 8 separable convs, two statistics each
    assert len(stats) == 2 * 22
    for k in stats:
        assert not np.array_equal(got[k], before[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    moved = {k for k in got if not np.array_equal(got[k], before[k])}
    for k in got:
        if k not in stats:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert {"backbone.srf_module.Generators.0.0.0.weight",
            "backbone.before_bifpn.lateral3.1.weight", "backbone.BiFPNLayer_1_conv7_down.norm.bias",
            "proposal_generator.fcos_head.cls_logits.weight",
            "proposal_generator.fcos_head.bbox_pred.weight",
            "backbone.bottom_up.res3.0.conv1.weight"} <= moved
    assert not any(".stem." in k or ".res2." in k for k in moved)  # FREEZE_AT 2


def test_stage2_discriminator_after_one_step_equals_jax():
    sd, _, after, _, _, jd = _runs()
    want = discriminator_state_dict(jd)
    got, before = after["D"], sd["D"]
    assert set(got) == set(want)
    top = max(float(np.abs(want[k] - before[k]).max()) for k in got if "running_" not in k)
    for k, v in got.items():
        if "running_" in k:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)
            continue
        upd, want_upd = v - before[k], want[k] - before[k]
        assert float(np.abs(upd - want_upd).max()) <= max(
            1e-3 * float(np.abs(want_upd).max()), 1e-5 * top), k


def test_stage2_fcos_models_train_the_bifpn_norms():
    """The detector's BiFPN norms are batch norm that trains (eps 1e-3, flax
    momentum 0.99); the guide's are frozen; D couples p3-p7 at 32 channels."""
    cfg = fcos_cfgs()[1]
    state = stage2.init_stage2_state(cfg, device="cpu")
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 22 and all(m.eps == 1e-3 and abs(m.momentum - 0.01) < 1e-12
                                  for m in bns)
    assert all(m.weight.requires_grad for m in bns)
    assert not any(isinstance(m, BatchNorm2d) for m in state.guide.modules())
    assert state.model.training and not state.guide.training
    assert stage2.gan_levels(cfg) == ("p3", "p4", "p5", "p6", "p7")
    assert state.discriminator.Discriminators[0][0][0].in_channels == 32


def test_bifpn_batch_stats_through_both_converters_after_a_step():
    """The BiFPN's batch-norm entries of the port's detector after the step
    (running statistics moved, affine trained) go into the JAX tree by the JAX
    package's ``state_dict_to_variables`` (the statistics into
    ``batch_stats``) and back by the port's ``variables_to_state_dict``
    unchanged, bit for bit."""
    from afigan_tpu.utils.converters import state_dict_to_variables, translate_d2_key

    _, _, after, _, _, _ = _runs()
    bifpn = {k: v for k, v in after["det"].items()
             if k.startswith(("backbone.before_bifpn.", "backbone.BiFPNLayer_"))}
    norms = {k: v for k, v in bifpn.items() if ".norm." in k or k.split(".")[-2] == "1"}
    variables, report = state_dict_to_variables(bifpn, translate=functools.partial(
        translate_d2_key, frozen_bn=False))
    assert not report["unmatched"] and len(report["matched"]) == len(bifpn)
    stats = [v for coll in ("batch_stats",) for v in jax.tree.leaves(variables[coll])]
    assert len(stats) == sum("running_" in k for k in norms) == 2 * 22
    back = variables_to_state_dict(variables)
    assert set(back) == set(bifpn)
    for k, v in bifpn.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
