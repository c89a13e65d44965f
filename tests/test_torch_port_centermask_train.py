"""CenterMask training and batch norm that trains (F4) in the port against the
JAX package, float32 on the CPU.

One stage-3 step of CenterMask R-50-BiFPN(AFI) (the inference YAML with
``MODEL.AFI_FREEZE False``, as the JAX bench trains it) against
``make_stage3_train_step``: a ResNet-50 at an eighth of its widths, BiFPN 2 x
32 channels whose batch norms train, one dense block of growth 8, one tower
conv, 3 classes, the FCOS decode of training at threshold 0 with 64 / 16
candidates (so that the mask branch samples the head's own detections, NMS
included), 8 GT slots (``max_fg`` 8), lr 0.001 with no warm-up, on two
128x256 images (a 128x128 canvas makes p7 one pixel an image, where batch
norm over two values is ill-conditioned). Both packages draw the same
subsample keys (``patch_jax_sampler``); the port pools with ``pallas``, the
JAX package with ``fast`` at 160 % 128 != 0, equal below 64 overflowing ROIs
a call (here at most 16). The port's seeded weights (FrozenBN calibrated on
the batch, every 1-D entry moved off its init, the box regression 30x) reach
the JAX tree through the inverse of the port's converter. Tolerances: the
four losses at 1e-4 relative; each trainable gradient at 1e-3 of its largest
entry or 1e-5 of the largest of all; after the step every parameter at 1e-6
absolute and the BiFPN running statistics at 1e-6 absolute plus 1e-5
relative. The mask branch trains on the FCOS proposals or the GT
(``tests/test_centermask.py``).

Also: ``get_norm``'s BN made trainable (``BatchNorm2d.from_frozen``) against
flax ``nn.BatchNorm`` (eps 1e-5 / momentum 0.9 and 1e-3 / 0.99; one value a
channel included), BN and SyncBN train in ``build_model(train=True)`` and
stay frozen in an eval build (FrozenBN in both), the weight-decay and learning-rate factors of every parameter equal
to the JAX optax chain's by name, a cascade with keypoints (the Res5 heads raise), the
PreciseBN hook of a trainer whose batch norm trains (none where JAX's is None),
a trainer checkpoint of the JAX package read from ``.msgpack``, the canvas divisibility
of every YAML against the JAX package's, and ``stage2_train`` on the FCOS
step-2 YAML for two iterations on a tiny COCO with its half-scale evaluation.
"""

import functools
import glob
import json
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import afigan_tpu.engine.stage3 as jstage3
from afigan_tpu.models import build_model as jax_build_model
from afigan_tpu.models.layers import get_norm as jax_get_norm
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu.ops.image_list import required_size_divisibility as jax_divisibility
from afigan_tpu_torch import stage2_train
from afigan_tpu_torch.data import required_size_divisibility
from afigan_tpu_torch.engine import stage3, trainers
from afigan_tpu_torch.engine.solver import parameter_groups
from afigan_tpu_torch.engine.precise_bn import PreciseBNHook, precise_bn_hook
from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer
from afigan_tpu_torch.models import build_model, centermask
from afigan_tpu_torch.models.build import trains_batch_norm
from afigan_tpu_torch.models.layers import (BatchNorm2d, FrozenBatchNorm2d, get_norm,
                                            unfreeze_batch_norms)
from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
from afigan_tpu_torch.utils.converters import load_state_dict, variables_to_state_dict
from tests.fixtures import make_tiny_coco
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import CENTERMASK_NARROW, centermask_batch
from tests.torch_port_train_common import (GradsInState, patch_jax_sampler, port_draws,
                                           stage3_cfgs, to_jax_variables)

CENTERMASK_YAML = f"{REPO}/configs/inference/AFI-GAN_centermask_R_50_BiFPN.yaml"
LOSSES = ("loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr", "loss_mask", "total_loss")


def centermask_cfgs(extra=()):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(CENTERMASK_YAML)
        cfg.merge_from_list(list(CENTERMASK_NARROW) + list(extra))
        out.append(cfg)
    return out


def _jax_gt(g):
    return JaxGroundTruth(*(jnp.asarray(g[k]) for k in ("boxes", "classes", "valid", "masks")))


@functools.lru_cache(maxsize=None)
def _jax_template():
    jcfg = centermask_cfgs()[0]
    gt = _jax_gt(centermask_batch()["gt"])
    det = jax_build_model(jcfg, train=True)
    k = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: det.init(
        {"params": k, "sampling": k, "dropout": k}, jnp.zeros((1, 128, 256, 3)),
        jnp.asarray([[128, 256]], jnp.int32), jax.tree.map(lambda a: a[:1], gt)))


@functools.lru_cache(maxsize=None)
def _runs():
    """The port's step and the JAX step from one set of weights: (port
    state dict before, port metrics, port gradients, port state dict after,
    JAX metrics, JAX gradients, JAX variables after)."""
    jcfg, cfg = centermask_cfgs()
    batch = centermask_batch()
    state = stage3.init_stage3_state(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    calibrate_frozen_bn(state.model, torch.from_numpy(batch["image"]))
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for k, v in state.model.state_dict().items():
            if v.dim() == 1:
                d = torch.from_numpy(0.2 * rs.rand(*v.shape).astype(np.float32))
                v.add_(d if k.endswith("running_var") else d - 0.1)
            elif k.endswith("bbox_pred.weight"):
                v.mul_(30.0)
    before = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}

    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        real_build = jstage3.build_optimizer
        mp.setattr(jstage3, "build_optimizer", lambda *a, **k: (
            lambda tx, sched: (GradsInState(tx), sched))(*real_build(*a, **k)))
        variables = to_jax_variables(_jax_template(), before)
        tx, _ = jstage3.build_optimizer(jcfg, variables["params"],
                                        jstage3._frozen_predicates(jcfg))
        jstate = jstage3.Stage3State(variables["params"], variables["batch_stats"],
                                     tx.init(variables["params"]), jnp.zeros((), jnp.int32))
        new, jmetrics = jstage3.make_stage3_train_step(jcfg)(
            jstate, {"image": jnp.asarray(batch["image"]),
                     "image_sizes": jnp.asarray(batch["image_sizes"]),
                     "gt": _jax_gt(batch["gt"])}, jax.random.PRNGKey(1))
    finally:
        mp.undo()
    np_tree = functools.partial(jax.tree.map, np.asarray)

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
    after = {k: v.numpy() for k, v in state.model.state_dict().items()}
    return (before, metrics, grads, after, {k: float(v) for k, v in jmetrics.items()},
            variables_to_state_dict({"params": np_tree(new.opt[1])}),
            variables_to_state_dict({"params": np_tree(new.params),
                                     "batch_stats": np_tree(new.stats)}))


@pytest.mark.parametrize("name", LOSSES)
def test_centermask_step_losses_equal_jax(name):
    _, got, _, _, want, _, _ = _runs()
    assert set(got) == set(want) == set(LOSSES)
    assert np.isfinite(got[name]) and got["loss_mask"] > 0
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-7)


def test_centermask_trainable_gradients_equal_jax():
    _, _, grads, _, _, jgrads, _ = _runs()
    assert grads and set(grads) <= set(jgrads)
    # the mask head, the FCOS head, the BiFPN norms and the AF interpolator train
    for part in ("roi_heads.mask_head.spatialAtt.conv.weight", "fcos_head.cls_logits.weight",
                 "BiFPNLayer_0_conv3_up.norm.weight", "srf_module.Generators.0.0.0.weight"):
        assert any(n.endswith(part) for n in grads), part
    top = max(float(np.abs(jgrads[n]).max()) for n in grads)
    for name, g in grads.items():
        w = jgrads[name]
        err = float(np.abs(g - w).max())
        assert err <= max(1e-3 * float(np.abs(w).max()), 1e-5 * top), (name, err)


def test_centermask_parameters_and_statistics_after_one_step_equal_jax():
    before, _, grads, after, _, _, want = _runs()
    assert set(after) == set(want)
    stats = [k for k in after if "running_" in k and "bottom_up" not in k]
    assert len(stats) == 2 * 22
    for k, v in after.items():
        if k in stats:
            assert not np.array_equal(v, before[k]), k
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)
            if not np.array_equal(v, before[k]):
                assert k in grads, k


def test_centermask_mask_branch_trains_on_fcos_proposals(monkeypatch):
    """CenterMask2's protocol, as ``tests/test_centermask.py``: every box the
    mask branch trains on is one of the FCOS head's post-NMS detections of the
    step or a GT box, and some are detections."""
    cfg = centermask_cfgs()[1]
    before = _runs()[0]
    seen = []
    real = centermask.sample_proposals

    def capture(props, valid, gt, *a, **k):
        out = real(props, valid, gt, *a, **k)
        seen.append((props, valid, gt.boxes, out))
        return out

    monkeypatch.setattr(centermask, "sample_proposals", capture)
    state = stage3.init_stage3_state(cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in before.items()})
    stage3.loss_and_grads(cfg, state.model, stage3.batch_to_device(centermask_batch(), "cpu"),
                          port_draws)
    (props, valid, gt_boxes, sampled), = seen
    from_props = 0
    for i in range(props.shape[0]):
        pool = torch.cat([props[i][valid[i]], gt_boxes[i]])
        for box, ok in zip(sampled.boxes[i], sampled.valid[i]):
            if ok:
                hit = (pool == box).all(dim=1)
                assert hit.any(), box
                from_props += bool(hit[:int(valid[i].sum())].any())
    assert valid.any() and from_props > 0


# ---------------------------------------------------------------------------
# batch norm that trains (F4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 1, 1, 8)], ids=["map", "one_value"])
@pytest.mark.parametrize("eps,momentum", [(1e-5, 0.9), (1e-3, 0.99)])
def test_get_norm_trains_as_flax_batch_norm(eps, momentum, shape):
    """Two training steps of ``get_norm("BN")`` made trainable
    (``BatchNorm2d.from_frozen``) against flax's ``nn.BatchNorm``: outputs and their gradients (input, scale, bias) at
    1e-5, the running statistics after each step at 1e-6 (flax's biased
    variance). A channel of one value normalises to the bias, where a
    rounding of its mean is multiplied by 1/sqrt(eps): there the outputs and
    gradients are held at 1e-5 plus two roundings of the largest input so
    amplified."""
    rs = np.random.RandomState(int(eps * 1e5) + shape[0])
    xs = [(rs.randn(*shape) * 3 + 1).astype(np.float32) for _ in range(2)]
    w = rs.randn(*shape).astype(np.float32)
    jm = jax_get_norm("BN", 8, train=True, bn_eps=eps, bn_momentum=momentum)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))
    params = {"scale": jnp.asarray(1 + 0.3 * rs.randn(8).astype(np.float32)),
              "bias": jnp.asarray(0.3 * rs.randn(8).astype(np.float32))}
    stats = {"mean": jnp.asarray(rs.randn(8).astype(np.float32)),
             "var": jnp.asarray(1 + rs.rand(8).astype(np.float32))}
    tol = 1e-5
    if np.prod(shape[:3]) == 1:
        tol += 2.0 ** -22 * float(np.abs(xs).max() * np.abs(params["scale"]).max()) / eps ** 0.5
    tm = BatchNorm2d.from_frozen(get_norm("BN", 8, eps, momentum))
    assert isinstance(tm, BatchNorm2d) and tm.eps == eps
    assert abs(tm.momentum - (1 - momentum)) < 1e-12
    assert set(variables["params"]) == set(params) and set(variables["batch_stats"]) == set(stats)
    tm.load_state_dict({"weight": torch.tensor(np.asarray(params["scale"])),
                        "bias": torch.tensor(np.asarray(params["bias"])),
                        "running_mean": torch.tensor(np.asarray(stats["mean"])),
                        "running_var": torch.tensor(np.asarray(stats["var"]))})
    for x in xs:
        def f(p, x, s=stats):
            y, mut = jm.apply({"params": p, "batch_stats": s}, x, mutable=["batch_stats"])
            return jnp.sum(y * w), (y, mut["batch_stats"])

        (_, (jy, stats)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        tx = torch.from_numpy(x).requires_grad_()
        tm.zero_grad()
        y = tm(tx)
        (y * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=tol)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5, atol=tol)
        np.testing.assert_allclose(tm.weight.grad.numpy(), np.asarray(jgp["scale"]), rtol=1e-5,
                                   atol=tol)
        np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(jgp["bias"]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-6)
    for norm in ("BN", "SyncBN"):  # an eval build keeps the frozen module
        assert isinstance(get_norm(norm, 8, eps, momentum), FrozenBatchNorm2d)
    # a training build unfreezes BN / SyncBN, never FrozenBN
    seq = torch.nn.Sequential(get_norm("FrozenBN", 8), get_norm("SyncBN", 8, eps, momentum))
    assert unfreeze_batch_norms(seq) == 1
    assert isinstance(seq[0], FrozenBatchNorm2d) and isinstance(seq[1], BatchNorm2d)


@pytest.mark.parametrize("key,module", [
    ("MODEL.FPN.NORM", "backbone.fpn_lateral3.norm"),
    ("MODEL.RESNETS.NORM", "backbone.bottom_up.res4.0.conv2.norm"),
    ("MODEL.ROI_MASK_HEAD.NORM", "roi_heads.mask_head.mask_fcn1.norm")])
@pytest.mark.parametrize("norm", ["BN", "SyncBN"])
def test_build_model_trains_batch_norm(key, module, norm):
    """``build_model(train=True)`` gives batch norm that trains (flax
    momentum 0.9, eps 1e-5), in the solver's norm group; the eval build the
    frozen module, as ``FrozenBatchNorm2d`` in JAX's eval."""
    cfg = stage3_cfgs((key, norm, "MODEL.FPN.OUT_CHANNELS", "32"))[1]
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS, cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 32, 8
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    assert trains_batch_norm(cfg)
    model = build_model(cfg, device="cpu", train=True)
    bn = model.get_submodule(module)
    assert isinstance(bn, BatchNorm2d) and bn.eps == 1e-5 and abs(bn.momentum - 0.1) < 1e-12
    assert model.training and bn.weight.requires_grad
    decay = {n: g["weight_decay"] for g in parameter_groups(cfg, model) for n in g["names"]}
    assert decay[module + ".weight"] == decay[module + ".bias"] == cfg.SOLVER.WEIGHT_DECAY_NORM
    assert isinstance(build_model(cfg, device="cpu").get_submodule(module), FrozenBatchNorm2d)


def test_decay_masks_equal_jax_by_name():
    """Every trainable parameter of the CenterMask training model gets the
    weight decay and learning-rate factor of the JAX optax chain: one SGD
    update on zero gradients and unit parameters is -lr * factor * decay a
    leaf (frozen leaves 0), with WEIGHT_DECAY, _BIAS and _NORM and
    BIAS_LR_FACTOR set apart."""
    extra = ("SOLVER.WEIGHT_DECAY", "0.001", "SOLVER.WEIGHT_DECAY_BIAS", "0.003",
             "SOLVER.WEIGHT_DECAY_NORM", "0.005", "SOLVER.BIAS_LR_FACTOR", "2.0",
             "SOLVER.BASE_LR", "1.0")
    jcfg, cfg = centermask_cfgs(extra)
    params = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), _jax_template()["params"])
    tx, _ = jstage3.build_optimizer(jcfg, params, jstage3._frozen_predicates(jcfg))
    updates, _ = tx.update(jax.tree.map(jnp.zeros_like, params), tx.init(params), params)
    want = {k: -float(np.unique(v)[0]) for k, v in variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, updates)}).items()}
    model = stage3.init_stage3_state(cfg, device="cpu").model
    got = {n: g["weight_decay"] * g["lr_factor"] for g in parameter_groups(cfg, model)
           for n in g["names"]}
    assert got and {n for n, v in want.items() if v != 0} == set(got)
    for n, v in got.items():
        assert abs(v - want[n]) < 1e-9, (n, v, want[n])
    seen = {round(v, 6) for v in got.values()}
    assert {0.001, 0.006, 0.005} <= seen  # weights, non-norm biases x2, norms
    assert got["proposal_generator.fcos_head.scales.0.scale"] == 0.001


def test_cascade_training_raises():
    """Cascade R-CNN trains since its losses were ported (and over a Swin
    bottom-up since its DropPath was), and with keypoints since the keypoint
    branch was; the Res5 heads with keypoints raise, as JAX's build does."""
    cfg = stage3_cfgs(("MODEL.ROI_HEADS.NAME", "CascadeROIHeads"))[1]
    assert build_model(cfg, device="cpu", train=True).training
    cfg.MODEL.KEYPOINT_ON = True
    model = build_model(cfg, device="cpu", train=True)
    assert model.training and model.roi_heads.keypoint_on
    assert any(k.startswith("roi_heads.keypoint_head.") for k in model.state_dict())
    cfg.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
    with pytest.raises(ValueError, match="KEYPOINT_ON requires"):
        build_model(cfg, device="cpu", train=True)


def test_precise_bn_raises_with_batch_norm_that_trains(tmp_path):
    """JAX's trainers run PreciseBN every TEST.EVAL_PERIOD when the model has
    batch norm that trains; so does the port now (it refused that
    configuration before PreciseBN was ported): the stage-3 trainer of the
    CenterMask YAML has the hook at the evaluation period with the YAML's
    NUM_ITER, and none where JAX's ``_precise_bn_hook`` returns None (a
    FrozenBN-only model, no period, PreciseBN off)."""
    extra = ("TEST.PRECISE_BN.ENABLED", "True", "TEST.EVAL_PERIOD", "10",
             "OUTPUT_DIR", str(tmp_path), "DATASETS.ROOT", str(tmp_path))
    cfg = centermask_cfgs(extra)[1]
    assert trains_batch_norm(cfg)
    trainer = TargetDetectorTrainer(cfg, device="cpu")
    hook = precise_bn_hook(cfg, trainer.model, trainer.run_precise_bn)
    assert isinstance(hook, PreciseBNHook)
    assert (hook.period, hook.num_iter) == (10, cfg.TEST.PRECISE_BN.NUM_ITER) == (10, 200)
    # nothing to refresh in a FrozenBN-only model, or with no periodic hook
    r50 = stage3_cfgs(extra)[1]
    assert not trains_batch_norm(r50) and not any(
        isinstance(m, BatchNorm2d) for m in build_model(r50, device="cpu", train=True).modules())
    trainer = TargetDetectorTrainer(r50, device="cpu")
    assert precise_bn_hook(r50, trainer.model, trainer.run_precise_bn) is None
    for key, value in (("TEST.EVAL_PERIOD", "0"), ("TEST.PRECISE_BN.ENABLED", "False")):
        off = centermask_cfgs(extra + (key, value))[1]
        trainer = TargetDetectorTrainer(off, device="cpu")
        assert precise_bn_hook(off, trainer.model, trainer.run_precise_bn) is None


def test_msgpack_weights_raise(tmp_path):
    """``.msgpack`` weights used to raise; the port reads them now: a trainer
    checkpoint of the JAX package (its ``opt`` and ``step`` dropped) gives the
    state dict that ``variables_to_state_dict`` gives of its variables, and a
    kind the converters do not know still raises."""
    from flax import serialization

    from afigan_tpu.engine.checkpoint import save_checkpoint

    template = _jax_template()
    rs = np.random.RandomState(3)
    variables = jax.tree.map(lambda a: np.asarray(rs.rand(*a.shape), np.float32), template)
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt": {"0": {"trace": jax.tree.map(np.zeros_like, variables["params"])}},
            "step": np.asarray(100, np.int32)}
    path = save_checkpoint(str(tmp_path), "model_0000100", tree)
    assert path.endswith(".msgpack") and serialization.msgpack_restore(
        open(path, "rb").read())["step"] == 100
    got = load_state_dict(path)
    want = variables_to_state_dict(variables)
    assert set(got) == set(want) and len(got) > 100
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="kind"):
        load_state_dict(path, "keypoint_head")


YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("dual_scale", [False, True])
@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, REPO))
def test_size_divisibility_equals_jax(path, dual_scale):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make, fn in ((jax_get_cfg, jax_divisibility), (get_cfg, required_size_divisibility)):
        cfg = make()
        cfg.merge_from_file(path)
        out.append(fn(cfg, dual_scale=dual_scale))
    assert out[0] == out[1]
    bifpn = "BiFPN" in os.path.basename(path) or "bifpn" in cfg.MODEL.BACKBONE.NAME
    assert out[1] == ((256 if dual_scale else 128) if bifpn else 64)


# ---------------------------------------------------------------------------
# the FCOS step-2 YAML through the data loader and the CLI
# ---------------------------------------------------------------------------

STEP2_FCOS = "configs/step2_af_extractor_training/step2_af_extractor_fcos_R_50_BiFPN.yaml"
FCOS_TINY = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2",
    "MODEL.AFI.IN_CHANNELS", "32", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "4",
    "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3",
    "MODEL.FCOS.INFERENCE_TH_TEST", "0.0", "MODEL.FCOS.PRE_NMS_TOPK_TEST", "64",
    "MODEL.FCOS.POST_NMS_TOPK_TEST", "16", "TEST.DETECTIONS_PER_IMAGE", "16",
    "INPUT.MIN_SIZE_TRAIN", "(96, 112)", "INPUT.MAX_SIZE_TRAIN", "128",
    "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "128",
    "TPU.IMAGE_BUCKETS", "((256, 256),)", "TPU.MAX_GT_BOXES", "8",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.001", "SOLVER.CHECKPOINT_PERIOD", "2",
    "SEED", "3"]


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """The tiny COCO (96x128 images) as ``DATASETS.ROOT`` lays out
    coco_2017_{train,val}."""
    root = tmp_path_factory.mktemp("fcoscoco")
    json_path, img_dir = make_tiny_coco(str(root / "raw"), num_images=4, hw=(96, 128))
    os.makedirs(root / "coco" / "annotations")
    for split in ("train2017", "val2017"):
        shutil.copy(json_path, root / "coco" / "annotations" / f"instances_{split}.json")
        shutil.copytree(img_dir, root / "coco" / split)
    return root, json_path, img_dir


def test_dual_scale_loader_pads_a_bifpn_canvas_to_256(coco_root):
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.data import build_train_loader
    from afigan_tpu_torch.data.coco import CocoDataset

    _, json_path, img_dir = coco_root
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, STEP2_FCOS))
    cfg.merge_from_list(FCOS_TINY + ["TPU.IMAGE_BUCKETS", "((224, 224),)"])
    loader = build_train_loader(cfg, CocoDataset(json_path, img_dir), seed=2, dual_scale=True)
    b = next(loader)
    full, half = b["image"].shape[1:3], b["image_x0.5"].shape[1:3]
    # the 224 bucket rounds up to 256, whose half the BiFPN takes
    assert full == (256, 256) and half == (128, 128)
    assert all(s % 256 == 0 for s in full) and all(s % 128 == 0 for s in half)


def test_stage2_cli_trains_the_fcos_yaml(coco_root, tmp_path):
    root, out = coco_root[0], tmp_path / "s2"
    t = stage2_train.main(stage2_train.parse_args(
        ["--config-file", os.path.join(REPO, STEP2_FCOS), "--device", "cpu", *FCOS_TINY,
         "DATASETS.ROOT", str(root), "OUTPUT_DIR", str(out), "SOLVER.MAX_ITER", "2",
         "TEST.EVAL_PERIOD", "2"]))
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    last = lines[-1]
    assert last["iteration"] == 1 and all(np.isfinite(r["total_loss"]) for r in lines)
    assert {"loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr", "adv_loss_p7",
            "content_loss_p3", "d_loss_p5"} <= set(last)
    assert "bbox/AP" in last  # the half-scale evaluation ran FCOS inference
    assert t.model.training and t.model.return_features
    saved = load_state_dict(str(out / "AFExtractor" / "model_0000002.pth"))
    key = "backbone.BiFPNLayer_1_conv3_up.norm.running_var"
    assert key in saved and not np.allclose(saved[key], 1.0)  # the statistics moved
    assert (out / "Disc" / "model_0000002.pth").is_file()
