"""The port's stage 2 (the AF extractor: the detector on the x0.5 images with
the discriminator D against the frozen guide) against
``afigan_tpu/engine/stage2.py``, float32 on the CPU.

The step-2 YAML (Mask R-CNN R-50-FPN(AFI), half-size anchors) at the narrow
widths of the JAX package's stage-1 tests (AF interpolator and FPN 16
channels, one dense block of growth 8) and the small RPN / ROI sampling of
the stage-3 tests, lr 0.001 with no warm-up; the guide sees two 256x256
images, the detector their 128x128 halves with two GT boxes each (at 64x64
the detector's p6 is 1x1, and D's batch norm over two values a channel is
ill-conditioned: see ``tests/test_torch_port_stage1.py``). The JAX
init's weights reach the port through the converters, with the FrozenBN
statistics of the detector and of the guide calibrated on their images; both
packages draw the same subsample keys (``tests/torch_port_train_common.py``).
The JAX step's gradients are read out of its own optimizer: the test wraps
the detector's optax transform so that its state carries the gradient it
was given. Tolerances: the metrics at 1e-4 relative; each trainable gradient
at 1e-3 of its largest entry, or 1e-5 of the largest of all where a tensor's
sums cancel. A gradient of the ResNet's res3-res5 alone may instead be held
to twice the port's own spread, capped at 5e-3 of its largest entry: the
change in the port's gradient when the x0.5 images are scaled by 1 + 1e-6
(the deep ResNet gradients of this random detector move by up to 5e-2 of
their largest entry under it, with or without the adversarial term). The
test prints each tensor that needed the spread, with its error and bound
(one does: res3.2.conv3, 1.9e-3 against 3.7e-3);
after one step the detector's parameters at 1e-6 absolute, D's
running statistics at 1e-5 and D's parameters by their update as in
``tests/test_torch_port_stage1.py``.

Also: "real" (the guide's levels resized by half) against
``jax.image.resize`` on odd and even maps, ``gan_levels`` on every YAML under
``configs/``, and the FCOS step-2 YAML accepted (``tests/test_torch_port_fcos_train.py``
holds its step against JAX).
"""

import functools
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import afigan_tpu.engine.stage2 as jstage2
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu_torch.engine import stage2
from afigan_tpu_torch.utils.converters import discriminator_state_dict, variables_to_state_dict
from tests.torch_port_common import REPO
from tests.torch_port_train_common import (GradsInState, calibrated_guide,
                                           calibrated_jax_params, det_batch, patch_jax_sampler,
                                           port_draws)

STEP2_YAML = (f"{REPO}/configs/step2_af_extractor_training/"
              "step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml")
STAGE2_OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI.IN_CHANNELS", "16", "MODEL.AFI.N_RDB", "1",
    "MODEL.AFI.GROWTH_RATE", "8", "MODEL.FPN.OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]
LEVELS = ("p2", "p3", "p4", "p5", "p6")
# the gradients that may be held to the port's spread (see the docstring)
DEEP_RESNET = tuple(f"backbone.bottom_up.res{i}." for i in (3, 4, 5))


def stage2_cfgs():
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(STEP2_YAML)
        cfg.merge_from_list(list(STAGE2_OVERRIDES))
        out.append(cfg)
    return out


def stage2_batch():
    """A collated dual-scale batch: two 256x256 images, their 2x2-mean halves
    and the half-scale GT of ``det_batch``."""
    img = (np.random.RandomState(5).rand(2, 256, 256, 3) * 255).astype(np.float32)
    return {"image": img, "image_x0.5": img.reshape(2, 128, 2, 128, 2, 3).mean(axis=(2, 4)),
            "image_sizes_x0.5": np.asarray([[128, 128]] * 2, np.int32),
            "gt_x0.5": det_batch()["gt"]}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX step, once per file: (weights before: detector params, D
    params and statistics, guide params), metrics, gradients, (detector, D
    params, D statistics) after; numpy."""
    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        real_build = jstage2.build_optimizer

        def build(cfg, params, frozen=(), *a, **k):
            tx, sched = real_build(cfg, params, frozen, *a, **k)
            return (GradsInState(tx) if frozen else tx), sched

        mp.setattr(jstage2, "build_optimizer", build)
        jcfg, cfg = stage2_cfgs()
        batch = stage2_batch()
        gt = JaxGroundTruth(*(jnp.asarray(batch["gt_x0.5"][k])
                              for k in ("boxes", "classes", "valid", "masks")))
        det, disc, guide = jstage2.make_stage2_models(jcfg)
        kd, kdd, kg, ks = jax.random.split(jax.random.PRNGKey(0), 4)
        det_vars = jax.jit(lambda: det.init(
            {"params": kd, "sampling": ks, "dropout": ks}, jnp.zeros((1, 128, 128, 3)),
            jnp.asarray([[128, 128]], jnp.int32), jax.tree.map(lambda a: a[:1], gt)))()
        d_vars = jax.jit(disc.init)(kdd, jnp.zeros((1, 16, 16, 16)))
        guide_vars = jax.jit(guide.init)(kg, jnp.zeros((1, 256, 256, 3)))
        np_tree = functools.partial(jax.tree.map, np.asarray)
        det_params = calibrated_jax_params(np_tree(det_vars["params"]), cfg,
                                           batch["image_x0.5"])
        guide_params = calibrated_guide(cfg, np_tree(guide_vars["params"]), batch["image"])
        d_params, d_stats = np_tree(d_vars["params"]), np_tree(d_vars["batch_stats"])
        dtx, _ = build(jcfg, det_params, jstage2._det_frozen_predicates(jcfg))
        ddx, _ = build(jcfg, d_params)
        state = jstage2.Stage2State(det_params, {}, dtx.init(det_params), d_params, d_stats,
                                    ddx.init(d_params), jnp.zeros((), jnp.int32))
        new, metrics = jstage2.make_stage2_train_step(jcfg)(
            state, {"params": guide_params},
            {"image": jnp.asarray(batch["image"]), "image_x0.5": jnp.asarray(batch["image_x0.5"]),
             "image_sizes_x0.5": jnp.asarray(batch["image_sizes_x0.5"]), "gt": gt},
            jax.random.PRNGKey(1))
        return ((det_params, d_params, d_stats, guide_params),
                {k: float(v) for k, v in metrics.items()}, np_tree(new.det_opt[1]),
                (np_tree(new.det_params), np_tree(new.d_params), np_tree(new.d_stats)))
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _port_run(scale=1.0):
    """The port's step from the same weights, the x0.5 images times
    ``scale``: (state dict before, metrics, {name: gradient} of the trainable
    parameters, the state)."""
    (det_params, d_params, d_stats, guide_params), _, _, _ = _jax_run()
    cfg = stage2_cfgs()[1]
    state = stage2.init_stage2_state(cfg, device="cpu")
    for module, sd in ((state.model, variables_to_state_dict({"params": det_params})),
                       (state.guide, variables_to_state_dict({"params": guide_params})),
                       (state.discriminator,
                        discriminator_state_dict({"params": d_params, "batch_stats": d_stats}))):
        module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in state.model.named_parameters() if p.requires_grad]
    try:
        batch = stage2_batch()
        batch["image_x0.5"] = batch["image_x0.5"] * np.float32(scale)
        metrics = stage2.train_step(cfg, state, stage2.batch_to_device(batch, "cpu"),
                                    draws=port_draws)
    finally:
        for h in hooks:
            h.remove()
    return before, metrics, grads, state


def test_step_metrics_equal_jax():
    _, want, _, _ = _jax_run()
    _, got, _, _ = _port_run()
    assert set(got) == set(want)
    for k in ("total_loss", "d_loss", "loss_mask", "diag_fg_frac", "adv_loss_p6",
              "content_loss_p2", "d_loss_p2"):
        assert k in got, k
    assert got["diag_fg_frac"] > 0 and got["loss_mask"] > 0
    for k, w in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)


def test_trainable_gradients_equal_jax():
    _, _, jgrads, _ = _jax_run()
    _, _, grads, _ = _port_run()
    _, _, moved, _ = _port_run(1.0 + 1e-6)
    want = variables_to_state_dict({"params": jgrads})
    assert grads and set(grads) <= set(want)
    # the GAN terms reach the AF interpolator and the layers before it
    assert any("srf_module" in n for n in grads) and any("fpn_lateral" in n for n in grads)
    assert not any(".stem." in n or ".res2." in n for n in grads)  # FREEZE_AT 2
    top = max(float(np.abs(want[n]).max()) for n in grads)
    spread_used = {}
    for name, g in grads.items():
        w = want[name]
        largest = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        if err <= max(1e-3 * largest, 1e-5 * top):
            continue
        # the port's own spread, at most 5e-3 of the tensor's largest entry
        bound = min(2 * float((g - moved[name]).abs().max()), 5e-3 * largest)
        spread_used[name] = f"err {err / largest:.2e}, bound {bound / largest:.2e} of the largest"
        assert err <= bound, (name, spread_used[name])
    print("gradients held to the port's spread:", spread_used)
    assert all(n.startswith(DEEP_RESNET) for n in spread_used), spread_used


def test_detector_after_one_step_equals_jax():
    _, _, _, (jdet, _, _) = _jax_run()
    before, _, grads, state = _port_run()
    want = variables_to_state_dict({"params": jdet})
    moved = set()
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
        if not torch.equal(before[k], v):
            moved.add(k)
    assert moved <= set(grads)
    assert {"backbone.srf_module.Generators.0.0.0.weight", "backbone.fpn_lateral2.weight",
            "roi_heads.box_predictor.cls_score.weight"} <= moved


def test_discriminator_after_one_step_equals_jax():
    (_, d_p0, d_s0, _), _, _, (_, d_p1, d_s1) = _jax_run()
    _, _, _, state = _port_run()
    want = discriminator_state_dict({"params": d_p1, "batch_stats": d_s1})
    before = discriminator_state_dict({"params": d_p0, "batch_stats": d_s0})
    got = {k: v.numpy() for k, v in state.discriminator.state_dict().items()}
    assert set(got) == set(want)
    assert all(p.grad is None for p in state.discriminator.parameters())
    top = max(float(np.abs(want[k] - before[k]).max()) for k in got if "running_" not in k)
    for k, v in got.items():
        assert not np.array_equal(want[k], before[k]), k
        if "running_" in k:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)
            continue
        upd, want_upd = v - before[k], want[k] - before[k]
        assert float(np.abs(upd - want_upd).max()) <= max(
            1e-3 * float(np.abs(want_upd).max()), 1e-5 * top), k


@pytest.mark.parametrize("hw", [(13, 21), (12, 20), (7, 1), (1, 1)])
def test_real_equals_jax_resize(hw):
    """``half_resize`` is ``jax.image.resize(f, (b, h//2, w//2, c), "linear")``,
    which anti-aliases when it shrinks: at 1e-6 of the map's scale, odd and
    even sizes (plain bilinear differs by up to 2 at 13x21)."""
    h, w = hw
    f = np.random.RandomState(h * w).randn(2, h, w, 4).astype(np.float32) * 3
    want = np.asarray(jax.image.resize(jnp.asarray(f), (2, h // 2, w // 2, 4), "linear"))
    got = stage2.half_resize(torch.tensor(f)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(f).max())


YAMLS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, REPO))
def test_gan_levels_equal_jax(path):
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make, fn in ((jax_get_cfg, jstage2.gan_levels), (get_cfg, stage2.gan_levels)):
        cfg = make()
        cfg.merge_from_file(path)
        try:
            out.append(fn(cfg))
        except ValueError as e:  # the same refusal on both sides
            out.append(type(e))
    assert out[0] == out[1]


def test_fcos_step2_config_refused_before_anything_is_built(monkeypatch, tmp_path):
    """The FCOS step-2 YAML trains (below), and with PreciseBN
    (``TEST.PRECISE_BN.ENABLED`` with an evaluation period), which the port
    refused before it was ported, the stage-2 trainer now has the PreciseBN
    hook over its BiFPN's batch norm that trains, before the evaluation, fed
    the half-resolution images of dual-scale batches (JAX's stage-2
    ``run_precise_bn``)."""
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.engine import trainers
    from afigan_tpu_torch.engine.precise_bn import PreciseBNHook, batch_norms, precise_bn_hook
    from afigan_tpu_torch.engine.train_loop import EvalHook
    from afigan_tpu_torch.engine.trainers import AFExtractorTrainer
    from tests.torch_port_gan_tiny import FCOS_NARROW

    cfg = get_cfg()
    cfg.merge_from_file(f"{REPO}/configs/step2_af_extractor_training/"
                        "step2_af_extractor_fcos_R_50_BiFPN.yaml")
    cfg.merge_from_list(FCOS_NARROW + ["TEST.PRECISE_BN.ENABLED", "True",
                                       "TEST.EVAL_PERIOD", "10", "OUTPUT_DIR", str(tmp_path)])
    trainer = AFExtractorTrainer(cfg, device="cpu")
    hook = precise_bn_hook(cfg, trainer.model, trainer.run_precise_bn)
    assert isinstance(hook, PreciseBNHook) and hook.period == 10
    # the hooks of the trainer's own loop (no step runs)
    loops = []
    monkeypatch.setattr(trainers.coco, "get_dataset", lambda name: None)
    monkeypatch.setattr(trainers, "build_train_loader", lambda *a, **k: (b for b in ()))

    class Loop:
        def __init__(self, max_iter, hooks, start):
            loops.append(hooks)

        def run(self, run_step):
            pass

    monkeypatch.setattr(trainers, "TrainLoop", Loop)
    trainer.train()
    kinds = [type(h) for h in loops[0]]
    hook = loops[0][kinds.index(PreciseBNHook)]
    assert kinds.index(PreciseBNHook) < kinds.index(EvalHook)
    assert hook.run.func == trainer.run_precise_bn and hook.run.keywords == {"dual_scale": True}
    bns = batch_norms(trainer.model)
    assert bns and all(b.sync for b in bns) and all(
        n.startswith("backbone.") for n, m in trainer.model.named_modules() if m in bns)


def test_fcos_step2_config_builds_the_fcos_detector_for_training(monkeypatch, tmp_path):
    """The FCOS step-2 YAML is no longer refused: the stage-2 state and its
    trainer go straight to building the FCOS detector in training mode (the
    first model built; the test stops the build there)."""
    from afigan_tpu_torch.config import get_cfg
    from afigan_tpu_torch.engine.trainers import AFExtractorTrainer

    class Built(Exception):
        pass

    built = []

    def record(cfg, *a, **k):
        built.append((cfg.MODEL.META_ARCHITECTURE, k.get("train")))
        raise Built  # stop: nothing else is needed

    monkeypatch.setattr(stage2, "build_model", record)
    cfg = get_cfg()
    cfg.merge_from_file(f"{REPO}/configs/step2_af_extractor_training/"
                        "step2_af_extractor_fcos_R_50_BiFPN.yaml")
    cfg.OUTPUT_DIR = str(tmp_path)
    for make in (lambda: stage2.init_stage2_state(cfg, device="cpu"),
                 lambda: AFExtractorTrainer(cfg, device="cpu")):
        with pytest.raises(Built):
            make()
    assert built == [("FCOS", True)] * 2
