"""The port's stage-3 train step against ``make_stage3_train_step``, float32
on the CPU.

The narrow config of the JAX package's own stage-3 tests (ResNet-50 with
FrozenBN and FREEZE_AT 2, FPN 64 with a one-block AF interpolator, RPN 64 /
32 proposals an image, 16 RPN anchors and 16 ROIs sampled an image, masks) on
a batch of two 64x64 images. The JAX init's weights, with the FrozenBN
statistics calibrated on the batch and small-gamma residual branches
(``afigan_tpu_torch/tools/frozen_bn.py``: random weights at identity
statistics are too ill-conditioned to compare two frameworks' gradients),
reach the port through ``variables_to_state_dict``; the subsamples' keys are
fixed on both sides (``patch_jax_sampler``). Tolerances, float32 convs in
other summation orders: the five losses and ``diag_fg_frac`` at 1e-4
relative; each trainable gradient at 1e-3 of its largest entry, or 1e-5 of
the largest entry of all gradients where a tensor's sums cancel to far below
their terms (the JAX gradients mapped through the same converter); after one
SGD step every parameter at 1e-6 absolute (lr 0.001), and the frozen ones
(stem, res2) bit for bit unchanged.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.engine.solver import build_optimizer
from afigan_tpu.engine.stage1 import _det_rngs
from afigan_tpu.engine.stage3 import Stage3State, _frozen_predicates, make_stage3_train_step
from afigan_tpu.models import build_model as jax_build_model
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu_torch.engine.stage3 import batch_to_device, init_stage3_state as port_init
from afigan_tpu_torch.engine.stage3 import _slice, loss_and_grads, train_step
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_train_common import (calibrated_jax_params, det_batch, patch_jax_sampler,
                                           port_draws, stage3_cfgs)

LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
          "diag_fg_frac", "total_loss")


def _jax_gt(g):
    return JaxGroundTruth(*(jnp.asarray(g[k]) for k in ("boxes", "classes", "valid", "masks")))


@functools.lru_cache(maxsize=None)
def _jax_run(extra=()):
    """The JAX step on the narrow config, once per file: (params before,
    losses, gradients, params after), numpy."""
    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        cfg = stage3_cfgs(extra)[0]
        batch = det_batch()
        gt = _jax_gt(batch["gt"])
        det = jax_build_model(cfg, train=True)
        rng = jax.random.PRNGKey(1)
        # init_stage3_state's init, jitted (its eager init of ResNet-50 takes
        # a minute on the CPU)
        variables = jax.jit(lambda: det.init(
            {"params": jax.random.PRNGKey(0), "sampling": rng},
            jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]], jnp.int32),
            jax.tree.map(lambda a: a[:1], gt)))()
        params = calibrated_jax_params(jax.tree.map(np.asarray, variables["params"]),
                                       stage3_cfgs(extra)[1], batch["image"])
        tx, _ = build_optimizer(cfg, params, _frozen_predicates(cfg))
        state = Stage3State(params, {}, tx.init(params), jnp.zeros((), jnp.int32))

        def loss_fn(p):
            losses = det.apply({"params": p}, jnp.asarray(batch["image"]),
                               jnp.asarray(batch["image_sizes"]), gt, rngs=_det_rngs(rng))
            return sum(v for k, v in losses.items() if not k.startswith("diag_")), losses

        (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
        losses = {k: float(v) for k, v in losses.items()}
        losses["total_loss"] = float(total)
        step = make_stage3_train_step(cfg)
        new_state, metrics = step(state, {"image": jnp.asarray(batch["image"]),
                                          "image_sizes": jnp.asarray(batch["image_sizes"]),
                                          "gt": gt}, rng)
        for k in LOSSES:  # the step computes the same losses
            np.testing.assert_allclose(float(metrics[k]), losses[k], rtol=1e-5)
        return (params, losses, jax.tree.map(np.asarray, grads),
                jax.tree.map(np.asarray, new_state.params))
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def _port_run(extra=()):
    """The port's step from the same weights: (state dict before, losses,
    {name: gradient} of the trainable parameters, state dict after)."""
    params = _jax_run()[0]  # the weights do not depend on the extra options
    cfg = stage3_cfgs(extra)[1]
    state = port_init(cfg, device="cpu")
    sd = variables_to_state_dict({"params": params})
    state.model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().clone()))
        for n, p in state.model.named_parameters() if p.requires_grad]
    metrics = train_step(cfg, state, batch_to_device(det_batch(), "cpu"), draws=port_draws)
    for h in hooks:
        h.remove()
    after = {k: v.clone() for k, v in state.model.state_dict().items()}
    return before, metrics, grads, after


@pytest.mark.parametrize("name", LOSSES)
def test_step_losses_equal_jax(name):
    _, want, _, _ = _jax_run()
    _, got, _, _ = _port_run()
    assert np.isfinite(got[name])
    np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-7)


def test_step_samples_foreground():
    """The fixed draws sample foreground ROIs, so every loss carries signal."""
    _, got, _, _ = _port_run()
    assert got["diag_fg_frac"] > 0 and got["loss_mask"] > 0 and got["loss_box_reg"] > 0


def test_trainable_gradients_equal_jax():
    _, _, jgrads, _ = _jax_run()
    _, _, grads, _ = _port_run()
    want = variables_to_state_dict({"params": jgrads})
    assert grads and set(grads) <= set(want)
    top = max(float(np.abs(want[n]).max()) for n in grads)
    for name, g in grads.items():
        w = want[name]
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= max(1e-3 * scale, 1e-5 * top), (name, err, scale, top)


def test_frozen_and_trainable_sets_equal_jax():
    """Trainable in the port ⇔ not masked by the JAX optimizer: stem and res2
    frozen (FREEZE_AT 2), FrozenBN buffers, everything else trained."""
    _, _, grads, _ = _port_run()
    names = set(grads)
    assert not any(".stem." in n or ".res2." in n for n in names)
    assert any(".res3." in n for n in names) and any("srf_module" in n for n in names)
    before, _, _, after = _port_run()
    for k in before:
        if k not in names:
            assert torch.equal(before[k], after[k]), k


def test_parameters_after_one_step_equal_jax():
    _, _, _, jafter = _jax_run()
    before, _, grads, after = _port_run()
    want = variables_to_state_dict({"params": jafter})
    moved = set()
    for k, v in after.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
        if not torch.equal(before[k], v):
            moved.add(k)
    # only trainable parameters move (a zero bias with a zero gradient stays)
    assert moved <= set(grads)
    assert {"roi_heads.box_predictor.cls_score.weight", "backbone.bottom_up.res3.0.conv1.weight",
            "backbone.srf_module.Generators.0.0.0.weight", "backbone.fpn_lateral2.weight",
            "proposal_generator.rpn_head.conv.weight"} <= moved


def test_afi_freeze_keeps_the_generator_and_trains_through_it():
    """MODEL.AFI_FREEZE: the generator's weights stay, its input still gets a
    gradient (the FPN's lateral convs before it move)."""
    before, _, grads, after = _port_run(("MODEL.AFI_FREEZE", "True"))
    afi = [k for k in before if "srf_module" in k]
    assert afi and not any(k in grads for k in afi)
    assert all(torch.equal(before[k], after[k]) for k in afi)
    lateral = [k for k in grads if "fpn_lateral" in k]
    assert lateral and all(float(grads[k].abs().max()) > 0 for k in lateral)


def test_grad_accum_averages_the_micro_batches():
    """TPU.GRAD_ACCUM 2 on the batch of two: gradients and losses are the
    means of the two one-image batches' (1e-6 absolute)."""
    params = _jax_run()[0]
    sd = {k: torch.tensor(v) for k, v in variables_to_state_dict({"params": params}).items()}
    inputs = batch_to_device(det_batch(), "cpu")
    cfg = stage3_cfgs()[1]
    runs = []
    for accum, parts in ((2, [(0, 2)]), (1, [(0, 1), (1, 2)])):
        cfg.TPU.GRAD_ACCUM = accum
        state = port_init(cfg, device="cpu")
        state.model.load_state_dict(sd, strict=True)
        out = []
        for lo, hi in parts:
            state.model.zero_grad(set_to_none=True)
            m = loss_and_grads(cfg, state.model, _slice(inputs, lo, hi), port_draws)
            out.append((m, {n: p.grad.clone() for n, p in state.model.named_parameters()
                            if p.grad is not None}))
        runs.append(out)
    (acc_m, acc_g), = runs[0]
    (m0, g0), (m1, g1) = runs[1]
    for k in acc_m:
        np.testing.assert_allclose(float(acc_m[k]), (float(m0[k]) + float(m1[k])) / 2,
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for n, g in acc_g.items():
        torch.testing.assert_close(g, (g0[n] + g1[n]) / 2, rtol=0, atol=1e-6)
