"""The port's solver against the JAX package's, on the CPU: the warm-up
multi-step schedule's values, the frozen parameters of ``FREEZE_AT`` /
``AFI_FREEZE``, and three SGD (and AdamW, and SGD with gradient clipping by
value and by global norm) steps of a small module with a norm, biases and
weights under ``BIAS_LR_FACTOR`` 2 and three different decays against the
JAX package's optax chain on the same gradients (1e-6).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn as nn

from afigan_tpu.config import get_cfg as jax_get_cfg
from afigan_tpu.engine import solver as jsolver
from afigan_tpu_torch.config import get_cfg
from afigan_tpu_torch.engine import solver


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedule_equals_jax(method):
    args = (0.02, (30, 50), 0.1, 1.0 / 1000, 20, method)
    ours, theirs = solver.warmup_multistep_schedule(*args), jsolver.warmup_multistep_schedule(*args)
    for it in (0, 1, 7, 19, 20, 29, 30, 31, 49, 50, 80):
        np.testing.assert_allclose(ours(it), float(theirs(it)), rtol=1e-6, err_msg=str(it))


def test_freeze_predicates():
    cfg = get_cfg()
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.AFI_FREEZE = True
    preds = solver.frozen_predicates(cfg)
    frozen = ["backbone.bottom_up.stem.conv1.weight", "backbone.bottom_up.res2.0.conv1.weight",
              "backbone.srf_module.Generators.0.0.0.bias"]
    live = ["backbone.bottom_up.res3.0.conv1.weight", "backbone.fpn_lateral2.weight",
            "roi_heads.box_head.fc1.bias", "proposal_generator.rpn_head.conv.weight"]
    assert all(any(p(n) for p in preds) for n in frozen)
    assert not any(p(n) for p in preds for n in live)
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.AFI_FREEZE = False
    assert solver.frozen_predicates(cfg) == []


class _Small(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 1)
        self.norm = nn.GroupNorm(2, 4)
        self.fc = nn.Linear(4, 2)


def _jax_params(m):
    t = lambda x: jnp.asarray(x.detach().numpy())  # noqa: E731
    return {"conv": {"kernel": t(m.conv.weight), "bias": t(m.conv.bias)},
            "norm": {"scale": t(m.norm.weight), "bias": t(m.norm.bias)},
            "fc": {"kernel": t(m.fc.weight), "bias": t(m.fc.bias)}}


_NAMES = {("conv", "kernel"): "conv.weight", ("conv", "bias"): "conv.bias",
          ("norm", "scale"): "norm.weight", ("norm", "bias"): "norm.bias",
          ("fc", "kernel"): "fc.weight", ("fc", "bias"): "fc.bias"}


@pytest.mark.parametrize("optimizer,clip", [("SGD", ""), ("ADAMW", ""), ("SGD", "value"),
                                            ("SGD", "norm")])
def test_optimizer_steps_equal_the_jax_chain(optimizer, clip):
    cfgs = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.SOLVER.OPTIMIZER = optimizer
        cfg.SOLVER.BASE_LR = 0.1
        cfg.SOLVER.WEIGHT_DECAY = 0.01
        cfg.SOLVER.WEIGHT_DECAY_NORM = 0.002
        cfg.SOLVER.WEIGHT_DECAY_BIAS = 0.03
        cfg.SOLVER.BIAS_LR_FACTOR = 2.0
        cfg.SOLVER.WARMUP_ITERS = 2
        cfg.SOLVER.STEPS = (2,)
        cfg.SOLVER.CLIP_GRADIENTS.ENABLED = bool(clip)
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = clip or "value"
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 0.5
        cfgs.append(cfg)
    torch.manual_seed(0)
    model = _Small()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.5)
    params = _jax_params(model)
    tx, _ = jsolver.build_optimizer(cfgs[0], params)
    opt_state = tx.init(params)
    opt, sched, _ = solver.build_optimizer(cfgs[1], model)
    groups = {n: (g["weight_decay"], g["lr_factor"]) for g in opt.param_groups
              for n in g["names"]}
    if optimizer == "SGD":
        assert groups == {"conv.weight": (0.01, 1.0), "conv.bias": (0.03, 2.0),
                          "norm.weight": (0.002, 1.0), "norm.bias": (0.002, 1.0),
                          "fc.weight": (0.01, 1.0), "fc.bias": (0.03, 2.0)}
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
                             params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for (mod, leaf), name in _NAMES.items():
            model.get_parameter(name).grad = torch.tensor(np.asarray(grads[mod][leaf]))
        solver.clip_gradients(cfgs[1], model.parameters())
        opt.step()
        sched.step()
    for (mod, leaf), name in _NAMES.items():
        np.testing.assert_allclose(model.get_parameter(name).detach().numpy(),
                                   np.asarray(params[mod][leaf]), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
