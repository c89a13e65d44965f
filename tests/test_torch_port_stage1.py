"""The port's stage 1 (AFI-GAN: the generator G and the discriminator D
against the frozen guide) against ``afigan_tpu/engine/stage1.py``, float32 on
the CPU.

The narrow config of the JAX package's own stage-1 tests
(``tests/test_train_stages.py::_stage1_cfg``: AF interpolator 16 channels,
one dense block of growth 8, an R-50-FPN guide of 16 channels) from the
step-1 YAML, lr 0.001 with no warm-up, on a batch of two 128x128 images and
their 64x64 halves. (At 64x64 p6 is 1x1, and D's batch norm over two values a
channel has a gradient that scales with 1/|x1 - x2|: float32 summation order
alone moves D's update there by percents.) The JAX init's weights reach the
port through the converters, the guide's FrozenBN statistics calibrated on the
batch (``afigan_tpu_torch/tools/frozen_bn.py``). Tolerances: the metrics at
1e-4 relative; after one step G's parameters at 1e-6 absolute, D's running
statistics at 1e-5 absolute, and D's parameters by their update (after -
before = lr (g + wd p) at the first SGD step) at 1e-3 of each tensor's largest
update entry, or 1e-5 of the largest of all where a tensor's sums cancel
(the conv biases before a batch norm, whose gradient is zero up to rounding):
D's gradient is the difference of the real and the fake terms, which cancel,
and the two frameworks' float32 convolutions leave it up to 5e-4 of its
largest entry apart (1.7e-6 at lr 0.001, measured).

Also: the discriminator alone (output and statistics after one train-mode
call, and why torch's own batch norm would not do), the adversarial term's
gradient reaching G, and D taking no gradient in the G step.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.engine.solver import build_optimizer
from afigan_tpu.engine.stage1 import Stage1State, make_stage1_models, make_stage1_train_step
from afigan_tpu.models import PatchDiscriminator as JaxDiscriminator
from afigan_tpu_torch.engine import stage1
from afigan_tpu_torch.models.afi import PatchDiscriminator
from afigan_tpu_torch.utils.converters import (discriminator_state_dict, generator_state_dict,
                                               variables_to_state_dict)
from tests.torch_port_common import REPO
from tests.torch_port_train_common import calibrated_guide

STEP1_YAML = f"{REPO}/configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
STAGE1_OVERRIDES = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI.IN_CHANNELS", "16", "MODEL.AFI.N_RDB", "1",
    "MODEL.AFI.GROWTH_RATE", "8", "MODEL.FPN.OUT_CHANNELS", "16",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]


def stage1_cfgs(extra=()):
    """(JAX config, port config) from the step-1 YAML at narrow widths."""
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(STEP1_YAML)
        cfg.merge_from_list(STAGE1_OVERRIDES + list(extra))
        out.append(cfg)
    return out


def stage1_batch(b=2, h=128, w=128, seed=0):
    """Random pixels and their 2x2-mean halves."""
    img = (np.random.RandomState(seed).rand(b, h, w, 3) * 255).astype(np.float32)
    half = img.reshape(b, h // 2, 2, w // 2, 2, 3).mean(axis=(2, 4))
    return {"image": img, "image_x0.5": half}


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX step on the narrow config, once per file: (G params, D params,
    D statistics, guide params) before; metrics; (G, D, D statistics) after."""
    jcfg, cfg = stage1_cfgs()
    batch = stage1_batch()
    g, d, guide = make_stage1_models(jcfg, train=True)
    kg, kd, kguide = jax.random.split(jax.random.PRNGKey(0), 3)
    g_vars = jax.jit(g.init)(kg, jnp.zeros((1, 16, 16, 16)))
    d_vars = jax.jit(d.init)(kd, jnp.zeros((1, 16, 16, 16)))
    guide_vars = jax.jit(guide.init)(kguide, jnp.zeros((1, 128, 128, 3)))
    np_tree = functools.partial(jax.tree.map, np.asarray)
    guide_params = calibrated_guide(cfg, np_tree(guide_vars["params"]), batch["image"])
    g_params, d_params, d_stats = (np_tree(g_vars["params"]), np_tree(d_vars["params"]),
                                   np_tree(d_vars["batch_stats"]))
    g_tx, _ = build_optimizer(jcfg, g_params)
    d_tx, _ = build_optimizer(jcfg, d_params)
    state = Stage1State(g_params, g_tx.init(g_params), d_params, d_stats,
                        d_tx.init(d_params), jnp.zeros((), jnp.int32))
    new, metrics = make_stage1_train_step(jcfg)(
        state, {"params": guide_params}, {k: jnp.asarray(v) for k, v in batch.items()})
    return ((g_params, d_params, d_stats, guide_params),
            {k: float(v) for k, v in metrics.items()},
            (np_tree(new.g_params), np_tree(new.d_params), np_tree(new.d_stats)))


def port_state(extra=()):
    """The port's stage-1 state with the JAX init's weights."""
    (g_params, d_params, d_stats, guide_params), _, _ = _jax_run()
    cfg = stage1_cfgs(extra)[1]
    state = stage1.init_stage1_state(cfg, device="cpu")

    def load(module, sd):
        module.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)

    load(state.guide, variables_to_state_dict({"params": guide_params}))
    load(state.generator, generator_state_dict(g_params))
    load(state.discriminator, discriminator_state_dict({"params": d_params,
                                                         "batch_stats": d_stats}))
    return cfg, state


@functools.lru_cache(maxsize=None)
def _port_run():
    cfg, state = port_state()
    metrics = stage1.train_step(cfg, state, stage1.batch_to_device(stage1_batch(), "cpu"))
    return metrics, state


def test_step_metrics_equal_jax():
    _, want, _ = _jax_run()
    got, _ = _port_run()
    assert set(got) == set(want)  # the JAX dict comes back sorted
    assert len(got) == 2 + 3 * 5
    for k, w in want.items():
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-7, err_msg=k)


def test_generator_after_one_step_equals_jax():
    (g_before, _, _, _), _, (g_after, _, _) = _jax_run()
    _, state = _port_run()
    want, before = generator_state_dict(g_after), generator_state_dict(g_before)
    moved = 0
    for k, v in state.generator.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-6, err_msg=k)
        moved += not np.array_equal(want[k], before[k])
    assert moved == len(want)  # every weight and bias took the step


def test_discriminator_and_statistics_after_one_step_equal_jax():
    (_, d_p0, d_s0, _), _, (_, d_p1, d_s1) = _jax_run()
    _, state = _port_run()
    want = discriminator_state_dict({"params": d_p1, "batch_stats": d_s1})
    before = discriminator_state_dict({"params": d_p0, "batch_stats": d_s0})
    got = {k: v.numpy() for k, v in state.discriminator.state_dict().items()}
    assert set(got) == set(want)
    top = max(float(np.abs(want[k] - before[k]).max()) for k in got if "running_" not in k)
    for k, v in got.items():
        assert not np.array_equal(want[k], before[k]), k  # everything moved
        if "running_" in k:
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5, err_msg=k)
            continue
        upd, want_upd = v - before[k], want[k] - before[k]
        bound = max(1e-3 * float(np.abs(want_upd).max()), 1e-5 * top)
        assert float(np.abs(upd - want_upd).max()) <= bound, k


def test_discriminator_takes_no_gradient_in_the_g_step():
    """Each of D's parameters receives one gradient a step (the D step's),
    and none is left after the step; each of G's receives one (the G step's)."""
    cfg, state = port_state()
    counts = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: counts.__setitem__(n, counts.get(n, 0) + 1))
        for n, p in [*(("D." + n, p) for n, p in state.discriminator.named_parameters()),
                     *(("G." + n, p) for n, p in state.generator.named_parameters())]]
    try:
        stage1.train_step(cfg, state, stage1.batch_to_device(stage1_batch(), "cpu"))
    finally:
        for h in hooks:
            h.remove()
    names = ([f"D.{n}" for n, _ in state.discriminator.named_parameters()]
             + [f"G.{n}" for n, _ in state.generator.named_parameters()])
    assert counts == {n: 1 for n in names}
    assert all(p.grad is None for p in state.discriminator.parameters())
    assert all(p.grad is not None for p in state.generator.parameters())


def test_adversarial_gradient_reaches_the_generator():
    """The counterpart of tests/test_train_stages.py's quirk-Q3 guard: with
    ``ADV_LOSS_WEIGHT`` 0 and 100, one step from the same weights moves G
    differently, so the adversarial term carries gradient into G."""
    out = []
    for w in ("0.0", "100.0"):
        cfg, state = port_state(("MODEL.AFI.ADV_LOSS_WEIGHT", w))
        stage1.train_step(cfg, state, stage1.batch_to_device(stage1_batch(seed=7), "cpu"))
        out.append({k: v.clone() for k, v in state.generator.state_dict().items()})
    assert max(float((out[0][k] - out[1][k]).abs().max()) for k in out[0]) > 1e-8


class _TorchBatchNorm(torch.nn.BatchNorm2d):
    """torch's own batch norm over NHWC, as a plain port would take it."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("norm", ["port", "torch"])
def test_discriminator_equals_jax_after_one_train_call(norm):
    """D's output and running statistics after one train-mode call against
    the JAX ``PatchDiscriminator`` (flax ``BatchNorm``, momentum 0.9): at 1e-5
    with the port's norm. torch's ``nn.BatchNorm2d`` gives the same output but
    moves the running variance by the unbiased batch variance, n/(n-1) times
    flax's: that case must fail the statistics check."""
    x = (np.random.RandomState(3).randn(2, 5, 6, 16) * 2 + 0.5).astype(np.float32)
    jd = JaxDiscriminator(in_channels=16, train=True)
    variables = jax.jit(jd.init)(jax.random.PRNGKey(4), jnp.zeros((1, 5, 6, 16)))
    want, mutated = jd.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    d = PatchDiscriminator(16)
    if norm == "torch":
        for block in list(d.Discriminators[0])[:3]:
            block[0].norm = _TorchBatchNorm(block[0].out_channels, eps=1e-5, momentum=0.1)
    d.load_state_dict({k: torch.tensor(v) for k, v in
                       discriminator_state_dict(jax.tree.map(np.asarray, variables)).items()},
                      strict=False)
    got = d.train()(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))
    stats = discriminator_state_dict({"params": variables["params"],
                                      "batch_stats": mutated["batch_stats"]})
    sd = d.state_dict()
    err = max(float(np.abs(sd[k].numpy() - v).max()) for k, v in stats.items()
              if "running_" in k)
    if norm == "port":
        assert err <= 1e-5
    else:
        assert err > 1e-3
        n = x.shape[0] * x.shape[1] * x.shape[2]
        key = "Discriminators.0.0.0.norm.running_var"
        # 0.9 * 1 + 0.1 * var: torch's batch term is n/(n-1) times flax's
        np.testing.assert_allclose((sd[key].numpy() - 0.9) / (stats[key] - 0.9), n / (n - 1),
                                   rtol=1e-4)
