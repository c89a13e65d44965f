"""Swin-BiFPN(AFI) Cascade R-CNN training in the port against the JAX package,
float32 on the CPU.

The model is the Swin cascade YAML at the JAX flagship test's tiny widths
with depths 1-2-2-1 (``torch_port_gan_tiny.SWIN_NARROW``) on two 128x128
images: the shifted blocks of the third stage run with their masks on an 8x8
map, wider than the 4x4 window.

(a) ``DropPath``: the schedule is ``np.linspace(0, DROP_PATH_RATE,
sum(DEPTHS))``; one keep draw an image; ``where(mask, x / keep, 0)`` in x's
dtype, bit for bit the JAX module's on the same mask (bfloat16 included);
identity in eval mode and at rate 0, drawing nothing there; one generator
seed, one set of masks.

(b) The training route of the attention (JAX's XLA "split" branch, float32
scores) and of LayerNorm (the jnp branch): outputs and ``jax.grad`` of the
input and of every parameter (the relative-position bias table included) at
1e-5 of each tensor's largest entry.

(c) One stage-3 step of the narrow model against ``make_stage3_train_step``
at ``DROP_PATH_RATE`` 0 and 0.2, the subsample keys fixed on both sides
(``patch_jax_sampler`` / ``port_draws``) and, at 0.2, the same DropPath masks
given to both packages (``jax.random.bernoulli`` patched as the JAX Swin
module sees it; the port's masks through ``drop_path_source``). The port's
seeded weights (every 1-D entry moved off its init, the box regressions 30x)
reach JAX through the inverse of the port's converter. Losses at 1e-4
relative; each trainable gradient at 1e-3 of its largest entry (or 1e-5 of the
largest of all, where a tensor's sums cancel: the stage-3 step tests'
bound). A gradient that misses that bound is held instead to the port's own
move when the images are scaled by 1 + 1e-6, 3e-6 or 1e-5, and only where
that move passes the bound too: the box heads' batch norm over the
cascade's near-equal ROIs makes their conv's gradient move by up to 5e-2 of
its largest entry under a 1e-6 scale, and with it the gradients of the
pyramid and the Swin behind the pool (by 2e-3 at rate 0.2). How many
gradients needed it depends on the threads' summation order: none at two
threads (the suite's), 112 of 263 at eight (each within 0.7 of its own
move). The predictors and the RPN head hold the bound itself. Every running
statistic after the step (the BiFPN's and the box
heads') at 1e-4 of its largest entry; every parameter after the step at
1e-6 plus lr times its gradient's allowed error. The step fails with the
port's masks flipped, and with the bias table detached (its gradient is
lost).

(d) F6: the weight decay and learning-rate factor of every parameter equal
the JAX optax chain's, under SGD and AdamW: one update of both optimizers on
unit parameters and unit gradients, parameter by parameter.

(e) A trained Swin's state dict round-trips through the JAX names; the
stage-3 trainer's DropPath stream draws once a micro-batch under
``TPU.GRAD_ACCUM``.
"""

import collections
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import afigan_tpu.engine.stage3 as jstage3
import afigan_tpu.models.swin as jswin
from afigan_tpu.models import build_model as jax_build_model
from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth
from afigan_tpu_torch.engine import stage3
from afigan_tpu_torch.models import build_model
from afigan_tpu_torch.models import swin as tswin
from afigan_tpu_torch.utils.converters import variables_to_state_dict
from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import SWIN_NARROW
from tests.torch_port_train_common import (GradsInState, patch_jax_sampler, port_draws,
                                           to_jax_variables)

SWIN_YAML = f"{REPO}/configs/inference/AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml"
HW = (128, 128)
RATES = (0.0, 0.2)
STEP_LOSSES = ("loss_rpn_cls", "loss_rpn_loc", "total_loss") + tuple(
    f"{k}_stage{s}" for s in range(3) for k in ("loss_cls", "loss_box_reg", "diag_fg_frac"))


def swin_cfgs(extra=()):
    """(JAX config, port config) of the Swin cascade YAML at narrow widths."""
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(SWIN_YAML)
        cfg.merge_from_list(list(SWIN_NARROW) + list(extra))
        out.append(cfg)
    return out


def _rate(rate):
    return ("MODEL.SWINT.DROP_PATH_RATE", str(rate))


# ---------------------------------------------------------------------------
# (a) DropPath
# ---------------------------------------------------------------------------

def _drop_paths(model):
    return [m for m in model.modules() if isinstance(m, tswin.DropPath)]


def test_drop_path_schedule_is_linspace():
    cfg = swin_cfgs(_rate(0.2))[1]
    model = build_model(cfg, device="cpu", train=True)
    blocks = [b for layer in model.backbone.bottom_up.layers for b in layer.blocks]
    want = np.linspace(0, 0.2, sum(cfg.MODEL.SWINT.DEPTHS))
    assert len(blocks) == len(want) == 6
    np.testing.assert_array_equal([b.drop_path1.rate for b in blocks], want)
    np.testing.assert_array_equal([b.drop_path2.rate for b in blocks], want)
    # an inference build drops nothing (JAX's train=False)
    assert all(m.rate == 0.0 for m in _drop_paths(build_model(cfg, device="cpu")))


def _jax_drop_path(x, rate, mask, dtype):
    """The JAX module on ``x`` with ``jax.random.bernoulli`` answering ``mask``."""
    fake = _jax_with_masks([(1.0 - rate, mask)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jswin, "jax", fake)
        y = jswin.DropPath(rate, train=True).apply(
            {}, jnp.asarray(x, dtype), rngs={"dropout": jax.random.PRNGKey(0)})
    assert fake.calls == [1]
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drop_path_equals_jax_on_the_same_mask(dtype):
    rate = 0.3
    x = np.random.RandomState(0).randn(4, 3, 5, 8).astype(np.float32) * 3
    mask = np.asarray([True, False, True, False]).reshape(4, 1, 1, 1)
    m = tswin.DropPath(rate)
    with tswin.drop_path_source(m, lambda shape, keep, device: torch.from_numpy(mask)):
        got = m(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = _jax_drop_path(x, rate, mask, getattr(jnp, dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the kept images divided by keep rounded to the dtype, the quotient
    # rounded; the dropped ones zero
    assert (got[1] == 0).all() and (got[3] == 0).all()
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    assert torch.equal(got[0], xt[0] / torch.tensor(1 - rate, dtype=xt.dtype))


def test_drop_path_draws_per_image_and_follows_its_generator():
    x = torch.ones(64, 2, 3, 4)
    m = tswin.DropPath(0.5)
    outs = []
    for _ in range(2):
        with tswin.drop_path_source(m, torch.Generator().manual_seed(5)):
            outs.append(m(x))
    assert torch.equal(outs[0], outs[1])
    per_image = outs[0].flatten(1)
    # each image kept whole (x 2) or dropped whole, both seen
    assert set(per_image.unique().tolist()) == {0.0, 2.0}
    assert (per_image == per_image[:, :1]).all()
    with tswin.drop_path_source(m, torch.Generator().manual_seed(6)):
        assert not torch.equal(m(x), outs[0])


def test_drop_path_is_identity_in_eval_mode_and_at_rate_zero():
    x = torch.randn(4, 2, 2, 3)

    def never(*_):
        raise AssertionError("drew a mask")

    for m in (tswin.DropPath(0.5).eval(), tswin.DropPath(0.0).train()):
        with tswin.drop_path_source(m, never):
            assert m(x) is x


# ---------------------------------------------------------------------------
# (b) the training route of the attention and of LayerNorm
# ---------------------------------------------------------------------------

def _assert_close_to(got, want, rel=1e-5):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("shifted", [False, True])
def test_training_attention_equals_jax_xla_branch(shifted):
    dim, nh, ws, nw = 48, 2, 4, 3
    n = ws * ws
    rs = np.random.RandomState(1 + shifted)
    x = rs.randn(2 * nw, n, dim).astype(np.float32)
    mask = None
    if shifted:
        mask = np.where(rs.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
        mask[:, np.arange(n), np.arange(n)] = 0.0
    jm = jswin.WindowAttention(dim, nh, ws, attn_impl="xla", qkv_layout="split",
                               scores_dtype="float32")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              None if mask is None else jnp.asarray(mask)))
    params = params["params"]
    params["relative_position_bias_table"] = rs.randn(
        *params["relative_position_bias_table"].shape).astype(np.float32)
    params = jax.tree.map(lambda a: a + 0.1 * rs.randn(*a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    w = rs.randn(2 * nw, n, dim).astype(np.float32)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx, jmask) * w)

    jy = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jmask))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    tm = tswin.WindowAttention(dim, nh, ws).train()
    with torch.no_grad():
        for lin in ("qkv", "proj"):
            getattr(tm, lin).weight.copy_(torch.from_numpy(params[lin]["kernel"].T.copy()))
            getattr(tm, lin).bias.copy_(torch.from_numpy(params[lin]["bias"]))
        tm.relative_position_bias_table.copy_(
            torch.from_numpy(params["relative_position_bias_table"]))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx, None if mask is None else torch.from_numpy(mask))
    (ty * torch.from_numpy(w)).sum().backward()
    _assert_close_to(ty.detach().numpy(), jy)
    _assert_close_to(tx.grad.numpy(), np.asarray(gx))
    for lin in ("qkv", "proj"):
        _assert_close_to(getattr(tm, lin).weight.grad.numpy().T, np.asarray(gp[lin]["kernel"]))
        _assert_close_to(getattr(tm, lin).bias.grad.numpy(), np.asarray(gp[lin]["bias"]))
    table = tm.relative_position_bias_table.grad
    assert table is not None and float(table.abs().max()) > 0  # the table trains
    _assert_close_to(table.numpy(), np.asarray(gp["relative_position_bias_table"]))


def test_training_layer_norm_equals_jax_jnp_branch():
    rs = np.random.RandomState(3)
    # rows with a large mean: E[x^2] - mean^2, as JAX takes it
    x = (rs.randn(5, 7, 96) + 4 * rs.randn(5, 7, 1)).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(96)).astype(np.float32)
    bias = (0.1 * rs.randn(96)).astype(np.float32)
    w = rs.randn(*x.shape).astype(np.float32)
    jm = jswin.FusedLayerNorm(use_pallas=False)
    p = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}

    def loss(p_, xx):
        return jnp.sum(jm.apply({"params": p_}, xx) * w)

    jy = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    tm = tswin.FusedLayerNorm(96).train()
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(scale))
        tm.bias.copy_(torch.from_numpy(bias))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * torch.from_numpy(w)).sum().backward()
    _assert_close_to(ty.detach().numpy(), jy)
    _assert_close_to(tx.grad.numpy(), np.asarray(gx))
    _assert_close_to(tm.weight.grad.numpy(), np.asarray(gp["scale"]))
    _assert_close_to(tm.bias.grad.numpy(), np.asarray(gp["bias"]))


# ---------------------------------------------------------------------------
# (c) one whole step
# ---------------------------------------------------------------------------

class _JaxWithMasks:
    """``jax`` as ``afigan_tpu/models/swin.py`` sees it, with
    ``jax.random.bernoulli`` answering ``masks`` ((keep, mask) in call
    order; a retrace starts them again)."""

    def __init__(self, masks):
        self.masks, self.calls = masks, []
        self.random = types.SimpleNamespace(bernoulli=self._bernoulli)

    def _bernoulli(self, key, p, shape):
        i = sum(self.calls) % len(self.masks)
        keep, mask = self.masks[i]
        assert abs(p - keep) < 1e-12 and tuple(shape) == mask.shape, (i, p, keep, shape)
        self.calls.append(1)
        return jnp.asarray(mask)

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_with_masks(masks):
    return _JaxWithMasks(masks)


class PortMasks:
    """The port's DropPath source answering ``masks`` in call order."""

    def __init__(self, masks, flip=False):
        self.masks, self.flip, self.calls = masks, flip, 0

    def __call__(self, shape, keep, device):
        want_keep, mask = self.masks[self.calls % len(self.masks)]
        assert abs(keep - want_keep) < 1e-12 and tuple(shape) == mask.shape
        self.calls += 1
        return torch.from_numpy(~mask if self.flip else mask).to(device)


def step_masks(cfg):
    """(keep, (2, 1, 1, 1) mask) for each DropPath call of a step in JAX's
    order (block by block, drop_path1 then drop_path2), rate > 0 only: a
    seeded half of the images kept, whatever the rate, so that both sides
    drop several branches."""
    rates = np.linspace(0, cfg.MODEL.SWINT.DROP_PATH_RATE, sum(cfg.MODEL.SWINT.DEPTHS))
    rs = np.random.RandomState(9)
    return [(1.0 - float(r), (rs.rand(2) < 0.5).reshape(2, 1, 1, 1))
            for r in rates if r > 0 for _ in range(2)]


def step_batch():
    """Two 128x128 images, each noise over a ramp of its own direction and
    brightness, 4 GT slots with 3 valid boxes each."""
    rs = np.random.RandomState(5)
    h, w = HW
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, :3] = [[10, 12, 80, 70], [40, 44, 120, 116], [72, 8, 124, 60]]
    boxes[1] += 2.0
    img = rs.rand(2, h, w, 3).astype(np.float32) * 127
    img[0] += 128 * np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    img[1] += 64 * np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None]
    return {"image": img, "image_sizes": np.asarray([HW] * 2, np.int32),
            "gt": {"boxes": boxes, "classes": np.asarray([[0, 1, 2, 0], [2, 0, 1, 0]], np.int32),
                   "valid": np.arange(4)[None].repeat(2, 0) < 3}}


def _perturb(state_dict, seed):
    """Every 1-D entry moved off its init by a seeded draw (running
    variances up), the box regressions 30x: in place."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for k, v in state_dict.items():
            if v.dim() == 1 and v.is_floating_point():
                d = torch.from_numpy(0.2 * rs.rand(*v.shape).astype(np.float32))
                v.add_(d if k.endswith("running_var") else d - 0.1)
            elif k.endswith("bbox_pred.weight"):
                v.mul_(30.0)


def _jax_gt(g):
    return JaxGroundTruth(*(jnp.asarray(g[k]) for k in ("boxes", "classes", "valid")))


def _port_step(cfg, before, batch, masks, flip=False):
    """One port train step from ``before``: (metrics, {name: gradient}, state
    dict after, DropPath calls)."""
    state = stage3.init_stage3_state(cfg, device="cpu")
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in before.items()})
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().numpy().copy()))
        for n, p in state.model.named_parameters() if p.requires_grad]
    source = PortMasks(masks, flip)
    try:
        metrics = stage3.train_step(cfg, state, stage3.batch_to_device(batch, "cpu"),
                                    draws=port_draws, drop_path=source)
    finally:
        for h in hooks:
            h.remove()
    return metrics, grads, {k: v.numpy() for k, v in state.model.state_dict().items()}, \
        source.calls


# the image scales of the port's own gradient spread (see ``_allowed``)
SPREAD_SCALES = (1e-6, 3e-6, 1e-5)
StepRuns = collections.namedtuple("StepRuns", "before metrics grads after jmetrics jgrads "
                                              "jafter masks calls jcalls allowed spread_used")


@functools.lru_cache(maxsize=None)
def _step_runs(rate):
    """The port's step and ``make_stage3_train_step`` (one JAX compile) from
    one set of weights at DropPath rate ``rate``, the same masks on both
    sides, and each gradient's allowed error (``_allowed``)."""
    jcfg, cfg = swin_cfgs(_rate(rate))
    batch = step_batch()
    state = stage3.init_stage3_state(cfg, device="cpu",
                                     generator=torch.Generator().manual_seed(0))
    _perturb(state.model.state_dict(), 0)
    before = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
    masks = step_masks(cfg)

    det = jax_build_model(jcfg, train=True)
    k = jax.random.PRNGKey(0)
    gt = _jax_gt(batch["gt"])
    template = jax.eval_shape(lambda: det.init(
        {"params": k, "sampling": k, "dropout": k}, jnp.zeros((1, *HW, 3)),
        jnp.asarray([HW], jnp.int32), jax.tree.map(lambda a: a[:1], gt)))
    fake = _jax_with_masks(masks or [(1.0, np.ones((2, 1, 1, 1), bool))])
    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        mp.setattr(jswin, "jax", fake)
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
    metrics, grads, after, calls = _port_step(cfg, before, batch, masks)
    jgrads = variables_to_state_dict({"params": np_tree(new.opt[1])})
    spread = []
    for scale in SPREAD_SCALES:
        moved = dict(batch, image=batch["image"] * np.float32(1.0 + scale))
        spread.append(_port_step(cfg, before, moved, masks)[1])
    allowed, used = _allowed(grads, jgrads, spread)
    return StepRuns(before, metrics, grads, after, {k_: float(v) for k_, v in jmetrics.items()},
                    jgrads, variables_to_state_dict({"params": np_tree(new.params),
                                                     "batch_stats": np_tree(new.stats)}),
                    masks, calls, len(fake.calls), allowed, used)


def _allowed(grads, want, spread):
    """Each gradient's allowed error: 1e-3 of its largest entry, or 1e-5 of
    the largest of all where a tensor's sums cancel to far below their terms
    (the stage-3 step tests' bound); where the port's own gradient moves past
    that bound when
    the images are scaled by 1 + each of ``SPREAD_SCALES`` (an ill-conditioned
    gradient: a batch norm of a box head over near-equal ROIs, a ReLU input
    near zero), its own largest move. Returns ({name: allowed}, {name: (error,
    own move) / largest entry} for the gradients that needed their own move)."""
    top = max(float(np.abs(want[n]).max()) for n in grads)
    allowed, used = {}, {}
    for n, g in grads.items():
        largest = float(np.abs(want[n]).max())
        base = max(1e-3 * largest, 1e-5 * top)
        own = max(float(np.abs(g - s_[n]).max()) for s_ in spread)
        allowed[n] = max(base, own)
        err = float(np.abs(g - want[n]).max())
        if err > base:
            used[n] = (err / largest, own / largest)
    return allowed, used


def _losses_equal(got, want):
    return all(np.isclose(got[k], want[k], rtol=1e-4, atol=1e-7) for k in STEP_LOSSES)


def _grad_misses(grads, want, allowed):
    """The names whose gradient misses its allowed error, or that lack a
    gradient on either side."""
    both = set(grads) & set(want)
    return (set(grads) ^ set(want)) | {
        n for n in both if float(np.abs(grads[n] - want[n]).max()) > allowed[n]}


@pytest.mark.parametrize("rate", RATES)
def test_swin_step_losses_equal_jax(rate):
    r = _step_runs(rate)
    got, want = r.metrics, r.jmetrics
    assert set(got) == set(want) == set(STEP_LOSSES)
    for name in STEP_LOSSES:
        assert np.isfinite(got[name])
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-7, err_msg=name)
    # 5 blocks of rate > 0, two DropPaths each, on both sides; none at rate 0
    assert r.calls == r.jcalls == (10 if rate else 0) == len(r.masks)
    if rate:
        drawn = np.concatenate([m.ravel() for _, m in r.masks])
        assert drawn.any() and not drawn.all()
    assert all(got[f"diag_fg_frac_stage{s}"] > 0 for s in range(3))


@pytest.mark.parametrize("rate", RATES)
def test_swin_step_gradients_equal_jax(rate):
    r = _step_runs(rate)
    for part in ("bottom_up.patch_embed.norm.weight", "bottom_up.layers.2.blocks.1.norm1.weight",
                 "bottom_up.layers.2.blocks.1.attn.relative_position_bias_table",
                 "bottom_up.layers.1.downsample.norm.bias", "bottom_up.norm1.weight",
                 "srf_module.Generators.0.0.0.weight", "box_head.2.conv1.norm.weight",
                 "box_predictor.1.bbox_pred.weight", "rpn_head.conv.weight"):
        assert any(n.endswith(part) for n in r.grads), part
    missed = _grad_misses(r.grads, r.jgrads, r.allowed)
    assert not missed, sorted(missed)[:8]
    print(f"{len(r.spread_used)} of {len(r.grads)} ill-conditioned gradients held to the "
          "port's own spread (error, own move, of the largest entry):", r.spread_used)
    # the predictors and the RPN head, which the loss reaches first, hold that bound
    assert not any(n.startswith(("roi_heads.box_predictor", "proposal_generator"))
                   for n in r.spread_used), r.spread_used


@pytest.mark.parametrize("rate", RATES)
def test_swin_step_statistics_and_parameters_equal_jax(rate):
    """The running statistics at 1e-4 of their largest entry; each parameter
    at 1e-6 plus the step's lr times its gradient's allowed error (SGD, no
    momentum yet on the first step)."""
    r = _step_runs(rate)
    lr = swin_cfgs()[1].SOLVER.BASE_LR
    assert set(r.after) == set(r.jafter)
    stats = [k for k in r.after if "running_" in k]
    # the BiFPN's (3 laterals, 2 skips, p6, 8 convs a layer) and the three box heads'
    assert len(stats) == 2 * (6 + 8 * 2 + 3)
    for k, v in r.after.items():
        want = r.jafter[k]
        if k in stats:
            assert not np.array_equal(v, r.before[k]), k
            assert float(np.abs(v - want).max()) <= 1e-4 * float(np.abs(want).max()), k
        else:
            assert k in r.grads, k  # no parameter is frozen under FREEZE_AT -1
            assert float(np.abs(v - want).max()) <= 1e-6 + lr * r.allowed[k], k


def test_swin_step_fails_with_the_masks_flipped():
    """Mutation check of (c): the same step with each of the port's masks
    flipped misses JAX's losses or gradients."""
    r = _step_runs(0.2)
    cfg = swin_cfgs(_rate(0.2))[1]
    metrics, grads, _, calls = _port_step(cfg, r.before, step_batch(), r.masks, flip=True)
    assert calls == len(r.masks)
    assert not _losses_equal(metrics, r.jmetrics) or _grad_misses(grads, r.jgrads, r.allowed)


def test_swin_step_fails_with_the_bias_table_detached(monkeypatch):
    """Mutation check of (c): with the training route's bias detached from
    its table, the tables get no gradient and the step misses JAX's."""
    r = _step_runs(0.2)
    cfg = swin_cfgs(_rate(0.2))[1]
    real = tswin.WindowAttention.train_bias
    monkeypatch.setattr(tswin.WindowAttention, "train_bias", lambda self: real(self).detach())
    _, grads, _, _ = _port_step(cfg, r.before, step_batch(), r.masks)
    missed = _grad_misses(grads, r.jgrads, r.allowed)
    tables = {n for n in r.jgrads if n.endswith("relative_position_bias_table")}
    assert len(tables) == 6 and missed == tables, sorted(missed)


# ---------------------------------------------------------------------------
# (d) F6: the optimizer groups
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_template():
    jcfg = swin_cfgs()[0]
    det = jax_build_model(jcfg, train=True)
    k = jax.random.PRNGKey(0)
    gt = jax.tree.map(lambda a: a[:1], _jax_gt(step_batch()["gt"]))
    return jax.eval_shape(lambda: det.init(
        {"params": k, "sampling": k, "dropout": k}, jnp.zeros((1, *HW, 3)),
        jnp.asarray([HW], jnp.int32), gt))


@pytest.mark.parametrize("optimizer", ["SGD", "ADAMW"])
def test_optimizer_groups_equal_jax(optimizer):
    """One update of each package's optimizer on unit parameters and unit
    gradients, WEIGHT_DECAY, _BIAS, _NORM and BIAS_LR_FACTOR set apart: every
    parameter moves as in JAX (SGD: -(1 + decay) x factor; AdamW: -(1 + decay)
    x factor, no decay for norms, biases and the bias tables). Every Swin
    LayerNorm (``norm*``, ``patch_norm``, the downsample's ``norm``) and
    every batch norm of the BiFPN (``*_bn``, the convs' ``norm``) and of the
    box heads takes the norm group as in JAX."""
    extra = ("SOLVER.OPTIMIZER", optimizer, "SOLVER.WEIGHT_DECAY", "0.001",
             "SOLVER.WEIGHT_DECAY_BIAS", "0.003", "SOLVER.WEIGHT_DECAY_NORM", "0.005",
             "SOLVER.BIAS_LR_FACTOR", "2.0", "SOLVER.BASE_LR", "0.5")
    jcfg, cfg = swin_cfgs(extra)
    params = jax.tree.map(lambda s: jnp.ones(s.shape, s.dtype), _jax_template()["params"])
    tx, _ = jstage3.build_optimizer(jcfg, params, jstage3._frozen_predicates(jcfg))
    updates, _ = jax.jit(tx.update)(jax.tree.map(jnp.ones_like, params), tx.init(params),
                                    params)
    want = {k: np.asarray(v) for k, v in variables_to_state_dict(
        {"params": jax.tree.map(np.asarray, updates)}).items()}
    state = stage3.init_stage3_state(cfg, device="cpu")
    named = dict(state.model.named_parameters())
    assert set(named) == set(want) and all(p.requires_grad for p in named.values())
    with torch.no_grad():
        for p in named.values():
            p.fill_(1.0)
            p.grad = torch.ones_like(p)
    state.optimizer.step()
    # optax takes Adam's bias corrections in float32 (1 - 0.999 rounds), torch
    # in float64: the first AdamW step differs by 6.4e-6 relative, far below
    # the 1e-3 that a decay of 0.001 adds or the factor 2 of a bias
    rtol = 2e-5 if optimizer == "ADAMW" else 1e-6
    for n, p in named.items():
        np.testing.assert_allclose(p.detach().numpy() - 1.0, want[n], rtol=rtol, atol=0,
                                   err_msg=n)
    # the groups as named: norms, non-norm biases, the rest
    lr = {n: g["weight_decay"] * g["lr_factor"] for g in state.optimizer.param_groups
          for n in g["names"]}
    for n in ("backbone.bottom_up.patch_embed.norm.weight",
              "backbone.bottom_up.layers.0.blocks.0.norm1.bias",
              "backbone.bottom_up.layers.2.blocks.1.norm2.weight",
              "backbone.bottom_up.layers.1.downsample.norm.weight",
              "backbone.bottom_up.norm2.bias", "backbone.before_bifpn.lateral3.1.weight",
              "roi_heads.box_head.0.conv1.norm.bias"):
        assert lr[n] == (0.0 if optimizer == "ADAMW" else 0.005), n
    assert lr["backbone.bottom_up.layers.0.blocks.0.attn.qkv.bias"] == (
        0.0 if optimizer == "ADAMW" else 0.006)
    assert lr["backbone.bottom_up.layers.0.blocks.0.attn.relative_position_bias_table"] == (
        0.0 if optimizer == "ADAMW" else 0.001)


# ---------------------------------------------------------------------------
# (e) checkpoint names and the trainer's stream
# ---------------------------------------------------------------------------

def test_trained_swin_state_dict_round_trips_through_the_jax_names():
    """The state dict after a step (every LayerNorm, bias table, BiFPN
    statistic moved) through the JAX tree and back, entry for entry."""
    after = _step_runs(0.2).after
    variables = to_jax_variables(_jax_template(), after)
    swin = variables["params"]["backbone"]["bottom_up"]
    assert "relative_position_bias_table" in swin["stage4/block1"]["attn"]
    assert set(swin["stage4/block1"]["norm1"]) == {"scale", "bias"}
    back = variables_to_state_dict(variables)
    assert set(back) == set(after)
    for k, v in after.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_grad_accum_draws_masks_a_micro_batch(tmp_path):
    """Under ``TPU.GRAD_ACCUM`` 2 each micro-batch (one image) draws its own
    masks from the stream, in order; the trainer's stream is seeded from its
    seed, beside the sampling stream."""
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer

    cfg = swin_cfgs((*_rate(0.2), "TPU.GRAD_ACCUM", "2", "OUTPUT_DIR", str(tmp_path),
                     "DATASETS.ROOT", str(tmp_path), "SEED", "4"))[1]
    trainer = TargetDetectorTrainer(cfg, device="cpu")
    assert trainer.drop_path.initial_seed() == 6 and trainer.sampling.initial_seed() == 5
    shapes = []

    def source(shape, keep, device):
        shapes.append(tuple(shape))
        return tswin.drop_path_keep(trainer.drop_path, shape, keep, device)

    metrics = stage3.train_step(cfg, trainer.state,
                                stage3.batch_to_device(step_batch(), "cpu"),
                                trainer.sampling, source)
    assert np.isfinite(metrics["total_loss"])
    assert shapes == [(1, 1, 1, 1)] * 10 * 2


def test_stage3_cli_trains_the_swin_cascade(tmp_path):
    """``python -m afigan_tpu_torch.stage3_train --device cpu`` takes the Swin
    cascade YAML (``MODEL.AFI_FREEZE False``) at narrow widths for two
    iterations on a tiny COCO: finite losses of the three stages in
    ``metrics.json`` and a ``model_0000002.pth`` that loads strictly into the
    eval build, its LayerNorms and bias tables trained."""
    import json
    import os
    import shutil

    from afigan_tpu_torch import stage3_train
    from afigan_tpu_torch.utils.converters import load_state_dict
    from tests.fixtures import make_tiny_coco

    root, out = tmp_path / "root", tmp_path / "out"
    json_path, img_dir = make_tiny_coco(str(tmp_path / "raw"), num_images=2, hw=(96, 128))
    os.makedirs(root / "coco" / "annotations")
    shutil.copy(json_path, root / "coco" / "annotations" / "instances_train2017.json")
    shutil.copytree(img_dir, root / "coco" / "train2017")
    opts = ["INPUT.MIN_SIZE_TRAIN", "(64, 72)", "INPUT.MAX_SIZE_TRAIN", "128",
            "TPU.IMAGE_BUCKETS", "((128, 128),)", "TPU.MAX_GT_BOXES", "8",
            "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
            "DATASETS.TEST", "()", "SEED", "3", "DATASETS.ROOT", str(root),
            "OUTPUT_DIR", str(out)]
    trainer = stage3_train.main(stage3_train.parse_args(
        ["--config-file", SWIN_YAML, "--device", "cpu", *SWIN_NARROW, *opts]))
    assert trainer.model.training and trainer.model.backbone.bottom_up.layers[3].blocks[0] \
        .drop_path2.rate == 0.2
    lines = [json.loads(line) for line in open(out / "metrics.json")]
    assert lines[-1]["iteration"] == 1
    for r in lines:
        assert np.isfinite(r["total_loss"]) and all(
            np.isfinite(r[f"loss_cls_stage{s}"]) for s in range(3))
    saved = load_state_dict(str(out / "model_0000002.pth"))
    model = build_model(swin_cfgs(opts)[1], device="cpu")
    model.load_state_dict({k: torch.as_tensor(v) for k, v in saved.items()}, strict=True)
    fresh = build_model(swin_cfgs(opts)[1], device="cpu",
                        generator=torch.Generator().manual_seed(3)).state_dict()
    for key in ("backbone.bottom_up.layers.2.blocks.1.norm1.weight",
                "backbone.bottom_up.layers.2.blocks.1.attn.relative_position_bias_table"):
        assert not np.array_equal(saved[key], fresh[key].numpy()), key
