"""Shared set-up of the port's training tests (not collected by pytest).

The JAX package's random bits cannot be reproduced in torch, so both
packages take the subsamples' uniform keys from ``fixed_draws``: numpy draws
keyed by the number of labels, the same for every image. The JAX side gets
them by patching, inside a test, the ``subsample_labels`` that
``afigan_tpu.models.rpn`` and ``afigan_tpu.models.roi_heads`` call: the
wrapper runs the JAX package's own ``subsample_labels`` with its
``jax.random.uniform`` answering the fixed draws (positive keys first, as the
function draws them). The JAX package itself is not edited.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_common import REPO
from tests.torch_port_gan_tiny import fixed_draws, port_draws  # noqa: F401 (re-exported)


def patch_jax_sampler(monkeypatch):
    """Make the JAX detector's two subsamples draw ``fixed_draws``."""
    import afigan_tpu.models.roi_heads as jrh
    import afigan_tpu.models.rpn as jrpn
    import afigan_tpu.ops.sampling as jsampling

    real = jsampling.subsample_labels

    def fixed(key, labels, *args, **kwargs):
        draws = iter(fixed_draws(labels.shape[-1]))
        fake = types.SimpleNamespace(
            random=types.SimpleNamespace(
                split=jax.random.split,
                uniform=lambda key, shape, minval, maxval: jnp.asarray(next(draws))),
            lax=jax.lax)
        with monkeypatch.context() as m:
            m.setattr(jsampling, "jax", fake)
            return real(key, labels, *args, **kwargs)

    monkeypatch.setattr(jrpn, "subsample_labels", fixed)
    monkeypatch.setattr(jrh, "subsample_labels", fixed)


STAGE3_OVERRIDES = [
    # tests/test_train_stages.py::_stage3_cfg
    "TPU.COMPUTE_DTYPE", "float32",
    "MODEL.MASK_ON", "True",
    "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.AFI.IN_CHANNELS", "64",
    "MODEL.AFI.N_RDB", "1",
    "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64",
    "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "SOLVER.BASE_LR", "0.001",
]




def stage3_cfgs(extra=()):
    """(JAX config, port config): the narrow stage-3 config of the JAX
    package's own train-step tests, built from the same YAML both ways."""
    from afigan_tpu.config import get_cfg as jax_get_cfg
    from afigan_tpu_torch.config import get_cfg

    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(f"{REPO}/configs/Base-RCNN-FPN-AFIGAN.yaml")
        cfg.merge_from_list(STAGE3_OVERRIDES + list(extra))
        out.append(cfg)
    return out


def calibrated_jax_params(params, cfg, images):
    """The JAX params with their FrozenBN statistics calibrated on ``images``
    (``afigan_tpu_torch/tools/frozen_bn.py``: random weights at identity
    statistics are too ill-conditioned to compare two frameworks' gradients),
    through the port model and back by the two converters."""
    from afigan_tpu.utils.converters import state_dict_to_variables
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
    from afigan_tpu_torch.utils.converters import variables_to_state_dict

    model = build_model(cfg, device="cpu", train=True)
    sd = variables_to_state_dict({"params": params})
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    calibrate_frozen_bn(model, torch.tensor(images))
    variables, _ = state_dict_to_variables(
        {k: v.numpy() for k, v in model.state_dict().items()}, template={"params": params})
    return variables["params"]


def calibrated_guide(cfg, params, images):
    """The JAX guide's (``RCNN_FPN_only``) params with their FrozenBN
    statistics calibrated on ``images``, as ``calibrated_jax_params``."""
    from afigan_tpu.utils.converters import state_dict_to_variables
    from afigan_tpu_torch.models import build_guide_model
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
    from afigan_tpu_torch.utils.converters import variables_to_state_dict

    guide = build_guide_model(cfg, device="cpu")
    sd = variables_to_state_dict({"params": params})
    guide.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    calibrate_frozen_bn(guide, torch.tensor(images))
    variables, _ = state_dict_to_variables(
        {k: v.numpy() for k, v in guide.state_dict().items()}, template={"params": params})
    return variables["params"]


def det_batch(b=2, h=64, w=64, m=4, seed=0):
    """tests/test_train_stages.py::_det_batch as numpy: two valid GT boxes an
    image of four slots, random 28x28 mask canvases."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((b, m, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 32]
    boxes[:, 1] = [20, 24, 60, 56]
    return {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.asarray([[h, w]] * b, np.int32),
        "gt": {"boxes": boxes, "classes": np.zeros((b, m), np.int32),
               "valid": np.array([[True, True, False, False]] * b),
               "masks": rng.rand(b, m, 28, 28).astype(np.float32)},
    }


def keypoint_det_batch(num_keypoints=3, **kw):
    """``det_batch`` with (B, M, K, 3) GT keypoints: a seeded spread over
    each GT box, one of them invisible and one outside its box."""
    batch = det_batch(**kw)
    boxes = batch["gt"]["boxes"]
    b, m = boxes.shape[:2]
    rng = np.random.RandomState(11)
    u = rng.rand(b, m, num_keypoints, 2)
    kp = np.zeros((b, m, num_keypoints, 3), np.float32)
    kp[..., 0] = boxes[..., None, 0] + u[..., 0] * (boxes[..., None, 2] - boxes[..., None, 0])
    kp[..., 1] = boxes[..., None, 1] + u[..., 1] * (boxes[..., None, 3] - boxes[..., None, 1])
    kp[..., 2] = 2.0
    kp[:, 0, 1] = 0.0  # invisible
    kp[:, 1, 2, 0] = boxes[:, 1, 2] + 3.0  # right of its box
    batch["gt"]["keypoints"] = kp * batch["gt"]["valid"][..., None, None]
    return batch


def _calibrated(params, cfg, images):
    """``calibrated_jax_params`` back through ``to_jax_variables`` (the
    inverse of the port's own mapping, which also knows the Res5 heads)."""
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
    from afigan_tpu_torch.utils.converters import variables_to_state_dict

    model = build_model(cfg, device="cpu", train=True)
    sd = variables_to_state_dict({"params": params})
    model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    calibrate_frozen_bn(model, torch.tensor(images))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    return to_jax_variables({"params": params}, state)["params"]


def jax_stage3_step(extra, batch):
    """``make_stage3_train_step`` on the narrow config ``stage3_cfgs(extra)``
    from the JAX init (PRNGKey 0, its FrozenBN calibrated on the batch),
    with the fixed subsample draws: (params before, metrics, params after),
    numpy."""
    from afigan_tpu.engine.solver import build_optimizer
    from afigan_tpu.engine.stage3 import Stage3State, _frozen_predicates, make_stage3_train_step
    from afigan_tpu.models import build_model as jax_build_model
    from afigan_tpu.models.roi_heads import GroundTruth as JaxGroundTruth

    mp = pytest.MonkeyPatch()
    try:
        patch_jax_sampler(mp)
        cfg = stage3_cfgs(extra)[0]
        h, w = batch["image"].shape[1:3]
        gt = JaxGroundTruth(**{k: jnp.asarray(v) for k, v in batch["gt"].items()})
        det = jax_build_model(cfg, train=True)
        rng = jax.random.PRNGKey(1)
        variables = jax.jit(lambda: det.init(
            {"params": jax.random.PRNGKey(0), "sampling": rng},
            jnp.zeros((1, h, w, 3)), jnp.asarray([[h, w]], jnp.int32),
            jax.tree.map(lambda a: a[:1], gt)))()
        params = _calibrated(jax.tree.map(np.asarray, variables["params"]),
                             stage3_cfgs(extra)[1], batch["image"])
        tx, _ = build_optimizer(cfg, params, _frozen_predicates(cfg))
        state = Stage3State(params, {}, tx.init(params), jnp.zeros((), jnp.int32))
        new_state, metrics = make_stage3_train_step(cfg)(
            state, {"image": jnp.asarray(batch["image"]),
                    "image_sizes": jnp.asarray(batch["image_sizes"]), "gt": gt}, rng)
        return (params, {k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, new_state.params))
    finally:
        mp.undo()


def port_stage3_step(params, extra, batch):
    """The port's ``train_step`` from the same weights and draws: (metrics,
    state dict before, state dict after)."""
    from afigan_tpu_torch.engine.stage3 import batch_to_device, init_stage3_state, train_step
    from afigan_tpu_torch.utils.converters import variables_to_state_dict

    cfg = stage3_cfgs(extra)[1]
    state = init_stage3_state(cfg, device="cpu")
    sd = variables_to_state_dict({"params": params})
    state.model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = train_step(cfg, state, batch_to_device(batch, "cpu"), draws=port_draws)
    return metrics, before, {k: v.clone() for k, v in state.model.state_dict().items()}


class GradsInState:
    """Wraps an optax transform: its state also carries the gradient of the
    last update, so that a JAX train step's gradients can be read back."""

    def __init__(self, tx):
        self.tx = tx

    def init(self, params):
        return (self.tx.init(params), jax.tree.map(jnp.zeros_like, params))

    def update(self, grads, state, params=None):
        updates, inner = self.tx.update(grads, state[0], params)
        return updates, (inner, grads)


def to_jax_variables(template, state, key=None):
    """A port state dict (name → array) as the JAX tree of ``template`` (its
    ``params`` and ``batch_stats``, e.g. from ``jax.eval_shape`` of an init:
    nothing compiled): the inverse of the port's own ``variables_to_state_dict``
    mapping, each layout transform inverted by applying it to the leaf's flat
    indices. ``key``: path → (state-dict key, transform), the port's
    ``translate_path`` by default. Every leaf is filled and every entry of
    ``state`` used, or it raises."""
    from afigan_tpu_torch.utils.converters import _fc1_channels, _leaves, translate_path

    if key is None:
        params = template["params"]
        step = 3 if "norm" in params.get("fcos_head", {}).get("cls_tower0", {}) else 2
        fc1 = _fc1_channels(params)
        key = lambda path: translate_path(path, fc1, step)  # noqa: E731
    out, used = {}, set()
    for coll, tree in template.items():
        out[coll] = {}
        for path, leaf in _leaves(tree):
            name, tf = key(path)
            shape = tuple(np.shape(leaf))
            idx = np.asarray(tf(np.arange(int(np.prod(shape))).reshape(shape)))
            src = np.asarray(state[name], np.float32)
            assert idx.shape == src.shape, (name, idx.shape, src.shape)
            flat = np.empty(idx.size, np.float32)
            flat[idx.ravel()] = src.ravel()
            node = out[coll]
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = flat.reshape(shape)
            used.add(name)
    assert used == set(state), sorted(set(state) - used)[:8]
    return out
