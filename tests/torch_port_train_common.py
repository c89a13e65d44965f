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
import torch

from tests.torch_port_common import REPO


def fixed_draws(n):
    """(positive, negative) float32 keys in [0.1, 1) for n labels."""
    rs = np.random.RandomState(1000 + n)
    return (0.1 + 0.9 * rs.rand(2, n)).astype(np.float32)


def port_draws(shape, device):
    """The port's draw source: ``fixed_draws`` for every image of the batch."""
    rp, rn = fixed_draws(shape[-1])
    return tuple(torch.from_numpy(np.broadcast_to(d, shape).copy()).to(device)
                 for d in (rp, rn))


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
