"""Flax variables → d2 state dict: the inverse of
``afigan_tpu.utils.converters.state_dict_to_variables``.

The port's modules keep d2's state-dict key names, so one set of numpy
arrays serves both packages: ``state_dict_to_variables`` maps a port
``state_dict()`` into the JAX tree, and ``variables_to_state_dict`` maps a
JAX tree (e.g. from ``model.init``) back into the port. Layouts undone:
HWIO→OIHW (conv), HWIO(in,out)→IOHW (transposed conv), (in,out)→(out,in)
(linear), and the HWC→CHW input-order permutation of the first box FC
(``t_linear_from_chw``). Covers the ResNet / ResNeSt / Swin bottom-ups (the
ResNeSt deep stem ``stem.conv1_{1,2,3}`` and split-attention
``conv2.{conv,bn0,fc1,bn1,fc2}``), the FPN, PAFPN and BiFPN pyramids with the
AF interpolator (``fpn_lateral``, ``fpn_output``, ``pafpn_output``,
``pafpn_downsample``, each with its norm), the RPN, and the standard and
cascade ROI heads with normed box and mask heads (batch-norm statistics from
``batch_stats``).

FCOS and CenterMask have no names in the JAX package's converter; theirs
follow AdelaiDet and CenterMask2:

====================================================  ==========================================
flax path                                             state-dict key
====================================================  ==========================================
``backbone/pyramid/top_block/p{6,7}/conv``            ``backbone.top_block.p{6,7}``
``fcos_head/{cls,bbox}_tower{i}/conv``                ``proposal_generator.fcos_head.{cls,bbox}_tower.{3i}`` (``{2i}`` without a norm)
``fcos_head/{cls,bbox}_tower{i}/norm/{scale,bias}``   ``...{cls,bbox}_tower.{3i+1}.{weight,bias}``
``fcos_head/{cls_logits,bbox_pred,ctrness}/conv``     ``proposal_generator.fcos_head.{cls_logits,bbox_pred,ctrness}``
``fcos_head/scale_{l}``                               ``proposal_generator.fcos_head.scales.{l}.scale``
``mask_head/mask_fcn{i}/conv``                        ``roi_heads.mask_head.mask_fcn{i}``
``mask_head/sam/sam_conv/conv``                       ``roi_heads.mask_head.spatialAtt.conv``
``mask_head/deconv``, ``mask_head/predictor/conv``    ``roi_heads.mask_head.{deconv,predictor}``
====================================================  ==========================================

Batch-norm statistics (``batch_stats``: the running mean and variance of the
BN / SyncBN that train, a BiFPN's) map to the same keys as the FrozenBN
statistics. Numpy only; ``load_state_dict`` reads d2 / Caffe2 ``.pkl``,
torch ``.pth`` and the JAX package's ``.msgpack`` trees (``msgpack_tree.py``),
the last through the converter of their kind.
"""

from __future__ import annotations

import pickle
import re
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


KINDS = ("detector", "generator", "discriminator")


def msgpack_state_dict(path: str, kind: str = "detector") -> Dict[str, np.ndarray]:
    """A ``.msgpack`` tree of the JAX package (a trainer checkpoint, whose
    ``opt`` and ``step`` are dropped, a variables tree or a bare params tree)
    → the port's state dict of a model of ``kind``: a detector
    (``variables_to_state_dict``), a standalone generator, stage 1's ``G_0``
    (``generator_state_dict``), or a discriminator, ``D_0``
    (``discriminator_state_dict``), as ``afigan_tpu/engine/weights.py`` picks
    its translator by kind."""
    from .msgpack_tree import numpy_tree, read_msgpack, split_checkpoint

    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    params, stats = split_checkpoint(read_msgpack(path))
    variables = {"params": numpy_tree(params), "batch_stats": numpy_tree(stats)}
    if kind == "generator":
        return generator_state_dict(variables["params"])
    if kind == "discriminator":
        return discriminator_state_dict(variables)
    return variables_to_state_dict(variables)


def load_state_dict(path: str, kind: str = "detector") -> Dict[str, np.ndarray]:
    """Load a d2 ``.pkl``, a torch ``.pth`` or a JAX ``.msgpack`` checkpoint
    into name→ndarray. ``kind`` (``KINDS``) names the model a ``.msgpack``
    tree is of; the other formats carry the port's names already."""
    if path.endswith(".msgpack"):
        return msgpack_state_dict(path, kind)
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        data = data.get("model", data)
        data = data.get("blobs", data)
        out = {k: np.asarray(v) for k, v in data.items()
               if not (k.endswith("_momentum") or k.startswith("__"))}
        if any(k.endswith(("_w", "_b")) or "branch" in k for k in out):
            out = convert_c2_resnet_names(out)
        return out
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict"):
        if isinstance(data, dict) and key in data and isinstance(data[key], dict):
            data = data[key]
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
            for k, v in data.items() if hasattr(v, "shape")}


def convert_c2_resnet_names(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Caffe2 ImageNet ResNet names → d2 names (stem / res{s}.{i}.conv{j})."""
    stem = {"conv1_w": "stem.conv1.weight", "res_conv1_bn_s": "stem.conv1.norm.weight",
            "res_conv1_bn_b": "stem.conv1.norm.bias"}
    suffix = {"w": "weight", "bn_s": "norm.weight", "bn_b": "norm.bias"}
    out = {}
    for k, v in weights.items():
        name = stem.get(k, k)
        m = re.match(r"^res(\d)_(\d+)_branch([12])([a-c]?)_(w|bn_s|bn_b)$", k)
        if m:
            stage, block, branch, sub, kind = m.groups()
            layer = "shortcut" if branch == "1" else {"a": "conv1", "b": "conv2",
                                                       "c": "conv3"}[sub]
            name = f"res{stage}.{block}.{layer}.{suffix[kind]}"
        out[name] = v
    return out


def inv_conv(w):  # HWIO -> OIHW
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def inv_deconv(w):  # HWIO(in,out) -> IOHW
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def inv_linear(w):  # (in,out) -> (out,in)
    return np.ascontiguousarray(np.asarray(w).T)


def inv_linear_to_chw(w, channels: int):
    """Inverse of ``t_linear_from_chw``: (P*P*C [HWC order], out) →
    (out, C*P*P [CHW order])."""
    in_f, out_f = w.shape
    if in_f % channels:
        return inv_linear(w)
    pp = in_f // channels
    p = int(round(pp ** 0.5))
    if p * p != pp:
        return inv_linear(w)
    w4 = np.asarray(w).T.reshape(out_f, p, p, channels).transpose(0, 3, 1, 2)
    return np.ascontiguousarray(w4.reshape(out_f, in_f))


def ident(w):
    return np.asarray(w)


_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
# a ResNeSt split-attention conv2's parts: (flax module, conv|norm) → d2 name
_SPLAT = {("conv", "conv"): "conv", ("conv", "norm"): "bn0", ("fc1", "conv"): "fc1",
          ("fc1", "norm"): "bn1", ("fc2", "conv"): "fc2"}
_GEN_SEQ = {"generators_0/head": "0.0.0", "generators_0/mid": "0.2.0",
            "generators_0/tail": "0.4.0"}


def _conv_leaf(leaf: str) -> Tuple[str, Callable]:
    return ("weight", inv_conv) if leaf == "kernel" else ("bias", ident)


def _generator_key(path: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """srf_module subtree path → d2 'Generators.0.*' suffix."""
    if path[0] in _GEN_SEQ and path[1:2] == ("conv",):
        name, tf = _conv_leaf(path[2])
        return f"Generators.{_GEN_SEQ[path[0]]}.{name}", tf
    if path[0] == "generators_0/up":
        if path[1] == "kernel":
            return "Generators.0.3.0.weight", inv_deconv
        return "Generators.0.3.0.bias", ident
    if path[0] == "generators_0/rir" and len(path) == 5:
        i = path[1][len("rdb"):]
        j = path[2][len("conv"):]
        name, tf = _conv_leaf(path[4])
        # d2 reference: conv1..4 are Sequential(conv, LReLU); conv5 is bare
        seq = ".0" if j != "5" else ""
        return f"Generators.0.1.RDBs.{i}.conv{j}{seq}.{name}", tf
    return None


def _swin_key(p: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """bottom_up subtree path of a Swin → d2 key (the inverse of the Swin
    block of ``afigan_tpu.utils.converters.translate_d2_key``)."""
    pre = "backbone.bottom_up."
    ln = {"scale": "weight", "bias": "bias"}
    if p[0] == "patch_embed":
        name, tf = _conv_leaf(p[1])
        return f"{pre}patch_embed.proj.{name}", tf
    if p[0] == "patch_norm":
        return f"{pre}patch_embed.norm.{ln[p[1]]}", ident
    m = re.match(r"^norm_stage(\d)$", p[0])
    if m:
        return f"{pre}norm{int(m.group(1)) - 2}.{ln[p[1]]}", ident
    m = re.match(r"^stage(\d)/(block(\d+)|downsample)$", p[0])
    if not m:
        return None
    layer = f"{pre}layers.{int(m.group(1)) - 2}."
    if m.group(2) == "downsample":
        if p[1] == "reduction":
            return layer + "downsample.reduction.weight", inv_linear
        return layer + f"downsample.norm.{ln[p[2]]}", ident
    blk = layer + f"blocks.{m.group(3)}."
    if p[1] in ("norm1", "norm2"):
        return blk + f"{p[1]}.{ln[p[2]]}", ident
    if p[1] == "attn" and p[2] == "relative_position_bias_table":
        return blk + "attn.relative_position_bias_table", ident
    name = {"attn": "attn." + p[2], "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}.get(p[1])
    if name is None:
        return None
    if p[-1] == "kernel":
        return blk + name + ".weight", inv_linear
    return blk + name + ".bias", ident


def _bifpn_key(p: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """pyramid subtree path of a BiFPN → d2 key without the ``backbone.``."""
    m = re.match(r"^(lateral\d|p\d_skip|p6_resample)(_bn)?$", p[0])
    if m:
        name, bn = m.groups()
        if name == "p6_resample":
            base, conv, norm = "before_bifpn.top_block.p6", ".conv", ".norm"
        else:
            base, conv, norm = f"before_bifpn.{name}", ".0", ".1"
        if bn:
            return f"{base}{norm}.{_NORM_LEAF[p[1]]}", ident
        leaf, tf = _conv_leaf(p[2])
        return f"{base}{conv}.{leaf}", tf
    m = re.match(r"^layer(\d+)_(conv\d_(?:up|down)|p\d_w[12])$", p[0])
    if not m:
        return None
    base = f"BiFPNLayer_{m.group(1)}_{m.group(2)}"
    if len(p) == 1:
        return base, ident
    if p[1] == "norm":
        return f"{base}.norm.{_NORM_LEAF[p[2]]}", ident
    leaf, tf = _conv_leaf(p[2])
    return f"{base}.{p[1]}.{leaf}", tf


def _fcos_key(p: Tuple[str, ...], tower_step: int) -> Optional[Tuple[str, Callable]]:
    """fcos_head subtree path → AdelaiDet key."""
    pre = "proposal_generator.fcos_head."
    m = re.match(r"^scale_(\d+)$", p[0])
    if m and len(p) == 1:
        return f"{pre}scales.{m.group(1)}.scale", ident
    m = re.match(r"^(cls_tower|bbox_tower)(\d+)$", p[0])
    if m:
        idx = int(m.group(2)) * tower_step
        if p[1] == "conv":
            name, tf = _conv_leaf(p[2])
            return f"{pre}{m.group(1)}.{idx}.{name}", tf
        if p[1] == "norm" and p[2] in ("scale", "bias"):
            return f"{pre}{m.group(1)}.{idx + 1}.{_NORM_LEAF[p[2]]}", ident
        return None
    if p[0] in ("cls_logits", "bbox_pred", "ctrness") and p[1] == "conv":
        name, tf = _conv_leaf(p[2])
        return f"{pre}{p[0]}.{name}", tf
    return None


def _sag_mask_key(p: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """CenterMask mask_head subtree path → CenterMask2 key."""
    pre = "roi_heads.mask_head."
    if p[0] == "deconv" and len(p) == 2:
        return (pre + "deconv.weight", inv_deconv) if p[1] == "kernel" else (
            pre + "deconv.bias", ident)
    if p[:2] == ("sam", "sam_conv") and p[2] == "conv":
        name, tf = _conv_leaf(p[3])
        return f"{pre}spatialAtt.conv.{name}", tf
    if (re.match(r"^mask_fcn\d+$", p[0]) or p[0] == "predictor") and p[1] == "conv":
        name, tf = _conv_leaf(p[2])
        return f"{pre}{p[0]}.{name}", tf
    return None


def _keypoint_key(p: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """roi_heads/keypoint_head subtree path → d2 key (the inverse of the JAX
    package's keypoint-head mapping): ``conv_fcn{i}/conv`` convs and the
    ``score_lowres`` deconv."""
    pre = "roi_heads.keypoint_head."
    if p[0] == "score_lowres" and len(p) == 2:
        return (pre + "score_lowres.weight", inv_deconv) if p[1] == "kernel" else (
            pre + "score_lowres.bias", ident)
    if re.match(r"^conv_fcn\d+$", p[0]) and p[1] == "conv":
        name, tf = _conv_leaf(p[2])
        return f"{pre}{p[0]}.{name}", tf
    return None


def translate_path(path: Tuple[str, ...], fc1_channels: Dict[str, int],
                   tower_step: int = 3) -> Optional[Tuple[str, Callable]]:
    """Flax params / batch_stats path → (d2 key, inverse transform), or
    None. ``fc1_channels``: per box head (its flax name), the channels of
    the map that its first FC flattens. ``tower_step``: modules per FCOS tower
    conv (3 with a norm: conv, norm, ReLU; 2 without)."""
    p = path
    if p[0] == "fcos_head":
        return _fcos_key(p[1:], tower_step)
    if p[0] == "mask_head":
        return _sag_mask_key(p[1:])
    if p[0] == "backbone" and p[1] == "bottom_up" and p[2].startswith(("stem", "res")):
        # ("stem"|"resN/blockK", conv, "conv"|"norm", leaf)
        blk, layer = p[2], p[3]
        if blk == "stem":
            prefix = f"backbone.bottom_up.stem.{layer}"
        else:
            m = re.match(r"^res(\d)/block(\d+)$", blk)
            if not m:
                return None
            prefix = f"backbone.bottom_up.res{m.group(1)}.{m.group(2)}.{layer}"
        if len(p) == 7 and (p[4], p[5]) in _SPLAT:
            prefix = f"{prefix}.{_SPLAT[p[4], p[5]]}"
            if p[5] == "norm":
                return f"{prefix}.{_NORM_LEAF[p[6]]}", ident
            name, tf = _conv_leaf(p[6])
            return f"{prefix}.{name}", tf
        if p[4] == "conv" and p[5] == "kernel":
            return prefix + ".weight", inv_conv
        if p[4] == "norm":
            return f"{prefix}.norm.{_NORM_LEAF[p[5]]}", ident
        return None
    if p[0] == "backbone" and p[1] == "bottom_up" and not p[2].startswith(("stem", "res")):
        return _swin_key(p[2:])
    if p[0] == "backbone" and p[1] == "pyramid":
        bifpn = _bifpn_key(p[2:])
        if bifpn is not None:
            return "backbone." + bifpn[0], bifpn[1]
        if p[2] == "srf_module":
            out = _generator_key(p[3:])
            if out is None:
                return None
            return "backbone.srf_module." + out[0], out[1]
        if re.match(r"^(fpn_lateral|fpn_output|pafpn_output|pafpn_downsample)\d$", p[2]):
            if p[3] == "norm":
                return f"backbone.{p[2]}.norm.{_NORM_LEAF[p[4]]}", ident
            name, tf = _conv_leaf(p[4])
            return f"backbone.{p[2]}.{name}", tf
        if p[2] in ("top_block/p6", "top_block/p7") and p[3] == "conv":
            name, tf = _conv_leaf(p[4])
            return f"backbone.{p[2].replace('/', '.')}.{name}", tf
        return None
    if p[0] == "proposal_generator" and p[2] == "conv":
        name, tf = _conv_leaf(p[3])
        return f"proposal_generator.rpn_head.{p[1]}.{name}", tf
    if p[0] == "roi_heads":
        head = p[1]
        m = re.match(r"^(box_head|box_predictor)(?:_(\d))?$", head)
        if m:  # the cascade stage index becomes a ModuleList index
            head = m.group(1)
            prefix = f"roi_heads.{head}." + (f"{m.group(2)}." if m.group(2) else "")
        if head == "box_head" and re.match(r"^fc\d$", p[2]):
            if p[3] == "bias":
                return f"{prefix}{p[2]}.bias", ident
            if p[2] == "fc1":
                return (f"{prefix}fc1.weight",
                        lambda w: inv_linear_to_chw(w, fc1_channels[p[1]]))
            return f"{prefix}{p[2]}.weight", inv_linear
        if head == "box_head" and re.match(r"^conv\d$", p[2]):
            if p[3] == "conv":
                name, tf = _conv_leaf(p[4])
                return f"{prefix}{p[2]}.{name}", tf
            return f"{prefix}{p[2]}.norm.{_NORM_LEAF[p[4]]}", ident
        if head == "box_predictor":
            name = "weight" if p[3] == "kernel" else "bias"
            return (f"{prefix}{p[2]}.{name}",
                    inv_linear if name == "weight" else ident)
        if head == "keypoint_head":
            return _keypoint_key(p[2:])
        m = re.match(r"^res5/block(\d+)$", head)
        if m:  # the Res5 heads' res5 stage ("res5/block0" is one flax key)
            prefix = f"roi_heads.res5.{m.group(1)}.{p[2]}"
            if p[3] == "conv" and p[4] == "kernel":
                return prefix + ".weight", inv_conv
            if p[3] == "norm":
                return f"{prefix}.norm.{_NORM_LEAF[p[4]]}", ident
            return None
        if head == "mask_deconv":  # the Res5 heads' C4 mask head
            return (("roi_heads.mask_head.deconv.weight", inv_deconv) if p[2] == "kernel"
                    else ("roi_heads.mask_head.deconv.bias", ident))
        if head == "mask_predictor" and p[2] == "conv":
            name, tf = _conv_leaf(p[3])
            return f"roi_heads.mask_head.predictor.{name}", tf
        if head == "mask_head":
            if p[2] == "deconv":
                if p[3] == "kernel":
                    return "roi_heads.mask_head.deconv.weight", inv_deconv
                return "roi_heads.mask_head.deconv.bias", ident
            if p[3] == "conv":
                name, tf = _conv_leaf(p[4])
                return f"roi_heads.mask_head.{p[2]}.{name}", tf
            if p[3] == "norm":
                return f"roi_heads.mask_head.{p[2]}.norm.{_NORM_LEAF[p[4]]}", ident
        return None
    return None


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def generator_state_dict(params) -> Dict[str, np.ndarray]:
    """A standalone ``AFIGenerator`` params tree → {'Generators.0.*': ndarray}
    (the port ``AFIGenerator``'s own state-dict keys)."""
    out = {}
    for path, leaf in _leaves(params):
        tr = _generator_key(path)
        if tr is None:
            raise KeyError(f"no d2 name for generator param {'/'.join(path)}")
        out[tr[0]] = tr[1](np.asarray(leaf, np.float32))
    return out


def _discriminator_key(path: Tuple[str, ...]) -> Optional[Tuple[str, Callable]]:
    """``discriminators_0/block{i}`` / ``discriminators_0/out`` path → d2
    'Discriminators.0.{i}.0.*' key (the inverse of the JAX package's
    ``translate_discriminator_key``)."""
    m = re.match(r"^discriminators_0/(?:block(\d)|out)$", path[0])
    if m is None or len(path) != 3:
        return None
    base = f"Discriminators.0.{m.group(1) or 3}.0"
    if path[1] == "conv":
        name, tf = _conv_leaf(path[2])
        return f"{base}.{name}", tf
    if path[1] == "norm" and path[2] in _NORM_LEAF:
        return f"{base}.norm.{_NORM_LEAF[path[2]]}", ident
    return None


def discriminator_state_dict(variables) -> Dict[str, np.ndarray]:
    """A ``PatchDiscriminator``'s flax ``{"params", "batch_stats"}`` (or a D
    state's params and statistics) → the port ``PatchDiscriminator``'s own
    state-dict keys."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            tr = _discriminator_key(path)
            if tr is None:
                raise KeyError(f"no d2 name for discriminator {coll} {'/'.join(path)}")
            out[tr[0]] = tr[1](np.asarray(leaf, np.float32))
    return out


def _fc1_channels(params) -> Dict[str, int]:
    """Per box head: the output width of its last conv, or without convs the
    pyramid's width (the RPN conv's input)."""
    out = {}
    for name, head in params.get("roi_heads", {}).items():
        if name.startswith("box_head"):
            convs = sorted(k for k in head if re.match(r"^conv\d$", k))
            kernel = (head[convs[-1]] if convs else params["proposal_generator"]["conv"]
                      )["conv"]["kernel"]
            out[name] = int(np.shape(kernel)[-1 if convs else 2])
    return out


def variables_to_state_dict(variables) -> Dict[str, np.ndarray]:
    """flax ``{"params": ..., "batch_stats": ...}`` (numpy or jax arrays) →
    {d2 key: ndarray}.

    Raises KeyError naming any path the mapping does not know, so a
    silently-dropped weight cannot pass a strict load."""
    params = variables["params"]
    fc1_channels = _fc1_channels(params)
    tower_step = 3 if "norm" in params.get("fcos_head", {}).get("cls_tower0", {}) else 2
    out: Dict[str, np.ndarray] = {}
    unknown = []
    for coll in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(coll, {})):
            tr = translate_path(path, fc1_channels, tower_step)
            if tr is None:
                unknown.append("/".join(path))
                continue
            key, tf = tr
            out[key] = tf(np.asarray(leaf, np.float32))
    if unknown:
        raise KeyError(f"no d2 name for flax variables: {unknown[:8]}")
    return out
