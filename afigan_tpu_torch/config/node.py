"""Typed hierarchical config node with YAML `_BASE_` inheritance.

A small, dependency-free re-design of the reference's yacs `CfgNode`
(ref: afigan/config/config.py:3-12 and detectron2 v0.1.1 defaults): the
reference's YAML config zoo must load verbatim, so we keep yacs semantics —
string values are `literal_eval`'d (d2 YAMLs write tuples as strings, e.g.
``TRAIN: ("coco_2017_train",)``), merging type-checks against defaults,
`_BASE_` performs recursive inheritance, CLI overrides are dotted paths,
and `freeze()` makes the tree immutable after build.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

import yaml

_VALID_TYPES = (int, float, bool, str, list, tuple, type(None))

BASE_KEY = "_BASE_"


class CfgNode(dict):
    """Attribute-accessible dict with freeze semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze -------------------------------------------------------------
    def freeze(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def clone(self) -> "CfgNode":
        frozen = self.__dict__[CfgNode.IMMUTABLE]
        self.defrost()  # recursively, so deepcopy can reconstruct children
        c = copy.deepcopy(self)
        c.defrost()
        if frozen:
            self.freeze()
        return c

    # -- merging ------------------------------------------------------------
    def merge_from_file(self, cfg_filename: str, allow_unsafe: bool = True) -> None:
        loaded = _load_yaml_with_base(cfg_filename)
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(dict(other), [])

    def merge_from_list(self, opts: list) -> None:
        if len(opts) % 2 != 0:  # not an assert: must survive python -O
            raise ValueError(f"Override list has odd length: {opts}")
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            d = self
            for sub in keys[:-1]:
                if sub not in d:
                    raise KeyError(f"Non-existent config key: {full_key}")
                d = d[sub]
            last = keys[-1]
            if last not in d:
                raise KeyError(f"Non-existent config key: {full_key}")
            value = _decode_value(v)
            d[last] = _coerce(value, d[last], full_key)

    def _merge_dict(self, other: dict, path: list) -> None:
        for k, v in other.items():
            full = ".".join(path + [k])
            if k not in self:
                # yacs semantics: a YAML typo must not silently create a
                # dead key (merge_from_list already raised; file merges
                # behaved inconsistently)
                raise KeyError(f"Non-existent config key: {full}")
            if isinstance(v, dict):
                node = self[k]
                if not isinstance(node, CfgNode):
                    raise TypeError(f"Cannot merge dict into non-dict at {full}")
                node._merge_dict(v, path + [k])
            else:
                value = _decode_value(v)
                self[k] = _coerce(value, self[k], full)

    # -- io -----------------------------------------------------------------
    def dump(self) -> str:
        def to_plain(node):
            if isinstance(node, CfgNode):
                return {k: to_plain(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return list(node)
            return node

        return yaml.safe_dump(to_plain(self), sort_keys=True)

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _decode_value(v: Any) -> Any:
    """yacs semantics: strings that parse as Python literals become literals.

    Needed because d2-style YAMLs encode tuples as strings, e.g.
    ``STEPS: (60000, 80000)`` parses as the *string* "(60000, 80000)".
    """
    if not isinstance(v, str):
        if isinstance(v, dict):
            return CfgNode(v)
        return v
    try:
        parsed = ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v
    if isinstance(parsed, _VALID_TYPES) or isinstance(parsed, dict):
        return parsed
    return v


def _coerce(value: Any, existing: Any, full_key: str) -> Any:
    """Type-check a merged value against the default, with yacs's casts."""
    if existing is None or value is None:
        return value
    vt, et = type(value), type(existing)
    if vt == et:
        return value
    # interchangeable casts (yacs _check_and_coerce_cfg_value_type):
    # int may widen onto a float default; a float onto an int default is
    # a type error (silently storing 3.0 in NUM_CLASSES breaks shape
    # arithmetic far from the merge site)
    casts = [(tuple, list), (list, tuple), (int, float)]
    for src, dst in casts:
        if vt is src and et is dst:
            return dst(value)
    if isinstance(existing, CfgNode) and isinstance(value, dict):
        return CfgNode(value)
    raise ValueError(
        f"Type mismatch ({et} vs {vt}) for config key {full_key}: {existing} vs {value}"
    )


def _load_yaml_with_base(filename: str, _seen: tuple = ()) -> dict:
    resolved = os.path.abspath(os.path.expanduser(filename))
    if resolved in _seen:
        chain = " -> ".join(_seen + (resolved,))
        raise ValueError(f"_BASE_ cycle detected: {chain}")
    with open(resolved, "r") as f:
        cfg = yaml.safe_load(f)
    if cfg is None:
        cfg = {}
    if BASE_KEY in cfg:
        base_filename = os.path.expanduser(cfg.pop(BASE_KEY))
        if not os.path.isabs(base_filename):
            base_filename = os.path.join(os.path.dirname(resolved), base_filename)
        base = _load_yaml_with_base(base_filename, _seen + (resolved,))
        _deep_update(base, cfg)
        return base
    return cfg


def _deep_update(base: dict, other: dict) -> dict:
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base
