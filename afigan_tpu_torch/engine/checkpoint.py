"""Checkpoints of the port's trainers (counterpart of
``afigan_tpu/engine/checkpoint.py``): ``<dir>/model_%07d.pth`` holding the
model's state dict, the optimizer's and the iteration, a ``last_checkpoint``
pointer, and resume from it. The cross-stage surgery, over state dicts:
``remain_only_afi_names`` keeps only the AF interpolator's keys of a detector
checkpoint (the reference's ``remain_only_AFI_names``), ``extract_afi_subtree``
gives them under the standalone generator's names (``Generators.0.*``),
``transplant_generator`` puts a stage-1 generator into a detector's AF
interpolator (keys and shapes checked), and
``transplant_afi_between_detectors`` moves it from one detector to another
(stage 2 → stage 3)."""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

LAST_CHECKPOINT_FILE = "last_checkpoint"
AFI_PREFIX = "backbone.srf_module."


def save_checkpoint(directory: str, iteration: int, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    name = f"model_{iteration:07d}.pth"
    path = os.path.join(directory, name)
    torch.save({"model": model.state_dict(),
                "optimizer": None if optimizer is None else optimizer.state_dict(),
                "iteration": iteration}, path)
    with open(os.path.join(directory, LAST_CHECKPOINT_FILE), "w") as f:
        f.write(name)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    ptr = os.path.join(directory, LAST_CHECKPOINT_FILE)
    if not os.path.isfile(ptr):
        return None
    with open(ptr) as f:
        path = os.path.join(directory, f.read().strip())
    return path if os.path.isfile(path) else None


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """Model (strict) and optimizer state from ``path``; returns its
    iteration."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    model.load_state_dict(data["model"], strict=True)
    if optimizer is not None and data.get("optimizer") is not None:
        optimizer.load_state_dict(data["optimizer"])
    return int(data["iteration"])


def resume(directory: str, model: torch.nn.Module,
           optimizer: Optional[torch.optim.Optimizer] = None) -> int:
    """The latest checkpoint's iteration after loading it, or 0 if none."""
    path = latest_checkpoint(directory)
    return 0 if path is None else load_checkpoint(path, model, optimizer)


def remain_only_afi_names(state: Dict) -> Dict:
    """Only the AF interpolator's entries of a detector's state dict."""
    kept = {k: v for k, v in state.items() if k.startswith(AFI_PREFIX)}
    if not kept:
        raise KeyError(f"no {AFI_PREFIX}* keys in the checkpoint")
    return kept


def extract_afi_subtree(det_state: Mapping) -> Dict:
    """A detector's AF interpolator as a standalone generator's state dict."""
    return {k[len(AFI_PREFIX):]: v for k, v in remain_only_afi_names(det_state).items()}


def transplant_generator(det_state: Mapping, g_state: Mapping) -> Dict:
    """``det_state`` with its AF interpolator replaced by the generator
    ``g_state`` (``Generators.0.*`` keys): the same keys, the same shapes."""
    g = dict(g_state)
    own = extract_afi_subtree(det_state)
    if set(g) != set(own):
        raise KeyError("transplant: the generator's keys differ from the detector's AF "
                       f"interpolator's: {sorted(set(g) ^ set(own))[:8]}")
    for k, v in g.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"transplant: {k} has shape {tuple(v.shape)}, the detector "
                             f"{tuple(own[k].shape)}")
    out = dict(det_state)
    out.update({AFI_PREFIX + k: v for k, v in g.items()})
    return out


def transplant_afi_between_detectors(dst_state: Mapping, src_state: Mapping) -> Dict:
    """``dst_state`` with ``src_state``'s AF interpolator (only it moves)."""
    return transplant_generator(dst_state, extract_afi_subtree(src_state))
