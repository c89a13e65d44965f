"""Checkpoints of the port's trainers (counterpart of
``afigan_tpu/engine/checkpoint.py``): ``<dir>/model_%07d.pth`` holding the
model's state dict, the optimizer's and the iteration, a ``last_checkpoint``
pointer, and resume from it. The cross-stage surgery keeps only the AF
interpolator's keys of a detector checkpoint (``remain_only_afi_names``, the
reference's ``remain_only_AFI_names``)."""

from __future__ import annotations

import os
from typing import Dict, Optional

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
