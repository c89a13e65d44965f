#!/usr/bin/env python
"""Evaluation CLI of the port — COCO AP of a detector on one GPU (or the CPU).

Usage:
    python -m afigan_tpu_torch.run_net \\
        --config-file configs/inference/AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml \\
        --eval-only [MODEL.WEIGHTS model.pkl] [DATASETS.ROOT datasets] [KEY VALUE ...]

Same surface as the repo's ``run_net.py``: YAML config with ``_BASE_``
inheritance and dotted overrides, ``DATASETS.TEST[0]`` registered from
``DATASETS.ROOT``, then inference (test-time augmentation under
``TEST.AUG.ENABLED``, ``engine/tta.py::run_tta_inference``) and the COCO
evaluator, whose results are held against ``TEST.EXPECTED_RESULTS``. Weights come from
``MODEL.WEIGHTS`` (d2 ``.pkl`` / torch ``.pth``) or, when empty, from a
seeded generator (``--seed``). Runs on the GPU and fails without one;
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging

import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help='"cuda" (the default; fails without a GPU) or "cpu"')
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load a d2 ``.pkl`` / torch ``.pth`` checkpoint into ``model``. Every
    key of the model must be in the file, or nothing is loaded; keys only
    the file has (e.g. training-only state) are logged and skipped."""
    from .utils.converters import load_state_dict

    state = load_state_dict(path)
    own = model.state_dict().keys()
    missing = sorted(own - state.keys())
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} of the model's keys: {missing[:8]}")
    unexpected = sorted(state.keys() - own)
    if unexpected:
        logger.warning("%s: %d keys the model does not have, not loaded: %s",
                       path, len(unexpected), unexpected[:8])
    model.load_state_dict({k: torch.from_numpy(state[k]) for k in own}, strict=True)


def main(args):
    from .config import get_cfg
    from .data import coco
    from .engine.inference import run_inference
    from .engine.testing import verify_results
    from .engine.tta import run_tta_inference
    from .models.build import build_model

    if not args.eval_only:
        raise NotImplementedError("run_net is eval-only; training is not ported yet")
    logging.basicConfig(level=logging.INFO)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    coco.register_default_datasets(cfg.DATASETS.ROOT)
    dataset = coco.get_dataset(cfg.DATASETS.TEST[0])

    device = torch.device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)
    if cfg.MODEL.WEIGHTS:
        load_weights(model, cfg.MODEL.WEIGHTS)
    if cfg.TEST.AUG.ENABLED:
        results = run_tta_inference(cfg, model, dataset)
    else:
        results = run_inference(cfg, model, dataset)
    print(json.dumps(results))
    verify_results(cfg, results)
    return results


if __name__ == "__main__":
    main(parse_args())
