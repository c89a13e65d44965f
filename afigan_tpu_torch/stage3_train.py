#!/usr/bin/env python
"""Stage-3 training CLI of the port: the target-detector fine-tune on one GPU
(or the CPU), the counterpart of the repo's ``stage3_train.py``.

Usage:
    python -m afigan_tpu_torch.stage3_train \\
        --config-file configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml [--resume] \\
        [--device cpu] [MODEL.WEIGHTS backbone.pkl] [MODEL.AF_EXTRACTOR_WEIGHTS s2.pth] \\
        [DATASETS.ROOT datasets] [SOLVER.MAX_ITER N] [KEY VALUE ...]

Writes ``metrics.json``, ``log.txt`` and ``model_%07d.pth`` checkpoints to
``OUTPUT_DIR``. Runs on the GPU and fails without one; ``--device cpu`` asks
for the CPU.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config-file", required=True)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help='"cuda" (the default; fails without a GPU) or "cpu"')
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(args):
    from .config import get_cfg
    from .engine.trainers import TargetDetectorTrainer

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()
    trainer = TargetDetectorTrainer(cfg, device=args.device)
    trainer.train(resume=args.resume)
    return trainer


if __name__ == "__main__":
    main(parse_args())
