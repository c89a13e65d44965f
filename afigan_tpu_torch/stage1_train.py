#!/usr/bin/env python
"""Stage-1 training CLI of the port: AFI-GAN, the generator and the
discriminator against the frozen guide, on one GPU (or the CPU); the
counterpart of the repo's ``stage1_train.py``.

Usage:
    python -m afigan_tpu_torch.stage1_train \\
        --config-file configs/step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml \\
        [--resume] [--device cpu] [MODEL.GUIDE_WEIGHTS guide.pkl] [DATASETS.ROOT datasets] \\
        [SOLVER.MAX_ITER N] [KEY VALUE ...]

Writes ``metrics.json``, ``log.txt`` and ``G_0/model_%07d.pth`` /
``D_0/model_%07d.pth`` checkpoints to ``OUTPUT_DIR``. Runs on the GPU and
fails without one; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from . import stage3_train


def parse_args(argv=None):
    return stage3_train.parse_args(argv, __doc__)


def main(args):
    return stage3_train.run(args, "AFIGANTrainer")


if __name__ == "__main__":
    main(parse_args())
