#!/usr/bin/env python
"""Stage-2 training CLI of the port: the AF extractor, the detector on the
x0.5 images with the discriminator against the frozen guide, on one GPU (or
the CPU); the counterpart of the repo's ``stage2_train.py``.

Usage:
    python -m afigan_tpu_torch.stage2_train \\
        --config-file configs/step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml \\
        [--resume] [--device cpu] [MODEL.AFI_GEN_WEIGHTS G_0/model_0300000.pth] \\
        [MODEL.AFI_DIS_WEIGHTS D_0/model_0300000.pth] [DATASETS.ROOT datasets] [KEY VALUE ...]

Writes ``metrics.json``, ``log.txt`` and ``AFExtractor/model_%07d.pth`` /
``Disc/model_%07d.pth`` checkpoints to ``OUTPUT_DIR``. Runs on the GPU and
fails without one; ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

from . import stage3_train


def parse_args(argv=None):
    return stage3_train.parse_args(argv, __doc__)


def main(args):
    return stage3_train.run(args, "AFExtractorTrainer")


if __name__ == "__main__":
    main(parse_args())
