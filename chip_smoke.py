#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``afigan_tpu_torch``).

    python3 chip_smoke.py            # one GPU, no arguments
    python3 chip_smoke.py --generator-levels   # only the generator's device
                                     # time per pyramid level
    python3 chip_smoke.py --ddp-cards N   # only phase train_ddp's (a) and
                                     # (b) on N cards, NCCL between them

Phases, always all (any failure exits non-zero; nothing falls back to the
CPU):
  1. build    compile every CUDA kernel from ``afigan_tpu_torch/csrc`` (one nvcc
              per source, in parallel); print the card and its power limit; the
              pool's backward must hold no global atomic in its SASS
  2. kernels  each of the eleven kernels against its plain PyTorch version at
              the shapes of the paths that run it (the generator and the pooler
              at 256 and at 160 channels), float32 with TF32 off and
              bfloat16: error, median CUDA-event time of both and of the one
              PyTorch call that computes the same function where there is one
              (``F.layer_norm``, ``scaled_dot_product_attention``, an
              advanced-indexing gather: yardsticks, used nowhere in the port),
              and the least time the card could
              take (bytes over 3.35 TB/s against operations over 989 TFLOP/s in
              bf16, 67 in fp32). In bfloat16 each of the generator's 19
              launches is also held, on its own inputs, against the float32
              plain conv at one rounding of its output, and every bf16 bound
              must reject a plain output with a part taken out. The generator's
              one-call routes must equal their single launches bit for bit; the
              attention reads views of a packed qkv tensor, as the Swin block
              passes them; one generator call per pyramid level runs under the
              profiler (device time; 19 conv launches and no other kernel). The
              pooler at the R-50, Swin and CenterMask shapes; the NMS kernel equal
              to the blocked plain loop on the card entry for entry (outputs,
              orders, keep masks up to the max_out-th kept box) at the RPN,
              training RPN (8819), Res5 (2000), FCOS and detection sizes and
              the contract's corner cases (``tests/torch_port_nms_cases.py``),
              and a keep mask with one kept box flipped must fail that check;
              at the real sizes its device time beside its bound and the
              walk's floor (tiles walked times one dependent step, measured). The
              pool's backward at the train step's shapes (box pool 2 x 512 ROIs
              at P 7, mask pool 2 x 128 at P 14, C 256) against autograd through
              the plain gather, the same bits on a second run, by events (its
              device time is read in phase 10); the plain gradient without one
              ROI must fail. The deformable conv's sampling
              (``deform_conv``) and its adjoint (``deform_conv_bwd``) at the six
              shapes of the ResNeSt-101 cascade's 30 deformable convs (832x1344,
              batch 2: 208x336x128 down to 26x42x512), bf16 x and offsets (a
              non-contiguous view, as the model passes them), a float32 mask or
              none, under fractional, all-zero and integer offsets (samples on
              rows -1, 0, H-1, H), and off the path at C 36 and 10, stride
              and dilation 2: the columns equal to the plain gather's bit
              for bit, the three gradients within 1e-4 of their largest entry,
              the share of each kernel's corners outside their tile's window;
              the forward's device time against its bound at each path shape
              and offset set; kernel, plain and bound ms of the main path's
              case by events
  3. slice    Mask R-CNN R-50-FPN + AF interpolator at full width (bf16, random
              weights from a seeded torch.Generator) through ``build_model``
              and ``predict`` on random-pixel batches of an 832x1344 canvas;
              launch counts of every kernel in that run (4 NMS calls a batch, each
              one kernel call and none the plain loop), ms per batch (median
              and range), peak memory, one batch under torch.profiler and split
              by layer; then the same with normalised pixels and no score
              threshold, so that the heads see 100 boxes per image; then one
              batch of the same model with ``MODEL.AFI.N_RDB 1``, the
              configuration whose generator runs ``fused_rdb``
  4. slice_swin  Cascade R-CNN, Swin (embed 192, depths 2-2-18-2, window 12) +
              BiFPN (7 layers, shared AF interpolator) at full width from the
              flagship YAML, 896x1408 canvas, batch 2, bf16, the same two
              traffics, launch counts asserted per batch (24 window attentions,
              55 LayerNorms, 28 generator calls, 3 pooler calls, 4 NMS calls); one window
              attention under the profiler must copy no activation between its
              qkv linear and its projection
  5. slice_centermask  CenterMask (FCOS + SAG mask head) on ResNet-50 + BiFPN
              (6 layers x 160 channels, shared AF interpolator) at full width,
              896x1408 canvas, batch 2, bf16, the same two traffics, each under
              ``TPU.POOLER_IMPL`` ``pallas`` (one ``roi_pool`` launch a batch) and
              ``windowed`` (one ``window_gather`` launch and one ``roi_pool``
              launch over the overflow slots a batch); 24 generator calls and 2
              NMS calls a batch; on one batch the two poolers' features and masks must agree
  6. slice_pafpn  Mask R-CNN R-50-PAFPN(AFI) from its YAML at full width,
              832x1344, batch 2, bf16, the same two traffics as phase 3, launch
              counts a batch asserted (3 generator calls, 2 pooler calls, 4 NMS)
  7. slice_resnest  Cascade Mask R-CNN ResNeSt-101 (radix 2, deep stem, SyncBN)
              with FPN(AFI) and with PAFPN(AFI) from their YAMLs at full width,
              the canvas of their 800/1333 test sizes, batch 2, bf16, the same
              two traffics; 4 pooler calls a batch (3 cascade box stages and the
              mask head on the final detections), 3 generator calls, 4 NMS
  7b. slice_keypoint  Keypoint R-CNN R-50-FPN(AFI) at full width (the main
              path's YAML with d2's Base-Keypoint-RCNN-FPN edits: 17 keypoints
              through 8 x 512 convs, one class), 832x1344, batch 2, bf16, the
              two traffics of phase 3: 3 generator calls, 2 pool calls (the box
              7x7 and the keypoint 14x14 with its own sampling and alignment)
              and 4 NMS a batch asserted, every batch's keypoints (2, 100, 17,
              3), finite and inside their boxes; one batch of 100 detections
              an image with every call held against its plain version
  7c. res5    the Res5 (C4) ROI heads over the same FPN(AFI) (the RPN and the
              heads on p4, res5 2048/512 inside the head, masks), full width,
              batch 2, bf16, the two traffics: 2 window_gather and 2 pool
              launches (the fast pooler's overflow slots) and 4 NMS a batch
              asserted, one batch with every call held (window_gather bit for
              bit) and each window_gather call timed against its plain
              version, the indexing gather and its bound; then stage-3
              training as phase 10 (ROI batch 512): the fast pooler's
              training route, one window_gather, one pool (its overflow
              slots), one pool backward and 2 NMS launches a step, all held
              on one step and timed on a step's own calls
  7d. slice_proposals  ProposalNetwork R-50-FPN(AFI) (the main path's YAML
              with d2's rpn_R_50_FPN_1x edits: backbone and RPN alone, 2000
              proposals an image) at full width, 832x1344, batch 2, bf16, 10
              timed batches: 48 chain, 9 upsample and 2 NMS launches a batch
              and no pool asserted, the proposals (2, 2000) finite and inside
              the canvas; one batch held, its bounds, a profiled batch and
              its layer split; then ``run_inference`` over a generated 4-image
              COCO set with ``max_images`` 3: the 8 box-proposal AR keys,
              from 3 images
  7e. slice_backbones  R-18-FPN(AFI) Mask R-CNN (basic blocks, res2 64) and
              the ResNeSt-101-FPN cascade with modulated deformable convs in
              res3-res5 (ResNeSt's public DCN setting; float32 inside the
              deformable conv), full width, bf16, batch 2, the two traffics,
              5 batches each, launches asserted (30 ``deform_conv`` a batch of
              the deformable ResNeSt); one R-18 batch and one deformable batch
              held (every deformable conv's columns bit for bit); the
              deformable convs' device time, the sampling kernel's 30
              launches against their bound, and the batch's peak memory in a
              profiled batch
  8. tta      the flagship YAML unchanged (Swin-L + BiFPN x7 + Cascade R-CNN;
              9 scales x flip) through ``engine/tta.py::run_tta_inference`` over
              an on-disk COCO set of 2 random-pixel 480x640 images, bf16: seconds
              per image, 18 passes an image of one image each, every launch
              count of a pass asserted (the Swin slice's, NMS 2) plus one merge
              NMS an image, peak memory by canvas; then one pass at the smallest
              and one at the largest scale with every kernel call held against
              its plain version
  9. nms_ab   r50 and centermask (main path): every NMS call of one batch
              under torch.cuda.set_sync_debug_mode("error"), the host syncs
              from the proposal head to the end of a batch logged by source
              line; then 10 batches with the NMS kernel against 10 with the
              blocked plain loop on the card, alternating, medians and layer
              splits side by side (the plain route is this script's switch)
 10. train    stage-3 training of Mask R-CNN R-50-FPN(AFI) at full width
              (``configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml``, bf16, batch
              2, 832x1344) through ``TargetDetectorTrainer``: two iterations of
              ``train()`` over an in-memory dataset, then 2 + 10 steps on one
              repeated batch (launches per step asserted: 2 pool forwards, 2
              pool backwards, 2 NMS, no generator kernel; losses finite and
              falling), ms per step, images/s, peak memory, one profiled step
              (the pool's backward's device time in it) and a forward /
              backward / optimizer split; then the pool's backward on one
              step's own ROIs and gradients, as in phase 2 (the JSON line's
              ``roi_pool_bwd`` entry)
 10b. train_centermask  stage-3 training of CenterMask R-50-BiFPN(AFI) the
              same way (the inference YAML at full width with
              ``MODEL.AFI_FREEZE False``, BiFPN 6 x 160 with batch norm that
              trains, 64 GT slots with 28x28 masks, bf16, batch 2, 896x1408):
              1 pool forward, 1 pool backward at 160 channels and 2 NMS
              launches a step asserted; the mask branch samples the FCOS
              head's post-NMS detections of the step (with random weights none
              passes the 0.05 threshold: it trains on the 12 GT boxes an image,
              appended); one step's pool and NMS launches held against their
              plain versions, and the pool's backward on one step's own ROIs
 10c. train_cascade  stage-3 training of Cascade Mask R-CNN ResNeSt-101-PAFPN
              the same way (4 pool launches each way, 2 NMS a step)
 10d. train_swin  stage-3 training of Cascade R-CNN Swin-L-BiFPN(AFI) the same
              way (the flagship YAML at full width with ``MODEL.AFI_FREEZE
              False``: embed 192, depths 2-2-18-2, window 12, DropPath 0.2,
              BiFPN 7 x 256 with SyncBN that trains, no masks; bf16, batch 2,
              896x1408): 3 pool launches each way and 2 NMS a step and no
              LayerNorm or attention kernel (the Swin trains through its
              training route, torch ops under autograd) asserted; the timed
              steps' DropPath masks (the trainer's stream) must drop some
              branches and keep others; the device time of the training
              route's attention and LayerNorm in the profiled step; then one
              eval pass of the trained model under ``no_grad``: 24 attention
              and 55 LayerNorm launches, every kernel call held against its
              plain version
 10f. train_keypoint  stage-3 training of phase 7b's Keypoint R-CNN the same
              way (17 COCO keypoints an object, the flip through their
              left/right permutation): 2 pool launches each way (box 7x7,
              keypoint 14x14) and 2 NMS a step, the held step holding the
              pool's backward too
 10g. train_proposals  stage-3 training of the stage-3 YAML as a
              ProposalNetwork the same way (12 steps): 2 NMS launches a step
              and no pool; only the RPN's two losses, finite and falling; the
              RPN head and the backbone moved, stem and res2 frozen
 10h. train_aug  stage-3 training of the R-50 YAML over 16 generated
              480x640 scenes whose classes are skewed (two of the three in
              one image), with d2's crop (relative_range 0.9), the colour
              jitter and the repeat-factor sampler (threshold 0.25), 4
              mapping threads: ``train()`` for 2 iterations, then 12 steps
              each on the loader's next batch: the first with its pool,
              pool-backward and NMS calls held against their plain versions,
              the wait on the loader beside each later step, float32 batches,
              the rare image's repeats, 2 pool launches each way and 2 NMS
              asserted at every step
 10i. train_dcn  stage-3 training of 7e's deformable ResNeSt-101-FPN cascade
              (``MODEL.AFI_FREEZE False``) the same way, full width, bf16, batch
              2, 832x1344: the first step, from the zero-initialised offset
              predictors (every sample on a pixel), held against the plain
              versions (30 ``deform_conv``, 30 ``deform_conv_bwd``, 4 pool
              launches each way, 2 NMS); every step's launches asserted; the
              offset predictors and deformable weights moved; then the offset
              predictors set off zero (``offsets_on``), one more step held and
              3 steps counted one by one, losses finite; ms a step and peak
              memory; in the profiled step the sampling kernel's 30 launches
              against their bound
 10e. train_ddp  data-parallel training through ``engine/launch.py``: two ranks
              spawned on this one card over gloo (``device="cuda:0"``,
              ``backend="gloo"``: NCCL refuses two ranks on one device; gloo
              stages every collective through the host, so its times are not
              NCCL's). (a) stage 3 of the R-50 step-3 YAML, 2 ranks x 2 images
              at 832x1344, bf16, through ``TargetDetectorTrainer``: two
              iterations of ``train()`` (only rank 0 writes the checkpoint and
              ``metrics.json``), then 2 + 8 steps on each rank's batches from
              its shard of the loader: losses finite and equal on both ranks,
              parameters bit-equal across ranks, step 1's reduced gradient
              equal to the mean of the ranks' own, 2 pool forwards, 2 pool
              backwards and 2 NMS and no other kernel a rank at every step
              (each step counted on its own), disjoint records at every step;
              ms a step, the reduce's ms and bytes, peak memory a rank.
              (b) stage 1 of the step-1 YAML, 2 ranks x 2 images: D's SyncBN
              statistics moved, G and D bit-equal across ranks. (c) in this
              process, a one-rank NCCL group: (a)'s steps bit-equal to the
              same steps with no group (deterministic algorithms on), NCCL's
              all-reduce op in the profiled step (over one rank it launches no
              device kernel); ms a step of one rank. ``--ddp-cards N`` runs
              (a) and (b) alone on N cards over NCCL, whose all-reduce kernel
              each rank's profiled step must show
 11. stage1   stage-1 training (AFI-GAN) at full width
              (``configs/step1_afigan_training/...R_50_FPN_1x.yaml``: R-50-FPN
              guide, AF interpolator 256 channels with 3 dense blocks, the
              discriminator at 512/1024/1024; bf16, batch 2, 832x1344 and its
              416x672 half) through ``AFIGANTrainer``: two iterations of
              ``train()`` over the in-memory dataset (dual-scale loader, G_0/
              and D_0/ checkpoints), then 2 + 10 steps on one repeated batch:
              no launch of any port kernel (the generator trains through its
              unfused route), every loss finite, G and D moved, no gradient
              left on D; ms per step, images/s, peak memory, one profiled step
              (device busy, and its guide / generator / D step / G step
              split by the step's record_function ranges), and the step's
              operations (PyTorch's FLOP counter) against the
              tensor cores' peak
 12. stage2   stage-2 training (the AF extractor) the same way through
              ``AFExtractorTrainer``, built from phase 11's G_0/ and D_0/
              checkpoints (held equal on the card), whose AFExtractor/
              checkpoint then goes into a stage-3 trainer (held equal too):
              the detector on the half-scale images and
              GT, the guide at 832x1344; 2 ``roi_pool``, 2 ``roi_pool_bwd`` and
              2 NMS launches a step asserted, no generator kernel; then the
              pool's backward on one step's own ROIs, as in phase 10
 12b. stage2_fcos  stage 2 of the FCOS R-50-BiFPN step-2 YAML the same way,
              widths unchanged (R-50, BiFPN 6 x 160 whose batch norms train, AF
              interpolator and D at 160 channels, 4-conv GN towers; guide
              R-50-BiFPN with nearest upsampling), bf16, batch 2, 1024x1536
              (800x1333 padded to 256) and its 512x768 half, the YAML's lr at
              batch 2: no launch of any port kernel (FCOS pools nothing and
              decodes nothing in training, the generator trains unfused),
              detector, D and every BiFPN running statistic moved
 12c. stage2_keypoint  stage 2 of the R-50 step-2 YAML with d2's keypoint
              edits (17 COCO keypoints an object, the half-scale keypoints in
              the detector's GT) the same way: 2 pool launches each way (box
              7x7, keypoint 14x14) and 2 NMS a step asserted, one step held
              (the pool's backward too), ``loss_keypoint`` positive; the
              pool's backward on one step's own ROIs
 13. card_vs_cpu  in float32 (TF32 off) on a small canvas: the GPU (kernels)
              and the CPU (plain versions) on the same weights; detections must
              agree at the golden-regression tolerances. The R-50 model under
              both poolers, a narrow Swin model (embed 32, window 4), a
              narrow CenterMask under ``windowed``, the R-50-PAFPN model, a
              narrow ResNeSt-PAFPN cascade mask model, TTA with masks on
              a narrow R-50 (merged detections and averaged masks), Keypoint
              R-CNN with two keypoint convs of 64 (keypoints within 0.05 px)
              and the Res5 heads (window_gather and the overflow pool); the
              ProposalNetwork (proposals within 0.05 px, objectness 1e-3), the
              R-18 and a narrow deformable ResNeSt (its offset predictors
              moved off zero; the sampling kernel launched on the card)
 14. train_card_vs_cpu  one stage-3 step of each of five narrow float32
              models (R-50, CenterMask, the ResNeSt cascade's heads over a
              ResNet-50, the Swin cascade with the same DropPath masks, the
              ProposalNetwork) on the
              card and on the CPU with the same weights, batch and subsample
              keys: losses, trainable gradients and batch-norm statistics must
              agree
 15. stage12_card_vs_cpu  one step of stage 1 and one of stage 2 (the R-50
              and the FCOS step-2 YAMLs, and the R-50's with keypoints) at the
              CPU tests' narrow widths, the
              same way: metrics, gradients and the discriminator's (and the
              BiFPN's) statistics must agree
 16. tools    the port's tools under ``output/chip_smoke_tools/``: (a)
              ``validate_training --family r50`` (stages 1 -> 2 -> 3 through
              the trainers' checkpoint files, 400 iterations a stage at 8
              images, full width, a generated COCO set of 16 structured
              480x640 scenes): every judge's verdict true and every loss
              finite, ms an iteration and peak memory a stage, no launch in
              any step of stage 1 and exactly 2 pool launches each way and 8
              NMS in every step of stages 2 and 3, each stage's first step
              with those calls held against their plain versions, the data
              time a stage beside the serial loader's (PERF.md); (a2)
              ``validate_training --family keypoint`` (Keypoint R-CNN stage
              3, 150 iterations at 4 images): every judge, 2 pool launches
              each way and 4 NMS every step, the first step held; (b)
              ``generate_pseudo_labels`` with (a)'s stage-3 checkpoint over its
              16 images at score 0.05: 48 chain, 9 upsample, 2 pool and 2 NMS
              launches on every image, the first image's calls held against
              their plain versions, images/s, the JSON read back by
              ``register_coco_instances`` with 16 images; (c) PreciseBN on a
              4-iteration stage-3 run of the CenterMask YAML (BiFPN SyncBN
              that trains, ``NUM_ITER`` 8 of the YAML's 200): every running
              statistic replaced by finite values before the evaluation,
              which sees them; (d) a ``ProfilerHook`` trace of two of (c)'s
              steps that names the pool kernel forward and backward; (e)
              ``convert_checkpoint`` of (a)'s stage-3 checkpoint, loaded into
              a fresh model on the card with no key unmatched

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# kernel name → (port source, the TPU kernel it replaces, the path whose
# launches and shapes its entry of the JSON line reports)
KERNELS = {
    "afi_chain": ("afigan_tpu_torch/csrc/afi_conv3x3.cu",
                  "afigan_tpu/ops/pallas/afi_chain.py:180", "r50"),
    "afi_upsample": ("afigan_tpu_torch/csrc/afi_upsample.cu",
                     "afigan_tpu/ops/pallas/afi_upsample.py:159", "r50"),
    "roi_pool": ("afigan_tpu_torch/csrc/roi_pool.cu",
                 "afigan_tpu/ops/pallas/roi_pool.py:81", "r50"),
    "afi_rdb": ("afigan_tpu_torch/csrc/afi_conv3x3.cu",
                "afigan_tpu/ops/pallas/afi_rdb.py:194", "r50_n_rdb1"),
    "window_attention": ("afigan_tpu_torch/csrc/window_attention.cu",
                         "afigan_tpu/ops/pallas/window_attention.py:85", "swin"),
    "layer_norm": ("afigan_tpu_torch/csrc/layer_norm.cu",
                   "afigan_tpu/ops/pallas/layer_norm.py:49", "swin"),
    "window_gather": ("afigan_tpu_torch/csrc/window_gather.cu",
                      "afigan_tpu/ops/pallas/window_gather.py:44", "centermask_windowed"),
    "nms": ("afigan_tpu_torch/csrc/nms.cu",
            "afigan_tpu/ops/nms.py:36::nms_keep_mask (XLA code, not a Pallas kernel)", "r50"),
    "roi_pool_bwd": ("afigan_tpu_torch/csrc/roi_pool.cu",
                     "afigan_tpu/ops/roi_align.py:720::_pallas_pool_bwd_dense (XLA adjoint, "
                     "not a Pallas kernel)", "train"),
    "deform_conv": ("afigan_tpu_torch/csrc/deform_conv.cu",
                    "afigan_tpu/ops/deform_conv.py:20::deform_conv2d (XLA code, not a "
                    "Pallas kernel)", "resnest_dcn"),
    "deform_conv_bwd": ("afigan_tpu_torch/csrc/deform_conv.cu",
                        "afigan_tpu/ops/deform_conv.py:20::deform_conv2d (its VJP by XLA "
                        "autodiff, not a Pallas kernel)", "train_dcn"),
}

# max|kernel - plain| <= rel * max|plain| + abs
TOL = {
    ("gen", "float32"): (1e-4, 1e-5),
    # intermediates round to bf16 between the 16+3 chained convs, in a
    # different order in the kernel (fp32 accumulation) and in cuDNN
    ("gen", "bfloat16"): (3e-2, 0.0),
    ("pool", "float32"): (1e-4, 1e-5),
    ("pool", "bfloat16"): (1e-2, 0.0),
    # both versions compute in float32 and round once to bf16: they differ by
    # one bf16 step (2^-8 relative) where the float32 values straddle a
    # rounding boundary
    ("ln", "float32"): (1e-4, 1e-5),
    ("ln", "bfloat16"): (1e-2, 0.0),
    # the probabilities round to bf16 in both versions (2^-9 relative each,
    # averaging out over the 144-term sum), then the output rounds once
    ("attn", "float32"): (1e-4, 1e-5),
    ("attn", "bfloat16"): (1e-2, 0.0),
    # a copy has no tolerance
    ("copy", "float32"): (0.0, 0.0),
    ("copy", "bfloat16"): (0.0, 0.0),
    # the deformable conv's columns: the kernel does the plain gather's float32
    # arithmetic in its order with no contraction (__f*_rn), so no tolerance
    ("dcn_fwd", "float32"): (0.0, 0.0),
    ("dcn_fwd", "bfloat16"): (0.0, 0.0),
    # its adjoint (float32 out, whatever x's type): x's gradient sums up to
    # 36 terms an entry in atomics' order, the offsets' and the mask's sum
    # over the channels in a warp's order, against torch's index_add_ / sum
    ("dcn_bwd", "float32"): (1e-4, 0.0),
    ("dcn_bwd", "bfloat16"): (1e-4, 0.0),
}
# one bfloat16 launch of the generator against the float32 plain conv on the
# same bf16 values: the kernel accumulates in float32 and rounds once, so
# |k - ref| <= 2^-8 |ref| (bf16's unit roundoff), elementwise, plus 1e-4
# max|ref| for the float32 summation order
STAGE_REL, STAGE_ABS = 2.0 ** -8, 1e-4
# the test-time pixel std of tests/test_golden_regression.py: random weights
# then give non-degenerate class scores
GOLDEN_PIXEL_STD = [57.375, 57.12, 58.395]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, and operations/s by the type of the kernel's inputs
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
ELT = {"bfloat16": 2, "float32": 4}
DTYPES = ("float32", "bfloat16")

# both BiFPN models pad the 832x1344 bucket to the pyramid's 128
R50_CANVAS, SWIN_CANVAS = (832, 1344), (896, 1408)
SIZES = [(800, 1333), (800, 1067)]
# path → (pyramid channels, generator inputs (H, W) per batch and how often
# each is called)
GEN_LEVELS = {"r50": (256, [((26, 42), 1), ((52, 84), 1), ((104, 168), 1)]),
              "swin": (256, [((7, 11), 7), ((14, 22), 7), ((28, 44), 7), ((56, 88), 7)]),
              "centermask": (160, [((7, 11), 6), ((14, 22), 6), ((28, 44), 6),
                                   ((56, 88), 6)])}


class Tally:
    """Sums over the calls that one batch of a path makes of one kernel."""

    def __init__(self):
        self.ms = self.plain_ms = self.bytes_s = self.ops_s = self.bound_s = 0.0
        self.library_ms = None
        self.err = 0.0
        self.calls = 0

    def add(self, ms, plain_ms, nbytes, ops, dtype_name, err, count=1, library_ms=None):
        tb, to = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype_name]
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bytes_s += count * tb
        self.ops_s += count * to
        self.bound_s += count * max(tb, to)
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + count * library_ms
        self.err = max(self.err, err)
        self.calls += count

    def summary(self):
        return {"ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": 1000 * self.bound_s,
                "bound_by": "bytes" if self.bytes_s >= self.ops_s else "operations",
                "library_ms": self.library_ms, "max_abs_err": self.err,
                "calls": self.calls}


def tally(results, name, path, dtype_name) -> Tally:
    return results[name].setdefault("tallies", {}).setdefault((path, dtype_name), Tally())


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def tf32_off():
    """TF32 off for cuDNN and for matrix products (the float32 comparisons),
    both flags restored as they were after; also a phase's decorator."""
    import torch

    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def median_ms(fn, iters=10, warmup=2, inner=4):
    """Median over ``iters`` CUDA-event timings of ``inner`` calls in a row,
    per call. A call shorter than its own enqueue (Python wrapper, ctypes,
    launch: tens of microseconds) measures the enqueue, for the kernel, its
    plain version and the library call alike; the profiled batch of the
    slice phases gives such a kernel's device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / inner)
    return float(np.median(times))


def device_ms_per_call(fn, names, reps=20):
    """Device time a call of ``fn`` (ms) of the kernels whose names hold one
    of ``names``, one launch each a call: over ``reps`` calls under
    torch.profiler, each kernel's mean over the launches its trace holds (a
    trace that drops records then reads no lower), summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and any(n in e.key for n in names):
            tot, count = us.get(e.key, (0.0, 0))
            us[e.key] = (tot + e.self_device_time_total, count + e.count)
    if not us:
        raise AssertionError(f"{names}: no launch in the profiler's trace")
    return sum(tot / count for tot, count in us.values()) / 1000.0


def timed_steps(step):
    """``TRAIN_WARMUP`` + ``TRAIN_TIMED`` calls of ``step`` (a train step that
    returns its metrics): (every step's metrics, and for the timed steps the
    host-clock ms to a synchronize and the ms between CUDA events recorded
    around the step)."""
    import torch

    steps, host, events = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        steps.append(step())
        end.record()
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            host.append(1000 * (time.perf_counter() - t0))
            events.append(start.elapsed_time(end))
    return steps, host, events


def compare(name, got, want, kind, dtype_name, quiet=False):
    import torch

    got = got.float()
    want = want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    rel, ab = TOL[(kind, dtype_name)]
    bound = rel * scale + ab
    if not quiet or not err <= bound:
        log(f"  {name}: max_abs_err={err:.3e} max|plain|={scale:.3e} "
            f"rel={err / max(scale, 1e-30):.3e} bound={bound:.3e}")
    if not err <= bound:
        raise AssertionError(f"{name}: max_abs_err {err} > {bound}")
    return err


def reject(name, wrong, want, kind, dtype_name):
    """The bound of ``compare`` must fail ``wrong``, a plain output with a
    part of the computation taken out."""
    err = float((wrong.float() - want.float()).abs().max())
    rel, ab = TOL[(kind, dtype_name)]
    bound = rel * float(want.float().abs().max()) + ab
    ratio = f"{err / bound:.1f}x bound" if bound else "bound 0"
    log(f"  {name}: max_abs_err={err:.3e} = {ratio} (must exceed it)")
    if not err > bound:
        raise AssertionError(f"{name}: the bound {bound} does not reject it ({err})")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def _gen_weights(c, g, n_rdb, gen, device):
    """Generator weights at the Kaiming scale, std sqrt(2/fan_in), the
    transposed conv's fan-in that of one output phase (9C). The model's own
    init is 0.1x that, where the bilinear skip of x swamps the convs in the
    output and a wrong conv could pass the end-to-end bound."""
    import torch

    def w(*shape, fan_in):
        return (torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5).to(device)

    def b(n):
        return (torch.randn((n,), generator=gen) * 0.01).to(device)

    head = (w(c, c, 3, 3, fan_in=9 * c), b(c))
    rdbs = [[w(g if i < 4 else c, c + i * g, 3, 3, fan_in=9 * (c + i * g))
             for i in range(5)] for _ in range(n_rdb)]
    mid = (w(c, c, 3, 3, fan_in=9 * c), b(c))
    up = (w(c, c, 6, 6, fan_in=9 * c), b(c))
    tail = (w(c, c, 3, 3, fan_in=9 * c), b(c))
    return head, rdbs, mid, up, tail


def check_launches(x, head, rdbs, mid, up, tail):
    """bf16: each of the generator's 19 kernel launches, on its own inputs,
    against the float32 plain version of that one conv on the same bf16
    values, at one rounding of the output (STAGE_REL, STAGE_ABS). The chain
    runs through the port's own wiring (``_chain``) with this checked conv in
    place of ``conv3x3``. Returns (worst error / bound, at which launch)."""
    import torch

    from afigan_tpu_torch.ops.kernels import afi_generator as ag

    def f32(t):  # the values the kernel reads, in float32
        return None if t is None else t.to(torch.bfloat16).float()

    worst = [0.0, ""]
    n = [0]

    def check(k, ref):
        n[0] += 1
        err = (k.float() - ref).abs()
        ratio = float((err / (STAGE_REL * ref.abs() + STAGE_ABS * ref.abs().max())).max())
        if not ratio <= 1.0:
            raise AssertionError(f"launch {n[0]} of 19: |k-ref| up to {ratio:.2f}x "
                                 "the one-rounding bound")
        if ratio > worst[0]:
            worst[:] = [ratio, f"launch {n[0]}"]
        return k

    def conv(srcs, w, b=None, leaky=False, res1=None, s1=1.0, res2=None, s2=1.0,
             skip=None):
        k = ag.conv3x3(srcs, w, b, leaky, res1, s1, res2, s2, skip)
        return check(k, ag.conv3x3_plain([f32(s) for s in srcs], f32(w), f32(b), leaky,
                                         f32(res1), s1, f32(res2), s2, f32(skip)))

    r = ag._chain(conv, x, *head, rdbs, 0.2)
    y = conv([r], *mid, leaky=True)
    z = check(ag.subpixel_deconv(y, *up),
              ag.subpixel_deconv_plain(f32(y), f32(up[0]), f32(up[1])))
    conv([z], *tail, skip=x)
    return worst


def _boxes(n_img, n, canvas_hw, gen, device):
    """Random xyxy boxes over the canvas: a spread of scales, aspect ratios
    up to 8:1, some crossing the border."""
    import torch

    h, w = canvas_hw
    ctr = torch.rand((n_img, n, 2), generator=gen) * torch.tensor([w, h])
    scale = torch.exp(torch.rand((n_img, n), generator=gen) * np.log(600 / 8)) * 8
    ar = torch.exp((torch.rand((n_img, n), generator=gen) * 2 - 1) * np.log(8))
    bw, bh = scale * ar.sqrt(), scale / ar.sqrt()
    bx = torch.stack([ctr[..., 0] - bw / 2, ctr[..., 1] - bh / 2,
                      ctr[..., 0] + bw / 2, ctr[..., 1] + bh / 2], -1)
    return bx.to(device)


def _chain_work(b, h, w, c, g, n_rdb, elt):
    """(bytes, operations) of the generator chain as one function: x and the
    weights read once, r written once; two operations per multiply-add."""
    cc = c * c + n_rdb * (sum((c + i * g) * g for i in range(4)) + (c + 4 * g) * c)
    px = b * h * w
    return elt * (2 * px * c + 9 * cc), 2 * 9 * px * cc


def _upsample_work(b, h, w, c, elt):
    """mid conv + transposed conv (4 phases of 9 taps) + tail conv at 2H x 2W;
    r and x read, the 2H x 2W output written."""
    px = b * h * w
    return elt * (2 * px * c + 4 * px * c + (9 + 36 + 9) * c * c), 2 * 9 * (1 + 4 + 4) * px * c * c


def kernels_generator(results):
    """afi_chain and afi_upsample at the generator's shapes on the three
    paths (256 and 160 channels), and afi_rdb (one dense block) at the R-50
    path's."""
    import torch

    from afigan_tpu_torch.ops.kernels import afi_generator as ag

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, G = 2, 32
    weights = {c: _gen_weights(c, G, 3, gen, dev) for c in (256, 160)}
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        elt = ELT[dtype_name]
        for path, (C, levels) in GEN_LEVELS.items():
            if path == "swin" and dtype_name == "float32":
                continue  # the Swin slice runs in bf16; fp32 is timed at the R-50 shapes
            head, rdbs, mid, up, tail = weights[C]
            up_args = (*mid, *up, *tail)
            # as the module calls the wrappers: the weights laid out ahead
            # (check_launches below goes through the wrappers' own layout)
            laid = ag.lay_out_generator(*head, rdbs, *up_args, dt)
            for (h, w), count in levels:
                x = torch.randn((B, h, w, C), generator=gen).to(dev, dt)
                tag = f"{dtype_name} {path} C={C} {h}x{w}"
                chain_k = lambda: ag.fused_generator_chain(x, *head, rdbs, 0.2, laid=laid)  # noqa: E731
                chain_p = lambda: ag.fused_generator_chain_plain(x, *head, rdbs, 0.2)  # noqa: E731
                r_k, r_p = chain_k(), chain_p()
                torch.cuda.synchronize()
                e1 = compare(f"afi_chain {tag}", r_k, r_p, "gen", dtype_name)
                # the one-call route launches what the wiring over single
                # launches does: the same numbers, bit for bit
                if not torch.equal(r_k, ag._chain(ag.conv3x3, x, *head, rdbs, 0.2)):
                    raise AssertionError(f"afi_chain {tag}: one call != 16 single launches")
                up_k = lambda: ag.fused_upsample(r_p, x, *up_args, laid=laid.upsample())  # noqa: E731
                up_p = lambda: ag.fused_upsample_plain(r_p, x, *up_args)  # noqa: E731
                u_k, u_p = up_k(), up_p()
                torch.cuda.synchronize()
                e2 = compare(f"afi_upsample {tag}", u_k, u_p, "gen", dtype_name)
                z = ag.subpixel_deconv(ag.conv3x3([r_p], *mid, leaky=True), *up)
                if not torch.equal(u_k, ag.conv3x3([z], *tail, skip=x)):
                    raise AssertionError(f"afi_upsample {tag}: one call != 3 single launches")
                del z
                if dtype_name == "bfloat16":
                    no_rdb = [[*ws[:4], torch.zeros_like(ws[4])] for ws in rdbs]
                    reject(f"afi_chain plain without its dense blocks {tag}",
                           ag.fused_generator_chain_plain(x, *head, no_rdb, 0.2), r_p,
                           "gen", dtype_name)
                    reject(f"afi_upsample plain with a zero deconv {tag}",
                           ag.fused_upsample_plain(r_p, x, *mid, torch.zeros_like(up[0]),
                                                   torch.zeros_like(up[1]), *tail), u_p,
                           "gen", dtype_name)
                    ratio, where = check_launches(x, head, rdbs, mid, up, tail)
                    log(f"  afi launches {tag}: all 19 within one rounding, "
                        f"worst {ratio:.3f}x the bound ({where})")
                t = [median_ms(chain_p), median_ms(chain_k), median_ms(up_p), median_ms(up_k)]
                log(f"  {tag}: chain kernel {t[1]:.3f} ms plain {t[0]:.3f} ms; "
                    f"upsample kernel {t[3]:.3f} ms plain {t[2]:.3f} ms")
                tally(results, "afi_chain", path, dtype_name).add(
                    t[1], t[0], *_chain_work(B, h, w, C, G, 3, elt), dtype_name, e1, count)
                tally(results, "afi_upsample", path, dtype_name).add(
                    t[3], t[2], *_upsample_work(B, h, w, C, elt), dtype_name, e2, count)
                if path != "r50":
                    continue
                # one dense block at the same inputs: the N_RDB 1 generator's kernel
                ws = rdbs[0]
                rdb_k = lambda: ag.fused_rdb(x, ws, 0.2, laid=laid.rdbs[0])  # noqa: E731
                rdb_p = lambda: ag.fused_rdb_plain(x, ws, 0.2)  # noqa: E731
                o_k, o_p = rdb_k(), rdb_p()
                torch.cuda.synchronize()
                e3 = compare(f"afi_rdb {tag}", o_k, o_p, "gen", dtype_name)
                if not torch.equal(o_k, ag._rdb(ag.conv3x3, x, ws, 0.2)):
                    raise AssertionError(f"afi_rdb {tag}: one call != 5 single launches")
                if dtype_name == "bfloat16":
                    reject(f"afi_rdb plain without its last conv {tag}",
                           ag.fused_rdb_plain(x, [*ws[:4], torch.zeros_like(ws[4])], 0.2),
                           o_p, "gen", dtype_name)
                tk, tp = median_ms(rdb_k), median_ms(rdb_p)
                log(f"  {tag}: rdb kernel {tk:.3f} ms plain {tp:.3f} ms")
                nb, ops = _chain_work(B, h, w, C, G, 1, elt)
                cc = 9 * C * C  # _chain_work counts a head conv; the block has none
                tally(results, "afi_rdb", "r50_n_rdb1", dtype_name).add(
                    tk, tp, nb - elt * cc, ops - 2 * B * h * w * cc, dtype_name, e3, count)
    # the N_RDB 1 generator end to end, kernels against plain versions
    from afigan_tpu_torch.models.afi import AFIGenerator

    C = 256
    g1 = AFIGenerator(C, 1, G, device=dev)
    g1.init_weights(torch.Generator().manual_seed(1))
    for m in g1.modules():  # Kaiming scale, as _gen_weights
        if hasattr(m, "weight"):
            m.weight.data *= 10.0
    x = torch.randn((B, 52, 84, C), generator=gen)
    with torch.inference_mode():
        got = g1(x.to(dev))
        want = g1.cpu()(x)
    compare("AFIGenerator N_RDB 1 float32, card vs CPU", got.cpu(), want, "gen", "float32")


PORT_KERNELS = ("afi::", "roi_pool_kernel", "layer_norm_kernel", "window_attention_",
                "window_gather_kernel", "nms_cluster_kernel", "roi_pool_bwd_kernel",
                "deform_im2col_kernel", "deform_col2im_kernel")


def device_kernels(counts):
    """The device kernels that the wrappers' launch counts stand for: one
    each."""
    return sum(counts.values())


def device_events(fn, expected, record_shapes=False, tries=3):
    """One call of ``fn`` under torch.profiler: (the profile, its device
    kernels as [(name, microseconds, count)], the sessions taken, whether the
    trace is whole). The profiler's device tracing now and then loses records:
    a session comes back with no device event, or with part of the call's
    kernels (9 of a generator call's 19 were seen), while the call's results
    are right. ``fn`` makes ``expected`` launches of the port's kernels, each
    one device kernel; a trace that holds another number of them is a failed
    reading, not a result, and the session is taken again, ``tries`` times at
    most. Where none is whole the callers say that the device time was not
    measured and keep to the checks that need no trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        held = sum(k[2] for k in kernels if any(name in k[0] for name in PORT_KERNELS))
        if held == expected:
            return prof, kernels, i + 1, True
        log(f"  profiler session {i + 1} of {tries}: the trace holds {held} of the call's "
            f"{expected} launches of the port's kernels")
    return prof, kernels, tries, False


# ATen operators that launch nothing on the device: allocations and views
ATEN_NO_KERNEL = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "view",
    "_unsafe_view", "_reshape_alias", "as_strided", "permute", "transpose", "t", "slice",
    "select", "narrow", "expand", "squeeze", "unsqueeze", "unbind", "split",
    "split_with_sizes", "alias", "detach", "unflatten", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset"))


def aten_launches(fn):
    """One call of ``fn`` with every ATen operator it dispatches recorded on
    the host: the names of those that run a kernel or a copy on the device
    (every operator but an allocation or a view). It needs no device trace,
    so it holds where the profiler's session came back empty."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            import torch

            name = func.overloadpacket.__name__
            out = func(*args, **(kwargs or {}))
            if name in ATEN_NO_KERNEL:
                return out
            # reshape, flatten, contiguous, to: a view of an argument's
            # storage where nothing had to move, else a copy
            if isinstance(out, torch.Tensor) and not name.endswith("_"):
                at = out.untyped_storage().data_ptr()
                if any(isinstance(a, torch.Tensor) and a.untyped_storage().data_ptr() == at
                       for a in args):
                    return out
            seen.append(name)
            return out

    with Record():
        fn()
    return seen


def generator_levels(strict=True):
    """bf16: one call of the ``AFIGenerator`` module (its weights laid out
    ahead) per pyramid level of each path, under the profiler: the device
    time of its kernels, and by events the time of a call. With ``strict``
    the call must be the 19 launches of the conv kernel and nothing else, no
    layout kernel between them: by the wrappers' launch counts and the ATen
    operators the call dispatches, and by the device trace wherever the
    profiler gave one."""
    import torch

    from afigan_tpu_torch.models.afi import AFIGenerator
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(6)
    for C in (256, 160):
        g = AFIGenerator(C, 3, 32, device=dev)
        g.init_weights(torch.Generator().manual_seed(1))
        for path, (c, levels) in GEN_LEVELS.items():
            if c != C:
                continue
            for (h, w), _ in levels:
                x = torch.randn((2, h, w, C), generator=gen).to(dev, torch.bfloat16)
                with torch.inference_mode():
                    call = lambda: g(x)  # noqa: E731
                    call()
                    reset_launches()
                    aten = aten_launches(call)
                    counts = {k: v for k, v in LAUNCHES.items() if v}
                    _, kernels, _, whole = device_events(call, 19)
                    ms = median_ms(call)
                conv = [k for k in kernels if "afi::conv3x3_bf16_" in k[0]]  # mma.sync and wgmma
                other = [k for k in kernels if k not in conv]
                traced = (f"device {sum(k[1] for k in kernels) / 1000:.3f} ms "
                          f"({sum(k[2] for k in conv)} conv launches "
                          f"{sum(k[1] for k in conv) / 1000:.3f} ms, {sum(k[2] for k in other)} "
                          f"other kernels {sum(k[1] for k in other) / 1000:.3f} ms)"
                          if whole else "device time not measured (no whole device trace)")
                log(f"  generator level {path} C={C} {h}x{w}: {traced}; wrappers' launches "
                    f"{counts}, {len(aten)} ATen kernels; a call by events {ms:.3f} ms")
                # a trace that lost records still must show no other kernel
                if strict and (counts != {"afi_chain": 16, "afi_upsample": 3} or aten or other):
                    raise AssertionError(
                        f"generator call at {h}x{w}: expected 16 + 3 conv launches and no other "
                        f"kernel, got {counts}, ATen kernels {aten}, device trace {kernels}")


def _pool_work(feats, b, n, p, s):
    """(bytes, operations) of one pooler call over b x n ROIs: 4 corner
    reads per sample, but no more than the maps themselves; the float32
    output; the boxes and levels; 8 float32 operations per sample and
    channel (4 taps, a multiply-add each)."""
    c = feats[0].shape[-1]
    samples = b * n * p * p * s * s
    read = min(4 * samples * c, sum(f.numel() for f in feats)) * feats[0].element_size()
    return read + b * n * p * p * c * 4 + b * n * 20, 2 * 4 * samples * c


class BoundCapture:
    """While entered, adds up the least time the card could take for every
    pooler and NMS launch the code makes, from the launch's own inputs
    (``_pool_work``, ``_nms_work``): bytes over 3.35 TB/s against float32
    operations over 67 TFLOP/s, the larger. ``ms`` maps kernel → (bound ms,
    launches)."""

    def __init__(self):
        self.ms = {"roi_pool": [0.0, 0], "nms": [0.0, 0]}
        self.walk = [0, 0.0, True]  # NMS tiles walked, their floor (ms), all steps measured

    def _add(self, name, nbytes, ops):
        self.ms[name][0] += 1000 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"])
        self.ms[name][1] += 1

    def __enter__(self):
        from afigan_tpu_torch.ops import nms
        from afigan_tpu_torch.ops.kernels import roi_pool

        self._saved = (roi_pool.roi_pool, nms.nms_keep_sorted)
        pool, keep_sorted = self._saved

        def pool_bound(features, boxes, levels, strides, output_size, sampling_ratio, *a, **k):
            self._add("roi_pool", *_pool_work(features, boxes.shape[0], boxes.shape[1],
                                              output_size, sampling_ratio))
            return pool(features, boxes, levels, strides, output_size, sampling_ratio, *a, **k)

        def nms_bound(boxes, valid, order, *a, **k):
            keep = keep_sorted(boxes, valid, order, *a, **k)
            stop = a[1] if len(a) > 1 else k.get("stop_after", 0)
            step = WALK_STEP_MS.get(nms_plan(boxes.shape[1])[0])
            nbytes = ops = 0
            for i in range(boxes.shape[0]):
                w = _nms_work(valid[i][order[i]], keep[i], boxes.shape[1])
                nbytes, ops = nbytes + w[0], ops + w[1]
                tiles = walked_tiles(valid[i][order[i]], keep[i], stop)
                self.walk[0] += tiles
                self.walk[1] += tiles * (step or 0.0)
                self.walk[2] &= step is not None
            self._add("nms", nbytes, ops)
            return keep

        roi_pool.roi_pool, nms.nms_keep_sorted = pool_bound, nms_bound
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.ops import nms
        from afigan_tpu_torch.ops.kernels import roi_pool

        roi_pool.roi_pool, nms.nms_keep_sorted = self._saved

    def log(self, what):
        tiles, floor, whole = self.walk
        log(f"  {what}: bound of its launches (their own inputs) " + ", ".join(
            f"{k} {ms:.4f} ms over {n} launches" for k, (ms, n) in self.ms.items())
            + f"; the NMS walks {tiles} tiles, floor " + (f"{floor:.4f} ms" if whole else
                                                         "not measured (no step measured "
                                                         "at one of its cluster sizes)"))


def kernels_roi_pool(results):
    import torch

    from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool, roi_pool_plain
    from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    B, S = 2, 2
    # (path, canvas, strides, channels, P, ROIs per image, calls per batch)
    cases = [("r50", R50_CANVAS, (4, 8, 16, 32), 256, 7, 1000, 1),
             ("r50", R50_CANVAS, (4, 8, 16, 32), 256, 14, 100, 1),
             (None, R50_CANVAS, (4, 8, 16, 32), 160, 7, 100, 0),
             ("swin", SWIN_CANVAS, (8, 16, 32, 64), 256, 7, 1000, 3),
             ("centermask", SWIN_CANVAS, (8, 16, 32), 160, 14, 100, 1)]
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        for path, canvas, strides, c, p, n, count in cases:
            feats = [torch.randn((B, canvas[0] // s, canvas[1] // s, c),
                                 generator=gen).to(dev, dt) for s in strides]
            boxes = _boxes(B, n, canvas, gen, dev)
            lo = int(np.log2(strides[0]))
            lv = assign_boxes_to_levels(boxes, lo, lo + len(strides) - 1)
            fk = lambda: roi_pool(feats, boxes, lv, strides, p, S, True)  # noqa: E731
            fp = lambda: roi_pool_plain(feats, boxes, lv, strides, p, S, True)  # noqa: E731
            o_k, o_p = fk(), fp()
            torch.cuda.synchronize()
            tag = f"{dtype_name} {path or 'extra'} C={c} P={p} N={B}x{n}"
            e = compare(f"roi_pool {tag}", o_k, o_p, "pool", dtype_name)
            tk, tp = median_ms(fk), median_ms(fp)
            log(f"  roi_pool {tag}: kernel {tk:.3f} ms plain {tp:.3f} ms")
            if path is None:
                continue
            tally(results, "roi_pool", path, dtype_name).add(
                tk, tp, *_pool_work(feats, B, n, p, S), "float32", e, count)


def bwd_without_atomics(build):
    """The pool's backward gathers: no global atomic or reduction (``ATOMG``,
    ``RED``) in the SASS of any instance of its kernel."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.lib_path("roi_pool"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = [f for f in sass.split("Function : ")[1:]
             if "roi_pool_bwd_kernel" in f.split("\n", 1)[0]]
    ops = [ln.strip() for f in funcs for ln in f.splitlines()
           if " RED" in ln or "ATOMG" in ln or "ATOM." in ln]
    log(f"  roi_pool_bwd_kernel: {len(funcs)} instances, {len(ops)} global atomics in SASS")
    if not funcs or ops:
        raise AssertionError(f"roi_pool_bwd_kernel SASS: {len(funcs)} instances, {ops[:3]}")


def check_pool_backward(results, path, tag, feats, boxes, lv, grad, strides, p, dtype_name,
                        count=1):
    """One call of the pool's backward against ``torch.autograd.grad``
    through the plain gather (summed in float32): the error, the same bits on
    a second run, the bound's rejection of the plain gradient without one ROI,
    the time by events of the kernel and the plain version, and the tally of
    ``path``. On ``synthetic`` boxes the ROI left out is image 0's smallest
    (its samples pile onto the fewest taps), and the bound must fail it. On
    the train step's ROIs (``path`` ``train``) six candidates are left out in
    turn, the smallest ROI with a gradient and the five with the largest
    gradient over the fewest pixels of their level: each is logged with its
    error over the bound, and over a bound taken from its level's largest
    entry alone; the bound must fail the largest. The bound is relative to
    the largest entry of all levels, so a ROI whose own gradient lies far
    below it can pass (PERF.md, section 7).
    Its device time is read in phase ``train``'s profiled step: no profiler
    session here (a process whose profiler started before the other kernel
    checks lost records in every later short session on the card, the
    generator levels' included)."""
    import torch

    from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool_backward, roi_pool_backward_plain

    args = (feats, boxes, lv, grad, strides, p, 2, True)
    fk = lambda: roi_pool_backward(*args)  # noqa: E731
    fp = lambda: roi_pool_backward_plain(*args)  # noqa: E731

    def flat(gs):
        return torch.cat([g.float().flatten() for g in gs])

    got, want = fk(), fp()
    again = fk()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    g_k, g_p = flat(got), flat(want)
    e = compare(f"roi_pool_bwd {tag}", g_k, g_p, "pool", dtype_name)
    if not same:
        raise AssertionError(f"roi_pool_bwd {tag}: two runs differ in their bits")
    area = ((boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])).clamp(min=1)

    def without(k):  # the plain gradient without ROI k (of the flattened batch)
        left_out = grad.clone()
        left_out.view(-1, *grad.shape[2:])[k] = 0.0
        return roi_pool_backward_plain(feats, boxes, lv, left_out, strides, p)

    def name(k):
        img, roi = divmod(k, grad.shape[1])
        return f"roi_pool_bwd {tag} without ROI {roi} of image {img}"

    if path == "synthetic":
        drop = int(area[0].argmin())
    else:
        rel, ab = TOL[("pool", dtype_name)]
        peak = grad.abs().flatten(2).amax(-1)
        scale = torch.tensor([1.0 / s for s in strides], device=boxes.device)[lv]
        score = (peak / (area * scale * scale).clamp(min=1)).flatten()
        small = int(torch.where(peak.flatten() > 0, area.flatten(),
                                torch.full_like(score, float("inf"))).argmin())
        cands = list(dict.fromkeys([small] + score.topk(min(5, score.numel())).indices.tolist()))

        def over(got_, want_):  # max |got - want| over the bound from want's largest entry
            err, bound = float((got_ - want_).abs().max()), rel * float(want_.abs().max()) + ab
            return err / bound if bound > 0 else (float("inf") if err > 0 else 0.0)

        worst, drop = -1.0, None
        for k in cands:
            short = without(k)
            r_all = over(flat(short), g_p)
            r_lvl = max(over(a.float(), b.float()) for a, b in zip(short, want))
            level = int(math.log2(strides[int(lv.flatten()[k])]))
            log(f"  {name(k)} ({float(area.flatten()[k]):.0f} px^2 at p{level}"
                f"{', the smallest' if k == small else ''}): {r_all:.2f}x the bound, "
                f"{r_lvl:.2f}x a bound from its level's largest entry")
            if r_all > worst:
                worst, drop = r_all, k
    reject(name(drop), flat(without(drop)), g_p, "pool", dtype_name)
    tk, tp = median_ms(fk), median_ms(fp, iters=3, warmup=1, inner=1)
    log(f"  roi_pool_bwd {tag}: kernel {tk:.3f} ms plain {tp:.3f} ms by events; two runs "
        "the same bits")
    # g read once, the boxes and levels, each level's gradient written once;
    # a multiply-add per tap and channel of every sample
    samples = grad.shape[0] * grad.shape[1] * p * p * 2 * 2  # S * S a bin
    c = grad.shape[-1]
    nbytes = (grad.numel() * 4 + boxes.shape[0] * boxes.shape[1] * 20
              + sum(f.numel() for f in feats) * ELT[dtype_name])
    tally(results, "roi_pool_bwd", path, dtype_name).add(
        tk, tp, nbytes, 2 * 4 * samples * c, "float32", e, count)


def kernels_roi_pool_backward(results):
    """The pool's backward at the stage-3 train step's shapes, on boxes that
    are not the step's (``_boxes``' log-uniform sizes; phase ``train`` adds
    the step's own ROIs): the box pool (512 ROIs an image, P = 7) and the mask
    pool (128 an image, P = 14) over p2-p5 of the 832x1344 canvas."""
    import torch

    from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    B, strides = 2, (4, 8, 16, 32)
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        feats = [torch.randn((B, R50_CANVAS[0] // s, R50_CANVAS[1] // s, 256),
                             generator=gen).to(dev, dt) for s in strides]
        for p, n in ((7, 512), (14, 128)):
            boxes = _boxes(B, n, R50_CANVAS, gen, dev)
            lv = assign_boxes_to_levels(boxes, 2, 5)
            grad = torch.randn((B, n, p, p, 256), generator=gen).to(dev)
            check_pool_backward(results, "synthetic", f"{dtype_name} synthetic C=256 P={p} "
                                f"N={B}x{n}", feats, boxes, lv, grad, strides, p, dtype_name)
        del feats
        torch.cuda.empty_cache()


def check_train_pool_backward(results, calls, path="train", sizes=(7, 14)):
    """The pool's backward on the ROIs and gradients of one train step (its
    box and mask pools), in bf16 as the step runs it and in float32 on the
    same values: the JSON line's ``roi_pool_bwd`` entry. The step's gradient
    (a largest entry near 1e-5: the losses average over the ROIs) is scaled to
    a largest entry of 1; the backward is linear in it, and the float32 bound's
    absolute term (1e-5) would otherwise pass any answer."""
    import torch

    if sorted(c[5] for c in calls) != sorted(sizes):
        raise AssertionError(f"{path}: pool backward calls at P {[c[5] for c in calls]}")
    for feats, boxes, lv, grad, strides, p, *_ in calls:
        hist = torch.bincount(lv.flatten(), minlength=len(feats)).tolist()
        n_live = int((grad.flatten(2).abs().amax(-1) > 0).sum())
        top = float(grad.abs().max())
        log(f"  {path} step's pool P={p}: {tuple(boxes.shape[:2])} ROIs, by level {hist}, "
            f"{n_live} with a gradient, its largest entry {top:.3e}")
        grad = grad / top
        for dtype_name in DTYPES:
            dt = getattr(torch, dtype_name)
            fs = [f.detach().to(dt) for f in feats]
            check_pool_backward(results, path, f"{dtype_name} {path} step "
                                f"C={grad.shape[-1]} P={p} N={boxes.shape[0]}x{boxes.shape[1]}",
                                fs, boxes, lv, grad, strides, p, dtype_name)


def swin_stage_shapes(canvas=SWIN_CANVAS, batch=2, embed=192, depths=(2, 2, 18, 2),
                      heads=(6, 12, 24, 48), ws=12):
    """Per Swin stage at the flagship widths: (H, W, C, heads, depth, padded
    H, padded W)."""
    h, w = canvas[0] // 4, canvas[1] // 4
    out = []
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
        out.append((h, w, embed * 2 ** i, nh, depth, hp, wp))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def kernels_layer_norm(results):
    import torch
    import torch.nn.functional as F

    from afigan_tpu_torch.ops.kernels.layer_norm import (fused_layer_norm,
                                                         fused_layer_norm_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    B = 2
    stages = swin_stage_shapes()
    # (rows, C) → calls per batch: the patch norm, two per block, one per
    # output stage (stage 3 on), one per patch merging (on 4C)
    shapes = {}
    for i, (h, w, c, _, depth, _, _) in enumerate(stages):
        rows = B * h * w
        shapes[(rows, c)] = 2 * depth + 1  # + the patch norm (stage 2) or the output norm
        if i < len(stages) - 1:
            shapes[(B * ((h + 1) // 2) * ((w + 1) // 2), 4 * c)] = 1
    assert sum(shapes.values()) == 55
    extra = [(2465, 3072), (777, 192), (1001, 100)]  # odd row counts; C not a multiple of 8
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        elt = ELT[dtype_name]
        for (rows, c), count in [*shapes.items(), *[(s, 0) for s in extra]]:
            x = (torch.randn((rows, c), generator=gen) * 2.0 + 1.5).to(dev, dt)
            scale = (torch.randn((c,), generator=gen) * 0.5 + 1.0).to(dev)
            bias = torch.randn((c,), generator=gen).to(dev)
            fk = lambda: fused_layer_norm(x, scale, bias)  # noqa: E731
            fp = lambda: fused_layer_norm_plain(x, scale, bias)  # noqa: E731
            fl = lambda: F.layer_norm(x, (c,), scale.to(dt), bias.to(dt), 1e-5)  # noqa: E731
            o_k, o_p = fk(), fp()
            torch.cuda.synchronize()
            tag = f"{dtype_name} ({rows}, {c})"
            e = compare(f"layer_norm {tag}", o_k, o_p, "ln", dtype_name)
            if dtype_name == "bfloat16":
                xf = x.float()
                no_mean = (xf * torch.rsqrt(xf.var(-1, keepdim=True, unbiased=False) + 1e-5)
                           * scale + bias).to(dt)
                reject(f"layer_norm plain without the mean {tag}", no_mean, o_p, "ln",
                       dtype_name)
                o32 = fused_layer_norm(x, scale, bias, out_dtype=torch.float32)
                compare(f"layer_norm bf16 in, float32 out {tag}", o32,
                        fused_layer_norm_plain(x, scale, bias, out_dtype=torch.float32),
                        "ln", "float32")
            if not count:
                continue
            tk, tp, tl = median_ms(fk), median_ms(fp), median_ms(fl)
            log(f"  layer_norm {tag} x{count}: kernel {tk:.3f} ms plain {tp:.3f} ms "
                f"F.layer_norm {tl:.3f} ms")
            tally(results, "layer_norm", "swin", dtype_name).add(
                tk, tp, 2 * rows * c * elt + 8 * c, 8 * rows * c, "float32", e, count, tl)


def kernels_window_attention(results):
    import torch
    import torch.nn.functional as F

    from afigan_tpu_torch.models.swin import _sw_attn_mask
    from afigan_tpu_torch.ops.kernels.window_attention import (fused_window_attention,
                                                               fused_window_attention_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    B, WS, D = 2, 12, 32
    # (windows per image, heads, tokens, mask or None, calls per batch)
    cases = []
    for _, _, _, nh, depth, hp, wp in swin_stage_shapes():
        nw = (hp // WS) * (wp // WS)
        cases.append((nw, nh, WS * WS, None, depth // 2))
        cases.append((nw, nh, WS * WS, _sw_attn_mask(hp, wp, WS, WS // 2), depth // 2))
    assert sum(c[-1] for c in cases) == 24
    cases.append((35, 3, 49, None, 0))  # window 7 (Swin-T)
    cases.append((35, 3, 49, _sw_attn_mask(35, 49, 7, 3), 0))
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        elt = ELT[dtype_name]
        for nw, nh, n, mask, count in cases:
            bnw = B * nw
            # q, k, v as the Swin block passes them: views of the packed output
            # of its qkv linear, (bnw, n, 3, nh, D)
            packed = torch.randn((bnw, n, 3, nh, D), generator=gen).to(dev, dt)
            q, k, v = packed.permute(2, 0, 3, 1, 4)
            bias = torch.randn((nh, n, n), generator=gen).to(dev)
            m = None if mask is None else torch.as_tensor(mask, device=dev)
            scale = D ** -0.5
            fk = lambda: fused_window_attention(q, k, v, bias, m, scale=scale)  # noqa: E731
            fp = lambda: fused_window_attention_plain(q, k, v, bias, m, scale=scale)  # noqa: E731
            o_k, o_p = fk(), fp()
            torch.cuda.synchronize()
            tag = (f"{dtype_name} ({bnw}, {nh}, {n}, {D}) "
                   f"{'no mask' if m is None else 'mask'}")
            e = compare(f"window_attention {tag}", o_k, o_p, "attn", dtype_name)
            if not o_k.permute(0, 2, 1, 3).is_contiguous():
                raise AssertionError("window_attention: the output is not laid out "
                                     "(bnw, n, nh, D) for the projection")
            if dtype_name == "bfloat16":
                reject(f"window_attention plain without the bias {tag}",
                       fused_window_attention_plain(q, k, v, torch.zeros_like(bias), m,
                                                    scale=scale), o_p, "attn", dtype_name)
                if m is not None:
                    reject(f"window_attention plain without the mask {tag}",
                           fused_window_attention_plain(q, k, v, bias, None, scale=scale),
                           o_p, "attn", dtype_name)
            if not count:
                continue
            # the yardstick: one library call with bias (+ mask) as its attn_mask
            am = bias[None]
            if m is not None:
                am = (bias[None, None] + m[None, :, None]).expand(B, nw, nh, n, n)
                am = am.reshape(bnw, nh, n, n)
            am = am.to(dt).contiguous()
            qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
            fl = lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=am,  # noqa: E731
                                                        scale=scale)
            tk, tp, tl = median_ms(fk), median_ms(fp), median_ms(fl)
            log(f"  window_attention {tag} x{count}: kernel {tk:.3f} ms plain {tp:.3f} ms "
                f"scaled_dot_product_attention {tl:.3f} ms")
            nbytes = 4 * bnw * nh * n * D * elt + 4 * nh * n * n + (
                0 if m is None else 4 * m.numel())
            ops = bnw * nh * (4 * n * n * D + 6 * n * n)
            tally(results, "window_attention", "swin", dtype_name).add(
                tk, tp, nbytes, ops, dtype_name, e, count, tl)
            del am, qc, kc, vc


def kernels_window_gather(results):
    """window_gather against its plain version (a stack of slices), bit for
    bit, at the concatenated pyramids of the paths that run it."""
    import torch

    from afigan_tpu_torch.ops.kernels.window_gather import (check_starts, gather_windows,
                                                            gather_windows_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    B, WIN = 2, 48

    def pyramid(canvas, strides):  # (rows of the batch's concat, its width)
        hs = [max(canvas[0] // s, WIN) for s in strides]
        return B * sum(hs), max(canvas[1] // strides[0], WIN)

    # (path, (sumH, Wmax), C, window, ROIs per batch, a view at an odd offset)
    cases = [("centermask_windowed", pyramid(SWIN_CANVAS, (8, 16, 32)), 160, WIN, 200, False),
             ("r50_box_pool_shape", pyramid(R50_CANVAS, (4, 8, 16, 32)), 256, WIN, 2000, False),
             (None, (40, 33), 100, 16, 7, True)]
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        elt = ELT[dtype_name]
        for path, (sum_h, wmax), c, win, r, odd in cases:
            n = sum_h * wmax * c
            buf = torch.randn((n + 1,), generator=gen).to(dev, dt)
            concat = (buf[1:] if odd else buf[:n]).view(sum_h, wmax, c)
            rows = torch.randint(0, sum_h - win + 1, (r,), generator=gen).to(dev)
            cols = torch.randint(0, wmax - win + 1, (r,), generator=gen).to(dev)
            rows[0], cols[0] = sum_h - win, wmax - win  # the last window that fits
            ar = torch.arange(win, device=dev)
            fk = lambda: gather_windows(concat, rows, cols, win)  # noqa: E731
            fp = lambda: gather_windows_plain(concat, rows, cols, win)  # noqa: E731
            fl = lambda: concat[(rows[:, None] + ar)[:, :, None],  # noqa: E731
                                (cols[:, None] + ar)[:, None, :]]
            check_starts(concat, rows, cols, win)
            o_k, o_p = fk(), fp()
            torch.cuda.synchronize()
            tag = f"{dtype_name} ({sum_h}, {wmax}, {c}) R={r} window={win}"
            e = compare(f"window_gather {tag}", o_k, o_p, "copy", dtype_name)
            if not torch.equal(o_k, o_p) or not torch.equal(fl(), o_p):
                raise AssertionError(f"window_gather {tag}: not a bit-for-bit copy")
            reject(f"window_gather plain with column starts shifted by one {tag}",
                   gather_windows_plain(concat, rows, torch.clamp(cols - 1, min=0) + (cols == 0),
                                        win), o_p, "copy", dtype_name)
            del o_k, o_p
            if path is None:
                continue
            tk, tp, tl = median_ms(fk), median_ms(fp, iters=3, inner=1), median_ms(fl)
            # every output byte written once; of the source only the bytes
            # under some window, each read once however many windows overlap
            # there (counted from this run's starts); the two int32 starts
            under = torch.zeros((sum_h, wmax), dtype=torch.bool, device=dev)
            under[(rows[:, None] + ar)[:, :, None], (cols[:, None] + ar)[:, None, :]] = True
            written, read = r * win * win * c * elt, int(under.sum()) * c * elt
            nbytes = written + read + 8 * r
            log(f"  window_gather {tag}: kernel {tk:.3f} ms (writes {written / 1e6:.1f} MB + "
                f"distinct reads {read / 1e6:.1f} MB of a {n * elt / 1e6:.1f} MB source, "
                f"{nbytes / tk / 1e9:.2f} TB/s) plain {tp:.3f} ms indexing gather {tl:.3f} ms")
            tally(results, "window_gather", path, dtype_name).add(
                tk, tp, nbytes, 0, dtype_name, e, 1, tl)
            # yardsticks of the card's copy rate at this size: a contiguous
            # device copy of the output (reads as much as it writes) and a fill
            o_k = fk()
            dst = torch.empty_like(o_k)
            log(f"    the output's {written / 1e6:.1f} MB: contiguous copy_ "
                f"{median_ms(lambda: dst.copy_(o_k)):.3f} ms, zero_ "
                f"{median_ms(lambda: dst.zero_()):.3f} ms")
            del o_k, dst
            del buf, concat
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# NMS: the kernel against the blocked plain loop, both on the card
# ---------------------------------------------------------------------------

class NMSRoute:
    """Counts, while it is entered, the calls of ``ops/nms.py::nms_keep_mask``
    and those of its blocked plain loop on CUDA tensors; with ``plain`` it
    also routes CUDA tensors to that loop instead of ``csrc/nms.cu`` (the
    A/B switch of this script, not a setting of the package)."""

    def __init__(self, plain=False):
        self.plain = plain
        self.calls = self.plain_on_card = 0

    def __enter__(self):
        from afigan_tpu_torch.ops import nms
        from afigan_tpu_torch.ops.kernels.nms import nms_keep_sorted_plain

        self._saved = (nms.nms_keep_mask, nms.blocked_keep, nms.nms_keep_sorted)
        keep_mask, blocked, _ = self._saved

        def counted_keep_mask(*a, **k):
            self.calls += 1
            return keep_mask(*a, **k)

        def counted_blocked(boxes_s, keep, *a, **k):
            self.plain_on_card += boxes_s.is_cuda
            return blocked(boxes_s, keep, *a, **k)

        nms.nms_keep_mask, nms.blocked_keep = counted_keep_mask, counted_blocked
        if self.plain:
            nms.nms_keep_sorted = nms_keep_sorted_plain
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.ops import nms

        nms.nms_keep_mask, nms.blocked_keep, nms.nms_keep_sorted = self._saved


def check_nms(tag, got, want, upto):
    """NMS outputs equal entry for entry; ``got`` and ``want`` are (the
    padded outputs..., order, keep mask); the keep masks up to ``upto``."""
    import torch

    *outs_k, order_k, keep_k = got
    *outs_p, order_p, keep_p = want
    for i, (g, w) in enumerate([*zip(outs_k, outs_p), (order_k, order_p)]):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"nms {tag}: output {i} differs from the plain loop")
    if not torch.equal(keep_k[:upto], keep_p[:upto]):
        bad = torch.nonzero(keep_k[:upto] != keep_p[:upto]).flatten()[:8].tolist()
        raise AssertionError(f"nms {tag}: keep masks differ at sorted positions {bad}")


def _nms_work(valid_s, keep, n):
    """(bytes, operations) that one image's keep mask needs on this input,
    counted as a kernel that stores the sorted boxes' suppression words in
    device memory would move them (the row's bound keeps that definition):
    boxes, validity and order read, the keep mask written, the suppression
    words of every valid row written (from its 64-box tile on) and those of
    the kept rows read back (their tile's diagonal word and the later tiles
    up to the last valid box); 20 float32 operations an IoU, one a pair of
    a valid box and a later box."""
    import torch

    pos = torch.arange(n, device=valid_s.device)
    last = int(torch.nonzero(valid_s).max()) + 1 if bool(valid_s.any()) else 0
    words, tiles = -(-n // 64), -(-last // 64)
    vrow, krow = pos[valid_s], pos[keep]
    written = int((words - vrow // 64).sum())
    read = int(vrow.numel() + (tiles - krow // 64 - 1).clamp(min=0).sum())
    nbytes = n * (16 + 1 + 8 + 1) + 8 * (written + read)
    return nbytes, 20 * int((n - 1 - vrow).sum())


def kernels_nms(results):
    """``csrc/nms.cu`` against the blocked loop on the card at the main
    paths' sizes and the contract's corner cases: ``batched_nms_padded`` /
    ``nms_padded`` outputs and orders equal entry for entry, keep masks equal
    everywhere without ``stop_after`` and up to the ``max_out``-th kept box
    with it; a keep mask with one kept box flipped must fail that check.
    The keep-mask function timed both ways at the real sizes (RPN, FCOS and
    detection pools at inference, the training RPN and the Res5 path's one
    level), by events and its device time, beside its bound and the walk's
    floor (``nms_walk_step`` times the tiles walked)."""
    import torch

    from afigan_tpu_torch.ops import nms
    from afigan_tpu_torch.ops.kernels.nms import nms_keep_sorted, nms_keep_sorted_plain

    # by file: a ``tests`` package installed elsewhere may shadow the repo's
    spec = importlib.util.spec_from_file_location(
        "torch_port_nms_cases", Path(__file__).resolve().parent / "tests" /
        "torch_port_nms_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    CARD_CASES, nms_case = cases.CARD_CASES, cases.nms_case

    dev = torch.device("cuda")
    # real size → (path, calls per batch): RPN and detection NMS once per
    # image on the R-CNN paths, FCOS NMS once per image on CenterMask
    paths = {"rpn": [("r50", 2), ("swin", 2)], "detection": [("r50", 2), ("swin", 2)],
             "fcos": [("centermask", 2)], "rpn_train": [("train_cascade", 2)],
             "res5_train": [("train_res5", 2)]}
    for case in CARD_CASES:
        boxes, scores, valid, idxs, thr, max_out = (
            torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a
            for a in nms_case(case))

        def run():
            return (*nms.batched_nms_padded(boxes, scores, idxs, thr, max_out, valid),
                    *nms.nms_padded(boxes, scores, thr, max_out, valid),
                    *nms.nms_keep_mask(boxes, scores, thr, valid),
                    *nms.nms_keep_mask(boxes, scores, thr, valid, stop_after=max_out))

        with NMSRoute() as route:
            got = run()
        with NMSRoute(plain=True) as plain:
            want = run()
        torch.cuda.synchronize()
        if (route.calls, route.plain_on_card, plain.plain_on_card) != (4, 0, 4):
            raise AssertionError(f"nms {case}: routes ran {route.calls} calls with "
                                 f"{route.plain_on_card} and {plain.plain_on_card} plain loops")
        full_k, full_p = got[8:10], want[8:10]
        check_nms(f"{case} full", (*got[:8], *full_k), (*want[:8], *full_p), len(boxes))
        where = torch.nonzero(full_p[1]).flatten()
        upto = len(boxes) if where.numel() < max_out else int(where[max_out - 1]) + 1
        check_nms(f"{case} stop_after={max_out}", got[10:12], want[10:12], upto)
        kept = int(full_p[1].sum())
        if kept:
            flipped = full_k[1].clone()
            flipped[int(torch.nonzero(flipped)[0])] = False
            try:
                check_nms(f"{case} one kept box flipped", (*got[:8], full_k[0], flipped),
                          (*want[:8], *full_p), len(boxes))
            except AssertionError:
                pass
            else:
                raise AssertionError(f"nms {case}: a flipped keep bit passed the check")
        log(f"  nms {case}: N={len(boxes)} thr={thr} max_out={max_out}, "
            f"{int(valid.sum())} valid, {kept} kept: kernel == plain loop entry for entry "
            f"(a flipped keep bit is caught: {bool(kept)})")
        if case not in paths:
            continue
        # the keep-mask function on what batched_nms_padded hands it
        shifted = boxes + (idxs.to(boxes.dtype) * (boxes.max() + 1.0))[:, None]
        s = torch.where(valid, scores, torch.full_like(scores, -1e10))
        order = torch.sort(-s, stable=True).indices
        b3, v2, o2 = shifted[None], valid[None], order[None]
        fk = lambda: nms_keep_sorted(b3, v2, o2, thr, max_out)  # noqa: E731
        fp = lambda: nms_keep_sorted_plain(b3, v2, o2, thr, max_out)  # noqa: E731
        tk, tp = median_ms(fk), median_ms(fp, iters=5, inner=1)
        dk = device_ms_per_call(fk, ("nms_cluster_kernel",))
        keep = fk()[0]
        nbytes, ops = _nms_work(valid[order], keep, len(boxes))
        cluster, per_block, history = nms_plan(len(boxes), max_out)
        step = nms_walk_step(len(boxes))
        walked = walked_tiles(valid[order], keep, max_out)
        bound = 1000 * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"])
        log(f"  nms {case} keep mask (stop_after={max_out}): kernel {tk:.3f} ms by events, "
            f"{dk:.4f} ms on the device (a cluster of {cluster} blocks x {per_block} tiles, "
            f"history {history}), plain loop {tp:.3f} ms; "
            f"{nbytes / 1e6:.2f} MB and "
            f"{ops / 1e6:.1f} M operations needed: bound {bound:.4f} ms; the walk's floor "
            f"{walked} tiles x {1000 * step:.2f} us a step = {walked * step:.4f} ms")
        for path, count in paths[case]:
            tally(results, "nms", path, "bfloat16").add(tk, tp, nbytes, ops, "float32", 0.0,
                                                          count)


def nms_plan(n, stop_after=0):
    """(blocks in the cluster, 64-box tiles a block, kept boxes of history)
    with which ``csrc/nms.cu`` walks an image of ``n`` boxes: its
    ``nms_plan``."""
    import ctypes

    from afigan_tpu_torch.ops.kernels import _build

    out = (ctypes.c_int * 3)()
    if _build.load("nms").nms_plan(n, stop_after, ctypes.addressof(out)):
        raise ValueError(f"no NMS plan for {n} boxes")
    return tuple(out)


# ms of one dependent step of the NMS walk, by cluster size (kernels_nms
# measures it at the main paths' sizes; BoundCapture reads it)
WALK_STEP_MS = {}


def nms_walk_step(n):
    """ms of one dependent step of the NMS walk over ``n`` boxes (on the
    cluster of ``nms_plan(n)``): the device time of a launch whose boxes
    are disjoint and valid one a tile (every tile walked, one box kept and
    applied a tile) less that of a launch with no valid box (the same loads
    and column words, no walk), over the tiles."""
    import torch

    from afigan_tpu_torch.ops.kernels import nms as knms

    dev = torch.device("cuda")
    i = torch.arange(n, device=dev, dtype=torch.float32)
    boxes = torch.stack([4 * i, 0 * i, 4 * i + 1, 0 * i + 1], 1)[None]
    order = torch.arange(n, device=dev)[None]
    sparse = (torch.arange(n, device=dev) % 64 == 0)[None]
    t1 = device_ms_per_call(lambda: knms.nms_keep_sorted(boxes, sparse, order, 0.5),
                            ("nms_cluster_kernel",))
    none = torch.zeros_like(sparse)
    t0 = device_ms_per_call(lambda: knms.nms_keep_sorted(boxes, none, order, 0.5),
                            ("nms_cluster_kernel",))
    step = max(t1 - t0, 0.0) / -(-n // 64)
    WALK_STEP_MS[nms_plan(n)[0]] = step
    return step


def walked_tiles(valid_s, keep, stop_after):
    """The 64-box tiles that the kernel's walk resolves for one image: up to
    the last valid box, or to the ``stop_after``-th kept box."""
    import torch

    if not bool(valid_s.any()):
        return 0
    end = int(torch.nonzero(valid_s).max()) + 1
    kept = torch.nonzero(keep).flatten()
    if stop_after > 0 and kept.numel() >= stop_after:
        end = min(end, int(kept[stop_after - 1]) + 1)
    return -(-end // 64)


# the deformable convs of one batch of the ResNeSt-101 cascade with
# DEFORM_ON_PER_STAGE [False, True, True, True] at 832x1344 (AVD: each at
# stride 1 on its block's input map): (map H, W), channels, convs a batch
DCN_SHAPES = [((208, 336), 128, 1), ((104, 168), 128, 3), ((104, 168), 256, 1),
              ((52, 84), 256, 22), ((52, 84), 512, 1), ((26, 42), 512, 2)]
DCN_OFFSETS = ("fractional", "zero", "integer")
# the kernels' contract off the path: (map H, W), channels, stride, dilation
# (padding = dilation): C not a multiple of the adjoint's 16-channel chunk
# (``CHUNK`` in csrc/deform_conv.cu), C % 4 != 0 (no vectors), stride 2,
# dilation 2
DCN_CONTRACT = [((26, 42), 36, 1, 1), ((26, 42), 10, 1, 1), ((52, 84), 64, 2, 1),
                ((52, 84), 64, 1, 2), ((52, 84), 64, 2, 2)]


def dcn_offsets(kind, b, h, w, gen, stride=1, dilation=1):
    """(B, Ho, Wo, 18) bf16 offsets of a 3x3 over an h x w map at ``stride``
    and ``dilation`` (padding = dilation; on the CPU, from ``gen``):
    ``fractional`` (2 N(0, 1), none an integer), ``zero``, or ``integer``:
    each sample on row -1, 0, H-1 or H (column -1, 0, W-1 or W), or with
    probability 0.4 on an interior pixel; offsets above 256 round to even
    integers in bf16, still integers."""
    import torch

    from afigan_tpu_torch.ops.kernels.deform_conv import out_size

    ho, wo = out_size(h, w, 3, 3, stride, dilation, dilation)
    shape = (b, ho, wo, 18)
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.bfloat16)
    if kind == "fractional":
        o = (2 * torch.randn(shape, generator=gen)).bfloat16()
        return torch.where(o == o.round(), o + 0.375, o)

    def land(n, size):
        border = torch.tensor([-1, 0, size - 1, size])[torch.randint(0, 4, (n,), generator=gen)]
        inner = torch.randint(1, size - 1, (n,), generator=gen)
        return torch.where(torch.rand(n, generator=gen) < 0.6, border, inner)

    n = b * ho * wo * 9
    ty = land(n, h).reshape(b, ho, wo, 3, 3)
    tx = land(n, w).reshape(b, ho, wo, 3, 3)
    taps = torch.arange(3) * dilation - dilation
    by = (torch.arange(ho)[:, None] * stride + taps)[None, :, None, :, None]
    bx = (torch.arange(wo)[:, None] * stride + taps)[None, None, :, None, :]
    return torch.stack([ty - by, tx - bx], -1).reshape(shape).bfloat16()


def _dcn_work(x, n, c, modulated, backward):
    """(bytes, float32 operations) that one launch needs: x, the offsets
    (bf16) and the mask (float32) read once; the forward writes the float32
    columns (n pixels x 9 taps x c) at 8 operations an entry (7 without the
    mask: 4 products, 3 sums, the mask's product); the backward reads the
    columns' gradient and writes x's float32 gradient, the offsets' and the
    mask's, at 32 operations an entry (22 without the mask)."""
    cols = n * 9 * c * 4
    nbytes = x.numel() * x.element_size() + n * 18 * 2 + (n * 9 * 4 if modulated else 0) + cols
    if not backward:
        return nbytes, n * 9 * c * (8 if modulated else 7)
    nbytes += x.numel() * 4 + n * 18 * 4 + (n * 9 * 4 if modulated else 0)
    return nbytes, n * 9 * c * (32 if modulated else 22)


def _dcn_bound_ms(work):
    """The least time of (bytes, float32 operations) on the card, ms."""
    return 1000 * max(work[0] / HBM_BYTES_PER_S, work[1] / PEAK_OPS_PER_S["float32"])


class SamplingWork:
    """Within the block, the deformable sampling's calls counted and the
    bound of their work summed (``_dcn_work`` of each call's own inputs):
    ``calls``, ``bound_ms``; ``line(kernels)`` holds it against the device
    time of the sampling kernel's records in a profiler's ``key_averages``."""

    def __enter__(self):
        from afigan_tpu_torch.ops.kernels import deform_conv as dc

        self.calls, self.bound_ms, orig = 0, 0.0, dc.deform_im2col
        self._orig = orig

        def record(x, offsets, mask=None, *conv, **kw):
            self.calls += 1
            n = offsets.shape[0] * offsets.shape[1] * offsets.shape[2]
            self.bound_ms += _dcn_bound_ms(_dcn_work(x, n, x.shape[-1], mask is not None,
                                                     False))
            return orig(x, offsets, mask, *conv, **kw)

        dc.deform_im2col = record
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.ops.kernels import deform_conv as dc

        dc.deform_im2col = self._orig

    def line(self, kernels):
        samp = [e for e in kernels if "deform_im2col_kernel" in e.key]
        ms = sum(e.self_device_time_total for e in samp) / 1000.0
        return (f"the sampling kernel's {sum(e.count for e in samp)} launches ({self.calls} "
                f"calls) {ms:.3f} ms on the device, bound {self.bound_ms:.3f} ms from their "
                f"own inputs: {100 * self.bound_ms / max(ms, 1e-9):.1f} % of the bound")


def _sampling_device_ms(fn, tries=2):
    """The sampling kernel's device time a call of ``fn`` (ms) under
    torch.profiler, or None where no session held a record of it."""
    for _ in range(tries):
        try:
            return device_ms_per_call(fn, ("deform_im2col_kernel",), reps=10)
        except AssertionError:
            continue
    return None


def kernels_deform_conv(results):
    """The deformable conv's two kernels against their plain versions at the
    six shapes of ``DCN_SHAPES`` (batch 2, bf16 x, the offsets a bf16 view of
    a (B, H, W, 27) tensor's first 18 channels, as the model passes them; a
    float32 sigmoid mask or none), under the three offset sets of
    ``dcn_offsets``, and at the contract's shapes off the path
    (``DCN_CONTRACT``): the columns bit for bit, the three gradients of the
    adjoint (on a random columns' gradient) within ``TOL["dcn_bwd"]``, whose
    bound must reject x's gradient taken without the mask; the share of each
    kernel's corners that fell outside their tile's window at each (the
    forward's ``im2col_spill_counts``, the adjoint's ``spill_counts``); at
    the path's shapes, modulated, the forward's device time against its bound
    under each offset set. The main path's case (modulated, fractional) timed
    by events, kernel and plain;
    the forward into ``resnest_dcn``'s tally, the backward into
    ``train_dcn``'s, each with its convs a batch."""
    import torch

    from afigan_tpu_torch.ops.kernels import deform_conv as dc
    from afigan_tpu_torch.ops.kernels.deform_conv import (deform_col2im, deform_col2im_plain,
                                                          deform_im2col, deform_im2col_plain)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    dgen = torch.Generator(device=dev).manual_seed(5)
    B = 2
    shapes = [(hw, c, count, 1, 1) for hw, c, count in DCN_SHAPES]
    shapes += [(hw, c, 0, st, dl) for hw, c, st, dl in DCN_CONTRACT]
    for (h, w), c, count, stride, dil in shapes:
        x = torch.randn((B, h, w, c), generator=gen).to(dev, torch.bfloat16)
        ho, wo = dc.out_size(h, w, 3, 3, stride, dil, dil)
        n = B * ho * wo
        conv = ((3, 3), stride, dil, dil)
        gcols = torch.randn((n, 9 * c), generator=dgen, device=dev)
        for modulated in (True, False):
            mask = (torch.sigmoid(torch.randn((B, ho, wo, 9), generator=gen)).to(dev)
                    if modulated else None)
            for kind in DCN_OFFSETS:
                pred = torch.zeros((B, ho, wo, 27), dtype=torch.bfloat16, device=dev)
                pred[..., :18] = dcn_offsets(kind, B, h, w, gen, stride, dil).to(dev)
                off = pred[..., :18]
                tag = (f"{h}x{w}x{c}" + (f" stride {stride} dilation {dil}" if count == 0
                                         else "")
                       + f" {'modulated' if modulated else 'unmodulated'} {kind}")
                fk = lambda: deform_im2col(x, off, mask, *conv)  # noqa: E731
                fp = lambda: deform_im2col_plain(x, off, mask, *conv)  # noqa: E731
                bk = lambda: deform_col2im(gcols, x, off, mask, *conv)  # noqa: E731
                bp = lambda: deform_col2im_plain(gcols, x, off, mask, *conv)  # noqa: E731
                dc.reset_im2col_spill(dev)
                e_f = compare(f"deform_conv {tag} columns", fk(), fp(), "dcn_fwd", "bfloat16",
                              quiet=True)
                f_spilled, f_corners = dc.im2col_spill_counts(dev)
                dc.reset_spill(dev)
                got = bk()
                spilled, corners = dc.spill_counts(dev)
                want = bp()
                torch.cuda.synchronize()
                e_b = 0.0
                for name, g_k, g_p in zip(("x", "offsets", "mask"), got, want):
                    if g_p is None:
                        if g_k is not None:
                            raise AssertionError(f"deform_conv_bwd {tag}: a mask gradient")
                        continue
                    e_b = max(e_b, compare(f"deform_conv_bwd {tag} grad_{name}", g_k, g_p,
                                           "dcn_bwd", "bfloat16", quiet=True))
                msg = (f"  deform_conv {tag}: columns equal bit for bit, the forward's corners "
                       f"inside the map outside their tile's window {f_spilled} of {f_corners} "
                       f"({100 * f_spilled / max(f_corners, 1):.2f} %); adjoint max_abs_err "
                       f"{e_b:.3e}, its corners outside the window {spilled} of {corners} "
                       f"({100 * spilled / max(corners, 1):.2f} %)")
                if modulated and count:  # the path's case: the forward against its bound
                    bf = _dcn_bound_ms(_dcn_work(x, n, c, True, False))
                    fd = _sampling_device_ms(fk)
                    msg += (f"; forward kernel {fd:.4f} ms on the device, bound {bf:.4f} ms: "
                            f"{100 * bf / fd:.1f} % of the bound" if fd else
                            "; forward kernel's device time not measured (no whole trace)")
                if modulated and kind == "fractional" and count:
                    # the bound must reject x's gradient with the mask left out
                    reject(f"deform_conv_bwd {tag} grad_x without the mask",
                           deform_col2im_plain(gcols, x, off, None)[0], want[0], "dcn_bwd",
                           "bfloat16")
                    tk, tp = median_ms(fk), median_ms(fp, iters=3, warmup=1, inner=1)
                    tbk, tbp = median_ms(bk), median_ms(bp, iters=3, warmup=1, inner=1)
                    wf, wb = _dcn_work(x, n, c, True, False), _dcn_work(x, n, c, True, True)
                    bb = _dcn_bound_ms(wb)
                    msg += (f"; by events forward kernel {tk:.3f} ms plain {tp:.3f} ms, "
                            f"backward kernel {tbk:.3f} ms plain {tbp:.3f} ms bound {bb:.3f} ms "
                            f"(x{count} a batch)")
                    tally(results, "deform_conv", "resnest_dcn", "bfloat16").add(
                        tk, tp, *wf, "float32", e_f, count)
                    tally(results, "deform_conv_bwd", "train_dcn", "bfloat16").add(
                        tbk, tbp, *wb, "float32", e_b, count)
                log(msg)
                del got, want, pred, off
        del x, gcols
        torch.cuda.empty_cache()


@tf32_off()
def phase_kernels(results):
    import torch

    for part in (kernels_generator, kernels_roi_pool, kernels_roi_pool_backward,
                 kernels_layer_norm, kernels_window_attention, kernels_window_gather,
                 kernels_nms, kernels_deform_conv):
        part(results)
        torch.cuda.empty_cache()
    generator_levels()


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------

def random_batch(rng, b, canvas, sizes):
    img = np.zeros((b, canvas[0], canvas[1], 3), np.uint8)
    for i, (h, w) in enumerate(sizes):
        img[i, :h, :w] = rng.randint(0, 256, size=(h, w, 3), dtype=np.uint8)
    return {"image": img, "image_sizes": np.asarray(sizes, np.int32)}


def check_outputs(dets, masks, b, d, mask_size):
    import torch

    shapes = {"boxes": (b, d, 4), "scores": (b, d), "classes": (b, d), "valid": (b, d)}
    for k, shp in shapes.items():
        t = getattr(dets, k)
        if tuple(t.shape) != shp:
            raise AssertionError(f"dets.{k} shape {tuple(t.shape)} != {shp}")
    finite = [("boxes", dets.boxes), ("scores", dets.scores)]
    if mask_size is None:
        if masks is not None:
            raise AssertionError("masks from a model without a mask head")
    else:
        if tuple(masks.shape) != (b, d, mask_size, mask_size):
            raise AssertionError(f"masks shape {tuple(masks.shape)}")
        finite.append(("masks", masks))
    if dets.keypoints is not None:
        kp = dets.keypoints.float()
        if kp.dim() != 4 or tuple(kp.shape[:2]) != (b, d) or kp.shape[-1] != 3:
            raise AssertionError(f"dets.keypoints shape {tuple(kp.shape)}")
        finite.append(("keypoints", kp))
        bx = dets.boxes.float()[:, :, None, :]
        x, y = kp[..., 0], kp[..., 1]
        inside = ((x >= bx[..., 0] - 1e-3) & (x <= bx[..., 2] + 1e-3)
                  & (y >= bx[..., 1] - 1e-3) & (y <= bx[..., 3] + 1e-3))
        if not bool(inside[dets.valid].all()):
            raise AssertionError("a keypoint outside its detection's box")
    for name, t in finite:
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"non-finite {name}")


def check_proposals(out, b, k):
    """A ProposalNetwork's ``RPNOutput``: (b, k) proposals, objectness and
    validity, finite, valid ones inside the canvas with a positive area."""
    import torch

    for name, shp in (("proposals", (b, k, 4)), ("scores", (b, k)), ("valid", (b, k))):
        if tuple(getattr(out, name).shape) != shp:
            raise AssertionError(f"{name} shape {tuple(getattr(out, name).shape)} != {shp}")
    p = out.proposals.float()[out.valid]
    if not (bool(torch.isfinite(p).all()) and bool(torch.isfinite(out.scores.float()).all())):
        raise AssertionError("non-finite proposals")
    if not bool(((p[:, 2] >= p[:, 0]) & (p[:, 3] >= p[:, 1]) & (p >= 0).all(1)).all()):
        raise AssertionError("a valid proposal with a negative side or outside the canvas")


def run_batches(name, cfg, batches, per_batch=None):
    """Build the model on the card from seed 0, run one warm-up batch, then
    time each batch alone (host clock, synchronized). The kernels' launch
    counts are set to 0 just before the model's first batch and read just
    after its last; ``per_batch`` names the counts one batch must make.
    Returns (model, valid detections per batch, counts)."""
    import torch

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    log(f"  {name}: model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, "
        f"compute dtype {model.dtype}")
    canvas = batches[0]["image"].shape[1:3]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with NMSRoute() as route:
        predict(model, batches[0])  # warm-up (cuDNN autotune, kernel load)
        torch.cuda.synchronize()
        ms, valid = [], []
        for batch in batches[1:]:
            t0 = time.perf_counter()
            out = predict(model, batch)
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - t0))
            if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork":
                check_proposals(out, 2, cfg.MODEL.RPN.POST_NMS_TOPK_TEST)
                valid.append(int(out.valid.sum()))
                continue
            dets, masks = out
            fcos = cfg.MODEL.META_ARCHITECTURE in ("FCOS", "CenterMask")
            # the Res5 heads' masks come from the res5 output at half the pool
            res5 = not fcos and cfg.MODEL.ROI_HEADS.NAME == "Res5ROIHeads"
            mask_size = 2 * (cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION // 2) if res5 else 28
            check_outputs(dets, masks, 2, cfg.MODEL.FCOS.POST_NMS_TOPK_TEST if fcos
                          else cfg.TEST.DETECTIONS_PER_IMAGE,
                          mask_size if cfg.MODEL.MASK_ON else None)
            valid.append(int(dets.valid.sum()))
    counts = dict(LAUNCHES)
    log(f"  {name}: launches in {len(batches)} batches " + json.dumps(counts)
        + f"; {route.calls} NMS calls, {route.plain_on_card} of them by the plain loop")
    for k, n in (per_batch or {}).items():
        if counts[k] != n * len(batches):
            raise AssertionError(f"{name}: {counts[k]} launches of {k} in {len(batches)} "
                                 f"batches, expected {n} per batch")
    if route.plain_on_card or counts["nms"] != route.calls:
        raise AssertionError(f"{name}: {route.calls} NMS calls, {counts['nms']} kernel "
                             f"launches, {route.plain_on_card} plain loops on the card")
    if ms:
        med = float(np.median(ms))
        log(f"  {name}: {med:.1f} ms per batch of 2 (median of {len(ms)}; min {min(ms):.1f}, "
            f"max {max(ms):.1f}), {2000 / med:.3f} images/s at the median, "
            f"{canvas[0]}x{canvas[1]} canvas, bf16; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"valid {'proposals' if cfg.MODEL.META_ARCHITECTURE == 'ProposalNetwork' else 'detections'}"
            f" per image {np.mean(valid) / 2:.1f}")
    return model, valid, counts


def run_slice(results, path, make_cfg, canvas, per_batch, n_batches):
    """One model at full width under the two traffics. The first, its config
    as is, is the path's main run: its launch counts go into the result."""
    from afigan_tpu_torch.engine.inference import predict

    rng = np.random.RandomState(0)
    batches = [random_batch(rng, 2, canvas, SIZES) for _ in range(n_batches + 1)]
    # random weights score no class above the 0.05 threshold, so every image
    # has 0 detections
    model, _, counts = run_batches(path, make_cfg(), batches, per_batch)
    with BoundCapture() as bounds:
        predict(model, batches[-1])
    bounds.log(f"{path}, one batch")
    for k, v in counts.items():
        results[k].setdefault("launches", {})[path] = v // len(batches)
        if per_batch.get(k, 0) and v <= 0:
            raise AssertionError(f"kernel {k} was not launched by the {path} path")
    profile_batch(model, batches[-1])
    del model
    # the load of a trained model: normalised pixels and no score threshold
    # fill all 100 detection slots, so detection NMS stops early and the
    # heads after it run on real boxes
    cfg = make_cfg()
    cfg.MODEL.PIXEL_STD = GOLDEN_PIXEL_STD
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.0
    model, valid, _ = run_batches(f"{path} with 100 detections per image", cfg, batches,
                                  per_batch)
    if min(valid) == 0:
        raise AssertionError("a batch without detections")
    profile_batch(model, batches[-1])
    return model, batches[-1]


# kernel launches that one batch of each path must make: the generator is 16
# chain + 3 upsample launches a call (3 calls on the FPN, 28 on the BiFPN),
# the pooler one launch a call; NMS one call per image for the proposals and
# one for the detections (FCOS: one in all)
NO_DCN = {"deform_conv": 0, "deform_conv_bwd": 0}
R50_PER_BATCH = {"afi_chain": 3 * 16, "afi_upsample": 3 * 3, "roi_pool": 2,
                 "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 0, "window_attention": 0,
                 "window_gather": 0, "nms": 4, **NO_DCN}
SWIN_PER_BATCH = {"afi_chain": 28 * 16, "afi_upsample": 28 * 3, "roi_pool": 3,
                  "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 55, "window_attention": 24,
                  "window_gather": 0, "nms": 4, **NO_DCN}
# with one dense block: the head conv + 5 dense convs a call, all launches
# of the conv kernel, counted as afi_rdb
RDB1_PER_BATCH = {"afi_chain": 0, "afi_upsample": 3 * 3, "roi_pool": 2,
                  "roi_pool_bwd": 0, "afi_rdb": 3 * 6, "layer_norm": 0, "window_attention": 0,
                  "window_gather": 0, "nms": 4, **NO_DCN}
# CenterMask: 6 BiFPN layers x 4 generator calls; one mask pool a batch. Under
# ``windowed`` the pool is one window_gather launch (the batch's ROIs in one)
# and one roi_pool launch over the 64 overflow slots per image, which runs
# whether or not a ROI overflows (fixed shapes, no device synchronisation)
CENTERMASK_PER_BATCH = {"afi_chain": 24 * 16, "afi_upsample": 24 * 3, "roi_pool": 1,
                        "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 0, "window_attention": 0,
                        "window_gather": 0, "nms": 2, **NO_DCN}
CENTERMASK_WINDOWED_PER_BATCH = dict(CENTERMASK_PER_BATCH, window_gather=1)


def phase_slice(results, n_batches=10):
    from afigan_tpu_torch.config import main_path_cfg

    run_slice(results, "r50", main_path_cfg, R50_CANVAS, R50_PER_BATCH, n_batches)
    # the configuration whose generator runs fused_rdb: one dense block
    cfg = main_path_cfg()
    cfg.MODEL.AFI.N_RDB = 1
    rng = np.random.RandomState(1)
    batches = [random_batch(rng, 2, R50_CANVAS, SIZES) for _ in range(3)]
    _, _, counts = run_batches("r50_n_rdb1", cfg, batches, RDB1_PER_BATCH)
    results["afi_rdb"].setdefault("launches", {})["r50_n_rdb1"] = counts["afi_rdb"] // 3


def phase_slice_swin(results, n_batches=10):
    from afigan_tpu_torch.config import swin_path_cfg

    model, _ = run_slice(results, "swin", swin_path_cfg, SWIN_CANVAS, SWIN_PER_BATCH, n_batches)
    check_attention_launch_path(model.backbone.bottom_up.layers[2].blocks[1].attn)


def check_attention_launch_path(attn):
    """One shifted-window attention of the model's third stage (80 windows, 24
    heads) under the profiler with shapes recorded: between the qkv linear and
    the projection nothing copies an activation. The only copies allowed are
    the linears' own casts of their float32 parameters."""
    import torch

    from afigan_tpu_torch.models.swin import _sw_attn_mask
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    dev = torch.device("cuda")
    c = attn.qkv.in_features
    x = torch.randn((80, 144, c), generator=torch.Generator().manual_seed(7)).to(
        dev, torch.bfloat16)
    mask = torch.as_tensor(_sw_attn_mask(60, 96, 12, 6), device=dev)
    with torch.inference_mode():
        attn(x, mask)
        reset_launches()
        prof, kernels, sessions, whole = device_events(lambda: attn(x, mask), 1,
                                                       record_shapes=True)
    launched = LAUNCHES["window_attention"]
    params = [list(p.shape) for p in (attn.qkv.weight, attn.qkv.bias, attn.proj.weight,
                                      attn.proj.bias)]
    copies = [(e.name, e.input_shapes[0]) for e in prof.events()
              if e.name in ("aten::copy_", "aten::clone", "aten::contiguous", "aten::_to_copy")
              and e.input_shapes and e.input_shapes[0]]
    moved = [cp for cp in copies if cp[1] not in params]
    ours = [k for k in kernels if "window_attention_bf16_kernel" in k[0]]
    log(f"  attention launch path ({x.shape[0]} windows, {attn.num_heads} heads): "
        f"{sum(k[2] for k in kernels)} device kernels, {len(copies)} copies, all of parameters "
        f"(the linears' casts); attention kernel {sum(k[1] for k in ours) / 1000:.3f} ms")
    for name, us, n in kernels:
        log(f"    {us / 1000:8.3f} ms x{n} {name[:100]}")
    if not whole:
        log("    device times not measured (no whole device trace); the copies are read from "
            "the host's operator events, the launch from the wrapper's count")
    if moved or launched != sessions:
        raise AssertionError(f"attention launch path: activation copies {moved}, {launched} "
                             f"attention launches in {sessions} calls")


def centermask_cfg(pooler_impl):
    from afigan_tpu_torch.config import centermask_path_cfg

    cfg = centermask_path_cfg()
    cfg.TPU.POOLER_IMPL = pooler_impl
    return cfg


def phase_slice_centermask(results, n_batches=10):
    import torch

    from afigan_tpu_torch.ops.roi_align import (multilevel_roi_align_pallas,
                                                multilevel_roi_align_windowed)

    run_slice(results, "centermask", lambda: centermask_cfg("pallas"), SWIN_CANVAS,
              CENTERMASK_PER_BATCH, n_batches)
    model, batch = run_slice(results, "centermask_windowed", lambda: centermask_cfg("windowed"),
                             SWIN_CANVAS, CENTERMASK_WINDOWED_PER_BATCH, n_batches)
    # the two poolers on one model and one batch's 100 detections per image:
    # direct sampling (pallas) against copy + two products (windowed)
    dev = torch.device("cuda")
    with torch.inference_mode():
        images = torch.as_tensor(batch["image"]).to(dev)
        features, dets = model.detect(images, torch.as_tensor(batch["image_sizes"]).to(dev))
        feats = [features[f] for f in model.mask_in_features]
        args = (model.mask_strides, model.mask_res, 2, True)
        # the float32 pools, before the heads' cast
        pooled = {"pallas": multilevel_roi_align_pallas(feats, dets.boxes, *args)}
        pooled["windowed"], over = multilevel_roi_align_windowed(
            feats, dets.boxes, *args, return_overflow=True)
        # a pool that is wrong by one p3 cell, which both checks must reject
        pooled["shifted"] = multilevel_roi_align_pallas(feats, dets.boxes + 8.0, *args)
        def flat(x):  # the head's input: the pool rounded to the features' dtype
            return x.reshape(-1, *x.shape[2:]).to(feats[0].dtype)

        def rms(a, b):
            return float((a - b).pow(2).mean().sqrt())

        head = model.roi_heads.mask_head
        # every class. The pools are compared through a float32 copy of the
        # head (the same weights, the same rounded pools), so that what
        # separates two pools is the pools and not the head's own bf16
        # rounding; that rounding, the bf16 head against the copy on one
        # pool, is the bound
        head32 = copy.deepcopy(head).float()
        logits = {impl: head32(flat(x).float()) for impl, x in pooled.items()}
        noise = rms(head(flat(pooled["pallas"])).float(), logits["pallas"])
        torch.cuda.synchronize()
        log(f"  pallas vs windowed: {int(dets.valid.sum())} valid detections, "
            f"{over.sum(dim=1).tolist()} per image overflow the 48-pixel window "
            "(recomputed exactly, up to 64 per image)")
        if int(over.sum(dim=1).max()) > 64:
            raise AssertionError("more overflow ROIs than slots: the poolers differ by design")
        compare("mask pool, windowed vs pallas (bf16 features)", pooled["windowed"],
                pooled["pallas"], "pool", "bfloat16")
        reject("mask pool of boxes shifted by 8 px vs pallas", pooled["shifted"],
               pooled["pallas"], "pool", "bfloat16")
        # the mask logits and not their sigmoid: the predictor's init (std
        # 0.001) keeps every probability at 0.5, where any pool would agree.
        # The two pools must move the logits by less (rms) than the head's own
        # bf16 rounding does, and a pool one cell off by more
        d_w = rms(logits["windowed"], logits["pallas"])
        d_s = rms(logits["shifted"], logits["pallas"])
        log(f"  mask logits, rms {rms(logits['pallas'], 0.0):.3e}: windowed vs pallas "
            f"{d_w:.3e}, boxes shifted by 8 px vs pallas {d_s:.3e}, bound {noise:.3e} "
            "(the bf16 head vs its float32 copy on the pallas pool)")
        if not d_w <= noise < d_s:
            raise AssertionError("mask logits: windowed must lie within the bound of pallas "
                                 "and the shifted pool outside it")
        # the pool alone, both ways, on these detections
        for impl in ("pallas", "windowed"):
            model.pooler_impl = impl
            t = median_ms(lambda: model._pool(features, dets.boxes))
            log(f"  mask pool of 2 x 100 ROIs under {impl}: {t:.3f} ms")


# ---------------------------------------------------------------------------
# NMS on the main paths: host syncs, and the kernel against the plain loop
# ---------------------------------------------------------------------------

def nms_syncs(name, model, batch, head):
    """One batch with every NMS call of the model under
    ``torch.cuda.set_sync_debug_mode("error")``: none may make the host wait
    on the card. Then one batch with the stretch from the proposal (RPN or
    FCOS) head's output to the end of the batch under "warn": every sync
    there, by the port's source line that made it, is logged (not hidden)."""
    import collections
    import traceback
    import warnings

    import torch

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models import box_head, fcos, rpn

    mods = [m for m in (rpn, box_head, fcos) if hasattr(m, "batched_nms_padded")]
    saved = {m: m.batched_nms_padded for m in mods}
    calls = [0]
    prev = torch.cuda.get_sync_debug_mode()

    def strict(fn):
        def call(*a, **k):
            calls[0] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return call

    for m in mods:
        m.batched_nms_padded = strict(saved[m])
    try:
        predict(model, batch)
        torch.cuda.synchronize()
    finally:
        for m in mods:
            m.batched_nms_padded = saved[m]
    log(f"  {name}: {calls[0]} NMS calls of one batch under sync debug mode \"error\": "
        "none synchronised with the host")

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()[:-1] if "afigan_tpu_torch" in f.filename]
        at = ours[-1] if ours else None
        sites[f"{at.filename.split('afigan_tpu_torch')[-1].lstrip('/')}:{at.lineno} "
              f"{at.line}" if at else f"{filename}:{lineno}"] += 1

    def start(*_):
        torch.cuda.set_sync_debug_mode("warn")

    hook = head.register_forward_hook(start)
    show = warnings.showwarning
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            # the capture must see a sync it is shown: a read of a device value
            start()
            control = torch.ones(1, device="cuda").item()
            torch.cuda.set_sync_debug_mode(prev)
            seen = sum(sites.values())
            sites.clear()
            predict(model, batch)
        torch.cuda.synchronize()
    finally:
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode(prev)
        hook.remove()
    # a measurement, not a gate (the gate is the "error" mode above): a
    # capture that misses the control's sync says so instead of a count
    count = sum(sites.values()) if control == 1.0 and seen == 1 else "not measured"
    log(f"  {name}: host syncs from the proposal head's output to the end of a batch "
        f"(the capture saw {seen} of the control's one .item()): {count}"
        + "".join(f"\n    {n}x afigan_tpu_torch/{where}" for where, n in sites.most_common()))


def nms_ab(name, make_cfg, canvas, per_batch, n_batches=10):
    """The kernel and the plain loop on one model, one batch after the other
    in alternating order (kernel first on even batches), ``n_batches`` each:
    medians side by side, then one layer split each."""
    import torch

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.RandomState(3)
    batches = [random_batch(rng, 2, canvas, SIZES) for _ in range(n_batches + 1)]
    model = build_model(make_cfg(), device="cuda", generator=torch.Generator().manual_seed(0))
    pg = model.proposal_generator
    head = pg.rpn_head if hasattr(pg, "rpn_head") else pg.fcos_head
    nms_syncs(name, model, batches[0], head)
    ms = {"kernel": [], "plain": []}
    for plain in (False, True):  # warm-up both
        with NMSRoute(plain):
            predict(model, batches[0])
    torch.cuda.synchronize()
    for i, batch in enumerate(batches[1:]):
        for route in (("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")):
            reset_launches()
            with NMSRoute(plain=route == "plain") as r:
                t0 = time.perf_counter()
                predict(model, batch)
                torch.cuda.synchronize()
                ms[route].append(1000 * (time.perf_counter() - t0))
            want = (0, per_batch) if route == "plain" else (per_batch, 0)
            if (LAUNCHES["nms"], r.plain_on_card) != want or r.calls != per_batch:
                raise AssertionError(f"{name} {route}: {LAUNCHES['nms']} kernel launches, "
                                     f"{r.plain_on_card} plain loops in {r.calls} NMS calls")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"  {name} A/B, {n_batches} batches of 2 each, alternating: kernel NMS "
        f"{med['kernel']:.1f} ms per batch (min {min(ms['kernel']):.1f}, max "
        f"{max(ms['kernel']):.1f}), plain NMS {med['plain']:.1f} ms (min {min(ms['plain']):.1f}, "
        f"max {max(ms['plain']):.1f}); {2000 / med['kernel']:.3f} against "
        f"{2000 / med['plain']:.3f} images/s; the kernel faster in "
        f"{sum(k < p for k, p in zip(ms['kernel'], ms['plain']))} of {n_batches} pairs")
    split = split_rcnn if hasattr(model.roi_heads, "box_predictor") else split_centermask
    for route in ("kernel", "plain"):
        log(f"  {name} layer split, {route} NMS:")
        with NMSRoute(plain=route == "plain"):
            split(model, batches[-1])
    del model
    torch.cuda.empty_cache()


def phase_nms_ab(results):
    from afigan_tpu_torch.config import main_path_cfg

    nms_ab("r50", main_path_cfg, R50_CANVAS, R50_PER_BATCH["nms"])
    nms_ab("centermask", lambda: centermask_cfg("pallas"), SWIN_CANVAS,
           CENTERMASK_PER_BATCH["nms"])


# ---------------------------------------------------------------------------
# the breadth slice: PAFPN, ResNeSt, test-time augmentation
# ---------------------------------------------------------------------------

# a cascade of 3 box stages: 3 box pools and 1 mask pool a batch; the
# pyramids call the generator 3 times (FPN and PAFPN alike)
RESNEST_PER_BATCH = dict(R50_PER_BATCH, roi_pool=4)


def phase_slice_pafpn(results, n_batches=10):
    from afigan_tpu_torch.config import cfg_from_yaml

    run_slice(results, "r50_pafpn", lambda: cfg_from_yaml(
        "inference/AFI-GAN_maskrcnn_R_50_PAFPN.yaml"), R50_CANVAS, R50_PER_BATCH, n_batches)


def phase_slice_resnest(results, n_batches=10):
    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.data import choose_bucket, required_size_divisibility

    for path, pyramid in (("resnest_fpn", "FPN"), ("resnest_pafpn", "PAFPN")):
        make = functools.partial(
            cfg_from_yaml, f"inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_{pyramid}.yaml")
        cfg = make()
        # SIZES are images resized to the YAML's MIN_SIZE_TEST / MAX_SIZE_TEST
        if (cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST) != (800, 1333):
            raise AssertionError(f"{path}: test sizes {cfg.INPUT.MIN_SIZE_TEST}, "
                                 f"{cfg.INPUT.MAX_SIZE_TEST}")
        canvas = choose_bucket(max(h for h, _ in SIZES), max(w for _, w in SIZES),
                               cfg.TPU.IMAGE_BUCKETS, required_size_divisibility(cfg))
        log(f"  {path}: depth {cfg.MODEL.RESNETS.DEPTH}, radix {cfg.MODEL.RESNETS.RADIX}, "
            f"norm {cfg.MODEL.RESNETS.NORM}, canvas {canvas[0]}x{canvas[1]}")
        run_slice(results, path, make, canvas, RESNEST_PER_BATCH, n_batches)


class HeldKernels:
    """While entered, every launch of the model's kernels (the generator's
    two one-call entries, the pooler, LayerNorm, window attention, NMS) is
    also computed by its plain version on the same inputs and the two are
    compared: the tolerances of TOL (NMS entry for entry, up to the walk's
    stop). With ``backward``, the pool's backward too (``roi_pool_bwd``):
    every level's gradient, all levels scaled by the largest entry of the
    incoming gradient, as ``check_train_pool_backward`` scales it. The
    deformable conv's sampling always (its columns bit for bit), with
    ``backward`` its adjoint too (each of its three gradients within
    ``TOL["dcn_bwd"]``). The plain calls launch nothing."""

    KINDS = {"afi_chain": "gen", "afi_upsample": "gen", "roi_pool": "pool",
             "roi_pool_bwd": "pool", "layer_norm": "ln", "window_attention": "attn",
             "window_gather": "copy", "deform_conv": "dcn_fwd"}

    def __init__(self, dtype_name, backward=False, windows=False):
        self.dtype_name = dtype_name
        self.backward = backward
        self.windows = windows  # the windowed pooler's copy (window_gather) too
        self.err = {}    # kernel → max error
        self.calls = {}  # kernel → calls compared
        # per NMS call: (boxes N, valid candidates, kept, suppressed up to the stop)
        self.nms = []

    def _held(self, name, kernel, plain, drop=()):
        def call(*a, **k):
            import torch

            got = kernel(*a, **k)
            want = plain(*a, **{n: v for n, v in k.items() if n not in drop})
            if name == "nms":
                # the walk stops at the stop_after-th kept box; the plain
                # loop leaves what follows unresolved
                stop = a[4] if len(a) > 4 else k.get("stop_after", 0)
                n = got.shape[1]
                upto = n if stop <= 0 else min(
                    n, int((got.int().cumsum(dim=1) < stop).sum(dim=1).max()) + 1)
                if not torch.equal(got[:, :upto], want[:, :upto]):
                    raise AssertionError("nms: the kernel's keep mask differs from the "
                                         "plain loop's")
                valid_s = torch.gather(a[1], 1, a[2])[:, :upto]
                self.nms.append((n, int(a[1].sum()), int(got.sum()),
                                 int((valid_s & ~got[:, :upto]).sum())))
                err = 0.0
            elif name == "window_gather":  # a copy: bit for bit (no float32 copies)
                if not torch.equal(got, want):
                    raise AssertionError("window_gather: the kernel's windows differ from "
                                         "the plain slices")
                err = 0.0
            elif name == "deform_conv_bwd":  # (grad_x, grad_offsets, grad_mask or None)
                err = max(compare(f"{name} held {i}", g, w, "dcn_bwd", self.dtype_name,
                                  quiet=True) for i, (g, w) in enumerate(zip(got, want))
                          if w is not None)
            elif name == "roi_pool_bwd":
                top = float(a[3].abs().max())
                if top > 0:
                    err = compare(f"{name} held", torch.cat([g.float().flatten() for g in got])
                                  / top, torch.cat([g.float().flatten() for g in want]) / top,
                                  "pool", self.dtype_name, quiet=True)
                else:
                    err = max(float(g.float().abs().max()) for g in got)
                    if err != 0.0:
                        raise AssertionError(f"{name}: a gradient from an incoming zero")
            else:
                err = compare(f"{name} held", got, want, self.KINDS[name], self.dtype_name,
                              quiet=True)
            self.err[name] = max(self.err.get(name, 0.0), err)
            self.calls[name] = self.calls.get(name, 0) + 1
            return got
        return call

    def __enter__(self):
        from afigan_tpu_torch.models import swin
        from afigan_tpu_torch.models.afi import generator
        from afigan_tpu_torch.ops import nms
        from afigan_tpu_torch.ops.kernels import afi_generator as ag
        from afigan_tpu_torch.ops.kernels import layer_norm, roi_pool, window_attention
        from afigan_tpu_torch.ops.kernels.nms import nms_keep_sorted_plain

        self._saved = [(generator, "fused_generator_chain"), (generator, "fused_upsample"),
                       (roi_pool, "roi_pool"), (swin, "fused_layer_norm"),
                       (swin, "fused_window_attention"), (nms, "nms_keep_sorted")]
        self._saved = [(m, n, getattr(m, n)) for m, n in self._saved]
        generator.fused_generator_chain = self._held(
            "afi_chain", ag.fused_generator_chain, ag.fused_generator_chain_plain, ("laid",))
        generator.fused_upsample = self._held("afi_upsample", ag.fused_upsample,
                                              ag.fused_upsample_plain, ("laid",))
        roi_pool.roi_pool = self._held("roi_pool", roi_pool.roi_pool, roi_pool.roi_pool_plain)
        swin.fused_layer_norm = self._held("layer_norm", layer_norm.fused_layer_norm,
                                           layer_norm.fused_layer_norm_plain)
        swin.fused_window_attention = self._held(
            "window_attention", window_attention.fused_window_attention,
            window_attention.fused_window_attention_plain)
        nms.nms_keep_sorted = self._held("nms", nms.nms_keep_sorted, nms_keep_sorted_plain)
        from afigan_tpu_torch.ops.kernels import deform_conv

        self._saved.append((deform_conv, "deform_im2col", deform_conv.deform_im2col))
        deform_conv.deform_im2col = self._held("deform_conv", deform_conv.deform_im2col,
                                               deform_conv.deform_im2col_plain)
        if self.backward:
            self._saved.append((deform_conv, "deform_col2im", deform_conv.deform_col2im))
            deform_conv.deform_col2im = self._held("deform_conv_bwd", deform_conv.deform_col2im,
                                                   deform_conv.deform_col2im_plain)
            self._saved.append((roi_pool, "roi_pool_backward", roi_pool.roi_pool_backward))
            roi_pool.roi_pool_backward = self._held("roi_pool_bwd", roi_pool.roi_pool_backward,
                                                    roi_pool.roi_pool_backward_plain)
        if self.windows:
            from afigan_tpu_torch.ops import roi_align
            from afigan_tpu_torch.ops.kernels import window_gather

            self._saved.append((roi_align, "gather_windows", roi_align.gather_windows))
            roi_align.gather_windows = self._held("window_gather", window_gather.gather_windows,
                                                  window_gather.gather_windows_plain)
        return self

    def __exit__(self, *exc):
        for m, n, f in self._saved:
            setattr(m, n, f)


class SampledROIs:
    """While entered, counts the ROIs of every ``roi_heads.sample_proposals``
    (its ``subsample_labels`` over the proposals with the ``m`` GT slots
    appended): those taken from the proposals (the detections, for
    CenterMask), of them foreground, and the appended GT."""

    def __init__(self, m):
        self.m = m
        self.det = self.fg_det = self.gt = 0

    def __enter__(self):
        import torch
        from afigan_tpu_torch.models import roi_heads

        subsample = self._saved = roi_heads.subsample_labels

        def probe(labels, *a, **k):
            idx, valid = subsample(labels, *a, **k)
            det = valid & (idx < labels.shape[-1] - self.m)
            self.det += int(det.sum())
            self.fg_det += int((det & (torch.gather(labels, -1, idx) == 1)).sum())
            self.gt += int((valid & ~det).sum())
            return idx, valid

        roi_heads.subsample_labels = probe
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.models import roi_heads

        roi_heads.subsample_labels = self._saved


def write_coco(root, n_img, hw, seed, num_classes):
    """A COCO-format set on disk: ``n_img`` random-pixel JPEGs of ``hw``,
    ``num_classes`` categories (the model's) and one 64x48 box an image of
    the first: (json path, image directory)."""
    from PIL import Image

    img_dir = Path(root) / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    h, w = hw
    images, anns = [], []
    for i in range(n_img):
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.jpg", quality=95)
        images.append({"id": i + 1, "file_name": f"{i}.jpg", "height": h, "width": w})
        x, y = float(w // 4), float(h // 4)
        anns.append({"id": i + 1, "image_id": i + 1, "category_id": 1,
                     "bbox": [x, y, 64.0, 48.0], "area": 64.0 * 48.0, "iscrowd": 0,
                     "segmentation": [[x, y, x + 64, y, x + 64, y + 48, x, y + 48]]})
    path = Path(root) / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": c + 1, "name": f"class{c}"} for c in range(num_classes)]}))
    return str(path), str(img_dir)


class TTACounts:
    """While entered, counts the TTA module's model passes (and images per
    pass), the peak memory and the synchronized host time of each canvas's
    passes, and its merge NMS calls."""

    def __init__(self):
        self.passes = []      # (canvas, images in the pass, ms)
        self.peak = {}        # canvas → peak bytes of its passes
        self.merges = 0

    def __enter__(self):
        import torch

        from afigan_tpu_torch.engine import tta

        self._saved = (tta._forward, tta.batched_nms_padded)
        forward, merge = self._saved

        def counted_forward(model, images, sizes, *a):
            canvas = tuple(images.shape[1:3])
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = forward(model, images, sizes, *a)
            torch.cuda.synchronize()
            self.peak[canvas] = max(self.peak.get(canvas, 0), torch.cuda.max_memory_allocated())
            self.passes.append((canvas, len(images), 1000 * (time.perf_counter() - t0)))
            return out

        def counted_merge(*a, **k):
            self.merges += 1
            return merge(*a, **k)

        tta._forward, tta.batched_nms_padded = counted_forward, counted_merge
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.engine import tta

        tta._forward, tta.batched_nms_padded = self._saved


# one pass of the flagship through TTA: batch 1, the Swin-BiFPN-Cascade
# launches of a forward; NMS one call for the proposals and one for the
# detections of its one image
TTA_PER_PASS = dict(SWIN_PER_BATCH, nms=2)
# the wrapper calls behind those launches (a generator call is one call of
# each of its two entries)
TTA_CALLS_PER_PASS = {"afi_chain": 28, "afi_upsample": 28, "roi_pool": 3, "layer_norm": 55,
                      "window_attention": 24, "nms": 2}
TTA_IMAGES, TTA_HW = 2, (480, 640)


def phase_tta(results):
    """The flagship YAML unchanged (Swin-L, BiFPN x7, Cascade R-CNN; 9 scales
    x flip) through the port's ``run_tta_inference`` over an on-disk COCO set
    of 2 random-pixel 480x640 images, bf16, weights from a seeded generator."""
    import torch

    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.data.coco import CocoDataset, read_image
    from afigan_tpu_torch.data.transforms import test_transform
    from afigan_tpu_torch.engine import tta
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.image_list import pad_to_canvas
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    cfg = cfg_from_yaml("inference/AFI-GAN_cascade_rcnn_swinL_BiFPN_ST_TTA.yaml")
    aug = cfg.TEST.AUG
    if not (aug.ENABLED and aug.FLIP and len(aug.MIN_SIZES) == 9):
        raise AssertionError(f"the TTA YAML: {aug}")
    json_path, img_dir = write_coco(Path("output") / "chip_smoke_tta", TTA_IMAGES, TTA_HW, 0,
                                    cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    dataset = CocoDataset(json_path, img_dir)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    log(f"  tta: Swin-L model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M params, "
        f"compute dtype {model.dtype}, TTA_BATCH {cfg.TPU.TTA_BATCH}")
    canvases = []
    for min_size in aug.MIN_SIZES:
        tf = test_transform(*TTA_HW, min_size, aug.MAX_SIZE)
        canvases.append(tta._canvas(cfg, tf.new_h, tf.new_w))
    log(f"  tta: canvases by scale {[f'{h}x{w}' for h, w in canvases]}")
    # every canvas once, so that the timed run below meets none for the first time
    with torch.inference_mode():
        for h, w in sorted(set(canvases)):
            tta._forward(model, np.zeros((1, h, w, 3), np.float32), [[h, w]])
    torch.cuda.synchronize()
    reset_launches()
    with TTACounts() as counts, NMSRoute() as route:
        t0 = time.perf_counter()
        res = tta.run_tta_inference(cfg, model, dataset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = dict(LAUNCHES)
    passes = len(counts.passes)
    log(f"  tta: {wall:.2f} s for {TTA_IMAGES} images, {wall / TTA_IMAGES:.3f} s per image; "
        f"{passes / TTA_IMAGES:.0f} passes per image, {counts.merges} merge NMS calls; "
        f"bbox AP {res['bbox']['AP']:.3f} (random weights)")
    log(f"  tta: launches in the run {json.dumps(launched)}; {route.calls} NMS calls, "
        f"{route.plain_on_card} of them by the plain loop")
    largest = max(counts.peak, key=lambda c: c[0] * c[1])
    for c in sorted(counts.peak):
        ms = [t for cv, _, t in counts.passes if cv == c]
        log(f"  tta: canvas {c[0]}x{c[1]}: {len(ms)} passes, {np.median(ms):.1f} ms a pass "
            f"(median; min {min(ms):.1f}, max {max(ms):.1f}; host clock from the images "
            f"on the host to the detections on the card, synchronized), peak memory "
            f"{counts.peak[c] / 2**30:.2f} GiB")
    if passes != 2 * len(aug.MIN_SIZES) * TTA_IMAGES or any(n != 1 for _, n, _ in counts.passes):
        raise AssertionError(f"tta: {passes} passes {counts.passes[:4]}..., expected 18 an "
                             "image of one image each")
    if counts.merges != TTA_IMAGES:
        raise AssertionError(f"tta: {counts.merges} merge NMS calls for {TTA_IMAGES} images")
    for k, n in TTA_PER_PASS.items():
        want = n * passes + (counts.merges if k == "nms" else 0)
        if launched[k] != want:
            raise AssertionError(f"tta: {launched[k]} launches of {k}, expected {n} a pass "
                                 f"x {passes} passes" + (" + the merges" if k == "nms" else ""))
        results[k].setdefault("launches", {})["tta"] = launched[k] // passes
    if route.plain_on_card or launched["nms"] != route.calls:
        raise AssertionError(f"tta: {route.calls} NMS calls, {launched['nms']} launches")
    log(f"  tta: peak memory at the largest canvas {largest[0]}x{largest[1]}: "
        f"{counts.peak[largest] / 2**30:.2f} GiB")
    # one pass at the smallest and at the largest scale, every kernel launch
    # held against its plain version
    img = read_image(dataset.records[0]["file_name"], cfg.INPUT.FORMAT)
    for min_size in (min(aug.MIN_SIZES), max(aug.MIN_SIZES)):
        resized = test_transform(*TTA_HW, min_size, aug.MAX_SIZE).apply_image(img)
        rh, rw = resized.shape[:2]
        canvas = tta._canvas(cfg, rh, rw)
        padded = pad_to_canvas(resized.astype(np.float32), canvas)
        with HeldKernels("bfloat16") as held, BoundCapture() as bounds:
            dets, _ = tta._forward(model, padded[None], [[rh, rw]])
            torch.cuda.synchronize()
        bounds.log(f"tta pass at min size {min_size}")
        check_outputs(dets, None, 1, cfg.TEST.DETECTIONS_PER_IMAGE, None)
        log(f"  tta pass at min size {min_size} ({canvas[0]}x{canvas[1]}): kernels held "
            f"against their plain versions, calls {json.dumps(held.calls)}, max errors "
            + json.dumps({k: float(f"{v:.3e}") for k, v in held.err.items()}))
        if held.calls != TTA_CALLS_PER_PASS:
            raise AssertionError(f"tta held pass: calls {held.calls}, expected "
                                 f"{TTA_CALLS_PER_PASS}")
    del model
    torch.cuda.empty_cache()


# the models' record_function ranges: their GPU spans (first to last kernel,
# idle gaps included) are not device work
# the record_function ranges of the Swin's training route (models/swin.py)
SWIN_ROUTE_RANGES = ("swin_attention", "swin_layer_norm")
RANGES = ("backbone", "afi_generator", "rpn", "roi_heads", "fcos_head", "fcos_decode",
          "fcos_losses", "mask_sample", "mask_pool", "mask_head", "guide", "generator",
          "detector", "d_step", "g_step", "deform_conv", *SWIN_ROUTE_RANGES)
# the ranges of a stage-1 and a stage-2 step (engine/stage{1,2}.py::step_tensors)
STEP_RANGES = {"stage1": ("guide", "generator", "d_step", "g_step"),
               "stage2": ("guide", "detector", "d_step", "g_step"),
               "stage2_fcos": ("guide", "detector", "d_step", "g_step"),
               "stage2_keypoint": ("guide", "detector", "d_step", "g_step")}


def profile_batch(model, batch):
    """One batch under torch.profiler (device kernel time by name and the
    device's busy share of the wall time; the trace is held against the
    wrappers' launch counts, which it leaves changed), then one batch split by layer on
    the host clock, with a synchronize at every layer boundary."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    for session in range(3):  # a trace that lost records is taken again, as in device_events
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            predict(model, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in RANGES]
        held = sum(e.count for e in kernels if any(name in e.key for name in PORT_KERNELS))
        if held == device_kernels(LAUNCHES):
            break
        log(f"  profile: session {session + 1} of 3 holds {held} of the batch's "
            f"{device_kernels(LAUNCHES)} launches of the port's kernels"
            + ("; device busy below is short of the truth" if session == 2 else ""))
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0
    log(f"  profile: wall {1000 * wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (1000 * wall):.1f} % of wall)")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(top):  # the 14 largest, and every kernel of the port
        if i < 14 or any(name in e.key for name in PORT_KERNELS):
            log(f"  kernel {e.self_device_time_total / 1000:9.3f} ms x{e.count:<5d} "
                f"{e.key[:90]}")

    if model.roi_heads is None:
        split_proposals(model, batch)
    elif hasattr(model.roi_heads, "box_predictor"):
        split_rcnn(model, batch)
    else:
        split_centermask(model, batch)


def layer_marks(model, batch, mods, methods=()):
    """One batch with a synchronize and a host time stamp before and after
    every module of ``mods`` (and every call of the model's ``methods``):
    [("start", t), ("name<", t), ("name>", t), ..., ("end", t)]."""
    import torch

    from afigan_tpu_torch.engine.inference import predict

    marks = []

    def mark(name):
        def hook(*_):
            torch.cuda.synchronize()
            marks.append((name, time.perf_counter()))
        return hook

    handles = [h for n, m in mods.items() for h in (
        m.register_forward_pre_hook(mark(n + "<")), m.register_forward_hook(mark(n + ">")))]
    for name in methods:
        def timed(*a, _orig=getattr(model, name), _name=name, **kw):
            mark(_name + "<")()
            out = _orig(*a, **kw)
            mark(_name + ">")()
            return out
        setattr(model, name, timed)
    mark("start")()
    predict(model, batch)
    mark("end")()
    for h in handles:
        h.remove()
    for name in methods:
        delattr(model, name)
    return marks


def log_layers(marks, stages):
    total = marks[-1][1] - marks[0][1]
    log(f"  layers (host clock, synchronized): {1000 * total:.1f} ms per batch")
    for name, s in stages:
        log(f"  layer {name:38s} {1000 * s:8.2f} ms {100 * s / total:5.1f} %")


def split_rcnn(model, batch):
    import torch

    rh = model.roi_heads
    cascade = isinstance(rh.box_predictor, torch.nn.ModuleList)
    mods = {"bottom_up": model.backbone.bottom_up, "afi": model.backbone.srf_module,
            "rpn_head": model.proposal_generator.rpn_head, "roi_heads": rh,
            "box_predictor": rh.box_predictor[-1] if cascade else rh.box_predictor}
    if rh.mask_on:
        mods["mask_head"] = rh.mask_head
    if getattr(rh, "keypoint_on", False):
        mods["keypoint_head"] = rh.keypoint_head
    marks = layer_marks(model, batch, mods)
    t = {}
    for name, ts in marks:
        t.setdefault(name, ts)
    spans = [ts - s for (n, ts), (_, s) in zip(marks[1:], marks) if n == "afi>"]
    afi = sum(spans)
    stages = [
        ("input + normalise", t["bottom_up<"] - t["start"]),
        (f"bottom-up ({type(model.backbone.bottom_up).__name__})",
         t["bottom_up>"] - t["bottom_up<"]),
        (f"afi generator x{len(spans)}", afi),
        ("pyramid convs", t["rpn_head<"] - t["bottom_up>"] - afi),
        ("rpn head", t["rpn_head>"] - t["rpn_head<"]),
        ("proposals (top-k, decode, nms)", t["roi_heads<"] - t["rpn_head>"]),
        (f"box pool + box head x{len(rh.box_predictor) if cascade else 1}",
         t["box_predictor>"] - t["roi_heads<"]),
    ]
    if rh.mask_on:
        stages += [
            ("detection (decode, nms) + mask pool", t["mask_head<"] - t["box_predictor>"]),
            ("mask head", t["mask_head>"] - t["mask_head<"]),
            ("output", t["end"] - t["mask_head>"])]
    elif "keypoint_head" in mods:
        stages += [
            ("detection (decode, nms) + keypoint pool",
             t["keypoint_head<"] - t["box_predictor>"]),
            ("keypoint head (8 convs, deconv, upsample)",
             t["keypoint_head>"] - t["keypoint_head<"]),
            ("heatmaps to keypoints + output", t["end"] - t["keypoint_head>"])]
    else:
        stages.append(("detection (decode, nms) + output", t["end"] - t["box_predictor>"]))
    log_layers(marks, stages)


def split_proposals(model, batch):
    """A ProposalNetwork's batch by layer: the backbone, the RPN head and the
    proposals (top-k, decode, NMS)."""
    mods = {"bottom_up": model.backbone.bottom_up, "afi": model.backbone.srf_module,
            "rpn_head": model.proposal_generator.rpn_head}
    marks = layer_marks(model, batch, mods)
    t = dict(reversed(marks))  # the first stamp of each name
    spans = [ts - s for (n, ts), (_, s) in zip(marks[1:], marks) if n == "afi>"]
    afi = sum(spans)
    log_layers(marks, [
        ("input + normalise", t["bottom_up<"] - t["start"]),
        ("bottom-up (ResNet)", t["bottom_up>"] - t["bottom_up<"]),
        (f"afi generator x{len(spans)}", afi),
        ("pyramid convs", t["rpn_head<"] - t["bottom_up>"] - afi),
        ("rpn head", t["rpn_head>"] - t["rpn_head<"]),
        ("proposals (top-k, decode, nms) + output", t["end"] - t["rpn_head>"])])


def split_centermask(model, batch):
    head = model.proposal_generator.fcos_head
    mods = {"bottom_up": model.backbone.bottom_up, "afi": model.backbone.srf_module,
            "fcos_head": head, "mask_head": model.roi_heads.mask_head}
    marks = layer_marks(model, batch, mods, methods=("_pool",))
    t = dict(reversed(marks))  # the first stamp of each name
    spans = [ts - s for (n, ts), (_, s) in zip(marks[1:], marks) if n == "afi>"]
    afi = sum(spans)
    log_layers(marks, [
        ("input + normalise", t["bottom_up<"] - t["start"]),
        ("bottom-up (ResNet)", t["bottom_up>"] - t["bottom_up<"]),
        (f"afi generator x{len(spans)}", afi),
        ("BiFPN nodes", t["fcos_head<"] - t["bottom_up>"] - afi),
        ("FCOS head (towers over 5 levels)", t["fcos_head>"] - t["fcos_head<"]),
        ("FCOS decode + NMS", t["_pool<"] - t["fcos_head>"]),
        (f"mask pool ({model.pooler_impl})", t["_pool>"] - t["_pool<"]),
        ("mask head", t["mask_head>"] - t["mask_head<"]),
        ("output", t["end"] - t["mask_head>"])])


# ---------------------------------------------------------------------------
# the stage-3 train step
# ---------------------------------------------------------------------------

STEP3_YAML = "step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"
# the YAML's 0.02 at 16 images, scaled to batch 2 by d2's linear rule
TRAIN_LR = 0.0025
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# per step: the box and the mask pool, forward and backward; one RPN NMS call
# an image; no generator kernel (training takes the unfused route)
TRAIN_PER_STEP = {"afi_chain": 0, "afi_upsample": 0, "afi_rdb": 0, "roi_pool": 2,
                  "roi_pool_bwd": 2, "layer_norm": 0, "window_attention": 0,
                  "window_gather": 0, "nms": 2, "deform_conv": 0, "deform_conv_bwd": 0}
# CenterMask: the mask pool forward and backward at 160 channels, one FCOS
# decode NMS call an image (the mask branch's proposals)
CENTERMASK_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, roi_pool=1, roi_pool_bwd=1)
CENTERMASK_YAML = "inference/AFI-GAN_centermask_R_50_BiFPN.yaml"
# Cascade: the three box stages' pools (7x7) and the mask pool (14x14), forward
# and backward; the RPN's NMS an image (the cascade adds none in training)
CASCADE_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, roi_pool=4, roi_pool_bwd=4)
CASCADE_YAML = "inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml"
# Swin cascade (box only): the three box stages' pools (7x7), forward and
# backward; the RPN's NMS an image (the cascade adds none in training); no
# LayerNorm or attention kernel (the Swin's training route: torch ops under
# autograd, as JAX trains through its XLA branches). The eval pass after the
# steps launches the Swin's forward kernels: 55 LayerNorms (patch norm, two a
# block, three merges, three outputs) and 24 attentions (one a block)
SWIN_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, roi_pool=3, roi_pool_bwd=3)
SWIN_EVAL_PASS = {"layer_norm": 55, "window_attention": 24}
SWIN_YAML = "inference/AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml"


# COCO person keypoints' left/right permutation (d2's
# create_keypoint_hflip_indices over the 17 COCO names)
COCO_KEYPOINT_HFLIP = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


def train_records(gen, n_img=2, hw=(800, 1333), n_obj=12, n_keypoints=0, n_classes=80):
    """In-memory COCO-style records: random pixels, and from ``gen`` per
    image ``n_obj`` boxes (xyxy, 24-400 px a side), classes in [0, n_classes) and an
    octagon polygon inside each box; with ``n_keypoints``, that many COCO
    keypoints an object inside its box, visibility 2, 1 or 0 (zeroed)."""
    import torch

    h, w = hw
    recs = []
    for i in range(n_img):
        img = torch.randint(0, 256, (h, w, 3), generator=gen, dtype=torch.uint8).numpy()
        anns = []
        for _ in range(n_obj):
            bw, bh = (24 + 376 * torch.rand(2, generator=gen)).tolist()
            x0 = float(torch.rand(1, generator=gen)) * (w - bw)
            y0 = float(torch.rand(1, generator=gen)) * (h - bh)
            ang = np.arange(8) * np.pi / 4
            poly = np.stack([x0 + bw / 2 * (1 + 0.95 * np.cos(ang)),
                             y0 + bh / 2 * (1 + 0.95 * np.sin(ang))], 1).reshape(-1)
            anns.append({"bbox": [x0, y0, x0 + bw, y0 + bh], "iscrowd": 0,
                         "category_id": int(torch.randint(0, n_classes, (1,),
                                                          generator=gen)),
                         "segmentation": [poly.tolist()]})
            if n_keypoints:
                u = torch.rand(n_keypoints, 2, generator=gen).numpy()
                vis = torch.randint(0, 3, (n_keypoints,), generator=gen).numpy()
                kp = np.stack([x0 + u[:, 0] * bw, y0 + u[:, 1] * bh, vis], 1) * (vis > 0)[:, None]
                anns[-1]["keypoints"] = kp.reshape(-1).tolist()
        recs.append({"image": img, "image_id": i + 1, "height": h, "width": w,
                     "annotations": anns})
    return recs


def train_cfg(out_dir, yaml=STEP3_YAML, *extra):
    """The stage-3 YAML at full width (ResNet-50, FPN 256, AFI 3 RDBs, masks,
    RPN 2000/1000, 512 + 128 ROIs an image), or ``yaml``, bf16, batch 2; the
    short side 800 so that every batch fills the 832x1344 canvas (896x1408
    for a BiFPN); warm-up off; ``extra`` merged last."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(yaml)
    cfg.merge_from_list([
        "TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.BASE_LR", str(TRAIN_LR), "SOLVER.WARMUP_ITERS", "0",
        "INPUT.MIN_SIZE_TRAIN", "(800,)", "SEED", "0", "DATASETS.TRAIN", "('chip_smoke_train',)",
        "DATASETS.TEST", "()", "OUTPUT_DIR", str(out_dir), *extra])
    return cfg


def centermask_train_cfg(out_dir):
    """The CenterMask R-50-BiFPN YAML at full width (BiFPN 6 x 160 channels,
    4-conv GN towers, SAG mask head) with the AF interpolator trained
    (``MODEL.AFI_FREEZE False``), 64 GT slots with 28x28 mask canvases, as
    the JAX bench's ``centermask`` mode; otherwise ``train_cfg``'s. The
    decode of training keeps its 1000 / 100 candidates at threshold 0: a
    seeded head scores every location near its 0.01 prior, under the YAML's
    0.05, so no candidate would reach NMS or the mask branch; a prior lifted
    above 0.05 takes the focal loss of 4.2M negative entries a step, about a
    thousand times its gradient at 0.01, and is trained back under it."""
    return train_cfg(out_dir, CENTERMASK_YAML, "MODEL.AFI_FREEZE", "False",
                     "TPU.MAX_GT_BOXES", "64", "TPU.MASK_CANVAS", "28",
                     "MODEL.FCOS.INFERENCE_TH_TRAIN", "0.0")


def cascade_train_cfg(out_dir):
    """The Cascade Mask R-CNN ResNeSt-101-PAFPN YAML at full width (radix 2,
    deep stem, AVD, SyncBN that trains everywhere, FREEZE_AT 2, RPN 2000
    proposals after NMS, three 4-conv box heads, the normed mask head) with
    the AF interpolator trained (``MODEL.AFI_FREEZE False``), as the JAX
    bench's ``s101`` mode; otherwise ``train_cfg``'s."""
    return train_cfg(out_dir, CASCADE_YAML, "MODEL.AFI_FREEZE", "False")


def swin_train_cfg(out_dir):
    """The Cascade R-CNN Swin-L-BiFPN(AFI) YAML at full width (embed 192,
    depths 2-2-18-2, heads 6-48, window 12, DropPath 0.2; BiFPN 7 x 256 with
    SyncBN that trains; three 4-conv SyncBN box heads, no masks) with the AF
    interpolator trained (``MODEL.AFI_FREEZE False``); otherwise
    ``train_cfg``'s."""
    return train_cfg(out_dir, SWIN_YAML, "MODEL.AFI_FREEZE", "False")


class DropPathRecord:
    """A DropPath source (``models/swin.py::drop_path_keep``) that draws from
    ``gen`` and keeps every mask it hands out, on the card (no sync)."""

    def __init__(self, gen):
        self.gen, self.masks = gen, []

    def __call__(self, shape, keep, device):
        from afigan_tpu_torch.models.swin import drop_path_keep

        mask = drop_path_keep(self.gen, shape, keep, device)
        self.masks.append(mask)
        return mask


def route_device_ms(prof, names):
    """The device time of the kernels that each record_function range of
    ``names`` launched in a profiled train step, forward and backward: the
    forward's by the host time of the launching operator inside the range,
    the backward's by the autograd node that carries the sequence number of
    one of the range's forward operators. {name: [forward ms, backward ms,
    kernel launches]}."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in events
             if e.name in names]
    out = {n: [0.0, 0.0, 0] for n in names}
    seq = {}
    for e in events:
        name = next((n for n, a, b, t in spans
                     if t == e.thread and a <= e.time_range.start <= b), None)
        if name is None:
            continue
        if e.sequence_nr >= 0:
            seq[(e.thread, e.sequence_nr)] = name
        out[name][0] += sum(k.duration for k in e.kernels) / 1000.0
        out[name][2] += len(e.kernels)
    for e in events:
        if not e.kernels:
            continue
        node = e
        while node is not None and not node.name.startswith(
                "autograd::engine::evaluate_function"):
            node = node.cpu_parent
        name = node is not None and seq.get((node.fwd_thread, node.sequence_nr))
        if name:
            out[name][1] += sum(k.duration for k in e.kernels) / 1000.0
            out[name][2] += len(e.kernels)
    return out


def swin_verify(path, model, before, steps):
    """After the timed steps of ``train_swin``: each cascade stage's
    foreground fraction above 0 at every step; every LayerNorm's scale and
    bias and every relative-position bias table moved (the training route
    trains them); every running statistic of the batch norms that train (the
    BiFPN's, each box head's) moved; nothing frozen (``FREEZE_AT -1``)."""
    import torch

    for k in range(3):
        fg = [m[f"diag_fg_frac_stage{k}"] for m in steps]
        if not min(fg) > 0:
            raise AssertionError(f"{path}: stage {k} foreground fraction by step {fg}")
    after = model.state_dict()
    params = dict(model.named_parameters())
    if not all(p.requires_grad for p in params.values()):
        raise AssertionError(f"{path}: frozen parameters under FREEZE_AT -1")
    swin = [n for n in params if n.startswith("backbone.bottom_up.") and (
        "norm" in n.split(".")[-2] or n.endswith("relative_position_bias_table"))]
    still = [n for n in swin if torch.equal(after[n], before[n])]
    groups = batch_norm_groups(model)
    want = {"pyramid", *(f"roi_heads.box_head.{k}" for k in range(3))}
    stuck = [f"{n}.{s_}" for names in groups.values() for n in names
             for s_ in ("running_mean", "running_var")
             if torch.equal(after[f"{n}.{s_}"], before[f"{n}.{s_}"])]
    if still or set(groups) != want or stuck:
        raise AssertionError(f"{path}: Swin norms or tables that did not move {still[:6]}, "
                             f"batch norms that train in {sorted(groups)}, statistics that "
                             f"did not move {stuck[:6]}")
    log(f"  {path}: {len(swin)} Swin LayerNorm parameters and bias tables moved, the "
        "running statistics of every batch norm moved: "
        + ", ".join(f"{p} {len(n)}" for p, n in sorted(groups.items())))


def swin_eval_pass(path, model, inputs, results):
    """One pass of the trained model in eval mode under ``no_grad``: the
    Swin's forward kernels (``SWIN_EVAL_PASS`` launches), each call held
    against its plain version with every other kernel of the pass; finite
    detections."""
    import torch

    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    model.eval()
    try:
        reset_launches()
        with torch.no_grad(), HeldKernels("bfloat16") as held:
            dets, masks = model(inputs["image"], inputs["image_sizes"])
        counts = dict(LAUNCHES)
    finally:
        model.train()
    check_outputs(dets, masks, 2, dets.boxes.shape[1], None)
    for k, n in SWIN_EVAL_PASS.items():
        if counts[k] != n or held.calls.get(k) != n:
            raise AssertionError(f"{path} eval pass: {counts[k]} launches of {k}, "
                                 f"{held.calls.get(k)} held, expected {n}")
        results[k].setdefault("launches", {})[f"{path}_eval"] = n
    launched = {k: v for k, v in counts.items() if v}
    log(f"  {path} eval pass (no_grad): launches {json.dumps(launched)}; held against their "
        "plain versions: " + ", ".join(
            f"{k} x{n_} max_abs_err {held.err[k]:.3e}" for k, n_ in held.calls.items()))


def batch_norm_groups(model):
    """The batch norms that train, by part of the model: {part: [module
    name, ...]}."""
    from afigan_tpu_torch.models.layers import BatchNorm2d

    groups = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            part = ("bottom-up" if name.startswith("backbone.bottom_up.") else
                    "pyramid" if name.startswith("backbone.") else
                    ".".join(name.split(".")[:3]) if ".box_head." in name else
                    ".".join(name.split(".")[:2]))
            groups.setdefault(part, []).append(name)
    return groups


def cascade_verify(path, model, before, steps):
    """After the timed steps of ``train_cascade``: each stage's foreground
    fraction above 0 at every step (the stage-1 and -2 rematch at 0.6 / 0.7
    keeps something to regress on); every trainable parameter moved but the
    split attention's fc1 biases, whose gradient batch norm zeroes; every
    running statistic of the batch norms that train moved (the bottom-up's,
    the frozen stem's and res2's included, the pyramid's, each box head's and
    the mask head's); the frozen parameters (the deep stem and res2) did
    not."""
    import torch

    for k in range(3):
        fg = [m[f"diag_fg_frac_stage{k}"] for m in steps]
        if not min(fg) > 0:
            raise AssertionError(f"{path}: stage {k} foreground fraction by step {fg}")
    log(f"  {path}: foreground fraction of stages 0 / 1 / 2, first step " + " / ".join(
        f"{steps[0][f'diag_fg_frac_stage{k}']:.4f}" for k in range(3)) + ", last step "
        + " / ".join(f"{steps[-1][f'diag_fg_frac_stage{k}']:.4f}" for k in range(3)))
    after = model.state_dict()
    params = dict(model.named_parameters())
    frozen = [n for n, p in params.items() if not p.requires_grad]
    if not frozen or not all(".stem." in n or ".res2." in n for n in frozen):
        raise AssertionError(f"{path}: frozen parameters {frozen[:4]}")
    still = [n for n, p in params.items() if p.requires_grad and torch.equal(after[n], before[n])]
    # the split attention's fc1 bias feeds bn1, batch norm that trains, which
    # subtracts the batch mean: its gradient is zero (over two images, the
    # two samples' gradients are exact negatives)
    zero_grad = [n for n in still if n.endswith(".conv2.fc1.bias")]
    moved_frozen = [n for n in frozen if not torch.equal(after[n], before[n])]
    if set(still) - set(zero_grad) or moved_frozen:
        raise AssertionError(
            f"{path}: trainable parameters that did not move "
            f"{sorted(set(still) - set(zero_grad))[:8]}, frozen ones that did {moved_frozen[:6]}")
    groups = batch_norm_groups(model)
    want = {"bottom-up", "pyramid", "roi_heads.mask_head",
            *(f"roi_heads.box_head.{k}" for k in range(3))}
    if set(groups) != want:
        raise AssertionError(f"{path}: batch norms that train in {sorted(groups)}")
    for part, names in groups.items():
        stuck = [f"{n}.{s}" for n in names for s in ("running_mean", "running_var")
                 if torch.equal(after[f"{n}.{s}"], before[f"{n}.{s}"])]
        if stuck:
            raise AssertionError(f"{path}: running statistics that did not move {stuck[:6]}")
    log(f"  {path}: {len(params) - len(frozen) - len(zero_grad)} trainable parameters moved, "
        f"{len(zero_grad)} fc1 biases before bn1 (a zero gradient) and {len(frozen)} frozen "
        f"(deep stem, res2) did not; the running statistics of every batch norm moved: "
        + ", ".join(f"{p} {len(n)}" for p, n in sorted(groups.items())))


# the FCOS head's box distances at the start of train_centermask, in strides
# (the bias of ``bbox_pred``): a seeded head regresses distances of a fraction
# of a stride, half of them 0, boxes that neither overlap in NMS nor cover a
# pooled window; 3 strides gives the boxes of 48-768 px of a trained head
CENTERMASK_BOX_STRIDES = 3.0


def spread_fcos_boxes(model):
    import torch

    with torch.no_grad():
        model.proposal_generator.fcos_head.bbox_pred.bias.fill_(CENTERMASK_BOX_STRIDES)


def step_split(cfg, state, inputs, draws, drop_path=None):
    """One train step on the host clock with a synchronize after the
    forward, the backward and the optimizer: (forward, backward, optimizer)
    seconds."""
    import torch

    from afigan_tpu_torch.models.swin import drop_path_source

    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with drop_path_source(model, drop_path):
        losses = model(inputs["image"], inputs["image_sizes"], inputs["gt"], draws=draws)
    total = sum(v for k, v in losses.items() if not k.startswith("diag_"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    total.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    opt.step()
    state.scheduler.step()
    torch.cuda.synchronize()
    return t1 - t0, t2 - t1, time.perf_counter() - t2


def phase_train(results):
    train_phase(results, "train", train_cfg, R50_CANVAS, TRAIN_PER_STEP, (7, 14))


def phase_train_centermask(results):
    train_phase(results, "train_centermask", centermask_train_cfg, SWIN_CANVAS,
                CENTERMASK_TRAIN_PER_STEP, (14,), spread_fcos_boxes)


def phase_train_cascade(results):
    train_phase(results, "train_cascade", cascade_train_cfg, R50_CANVAS,
                CASCADE_TRAIN_PER_STEP, (7, 7, 7, 14), verify=cascade_verify)


def phase_train_swin(results):
    train_phase(results, "train_swin", swin_train_cfg, SWIN_CANVAS, SWIN_TRAIN_PER_STEP,
                (7, 7, 7), verify=swin_verify, after=swin_eval_pass)


def keypoint_train_cfg(out_dir):
    """Keypoint R-CNN R-50-FPN(AFI) (``config.KEYPOINT_EDITS`` over the main
    path's YAML: 17 keypoints, 8 x 512 convs, one class, 1500 proposals)
    at full width; otherwise ``train_cfg``'s."""
    from afigan_tpu_torch.config import KEYPOINT_EDITS, R50_FPN_YAML

    return train_cfg(out_dir, R50_FPN_YAML, *KEYPOINT_EDITS)


def res5_train_cfg(out_dir):
    """The Res5 heads over the main path's FPN(AFI) (``config.RES5_EDITS``:
    the RPN and the heads on p4, res5 2048/512 inside the head, masks) at
    full width, ROI batch 512; otherwise ``train_cfg``'s."""
    from afigan_tpu_torch.config import R50_FPN_YAML, RES5_EDITS

    return train_cfg(out_dir, R50_FPN_YAML, *RES5_EDITS)


# Keypoint R-CNN a batch: the generator as r50's, the box pool (7x7) and the
# keypoint pool (14x14, its own sampling ratio and alignment), NMS for the
# proposals and the detections an image
KEYPOINT_PER_BATCH = dict(R50_PER_BATCH, roi_pool=2)
KEYPOINT_HELD = {"afi_chain": 3, "afi_upsample": 3, "roi_pool": 2, "nms": 4}
# a step: the box and the keypoint pool both ways, the RPN's NMS an image
KEYPOINT_TRAIN_PER_STEP = dict(TRAIN_PER_STEP)
# the Res5 heads a batch: the fast pooler over p4 for the proposals and for
# the detections' masks, each one window_gather launch and one roi_pool
# launch over the overflow slots (fixed shapes)
RES5_PER_BATCH = dict(R50_PER_BATCH, roi_pool=2, window_gather=2)
RES5_HELD = {"afi_chain": 3, "afi_upsample": 3, "roi_pool": 2, "window_gather": 2, "nms": 4}
# a step: the fast pooler's training route, its forward one window_gather
# launch and one roi_pool launch over the overflow slots, its backward one
# launch of the pool's backward
RES5_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, roi_pool=1, roi_pool_bwd=1, window_gather=1)


def held_batch(path, model, batch, want, windows=False):
    """One batch under ``HeldKernels`` (bf16): the calls made must be
    ``want``; their largest errors logged."""
    from afigan_tpu_torch.engine.inference import predict

    with HeldKernels("bfloat16", windows=windows) as held:
        predict(model, batch)
    if held.calls != want:
        raise AssertionError(f"{path}: held {held.calls}, expected {want}")
    log(f"  {path}: one batch's launches held against their plain versions: " + ", ".join(
        f"{k} x{n} max_abs_err {held.err[k]:.3e}" for k, n in held.calls.items())
        + f"; NMS calls (N, valid candidates, kept, suppressed before the stop) {held.nms}")


def phase_slice_keypoint(results, n_batches=10):
    """Keypoint R-CNN R-50-FPN(AFI) inference at full width: the two
    traffics of phase slice, the launches of every batch asserted, every
    batch's keypoints (2, 100, 17, 3), finite and inside their boxes; one
    batch of 100 detections an image with every call held."""
    from afigan_tpu_torch.config import keypoint_path_cfg

    model, batch = run_slice(results, "keypoint", keypoint_path_cfg, R50_CANVAS,
                             KEYPOINT_PER_BATCH, n_batches)
    from afigan_tpu_torch.engine.inference import predict

    dets, masks = predict(model, batch)
    if masks is not None or tuple(dets.keypoints.shape) != (2, 100, 17, 3):
        raise AssertionError(f"keypoint: keypoints {tuple(dets.keypoints.shape)}")
    kp = dets.keypoints[dets.valid]
    log(f"  keypoint: {int(dets.valid.sum())} detections, keypoint scores "
        f"{float(kp[..., 2].min()):.3e}-{float(kp[..., 2].max()):.3e}, all inside their boxes")
    held_batch("keypoint", model, batch, KEYPOINT_HELD)


def phase_train_keypoint(results):
    train_phase(results, "train_keypoint", keypoint_train_cfg, R50_CANVAS,
                KEYPOINT_TRAIN_PER_STEP, (7, 14), keypoints=17, held_backward=True)


def capture_windows(fn):
    """``fn()`` with every ``gather_windows`` call's inputs kept: [(concat,
    rows, cols, window)]."""
    from afigan_tpu_torch.ops import roi_align

    calls, real = [], roi_align.gather_windows

    def record(concat, rows, cols, window):
        calls.append((concat, rows.clone(), cols.clone(), window))
        return real(concat, rows, cols, window)

    roi_align.gather_windows = record
    try:
        fn()
    finally:
        roi_align.gather_windows = real
    return calls


def time_window_gather(results, path, calls):
    """Each captured ``window_gather`` call of one batch: kernel, plain (a
    stack of slices) and the one-call indexing gather by CUDA events, and the
    bound (its bytes), into ``path``'s bf16 tally."""
    import torch

    from afigan_tpu_torch.ops.kernels.window_gather import gather_windows, gather_windows_plain

    for concat, rows, cols, win in calls:
        dtype_name = str(concat.dtype)[6:]
        ar = torch.arange(win, device=concat.device)
        r, (sum_h, wmax, c) = rows.shape[0], concat.shape
        fk = lambda: gather_windows(concat, rows, cols, win)  # noqa: E731
        fp = lambda: gather_windows_plain(concat, rows, cols, win)  # noqa: E731
        fl = lambda: concat[(rows[:, None] + ar)[:, :, None],  # noqa: E731
                            (cols[:, None] + ar)[:, None, :]]
        if not torch.equal(fk(), fp()):
            raise AssertionError(f"{path}: window_gather differs from its plain version")
        tk, tp, tl = median_ms(fk), median_ms(fp, iters=3, inner=1), median_ms(fl)
        under = torch.zeros((sum_h, wmax), dtype=torch.bool, device=concat.device)
        under[(rows[:, None] + ar)[:, :, None], (cols[:, None] + ar)[:, None, :]] = True
        elt = ELT[dtype_name]
        written, read = r * win * win * c * elt, int(under.sum()) * c * elt
        nbytes = written + read + 8 * r
        log(f"  window_gather {path} {dtype_name} ({sum_h}, {wmax}, {c}) R={r} window={win}: "
            f"kernel {tk:.3f} ms ({nbytes / tk / 1e9:.2f} TB/s) plain {tp:.3f} ms "
            f"indexing gather {tl:.3f} ms, bound {1000 * nbytes / HBM_BYTES_PER_S:.3f} ms")
        tally(results, "window_gather", path, dtype_name).add(tk, tp, nbytes, 0, dtype_name,
                                                              0.0, 1, tl)
        torch.cuda.empty_cache()


def phase_res5(results, n_batches=5):
    """The Res5 (C4) heads over the FPN(AFI) pyramid at full width: inference
    under the two traffics (window_gather and the overflow pool twice a
    batch, asserted), one batch of 100 detections an image with every call
    (window_gather bit for bit) held and each window_gather call timed; then
    stage-3 training through ``train_phase``: the fast pooler's training
    route launches window_gather, the overflow pool and the pool's backward
    once a step, all three held and timed on a step's own calls."""
    import torch

    from afigan_tpu_torch.config import res5_path_cfg
    from afigan_tpu_torch.engine.inference import predict

    model, batch = run_slice(results, "res5", res5_path_cfg, R50_CANVAS, RES5_PER_BATCH,
                             n_batches)
    held_batch("res5", model, batch, RES5_HELD, windows=True)
    calls = capture_windows(lambda: predict(model, batch))
    del model
    torch.cuda.empty_cache()
    time_window_gather(results, "res5", calls)
    del calls
    torch.cuda.empty_cache()
    train_phase(results, "train_res5", res5_train_cfg, R50_CANVAS, RES5_TRAIN_PER_STEP, (14,),
                held_backward=True)


# ProposalNetwork a batch: the generator as r50's, the RPN's NMS an image, no
# pool; a step: the RPN's NMS an image, nothing else of the port
PROPOSAL_PER_BATCH = dict(R50_PER_BATCH, roi_pool=0, nms=2)
PROPOSAL_HELD = {"afi_chain": 3, "afi_upsample": 3, "nms": 2}
PROPOSAL_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, roi_pool=0, roi_pool_bwd=0)
PROPOSAL_AR = {f"AR{s}@{n}" for n in (100, 1000) for s in ("", "s", "m", "l")}


def phase_slice_proposals(results, n_batches=10):
    """ProposalNetwork R-50-FPN(AFI) at full width (``config.proposal_path_cfg``:
    d2's rpn_R_50_FPN_1x edits, 2000 proposals an image): 10 timed batches
    of 832x1344, 48 chain, 9 upsample and 2 NMS launches a batch and no
    pool asserted, every batch's proposals (2, 2000) finite and inside the
    canvas; the same with normalised pixels (at least 500 valid proposals
    an image); on that model one batch with every call held, the bounds of
    its launches, a profiled batch and its layer split; then
    ``run_inference`` over a
    generated 4-image COCO set at batch 2 with ``max_images`` 3: the
    box-proposal recall's 8 AR keys, from 3 images' proposals."""
    import torch

    from afigan_tpu_torch.config import proposal_path_cfg
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch import evaluation
    from afigan_tpu_torch.engine.inference import predict, run_inference

    rng = np.random.RandomState(0)
    batches = [random_batch(rng, 2, R50_CANVAS, SIZES) for _ in range(n_batches + 1)]
    model, _, counts = run_batches("proposals", proposal_path_cfg(), batches,
                                   PROPOSAL_PER_BATCH)
    for k, v in counts.items():
        results[k].setdefault("launches", {})["proposals"] = v // len(batches)
    del model
    # random weights on raw pixels decode nearly every proposal to a sliver
    # under the RPN's minimum size; normalised pixels (the golden test's
    # PIXEL_STD) give the load of a trained RPN: most of the 2000 slots valid
    cfg = proposal_path_cfg()
    cfg.MODEL.PIXEL_STD = GOLDEN_PIXEL_STD
    model, valid, _ = run_batches("proposals with normalised pixels", cfg, batches,
                                  PROPOSAL_PER_BATCH)
    if min(valid) < 2 * 500:
        raise AssertionError(f"proposals: valid proposals a batch {valid}")
    with BoundCapture() as bounds:
        predict(model, batches[-1])
    bounds.log("proposals, one batch")
    held_batch("proposals", model, batches[-1], PROPOSAL_HELD)
    profile_batch(model, batches[-1])
    dataset = CocoDataset(*write_coco(Path("output") / "chip_smoke_proposals", 4, (480, 640), 2,
                                      80))
    seen, real = [], evaluation.evaluate_box_proposals

    def recall(proposals, *a, **k):
        seen.append(len(proposals))
        return real(proposals, *a, **k)

    evaluation.evaluate_box_proposals = recall
    try:
        t0 = time.perf_counter()
        res = run_inference(cfg, model, dataset, batch_size=2, max_images=3)
        wall = time.perf_counter() - t0
    finally:
        evaluation.evaluate_box_proposals = real
    ar = res.get("box_proposals", {})
    if set(res) != {"box_proposals"} or set(ar) != PROPOSAL_AR or not all(
            np.isfinite(v) and 0 <= v <= 100 for v in ar.values()):
        raise AssertionError(f"proposals run_inference: {res}")
    if set(seen) != {3}:
        raise AssertionError(f"proposals run_inference: recall over {seen} images, expected 3")
    log(f"  proposals run_inference: 3 of 4 images (max_images), {wall:.2f} s with the "
        f"loader, the recall over 3 images: " + json.dumps({k: round(v, 3) for k, v in
                                                           sorted(ar.items())}))
    del model
    torch.cuda.empty_cache()


def deform_profile(model, batch):
    """One batch of a deformable model under the profiler: the device time
    of the deformable convs' gathers and products (their ``deform_conv``
    range), their calls, the sampling kernel's launches against the bound of
    their own inputs, and the batch's peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models.resnest import DeformConv

    n = sum(isinstance(m, DeformConv) for m in model.modules())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for session in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                SamplingWork() as work:
            t0 = time.perf_counter()
            predict(model, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        sampling = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and "deform_im2col_kernel" in e.key]
        if sum(e.count for e in sampling) == n:
            break
        log(f"  resnest_dcn profile: session {session + 1} of 3 holds "
            f"{sum(e.count for e in sampling)} of the batch's {n} sampling launches")
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = sum(1 for e in prof.events()
                if e.name == "deform_conv" and e.device_type == DeviceType.CPU)
    ms = range_device_ms(prof, ("deform_conv",))
    busy = sum(ms.values())
    if calls != n or ms["deform_conv"] <= 0:
        raise AssertionError(f"deform profile: {calls} deform_conv ranges of {n} modules, "
                             f"{ms['deform_conv']} ms")
    log(f"  resnest_dcn profile: the {n} deformable convs {ms['deform_conv']:.2f} ms on the "
        f"device (their deform_conv ranges; the plain torch gather took 63.83 ms there on "
        f"an NVIDIA H100 80GB HBM3 at 700 W), "
        f"{100 * ms['deform_conv'] / max(busy, 1e-9):.1f} % of the batch's "
        f"{busy:.1f} ms busy; wall {1000 * wall:.1f} ms, profiler on; peak memory of the "
        f"batch {peak:.2f} GiB")
    log("  resnest_dcn profile: " + work.line(sampling))


DCN_YAML = "inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_FPN.yaml"
DCN_EDITS = ["MODEL.RESNETS.DEFORM_ON_PER_STAGE", "[False, True, True, True]",
             "MODEL.RESNETS.DEFORM_MODULATED", "True"]


def dcn_cfg():
    """The ResNeSt-101-FPN cascade mask YAML with the DCN setting of
    ResNeSt's public d2 configs: a modulated deformable 3x3 in every block of
    res3-res5."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(DCN_YAML)
    cfg.merge_from_list(list(DCN_EDITS))
    return cfg


# a batch of the deformable ResNeSt cascade: one sampling launch a
# deformable conv (4 blocks of res3, 23 of res4, 3 of res5)
RESNEST_DCN_PER_BATCH = dict(RESNEST_PER_BATCH, deform_conv=30)
RESNEST_DCN_HELD = {"afi_chain": 3, "afi_upsample": 3, "roi_pool": 4, "nms": 4,
                    "deform_conv": 30}


def r18_cfg():
    """The main path's YAML over a ResNet-18 (basic blocks, res2 64)."""
    from afigan_tpu_torch.config import main_path_cfg

    cfg = main_path_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64"])
    return cfg


def phase_slice_backbones(results, n_batches=5):
    """The R-18 and the deformable ResNeSt bottom-ups at full width, bf16,
    batch 2, the two traffics of phase slice, 5 batches each, launches
    asserted every batch: R-18-FPN(AFI) Mask R-CNN (832x1344; one batch of 100
    detections held), and the ResNeSt-101-FPN cascade with deformable convs
    in res3-res5 (``dcn_cfg``; the deformable conv float32 inside): its
    deformable convs' device time and the batch's peak memory in a profiled
    batch."""
    import torch

    from afigan_tpu_torch.data import choose_bucket, required_size_divisibility

    model, batch = run_slice(results, "r18", r18_cfg, R50_CANVAS, R50_PER_BATCH, n_batches)
    held_batch("r18", model, batch, {"afi_chain": 3, "afi_upsample": 3, "roi_pool": 2, "nms": 4})
    del model
    torch.cuda.empty_cache()
    cfg = dcn_cfg()
    canvas = choose_bucket(max(h for h, _ in SIZES), max(w for _, w in SIZES),
                           cfg.TPU.IMAGE_BUCKETS, required_size_divisibility(cfg))
    model, batch = run_slice(results, "resnest_dcn", dcn_cfg, canvas, RESNEST_DCN_PER_BATCH,
                             n_batches)
    held_batch("resnest_dcn", model, batch, RESNEST_DCN_HELD)
    deform_profile(model, batch)
    del model
    torch.cuda.empty_cache()


def train_phase(results, path, make_cfg, canvas, per_step, pool_sizes, prepare=None,
                verify=None, after=None, keypoints=0, held_backward=False, first=None,
                more=None):
    """Stage-3 training at full width through ``TargetDetectorTrainer``: two
    iterations of ``train()`` over an in-memory dataset (mapper, loader,
    hooks, a checkpoint), then the main path: ``TRAIN_WARMUP`` + ``TRAIN_TIMED``
    steps of the trainer's state on one repeated batch, launches counted per
    step, every loss finite, ``total_loss`` lower at the last step than at
    the first; one step with every pooler and NMS launch held against its
    plain version on its own inputs; one profiled step (device busy share)
    and one step split into forward, backward and optimizer; the pool's
    backward on one step's own ROIs (``pool_sizes``: its calls' output
    sizes), whose calls phase ``train`` saves for ``kernel_sweep.py``, and
    where a step launches window_gather, each of a step's calls timed. In the
    held step every NMS call has valid candidates and suppresses some, and
    the ROI sampler takes proposals besides the appended GT. A Swin's
    DropPath masks come from the trainer's stream; those of the timed steps
    must drop some branches and keep others; the profiled step gives the
    device time of the Swin's training route (``route_device_ms``).
    ``prepare``: a change to the seeded model before the first step;
    ``verify(path, model, state dict before the timed steps, their
    metrics)``: checks after them; ``after(path, model, inputs, results)``:
    run last, on the trained model. ``keypoints``: COCO keypoints an object
    in the records (one class, the dataset's flip permutation);
    ``held_backward``: the held step holds the pool's backward too (and the
    deformable conv's adjoint). ``first(path, step, model)``: run before
    ``train()`` on the seeded model; ``more(path, step, model)``: run after
    the pool's backward was captured, before ``after``; ``step()`` is one
    train step of the trainer's state on the repeated batch. Every step's
    launches are counted on their own."""
    import json as _json
    import shutil
    import types

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
    from afigan_tpu_torch.data.loader import collate_batch, required_size_divisibility
    from afigan_tpu_torch.engine.stage3 import batch_to_device, train_step
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer
    from afigan_tpu_torch.models.swin import DropPath
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
    from afigan_tpu_torch.tools.kernel_sweep import (POOL_CALLS, capture_pool_backward,
                                                     save_pool_calls)

    out_dir = Path(__file__).resolve().parent / "output" / f"chip_smoke_{path}"
    shutil.rmtree(out_dir, ignore_errors=True)
    hflip = COCO_KEYPOINT_HFLIP[:keypoints] if keypoints else None
    records = train_records(torch.Generator().manual_seed(7), n_keypoints=keypoints,
                            n_classes=1 if keypoints else 80)
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(
        records=records, keypoint_hflip_indices=hflip))
    cfg = make_cfg(out_dir)
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    mapper = DatasetMapper(cfg, is_train=True, seed=0, keypoint_hflip_indices=hflip)
    batch = collate_batch([mapper(r) for r in records], cfg.TPU.IMAGE_BUCKETS,
                          required_size_divisibility(cfg))
    if tuple(batch["image"].shape[1:3]) != canvas:
        raise AssertionError(f"{path}: canvas {batch['image'].shape[1:3]} != {canvas}")
    t0 = time.perf_counter()
    trainer = TargetDetectorTrainer(cfg, device="cuda")
    if prepare is not None:
        prepare(trainer.model)
    inputs = batch_to_device(batch, "cuda")
    n_bn = calibrate_frozen_bn(trainer.model, inputs["image"])

    def step():
        return train_step(cfg, trainer.state, inputs, trainer.sampling, trainer.drop_path)

    if first is not None:
        first(path, step, trainer.model)
    trainer.train()
    lines = [_json.loads(x) for x in open(out_dir / "metrics.json")]
    if not (out_dir / "model_0000002.pth").is_file() or not all(
            np.isfinite(r["total_loss"]) for r in lines):
        raise AssertionError(f"{path} train(): no checkpoint or a non-finite loss: {lines}")
    log(f"  {path} train(): 2 iterations through the loader in {time.perf_counter() - t0:.1f} s "
        f"(build included), total_loss {lines[-1]['total_loss']:.4f}, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.2f}M params, "
        f"{sum(p.numel() for p in trainer.model.parameters() if p.requires_grad) / 1e6:.2f}M "
        f"trainable, {n_bn} FrozenBN statistics calibrated on the batch")
    n_gt = int(inputs["gt"].valid.sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ({k: v.clone() for k, v in trainer.model.state_dict().items()}
              if verify is not None else None)
    drop = DropPathRecord(trainer.drop_path)
    reset_launches()
    each = []  # every step's own launches

    def counted():
        was = dict(LAUNCHES)
        out = train_step(cfg, trainer.state, inputs, trainer.sampling, drop)
        each.append({k: LAUNCHES[k] - was[k] for k in LAUNCHES})
        return out

    steps, ms, ev = timed_steps(counted)
    counts = dict(LAUNCHES)
    n = len(steps)
    if verify is not None:
        verify(path, trainer.model, before, steps)
        del before

    if any(m.rate > 0 for m in trainer.model.modules() if isinstance(m, DropPath)):
        draws = len(drop.masks) // n  # a step's DropPath calls, each one keep an image
        kept = torch.cat([m.flatten() for m in drop.masks[TRAIN_WARMUP * draws:]])
        log(f"  {path}: DropPath draws {draws} masks a step; in the timed steps "
            f"{int(kept.sum())} of {kept.numel()} branches kept, {int((~kept).sum())} dropped")
        if kept.all() or not kept.any():
            raise AssertionError(f"{path}: the timed steps' DropPath masks kept "
                                 f"{int(kept.sum())} of {kept.numel()} branches")
    with BoundCapture() as bounds:  # one more step: the bounds of its launches
        step()
    bounds.log(f"{path}, one step")
    log(f"  {path}: launches in {n} steps " + _json.dumps(counts))
    for k, per in per_step.items():
        if counts[k] != per * n or any(c[k] != per for c in each):
            raise AssertionError(f"{path}: {[c[k] for c in each]} launches of {k} in the {n} "
                                 f"steps, expected {per} at every step")
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{path} step {i}: a non-finite loss {m}")
    log(f"  {path}: total_loss by step " + " ".join(f"{m['total_loss']:.4f}" for m in steps))
    log(f"  {path}: first / last step " + ", ".join(
        f"{k} {steps[0][k]:.4f} / {steps[-1][k]:.4f}" for k in steps[0]))
    if not steps[-1]["total_loss"] < steps[0]["total_loss"]:
        raise AssertionError(f"{path}: total_loss did not fall over the repeated batch")
    med = float(np.median(ms))
    log(f"  {path}: {med:.1f} ms per step of 2 images (median of {len(ms)}; min {min(ms):.1f}, "
        f"max {max(ms):.1f}), {2000 / med:.3f} images/s at the median, by CUDA events "
        f"{np.median(ev):.1f} ms ({min(ev):.1f}-{max(ev):.1f}), "
        f"{canvas[0]}x{canvas[1]} canvas, bf16, lr {TRAIN_LR}, {n_gt} GT boxes; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in ("roi_pool", "roi_pool_bwd", "nms", "layer_norm", "window_attention",
              "window_gather", "deform_conv", "deform_conv_bwd"):
        results[k].setdefault("launches", {})[path] = counts[k] // n
    # one step with every pooler and NMS launch held against its plain
    # version on the launch's own inputs (the pool's backward: below)
    windows = per_step["window_gather"] > 0
    with HeldKernels("bfloat16", backward=held_backward, windows=windows) as held, \
            SampledROIs(inputs["gt"].valid.shape[1]) as rois:
        step()
    want = held_want(per_step, held_backward)
    if held.calls != want:
        raise AssertionError(f"{path}: held {held.calls} launches, expected {want}")
    log(f"  {path}: one step's launches held against their plain versions: " + ", ".join(
        f"{k} x{n_} max_abs_err {held.err[k]:.3e}" for k, n_ in held.calls.items()))
    log(f"  {path}: the held step's NMS calls (N, valid candidates, kept, suppressed "
        f"before the stop) {held.nms}; ROIs sampled {rois.det} from the proposals "
        f"({rois.fg_det} foreground), {rois.gt} appended GT")
    if min(min(v, s) for _, v, _, s in held.nms) == 0:
        raise AssertionError(f"{path}: an NMS call without valid candidates or suppression")
    if getattr(trainer.model, "roi_heads", None) is not None and rois.det == 0:
        raise AssertionError(f"{path}: the ROI sampler took only the appended GT")

    # one step under the profiler, its trace held against the wrappers' counts
    for session in range(3):
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                SamplingWork() as work:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in RANGES]
        held = sum(e.count for e in kernels if any(k in e.key for k in PORT_KERNELS))
        if held == device_kernels(LAUNCHES):
            break
        log(f"  {path} profile: session {session + 1} of 3 holds {held} of the step's "
            f"{device_kernels(LAUNCHES)} launches of the port's kernels")
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0
    log(f"  {path} profile: wall {1000 * wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (1000 * wall):.1f} % of wall)")
    route = route_device_ms(prof, SWIN_ROUTE_RANGES + ("deform_conv",))
    for name, (f_ms, b_ms, launched) in route.items():
        if launched:
            log(f"  {path} profile: training route {name}: forward {f_ms:.3f} ms, backward "
                f"{b_ms:.3f} ms on the device in {launched} kernel launches "
                f"({100 * (f_ms + b_ms) / max(busy, 1e-9):.1f} % of the busy time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  kernel {e.self_device_time_total / 1000:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        if any(k in e.key for k in ("roi_pool", "nms_", "deform_")):
            log(f"  port kernel {e.self_device_time_total / 1000:9.3f} ms x{e.count:<5d} "
                f"{e.key[:90]}")
    if work.calls:
        log(f"  {path} profile: " + work.line(kernels))
    # the pool's backward launch by launch, in the order autograd ran them
    bwd = [e.self_device_time_total / 1000.0 for e in prof.events()
           if e.device_type == DeviceType.CUDA and "roi_pool_bwd_kernel" in e.name]
    log(f"  {path} profile: the pool's backward {sum(bwd):.3f} ms on the device in "
        f"{len(bwd)} launches ({', '.join(f'{t:.3f}' for t in bwd)} ms; "
        f"{100 * sum(bwd) / max(busy, 1e-9):.1f} % of the busy time)")
    fwd, bwd, opt = step_split(cfg, trainer.state, inputs, trainer.sampling,
                               trainer.drop_path)
    tot = fwd + bwd + opt
    log(f"  {path} split (host clock, synchronized): forward {1000 * fwd:.1f} ms "
        f"({100 * fwd / tot:.1f} %), backward {1000 * bwd:.1f} ms ({100 * bwd / tot:.1f} %), "
        f"optimizer {1000 * opt:.1f} ms ({100 * opt / tot:.1f} %)")
    # the pool's backward on this step's own ROIs and gradients, saved for
    # ``kernel_sweep.py roi_pool_bwd``
    if windows:
        wcalls = capture_windows(step)
        time_window_gather(results, path, wcalls)
        del wcalls
    calls = capture_pool_backward(step)
    if path == "train":
        save_pool_calls(calls, POOL_CALLS)
        log(f"  train: the step's {len(calls)} pool backward calls saved to {POOL_CALLS}")
    if more is not None:
        more(path, step, trainer.model)
    if after is not None:
        after(path, trainer.model, inputs, results)
    del trainer, inputs, step
    check_train_pool_backward(results, calls, path, pool_sizes)
    del calls
    torch.cuda.empty_cache()


def held_want(per_step, backward):
    """The kernel calls that ``HeldKernels`` holds in one train step of
    ``per_step``: the pool, NMS, window copy and deformable sampling; with
    ``backward`` the pool's backward and the deformable adjoint too."""
    kinds = ("roi_pool", "nms", "window_gather", "deform_conv")
    if backward:
        kinds += ("roi_pool_bwd", "deform_conv_bwd")
    return {k: per_step[k] for k in kinds if per_step[k]}


# a step of the deformable cascade: the cascade's pools and NMS, one
# sampling launch a deformable conv forward and one adjoint launch backward
DCN_TRAIN_PER_STEP = dict(CASCADE_TRAIN_PER_STEP, deform_conv=30, deform_conv_bwd=30)
DCN_MORE_STEPS = 3
# where phase ``train_dcn`` saves the adjoint's calls of two steps after
# ``offsets_on``: the traffic that ``kernel_ab.py`` times
DCN_CALLS = Path(__file__).resolve().parent / "output" / "chip_smoke_train_dcn" / \
    "adjoint_calls.pt"


def dcn_train_cfg(out_dir):
    """``dcn_cfg``'s model (the ResNeSt-101-FPN cascade, modulated deformable
    convs in res3-res5) with the AF interpolator trained (``MODEL.AFI_FREEZE
    False``); otherwise ``train_cfg``'s."""
    return train_cfg(out_dir, DCN_YAML, "MODEL.AFI_FREEZE", "False", *DCN_EDITS)


def dcn_held_step(path, what, step):
    """One step under ``HeldKernels`` (bf16, the backward too): the calls
    held must be a whole ``DCN_TRAIN_PER_STEP`` step; the metrics, and the
    share of the adjoint's corners that fell outside their tile's window."""
    import torch

    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.ops.kernels import deform_conv as dc

    reset_launches()
    dev = torch.device("cuda")
    dc.reset_spill(dev)
    with HeldKernels("bfloat16", backward=True) as held:
        m = step()
    spilled, corners = dc.spill_counts(dev)
    want = held_want(DCN_TRAIN_PER_STEP, True)
    if held.calls != want or any(LAUNCHES[k] != n for k, n in DCN_TRAIN_PER_STEP.items()):
        raise AssertionError(f"{path} {what}: held {held.calls}, launches {dict(LAUNCHES)}, "
                             f"expected {want}")
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"{path} {what}: a non-finite loss {m}")
    log(f"  {path} {what}: launches held against their plain versions: " + ", ".join(
        f"{k} x{n} max_abs_err {held.err[k]:.3e}" for k, n in held.calls.items())
        + f"; total_loss {m['total_loss']:.4f}; the adjoint's corners outside their tile's "
        f"window {spilled} of {corners} ({100 * spilled / max(corners, 1):.2f} %)")
    return m


def dcn_first_step(path, step, model):
    """The first step, from the zero-initialised offset predictors (every
    sample on a pixel, where the offsets' gradient is the forward
    difference): held; after it every offset predictor has moved."""
    preds = {k: p for k, p in model.named_parameters() if k.endswith("conv2_offset.weight")}
    if len(preds) != DCN_TRAIN_PER_STEP["deform_conv"] or any(
            bool(p.detach().any()) for p in preds.values()):
        raise AssertionError(f"{path}: {len(preds)} offset predictors, not all zero at init")
    dcn_held_step(path, "first step (offset predictors at zero)", step)
    still = [k for k, p in preds.items() if not p.detach().any()]
    if still:
        raise AssertionError(f"{path}: offset predictors still zero after a step {still[:4]}")


def dcn_verify(path, model, before, steps):
    """After the timed steps: every deformable conv's weight and offset
    predictor moved."""
    import torch

    after = model.state_dict()
    names = [k for k in after if k.endswith(("conv2_offset.weight", "conv2_offset.bias"))
             or (k.endswith("conv2.weight") and k[:-len("conv2.weight")] + "conv2_offset.weight"
                 in after)]
    still = [k for k in names if torch.equal(after[k], before[k])]
    if len(names) != 3 * DCN_TRAIN_PER_STEP["deform_conv"] or still:
        raise AssertionError(f"{path}: {len(names)} deformable parameters, unmoved {still[:4]}")
    log(f"  {path}: the {len(names) // 3} deformable convs' weights and offset predictors "
        f"(weight and bias) moved")


def dcn_offsets_on(path, step, model):
    """The offset predictors set off zero (``offsets_on``: taps moved by a
    few pixels, samples between pixels), one step held, then
    ``DCN_MORE_STEPS`` steps with their launches counted one by one: losses
    finite, ms a step (host clock to a synchronize), peak memory; one more
    step, and the adjoint's calls of the held step and of that one saved to
    ``DCN_CALLS`` for ``kernel_ab.py``."""
    import torch

    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    offsets_on(model)
    with AdjointCalls() as first:
        dcn_held_step(path, "step after offsets_on", step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(DCN_MORE_STEPS):
        reset_launches()
        t0 = time.perf_counter()
        m = step()
        torch.cuda.synchronize()
        ms.append(1000 * (time.perf_counter() - t0))
        wrong = {k: LAUNCHES[k] for k, n in DCN_TRAIN_PER_STEP.items() if LAUNCHES[k] != n}
        if wrong or not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{path} step {i} after offsets_on: launches {wrong}, "
                                 f"metrics {m}")
        losses.append(m["total_loss"])
    log(f"  {path} after offsets_on: {DCN_MORE_STEPS} steps, {DCN_TRAIN_PER_STEP['deform_conv']} "
        f"deform_conv and {DCN_TRAIN_PER_STEP['deform_conv_bwd']} deform_conv_bwd launches each; "
        f"ms a step {', '.join(f'{t:.1f}' for t in ms)}; total_loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with AdjointCalls() as later:
        step()
    calls = {"step after offsets_on": first.calls,
             f"step {DCN_MORE_STEPS + 2} after offsets_on": later.calls}
    if any(len(c) != DCN_TRAIN_PER_STEP["deform_conv_bwd"] for c in calls.values()):
        raise AssertionError(f"{path}: adjoint calls a step {[len(c) for c in calls.values()]}")
    DCN_CALLS.parent.mkdir(parents=True, exist_ok=True)
    torch.save(calls, DCN_CALLS)
    log(f"  {path}: the adjoint calls (offsets, masks, shapes) of the held step after "
        f"offsets_on and of one more step saved to {DCN_CALLS}")


class AdjointCalls:
    """Within the block, the deformable adjoint's calls recorded (``calls``):
    for each, what sets its work, x's shape and dtype, the offsets and the
    mask (values and element strides) and the conv's geometry; the values of
    x and of the columns' gradient, which set no part of it, are left out.
    Entered outside ``HeldKernels``, whose held calls then pass through it."""

    def __enter__(self):
        from afigan_tpu_torch.ops.kernels import deform_conv as dc

        self.calls, orig = [], dc.deform_col2im
        self._orig = orig

        def record(grad_cols, x, offsets, mask=None, *conv):
            self.calls.append({"x": (tuple(x.shape), str(x.dtype)[6:]),
                               "offsets": offsets.cpu(), "offsets_stride": offsets.stride(),
                               "mask": None if mask is None else mask.cpu(),
                               "mask_stride": None if mask is None else mask.stride(),
                               "conv": conv})
            return orig(grad_cols, x, offsets, mask, *conv)

        dc.deform_col2im = record
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.ops.kernels import deform_conv as dc

        dc.deform_col2im = self._orig


def phase_train_dcn(results):
    train_phase(results, "train_dcn", dcn_train_cfg, R50_CANVAS, DCN_TRAIN_PER_STEP,
                (7, 7, 7, 14), verify=dcn_verify, held_backward=True, first=dcn_first_step,
                more=dcn_offsets_on)


def proposal_train_cfg(out_dir):
    """The stage-3 YAML as a ProposalNetwork (``config.PROPOSAL_EDITS``: the
    backbone and the RPN alone, no masks) at full width; otherwise
    ``train_cfg``'s."""
    from afigan_tpu_torch.config import PROPOSAL_EDITS

    return train_cfg(out_dir, STEP3_YAML, *PROPOSAL_EDITS)


def proposal_verify(path, model, before, steps):
    """The RPN's two losses alone, and the RPN head and the trainable
    backbone moved over the steps."""
    import torch

    if set(steps[0]) != {"loss_rpn_cls", "loss_rpn_loc", "total_loss"}:
        raise AssertionError(f"{path}: losses {sorted(steps[0])}")
    after = model.state_dict()
    moved = [k for k, v in before.items() if not torch.equal(v, after[k])]
    for part in ("proposal_generator.rpn_head.", "backbone.fpn_", "backbone.bottom_up.res5."):
        if not any(k.startswith(part) for k in moved):
            raise AssertionError(f"{path}: nothing of {part} moved")
    if any(".stem." in k or ".res2." in k for k in moved):
        raise AssertionError(f"{path}: a frozen parameter (FREEZE_AT 2) moved")
    log(f"  {path}: {len(moved)} tensors moved over the steps, the RPN head's and the "
        f"backbone's; stem and res2 frozen")


def phase_train_proposals(results):
    train_phase(results, "train_proposals", proposal_train_cfg, R50_CANVAS,
                PROPOSAL_TRAIN_PER_STEP, (), verify=proposal_verify)


# the augmentation of phase train_aug: d2's instance-aware crop at
# relative_range 0.9, the colour jitter's default ranges, the repeat-factor
# sampler, the loader's four mapping threads. The threshold is LVIS's 0.001
# scaled to 16 images: at 0.001 a category must be in fewer than one image in
# a thousand to be repeated, so 16 scenes would repeat nothing; at 0.25 a
# category in one image of 16 is repeated twice
AUG_SCENES, AUG_REPEAT_THRESHOLD, AUG_STEPS = 16, 0.25, 12
AUG_EDITS = ["INPUT.CROP.ENABLED", "True", "INPUT.CROP.TYPE", "relative_range",
             "INPUT.CROP.SIZE", "(0.9, 0.9)", "INPUT.COLOR_JITTER.ENABLED", "True",
             "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
             "DATALOADER.REPEAT_THRESHOLD", str(AUG_REPEAT_THRESHOLD),
             "DATALOADER.NUM_WORKERS", "4", "DATASETS.TRAIN", "('chip_smoke_aug',)"]


def skewed_scenes(root):
    """``validate_training``'s generated 480x640 scenes (3 shape classes) with
    every object of all but the first image made class 1: classes 2 and 3
    stand in one image of 16. Returns (json, image dir)."""
    from afigan_tpu_torch.tools.validate_training import make_scene_coco

    json_path, img_dir = make_scene_coco(str(root), num_images=AUG_SCENES, hw=(480, 640))
    js = json.loads(Path(json_path).read_text())
    first = js["images"][0]["id"]
    for a in js["annotations"]:
        if a["image_id"] != first:
            a["category_id"] = js["categories"][0]["id"]
    Path(json_path).write_text(json.dumps(js))
    return json_path, img_dir


def phase_train_aug(results):
    """Stage-3 training of the R-50 YAML at full width over generated scenes
    whose classes are skewed, with crop, colour jitter and the repeat-factor
    sampler (``AUG_EDITS``) behind the loader's 4 mapping threads:
    ``train()`` for 2 iterations (its own loader, a checkpoint), then
    ``AUG_STEPS`` steps of the trainer's state, each on the next batch of a
    loader of the config: the first with its pool, pool-backward and NMS
    calls held against their plain versions (2 each), the others timed, the
    wait on the loader (data ms) beside the step's ms; every batch float32
    (jitter) on canvases of the crops' sizes; the rare image's repeats; 2
    pool launches each way and 2 NMS asserted at every step; losses finite,
    weights moved."""
    import shutil

    import torch

    from afigan_tpu_torch.data import build_train_loader, coco
    from afigan_tpu_torch.data.loader import RepeatFactorTrainingSampler
    from afigan_tpu_torch.engine.stage3 import batch_to_device, train_step
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    path = "train_aug"
    out_dir = Path(__file__).resolve().parent / "output" / f"chip_smoke_{path}"
    shutil.rmtree(out_dir, ignore_errors=True)
    json_path, img_dir = skewed_scenes(out_dir / "scenes")
    coco.register_coco_instances("chip_smoke_aug", json_path, img_dir)
    dataset = coco.get_dataset("chip_smoke_aug")
    cfg = train_cfg(out_dir, STEP3_YAML, *AUG_EDITS)
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    factors = RepeatFactorTrainingSampler(dataset.records, AUG_REPEAT_THRESHOLD).factors
    if not (factors.max() > 1.5 and (factors == 1.0).sum() == AUG_SCENES - 1):
        raise AssertionError(f"{path}: repeat factors {factors}")
    trainer = TargetDetectorTrainer(cfg, device="cuda")
    loader = build_train_loader(cfg, dataset, seed=cfg.SEED + 5)
    try:
        first = next(loader)
        n_bn = calibrate_frozen_bn(trainer.model, batch_to_device(first, "cuda")["image"])
        t0 = time.perf_counter()
        trainer.train()
        lines = [json.loads(x) for x in open(out_dir / "metrics.json")]
        if not (out_dir / "model_0000002.pth").is_file() or not all(
                np.isfinite(r["total_loss"]) for r in lines):
            raise AssertionError(f"{path} train(): no checkpoint or a non-finite loss: {lines}")
        log(f"  {path} train(): 2 iterations through its loader in "
            f"{time.perf_counter() - t0:.1f} s, total_loss {lines[-1]['total_loss']:.4f}, "
            f"data_time {lines[-1].get('data_time', float('nan')):.4f} s; {n_bn} FrozenBN "
            f"statistics calibrated; repeat factors {sorted(set(np.round(factors, 3)))}")
        before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        steps, data_ms, step_ms, canvases, ids = [], [], [], set(), []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(AUG_STEPS):
            t0 = time.perf_counter()
            batch = first if i == 0 else next(loader)
            t1 = time.perf_counter()
            if batch["image"].dtype != np.float32:
                raise AssertionError(f"{path}: a {batch['image'].dtype} batch under jitter")
            canvases.add(tuple(batch["image"].shape[1:3]))
            ids += [int(x) for x in batch["image_id"]]
            reset_launches()
            # the first step's kernel calls held against their plain versions
            # on this phase's own canvases (the crops' sizes); it is not timed
            held = HeldKernels("bfloat16", backward=True) if i == 0 else contextlib.nullcontext()
            with held:
                steps.append(train_step(cfg, trainer.state, batch_to_device(batch, "cuda"),
                                        trainer.sampling, trainer.drop_path))
                torch.cuda.synchronize()
            for k, want in TRAIN_PER_STEP.items():
                if LAUNCHES[k] != want:
                    raise AssertionError(f"{path} step {i}: {LAUNCHES[k]} launches of {k}, "
                                         f"expected {want}")
            if i == 0:  # its batch was taken before train(): no wait to read
                want = {"roi_pool": 2, "nms": 2, "roi_pool_bwd": 2}
                if held.calls != want:
                    raise AssertionError(f"{path}: held {held.calls}, expected {want}")
                log(f"  {path}: step 0's launches held against their plain versions: "
                    + ", ".join(f"{k} x{n_} max_abs_err {held.err[k]:.3e}"
                                for k, n_ in held.calls.items()))
                continue
            data_ms.append(1000 * (t1 - t0))
            step_ms.append(1000 * (time.perf_counter() - t1))
        for k in ("roi_pool", "roi_pool_bwd", "nms"):
            results[k].setdefault("launches", {})[path] = TRAIN_PER_STEP[k]
    finally:
        loader.close()
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{path} step {i}: a non-finite loss {m}")
    after = trainer.model.state_dict()
    moved = sum(not torch.equal(v, after[k]) for k, v in before.items())
    if not moved:
        raise AssertionError(f"{path}: no weight moved")
    rare = dataset.records[0]["image_id"]
    log(f"  {path}: {AUG_STEPS} steps, {len(step_ms)} timed: {np.median(step_ms):.1f} ms a "
        f"step (median; min "
        f"{min(step_ms):.1f}, max {max(step_ms):.1f}), data {np.median(data_ms):.1f} ms (median "
        f"wait on the loader; max {max(data_ms):.1f}), bf16, batch 2, canvases "
        f"{sorted(canvases)}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"the rare image {ids.count(rare)} times in {len(ids)} samples of {AUG_SCENES} images; "
        f"{moved} tensors moved; total_loss by step "
        + " ".join(f"{m['total_loss']:.4f}" for m in steps))
    del trainer
    torch.cuda.empty_cache()


# the narrow stage-3 config of the JAX package's train-step tests
NARROW_STAGE3 = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.MASK_ON", "True", "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16"]


def fixed_draws(shape, device):
    """The subsample keys of the card-vs-CPU steps: numpy draws keyed by the
    number of labels, the same on both devices."""
    import torch

    keys = np.random.RandomState(1000 + shape[-1]).rand(2, shape[-1]).astype(np.float32)
    return tuple(torch.from_numpy(np.broadcast_to(0.1 + 0.9 * k, shape).copy()).to(device)
                 for k in keys)


# the CenterMask YAML at the widths of tests/test_torch_port_centermask_train.py,
# its FCOS decode at threshold 0 so that the mask branch samples detections
NARROW_CENTERMASK = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI_FREEZE", "False",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.BIFPN.OUT_CHANNELS", "32",
    "MODEL.BIFPN.FPN_REPEAT", "2", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3",
    "MODEL.FCOS.INFERENCE_TH_TRAIN", "0.0", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "64",
    "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "16", "MODEL.PIXEL_STD", "(57.375, 57.12, 58.395)",
    "TPU.MAX_GT_BOXES", "8", "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]


def narrow_train_batch(h, w, m):
    """Two random-pixel images, m GT slots with the first two valid, masks."""
    rng = np.random.RandomState(0)
    boxes = np.zeros((2, m, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 32]
    boxes[:, 1] = [20, 24, 60, 56]
    return {"image": (rng.rand(2, h, w, 3) * 255).astype(np.float32),
            "image_sizes": np.asarray([[h, w]] * 2, np.int32),
            "gt": {"boxes": boxes, "classes": np.zeros((2, m), np.int32),
                   "valid": np.arange(m)[None].repeat(2, 0) < 2,
                   "masks": rng.rand(2, m, 28, 28).astype(np.float32)}}


@tf32_off()
def phase_train_card_vs_cpu(results):
    """One stage-3 step of a narrow float32 model (TF32 off) with the same
    weights (FrozenBN calibrated on the batch), batch and fixed subsample keys
    on the card and on the CPU: the losses at 1e-4 relative, each trainable
    gradient at 1e-3 of its largest entry (or 1e-5 of the largest of all).
    Four models: the R-50 stage-3 YAML (on the card the pool's forward and
    backward kernels at 2 launches each, 2 NMS), the CenterMask
    R-50-BiFPN YAML on 128x256 images (its mask pool's forward and backward
    at 32 channels, one launch each, and the FCOS decode's 2 NMS), the
    cascade of ``narrow_cascade_train_cfg`` (4 pool launches each way, 2 NMS)
    and the Swin cascade of ``narrow_swin_train_cfg`` on 128x128 images with
    the same DropPath masks on both devices (3 pool launches each way, 2 NMS,
    no LayerNorm or attention kernel: the training route); the batch-norm
    statistics that train (the CenterMask's BiFPN, every norm of the
    cascades) after the step at 1e-4 of each tensor's largest entry. Also
    the stage-3 YAML as a ProposalNetwork (2 NMS, no pool)."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(STEP3_YAML)
    cfg.merge_from_list(NARROW_STAGE3)
    stage3_card_vs_cpu("r50", cfg, narrow_train_batch(64, 64, 4), TRAIN_PER_STEP, 0)
    cfg = cfg_from_yaml(CENTERMASK_YAML)
    cfg.merge_from_list(NARROW_CENTERMASK)
    # the BiFPN's 6 + 8 a layer batch norms, mean and variance each
    stage3_card_vs_cpu("centermask", cfg, narrow_train_batch(128, 256, 8),
                       CENTERMASK_TRAIN_PER_STEP, 2 * (6 + 8 * cfg.MODEL.BIFPN.FPN_REPEAT))
    # every batch norm of the cascade trains: mean and variance each
    stage3_card_vs_cpu("cascade", narrow_cascade_train_cfg(), narrow_train_batch(64, 64, 4),
                       CASCADE_TRAIN_PER_STEP, None, small_residual_gamma)
    stage3_card_vs_cpu("swin", narrow_swin_train_cfg(), narrow_train_batch(128, 128, 4),
                       SWIN_TRAIN_PER_STEP, None, drop_path=FixedMasks)
    # the ProposalNetwork (the backbone and the RPN alone): 2 NMS, no pool
    from afigan_tpu_torch.config import PROPOSAL_EDITS

    cfg = cfg_from_yaml(STEP3_YAML)
    cfg.merge_from_list(NARROW_STAGE3 + PROPOSAL_EDITS)
    stage3_card_vs_cpu("proposals", cfg, narrow_train_batch(64, 64, 4),
                       PROPOSAL_TRAIN_PER_STEP, 0)


def narrow_swin_train_cfg():
    """The Swin cascade YAML at ``narrow_swin_cfg``'s widths (embed 32, depths
    2-2-2-2, window 4, BiFPN 2 x 32 with SyncBN, 4-conv box heads at 32, fc
    64) with the narrow stage-3 proposals and ROIs, no masks, float32, the AF
    interpolator trained, DropPath 0.2."""
    cfg = narrow_swin_cfg()
    cfg.merge_from_list(NARROW_STAGE3 + ["MODEL.MASK_ON", "False", "MODEL.AFI_FREEZE", "False"])
    return cfg


class FixedMasks:
    """A DropPath source handing out the same masks on every device: numpy
    draws from one seed in call order, kept with probability ``keep``."""

    def __init__(self):
        self.rs = np.random.RandomState(3)

    def __call__(self, shape, keep, device):
        import torch

        return torch.from_numpy(self.rs.rand(*shape) < keep).to(device)


def narrow_cascade_train_cfg():
    """The cascade YAML of ``train_cascade`` at ``narrow_resnest_cfg``'s widths
    with the narrow stage-3 proposals and ROIs, float32, the AF interpolator
    trained, over a ResNet-50 bottom-up with SyncBN
    (``build_resnet_pafpn_sr_backbone``). Not over the ResNeSt: at batch 2 its
    ``bn1`` normalises each channel over two pooled values, near-equal in
    some channel of some block, and a float32 step of the narrow ResNeSt
    differs from its own float64 step by 5e-2 in a loss and 1.5e3 times the
    gradient bound on the CPU alone (tests/test_torch_port_cascade_train.py
    holds ResNeSt's modules in training mode against JAX instead)."""
    cfg = narrow_resnest_cfg()
    cfg.merge_from_list(NARROW_STAGE3 + [
        "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.AFI_FREEZE", "False",
        "MODEL.BACKBONE.NAME", "build_resnet_pafpn_sr_backbone",
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "16"])
    return cfg


def small_residual_gamma(model):
    """Each bottleneck's last batch norm at a scale of 0.1 (the small-gamma
    residual init that ``tools/frozen_bn.py`` gives FrozenBN): random residual
    branches at full scale leave the deep gradients of a step so
    ill-conditioned that float32 summation order moves them past the bound
    (179 times it between the CPU's float32 and float64 steps of this model,
    0.005 times it with the small scale)."""
    import torch

    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("conv3.norm.weight") and ".bottom_up.res" in k:
                v.fill_(0.1)


def stage3_card_vs_cpu(name, cfg, batch, per_step, n_stats, prepare=None, drop_path=None):
    """``drop_path``: a class whose instance is each device's DropPath source."""
    import torch

    from afigan_tpu_torch.engine.stage3 import batch_to_device, init_stage3_state, loss_and_grads
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    out = {}
    for dev in ("cpu", "cuda"):
        state = init_stage3_state(cfg, dev, torch.Generator().manual_seed(1))
        if dev == "cpu":
            calibrate_frozen_bn(state.model, torch.from_numpy(batch["image"]))
            if prepare is not None:
                prepare(state.model)
            before = {k: v.clone() for k, v in state.model.state_dict().items()}
            if n_stats is None:
                n_stats = 2 * sum(len(v) for v in batch_norm_groups(state.model).values())
        else:
            state.model.load_state_dict(before)
        reset_launches()
        losses = loss_and_grads(cfg, state.model, batch_to_device(batch, dev), fixed_draws,
                                drop_path and drop_path())
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        out[dev] = ({k: float(v) for k, v in losses.items()}, grads,
                    {k: v.cpu() for k, v in state.model.state_dict().items()},
                    dict(LAUNCHES))
    (lc, gc, sc, _), (lg, gg, sg, launched) = out["cpu"], out["cuda"]
    for k, want in lc.items():
        np.testing.assert_allclose(lg[k], want, rtol=1e-4, atol=1e-7, err_msg=f"{name} {k}")
    if set(gg) != set(gc) or not gg:
        raise AssertionError(f"{name}: card and CPU train different parameters")
    # 1e-3 of each tensor's largest entry, or 1e-5 of the largest of all where
    # a tensor's sums cancel to far below their terms
    top = max(float(g.abs().max()) for g in gc.values())
    worst = 0.0
    for n, want in gc.items():
        bound = max(1e-3 * float(want.abs().max()), 1e-5 * top)
        err = float((gg[n] - want).abs().max())
        worst = max(worst, err / bound)
        if not err <= bound:
            raise AssertionError(f"{name} gradient {n}: {err} > {bound}")
    moved = [k for k in sc if "running_" in k and not torch.equal(sc[k], before[k])]
    if len(moved) != n_stats:
        raise AssertionError(f"{name}: {len(moved)} batch-norm statistics moved, expected "
                             f"{n_stats}")
    for k in moved:
        err = float((sg[k] - sc[k]).abs().max())
        if not err <= 1e-4 * float(sc[k].abs().max()):
            raise AssertionError(f"{name} statistic {k}: {err}")
    for k in ("roi_pool", "roi_pool_bwd", "nms"):
        if launched[k] != per_step[k]:
            raise AssertionError(f"{name} train card_vs_cpu: {launched[k]} launches of {k}, "
                                 f"expected {per_step[k]}")
    log(f"  {name} train card_vs_cpu: losses " + ", ".join(
        f"{k} {lg[k]:.6f} (cpu {lc[k]:.6f})" for k in lc)
        + f"; {len(gg)} trainable gradients, worst error {worst:.3f} of its bound; "
        f"{len(moved)} batch-norm statistics moved, equal; launches on the card "
        f"{json.dumps({k: v for k, v in launched.items() if v})}")


# ---------------------------------------------------------------------------
# stages 1 and 2: the GAN steps
# ---------------------------------------------------------------------------

STEP1_YAML = "step1_afigan_training/step1_afigan_mask_rcnn_R_50_FPN_1x.yaml"
STEP2_YAML = "step2_af_extractor_training/step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"
# per step: stage 1 launches no kernel of the port (the guide is plain ResNet +
# FPN, the generator trains through its unfused route, the discriminator is
# library convolutions); stage 2's detector launches stage 3's kernels
STAGE1_PER_STEP = {k: 0 for k in KERNELS}
STAGE2_PER_STEP = dict(STAGE1_PER_STEP, roi_pool=2, roi_pool_bwd=2, nms=2)
# FCOS over a BiFPN as the AF extractor: its training forward pools nothing
# and decodes nothing (no NMS), the guide is plain ResNet + BiFPN, the
# generator trains through its unfused route: no kernel of the port
STEP2_FCOS_YAML = "step2_af_extractor_training/step2_af_extractor_fcos_R_50_BiFPN.yaml"
FCOS_CANVAS = (1024, 1536)  # 800x1333 padded to 256 (dual scale): a 512x768 half
# stage → (YAML, full canvas, launches a step)
GAN_STAGES = {"stage1": (STEP1_YAML, R50_CANVAS, STAGE1_PER_STEP),
              "stage2": (STEP2_YAML, R50_CANVAS, STAGE2_PER_STEP),
              "stage2_fcos": (STEP2_FCOS_YAML, FCOS_CANVAS, STAGE1_PER_STEP),
              # stage 2 with config.KEYPOINT_EDITS: the box and the keypoint
              # pool (7x7, 14x14) both ways, the RPN's NMS an image
              "stage2_keypoint": (STEP2_YAML, R50_CANVAS, STAGE2_PER_STEP)}


def gan_cfg(yaml, out_dir, *extra):
    """A step-1 or step-2 YAML at full width (R-50-FPN guide, AF interpolator
    256 channels, 3 dense blocks of growth 32; stage 2's detector as stage
    3's with half-size anchors), bf16, batch 2, short side 800 (832x1344
    canvas, 416x672 half canvas); the YAML's lr at 8 images scaled to 2
    linearly, no warm-up."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(yaml)
    lr = cfg.SOLVER.BASE_LR * 2 / cfg.SOLVER.IMS_PER_BATCH
    cfg.merge_from_list([
        "TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", str(lr),
        "SOLVER.WARMUP_ITERS", "0", "INPUT.MIN_SIZE_TRAIN", "(800,)", "SEED", "0",
        "DATASETS.TRAIN", "('chip_smoke_train',)", "DATASETS.TEST", "()",
        "OUTPUT_DIR", str(out_dir), *extra])
    return cfg


def range_device_ms(prof, names):
    """The device time of the kernels that each record_function range of
    ``names`` launched in a profile (by the host time of the launching
    operator, the autograd thread's too), and of those outside every range:
    {name: ms}."""
    from torch.autograd import DeviceType

    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name in names and e.device_type == DeviceType.CPU]
    out = dict.fromkeys((*names, "outside"), 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        name = next((n for n, a, b in spans if a <= e.time_range.start <= b), "outside")
        out[name] += sum(k.duration for k in e.kernels) / 1000.0
    return out


def conv_device_time(prof):
    """The device time of a profiled call's convolutions by (operator, weight
    shape, kernel), largest first: [((op, weight, kernel), (us, launches))].
    The trace must have been taken with ``record_shapes``."""
    ops = ("aten::cudnn_convolution", "aten::convolution_backward")
    out = {}
    for e in prof.events():
        op = e
        while op is not None and op.name not in ops:  # the kernel's convolution
            op = op.cpu_parent
        if op is None or not e.kernels:
            continue
        shapes = op.input_shapes or []
        weight = shapes[1 if op.name == ops[0] else 2] if len(shapes) > 2 else "?"
        for k in e.kernels:
            key = (op.name[len("aten::"):], str(weight), k.name)
            us, n = out.get(key, (0.0, 0))
            out[key] = (us + k.duration, n + 1)
    return sorted(out.items(), key=lambda kv: -kv[1][0])


def step_tflop(step):
    """The operations of one call of ``step`` (forward and backward) that
    PyTorch's FLOP counter sees (convolutions, matrix products), in TFLOP."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        step()
    return fc.get_total_flops() / 1e12


def check_loaded(model, saved, prefix=""):
    """Each entry of ``saved`` (a checkpoint's path, or name → array) equals
    the model's under ``prefix`` + its name, on the card: their number."""
    import torch

    from afigan_tpu_torch.utils.converters import load_state_dict

    if not isinstance(saved, dict):
        saved = load_state_dict(str(saved))
    own = model.state_dict()
    for k, v in saved.items():
        got = own[prefix + k]
        if not (got.is_cuda and torch.equal(got.cpu(), torch.as_tensor(v))):
            raise AssertionError(f"{prefix + k}: not the checkpoint's value on the card")
    if not saved:
        raise AssertionError("an empty checkpoint")
    return len(saved)


def gan_phase(results, stage):
    """Stage 1 or 2 at full width through its trainer (``AFIGANTrainer``,
    ``AFExtractorTrainer``; ``stage`` a key of ``GAN_STAGES``): two iterations
    of ``train()`` over an in-memory dataset (dual-scale mapper, loader, hooks,
    both checkpoints), then the main path: ``TRAIN_WARMUP`` + ``TRAIN_TIMED``
    steps of the trainer's state on one repeated batch, launches counted per
    step, every loss finite, G (stage 1) or the detector (stage 2) and D
    moved, and the running statistics of the detector's batch norms that
    train (the FCOS BiFPN's), no gradient left on D; ms per step, images/s,
    peak memory, one profiled step (device busy share, and its guide / G or
    detector / D step / G step split by the step's record_function ranges)
    and the operations of a step against the tensor cores' peak. Stage 2 of
    the R-50 starts from the stage-1 phase's checkpoints and hands its own AF
    interpolator to a stage-3 trainer, each load held equal to its file on
    the card; it then holds the pool's backward on one step's own ROIs
    against its plain version. ``stage2_keypoint``: stage 2 with
    ``config.KEYPOINT_EDITS`` (17 COCO keypoints an object, flipped through
    their left/right permutation, one class; the half-scale keypoints reach
    the detector), from no stage-1 checkpoint; its keypoint pool runs both
    ways, held as the R-50's pools are."""
    import json as _json
    import shutil
    import types

    import torch

    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
    from afigan_tpu_torch.data.loader import collate_batch, required_size_divisibility
    from afigan_tpu_torch.engine import stage1, stage2
    from afigan_tpu_torch.engine.checkpoint import AFI_PREFIX
    from afigan_tpu_torch.engine.trainers import (AFExtractorTrainer, AFIGANTrainer,
                                                  TargetDetectorTrainer)
    from afigan_tpu_torch.models.layers import BatchNorm2d
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn
    from afigan_tpu_torch.tools.kernel_sweep import capture_pool_backward
    from afigan_tpu_torch.utils.converters import load_state_dict

    from afigan_tpu_torch.config import KEYPOINT_EDITS

    s1, handoff = stage == "stage1", stage == "stage2"
    keypoints = 17 if stage == "stage2_keypoint" else 0
    pools = stage in ("stage2", "stage2_keypoint")  # the detector pools, both ways
    mod = stage1 if s1 else stage2
    yaml, canvas, per_step = GAN_STAGES[stage]
    half = (canvas[0] // 2, canvas[1] // 2)
    out_dir = Path(__file__).resolve().parent / "output" / f"chip_smoke_{stage}"
    shutil.rmtree(out_dir, ignore_errors=True)
    hflip = COCO_KEYPOINT_HFLIP[:keypoints] if keypoints else None
    records = train_records(torch.Generator().manual_seed(7), n_keypoints=keypoints,
                            n_classes=1 if keypoints else 80)
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(
        records=records, keypoint_hflip_indices=hflip))
    cfg = gan_cfg(yaml, out_dir, *(KEYPOINT_EDITS if keypoints else ()))
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    mapper = DatasetMapper(cfg, is_train=True, seed=0, dual_scale=True,
                           keypoint_hflip_indices=hflip)
    batch = collate_batch([mapper(r) for r in records], cfg.TPU.IMAGE_BUCKETS,
                          required_size_divisibility(cfg, dual_scale=True), dual_scale=True)
    canvases = (tuple(batch["image"].shape[1:3]), tuple(batch["image_x0.5"].shape[1:3]))
    if canvases != (canvas, half):
        raise AssertionError(f"{stage}: canvases {canvases} != {(canvas, half)}")
    if handoff:  # the hand-off from stage 1: the stage-1 phase's G and D
        s1_dir = out_dir.parent / "chip_smoke_stage1"
        handed = {"G": s1_dir / "G_0" / "model_0000002.pth",
                  "D": s1_dir / "D_0" / "model_0000002.pth"}
        cfg.MODEL.AFI_GEN_WEIGHTS, cfg.MODEL.AFI_DIS_WEIGHTS = map(str, handed.values())
    t0 = time.perf_counter()
    trainer = (AFIGANTrainer if s1 else AFExtractorTrainer)(cfg, device="cuda")
    state = trainer.state
    if handoff:
        n = check_loaded(state.model, handed["G"], AFI_PREFIX)
        n += check_loaded(state.discriminator, handed["D"])
        log(f"  stage2: the stage-1 phase's G_0/ and D_0/ checkpoints loaded on the card "
            f"({n} tensors equal to the files)")
    inputs = mod.batch_to_device(batch, "cuda")
    n_bn = calibrate_frozen_bn(state.guide, inputs["image"])
    if not s1:
        n_bn += calibrate_frozen_bn(state.model, inputs["image_x0.5"])
    draws = None if s1 else trainer.sampling
    trainer.train()
    lines = [_json.loads(x) for x in open(out_dir / "metrics.json")]
    ckpts = [out_dir / d / "model_0000002.pth"
             for d in (("G_0", "D_0") if s1 else ("AFExtractor", "Disc"))]
    key = "g_loss" if s1 else "total_loss"
    if not all(c.is_file() for c in ckpts) or not all(np.isfinite(r[key]) for r in lines):
        raise AssertionError(f"{stage} train(): no checkpoint or a non-finite loss: {lines}")
    if handoff:  # the hand-off to stage 3: this phase's AF interpolator
        cfg3 = train_cfg(out_dir / "stage3")
        cfg3.MODEL.AF_EXTRACTOR_WEIGHTS = str(ckpts[0])
        t3 = TargetDetectorTrainer(cfg3, device="cuda")
        afi = {k: v for k, v in load_state_dict(cfg3.MODEL.AF_EXTRACTOR_WEIGHTS).items()
               if k.startswith(AFI_PREFIX)}
        n = check_loaded(t3.model, afi)
        log(f"  stage2: a stage-3 trainer took {ckpts[0].parent.name}/{ckpts[0].name}'s AF "
            f"interpolator on the card ({n} tensors equal to the file)")
        del t3
    trained = state.generator if s1 else state.model
    n_train = sum(p.numel() for p in trained.parameters() if p.requires_grad) / 1e6
    n_disc = sum(p.numel() for p in state.discriminator.parameters()) / 1e6
    log(f"  {stage} train(): 2 iterations through the loader in "
        f"{time.perf_counter() - t0:.1f} s (build included), {key} {lines[-1][key]:.4f}; "
        f"{n_train:.2f}M trainable parameters of {'G' if s1 else 'the detector'}, "
        f"{n_disc:.2f}M of D; {n_bn} FrozenBN statistics calibrated on the batch")

    def tensors():  # G (stage 1) or the detector's trainable tensors, D's, and
        # the running statistics of the detector's batch norms that train
        return {**{"G." + n: p for n, p in trained.named_parameters() if p.requires_grad},
                **{"D." + n: p for n, p in state.discriminator.named_parameters()},
                **{"S." + n: b for n, b in trained.named_buffers()
                   if "running_" in n and isinstance(trained.get_submodule(
                       n.rsplit(".", 1)[0]), BatchNorm2d)}}

    before = {k: v.detach().clone() for k, v in tensors().items()}

    def step():
        return mod.train_step(cfg, state, inputs, *(() if s1 else (draws,)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    steps, ms, ev = timed_steps(step)
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = len(steps)
    if pools:  # one more step: the bounds of its launches
        with BoundCapture() as bounds:
            step()
        bounds.log(f"{stage}, one step")
    log(f"  {stage}: launches in {n} steps " + _json.dumps(counts))
    for k, per in per_step.items():
        if counts[k] != per * n:
            raise AssertionError(f"{stage}: {counts[k]} launches of {k} in {n} steps, "
                                 f"expected {per} per step")
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{stage} step {i}: a non-finite loss {m}")
    log(f"  {stage}: {key} by step " + " ".join(f"{m[key]:.4f}" for m in steps))
    log(f"  {stage}: first / last step " + ", ".join(
        f"{k} {steps[0][k]:.4f} / {steps[-1][k]:.4f}" for k in steps[0]))
    now = tensors()
    moved = {k: not torch.equal(v, now[k]) for k, v in before.items()}
    for side in ("G", "D"):
        if not any(v for k, v in moved.items() if k.startswith(side + ".")):
            raise AssertionError(f"{stage}: {side} did not change over {n} steps")
    # the FCOS BiFPN: 6 norms before its layers and 8 a layer, 2 statistics each
    n_stats = sum(k.startswith("S.") for k in before)
    if n_stats != (2 * (6 + 8 * cfg.MODEL.BIFPN.FPN_REPEAT) if stage == "stage2_fcos" else 0):
        raise AssertionError(f"{stage}: {n_stats} running statistics of batch norm that trains")
    stuck = [k for k in before if k.startswith("S.") and not moved[k]]
    if stuck:
        raise AssertionError(f"{stage}: running statistics that did not move: {stuck[:4]}")
    if any(p.grad is not None for p in state.discriminator.parameters()):
        raise AssertionError(f"{stage}: a gradient is left on D after the step")
    med = float(np.median(ms))
    log(f"  {stage}: {med:.1f} ms per step of 2 images (median of {len(ms)}; min "
        f"{min(ms):.1f}, max {max(ms):.1f}), {2000 / med:.3f} images/s at the median, "
        f"by CUDA events {np.median(ev):.1f} ms ({min(ev):.1f}-{max(ev):.1f}), "
        f"{canvas[0]}x{canvas[1]} canvas and its {half[0]}x{half[1]} "
        f"half, bf16, lr {cfg.SOLVER.BASE_LR}; peak memory {peak:.2f} GiB; "
        f"{sum(moved.values())} of {len(moved)} tensors of {'G' if s1 else 'the detector'}, "
        f"D and {n_stats} batch-norm statistics moved, no gradient left on D")
    if keypoints:
        kp = [m["loss_keypoint"] for m in steps]
        if inputs["gt_x0.5"].keypoints is None or not min(kp) > 0:
            raise AssertionError(f"{stage}: loss_keypoint {kp}")
        with HeldKernels("bfloat16", backward=True) as held:
            step()
        want = {"roi_pool": 2, "nms": 2, "roi_pool_bwd": 2}
        if held.calls != want:
            raise AssertionError(f"{stage}: held {held.calls}, expected {want}")
        log(f"  {stage}: one step's launches held against their plain versions: " + ", ".join(
            f"{k} x{n_} max_abs_err {held.err[k]:.3e}" for k, n_ in held.calls.items()))
    if pools:
        for k in ("roi_pool", "roi_pool_bwd", "nms"):
            results[k].setdefault("launches", {})[stage] = counts[k] // n

    # one step under the profiler (stage 1 launches no kernel of the port, so
    # a session with no device event at all is the lost-records case)
    walls = []

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    for session in range(3):
        reset_launches()
        prof, kernels, _, whole = device_events(timed_step, device_kernels(per_step))
        wall = walls[-1]
        kernels = [k for k in kernels if k[0] not in RANGES]
        busy = sum(k[1] for k in kernels) / 1000.0
        if whole and busy > 0:
            break
        log(f"  {stage} profile: session {session + 1} of 3 has no whole trace")
    log(f"  {stage} profile: wall {1000 * wall:.1f} ms (profiler on), device busy {busy:.1f} "
        f"ms ({100 * busy / (1000 * wall):.1f} % of wall), {sum(k[2] for k in kernels)} "
        "device kernels")
    for name, us, count in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"  kernel {us / 1000:9.3f} ms x{count:<5d} {name[:90]}")
    for name, us, count in kernels:
        if any(p in name for p in PORT_KERNELS):
            log(f"  port kernel {us / 1000:9.3f} ms x{count:<5d} {name[:90]}")
    # the convolutions by weight shape, in a session of their own: recording
    # the shapes slows the host, and the busy share above is read without it
    prof = device_events(step, device_kernels(per_step), record_shapes=True)[0]
    for (op, weight, kernel), (us, count) in conv_device_time(prof)[:10]:
        log(f"  conv {us / 1000:9.3f} ms x{count:<4d} {op} weight {weight} {kernel[:60]}")
    # the step's parts, each the device time of what its range launched
    parts = range_device_ms(prof, STEP_RANGES[stage])
    log(f"  {stage} split (device time by the step's record_function ranges): " + ", ".join(
        f"{nm} {t:.1f} ms ({100 * t / busy:.1f} %)" for nm, t in parts.items()))
    tflop = step_tflop(step)
    bound = 1000 * tflop * 1e12 / PEAK_OPS_PER_S["bfloat16"]
    log(f"  {stage}: {tflop:.2f} TFLOP a step (convolutions and products, forward and "
        f"backward, PyTorch's FLOP counter): at least {bound:.1f} ms at 989 TFLOP/s "
        f"(bf16); the median step is {med / bound:.2f}x that")
    if pools:
        calls = capture_pool_backward(step)
        del trainer, state, inputs
        check_train_pool_backward(results, calls, path=stage)
        del calls
    torch.cuda.empty_cache()


def phase_stage1(results):
    gan_phase(results, "stage1")


def phase_stage2(results):
    gan_phase(results, "stage2")


def phase_stage2_fcos(results):
    gan_phase(results, "stage2_fcos")


def phase_stage2_keypoint(results):
    gan_phase(results, "stage2_keypoint")


# the narrow configs of the CPU tests tests/test_torch_port_stage{1,2}.py
NARROW_GAN = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.AFI.IN_CHANNELS", "16", "MODEL.AFI.N_RDB", "1",
    "MODEL.AFI.GROWTH_RATE", "8", "MODEL.FPN.OUT_CHANNELS", "16",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]
# the FCOS step-2 YAML at the widths of tests/test_torch_port_fcos_train.py:
# ResNet-50 at an eighth of its widths, BiFPN 2 x 32, one tower conv
NARROW_FCOS = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
    "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2",
    "MODEL.AFI.IN_CHANNELS", "32", "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3",
    "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "0"]
# stage → (YAML, narrow config, full canvas)
# stage 2 with config.KEYPOINT_EDITS at the widths of
# tests/test_torch_port_stage2_keypoint.py: 3 keypoints, two 16-channel convs
NARROW_KEYPOINT = ["MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS", "3",
                   "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(16, 16)",
                   "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32"]
NARROW_STAGES = {"stage1": (STEP1_YAML, NARROW_GAN, (128, 128)),
                 "stage2": (STEP2_YAML, NARROW_GAN, (256, 256)),
                 "stage2_fcos": (STEP2_FCOS_YAML, NARROW_FCOS, (256, 512)),
                 "stage2_keypoint": (STEP2_YAML, NARROW_GAN, (256, 256))}


def gan_narrow_run(stage, dev, cpu_state=None, scale=1.0):
    """One narrow float32 step of ``stage`` on ``dev``: weights from a seeded
    generator with the FrozenBN statistics calibrated on the batch (on the
    CPU), or ``cpu_state``'s; the x0.5 images times ``scale``. Returns
    (metrics, {name: gradient}, D's state dict after the step and the
    trained model's running statistics, the state dicts before it, the
    wrappers' launch counts). The FCOS step's images are noise over a ramp
    of their own direction each: its p7 is 1x2 an image, and D's batch norm
    over the noise of two alike images is ill-conditioned."""
    import torch

    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.engine import stage1, stage2
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    from afigan_tpu_torch.config import KEYPOINT_EDITS

    s1 = stage == "stage1"
    mod = stage1 if s1 else stage2
    yaml, narrow, (h, w) = NARROW_STAGES[stage]
    cfg = cfg_from_yaml(yaml)
    cfg.merge_from_list(narrow)
    if stage == "stage2_keypoint":
        cfg.merge_from_list(KEYPOINT_EDITS + NARROW_KEYPOINT)
    img = (np.random.RandomState(5).rand(2, h, w, 3) * 255).astype(np.float32)
    if stage == "stage2_fcos":
        img = img / 2
        img[0] += 128 * np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
        img[1] += 128 * np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None]
    half = img.reshape(2, h // 2, 2, w // 2, 2, 3).mean(axis=(2, 4)) * np.float32(scale)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 32]
    boxes[:, 1] = [20, 24, 60, 56]
    batch = {"image": img, "image_x0.5": half,
             "image_sizes_x0.5": np.asarray([[h // 2, w // 2]] * 2, np.int32),
             "gt_x0.5": {"boxes": boxes, "classes": np.zeros((2, 4), np.int32),
                         "valid": np.array([[True, True, False, False]] * 2),
                         "masks": np.random.RandomState(6).rand(2, 4, 28, 28).astype(np.float32)}}
    if stage == "stage2_keypoint":  # 3 keypoints over each box, one invisible
        gt = batch["gt_x0.5"]
        del gt["masks"]
        u = np.random.RandomState(11).rand(2, 4, 3, 2).astype(np.float32)
        kp = np.concatenate([boxes[:, :, None, :2] + u * (boxes[:, :, None, 2:] -
                                                          boxes[:, :, None, :2]),
                             np.full((2, 4, 3, 1), 2.0, np.float32)], -1)
        kp[:, 0, 1] = 0.0
        gt["keypoints"] = kp * gt["valid"][:, :, None, None]
    state = mod.init_stage1_state(cfg, dev, torch.Generator().manual_seed(1)) if s1 else \
        mod.init_stage2_state(cfg, dev, torch.Generator().manual_seed(1))
    trained = state.generator if s1 else state.model
    modules = {"guide": state.guide, "trained": trained, "D": state.discriminator}
    if cpu_state is None:
        calibrate_frozen_bn(state.guide, torch.from_numpy(img))
        if not s1:
            calibrate_frozen_bn(state.model, torch.from_numpy(half))
    else:
        for k, m in modules.items():
            m.load_state_dict(cpu_state[k])
    sd = {k: {n: v.detach().cpu().clone() for n, v in m.state_dict().items()}
          for k, m in modules.items()}
    grads = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: grads.__setitem__(n, p.grad.detach().cpu().clone()))
        for n, p in [*(("G." + n, p) for n, p in trained.named_parameters() if p.requires_grad),
                     *(("D." + n, p) for n, p in state.discriminator.named_parameters())]]
    reset_launches()
    try:
        metrics = mod.train_step(cfg, state, mod.batch_to_device(batch, dev),
                                 *(() if s1 else (fixed_draws,)))
    finally:
        for h in hooks:
            h.remove()
    d_after = {n: v.cpu() for n, v in state.discriminator.state_dict().items()}
    d_after.update({"S." + n: v.cpu() for n, v in trained.named_buffers() if "running_" in n})
    return metrics, grads, d_after, sd, dict(LAUNCHES)


# the detector's gradients that may be held to the CPU's spread
DEEP_RESNET = tuple(f"G.backbone.bottom_up.res{i}." for i in (3, 4, 5))


@tf32_off()
def phase_stage12_card_vs_cpu(results):
    """One step of each stage at the CPU tests' narrow widths, float32 (TF32
    off), on the card and on the CPU from the same weights, batch and (stage
    2) subsample keys: the metrics at 1e-4 relative; each gradient (G or the
    detector, and D's) at 1e-3 of its largest entry, or 1e-5 of the largest
    of all, or (stage 2, the ResNet's res3-res5 alone, each such tensor
    logged) twice the CPU's own spread under a 1 + 1e-6 scale of the x0.5
    images, at most 5e-3 of its largest entry, where the random detector's
    deep gradients are that ill conditioned; D's statistics (and those of the
    FCOS BiFPN's batch norms) after the step at 1e-4 of each tensor's largest
    entry. Stage 2 runs twice: the R-50 step-2 YAML, whose detector launches
    the pool's forward and backward kernels and NMS on the card (2 each), and
    the FCOS R-50-BiFPN step-2 YAML, which launches none; and the R-50
    step-2 YAML with ``config.KEYPOINT_EDITS`` (narrow keypoint head), whose
    box and keypoint pools run both ways on the card."""
    for stage in ("stage1", "stage2", "stage2_fcos", "stage2_keypoint"):
        per = GAN_STAGES[stage][2]
        mc, gc, dc, sd, _ = gan_narrow_run(stage, "cpu")
        mg, gg, dg, _, launched = gan_narrow_run(stage, "cuda", sd)
        spread = {}
        if stage != "stage1":
            _, g2, _, _, _ = gan_narrow_run(stage, "cpu", sd, scale=1.0 + 1e-6)
            spread = {n: float((g2[n] - g).abs().max()) for n, g in gc.items()}
        for k, want in mc.items():
            np.testing.assert_allclose(mg[k], want, rtol=1e-4, atol=1e-7, err_msg=f"{stage} {k}")
        if set(gg) != set(gc) or not gg:
            raise AssertionError(f"{stage}: card and CPU train different parameters")
        top = max(float(g.abs().max()) for g in gc.values())
        worst = 0.0
        for name, want in gc.items():
            largest = float(want.abs().max())
            bound = max(1e-3 * largest, 1e-5 * top)
            err = float((gg[name] - want).abs().max())
            if err > bound and name in spread:
                if not name.startswith(DEEP_RESNET):
                    raise AssertionError(f"{stage} gradient {name}: {err} > {bound}, and only "
                                         "res3-res5 may be held to the spread")
                bound = min(2 * spread[name], 5e-3 * largest)
                log(f"  {stage} card_vs_cpu: {name} held to the CPU's spread: error "
                    f"{err / largest:.2e}, bound {bound / largest:.2e} of its largest entry")
            worst = max(worst, err / bound)
            if not err <= bound:
                raise AssertionError(f"{stage} gradient {name}: {err} > {bound}")
        for name, want in dc.items():
            if "running_" in name:
                err = float((dg[name] - want).abs().max())
                if not err <= 1e-4 * float(want.abs().max()):
                    raise AssertionError(f"{stage} statistic {name}: {err}")
        for k, n in per.items():
            if launched[k] != n:
                raise AssertionError(f"{stage} card_vs_cpu: {launched[k]} launches of {k}, "
                                     f"expected {n}")
        log(f"  {stage} card_vs_cpu: " + ", ".join(
            f"{k} {mg[k]:.6f} (cpu {mc[k]:.6f})" for k in list(mc)[:6])
            + f", ...; {len(gg)} gradients, worst error {worst:.3f} of its bound; D "
            f"statistics within 1e-4; launches on the card "
            f"{json.dumps({k: v for k, v in launched.items() if v})}")


# ---------------------------------------------------------------------------
# data parallel: ranks through engine/launch.py
# ---------------------------------------------------------------------------

# two ranks share the one card over gloo (NCCL refuses two ranks on one
# device; gloo stages every collective through the host, so these times are
# not NCCL's); 2 images a rank, as phase train's batch
DDP_WORLD, DDP_TIMED, DDP_TIMEOUT_S = 2, 8, 300
DDP_ONE_RANK_STEPS = 3


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests, equal bits."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _trainable(opt):
    return [p for g in opt.param_groups for p in g["params"] if p.requires_grad]


def ddp_stage3_rank(out_dir: Path, world: int, profiled: bool):
    """One rank of phase ``train_ddp`` (a): ``TargetDetectorTrainer`` on the
    R-50 step-3 YAML at full width, ``IMS_PER_BATCH`` 2 a rank; two
    iterations of ``train()`` with its loader, checkpoints and writer
    watched, then ``TRAIN_WARMUP`` + ``DDP_TIMED`` steps on the rank's own
    batches of its shard loader, each step's launches counted on their own.
    The first step's local gradients are gathered to check the reduce; the
    gradient reduce of the timed steps is timed on its own (synchronized).
    ``profiled``: one more step under the profiler, its NCCL device kernels
    and ops kept. Returns what the parent checks."""
    import types

    import torch

    from afigan_tpu_torch import parallel
    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
    from afigan_tpu_torch.data.loader import build_train_loader, collate_batch
    from afigan_tpu_torch.engine import events, stage3, trainers
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    r = parallel.rank()
    records = train_records(torch.Generator().manual_seed(7), n_img=4 * world)
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(records=records))
    cfg = train_cfg(out_dir / "stage3", STEP3_YAML, "SOLVER.IMS_PER_BATCH", str(2 * world),
                    "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2")
    seen = {"train_ids": [], "saved": [], "json_lines": 0}
    build_loader, save, write = (trainers.build_train_loader, trainers.save_checkpoint,
                                 events.JSONWriter.write)

    def loader(*a, **kw):  # a generator: the trainer's close() ends it and the loader
        inner = build_loader(*a, **kw)
        try:
            for b in inner:
                seen["train_ids"].append(sorted(int(i) for i in b["image_id"]))
                yield b
        finally:
            inner.close()

    def saving(directory, iteration, *a, **kw):
        seen["saved"].append(iteration)
        return save(directory, iteration, *a, **kw)

    def writing(self, storage):
        seen["json_lines"] += 1
        return write(self, storage)

    trainer = trainers.TargetDetectorTrainer(cfg, device="cuda")
    # the frozen statistics from the first two records on every rank, then
    # rank 0's model on every rank
    mapper = DatasetMapper(cfg, is_train=True, seed=0)
    calib = collate_batch([mapper(x) for x in records[:2]], cfg.TPU.IMAGE_BUCKETS, 64)
    calibrate_frozen_bn(trainer.model, stage3.batch_to_device(calib, "cuda")["image"])
    parallel.broadcast_module_(trainer.model)
    trainers.build_train_loader, trainers.save_checkpoint = loader, saving
    events.JSONWriter.write = writing
    try:
        trainer.train()
    finally:
        trainers.build_train_loader, trainers.save_checkpoint = build_loader, save
        events.JSONWriter.write = write

    shard = build_train_loader(cfg, coco.get_dataset("chip_smoke_train"), seed=trainer.seed,
                               shard_id=r, num_shards=world)
    batches = [next(shard) for _ in range(TRAIN_WARMUP + DDP_TIMED + profiled)]
    state, params = trainer.state, _trainable(trainer.state.optimizer)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    local = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p: local.__setitem__(names[id(p)], p.grad.float().cpu().numpy().copy()))
        for p in params]
    reduce_ms, real_reduce = [], stage3.mean_grads_

    def timed_reduce(ps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(ps)
        torch.cuda.synchronize()
        reduce_ms.append(1000 * (time.perf_counter() - t0))

    stage3.mean_grads_ = timed_reduce
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps, host, launches, reduced_check = [], [], [], None
    try:
        for i, b in enumerate(batches[:TRAIN_WARMUP + DDP_TIMED]):
            inputs = stage3.batch_to_device(b, "cuda")
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            steps.append(stage3.train_step(cfg, state, inputs, trainer.sampling,
                                           trainer.drop_path))
            torch.cuda.synchronize()
            host.append(1000 * (time.perf_counter() - t0))
            launches.append({k: v for k, v in LAUNCHES.items() if v})
            if i == 0:
                for h in hooks:
                    h.remove()
                reduced = {names[id(p)]: p.grad.float().cpu().numpy()
                           for p in params if p.grad is not None}
                both = parallel.all_gather_objects(local)
                worst = 0.0
                if set(reduced) != set(both[0]) | set(both[1]):
                    raise AssertionError("train_ddp: the reduced gradients are not those the "
                                         "ranks computed")
                for n, g in reduced.items():
                    mean = sum(x.get(n, np.zeros_like(g)) for x in both) / world
                    err = float(np.abs(g - mean).max()) / max(float(np.abs(mean).max()), 1e-30)
                    worst = max(worst, err)
                if worst > 1e-6:
                    raise AssertionError(f"train_ddp: a reduced gradient is {worst:.2e} of its "
                                         "largest entry off the mean of the ranks' gradients")
                differ = sum(not np.array_equal(both[0][n], both[1][n])
                             for n in both[0] if n in both[1])
                reduced_check = {"tensors": len(reduced), "worst": worst, "differ": differ,
                                 "skipped": len(params) - len(reduced)}
                del both, reduced, local
    finally:
        stage3.mean_grads_ = real_reduce
    nccl = {"kernels": [], "ops": []}
    if profiled:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        inputs = stage3.batch_to_device(batches[-1], "cuda")
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps.append(stage3.train_step(cfg, state, inputs, trainer.sampling,
                                           trainer.drop_path))
            torch.cuda.synchronize()
        launches.append({k: v for k, v in LAUNCHES.items() if v})
        for kind, dev in (("kernels", DeviceType.CUDA), ("ops", DeviceType.CPU)):
            nccl[kind] = sorted({e.key for e in prof.key_averages()
                                 if e.device_type == dev and "nccl" in e.key.lower()})
    elems = sum(p.numel() for p in params) + len(params)
    return {"rank": r, "metrics": steps, "ms": host[TRAIN_WARMUP:],
            "reduce_ms": reduce_ms[TRAIN_WARMUP:], "reduce_bytes": 4 * elems,
            "ids": [sorted(int(i) for i in b["image_id"]) for b in batches],
            "launches": launches, "nccl": nccl, "reduced_check": reduced_check, **seen,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "params": _digest(trainer.model.parameters()), "n_steps": len(batches),
            "trainable": sum(p.numel() for p in params)}


def ddp_stage1_rank(out_dir: Path, world: int):
    """One rank of phase ``train_ddp`` (b): ``AFIGANTrainer`` on the step-1
    YAML at full width, 2 images a rank from its shard loader, 3 steps: the
    metrics, whether D's running statistics moved, and digests of G and D
    (parameters and statistics)."""
    import types

    import torch

    from afigan_tpu_torch import parallel
    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
    from afigan_tpu_torch.data.loader import (build_train_loader, collate_batch,
                                              required_size_divisibility)
    from afigan_tpu_torch.engine import stage1
    from afigan_tpu_torch.engine.trainers import AFIGANTrainer
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    r = parallel.rank()
    records = train_records(torch.Generator().manual_seed(7), n_img=4 * world)
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(records=records))
    cfg = gan_cfg(STEP1_YAML, out_dir / "stage1")
    cfg.SOLVER.IMS_PER_BATCH = 2 * world
    trainer = AFIGANTrainer(cfg, device="cuda")
    state = trainer.state
    mapper = DatasetMapper(cfg, is_train=True, seed=0, dual_scale=True)
    calib = collate_batch([mapper(x) for x in records[:2]], cfg.TPU.IMAGE_BUCKETS,
                          required_size_divisibility(cfg, dual_scale=True), dual_scale=True)
    calibrate_frozen_bn(state.guide, stage1.batch_to_device(calib, "cuda")["image"])
    parallel.broadcast_module_(state.guide)
    shard = build_train_loader(cfg, coco.get_dataset("chip_smoke_train"), seed=trainer.seed,
                               dual_scale=True, shard_id=r, num_shards=world)
    stats = {n: b.clone() for n, b in state.discriminator.named_buffers() if "running_" in n}
    steps, ids = [], []
    for _ in range(3):
        b = next(shard)
        ids.append(sorted(int(i) for i in b["image_id"]))
        steps.append(stage1.train_step(cfg, state, stage1.batch_to_device(b, "cuda")))
    moved = sum(not torch.equal(b, stats[n]) for n, b in state.discriminator.named_buffers()
                if n in stats)
    return {"metrics": steps, "ids": ids, "stats": len(stats), "stats_moved": moved,
            "G": _digest(state.generator.state_dict().values()),
            "D": _digest(state.discriminator.state_dict().values())}


def ddp_rank_main(out_dir: str, world: int, profiled: bool):
    """A rank of phase ``train_ddp`` (or of ``--ddp-cards``): (a) and (b),
    its results to ``<out_dir>/rank<r>.json``."""
    from afigan_tpu_torch import parallel

    out = Path(out_dir)
    res = {"stage3": ddp_stage3_rank(out, world, profiled),
           "stage1": ddp_stage1_rank(out, world)}
    with open(out / f"rank{parallel.rank()}.json", "w") as f:
        json.dump(res, f)


def ddp_one_rank(out_dir: Path):
    """(c) In this process: (a)'s trainer on one rank, 2 images, with
    torch's deterministic algorithms (cuDNN's, and a sorted indexing backward
    in place of atomics): ``DDP_ONE_RANK_STEPS`` steps twice
    with no process group and once in a one-rank NCCL group
    (``engine/launch.py::process_group``, the same code as (a), whose reduce
    and metric means then run through NCCL), the last step under the
    profiler. Then the world-1 timing: ``TRAIN_WARMUP`` + ``DDP_TIMED`` more
    steps with no group. Returns (digests, the profiled step's NCCL device
    kernels and ops, world-1 ms)."""
    import types

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from afigan_tpu_torch.data import coco
    from afigan_tpu_torch.data.dataset_mapper import DatasetMapper
    from afigan_tpu_torch.data.loader import collate_batch
    from afigan_tpu_torch.engine import stage3
    from afigan_tpu_torch.engine.launch import free_port, process_group
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    records = train_records(torch.Generator().manual_seed(7), n_img=2)
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(records=records))
    cfg = train_cfg(out_dir / "one")
    batch = collate_batch([DatasetMapper(cfg, is_train=True, seed=0)(x) for x in records],
                          cfg.TPU.IMAGE_BUCKETS, 64)
    inputs = stage3.batch_to_device(batch, "cuda")

    def run(profiled=False, more=0):
        trainer = TargetDetectorTrainer(cfg, device="cuda")
        calibrate_frozen_bn(trainer.model, inputs["image"])

        def step():
            return stage3.train_step(cfg, trainer.state, inputs, trainer.sampling,
                                     trainer.drop_path)

        for _ in range(DDP_ONE_RANK_STEPS - 1):
            step()
        prof = None
        if profiled:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
        else:
            step()
        digest = _digest(trainer.model.parameters())
        ms = timed_steps(step)[1][:more] if more else []
        return digest, prof, ms

    ms = run(more=DDP_TIMED)[2]
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a1, _, _ = run()
        a2, _, _ = run()
        with process_group("nccl", f"tcp://127.0.0.1:{free_port()}", 1, 0):
            b, prof, _ = run(profiled=True)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    kernels = sorted({e.key for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and "nccl" in e.key.lower()})
    ops = sorted({e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and "nccl" in e.key.lower()})
    return (a1, a2, b), kernels, ops, ms


def spread(v):
    """median (min-max) of a list of ms."""
    return f"{np.median(v):.1f} ({min(v):.1f}-{max(v):.1f})"


def check_ddp_ranks(ranks, out_dir: Path):
    """(a) and (b) over every rank's results: every loss finite and equal
    on all ranks, the parameters bit-equal across ranks after the last step,
    the first step's reduced gradient equal to the mean of the ranks' own,
    each rank's launches at every step as phase ``train``'s (2 pool
    forwards, 2 pool backwards, 2 NMS and no other kernel), the ranks'
    records disjoint at every step, and only rank 0 wrote the checkpoint and
    ``metrics.json``; stage 1's D SyncBN statistics moved, G and D equal
    across ranks, its records disjoint. Returns (a's results, b's)."""
    a = [x["stage3"] for x in ranks]
    b = [x["stage1"] for x in ranks]

    def disjoint(per_rank):
        return all(len(set().union(*map(set, ids))) == sum(map(len, ids))
                   for ids in zip(*per_rank))

    if any(x["metrics"] != a[0]["metrics"] for x in a):
        raise AssertionError("train_ddp: the ranks' metrics differ")
    if not all(np.isfinite(v) for m in a[0]["metrics"] for v in m.values()):
        raise AssertionError(f"train_ddp: a non-finite loss {a[0]['metrics']}")
    if any(x["params"] != a[0]["params"] for x in a):
        raise AssertionError("train_ddp: the ranks' parameters differ after the last step")
    if not disjoint([x["ids"] for x in a]):
        raise AssertionError(f"train_ddp: ranks shared records {[x['ids'] for x in a]}")
    if not disjoint([x["train_ids"] for x in a]):
        raise AssertionError(f"train_ddp train(): ranks shared records "
                             f"{[x['train_ids'] for x in a]}")
    want = {"roi_pool": 2, "roi_pool_bwd": 2, "nms": 2}
    for x in a:
        for step, got in enumerate(x["launches"]):
            if got != want:
                raise AssertionError(f"train_ddp rank {x['rank']} step {step}: launches {got}, "
                                     f"expected {want}")
    saved = [x["saved"] for x in a]
    lines = [x["json_lines"] for x in a]
    if saved != [[2]] + [[]] * (len(a) - 1) or any(lines[1:]) or not lines[0]:
        raise AssertionError(f"train_ddp: checkpoints {saved}, metrics.json lines {lines}")
    if not (out_dir / "stage3" / "model_0000002.pth").is_file():
        raise AssertionError("train_ddp: rank 0 wrote no checkpoint")
    check = a[0]["reduced_check"]
    if check["differ"] < check["tensors"] // 2:
        raise AssertionError(f"train_ddp: the ranks' own gradients hardly differ {check}")
    if any((x["G"], x["D"], x["metrics"]) != (b[0]["G"], b[0]["D"], b[0]["metrics"])
           for x in b):
        raise AssertionError("train_ddp stage 1: G, D or the metrics differ across ranks")
    if b[0]["stats_moved"] != b[0]["stats"] or not b[0]["stats"]:
        raise AssertionError(f"train_ddp stage 1: {b[0]['stats_moved']} of D's {b[0]['stats']} "
                             "running statistics moved")
    if not disjoint([x["ids"] for x in b]):
        raise AssertionError(f"train_ddp stage 1: ranks shared records {[x['ids'] for x in b]}")
    return a, b


def log_ddp(a, b, how: str, smi: str):
    """The log lines of (a) and (b)."""
    world = len(a)
    ms = [max(x) for x in zip(*(r["ms"] for r in a))]
    # a rank's reduce waits for the others' backward: the last rank's is the reduce
    red = [min(x) for x in zip(*(r["reduce_ms"] for r in a))]
    check = a[0]["reduced_check"]
    log(f"  train_ddp (a) stage 3, {world} ranks x 2 images, 832x1344, bf16, {how}: "
        f"{spread(ms)} ms a step (the slowest rank's, median (min-max) of {len(ms)} after "
        f"{TRAIN_WARMUP}); gradient reduce {spread(red)} ms a step (the last rank's) over "
        f"{a[0]['reduce_bytes'] / 1e6:.1f} MB ({a[0]['trainable'] / 1e6:.2f}M trainable "
        f"parameters, float32, and a flag each); peak memory "
        + " / ".join(f"{x['peak_gib']:.2f}" for x in a) + f" GiB a rank [{smi}]")
    log(f"  train_ddp (a): losses equal on all ranks, total_loss "
        + " ".join(f"{m['total_loss']:.4f}" for m in a[0]["metrics"])
        + f"; parameters bit-equal across ranks; step 1's reduced gradient within "
        f"{check['worst']:.1e} of the mean of the ranks' own ({check['tensors']} tensors, "
        f"{check['differ']} differ between ranks 0 and 1, {check['skipped']} without a "
        f"gradient); launches a rank at each of {len(a[0]['launches'])} steps "
        f"{json.dumps(a[0]['launches'][0])}; records disjoint at every step; checkpoint "
        f"and {a[0]['json_lines']} metrics.json line(s) from rank 0 only")
    log(f"  train_ddp (b) stage 1, {world} ranks x 2 images: D's {b[0]['stats']} running "
        f"statistics moved, G and D bit-equal across ranks, d_loss "
        + " ".join(f"{m['d_loss']:.4f}" for m in b[0]["metrics"]))


def phase_train_ddp(results):
    """Data-parallel training through ``engine/launch.py``: (a) stage 3 of
    the R-50 step-3 YAML on two ranks x 2 images at 832x1344, bf16, both on
    this card over gloo (``device="cuda:0"``, ``backend="gloo"`` given
    explicitly), and (b) stage 1 of the step-1 YAML on two ranks x 2
    images, held by ``check_ddp_ranks``. (c) a one-rank NCCL group on this
    card: the same parameters bit for bit as with no group, and NCCL's
    all-reduce op in the profiled step (over one rank it launches no device
    kernel: ``--ddp-cards`` checks NCCL's kernels on several cards). Logs ms
    a step (world 2 and world 1), the reduce's ms and bytes, peak memory a
    rank and the phase's wall."""
    import datetime
    import shutil

    from afigan_tpu_torch.engine.launch import launch

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "output" / "chip_smoke_train_ddp"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launch(ddp_rank_main, DDP_WORLD, args=(str(out_dir), DDP_WORLD, False), device="cuda:0",
           backend="gloo", timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    t_ranks = time.perf_counter() - t_phase
    ranks = [json.load(open(out_dir / f"rank{r}.json")) for r in range(DDP_WORLD)]
    a, b = check_ddp_ranks(ranks, out_dir)
    # (c)
    t0 = time.perf_counter()
    (a1, a2, one_group), kernels, ops, ms1 = ddp_one_rank(out_dir)
    t_one = time.perf_counter() - t0
    if a1 != a2:
        raise AssertionError("train_ddp (c): two runs with no group differ (nondeterminism)")
    if one_group != a1:
        raise AssertionError("train_ddp (c): the one-rank NCCL group changed the parameters")
    if not ops:
        raise AssertionError("train_ddp (c): no NCCL collective in the profiled step")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    log_ddp(a, b, "gloo on one card", smi)
    log(f"  train_ddp (c) one rank, 2 images: {spread(ms1)} ms a step with no group "
        f"[{smi}]; {DDP_ONE_RANK_STEPS} steps in a one-rank NCCL group bit-equal to "
        f"the same steps with no group (and two runs with no group to each other); "
        f"NCCL in the profiled step: ops {ops}, device kernels {kernels or 'none'} (an in-place "
        "sum over one rank moves nothing)")
    log(f"  train_ddp: wall {time.perf_counter() - t_phase:.1f} s (the ranks {t_ranks:.1f} s, "
        f"spawn and build included; (c) {t_one:.1f} s); gloo stages every collective "
        "through the host: these times are not NCCL's [" + smi + "]")
    for k, v in a[0]["launches"][0].items():
        results[k].setdefault("launches", {})["train_ddp"] = int(v)


def ddp_cards(n: int):
    """``--ddp-cards N``: (a) and (b) on N ranks, one card each, through
    ``launch``'s own choice for that (NCCL), held by ``check_ddp_ranks``;
    each rank profiles one more stage-3 step, in which NCCL's all-reduce
    kernel must run on its card. Logs what phase ``train_ddp`` logs."""
    import datetime
    import shutil

    import torch

    from afigan_tpu_torch.engine.launch import launch, pick_backend

    if torch.cuda.device_count() < n:
        raise RuntimeError(f"--ddp-cards {n}: {torch.cuda.device_count()} card(s) here")
    backend = pick_backend("cuda", n)
    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "output" / "chip_smoke_ddp_cards"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    launch(ddp_rank_main, n, args=(str(out_dir), n, True), device="cuda",
           timeout=datetime.timedelta(seconds=DDP_TIMEOUT_S))
    ranks = [json.load(open(out_dir / f"rank{r}.json")) for r in range(n)]
    a, b = check_ddp_ranks(ranks, out_dir)
    for x in a:
        if not any("allreduce" in k.lower().replace("_", "") for k in x["nccl"]["kernels"]):
            raise AssertionError(f"--ddp-cards rank {x['rank']}: no NCCL all-reduce kernel on "
                                 f"its card in the profiled step {x['nccl']}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    log_ddp(a, b, f"{backend}, one card a rank", smi[0])
    log(f"  ddp_cards: NCCL in each rank's profiled step: device kernels "
        f"{a[0]['nccl']['kernels']}, ops {a[0]['nccl']['ops']}")
    log(f"  ddp_cards: wall {time.perf_counter() - t_phase:.1f} s (spawn included) on "
        f"{n} cards: " + "; ".join(smi))
    return {"world": n, "backend": backend, "nccl_kernels": a[0]["nccl"]["kernels"],
            "ms": [max(x) for x in zip(*(r["ms"] for r in a))],
            "reduce_ms": [min(x) for x in zip(*(r["reduce_ms"] for r in a))],
            "reduce_bytes": a[0]["reduce_bytes"]}


# ---------------------------------------------------------------------------
# last phase: card vs CPU
# ---------------------------------------------------------------------------

def narrow_swin_cfg():
    """The flagship YAML at narrow widths for the card-vs-CPU check: head
    dimension 32 (the attention kernel's) at embed 32 with 1-2-4-8 heads,
    window 4, two BiFPN layers of 32 channels, growth 8."""
    from afigan_tpu_torch.config import swin_path_cfg

    cfg = swin_path_cfg()
    cfg.merge_from_list([
        "MODEL.SWINT.EMBED_DIM", "32", "MODEL.SWINT.DEPTHS", "(2, 2, 2, 2)",
        "MODEL.SWINT.NUM_HEADS", "(1, 2, 4, 8)", "MODEL.SWINT.WINDOW_SIZE", "4",
        "MODEL.BIFPN.OUT_CHANNELS", "32", "MODEL.BIFPN.FPN_REPEAT", "2",
        "MODEL.AFI.GROWTH_RATE", "8", "MODEL.ROI_BOX_HEAD.CONV_DIM", "32",
        "MODEL.ROI_BOX_HEAD.FC_DIM", "64"])
    return cfg


def narrow_centermask_cfg():
    """The CenterMask YAML at narrow widths: ResNet-50 at an eighth of its
    widths, two BiFPN layers of 32 channels, growth 8, one tower conv, 3
    classes, under the windowed pooler."""
    cfg = centermask_cfg("windowed")
    cfg.merge_from_list([
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.BIFPN.OUT_CHANNELS", "32",
        "MODEL.BIFPN.FPN_REPEAT", "2", "MODEL.AFI.GROWTH_RATE", "8",
        "MODEL.FCOS.NUM_CONVS", "1", "MODEL.FCOS.NUM_CLASSES", "3"])
    return cfg


def narrow_resnest_cfg():
    """The ResNeSt-PAFPN cascade mask YAML at narrow widths: depth 50 (the
    deep stem's smallest), res2 32 channels, width 8 a group, the pyramid, box
    and mask heads at 32 channels, growth 8, 3 classes; SyncBN everywhere."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml("inference/AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml")
    cfg.merge_from_list([
        "MODEL.RESNETS.DEPTH", "50", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "32",
        "MODEL.AFI.GROWTH_RATE", "8", "MODEL.ROI_BOX_HEAD.CONV_DIM", "32",
        "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32",
        "MODEL.ROI_HEADS.NUM_CLASSES", "3"])
    return cfg


def golden_settings(cfg):
    """tests/test_golden_regression.py's test-time settings, float32."""
    cfg.TPU.COMPUTE_DTYPE = "float32"
    # normalised inputs so random weights give non-degenerate detections,
    # every class scored, 128/64 proposals and 16 detections. With random weights most scores
    # tie to ~1e-7 (one dominant class); at 1000 proposals / 100 detections
    # a 1e-6 relative weight perturbation already reorders detection slots
    # on the CPU alone, so that setting cannot tell kernels from noise.
    cfg.MODEL.PIXEL_STD = GOLDEN_PIXEL_STD
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 128
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    cfg.TEST.DETECTIONS_PER_IMAGE = 16
    cfg.MODEL.FCOS.INFERENCE_TH_TEST = 0.0
    cfg.MODEL.FCOS.PRE_NMS_TOPK_TEST = 128
    cfg.MODEL.FCOS.POST_NMS_TOPK_TEST = 16
    return cfg


def card_vs_cpu(name, cfg, canvas, size, prepare=None):
    """``prepare``: a change to the seeded CPU model before the card's takes
    its weights. A ProposalNetwork's proposals: validity equal, proposals
    within 0.05 px, objectness 1e-3."""
    import torch

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    golden_settings(cfg)
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    if prepare is not None:
        prepare(cpu)
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.RandomState(42)
    batch = random_batch(rng, 1, canvas, [size])
    reset_launches()
    out_g = predict(gpu, batch)
    launched = {k: v for k, v in LAUNCHES.items() if v}
    out_c = predict(cpu, batch)
    if cfg.MODEL.META_ARCHITECTURE == "ProposalNetwork":
        vc = out_c.valid[0].numpy()
        np.testing.assert_array_equal(out_g.valid[0].cpu().numpy(), vc, "valid")
        if not vc.any():
            raise AssertionError("no valid proposals to compare")
        pg, pc = out_g.proposals[0].cpu().numpy()[vc], out_c.proposals[0].numpy()[vc]
        sg, sc = out_g.scores[0].cpu().numpy()[vc], out_c.scores[0].numpy()[vc]
        np.testing.assert_allclose(pg, pc, rtol=0, atol=0.05, err_msg="proposals(px)")
        np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-3, err_msg="objectness")
        log(f"  card_vs_cpu {name}: {int(vc.sum())} valid proposals; max |d box| "
            f"{np.abs(pg - pc).max():.2e} px, max |d objectness| {np.abs(sg - sc).max():.2e}; "
            f"launches on the card {json.dumps(launched)}")
        return launched
    (d_g, m_g), (d_c, m_c) = out_g, out_c
    vg, vc = d_g.valid[0].cpu().numpy(), d_c.valid[0].numpy()
    np.testing.assert_array_equal(vg, vc, "valid")
    n = int(vc.sum())
    if n == 0:
        raise AssertionError("no valid detections to compare")
    np.testing.assert_array_equal(d_g.classes[0].cpu().numpy()[vg],
                                  d_c.classes[0].numpy()[vc], "classes")
    sg, sc = d_g.scores[0].cpu().numpy()[vg], d_c.scores[0].numpy()[vc]
    bg, bc = d_g.boxes[0].cpu().numpy()[vg], d_c.boxes[0].numpy()[vc]
    np.testing.assert_allclose(sg, sc, rtol=0, atol=1e-3, err_msg="scores")
    np.testing.assert_allclose(bg, bc, rtol=0, atol=0.05, err_msg="boxes(px)")
    msg = (f"  card_vs_cpu {name}: {n} valid detections equal in class; max |d score| "
           f"{np.abs(sg - sc).max():.2e}, max |d box| {np.abs(bg - bc).max():.2e} px")
    if m_c is not None:
        mg = m_g[0].sum(dim=(1, 2)).cpu().numpy()[vg]
        mc = m_c[0].sum(dim=(1, 2)).numpy()[vc]
        np.testing.assert_allclose(mg, mc, rtol=5e-3, atol=5e-3, err_msg="mask_sum")
        msg += f", max |d mask_sum| {np.abs(mg - mc).max():.2e}"
    if d_c.keypoints is not None:
        kg, kc = d_g.keypoints[0].cpu().numpy()[vg], d_c.keypoints[0].numpy()[vc]
        np.testing.assert_allclose(kg[..., :2], kc[..., :2], rtol=0, atol=0.05,
                                   err_msg="keypoints(px)")
        np.testing.assert_allclose(kg[..., 2], kc[..., 2], rtol=0, atol=1e-3,
                                   err_msg="keypoint scores")
        msg += (f", max |d keypoint| {np.abs(kg[..., :2] - kc[..., :2]).max():.2e} px, "
                f"max |d keypoint score| {np.abs(kg[..., 2] - kc[..., 2]).max():.2e}")
    log(msg + f"; launches on the card {json.dumps(launched)}")
    return launched


def offsets_on(model):
    """Every deformable block's offset predictor at a seeded scale that moves
    its taps by a few pixels (it starts at zero, a plain conv)."""
    import torch

    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for k, p in model.named_parameters():
            if k.endswith("conv2_offset.weight"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))


def narrow_dcn_cfg():
    """``narrow_resnest_cfg`` with the deformable convs of ``dcn_cfg``."""
    cfg = narrow_resnest_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEFORM_ON_PER_STAGE", "[False, True, True, True]",
                         "MODEL.RESNETS.DEFORM_MODULATED", "True"])
    return cfg


def tta_capture(fn):
    """``fn()`` (a ``run_tta_inference``) with the evaluator's predictions and
    the averaged mask probabilities it pastes captured: (results,
    predictions, [(probabilities, valid)] an image)."""
    from afigan_tpu_torch.engine import tta
    from afigan_tpu_torch.evaluation import CocoEvaluator

    seen = {"masks": []}
    evaluate, paste = CocoEvaluator.evaluate, tta.paste_masks

    def capture_eval(self):
        seen["preds"] = list(self.predictions)
        return evaluate(self)

    def capture_paste(masks, boxes, valid, *a, **k):
        seen["masks"].append((np.asarray(masks), np.asarray(valid)))
        return paste(masks, boxes, valid, *a, **k)

    CocoEvaluator.evaluate, tta.paste_masks = capture_eval, capture_paste
    try:
        return fn(), seen["preds"], seen["masks"]
    finally:
        CocoEvaluator.evaluate, tta.paste_masks = evaluate, paste


def card_vs_cpu_tta():
    """Test-time augmentation with MASK_ON on a narrow R-50 Mask R-CNN (an
    eighth of the widths), 2 random-pixel 120x160 images at min sizes 96 and
    128 with flips, on the card and on the CPU with the same weights (the box
    regression and mask predictors scaled up 30x and the class scores 3x, so
    that merged boxes, masks and scores depend on the features and the merge
    meets no tie): merged detections at the golden tolerances, each averaged
    mask's probability sum at 5e-3 relative, AP 1e-3."""
    import torch

    from afigan_tpu_torch.config import main_path_cfg
    from afigan_tpu_torch.data.coco import CocoDataset
    from afigan_tpu_torch.engine import tta
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    cfg = golden_settings(main_path_cfg())
    cfg.merge_from_list([
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.FPN.OUT_CHANNELS", "32",
        "MODEL.AFI.GROWTH_RATE", "8", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
        "MODEL.ROI_MASK_HEAD.CONV_DIM", "32", "MODEL.ROI_HEADS.NUM_CLASSES", "3",
        "TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(96, 128)",
        "TEST.AUG.MAX_SIZE", "256", "TEST.AUG.FLIP", "True",
        "TPU.IMAGE_BUCKETS", "((128, 256),)"])
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for k, p in cpu.named_parameters():
            if k.endswith(("bbox_pred.weight", "mask_head.predictor.weight")):
                p.mul_(30.0)
            elif k.endswith("cls_score.weight"):
                p.mul_(3.0)
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    dataset = CocoDataset(*write_coco(Path("output") / "chip_smoke_tta_small", 2, (120, 160), 1,
                                      cfg.MODEL.ROI_HEADS.NUM_CLASSES))
    reset_launches()
    got = tta_capture(lambda: tta.run_tta_inference(cfg, gpu, dataset))
    launched = {k: v for k, v in LAUNCHES.items() if v}
    want = tta_capture(lambda: tta.run_tta_inference(cfg, cpu, dataset))
    (res_g, preds_g, masks_g), (res_w, preds_w, masks_w) = got, want
    if len(preds_g) != len(preds_w) or not preds_w:
        raise AssertionError(f"tta card vs cpu: {len(preds_g)} vs {len(preds_w)} detections")
    db = ds = 0.0
    for g, w in zip(preds_g, preds_w):
        if (g["image_id"], g["category_id"]) != (w["image_id"], w["category_id"]):
            raise AssertionError(f"tta card vs cpu: {g} vs {w}")
        db = max(db, float(np.abs(np.asarray(g["bbox"]) - np.asarray(w["bbox"])).max()))
        ds = max(ds, abs(g["score"] - w["score"]))
    dm = 0.0
    for (mg, vg), (mw, vw) in zip(masks_g, masks_w):
        np.testing.assert_array_equal(vg, vw, "merged valid")
        sg, sw = mg[vg].sum(axis=(1, 2)), mw[vw].sum(axis=(1, 2))
        np.testing.assert_allclose(sg, sw, rtol=5e-3, atol=0, err_msg="averaged mask sums")
        dm = max(dm, float(np.abs(sg / sw - 1).max()))
    dap = max(abs(res_g[t]["AP"] - res_w[t]["AP"]) for t in res_w)
    log(f"  card_vs_cpu tta r50 mask: {len(preds_w)} merged detections equal in image and "
        f"class; max |d box| {db:.2e} px, |d score| {ds:.2e}, |d mask sum| {dm:.2e} "
        f"relative, |d AP| {dap:.2e}; launches on the card {json.dumps(launched)}")
    if db > 0.05 or ds > 1e-3 or dap > 1e-3 or len(masks_g) != 2:
        raise AssertionError("tta card vs cpu: outside the golden tolerances")
    return launched


@tf32_off()
def phase_card_vs_cpu(results):
    from afigan_tpu_torch.config import cfg_from_yaml, main_path_cfg, proposal_path_cfg

    def need(launched, name, kernels):
        for k in kernels:
            if not launched.get(k):
                raise AssertionError(f"the {name} model did not launch {k} on the card")

    need(card_vs_cpu("r50", main_path_cfg(), (320, 320), (288, 320)), "R-50",
         ("roi_pool", "afi_chain", "afi_upsample", "nms"))
    # the same model through the windowed pooler: window_gather at C=256, with
    # a box head (P=7, 64 proposals) and a mask head (P=14) behind it
    cfg = main_path_cfg()
    cfg.TPU.POOLER_IMPL = "windowed"
    need(card_vs_cpu("r50 windowed", cfg, (320, 320), (288, 320)), "windowed R-50",
         ("window_gather", "roi_pool", "afi_chain", "afi_upsample", "nms"))
    need(card_vs_cpu("narrow swin", narrow_swin_cfg(), (128, 256), (120, 250)), "narrow Swin",
         ("layer_norm", "window_attention", "afi_chain", "afi_upsample", "roi_pool", "nms"))
    need(card_vs_cpu("narrow centermask windowed", narrow_centermask_cfg(), (128, 256),
                     (120, 250)), "narrow CenterMask",
         ("window_gather", "roi_pool", "afi_chain", "afi_upsample", "nms"))
    need(card_vs_cpu("r50 pafpn", cfg_from_yaml("inference/AFI-GAN_maskrcnn_R_50_PAFPN.yaml"),
                     (320, 320), (288, 320)), "R-50-PAFPN",
         ("roi_pool", "afi_chain", "afi_upsample", "nms"))
    need(card_vs_cpu("narrow resnest pafpn cascade mask", narrow_resnest_cfg(), (128, 256),
                     (120, 250)), "narrow ResNeSt", ("roi_pool", "afi_chain", "afi_upsample",
                                                     "nms"))
    need(card_vs_cpu_tta(), "TTA R-50", ("roi_pool", "afi_chain", "afi_upsample", "nms"))
    # Keypoint R-CNN (the keypoint pool at 14x14, its own sampling and
    # alignment) with two keypoint convs of 64, and the Res5 heads (the fast
    # pooler over p4: window_gather and the overflow pool)
    from afigan_tpu_torch.config import keypoint_path_cfg, res5_path_cfg

    cfg = keypoint_path_cfg()
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [64, 64]
    need(card_vs_cpu("narrow keypoint", cfg, (320, 320), (288, 320)), "keypoint",
         ("roi_pool", "afi_chain", "afi_upsample", "nms"))
    # a 512x512 canvas: at 320x320 the random RPN's 128 best p4 anchors all
    # decode outside the image, on the CPU as on the card
    need(card_vs_cpu("res5", res5_path_cfg(), (512, 512), (480, 512)), "Res5",
         ("window_gather", "roi_pool", "afi_chain", "afi_upsample", "nms"))
    # the ProposalNetwork, the R-18 and the deformable ResNeSt (its
    # offset predictors moved off zero, so that the gather samples between
    # pixels and outside the map)
    need(card_vs_cpu("proposals", proposal_path_cfg(), (320, 320), (288, 320)),
         "ProposalNetwork", ("afi_chain", "afi_upsample", "nms"))
    need(card_vs_cpu("r18", r18_cfg(), (320, 320), (288, 320)), "R-18",
         ("roi_pool", "afi_chain", "afi_upsample", "nms"))
    need(card_vs_cpu("narrow resnest dcn", narrow_dcn_cfg(), (128, 256), (120, 250),
                     prepare=offsets_on), "deformable ResNeSt",
         ("roi_pool", "afi_chain", "afi_upsample", "nms", "deform_conv"))


# ---------------------------------------------------------------------------
# phase tools: validate_training, pseudo labels, PreciseBN, the profiler hook
# and convert_checkpoint on the card
# ---------------------------------------------------------------------------

TOOLS_DIR = Path("output/chip_smoke_tools")
# the length of the JAX package's own r50 validation run (PARITY.md:658), not
# the tool's default 150: at 150 the judges see about eight writer records a
# stage, two at each end, and one late spike of stage 2's loss_cls on the card
# turned its verdict (PERF.md, section 6)
TOOLS_ITERS = 400
# the stage-3 YAML's own test threshold: the pseudo labels keep what the model
# itself calls a detection
PSEUDO_SCORE_THRESH = 0.05
# one image a predict call: each generator and pool call launches as in a
# batch of two, NMS once an image for the proposals and once for the
# detections
PSEUDO_PER_IMAGE = dict(R50_PER_BATCH, nms=2)
# PreciseBN's run: iterations (EVAL_PERIOD = MAX_ITER) and forwards (the
# YAML's NUM_ITER is 200)
PRECISE_BN_ITERS, PRECISE_BN_FORWARDS = 4, 8
# a training step of validate_training's stages 2 and 3 at 8 images: the box
# and the mask pool both ways, the RPN's NMS an image; stage 1 launches none
TOOLS_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, nms=8)
# the held calls of such a step (one launch a call)
TOOLS_TRAIN_HELD = {"roi_pool": 2, "nms": 8, "roi_pool_bwd": 2}
# the loader's mapping threads in validate_training (the JAX tool's
# DATALOADER.NUM_WORKERS) and the data time a stage took when the loader
# mapped serially on the training thread (PERF.md, section 5; NVIDIA H100
# 80GB HBM3, 700.00 W)
TOOLS_WORKERS = 2
SERIAL_DATA_MS = {"1": 100.9, "2": 101.3, "3": 92.0}
# validate_training --family keypoint: the JAX run's length
# (benchmarks/DYNVAL_r05_keypoint.json) at 4 images; a step launches the box
# and the keypoint pool both ways and the RPN's NMS an image
KEYPOINT_ITERS = 150
KEYPOINT_TOOLS_PER_STEP = dict(TRAIN_PER_STEP, nms=4)
KEYPOINT_TOOLS_HELD = {"roi_pool": 2, "nms": 4, "roi_pool_bwd": 2}
# the held calls of a pseudo-label image: the generator's two one-call
# entries at each of the three levels it runs at, the box and the mask pool,
# NMS for the proposals and for the detections
PSEUDO_HELD = {"afi_chain": 3, "afi_upsample": 3, "roi_pool": 2, "nms": 2}


class StepLaunches:
    """While entered, every loop of the trainers (``engine/trainers.py``)
    carries a first hook that reads the launch counts of each step on its own
    (reset before the first step and after each), and the loop's first step
    runs under ``HeldKernels`` at the trainer's compute dtype, the pool's
    backward held too. ``loops``: per loop in order, the trainer's class
    name, the counts of each step and the ``HeldKernels``."""

    def __init__(self):
        self.loops = []

    def __enter__(self):
        from afigan_tpu_torch.engine import trainers
        from afigan_tpu_torch.engine.train_loop import Hook
        from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

        loops = self.loops
        self._saved = (trainers._Trainer._run, trainers.TrainLoop)
        run, train_loop = self._saved

        class Counts(Hook):
            def __init__(self, rec):
                self.rec = rec

            def before_train(self, loop):
                self.held = HeldKernels(self.rec["dtype"], backward=True).__enter__()
                self.rec["held"] = self.held
                reset_launches()

            def after_step(self, loop):
                self.rec["steps"].append(dict(LAUNCHES))
                reset_launches()
                self.after_train(loop)

            def after_train(self, loop):
                if self.held is not None:
                    self.held.__exit__(None, None, None)
                    self.held = None

        def counted_run(trainer, *a, **k):
            loops.append({"trainer": type(trainer).__name__, "steps": [], "held": None,
                          "dtype": trainer.cfg.TPU.COMPUTE_DTYPE})
            return run(trainer, *a, **k)

        def counted_loop(max_iter, hooks, start=0):
            return train_loop(max_iter, [Counts(loops[-1])] + list(hooks), start)

        trainers._Trainer._run, trainers.TrainLoop = counted_run, counted_loop
        return self

    def __exit__(self, *exc):
        from afigan_tpu_torch.engine import trainers

        trainers._Trainer._run, trainers.TrainLoop = self._saved


def check_tools_steps(loops, results):
    """validate_training's three loops: stage 1 launches nothing at any
    step, every step of stages 2 and 3 exactly ``TOOLS_TRAIN_PER_STEP``; each
    loop's first step held against the plain versions (``TOOLS_TRAIN_HELD``,
    none in stage 1) within TOL."""
    names = ["AFIGANTrainer", "AFExtractorTrainer", "TargetDetectorTrainer"]
    if [r["trainer"] for r in loops] != names:
        raise AssertionError(f"validate_training: loops {[r['trainer'] for r in loops]}")
    for s, rec in enumerate(loops, 1):
        want = TOOLS_TRAIN_PER_STEP if s > 1 else {k: 0 for k in TOOLS_TRAIN_PER_STEP}
        if len(rec["steps"]) != TOOLS_ITERS:
            raise AssertionError(f"validate_training stage {s}: {len(rec['steps'])} steps")
        for i, counts in enumerate(rec["steps"]):
            launched = {k: v for k, v in counts.items() if v}
            if launched != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"validate_training stage {s} step {i}: launches "
                                     f"{launched}, expected {want}")
        held = rec["held"]
        if held.calls != (TOOLS_TRAIN_HELD if s > 1 else {}):
            raise AssertionError(f"validate_training stage {s}: held {held.calls}")
        log(f"  stage {s}: {len(rec['steps'])} steps of {json.dumps(want)} launches each; its "
            f"first step held against the plain versions at {rec['dtype']}: " + (", ".join(
                f"{k} x{n} max_abs_err {held.err[k]:.3e}" for k, n in held.calls.items())
                or "nothing launched") + (f"; NMS calls (N, valid candidates, kept, "
                                          f"suppressed before the stop) {held.nms}"
                                          if held.nms else ""))
        if s > 1:
            for k, n in TOOLS_TRAIN_PER_STEP.items():
                results[k].setdefault("launches", {})[f"tools_validate_s{s}"] = n


def tools_validate(results):
    """(a) validate_training, r50, stages 1-3 at full width: every verdict
    true and every loss finite; each step's launches (``check_tools_steps``);
    each stage's ms an iteration and peak memory, each judged loss's head or
    peak beside its tail. Returns the output directory."""
    import shutil

    from afigan_tpu_torch.tools import validate_training

    out = TOOLS_DIR / "validate"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    with StepLaunches() as steps:
        rc = validate_training.main(["--family", "r50", "--stages", "1,2,3",
                                     "--iters", str(TOOLS_ITERS), "--out", str(out)])
    wall = time.perf_counter() - t0
    check_tools_steps(steps.loops, results)
    summary = json.loads((out / "summary.json").read_text())
    log(f"  validate_training r50, {TOOLS_ITERS} iterations a stage at 8 images: exit {rc}, "
        f"ok {summary['ok']}, {wall:.1f} s")
    for s in ("1", "2", "3"):
        t = summary["timing"][s]
        log(f"  stage {s}: {1000 * t['median_iter_s']:.1f} ms an iteration (median of the "
            f"writer's records; data {1000 * t['median_data_s']:.1f} ms on "
            f"{TOOLS_WORKERS} mapping threads, {SERIAL_DATA_MS[s]} ms with a serial "
            f"loader), {8 / t['median_iter_s']:.2f} images/s, "
            f"peak {t['peak_gib']:.2f} GiB")
        for key, c in summary["stages"][s].items():
            if isinstance(c, dict):
                first = "peak" if "peak" in c else "head"
                log(f"    {key}: {first} {c[first]:.4f} -> tail {c['tail']:.4f}, "
                    f"fell {c['fell']}")
                vals = (c[first], c["tail"])
                # stage 2's content loss against a random guide is recorded,
                # not judged (the JAX tool's judge)
                ok = c["fell"] or (s == "2" and key == "content_loss_*")
            elif key.endswith("_curve"):
                log(f"    {key}: " + ", ".join(f"{it}: {v:.4f}" for it, v in c))
                vals, ok = [v for _, v in c], True
            else:
                log(f"    {key}: {c}")
                vals, ok = [c] if isinstance(c, float) else [], c is not False
            if not ok or not np.all(np.isfinite(np.asarray(vals, dtype=float))):
                raise AssertionError(f"validate_training stage {s}: {key} {c}")
    if rc != 0 or not summary["ok"]:
        raise AssertionError(f"validate_training: exit {rc}, ok {summary['ok']}")
    return out


def log_judges(what, checks):
    """A stage's judged losses (head or peak beside tail) and curves; raises
    on a verdict that is false or a loss that is not finite."""
    for key, c in checks.items():
        if isinstance(c, dict):
            first = "peak" if "peak" in c else "head"
            log(f"    {key}: {first} {c[first]:.4f} -> tail {c['tail']:.4f}, fell {c['fell']}")
            vals, ok = (c[first], c["tail"]), c["fell"]
        elif key.endswith("_curve"):
            log(f"    {key}: " + ", ".join(f"{it}: {v:.4f}" for it, v in c))
            vals, ok = [v for _, v in c], True
        else:
            log(f"    {key}: {c}")
            vals, ok = [c] if isinstance(c, float) else [], c is not False
        if not ok or not np.all(np.isfinite(np.asarray(vals, dtype=float))):
            raise AssertionError(f"{what}: {key} {c}")


def tools_validate_keypoint(results):
    """(a2) validate_training --family keypoint (Keypoint R-CNN R-50-FPN,
    stage 3) at the JAX run's 150 iterations and 4 images: every verdict
    true; every step 2 pool launches each way (box, keypoint) and 4 NMS, the
    first step held against the plain versions (the pool's backward too)."""
    import shutil

    from afigan_tpu_torch.tools import validate_training

    out = TOOLS_DIR / "validate_keypoint"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    with StepLaunches() as steps:
        rc = validate_training.main(["--family", "keypoint", "--iters", str(KEYPOINT_ITERS),
                                     "--out", str(out)])
    wall = time.perf_counter() - t0
    summary = json.loads((out / "summary.json").read_text())
    (rec,) = steps.loops
    want = {k: v for k, v in KEYPOINT_TOOLS_PER_STEP.items() if v}
    if rec["trainer"] != "TargetDetectorTrainer" or len(rec["steps"]) != KEYPOINT_ITERS:
        raise AssertionError(f"validate_training keypoint: {rec['trainer']}, "
                             f"{len(rec['steps'])} steps")
    for i, counts in enumerate(rec["steps"]):
        if {k: v for k, v in counts.items() if v} != want:
            raise AssertionError(f"validate_training keypoint step {i}: launches {counts}")
    held = rec["held"]
    if held.calls != KEYPOINT_TOOLS_HELD:
        raise AssertionError(f"validate_training keypoint: held {held.calls}")
    t = summary["timing"]["3"]
    log(f"  validate_training keypoint, {KEYPOINT_ITERS} iterations at 4 images: exit {rc}, "
        f"ok {summary['ok']}, {wall:.1f} s; {1000 * t['median_iter_s']:.1f} ms an iteration "
        f"(data {1000 * t['median_data_s']:.1f} ms), peak {t['peak_gib']:.2f} GiB; every step "
        f"{json.dumps(want)}; the first step held: " + ", ".join(
            f"{k} x{n} max_abs_err {held.err[k]:.3e}" for k, n in held.calls.items()))
    log_judges("validate_training keypoint", summary["stages"]["3"])
    if rc != 0 or not summary["ok"]:
        raise AssertionError(f"validate_training keypoint: exit {rc}, ok {summary['ok']}")
    for k, n in KEYPOINT_TOOLS_PER_STEP.items():
        results[k].setdefault("launches", {})["tools_validate_keypoint"] = n


def tools_pseudo_labels(results, validated: Path):
    """(b) generate_pseudo_labels with (a)'s stage-3 checkpoint over its 16
    scene images: every image's launches (the generator's, the pool's and
    NMS's), the first image's kernel calls held against their plain versions
    (``PSEUDO_HELD``), images/s, and the JSON back through
    ``register_coco_instances``."""
    import torch

    from afigan_tpu_torch.config import CONFIGS, get_cfg
    from afigan_tpu_torch.data.coco import get_dataset, register_coco_instances
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools import generate_pseudo_labels

    out = TOOLS_DIR / "pseudo_instances.json"
    img_dir = validated / "data" / "images"
    per_image, stamps = [], []
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIGS / STEP3_YAML))
    held = HeldKernels(cfg.TPU.COMPUTE_DTYPE)

    def after_image(fname):
        torch.cuda.synchronize()
        per_image.append(dict(LAUNCHES))
        stamps.append(time.perf_counter())
        reset_launches()
        held.__exit__(None, None, None)  # after the first image

    reset_launches()
    t0 = time.perf_counter()
    with held:  # building the model and loading its weights launch nothing
        coco = generate_pseudo_labels.main(
            ["--config-file", str(CONFIGS / STEP3_YAML),
             "--weights", str(validated / "s3" / f"model_{TOOLS_ITERS:07d}.pth"),
             "--image-dir", str(img_dir), "--output", str(out),
             "--score-thresh", str(PSEUDO_SCORE_THRESH), "MODEL.ROI_HEADS.NUM_CLASSES", "3"],
            after_image=after_image)
    if held.calls != PSEUDO_HELD:
        raise AssertionError(f"pseudo labels: the first image held {held.calls}, expected "
                             f"{PSEUDO_HELD}")
    log(f"  pseudo labels: the first image's calls held against their plain versions at "
        f"{cfg.TPU.COMPUTE_DTYPE}: " + ", ".join(
            f"{k} x{n} max_abs_err {held.err[k]:.3e}" for k, n in held.calls.items())
        + f"; NMS calls (N, valid candidates, kept, suppressed before the stop) {held.nms}")
    if len(per_image) != 16:
        raise AssertionError(f"pseudo labels: {len(per_image)} images, expected 16")
    for i, counts in enumerate(per_image):
        for k, n in PSEUDO_PER_IMAGE.items():
            if counts[k] != n:
                raise AssertionError(f"pseudo labels, image {i}: {counts[k]} launches of {k}, "
                                     f"expected {n}")
    for k, n in PSEUDO_PER_IMAGE.items():
        results[k].setdefault("launches", {})["tools_pseudo"] = n
    steady = np.diff(stamps)
    log(f"  pseudo labels: {len(coco['annotations'])} at score >= {PSEUDO_SCORE_THRESH} over "
        f"{len(coco['images'])} images in {stamps[-1] - t0:.1f} s (model built, weights "
        f"loaded); images 2-16 {1000 * float(np.median(steady)):.1f} ms an image (median; "
        f"{1 / float(np.median(steady)):.2f} images/s, min {1000 * steady.min():.1f}, max "
        f"{1000 * steady.max():.1f} ms), launches an image " + json.dumps(
            {k: v for k, v in per_image[-1].items() if v}))
    register_coco_instances("chip_smoke_pseudo", str(out), str(img_dir), filter_empty=False)
    ds = get_dataset("chip_smoke_pseudo")
    n_anns = sum(len(r["annotations"]) for r in ds.records)
    if len(ds.records) != 16 or n_anns != len(coco["annotations"]) or n_anns == 0:
        raise AssertionError(f"pseudo labels: {len(ds.records)} records with {n_anns} "
                             f"annotations read back")
    if any(not isinstance(a.get("segmentation"), dict) for a in coco["annotations"]):
        raise AssertionError("pseudo labels: an instance without its RLE mask")


def tools_precise_bn():
    """(c) PreciseBN: a short stage-3 run of the CenterMask YAML (its BiFPN
    SyncBN trains) with ``TEST.PRECISE_BN.ENABLED`` and ``EVAL_PERIOD`` =
    ``MAX_ITER`` over the scene set: every running statistic replaced by
    finite values before the evaluation, which sees them. Returns the
    trainer and its config."""
    import torch

    from afigan_tpu_torch.config import CONFIGS
    from afigan_tpu_torch.engine.precise_bn import batch_norms
    from afigan_tpu_torch.engine.trainers import TargetDetectorTrainer
    from afigan_tpu_torch.tools import validate_training as vt

    out = TOOLS_DIR / "precise_bn"
    cfg = vt._family_overrides(vt._cfg(str(CONFIGS / CENTERMASK_YAML), str(out),
                                       PRECISE_BN_ITERS, False), "centermask", False)
    cfg.merge_from_list(["MODEL.AFI_FREEZE", "False", "TEST.PRECISE_BN.ENABLED", "True",
                         "TEST.PRECISE_BN.NUM_ITER", str(PRECISE_BN_FORWARDS),
                         "TEST.EVAL_PERIOD", str(PRECISE_BN_ITERS)])
    trainer = TargetDetectorTrainer(cfg)
    bns = batch_norms(trainer.model)
    run_precise_bn, evaluate = trainer.run_precise_bn, trainer.evaluate
    events = []

    def stats():
        return [(b.running_mean.clone(), b.running_var.clone()) for b in bns]

    def precise_bn(num_iter, dual_scale):
        if dual_scale:
            raise AssertionError("PreciseBN: stage 3 asked for dual-scale batches")
        before = stats()
        t0 = time.perf_counter()
        n = run_precise_bn(num_iter, dual_scale=dual_scale)
        torch.cuda.synchronize()
        events.append(("precise_bn", n, before, stats(), time.perf_counter() - t0))
        return n

    def evaluation(final=True):
        events.append(("evaluate", stats()))
        return evaluate(final=final)

    trainer.run_precise_bn, trainer.evaluate = precise_bn, evaluation
    trainer.train()
    if [e[0] for e in events] != ["precise_bn", "evaluate"]:
        raise AssertionError(f"PreciseBN: hooks ran {[e[0] for e in events]}")
    _, n, before, after, seconds = events[0]
    if n != PRECISE_BN_FORWARDS or not bns:
        raise AssertionError(f"PreciseBN: {n} forwards over {len(bns)} batch norms")
    moved = []
    for (m0, v0), (m1, v1), (me, ve) in zip(before, after, events[1][1]):
        for old, new, seen in ((m0, m1, me), (v0, v1, ve)):
            if torch.equal(old, new) or not torch.isfinite(new).all():
                raise AssertionError("PreciseBN: a running statistic not replaced by finite "
                                     "values")
            if not torch.equal(new, seen):
                raise AssertionError("PreciseBN: the evaluation saw other statistics")
            moved.append(float(((new - old).abs().max() / old.abs().max().clamp_min(1e-12))))
    log(f"  PreciseBN: {len(bns)} batch norms ({2 * len(bns)} running buffers) replaced from "
        f"{n} training-mode forwards of 4 images in {seconds:.1f} s, before the evaluation; "
        f"largest change of a buffer {max(moved):.3g} of its largest entry (median "
        f"{float(np.median(moved)):.3g})")
    return trainer, cfg


def tools_profiler(trainer, cfg):
    """(d) ``ProfilerHook`` over iterations 1-2 of three more steps of (c)'s
    trainer: the Chrome trace exists and names the pool kernel forward and
    backward (the profiler loses device records now and then: up to three
    traces)."""
    from afigan_tpu_torch.data import build_train_loader
    from afigan_tpu_torch.data.coco import get_dataset
    from afigan_tpu_torch.engine.stage3 import batch_to_device, train_step
    from afigan_tpu_torch.engine.train_loop import TrainLoop
    from afigan_tpu_torch.utils.profiling import ProfilerHook, annotate

    loader = build_train_loader(cfg, get_dataset(cfg.DATASETS.TRAIN[0]), seed=1)

    def run_step():
        with annotate("tools_step"):
            return train_step(cfg, trainer.state, batch_to_device(next(loader), trainer.device),
                              trainer.sampling, trainer.drop_path)

    for attempt in range(1, 4):
        hook = ProfilerHook(str(TOOLS_DIR / "profile"), start_iter=1, num_iters=2)
        TrainLoop(3, [hook]).run(run_step)
        events = json.loads(Path(hook.path).read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        # a host range (the card's timeline mirrors it as gpu_user_annotation)
        steps = sum(1 for e in events
                    if e.get("name") == "tools_step" and e.get("cat") == "user_annotation")
        fwd = sum("roi_pool_kernel" in k for k in kernels)
        bwd = sum("roi_pool_bwd_kernel" in k for k in kernels)
        log(f"  profiler trace {attempt}: {hook.path}, {Path(hook.path).stat().st_size / 2**20:.1f}"
            f" MiB, {steps} step ranges, {len(kernels)} device kernels, roi_pool_kernel {fwd}, "
            f"roi_pool_bwd_kernel {bwd}")
        if steps != 2:
            raise AssertionError(f"the trace holds {steps} step ranges, expected 2")
        if fwd and bwd:
            return
    raise AssertionError("no trace named the pool kernel both ways")


def tools_convert(validated: Path):
    """(e) convert_checkpoint: (a)'s stage-3 ``.pth`` into a ``.pth`` that a
    fresh model on the card loads with no key unmatched, mismatched or
    missing, every value equal."""
    from afigan_tpu_torch.config import CONFIGS, get_cfg
    from afigan_tpu_torch.engine.trainers import load_matching
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.tools import convert_checkpoint
    from afigan_tpu_torch.utils.converters import load_state_dict

    src = validated / "s3" / f"model_{TOOLS_ITERS:07d}.pth"
    dst = TOOLS_DIR / "converted.pth"
    opts = ["MODEL.ROI_HEADS.NUM_CLASSES", "3"]
    convert_checkpoint.main(["--config-file", str(CONFIGS / STEP3_YAML), "--input", str(src),
                             "--output", str(dst), "--kind", "detector", *opts])
    cfg = get_cfg()
    cfg.merge_from_file(str(CONFIGS / STEP3_YAML))
    cfg.merge_from_list(opts)
    model = build_model(cfg)
    state = load_state_dict(str(dst))
    report = load_matching(model, state, str(dst))  # a shape mismatch raises
    if report["unmatched"] or report["missing"]:
        raise AssertionError("converted checkpoint: " + json.dumps(
            {k: v[:8] for k, v in report.items() if k != "matched"}))
    n = check_loaded(model, state)
    log(f"  convert_checkpoint: {src} -> {dst}: {len(report['matched'])} matched, 0 unmatched, "
        f"0 mismatched, 0 missing; {n} tensors equal on the card")


def phase_tools(results):
    validated = tools_validate(results)
    tools_validate_keypoint(results)
    tools_pseudo_labels(results, validated)
    trainer, cfg = tools_precise_bn()
    tools_profiler(trainer, cfg)
    del trainer
    tools_convert(validated)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU", file=sys.stderr)
        return 2
    from afigan_tpu_torch.ops.kernels import _build

    t_all = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(built) or 'cached'})")
    for name, txt in _build.PTXAS_LOG.items():
        for line in txt.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    bwd_without_atomics(_build)

    if "--ddp-cards" in sys.argv[1:]:
        # only data-parallel training on several cards, NCCL between them
        res = ddp_cards(int(sys.argv[sys.argv.index("--ddp-cards") + 1]))
        log(f"total {time.perf_counter() - t_all:.1f} s")
        log(smi)
        print(json.dumps({"ddp_cards": res}), flush=True)
        return 0

    if "--generator-levels" in sys.argv[1:]:
        # only the per-level device time of a generator call (also runs on a
        # tree whose module re-lays its weights on every call)
        generator_levels(strict=False)
        log(smi)
        return 0

    results = {k: {} for k in KERNELS}
    for name, phase in (("kernels", phase_kernels), ("slice", phase_slice),
                        ("slice_swin", phase_slice_swin),
                        ("slice_centermask", phase_slice_centermask),
                        ("slice_pafpn", phase_slice_pafpn),
                        ("slice_resnest", phase_slice_resnest),
                        ("slice_keypoint", phase_slice_keypoint), ("res5", phase_res5),
                        ("slice_proposals", phase_slice_proposals),
                        ("slice_backbones", phase_slice_backbones),
                        ("tta", phase_tta),
                        ("nms_ab", phase_nms_ab), ("train", phase_train),
                        ("train_centermask", phase_train_centermask),
                        ("train_cascade", phase_train_cascade),
                        ("train_swin", phase_train_swin),
                        ("train_keypoint", phase_train_keypoint),
                        ("train_proposals", phase_train_proposals),
                        ("train_aug", phase_train_aug),
                        ("train_dcn", phase_train_dcn),
                        ("train_ddp", phase_train_ddp),
                        ("stage1", phase_stage1), ("stage2", phase_stage2),
                        ("stage2_fcos", phase_stage2_fcos),
                        ("stage2_keypoint", phase_stage2_keypoint),
                        ("card_vs_cpu", phase_card_vs_cpu),
                        ("train_card_vs_cpu", phase_train_card_vs_cpu),
                        ("stage12_card_vs_cpu", phase_stage12_card_vs_cpu),
                        ("tools", phase_tools)):
        t0 = time.perf_counter()
        log(f"== phase {name}")
        phase(results)
        log(f"== phase {name} ok in {time.perf_counter() - t0:.1f} s")

    summary = []
    for name, (src, replaces, path) in KERNELS.items():
        r = results[name]
        if r["launches"].get(path, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {path} path")
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "path": path, "launches": r["launches"][path],
                 **r["tallies"][(path, "bfloat16")].summary(),
                 "launches_by_path": {p: n for p, n in r["launches"].items() if n},
                 "by_path_and_dtype": {f"{p} {d}": t.summary()
                                       for (p, d), t in r["tallies"].items()}}
        summary.append(entry)
    log(f"total {time.perf_counter() - t_all:.1f} s")
    log(smi)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
