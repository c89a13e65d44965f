"""Training-dynamics validation of the port's three stages (counterpart of
``tools/validate_training.py``).

It drives the port's real trainers (``AFIGANTrainer``, ``AFExtractorTrainer``,
``TargetDetectorTrainer``: their loaders, hooks, writers and checkpoints) for
a few hundred iterations each on a generated COCO set of structured scenes
(a textured background and solid shapes whose class is the shape), hands the
weights on from stage to stage through the files the trainers write (stage
1's ``G_0/`` and ``D_0/`` into stage 2, stage 2's ``AFExtractor/`` into stage
3), and judges the loss curves in ``metrics.json``:

  stage 1: the content (L1 to the guide) loss falls; the adversarial terms
           stay finite and bounded;
  stage 2: the detector's losses fall (the foreground-gated ones from their
           peak); the total stays finite;
  stage 3: the detector's losses and the total fall.

    python -m afigan_tpu_torch.tools.validate_training --iters 150 --out <dir>
    python -m afigan_tpu_torch.tools.validate_training --tiny --iters 8 --device cpu --out <dir>

``--family`` picks the model: ``r50`` (Mask R-CNN R-50-FPN, stages 1-3),
``s101`` (Cascade Mask R-CNN ResNeSt-101-PAFPN, stage 3), ``fcos_bifpn``
(FCOS R-50-BiFPN, stage 2), ``swin`` (Cascade R-CNN Swin-T-BiFPN, stage 3),
``centermask`` (CenterMask R-50-BiFPN, stage 3), ``keypoint`` (Keypoint R-CNN
R-50-FPN: the R-50 Mask R-CNN YAML with the keypoint branch for the mask
branch, 3 keypoints an object, stage 3). It writes ``<out>/summary.json`` (the curves, the
verdicts, and each stage's median seconds an iteration and peak device
memory) and exits non-zero if a check fails. The default device is the GPU;
``--device cpu`` runs the plain versions on the CPU.

The scene generator, the config edits, the series, the trends and the judges
are the JAX tool's, so that one seed gives the same data and one
``metrics.json`` the same verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..config import CONFIGS

STEP1_YAML = str(CONFIGS / "step1_afigan_training" / "step1_afigan_mask_rcnn_R_50_FPN_1x.yaml")
STEP2_YAMLS = {
    "r50": str(CONFIGS / "step2_af_extractor_training" /
               "step2_af_extractor_mask_rcnn_R_50_FPN_1x.yaml"),
    "fcos_bifpn": str(CONFIGS / "step2_af_extractor_training" /
                      "step2_af_extractor_fcos_R_50_BiFPN.yaml"),
}
STEP3_YAMLS = {
    "r50": str(CONFIGS / "step3_afigan_mask_rcnn_R_50_FPN_3x.yaml"),
    "s101": str(CONFIGS / "inference" / "AFI-GAN_cascade_mask_rcnn_ResNeSt101_PAFPN.yaml"),
    "swin": str(CONFIGS / "inference" / "AFI-GAN_cascade_rcnn_swint_BiFPN_ST.yaml"),
    "centermask": str(CONFIGS / "inference" / "AFI-GAN_centermask_R_50_BiFPN.yaml"),
    "keypoint": str(CONFIGS / "inference" / "AFI-GAN_maskrcnn_R_50_FPN.yaml"),
}
DATASET = "dynval_train"


def make_scene_coco(root, num_images=16, hw=(480, 640), num_classes=3, seed=0):
    """COCO dataset of structured synthetic scenes: textured background +
    solid geometric objects (class = shape), so detection/mask losses have
    real signal. The JAX tool's draws in its order: one seed, the same
    images and JSON."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    h, w = hw
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        # low-frequency textured background
        base = rng.rand(h // 8, w // 8, 3)
        arr = np.kron(base, np.ones((8, 8, 1)))
        arr = (arr * 80 + 60).astype(np.float32)
        n_obj = rng.randint(3, 8)
        for _ in range(n_obj):
            cls = int(rng.randint(1, num_classes + 1))
            lo_w, lo_h = max(8, w // 10), max(8, h // 8)
            bw = int(rng.randint(lo_w, min(220, w // 2)))
            bh = int(rng.randint(lo_h, min(220, h // 2)))
            x = int(rng.randint(0, w - bw - 1))
            y = int(rng.randint(0, h - bh - 1))
            color = rng.rand(3) * 155 + 100
            yy, xx = np.mgrid[0:bh, 0:bw]
            if cls == 1:  # rectangle
                mask = np.ones((bh, bw), bool)
            elif cls == 2:  # ellipse
                mask = (((yy - bh / 2) / (bh / 2)) ** 2
                        + ((xx - bw / 2) / (bw / 2)) ** 2) <= 1.0
            else:  # triangle
                mask = xx / bw + yy / bh <= 1.0
            region = arr[y:y + bh, x:x + bw]
            region[mask] = color
            # polygon = the mask's bbox outline for rect, coarse hull else
            if cls == 1:
                poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            elif cls == 2:
                t = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                px = x + bw / 2 + (bw / 2) * np.cos(t)
                py = y + bh / 2 + (bh / 2) * np.sin(t)
                poly = [v for xy in zip(px, py) for v in xy]
            else:
                poly = [x, y, x + bw, y, x, y + bh]
            # 3 keypoints per object (center, upper-left-third,
            # lower-right-third, visibility 2)
            kps = [x + bw / 2, y + bh / 2, 2,
                   x + bw / 4, y + bh / 4, 2,
                   x + 3 * bw / 4, y + 3 * bh / 4, 2]
            annotations.append({
                "id": ann_id, "image_id": i + 1, "category_id": cls,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(mask.sum()),
                "segmentation": [list(map(float, poly))],
                "keypoints": list(map(float, kps)),
                "num_keypoints": 3,
                "iscrowd": 0,
            })
            ann_id += 1
        fname = f"scene_{i}.jpg"
        Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(os.path.join(img_dir, fname))
        images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
    js = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c, "name": f"shape{c}",
                        "keypoints": ["center", "ul", "lr"],
                        "skeleton": [[1, 2], [1, 3]]}
                       for c in range(1, num_classes + 1)],
    }
    json_path = os.path.join(root, "instances.json")
    with open(json_path, "w") as f:
        json.dump(js, f)
    return json_path, img_dir


def _cfg(stage_yaml, out_dir, iters, tiny):
    """The stage's YAML with the JAX tool's edits, key for key."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(stage_yaml)
    cfg.OUTPUT_DIR = out_dir
    cfg.DATASETS.TRAIN = (DATASET,)
    cfg.DATASETS.TEST = (DATASET,)
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.SOLVER.MAX_ITER = iters
    cfg.SOLVER.CHECKPOINT_PERIOD = iters
    cfg.TEST.EVAL_PERIOD = 0
    # a few hundred iterations: the production 1000-iteration warm-up would
    # mask the dynamics; a short ramp keeps random init stable
    cfg.SOLVER.WARMUP_ITERS = min(30, max(1, iters // 5))
    # norm clipping: a random-init detector at production lr diverges
    # within 2 iterations without it
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.DATALOADER.NUM_WORKERS = 2
    if tiny:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.MODEL.FPN.OUT_CHANNELS = 32
        cfg.MODEL.AFI.IN_CHANNELS = 32
        cfg.MODEL.AFI.N_RDB = 1
        cfg.MODEL.AFI.GROWTH_RATE = 8
        cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 64
        cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 32
        cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 16
        cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
        cfg.INPUT.MIN_SIZE_TRAIN = (64,)
        cfg.INPUT.MAX_SIZE_TRAIN = 96
        cfg.TPU.IMAGE_BUCKETS = [[128, 128]]
        cfg.TPU.MAX_GT_BOXES = 8
        cfg.TPU.MASK_CANVAS = 32
        cfg.SOLVER.IMS_PER_BATCH = 2
    else:
        cfg.SOLVER.IMS_PER_BATCH = 8
        cfg.TPU.MAX_GT_BOXES = 16
    return cfg


def _family_overrides(cfg, fam, tiny):
    """The family's edits on top of ``_cfg`` (the JAX tool's)."""
    if fam == "s101":
        # the reference stage-3 lr scaled to the batch (0.02 at 16 -> 0.005 at 4)
        cfg.SOLVER.BASE_LR = 0.005
        cfg.SOLVER.IMS_PER_BATCH = 2 if tiny else 4
        if tiny:
            cfg.MODEL.RESNETS.DEPTH = 50  # radix/AVD/deep-stem kept
    elif fam == "fcos_bifpn":
        # dual-scale BiFPN needs 256-divisible full canvases
        cfg.MODEL.FCOS.NUM_CLASSES = 3
        cfg.SOLVER.IMS_PER_BATCH = 2 if tiny else 4
        if tiny:
            cfg.TPU.IMAGE_BUCKETS = [[256, 256]]
            cfg.MODEL.BIFPN.OUT_CHANNELS = 32
            cfg.MODEL.BIFPN.FPN_REPEAT = 1
            cfg.MODEL.AFI.IN_CHANNELS = 32
            cfg.MODEL.FCOS.NUM_CONVS = 1
    elif fam == "centermask":
        cfg.MODEL.FCOS.NUM_CLASSES = 3
        cfg.SOLVER.BASE_LR = 0.0025
        cfg.SOLVER.IMS_PER_BATCH = 2 if tiny else 4
        if tiny:
            cfg.TPU.IMAGE_BUCKETS = [[128, 128]]
            cfg.MODEL.BIFPN.OUT_CHANNELS = 32
            cfg.MODEL.BIFPN.FPN_REPEAT = 1
            cfg.MODEL.AFI.IN_CHANNELS = 32
            cfg.MODEL.FCOS.NUM_CONVS = 1
    elif fam == "keypoint":
        # Keypoint R-CNN R-50-FPN stage 3: the mask branch swapped for the
        # keypoint branch; the scenes carry 3 keypoints an object
        cfg.MODEL.MASK_ON = False
        cfg.MODEL.KEYPOINT_ON = True
        cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 3
        cfg.SOLVER.BASE_LR = 0.005
        cfg.SOLVER.IMS_PER_BATCH = 2 if tiny else 4
    elif fam == "swin":
        # Swin-T BiFPN cascade: the AdamW + LayerNorm + bf16 training path
        cfg.MODEL.SWINT.EMBED_DIM = 96
        cfg.MODEL.SWINT.DEPTHS = [2, 2, 6, 2]
        cfg.MODEL.SWINT.NUM_HEADS = [3, 6, 12, 24]
        cfg.MODEL.SWINT.WINDOW_SIZE = 7
        cfg.SOLVER.OPTIMIZER = "ADAMW"
        cfg.SOLVER.BASE_LR = 1e-4
        cfg.SOLVER.WEIGHT_DECAY = 0.05
        cfg.SOLVER.IMS_PER_BATCH = 2 if tiny else 4
        if tiny:
            cfg.TPU.IMAGE_BUCKETS = [[128, 128]]
            cfg.MODEL.SWINT.EMBED_DIM = 32
            cfg.MODEL.SWINT.DEPTHS = [1, 1, 1, 1]
            cfg.MODEL.SWINT.NUM_HEADS = [2, 2, 2, 2]
            cfg.MODEL.BIFPN.OUT_CHANNELS = 32
            cfg.MODEL.BIFPN.FPN_REPEAT = 1
            cfg.MODEL.AFI.IN_CHANNELS = 32
    return cfg


def _series(out_dir, key):
    """Series of `key` from metrics.json; a trailing '*' sums every key
    with that prefix (the stage steps emit per-pyramid-level metrics,
    e.g. content_loss_p2..p6)."""
    prefix = key[:-1] if key.endswith("*") else None
    vals = []
    with open(os.path.join(out_dir, "metrics.json")) as f:
        for line in f:
            rec = json.loads(line)
            if prefix is not None:
                ks = [k for k in rec if k.startswith(prefix)]
                if ks:
                    vals.append((rec.get("iteration", len(vals)),
                                 float(sum(rec[k] for k in ks))))
            elif key in rec:
                vals.append((rec.get("iteration", len(vals)), float(rec[key])))
    return vals


def _trend(series):
    """(head_mean, tail_mean, fell) over the first/last 25% of points."""
    v = [x for _, x in series]
    if len(v) < 4:
        return None, None, False
    q = max(1, len(v) // 4)
    head, tail = float(np.mean(v[:q])), float(np.mean(v[-q:]))
    return head, tail, tail < head


def _trend_from_peak(series):
    """(peak_window_median, tail_median, fell): the decline from the peak
    rolling-window median. Foreground-gated losses (box_reg, mask) start near
    zero while the RPN proposes nothing that matches, rise as foregrounds
    get sampled, then fall as the heads learn; medians, because one spiky
    batch in the last window must not flip a falling curve."""
    v = [x for _, x in series]
    if len(v) < 4:
        return None, None, False
    q = max(1, len(v) // 4)
    windows = [float(np.median(v[i: i + q])) for i in range(0, len(v) - q + 1)]
    peak, tail = max(windows), float(np.median(v[-q:]))
    return peak, tail, tail < peak


def _judge_stage1(out1, tiny):
    content = _series(out1, "content_loss_*")
    g_adv = _series(out1, "adv_loss_*") or _series(out1, "g_loss")
    d_loss = _series(out1, "d_loss")
    h, t, fell = _trend(content)
    adv_vals = [x for _, x in g_adv] + [x for _, x in d_loss]
    adv_ok = bool(np.all(np.isfinite(adv_vals))) and max(adv_vals, default=0.0) < 100.0
    checks = {
        "content_head": h, "content_tail": t, "content_fell": fell,
        "adv_finite_bounded": adv_ok,
        "content_curve": content[:: max(1, len(content) // 40)],
        "d_curve": d_loss[:: max(1, len(d_loss) // 40)],
    }
    # tiny mode writes too few records for trends: the pipeline and
    # finiteness only
    return checks, (fell or tiny) and adv_ok


# The detector families' loss keys. "peak" keys are foreground-gated and
# judged by their decline from the peak; "head" keys head against tail. The
# cascade heads emit per-stage keys (the '*' sums them) and judge the total
# from its peak too: stage k's sampled foregrounds rise only after stage
# k-1's boxes clear the tighter IoU, so the per-stage losses peak in sequence.
DET_KEYS = {
    "rcnn": {"head": ("loss_cls",), "peak": ("loss_box_reg", "loss_mask")},
    "cascade": {"head": (),
                "peak": ("loss_cls_stage*", "loss_box_reg_stage*", "loss_mask"),
                "total_from_peak": True},
    "cascade_nomask": {"head": (),
                       "peak": ("loss_cls_stage*", "loss_box_reg_stage*"),
                       "total_from_peak": True},
    "fcos": {"head": ("loss_fcos_cls",),
             "peak": ("loss_fcos_loc", "loss_fcos_ctr")},
    "centermask": {"head": ("loss_fcos_cls",),
                   "peak": ("loss_fcos_loc", "loss_fcos_ctr", "loss_mask")},
    "keypoint_rcnn": {"head": ("loss_cls",),
                      "peak": ("loss_box_reg", "loss_keypoint")},
}


def _judge_stage2(out2, tiny, det="rcnn"):
    keys = DET_KEYS[det]
    checks = {}
    stage_ok = True
    for key in keys["head"] + keys["peak"] + ("content_loss_*",):
        s = _series(out2, key)
        if key in keys["peak"]:
            h, t, fell = _trend_from_peak(s)
            checks[key] = {"peak": h, "tail": t, "fell": fell}
        else:
            h, t, fell = _trend(s)
            checks[key] = {"head": h, "tail": t, "fell": fell}
        if key != "content_loss_*":  # against a random guide: recorded only
            stage_ok &= fell or tiny
    total = _series(out2, "total_loss")
    checks["total_finite"] = bool(np.all(np.isfinite([x for _, x in total])))
    stage_ok &= checks["total_finite"]
    checks["total_curve"] = total[:: max(1, len(total) // 40)]
    return checks, stage_ok


def _judge_stage3(out3, tiny, det="rcnn"):
    keys = DET_KEYS[det]
    checks = {}
    stage_ok = True
    for key in keys["head"] + keys["peak"] + ("total_loss",):
        s = _series(out3, key)
        from_peak = key in keys["peak"] or (key == "total_loss" and keys.get("total_from_peak"))
        if from_peak:
            h, t, fell = _trend_from_peak(s)
            checks[key] = {"peak": h, "tail": t, "fell": fell}
        else:
            h, t, fell = _trend(s)
            checks[key] = {"head": h, "tail": t, "fell": fell}
        stage_ok &= fell or tiny
    total = _series(out3, "total_loss")
    checks["total_curve"] = total[:: max(1, len(total) // 40)]
    return checks, stage_ok


JUDGES = {"1": _judge_stage1, "2": _judge_stage2, "3": _judge_stage3}
FIXED_STAGE = {"s101": "3", "fcos_bifpn": "2", "swin": "3", "centermask": "3",
               "keypoint": "3"}
FAMILY_DET_KEYS = {"r50": "rcnn", "s101": "cascade", "fcos_bifpn": "fcos",
                   "swin": "cascade_nomask", "centermask": "centermask",
                   "keypoint": "keypoint_rcnn"}


def _judge(stage, out_s, tiny, det_keys):
    if stage == "1":
        return JUDGES[stage](out_s, tiny)
    return JUDGES[stage](out_s, tiny, det=det_keys)


def _train(trainer_cls, cfg, device):
    """One stage's trainer built and trained; (median seconds an iteration
    over the writer's records, peak device memory in GiB or None on the
    CPU)."""
    import torch

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trainer_cls(cfg, device=device).train(resume=False)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    times = [x for _, x in _series(cfg.OUTPUT_DIR, "iter_time")]
    return {"median_iter_s": float(np.median(times)) if times else None,
            "median_data_s": float(np.median([x for _, x in _series(cfg.OUTPUT_DIR,
                                                                     "data_time")] or [0.0])),
            "peak_gib": peak}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--out", default=os.path.join("output", "validate_training"))
    ap.add_argument("--tiny", action="store_true", help="shrunken CPU-speed smoke mode")
    ap.add_argument("--stages", default=None,
                    help="comma list of stages (default 1,2,3; non-r50 families run a "
                         "single fixed stage and reject a conflicting value)")
    ap.add_argument("--lr", type=float, default=None, help="override SOLVER.BASE_LR")
    ap.add_argument("--family", default="r50", choices=sorted(FAMILY_DET_KEYS))
    ap.add_argument("--rejudge", action="store_true",
                    help="skip training; recompute verdicts from the metrics.json files "
                         "already in --out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fixed = FIXED_STAGE.get(args.family)
    if fixed is not None:
        if args.stages is not None and args.stages != fixed:
            ap.error(f"--family {args.family} runs stage {fixed} only; "
                     f"--stages {args.stages} conflicts")
        args.stages = fixed
    elif args.stages is None:
        args.stages = "1,2,3"
    return args


def _finish(summary, ok, out):
    summary["ok"] = bool(ok)
    with open(os.path.join(out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary["stages"], indent=2))
    print("DYNAMICS OK" if ok else "DYNAMICS FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    args = parse_args(argv)
    fam = args.family
    det_keys = FAMILY_DET_KEYS[fam]
    stages = [s for s in ("1", "2", "3") if s in args.stages.split(",")]

    if args.rejudge:
        summary = {"iters": args.iters, "tiny": args.tiny, "family": fam,
                   "rejudged": True, "stages": {}}
        ok = True
        for s in stages:
            out_s = os.path.join(args.out, f"s{s}")
            if os.path.isfile(os.path.join(out_s, "metrics.json")):
                checks, stage_ok = _judge(s, out_s, args.tiny, det_keys)
                summary["stages"][s] = checks
                ok &= stage_ok
        return _finish(summary, ok, args.out)

    from ..data.coco import CocoDataset, register_dataset
    from ..engine.trainers import AFExtractorTrainer, AFIGANTrainer, TargetDetectorTrainer
    from ..models.build import check_device

    check_device(args.device, "validate_training")
    os.makedirs(args.out, exist_ok=True)
    hw = (96, 128) if args.tiny else (480, 640)
    json_path, img_dir = make_scene_coco(os.path.join(args.out, "data"),
                                         num_images=4 if args.tiny else 16, hw=hw)
    ds = CocoDataset(json_path, img_dir)
    register_dataset(DATASET, lambda: ds)

    summary = {"iters": args.iters, "tiny": args.tiny, "family": fam, "device": args.device,
               "stages": {}, "timing": {}}
    ok = True
    handoff = {}  # the previous stage's checkpoints, as the next reads them

    def configure(stage_yaml, out_s):
        cfg = _cfg(stage_yaml, out_s, args.iters, args.tiny)
        if stage_yaml != STEP1_YAML:
            cfg = _family_overrides(cfg, fam, args.tiny)
        if args.lr is not None:
            cfg.SOLVER.BASE_LR = args.lr
        return cfg

    for s in stages:
        out_s = os.path.join(args.out, f"s{s}")
        ckpt = f"model_{args.iters:07d}.pth"
        if s == "1":
            cfg = configure(STEP1_YAML, out_s)
            trainer = AFIGANTrainer
        elif s == "2":
            cfg = configure(STEP2_YAMLS[fam], out_s)
            for key, path in (("AFI_GEN_WEIGHTS", handoff.get("G")),
                              ("AFI_DIS_WEIGHTS", handoff.get("D"))):
                if path and os.path.isfile(path):
                    cfg.MODEL[key] = path
            trainer = AFExtractorTrainer
        else:
            cfg = configure(STEP3_YAMLS[fam], out_s)
            path = handoff.get("AFExtractor")
            if path and os.path.isfile(path):
                cfg.MODEL.AF_EXTRACTOR_WEIGHTS = path
            trainer = TargetDetectorTrainer
        summary["timing"][s] = _train(trainer, cfg, args.device)
        checks, stage_ok = _judge(s, out_s, args.tiny, det_keys)
        summary["stages"][s] = checks
        ok &= stage_ok
        if s == "1":
            handoff["G"] = os.path.join(out_s, "G_0", ckpt)
            handoff["D"] = os.path.join(out_s, "D_0", ckpt)
        elif s == "2":
            handoff["AFExtractor"] = os.path.join(out_s, "AFExtractor", ckpt)
    return _finish(summary, ok, args.out)


if __name__ == "__main__":
    sys.exit(main())
