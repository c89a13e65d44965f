"""COCO-style AP evaluation — self-contained numpy implementation.

The reference evaluates via pycocotools COCOeval wrapped by its
COCOEvaluator (ref: afigan/evaluation/coco_evaluation.py:477-511);
pycocotools is not in this image, so the framework owns the full
algorithm: greedy score-ordered matching per (image, category) at IoU
thresholds 0.50:0.05:0.95, crowd/area-range ignore handling, 101-point
interpolated precision, AP/AP50/AP75/APs/APm/APl + AR summaries — the
standard COCO protocol, reimplemented from its definition.

`CocoEvaluator` mirrors the d2-style evaluator surface: per-batch
``process(predictions)`` accumulation and ``evaluate()`` returning
{"bbox": {...}, "segm": {...}}. The port's copy of
``afigan_tpu/evaluation/coco_eval.py``, single process only (no gather
across hosts); a CPU test holds the two evaluators' AP equal.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from .rle import encode_mask, rle_area

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100

# COCO person-keypoint OKS sigmas (pycocotools cocoeval.py kpt_oks_sigmas)
KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]
) / 10.0


def _bbox_iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """xywh boxes: (D, 4) x (G, 4) -> (D, G); crowd gt → intersection/dt-area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.clip(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]),
        0, None,
    )
    iy = np.clip(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]),
        0, None,
    )
    inter = ix * iy
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _oks_iou_matrix(dts: List[Dict], gts: List[Dict],
                    sigmas: np.ndarray = None) -> np.ndarray:
    """OKS keypoint similarity (pycocotools computeOks numerics).

    dt/gt keypoints: flat [x1, y1, v1, x2, y2, v2, ...]; gt 'area' and
    'bbox' drive the scale / unlabeled-gt fallback window. ``sigmas``
    overrides the COCO-person table (TEST.KEYPOINT_OKS_SIGMAS).
    """
    if not dts or not gts:
        return np.zeros((len(dts), len(gts)))
    sigmas = KPT_SIGMAS if sigmas is None else np.asarray(sigmas, np.float64)
    var = (sigmas * 2) ** 2
    k = len(sigmas)
    out = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        x0, y0, w, h = gt["bbox"]
        # pycocotools computeOks padded window: [x0-w, x0+2w] x [y0-h, y0+2h]
        x1b, x2b = x0 - w, x0 + w * 2
        y1b, y2b = y0 - h, y0 + h * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                # all gt keypoints unlabeled: distance to the padded box
                dx = np.maximum(x1b - xd, 0) + np.maximum(xd - x2b, 0)
                dy = np.maximum(y1b - yd, 0) + np.maximum(yd - y2b, 0)
            e = (dx**2 + dy**2) / var / (gt.get("area", w * h) + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            out[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return out


def _segm_iou_matrix(dt_rles: List, gt_rles: List, iscrowd: np.ndarray) -> np.ndarray:
    """Decode-free RLE IoU (run-merge walk)."""
    from .rle import rle_iou

    if not dt_rles or not gt_rles:
        return np.zeros((len(dt_rles), len(gt_rles)))
    out = np.zeros((len(dt_rles), len(gt_rles)))
    for j, g in enumerate(gt_rles):
        for i, d in enumerate(dt_rles):
            out[i, j] = rle_iou(d, g, bool(iscrowd[j]))
    return out


def _keypoint_gt_unlabeled(g: Dict) -> bool:
    """pycocotools keypoint protocol: gts with no labeled keypoints are
    ignored (gt['ignore'] = num_keypoints == 0)."""
    if "num_keypoints" in g:
        return int(g["num_keypoints"]) == 0
    kp = g.get("keypoints")
    if kp is None:
        return True
    return not (np.asarray(kp, np.float64)[2::3] > 0).any()


def _evaluate_img(dts, gts, ious, area_rng, max_det=MAX_DETS,
                  keypoints_mode=False):
    """Greedy matching for one (img, cat, area-range); returns match arrays."""
    T = len(IOU_THRS)
    gt_ig = np.array(
        [
            g["iscrowd"]
            or g["area"] < area_rng[0]
            or g["area"] > area_rng[1]
            or (keypoints_mode and _keypoint_gt_unlabeled(g))
            for g in gts
        ],
        dtype=bool,
    ) if gts else np.zeros(0, bool)
    # gts sorted: non-ignored first (stable)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_ig = gt_ig[g_order]
    G = len(gts)
    D = min(len(dts), max_det)

    dtm = np.zeros((T, D), dtype=np.int64)  # matched gt id (+1) or 0
    dt_ig = np.zeros((T, D), dtype=bool)
    gtm = np.zeros((T, G), dtype=np.int64)

    if G and D:
        ious_s = ious[:D][:, g_order]
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best = thr if thr > 1e-10 else 1e-10
                best = min(best, 1 - 1e-10)
                m = -1
                for g in range(G):
                    if gtm[t, g] > 0 and not gts[g_order[g]]["iscrowd"]:
                        continue
                    # stop at ignored gts once a non-ignored match found
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break
                    if ious_s[d, g] < best:
                        continue
                    best = ious_s[d, g]
                    m = g
                if m == -1:
                    continue
                dt_ig[t, d] = gt_ig[m]
                dtm[t, d] = g_order[m] + 1
                gtm[t, m] = d + 1

    # unmatched dts outside the area range are ignored
    d_areas = np.array([dt["area"] for dt in dts[:D]]) if D else np.zeros(0)
    out_rng = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
    dt_ig = dt_ig | ((dtm == 0) & out_rng[None, :])

    return {
        "dtm": dtm,
        "dt_ig": dt_ig,
        "gt_ig": gt_ig,
        "scores": np.array([dt["score"] for dt in dts[:D]]) if D else np.zeros(0),
    }


class CocoEvalNP:
    """Evaluate detections vs COCO-format GT for one iou_type.

    iou_type: "bbox" | "segm" | "keypoints" (keypoints = OKS similarity,
    pycocotools keypoint protocol: maxDets (20,), area ranges all/medium/
    large). ``max_dets``: detection-count caps; the LAST entry is the
    primary cap used for the AP family and area-range ARs; each entry
    yields an AR@k summary (pycocotools (1, 10, 100) default).
    ``class_names``: enables the per-category AP table
    (ref coco_evaluation.py:233-299) as "AP-{name}" entries.
    """

    def __init__(self, gt_anns: Sequence[Dict], dt_anns: Sequence[Dict],
                 img_ids: Sequence, cat_ids: Sequence, iou_type: str = "bbox",
                 max_dets: Sequence[int] = (1, 10, MAX_DETS),
                 class_names: Sequence[str] = (),
                 oks_sigmas=None):
        self.iou_type = iou_type
        self.oks_sigmas = oks_sigmas
        self.img_ids = list(img_ids)
        self.cat_ids = list(cat_ids)
        self.class_names = list(class_names)
        if iou_type == "keypoints":
            max_dets = (20,)
            self.area_rng = {k: AREA_RNG[k] for k in ("all", "medium", "large")}
        else:
            self.area_rng = dict(AREA_RNG)
        self.max_dets = sorted(int(m) for m in max_dets)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gt_anns:
            g.setdefault("iscrowd", 0)
            if "area" not in g:
                g["area"] = g["bbox"][2] * g["bbox"][3]
            self._gts[(g["image_id"], g["category_id"])].append(g)
        for d in dt_anns:
            # Per-task dt area (pycocotools loadRes semantics): segm uses
            # the MASK area, keypoints the keypoint-extent area, bbox the
            # box area. The prediction dicts are SHARED across the tasks'
            # CocoEvalNP instances, so shallow-copy before writing — a
            # prior task's area must not leak into this one (bbox w*h
            # clobbering segm mask areas skews APs/APm/APl).
            d = dict(d)
            if iou_type == "segm" and "segmentation" in d:
                d["area"] = float(rle_area(d["segmentation"]))
            elif iou_type == "keypoints" and "keypoints" in d:
                kp = np.asarray(d["keypoints"], np.float64)
                xs, ys = kp[0::3], kp[1::3]
                d["area"] = float(
                    (xs.max() - xs.min()) * (ys.max() - ys.min())
                ) if len(xs) else 0.0
            else:
                d["area"] = d["bbox"][2] * d["bbox"][3]
            self._dts[(d["image_id"], d["category_id"])].append(d)

    def run(self) -> Dict[str, float]:
        T, R = len(IOU_THRS), len(REC_THRS)
        K = len(self.cat_ids)
        A = len(self.area_rng)
        M = len(self.max_dets)
        max_det = self.max_dets[-1]  # primary cap
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for k, cat in enumerate(self.cat_ids):
            per_img = []
            for img in self.img_ids:
                gts = self._gts.get((img, cat), [])
                dts = sorted(
                    self._dts.get((img, cat), []), key=lambda d: -d["score"]
                )
                if not gts and not dts:
                    per_img.append(None)
                    continue
                iscrowd = np.array([bool(g["iscrowd"]) for g in gts])
                if self.iou_type == "bbox":
                    ious = _bbox_iou_matrix(
                        np.array([d["bbox"] for d in dts[:max_det]]).reshape(-1, 4),
                        np.array([g["bbox"] for g in gts]).reshape(-1, 4),
                        iscrowd,
                    )
                elif self.iou_type == "keypoints":
                    ious = _oks_iou_matrix(dts[:max_det], gts,
                                           sigmas=self.oks_sigmas)
                else:
                    ious = _segm_iou_matrix(
                        [d["segmentation"] for d in dts[:max_det]],
                        [g["segmentation"] for g in gts],
                        iscrowd,
                    )
                per_img.append(
                    {
                        rng_name: _evaluate_img(
                            dts, gts, ious, rng, max_det,
                            keypoints_mode=self.iou_type == "keypoints",
                        )
                        for rng_name, rng in self.area_rng.items()
                    }
                )

            for a, rng_name in enumerate(self.area_rng):
                all_evals = [e[rng_name] for e in per_img if e is not None]
                if not all_evals:
                    continue
                n_gt = int(sum((~e["gt_ig"]).sum() for e in all_evals))
                if n_gt == 0:
                    continue
                for mi, md in enumerate(self.max_dets):
                    # pycocotools truncates PER IMAGE before the global sort
                    scores = np.concatenate([e["scores"][:md] for e in all_evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate(
                        [e["dtm"][:, :md] for e in all_evals], axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e["dt_ig"][:, :md] for e in all_evals], axis=1)[:, order]
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[t, k, a, mi] = rc[-1] if len(rc) else 0.0
                        # precision envelope (monotone decreasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < len(pr):
                                q[ri] = pr[pi]
                        precision[t, :, k, a, mi] = q

        areas = list(self.area_rng)

        def ap(t=None, area="all", k=None):
            a = areas.index(area)
            p = precision[:, :, :, a, -1]
            if t is not None:
                p = p[[t]]
            if k is not None:
                p = p[:, :, [k]]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else float("nan")

        def ar(mi=-1, area="all"):
            a = areas.index(area)
            r = recall[:, :, a, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else float("nan")

        if self.iou_type == "keypoints":
            out = {
                "AP": 100 * ap(), "AP50": 100 * ap(t=0), "AP75": 100 * ap(t=5),
                "APm": 100 * ap(area="medium"), "APl": 100 * ap(area="large"),
                "AR": 100 * ar(), "ARm": 100 * ar(area="medium"),
                "ARl": 100 * ar(area="large"),
            }
        else:
            out = {
                "AP": 100 * ap(),
                "AP50": 100 * ap(t=0),
                "AP75": 100 * ap(t=5),
                "APs": 100 * ap(area="small"),
                "APm": 100 * ap(area="medium"),
                "APl": 100 * ap(area="large"),
            }
            for mi, md in enumerate(self.max_dets):
                out[f"AR@{md}"] = 100 * ar(mi=mi)
            out["ARs"] = 100 * ar(area="small")
            out["ARm"] = 100 * ar(area="medium")
            out["ARl"] = 100 * ar(area="large")
        # per-category AP table (ref coco_evaluation.py:233-299)
        for k, name in enumerate(self.class_names[: K]):
            out[f"AP-{name}"] = 100 * ap(k=k)
        return out


class CocoEvaluator:
    """Accumulating evaluator with the d2 COCOEvaluator surface."""

    def __init__(self, dataset, tasks=("bbox",), oks_sigmas=None):
        """dataset: object with .annotations (COCO gt anns), .img_ids,
        .cat_ids, and .contiguous_to_cat_id mapping. ``oks_sigmas``:
        per-keypoint OKS sigmas (TEST.KEYPOINT_OKS_SIGMAS; COCO-person
        table when None)."""
        self.dataset = dataset
        self.tasks = tuple(tasks)
        self.oks_sigmas = oks_sigmas
        self.predictions: List[Dict] = []

    def reset(self):
        self.predictions = []

    def process(self, image_ids, boxes, scores, classes, valid, masks=None,
                mask_threshold: float = 0.5, keypoints=None):
        """Accumulate one batch of padded predictions (host numpy arrays).

        boxes: (B, D, 4) xyxy in ORIGINAL image coords; masks: (B, D, H, W)
        float paste-ready full-image masks or None; keypoints: (B, D, K, 3)
        (x, y, score) in original coords or None.
        """
        to_cat = self.dataset.contiguous_to_cat_id
        for i, img_id in enumerate(image_ids):
            v = np.asarray(valid[i], dtype=bool)
            for j in np.nonzero(v)[0]:
                x1, y1, x2, y2 = [float(t) for t in np.asarray(boxes[i][j])]
                pred = {
                    "image_id": int(img_id),
                    "category_id": int(to_cat[int(classes[i][j])]),
                    "bbox": [x1, y1, x2 - x1, y2 - y1],
                    "score": float(scores[i][j]),
                }
                if masks is not None:
                    m = np.asarray(masks[i][j]) >= mask_threshold
                    pred["segmentation"] = encode_mask(m.astype(np.uint8))
                if keypoints is not None:
                    pred["keypoints"] = (
                        np.asarray(keypoints[i][j], np.float64).reshape(-1).tolist()
                    )
                self.predictions.append(pred)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        predictions = self.predictions
        results = {}
        for task in self.tasks:
            gt_anns = self.dataset.annotations
            if task == "segm":
                gt_anns = [self._gt_segm_to_rle(g) for g in gt_anns]
            ev = CocoEvalNP(
                gt_anns, predictions,
                self.dataset.img_ids, self.dataset.cat_ids, iou_type=task,
                class_names=getattr(self.dataset, "class_names", ()),
                oks_sigmas=self.oks_sigmas,
            )
            results[task] = ev.run()
        return results

    def _gt_segm_to_rle(self, g: Dict) -> Dict:
        """GT polygon segmentations → RLE (pycocotools annToRLE semantics);
        RLE dicts (crowd regions) pass through unchanged."""
        seg = g.get("segmentation")
        if not isinstance(seg, list):
            return g
        from .rle import encode_mask, polygons_to_mask

        h, w = self.dataset.img_hw[g["image_id"]]
        out = dict(g)
        out["segmentation"] = encode_mask(
            polygons_to_mask(seg, int(h), int(w)).astype(np.uint8)
        )
        return out
