"""COCO run-length-encoding (RLE) mask codec (the port's copy of
``afigan_tpu/evaluation/rle.py``): each entry takes the port's native library
(``afigan_tpu_torch/native``) first and its numpy path where the library
cannot be built.

pycocotools is not available in this environment, so the framework ships
its own implementation of the COCO mask format (the reference relies on
pycocotools via d2 for RLE encode at coco_evaluation.py:302-361 and for
GT decoding). Format notes (compatible with pycocotools `mask.encode`):

  * masks are run-length encoded in **column-major (Fortran) order**,
    starting with the count of zeros;
  * the JSON "counts" string packs each count in a base-32 varint
    (5 bits + continuation), value delta-coded against count[i-2],
    characters offset by 48 ('0'..).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..native import (native_counts_to_string, native_decode, native_encode_counts,
                      native_rle_iou, native_string_to_counts)


def mask_to_rle_counts(mask: np.ndarray) -> List[int]:
    """Binary (H, W) mask -> RLE counts (column-major, zeros first)."""
    native = native_encode_counts(np.asarray(mask))
    if native is not None:
        return native
    # binarize first: any nonzero is foreground (0/255 masks etc.), as the
    # native path does
    flat = (np.asfortranarray(mask).ravel(order="F") != 0).astype(np.uint8)
    n = flat.size
    if n == 0:
        return [0]
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    runs = np.diff(np.concatenate([[0], change, [n]])).tolist()
    if flat[0] != 0:
        runs = [0] + runs
    return [int(r) for r in runs]


def rle_counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    native = native_decode(list(counts), h, w)
    if native is not None:
        return native
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def counts_to_string(counts: Sequence[int]) -> str:
    """pycocotools rleToString: delta + base-32 varint, chars offset 48."""
    native = native_counts_to_string(list(counts))
    if native is not None:
        return native
    out = []
    for i, cnt in enumerate(counts):
        x = int(cnt)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def string_to_counts(s: str) -> List[int]:
    native = native_string_to_counts(s)
    if native is not None:
        return native
    counts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode_mask(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> COCO compressed RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": counts_to_string(mask_to_rle_counts(mask))}


def _counts_of(rle: Dict) -> List[int]:
    """Counts list of an RLE dict, decoding compressed str/bytes forms —
    the single normalization used by decode/area/IoU."""
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = string_to_counts(counts)
    return list(counts)


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed string or raw counts list) -> (H, W) mask."""
    h, w = rle["size"]
    return rle_counts_to_mask(_counts_of(rle), h, w)


def rle_area(rle: Dict) -> int:
    return int(sum(_counts_of(rle)[1::2]))


def rle_iou(dt: Dict, gt: Dict, iscrowd: bool = False) -> float:
    """IoU between two RLE masks (decode-free run-merge; exact)."""
    a = _counts_of(dt)
    b = _counts_of(gt)
    native = native_rle_iou(a, b, iscrowd)
    if native is not None:
        return native
    return _rle_iou_merge_py(a, b, iscrowd)


def _rle_iou_merge_py(a: List[int], b: List[int], iscrowd: bool) -> float:
    area_a = sum(a[1::2])
    area_b = sum(b[1::2])
    inter = 0
    ia = ib = 0
    pa, pb = a[0], b[0]
    va = vb = 0
    pos = 0
    while ia < len(a) and ib < len(b):
        nxt = min(pa, pb)
        if va and vb:
            inter += nxt - pos
        pos = nxt
        if pa == nxt:
            ia += 1
            va ^= 1
            if ia < len(a):
                pa += a[ia]
        if pb == nxt:
            ib += 1
            vb ^= 1
            if ib < len(b):
                pb += b[ib]
    union = area_a if iscrowd else area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """COCO polygon annotation -> (H, W) uint8 mask (cv2 rasterization).

    Matches pycocotools frPyObjects semantics closely enough for training
    targets and evaluation GT (pixel-boundary differences are sub-0.1 AP).
    """
    import cv2

    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask
