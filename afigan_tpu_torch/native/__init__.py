"""The port's native host library (counterpart of ``afigan_tpu/native``): the
COCO RLE codec and IoU entries of ``rle_native.cpp``, bound through ctypes.

The library is compiled with ``g++ -O3 -shared -fPIC`` at first use into
``build/native/rle_native-<hash>.so``, the hash over the source and the
flags, so an edited source is rebuilt and a stale library never loaded. A
process compiles to a name of its own and renames the result into place, so
processes that reach first use together (test workers, data-parallel ranks)
each load a whole file; within a process a lock makes the threads that reach
it together (the loader's mapping threads) wait for one build.

``get_lib()`` returns None where the library cannot be built (no ``g++``, a
failed compile: the compiler's output is logged once), and every
``native_*`` wrapper then returns None, on which
``evaluation/rle.py`` takes its numpy path. ``require_lib()`` builds it or
raises with the compiler's output. ``CALLS`` counts each entry's calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("rle_native.cpp")
REPO = SRC.parents[2]
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
ENTRIES = ("rle_encode", "rle_decode", "rle_counts_to_string", "rle_string_to_counts",
           "bbox_iou_matrix", "rle_iou_single")

# calls of each C entry, by the wrappers below (a wrapper adds one where it
# calls its entry, and nowhere else)
CALLS: Dict[str, int] = {name: 0 for name in ENTRIES}

logger = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the library could not be had (logged once)


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def build_dir() -> Path:
    return REPO / "build" / "native"


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return build_dir() / f"rle_native-{h.hexdigest()[:12]}.so"


def _compile() -> Path:
    """The library's path, compiled first if missing; RuntimeError with the
    compiler's output if it cannot be."""
    path = lib_path()
    if path.exists():
        return path
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the native RLE library cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (rc {proc.returncode}) on {SRC}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"g++ timed out on {SRC}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return path


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    I = ctypes.c_int
    sigs = {
        "rle_encode": (I, [u8p, I, I, i64p, I]),
        "rle_decode": (None, [i64p, I, I, I, u8p]),
        "rle_counts_to_string": (I, [i64p, I, ctypes.c_char_p, I]),
        "rle_string_to_counts": (I, [ctypes.c_char_p, I, i64p, I]),
        "bbox_iou_matrix": (None, [f64p, I, f64p, I, u8p, f64p]),
        "rle_iou_single": (ctypes.c_double, [i64p, I, i64p, I, I]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _get(strict: bool) -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is None and (strict or _error is None):
            try:
                _lib = _load(_compile())
            except (RuntimeError, OSError) as e:
                if strict:
                    raise
                _error = str(e)
                logger.warning("native RLE library unavailable, the numpy codec runs: %s", e)
        return _lib


def require_lib() -> ctypes.CDLL:
    """The loaded library, built first if missing; raises (the compiler's
    output) if it cannot be built or loaded."""
    return _get(strict=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None where it cannot be built (tried once a
    process; the reason logged once)."""
    return _lib if _lib is not None else _get(strict=False)


def _call(name: str, *args):
    fn = getattr(get_lib(), name)
    with _lock:
        CALLS[name] += 1
    return fn(*args)


# ---------------------------------------------------------------------------
# numpy-facing wrappers: None where the library is absent
# ---------------------------------------------------------------------------

def native_encode_counts(mask: np.ndarray) -> Optional[List[int]]:
    if get_lib() is None:
        return None
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"rle_encode takes a (H, W) mask, got shape {mask.shape}")
    if mask.dtype not in (np.uint8, np.bool_):
        mask = mask != 0  # any non-zero is foreground, as on the numpy path
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    cap = m.size + 2
    out = np.empty(cap, np.int64)
    n = _call("rle_encode", m, m.shape[0], m.shape[1], out, cap)
    if n < 0:
        return None
    return out[:n].tolist()


def native_decode(counts: List[int], h: int, w: int) -> Optional[np.ndarray]:
    if get_lib() is None:
        return None
    if h < 0 or w < 0:
        raise ValueError(f"rle_decode: negative size {h}x{w}")
    c = np.ascontiguousarray(counts, dtype=np.int64)
    out = np.empty((h, w), np.uint8)
    _call("rle_decode", c, len(c), h, w, out)
    return out


def native_counts_to_string(counts: List[int]) -> Optional[str]:
    if get_lib() is None:
        return None
    c = np.ascontiguousarray(counts, dtype=np.int64)
    cap = 16 * len(c) + 16  # a 64-bit varint takes at most 13 characters
    buf = ctypes.create_string_buffer(cap)
    n = _call("rle_counts_to_string", c, len(c), buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode("ascii")


def native_string_to_counts(s: str) -> Optional[List[int]]:
    if get_lib() is None:
        return None
    b = s.encode("ascii")
    cap = len(b) + 2
    out = np.empty(cap, np.int64)
    n = _call("rle_string_to_counts", b, len(b), out, cap)
    if n < 0:
        return None
    return out[:n].tolist()


def native_bbox_iou(dt: np.ndarray, gt: np.ndarray,
                    iscrowd: np.ndarray) -> Optional[np.ndarray]:
    if get_lib() is None:
        return None
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    ic = np.ascontiguousarray(iscrowd, np.uint8)
    if len(ic) != len(gt):
        raise ValueError(f"bbox_iou_matrix: {len(ic)} crowd flags for {len(gt)} boxes")
    out = np.empty((len(dt), len(gt)), np.float64)
    _call("bbox_iou_matrix", dt, len(dt), gt, len(gt), ic, out)
    return out


def native_rle_iou(a: List[int], b: List[int], iscrowd: bool) -> Optional[float]:
    if get_lib() is None:
        return None
    aa = np.ascontiguousarray(a, np.int64)
    bb = np.ascontiguousarray(b, np.int64)
    v = float(_call("rle_iou_single", aa, len(aa), bb, len(bb), int(iscrowd)))
    if v < 0:  # an empty counts list: the numpy merge's a[0] / b[0]
        raise IndexError("rle_iou: an empty counts list")
    return v
