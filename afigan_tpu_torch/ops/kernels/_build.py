"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (``build/kernels/<name>-<hash>.so``) and loaded
with ``ctypes``. The file name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded. All
missing libraries are compiled in parallel, one ``nvcc`` per source.
Nothing is compiled or loaded at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
REPO = PKG.parent

SOURCES = {
    "roi_pool": ("roi_pool.cu",),
    "afi_conv3x3": ("afi_conv3x3.cu", "afi_conv_common.cuh"),
    "afi_upsample": ("afi_upsample.cu", "afi_conv_common.cuh"),
    "layer_norm": ("layer_norm.cu",),
    "window_attention": ("window_attention.cu",),
    "window_gather": ("window_gather.cu",),
    "nms": ("nms.cu",),
    "deform_conv": ("deform_conv.cu",),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}

# Launches of the hand-written kernels, by the JAX function each replaces.
# A wrapper adds one where it launches a kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {"afi_chain": 0, "afi_upsample": 0, "afi_rdb": 0,
                            "roi_pool": 0, "roi_pool_bwd": 0, "layer_norm": 0,
                            "window_attention": 0, "window_gather": 0, "nms": 0,
                            "deform_conv": 0, "deform_conv_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> Path:
    return REPO / "build" / "kernels"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES[name]:
        h.update((CSRC / src).read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named (default: all) libraries that are missing, in
    parallel. Returns {name: seconds} for those compiled; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    secs, errors = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        PTXAS_LOG[n] = log
        if p.returncode != 0:
            errors.append(f"--- nvcc {n} (rc {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, lib_path(n))
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    strided = [P, L, L, L, L, I]  # pointer, 4 element strides, dtype code
    sigs = {
        "roi_pool": {"roi_pool_forward": [P, P, P, P, I, P, P, P, I, I, I, I, I, I, I, I, I, P],
                     "roi_pool_backward": [P, P, P, P, P, I, P, P, P, I, I, I, I, I, I, I,
                                           I, I, I, P]},
        "afi_conv3x3": {
            "afi_conv3x3": [P, P, I, P, P, P, F, P, F, P, P, I, I, I, I, I, I, I, P],
            "afi_rdb_chain": [P, P, P, P, P, I, F, P, F, I, I, I, I, I, I, I, P]},
        "afi_upsample": {
            "afi_subpixel_deconv": [P, P, P, P, I, I, I, I, I, I, I, I, P],
            "afi_upsample_forward": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]},
        "layer_norm": {"layer_norm_forward": [P, P, P, P, I, I, F, I, I, P]},
        "window_attention": {
            "window_attention_forward": [P, P, P, P, P, P, P, I, I, I, I, I, F, I, P]},
        "window_gather": {"window_gather_forward": [P, P, P, P, I, I, I, I, I, P]},
        "nms": {"nms_forward": [P, P, P, F, I, I, I, P, P], "nms_max_n": [],
                "nms_plan": [I, I, P]},
        "deform_conv": {"deform_im2col": [P, I, *strided, *strided, P, *[I] * 11, P],
                        "deform_im2col_spill": [P, I, P],
                        "deform_col2im": [P, I, *strided, *strided, P, P, P, P, *[I] * 11,
                                          P, P]},
    }
    for fname, argtypes in sigs[name].items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = I


def refuse_grad(what: str, *tensors) -> None:
    """A forward-only kernel under autograd would hand back a tensor with no
    graph and train nothing behind it, silently: raise instead. Called on the
    CUDA route only (the plain versions on the CPU are differentiable)."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: a forward-only CUDA kernel called under autograd with an input "
            "that requires grad; run it under torch.no_grad() / inference_mode(), "
            "or take the module's training route")


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def dtype_code(t) -> int:
    """The kernels' code for a tensor's (or a torch dtype's) element type."""
    import torch

    dt = getattr(t, "dtype", t)
    if dt == torch.float32:
        return 0
    if dt == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {dt}")


def stream_ptr(*tensors) -> int:
    """The current CUDA stream's handle, on which a wrapper launches its
    kernel, once every CUDA tensor among ``tensors`` (the launch's inputs,
    outputs and workspaces; None skipped) is found on the current device.
    The launch goes to the current device: a tensor on another card would
    hand the kernel that card's pointers (a rank that never made its own
    card current with ``torch.cuda.set_device``). Raises there."""
    import torch

    if not tensors:
        raise TypeError("stream_ptr: pass the launch's tensors, whose device it checks")
    current = torch.cuda.current_device()
    for t in tensors:
        if t is not None and t.device.type == "cuda" and t.device.index != current:
            raise RuntimeError(
                f"kernel launch on cuda:{current} with a tensor on {t.device}: make the "
                "tensors' card current first (torch.cuda.set_device)")
    return torch.cuda.current_stream().cuda_stream
