"""Per-ROI window extraction: the port of
``afigan_tpu/ops/pallas/window_gather.py::gather_windows``.

    out[r] = concat[rows[r]:rows[r]+window, cols[r]:cols[r]+window, :]

On a CUDA tensor: ``csrc/window_gather.cu`` (a strided copy, one block per
window row). On a CPU tensor: the plain version below, a stack of slices.
The TPU kernel's alignment contract (window and column starts multiples of
8) is Mosaic's and is not kept: any start, window and channel count.
"""

from __future__ import annotations

import torch

from . import _build
from ._build import LAUNCHES


def check_starts(concat, rows, cols, window: int) -> None:
    """Raises unless every window lies inside ``concat``. Reads the starts on
    the host, a device synchronisation for CUDA tensors, so the kernel's
    wrapper does not call it: the pooler clamps its starts."""
    if rows.numel() == 0:
        return
    r0, r1 = int(rows.min()), int(rows.max())
    c0, c1 = int(cols.min()), int(cols.max())
    if r0 < 0 or c0 < 0 or r1 + window > concat.shape[0] or c1 + window > concat.shape[1]:
        raise ValueError(
            f"window starts rows [{r0}, {r1}] cols [{c0}, {c1}] + {window} leave "
            f"concat {tuple(concat.shape[:2])}")


def gather_windows_plain(concat, rows, cols, window: int):
    """(sumH, Wmax, C), (R,) row and column starts → (R, window, window, C),
    slice by slice."""
    check_starts(concat, rows, cols, window)
    out = [concat[r:r + window, c:c + window]
           for r, c in zip(rows.tolist(), cols.tolist())]
    if not out:
        return concat.new_empty((0, window, window, concat.shape[-1]))
    return torch.stack(out)


def gather_windows(concat, rows, cols, window: int):
    """concat (sumH, Wmax, C) float32 or bfloat16, contiguous; rows, cols (R,)
    integer window starts → (R, window, window, C) in concat's dtype. On CUDA
    tensors the starts are the caller's to keep in range (``check_starts``)."""
    devs = {t.device.type for t in (concat, rows, cols)}
    if devs == {"cpu"}:
        return gather_windows_plain(concat, rows, cols, window)
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed or unsupported devices: {devs}")
    _build.refuse_grad("gather_windows", concat)
    elt = {0: 4, 1: 2}[_build.dtype_code(concat)]
    if concat.dim() != 3 or not concat.is_contiguous():
        raise ValueError(f"concat must be contiguous (sumH, Wmax, C), got "
                         f"{tuple(concat.shape)} strides {concat.stride()}")
    r = rows.shape[0]
    if rows.dim() != 1 or tuple(cols.shape) != (r,):
        raise ValueError(f"rows {tuple(rows.shape)} / cols {tuple(cols.shape)} must be (R,)")
    sum_h, wmax, c = concat.shape
    if not 0 < window <= min(sum_h, wmax):
        raise ValueError(f"window {window} does not fit concat {(sum_h, wmax)}")
    out = torch.empty((r, window, window, c), device=concat.device, dtype=concat.dtype)
    if r == 0:
        return out
    ri = rows.to(torch.int32).contiguous()
    ci = cols.to(torch.int32).contiguous()
    lib = _build.load("window_gather")
    rc = lib.window_gather_forward(concat.data_ptr(), ri.data_ptr(), ci.data_ptr(),
                                   out.data_ptr(), r, window, wmax, c, elt,
                                   _build.stream_ptr())
    _build.check(rc, "window_gather_forward")
    LAUNCHES["window_gather"] += 1
    return out
