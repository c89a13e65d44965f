"""The NMS and deformable-adjoint kernels of this checkout against another
checkout's, on the card, in one process.

    python3 kernel_ab.py OTHER [--rounds N]

OTHER is the root of another checkout of the repo (for example the parent
commit, unpacked with ``git archive``); its ``afigan_tpu_torch`` is loaded
under another name and builds its kernels into OTHER/build. Both sides run
through their public wrappers, ``ops/kernels/nms.py::nms_keep_sorted`` and
``ops/kernels/deform_conv.py::deform_col2im``, on the same inputs:

* NMS at the paths' sizes (``tests/torch_port_nms_cases.py``: the RPN at
  inference and in training, the Res5 path's one level, FCOS, detection),
  the keep masks of both sides equal up to the stop;
* the adjoint at the six shapes of ``chip_smoke.DCN_SHAPES`` under
  fractional and zero offsets, and on the adjoint calls of two
  ``train_dcn`` steps after ``offsets_on`` that ``chip_smoke.py`` saved
  (``chip_smoke.DCN_CALLS``), where that file is present; each side within
  ``TOL["dcn_bwd"]`` of the plain version.

Each NMS call, and the adjoint's launches of a step at each shape, are
timed by the device time of every kernel they launch (the adjoint's
zero-filled scratch included) and by CUDA events, in turns other, this,
this, other. Prints the card's name and power limit first; compare two
checkouts only within one call.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NMS_CASES = ("rpn", "rpn_train", "res5_train", "fcos", "detection")


def load_checkout(root):
    """The port package of the checkout at ``root`` under another name: its
    NMS and deformable conv kernel modules."""
    pkg = Path(root).resolve() / "afigan_tpu_torch"
    name = "other_afigan_tpu_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module(f"{name}.ops.kernels.nms"),
            importlib.import_module(f"{name}.ops.kernels.deform_conv"))


def nms_inputs(name):
    """The keep-mask function's inputs of case ``name`` on the card, as
    ``batched_nms_padded`` hands them over: (boxes with the class offsets,
    valid, order, threshold, stop), a batch of one."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "torch_port_nms_cases", ROOT / "tests" / "torch_port_nms_cases.py")
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    boxes, scores, valid, idxs, thr, stop = (
        torch.from_numpy(a).cuda() if isinstance(a, np.ndarray) else a
        for a in cases.nms_case(name))
    boxes = boxes + (idxs.to(boxes.dtype) * (boxes.max() + 1.0))[:, None]
    order = torch.sort(-torch.where(valid, scores, -1e10), stable=True).indices
    return boxes[None], valid[None], order[None], thr, stop


def dcn_synthetic(cs, kind):
    """The adjoint's calls of a ``train_dcn`` step at ``DCN_SHAPES`` (batch 2,
    bf16 x, the offsets a bf16 view, a float32 mask, a random columns'
    gradient) under ``kind`` offsets: [(label, [args of each launch])]."""
    import torch

    gen = torch.Generator().manual_seed(5)
    dgen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for (h, w), c, count in cs.DCN_SHAPES:
        x = torch.randn((2, h, w, c), generator=dgen, device="cuda").bfloat16()
        pred = torch.zeros((2, h, w, 27), dtype=torch.bfloat16, device="cuda")
        pred[..., :18] = cs.dcn_offsets(kind, 2, h, w, gen).cuda()
        mask = torch.sigmoid(torch.randn((2, h, w, 9), generator=dgen, device="cuda"))
        g = torch.randn((2 * h * w, 9 * c), generator=dgen, device="cuda")
        out.append((f"{h}x{w}x{c}", [(g, x, pred[..., :18], mask)] * count))
    return out


def dcn_saved(saved):
    """Adjoint calls that ``chip_smoke.AdjointCalls`` recorded, on the card:
    their offsets and masks at their own element strides, random x and
    columns' gradient of their shapes, grouped by shape: [(label, [args])]."""
    import torch

    dgen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for c in saved:
        shape, dtype = c["x"]
        x = torch.randn(shape, generator=dgen, device="cuda").to(getattr(torch, dtype))

        def placed(t, stride):
            if t is None:
                return None
            d = torch.empty_strided(t.shape, stride, dtype=t.dtype, device="cuda")
            return d.copy_(t)

        off = placed(c["offsets"], c["offsets_stride"])
        mask = placed(c["mask"], c["mask_stride"])
        kh, kw = c["conv"][0] if c["conv"] else (3, 3)
        n = off.shape[0] * off.shape[1] * off.shape[2]
        g = torch.randn((n, kh * kw * shape[-1]), generator=dgen, device="cuda")
        out.setdefault(f"{shape[1]}x{shape[2]}x{shape[3]}", []).append(
            (g, x, off, mask, *c["conv"]))
    return list(out.items())


def close(got, want, what):
    for k, w in zip(got, want):
        if w is None:
            continue
        err = float((k.float() - w.float()).abs().max())
        if not err <= 1e-4 * float(w.float().abs().max()):
            raise AssertionError(f"{what}: max_abs_err {err}")


def device_ms(fn, reps=5, tries=3):
    """Device time (ms) of the kernels that a call of ``fn`` launches, where
    each kernel launches as often as the others: over ``reps`` calls under
    torch.profiler, each kernel's mean over the launches its trace holds,
    summed, times the launches a call (the most that any kernel shows), so
    that a trace that drops records reads no lower."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count]
        if ks:
            per_call = round(max(e.count for e in ks) / reps)
            return sum(e.self_device_time_total / e.count for e in ks) * per_call / 1000.0
    raise AssertionError("no kernel in the profiler's trace")


def turns(fns, rounds, cs, inner):
    """Each side's times in turns other, this, this, other: (events ms,
    device ms) lists by side."""
    ev, dv = {"other": [], "this": []}, {"other": [], "this": []}
    for _ in range(rounds):
        for tag in ("other", "this", "this", "other"):
            ev[tag].append(cs.median_ms(fns[tag], iters=5, inner=inner))
            dv[tag].append(device_ms(fns[tag]))
    return ev, dv


def fmt(ts):
    return " ".join(f"{1000 * t:.1f}" for t in ts)


def ab_nms(cs, other, rounds):
    from afigan_tpu_torch.ops.kernels import nms as knms

    for name in NMS_CASES:
        b, v, o, thr, stop = nms_inputs(name)
        fns = {"other": lambda: other.nms_keep_sorted(b, v, o, thr, stop),  # noqa: E731
               "this": lambda: knms.nms_keep_sorted(b, v, o, thr, stop)}  # noqa: E731
        got = {k: f()[0] for k, f in fns.items()}
        kept = np.flatnonzero(got["this"].cpu().numpy())
        upto = b.shape[1] if len(kept) < stop else int(kept[stop - 1]) + 1
        if not bool((got["other"][:upto] == got["this"][:upto]).all()):
            raise AssertionError(f"nms {name}: the two keep masks differ")
        ev, dv = turns(fns, rounds, cs, inner=10)
        print(f"ab nms {name} N={b.shape[1]} stop_after={stop}: us a call on the device other "
              f"{fmt(dv['other'])} this {fmt(dv['this'])}; by events other {fmt(ev['other'])} "
              f"this {fmt(ev['this'])}", flush=True)


def ab_dcn(cs, other, rounds, what, groups):
    """The adjoint's launches of a step, shape by shape (``groups``: [(label,
    [args of each launch])]), both sides within the bound of the plain
    version; the times of each shape's launches and of the step."""
    import torch

    from afigan_tpu_torch.ops.kernels import deform_conv as dc

    dev = torch.device("cuda")
    step = {"other": np.zeros(2 * rounds), "this": np.zeros(2 * rounds)}
    spilled = corners = launches = 0
    for label, calls in groups:
        for i, args in enumerate(calls):
            if i and args is calls[i - 1]:
                continue
            want = dc.deform_col2im_plain(*args)
            close(other.deform_col2im(*args), want, f"{what} {label} other")
            close(dc.deform_col2im(*args), want, f"{what} {label} this")
        dc.reset_spill(dev)
        for args in calls:
            dc.deform_col2im(*args)
        s, c = dc.spill_counts(dev)
        spilled, corners, launches = spilled + s, corners + c, launches + len(calls)

        def run(fn, calls=calls):
            for args in calls:
                fn(*args)

        fns = {"other": lambda: run(other.deform_col2im),  # noqa: E731
               "this": lambda: run(dc.deform_col2im)}  # noqa: E731
        ev, dv = turns(fns, rounds, cs, inner=1)
        for tag in step:
            step[tag] += np.asarray(dv[tag])
        n = len(calls)
        print(f"ab dcn_bwd {what} {label} (x{n} a step): us a launch on the device other "
              f"{fmt(np.asarray(dv['other']) / n)} this {fmt(np.asarray(dv['this']) / n)}; "
              f"by events other {fmt(np.asarray(ev['other']) / n)} this "
              f"{fmt(np.asarray(ev['this']) / n)}; corners outside the window (this) "
              f"{100 * s / max(c, 1):.2f} %", flush=True)
    print(f"ab dcn_bwd {what}: a step's {launches} launches, us on the device other "
          f"{fmt(step['other'])} this {fmt(step['this'])}; corners inside the map outside "
          f"their tile's window (this) {spilled} of {corners} "
          f"({100 * spilled / max(corners, 1):.2f} %)", flush=True)


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    other_nms, other_dc = load_checkout(args.other)
    ab_nms(cs, other_nms, args.rounds)
    for kind in ("fractional", "zero"):
        ab_dcn(cs, other_dc, args.rounds, kind, dcn_synthetic(cs, kind))
    if cs.DCN_CALLS.exists():
        import torch

        for what, saved in torch.load(cs.DCN_CALLS).items():
            ab_dcn(cs, other_dc, args.rounds, f"train_dcn {what}", dcn_saved(saved))
    else:
        print(f"ab dcn_bwd: no saved step at {cs.DCN_CALLS} (chip_smoke.py's phase "
              "train_dcn saves one)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
