"""Sweeps of kernel launch choices on the card.

    python3 -m afigan_tpu_torch.tools.kernel_sweep [conv] [roi_pool] [roi_pool_bwd]

With no argument all three run. ``conv``: each tiling of the table in
``csrc/afi_conv_common.cuh::launch_conv3x3`` on the generator's conv shapes
(head, a growth conv, conv5, the 4-phase transposed conv) at every pyramid
level of the three paths, beside the launcher's own choice (-1).
``roi_pool``: splits of ``csrc/roi_pool.cu`` (output rows and threads a
block) at the pooler's shapes on the three paths, beside the launcher's
own choice (0, 0). ``roi_pool_bwd``: splits of the pool's backward
(``csrc/roi_pool.cu::roi_pool_backward``: tile rows, tile columns and
channels a block) on the ROIs, level indices and gradients of one stage-3
train step, its box and mask pools, beside the launcher's own choice
(0, 0, 0); every split must give the same bits. ``chip_smoke.py``'s phase
``train`` saves that step's calls (``POOL_CALLS``): run it first. Device time
a launch from torch.profiler (the backward: by CUDA events around calls in a
row). Prints the card's name and power limit; compare only within one call.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

# where ``chip_smoke.py``'s phase ``train`` saves the pool's backward calls of
# one stage-3 train step: the traffic that ``roi_pool_bwd`` sweeps
POOL_CALLS = Path(__file__).resolve().parents[2] / "output" / "chip_smoke_train" / \
    "pool_bwd_calls.pt"


def _device_ms(fn, reps=20):
    """Mean device time of one call's kernels over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1000.0


def _events_us(fn, reps=20, rounds=5):
    """Median over ``rounds`` of the microseconds a call of ``reps`` calls in
    a row between two CUDA events: the card's time where the host enqueues
    faster than the card runs (no profiler, which loses records now and
    then in a long run of short sessions)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(1000.0 * start.elapsed_time(end) / reps)
    return sorted(times)[rounds // 2]


def sweep_conv(tilings=range(-1, 6)):
    from afigan_tpu_torch.ops.kernels import afi_generator as ag

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    levels = {256: [(7, 11), (14, 22), (28, 44), (56, 88), (26, 42), (52, 84), (104, 168)],
              160: [(7, 11), (14, 22), (28, 44), (56, 88)]}
    for c, hws in levels.items():
        # (name, sources' channels, cout, phases)
        convs = [("head", [c], c, 1), ("growth4", [c, 32, 32, 32], 32, 1),
                 ("conv5", [c, 32, 32, 32, 32], c, 1), ("deconv", [c], c, 4)]
        for h, w in hws:
            for name, chans, cout, phases in convs:
                srcs = [torch.randn((2, h, w, ch), generator=gen).to(dev, torch.bfloat16)
                        for ch in chans]
                cin = sum(chans)
                if phases == 1:
                    wt = torch.randn((cout, cin, 3, 3), generator=gen).to(dev) * 0.02
                    laid = ag.lay_out_conv(wt, None, torch.bfloat16)
                    call = lambda: ag.conv3x3(srcs, wt, None, leaky=True, laid=laid)  # noqa: E731
                else:
                    wt = torch.randn((cin, cout, 6, 6), generator=gen).to(dev) * 0.02
                    laid = ag.lay_out_deconv(wt, None, torch.bfloat16)
                    call = lambda: ag.subpixel_deconv(srcs[0], wt, None, laid=laid)  # noqa: E731
                ref, row = None, []
                for t in tilings:
                    if t >= 5 and (cout <= 32 or h * w < 1000):
                        continue  # wgmma: wide convs on large maps
                    ag.TILING = t
                    out = call()
                    if ref is None:
                        ref = out
                    elif not torch.allclose(out.float(), ref.float(), rtol=2e-2, atol=2e-2):
                        raise AssertionError(f"tiling {t} disagrees on {name} C={c} {h}x{w}")
                    row.append(f"{t}:{1000 * _device_ms(call):.1f}")
                ag.TILING = -1
                print(f"conv C={c} {h}x{w} {name:8s} us per launch by tiling  " + "  ".join(row),
                      flush=True)


def sweep_roi_pool(splits=((0, 0), (1, 128), (1, 256), (2, 256), (4, 256), (7, 256),
                            (14, 256), (2, 512), (4, 512), (7, 512), (14, 512))):
    import numpy as np

    from afigan_tpu_torch.ops.kernels import roi_pool as rp
    from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    # (canvas, strides, channels, P, ROIs per image): the r50 box and mask
    # pools, the swin box pool, the centermask mask pool
    cases = [((832, 1344), (4, 8, 16, 32), 256, 7, 1000),
             ((832, 1344), (4, 8, 16, 32), 256, 14, 100),
             ((896, 1408), (8, 16, 32, 64), 256, 7, 1000),
             ((896, 1408), (8, 16, 32), 160, 14, 100)]
    for dt in (torch.bfloat16, torch.float32):
        for (h, w), strides, c, p, n in cases:
            feats = [torch.randn((2, h // s, w // s, c), generator=gen).to(dev, dt)
                     for s in strides]
            ctr = torch.rand((2, n, 2), generator=gen) * torch.tensor([w, h])
            size = torch.exp(torch.rand((2, n, 2), generator=gen) * np.log(600 / 8)) * 8
            boxes = torch.cat([ctr - size / 2, ctr + size / 2], -1).to(dev)
            lo = int(np.log2(strides[0]))
            lv = assign_boxes_to_levels(boxes, lo, lo + len(strides) - 1)
            ref, row = None, []
            for split in splits:
                if split[0] > p:
                    continue
                rp.SPLIT = split
                call = lambda: rp.roi_pool(feats, boxes, lv, strides, p)  # noqa: E731
                out = call()
                if ref is None:
                    ref = out
                elif not torch.equal(out, ref):
                    raise AssertionError(f"split {split} changes the pool at C={c} P={p}")
                row.append(f"{split[0]}x{split[1]}:{1000 * _device_ms(call):.1f}")
            rp.SPLIT = (0, 0)
            print(f"roi_pool {str(dt)[6:]} C={c} P={p} N=2x{n} us per launch by rows x threads  "
                  + "  ".join(row), flush=True)


def bwd_splits():
    """The backward's launch splits (tile rows, tile columns, channels a
    block) that ``roi_pool_backward`` takes with 16-byte vectors: a thread
    holds 8 pixels of a tile row (4 where the tile is 4 wide) and 4
    channels; a block is a multiple of 32 threads, 256 at most."""
    out = []
    for th in (2, 4, 8, 16):
        for tw in (4, 8, 16):
            for cc in (32, 64, 128, 256):
                threads = th * (tw // (8 if tw % 8 == 0 else 4)) * (cc // 4)
                if threads % 32 == 0 and threads <= 256:
                    out.append((th, tw, cc))
    return out


def capture_pool_backward(step):
    """Run ``step`` with the pool's backward recorded: the arguments of each
    call (level maps, ROIs, level indices, gradient, strides, P, samples,
    aligned), the ROIs, level indices and gradient copied."""
    from afigan_tpu_torch.ops.kernels import roi_pool as rp

    calls, orig = [], rp.roi_pool_backward

    def record(feats, boxes, levels, grad, *rest):
        calls.append((list(feats), boxes.clone(), levels.clone(), grad.clone(), *rest))
        return orig(feats, boxes, levels, grad, *rest)

    rp.roi_pool_backward = record
    try:
        step()
    finally:
        rp.roi_pool_backward = orig
    return calls


def save_pool_calls(calls, path):
    """Save ``capture_pool_backward``'s calls to ``path``: everything but the
    level maps' values, which the backward does not read."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save([{"shapes": [tuple(f.shape) for f in feats], "dtype": str(feats[0].dtype)[6:],
                 "boxes": boxes.cpu(), "levels": levels.cpu(), "grad": grad.cpu(),
                 "args": tuple(rest)}
                for feats, boxes, levels, grad, *rest in calls], path)


def load_pool_calls(path, device, dtype=None):
    """The calls ``save_pool_calls`` saved, on ``device``: zero level maps of
    the saved shapes in ``dtype`` (the saved one by default), then the ROIs,
    level indices, gradient and the other arguments."""
    out = []
    for c in torch.load(path):
        dt = dtype or getattr(torch, c["dtype"])
        feats = [torch.zeros(s, device=device, dtype=dt) for s in c["shapes"]]
        out.append((feats, c["boxes"].to(device), c["levels"].to(device),
                    c["grad"].to(device), *c["args"]))
    return out


def sweep_roi_pool_bwd(path=POOL_CALLS):
    """Every split of ``bwd_splits`` on the pool's backward calls of one
    stage-3 train step (``path``, saved by ``chip_smoke.py``'s phase
    ``train``), in bf16 and float32, beside the launcher's own split timed
    first and last: the two differ by the timing's noise."""
    from afigan_tpu_torch.ops.kernels import roi_pool as rp

    if not Path(path).is_file():
        raise FileNotFoundError(f"{path}: run chip_smoke.py first (its phase train saves "
                                "the train step's pool backward calls there)")
    splits = [(0, 0, 0)] + bwd_splits() + [(0, 0, 0)]
    for dt in (torch.bfloat16, torch.float32):
        for feats, boxes, lv, grad, strides, p, *rest in load_pool_calls(path, "cuda", dt):
            args = (feats, boxes, lv, grad, strides, p, *rest)
            call = lambda: rp.roi_pool_backward(*args)  # noqa: E731
            ref, rows = None, []
            for split in splits:
                rp.BWD_SPLIT = split
                out = torch.cat([g.float().flatten() for g in call()])
                if ref is None:
                    ref = out
                elif not torch.equal(out, ref):
                    raise AssertionError(f"split {split} changes the backward at P={p}")
                rows.append((_events_us(call), "x".join(map(str, split))))
            rp.BWD_SPLIT = (0, 0, 0)
            hist = torch.bincount(lv.flatten(), minlength=len(feats)).tolist()
            print(f"roi_pool_bwd {str(dt)[6:]} C={grad.shape[-1]} P={p} "
                  f"N={boxes.shape[0]}x{boxes.shape[1]} (the train step's ROIs, by level "
                  f"{hist}) us per call by tile rows x tile columns x channels", flush=True)
            for us, tag in rows:
                print(f"  {tag:>10s} {us:9.1f}", flush=True)
            best = min(rows[1:-1])
            print(f"  fastest {best[1]} {best[0]:.1f} us, the launcher's own {rows[0][0]:.1f} "
                  f"and {rows[-1][0]:.1f} us", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    which = argv[1:] or ["conv", "roi_pool", "roi_pool_bwd"]
    if "roi_pool" in which:
        sweep_roi_pool()
    if "roi_pool_bwd" in which:
        sweep_roi_pool_bwd()
    if "conv" in which:
        sweep_conv()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
