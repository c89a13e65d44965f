"""Sweeps of kernel launch choices on the card.

    python3 -m afigan_tpu_torch.tools.kernel_sweep [conv] [roi_pool]

With no argument both run. ``conv``: each tiling of the table in
``csrc/afi_conv_common.cuh::launch_conv3x3`` on the generator's conv shapes
(head, a growth conv, conv5, the 4-phase transposed conv) at every pyramid
level of the three paths, beside the launcher's own choice (-1).
``roi_pool``: splits of ``csrc/roi_pool.cu`` (output rows and threads a
block) at the pooler's shapes on the three paths, beside the launcher's
own choice (0, 0). Device time per launch from torch.profiler. Prints the
card's name and power limit; compare only within one call.
"""

from __future__ import annotations

import subprocess
import sys

import torch


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


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    which = argv[1:] or ["conv", "roi_pool"]
    if "roi_pool" in which:
        sweep_roi_pool()
    if "conv" in which:
        sweep_conv()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
