#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``afigan_tpu_torch``).

    python3 chip_smoke.py            # one GPU, no arguments
    python3 chip_smoke.py --generator-levels   # only the generator's device
                                     # time per pyramid level

Phases, always all (any failure exits non-zero; nothing falls back to the
CPU):
  1. build    compile every CUDA kernel from ``afigan_tpu_torch/csrc`` (one nvcc
              per source, in parallel); print the card and its power limit
  2. kernels  each of the nine kernels against its plain PyTorch version at
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
              FCOS and detection sizes and the contract's corner cases, and a
              keep mask with one kept box flipped must fail that check. The
              pool's backward at the train step's shapes (box pool 2 x 512 ROIs
              at P 7, mask pool 2 x 128 at P 14, C 256) against autograd through
              the plain gather; the plain gradient without one ROI must fail
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
  6. nms_ab   r50 and centermask (main path): every NMS call of one batch
              under torch.cuda.set_sync_debug_mode("error"), the host syncs
              from the proposal head to the end of a batch logged by source
              line; then 10 batches with the NMS kernel against 10 with the
              blocked plain loop on the card, alternating, medians and layer
              splits side by side (the plain route is this script's switch)
  7. train    stage-3 training of Mask R-CNN R-50-FPN(AFI) at full width
              (``configs/step3_afigan_mask_rcnn_R_50_FPN_3x.yaml``, bf16, batch
              2, 832x1344) through ``TargetDetectorTrainer``: two iterations of
              ``train()`` over an in-memory dataset, then 2 + 10 steps on one
              repeated batch (launches per step asserted: 2 pool forwards, 2
              pool backwards, 2 NMS, no generator kernel; losses finite and
              falling), ms per step, images/s, peak memory, one profiled step
              and a forward / backward / optimizer split
  8. card_vs_cpu  in float32 (TF32 off) on a small canvas: the GPU (kernels)
              and the CPU (plain versions) on the same weights; detections must
              agree at the golden-regression tolerances. The R-50 model under
              both poolers, a narrow Swin model (embed 32, window 4) and a
              narrow CenterMask under ``windowed``
  9. train_card_vs_cpu  one stage-3 step of a narrow float32 model on the
              card and on the CPU with the same weights, batch and subsample
              keys: losses and trainable gradients must agree

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import importlib.util
import json
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


def compare(name, got, want, kind, dtype_name):
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
                "window_gather_kernel", "nms_mask_kernel", "nms_reduce_kernel",
                "roi_pool_bwd_kernel", "cast_bf16_kernel")


def device_kernels(counts):
    """The device kernels that the wrappers' launch counts stand for: one
    each, but two for a call of the NMS entry (its mask and its reduce) and
    two for a call of the pool's backward on bfloat16 levels (the scatter and
    the cast: every backward this script profiles is bfloat16)."""
    return sum(counts.values()) + counts.get("nms", 0) + counts.get("roi_pool_bwd", 0)


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
            # what this run's boxes need: 4 corner reads per sample, but no
            # more than the maps themselves; the float32 output; the boxes
            samples = B * n * p * p * S * S
            read = min(4 * samples * c, sum(f.numel() for f in feats)) * ELT[dtype_name]
            nbytes = read + B * n * p * p * c * 4 + B * n * 20
            tally(results, "roi_pool", path, dtype_name).add(
                tk, tp, nbytes, 2 * 4 * samples * c, "float32", e, count)


def kernels_roi_pool_backward(results):
    """The pool's backward at the stage-3 train step's shapes: the box pool
    (512 sampled ROIs an image, P = 7) and the mask pool (128 foreground ROIs
    an image, P = 14) over p2-p5 of the 832x1344 canvas, against
    ``torch.autograd.grad`` through the plain gather (summed in float32). The
    kernel's float32 atomics add in a run-dependent order: a tolerance, never
    bit equality. The bound must reject the plain gradient without the
    contribution of one ROI (the smallest: its samples pile onto the fewest
    taps)."""
    import torch

    from afigan_tpu_torch.ops.kernels.roi_pool import roi_pool_backward, roi_pool_backward_plain
    from afigan_tpu_torch.ops.roi_align import assign_boxes_to_levels

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    B, S, strides = 2, 2, (4, 8, 16, 32)
    for dtype_name in DTYPES:
        dt = getattr(torch, dtype_name)
        feats = [torch.randn((B, R50_CANVAS[0] // s, R50_CANVAS[1] // s, 256),
                             generator=gen).to(dev, dt) for s in strides]
        for p, n in ((7, 512), (14, 128)):
            boxes = _boxes(B, n, R50_CANVAS, gen, dev)
            lv = assign_boxes_to_levels(boxes, 2, 5)
            grad = torch.randn((B, n, p, p, 256), generator=gen).to(dev)
            args = (feats, boxes, lv, grad, strides, p, S, True)
            fk = lambda: roi_pool_backward(*args)  # noqa: E731
            fp = lambda: roi_pool_backward_plain(*args)  # noqa: E731

            def flat(gs):
                return torch.cat([g.float().flatten() for g in gs])

            g_k, g_p = flat(fk()), flat(fp())
            torch.cuda.synchronize()
            tag = f"{dtype_name} train C=256 P={p} N={B}x{n}"
            e = compare(f"roi_pool_bwd {tag}", g_k, g_p, "pool", dtype_name)
            area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
            drop = int(area[0].argmin())
            left_out = grad.clone()
            left_out[0, drop] = 0.0
            short = flat(roi_pool_backward_plain(feats, boxes, lv, left_out, strides, p, S,
                                                 True))
            reject(f"roi_pool_bwd {tag} without ROI {drop} of image 0", short, g_p, "pool",
                   dtype_name)
            tk, tp = median_ms(fk), median_ms(fp, iters=3, warmup=1, inner=1)
            log(f"  roi_pool_bwd {tag}: kernel {tk:.3f} ms plain {tp:.3f} ms")
            # g read once, the boxes and levels, each level's gradient written
            # once; a multiply-add per tap and channel of every sample
            samples = B * n * p * p * S * S
            nbytes = (grad.numel() * 4 + B * n * 20
                      + sum(f.numel() for f in feats) * ELT[dtype_name])
            tally(results, "roi_pool_bwd", "train", dtype_name).add(
                tk, tp, nbytes, 2 * 4 * samples * 256, "float32", e, 1)
        del feats
        torch.cuda.empty_cache()


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
    """(bytes, operations) that one image's keep mask needs on this input:
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
    The keep-mask function timed both ways at the three real sizes."""
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
             "fcos": [("centermask", 2)]}
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
        keep = fk()[0]
        nbytes, ops = _nms_work(valid[order], keep, len(boxes))
        log(f"  nms {case} keep mask (stop_after={max_out}): kernel {tk:.3f} ms, plain loop "
            f"{tp:.3f} ms; {nbytes / 1e6:.2f} MB and {ops / 1e6:.1f} M operations needed")
        for path, count in paths[case]:
            tally(results, "nms", path, "bfloat16").add(tk, tp, nbytes, ops, "float32", 0.0,
                                                          count)


def phase_kernels(results):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for part in (kernels_generator, kernels_roi_pool, kernels_roi_pool_backward,
                 kernels_layer_norm, kernels_window_attention, kernels_window_gather,
                 kernels_nms):
        part(results)
        torch.cuda.empty_cache()
    generator_levels()
    torch.backends.cudnn.allow_tf32 = True


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
    for name, t in finite:
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"non-finite {name}")


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
            dets, masks = predict(model, batch)
            torch.cuda.synchronize()
            ms.append(1000 * (time.perf_counter() - t0))
            fcos = cfg.MODEL.META_ARCHITECTURE in ("FCOS", "CenterMask")
            check_outputs(dets, masks, 2, cfg.MODEL.FCOS.POST_NMS_TOPK_TEST if fcos
                          else cfg.TEST.DETECTIONS_PER_IMAGE, 28 if cfg.MODEL.MASK_ON else None)
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
            f"valid detections per image {np.mean(valid) / 2:.1f}")
    return model, valid, counts


def run_slice(results, path, make_cfg, canvas, per_batch, n_batches):
    """One model at full width under the two traffics. The first, its config
    as is, is the path's main run: its launch counts go into the result."""
    rng = np.random.RandomState(0)
    batches = [random_batch(rng, 2, canvas, SIZES) for _ in range(n_batches + 1)]
    # random weights score no class above the 0.05 threshold, so every image
    # has 0 detections
    model, _, counts = run_batches(path, make_cfg(), batches, per_batch)
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
R50_PER_BATCH = {"afi_chain": 3 * 16, "afi_upsample": 3 * 3, "roi_pool": 2,
                 "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 0, "window_attention": 0,
                 "window_gather": 0, "nms": 4}
SWIN_PER_BATCH = {"afi_chain": 28 * 16, "afi_upsample": 28 * 3, "roi_pool": 3,
                  "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 55, "window_attention": 24,
                  "window_gather": 0, "nms": 4}
# with one dense block: the head conv + 5 dense convs a call, all launches
# of the conv kernel, counted as afi_rdb
RDB1_PER_BATCH = {"afi_chain": 0, "afi_upsample": 3 * 3, "roi_pool": 2,
                  "roi_pool_bwd": 0, "afi_rdb": 3 * 6, "layer_norm": 0, "window_attention": 0,
                  "window_gather": 0, "nms": 4}
# CenterMask: 6 BiFPN layers x 4 generator calls; one mask pool a batch. Under
# ``windowed`` the pool is one window_gather launch (the batch's ROIs in one)
# and one roi_pool launch over the 64 overflow slots per image, which runs
# whether or not a ROI overflows (fixed shapes, no device synchronisation)
CENTERMASK_PER_BATCH = {"afi_chain": 24 * 16, "afi_upsample": 24 * 3, "roi_pool": 1,
                        "roi_pool_bwd": 0, "afi_rdb": 0, "layer_norm": 0, "window_attention": 0,
                        "window_gather": 0, "nms": 2}
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


# the models' record_function ranges: their GPU spans (first to last kernel,
# idle gaps included) are not device work
RANGES = ("backbone", "afi_generator", "rpn", "roi_heads", "fcos_head", "fcos_decode",
          "mask_pool", "mask_head")


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

    if hasattr(model.roi_heads, "box_predictor"):
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
    else:
        stages.append(("detection (decode, nms) + output", t["end"] - t["box_predictor>"]))
    log_layers(marks, stages)


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
                  "window_gather": 0, "nms": 2}


def train_records(gen, n_img=2, hw=(800, 1333), n_obj=12):
    """In-memory COCO-style records: random pixels, and from ``gen`` per
    image ``n_obj`` boxes (xyxy, 24-400 px a side), classes in [0, 80) and an
    octagon polygon inside each box."""
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
                         "category_id": int(torch.randint(0, 80, (1,), generator=gen)),
                         "segmentation": [poly.tolist()]})
        recs.append({"image": img, "image_id": i + 1, "height": h, "width": w,
                     "annotations": anns})
    return recs


def train_cfg(out_dir):
    """The stage-3 YAML at full width (ResNet-50, FPN 256, AFI 3 RDBs, masks,
    RPN 2000/1000, 512 + 128 ROIs an image), bf16, batch 2; the short side
    800 so that every batch fills the 832x1344 canvas; warm-up off."""
    from afigan_tpu_torch.config import cfg_from_yaml

    cfg = cfg_from_yaml(STEP3_YAML)
    cfg.merge_from_list([
        "TPU.COMPUTE_DTYPE", "bfloat16", "SOLVER.IMS_PER_BATCH", "2",
        "SOLVER.BASE_LR", str(TRAIN_LR), "SOLVER.WARMUP_ITERS", "0",
        "INPUT.MIN_SIZE_TRAIN", "(800,)", "SEED", "0", "DATASETS.TRAIN", "('chip_smoke_train',)",
        "DATASETS.TEST", "()", "OUTPUT_DIR", str(out_dir)])
    return cfg


def step_split(cfg, state, inputs, draws):
    """One train step on the host clock with a synchronize after the
    forward, the backward and the optimizer: (forward, backward, optimizer)
    seconds."""
    import torch

    model, opt = state.model, state.optimizer
    opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
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
    """Stage-3 training at full width through ``TargetDetectorTrainer``: two
    iterations of ``train()`` over an in-memory dataset (mapper, loader,
    hooks, a checkpoint), then the main path: ``TRAIN_WARMUP`` + ``TRAIN_TIMED``
    steps of the trainer's state on one repeated batch, launches counted per
    step, every loss finite, ``total_loss`` lower at the last step than at
    the first; one profiled step (device busy share) and one step split into
    forward, backward and optimizer."""
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
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    out_dir = Path(__file__).resolve().parent / "output" / "chip_smoke_train"
    shutil.rmtree(out_dir, ignore_errors=True)
    records = train_records(torch.Generator().manual_seed(7))
    coco.register_dataset("chip_smoke_train", lambda: types.SimpleNamespace(records=records))
    cfg = train_cfg(out_dir)
    cfg.SOLVER.MAX_ITER = 2
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    mapper = DatasetMapper(cfg, is_train=True, seed=0)
    batch = collate_batch([mapper(r) for r in records], cfg.TPU.IMAGE_BUCKETS,
                          required_size_divisibility(cfg))
    if tuple(batch["image"].shape[1:3]) != R50_CANVAS:
        raise AssertionError(f"canvas {batch['image'].shape[1:3]} != {R50_CANVAS}")
    t0 = time.perf_counter()
    trainer = TargetDetectorTrainer(cfg, device="cuda")
    inputs = batch_to_device(batch, "cuda")
    n_bn = calibrate_frozen_bn(trainer.model, inputs["image"])
    trainer.train()
    lines = [_json.loads(x) for x in open(out_dir / "metrics.json")]
    if not (out_dir / "model_0000002.pth").is_file() or not all(
            np.isfinite(r["total_loss"]) for r in lines):
        raise AssertionError(f"train(): no checkpoint or a non-finite loss: {lines}")
    log(f"  train(): 2 iterations through the loader in {time.perf_counter() - t0:.1f} s "
        f"(build included), total_loss {lines[-1]['total_loss']:.4f}, "
        f"{sum(p.numel() for p in trainer.model.parameters()) / 1e6:.2f}M params, "
        f"{sum(p.numel() for p in trainer.model.parameters() if p.requires_grad) / 1e6:.2f}M "
        f"trainable, {n_bn} FrozenBN statistics calibrated on the batch")
    n_gt = int(inputs["gt"].valid.sum())
    steps, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        t0 = time.perf_counter()
        m = train_step(cfg, trainer.state, inputs, trainer.sampling)
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            ms.append(1000 * (time.perf_counter() - t0))
        steps.append(m)
    counts = dict(LAUNCHES)
    n = len(steps)
    log(f"  train: launches in {n} steps " + _json.dumps(counts))
    for k, per in TRAIN_PER_STEP.items():
        if counts[k] != per * n:
            raise AssertionError(f"train: {counts[k]} launches of {k} in {n} steps, expected "
                                 f"{per} per step")
    for i, m in enumerate(steps):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: a non-finite loss {m}")
    log("  train: total_loss by step " + " ".join(f"{m['total_loss']:.4f}" for m in steps))
    log("  train: first / last step " + ", ".join(
        f"{k} {steps[0][k]:.4f} / {steps[-1][k]:.4f}" for k in steps[0]))
    if not steps[-1]["total_loss"] < steps[0]["total_loss"]:
        raise AssertionError("train: total_loss did not fall over the repeated batch")
    med = float(np.median(ms))
    log(f"  train: {med:.1f} ms per step of 2 images (median of {len(ms)}; min {min(ms):.1f}, "
        f"max {max(ms):.1f}), {2000 / med:.3f} images/s at the median, "
        f"{R50_CANVAS[0]}x{R50_CANVAS[1]} canvas, bf16, lr {TRAIN_LR}, {n_gt} GT boxes; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for k in ("roi_pool", "roi_pool_bwd", "nms"):
        results[k].setdefault("launches", {})["train"] = counts[k] // n

    # one step under the profiler, its trace held against the wrappers' counts
    for session in range(3):
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(cfg, trainer.state, inputs, trainer.sampling)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key not in RANGES]
        held = sum(e.count for e in kernels if any(k in e.key for k in PORT_KERNELS))
        if held == device_kernels(LAUNCHES):
            break
        log(f"  train profile: session {session + 1} of 3 holds {held} of the step's "
            f"{device_kernels(LAUNCHES)} launches of the port's kernels")
    busy = sum(e.self_device_time_total for e in kernels) / 1000.0
    log(f"  train profile: wall {1000 * wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (1000 * wall):.1f} % of wall)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  kernel {e.self_device_time_total / 1000:9.3f} ms x{e.count:<5d} {e.key[:90]}")
    for e in kernels:
        if any(k in e.key for k in ("roi_pool", "cast_bf16", "nms_")):
            log(f"  port kernel {e.self_device_time_total / 1000:9.3f} ms x{e.count:<5d} "
                f"{e.key[:90]}")
    fwd, bwd, opt = step_split(cfg, trainer.state, inputs, trainer.sampling)
    tot = fwd + bwd + opt
    log(f"  train split (host clock, synchronized): forward {1000 * fwd:.1f} ms "
        f"({100 * fwd / tot:.1f} %), backward {1000 * bwd:.1f} ms ({100 * bwd / tot:.1f} %), "
        f"optimizer {1000 * opt:.1f} ms ({100 * opt / tot:.1f} %)")
    del trainer, inputs
    torch.cuda.empty_cache()


# the narrow stage-3 config of the JAX package's train-step tests
NARROW_STAGE3 = [
    "TPU.COMPUTE_DTYPE", "float32", "MODEL.MASK_ON", "True", "MODEL.FPN.OUT_CHANNELS", "64",
    "MODEL.AFI.N_RDB", "1", "MODEL.AFI.GROWTH_RATE", "8",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16"]


def phase_train_card_vs_cpu(results):
    """One stage-3 step of a narrow float32 model (TF32 off) with the same
    weights (FrozenBN calibrated on the batch), batch and fixed subsample keys
    on the card and on the CPU: the losses at 1e-4 relative, each trainable
    gradient at 1e-3 of its largest entry (or 1e-5 of the largest of all). On
    the card the pool's forward and backward kernels run inside."""
    import torch

    from afigan_tpu_torch.config import cfg_from_yaml
    from afigan_tpu_torch.engine.stage3 import batch_to_device, init_stage3_state, loss_and_grads
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from afigan_tpu_torch.tools.frozen_bn import calibrate_frozen_bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg_from_yaml(STEP3_YAML)
    cfg.merge_from_list(NARROW_STAGE3)
    rng = np.random.RandomState(0)
    b, h, w, m = 2, 64, 64, 4
    boxes = np.zeros((b, m, 4), np.float32)
    boxes[:, 0] = [8, 8, 40, 32]
    boxes[:, 1] = [20, 24, 60, 56]
    batch = {"image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
             "image_sizes": np.asarray([[h, w]] * b, np.int32),
             "gt": {"boxes": boxes, "classes": np.zeros((b, m), np.int32),
                    "valid": np.array([[True, True, False, False]] * b),
                    "masks": rng.rand(b, m, 28, 28).astype(np.float32)}}

    def draws(shape, device):
        keys = np.random.RandomState(1000 + shape[-1]).rand(2, shape[-1]).astype(np.float32)
        return tuple(torch.from_numpy(np.broadcast_to(0.1 + 0.9 * k, shape).copy()).to(device)
                     for k in keys)

    out = {}
    for dev in ("cpu", "cuda"):
        state = init_stage3_state(cfg, dev, torch.Generator().manual_seed(1))
        if dev == "cpu":
            calibrate_frozen_bn(state.model, torch.from_numpy(batch["image"]))
        else:
            state.model.load_state_dict(out["cpu"][2])
        reset_launches()
        losses = loss_and_grads(cfg, state.model, batch_to_device(batch, dev), draws)
        grads = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                 if p.grad is not None}
        out[dev] = ({k: float(v) for k, v in losses.items()}, grads,
                    {k: v.cpu() for k, v in state.model.state_dict().items()},
                    dict(LAUNCHES))
    (lc, gc, _, _), (lg, gg, _, launched) = out["cpu"], out["cuda"]
    for k, want in lc.items():
        np.testing.assert_allclose(lg[k], want, rtol=1e-4, atol=1e-7, err_msg=k)
    if set(gg) != set(gc) or not gg:
        raise AssertionError("card and CPU train different parameters")
    # 1e-3 of each tensor's largest entry, or 1e-5 of the largest of all where
    # a tensor's sums cancel to far below their terms
    top = max(float(g.abs().max()) for g in gc.values())
    worst = 0.0
    for name, want in gc.items():
        bound = max(1e-3 * float(want.abs().max()), 1e-5 * top)
        err = float((gg[name] - want).abs().max())
        worst = max(worst, err / bound)
        if not err <= bound:
            raise AssertionError(f"gradient {name}: {err} > {bound}")
    for k, per in (("roi_pool", 2), ("roi_pool_bwd", 2), ("nms", b)):
        if launched[k] != per:
            raise AssertionError(f"train card_vs_cpu: {launched[k]} launches of {k}, "
                                 f"expected {per}")
    log("  train card_vs_cpu: losses " + ", ".join(f"{k} {lg[k]:.6f} (cpu {lc[k]:.6f})"
                                                 for k in lc)
        + f"; {len(gg)} trainable gradients, worst error {worst:.3f} of its bound; "
        f"launches on the card {json.dumps({k: v for k, v in launched.items() if v})}")
    torch.backends.cudnn.allow_tf32 = True


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


def card_vs_cpu(name, cfg, canvas, size):
    import torch

    from afigan_tpu_torch.engine.inference import predict
    from afigan_tpu_torch.models import build_model
    from afigan_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    cfg.TPU.COMPUTE_DTYPE = "float32"
    # tests/test_golden_regression.py's test-time settings: normalised inputs
    # so random weights give non-degenerate detections, every class scored,
    # 128/64 proposals and 16 detections. With random weights most scores
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
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    rng = np.random.RandomState(42)
    batch = random_batch(rng, 1, canvas, [size])
    reset_launches()
    d_g, m_g = predict(gpu, batch)
    launched = {k: v for k, v in LAUNCHES.items() if v}
    d_c, m_c = predict(cpu, batch)
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
    log(msg + f"; launches on the card {json.dumps(launched)}")
    return launched


def phase_card_vs_cpu(results):
    import torch

    from afigan_tpu_torch.config import main_path_cfg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
    torch.backends.cudnn.allow_tf32 = True


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
                        ("nms_ab", phase_nms_ab), ("train", phase_train),
                        ("card_vs_cpu", phase_card_vs_cpu),
                        ("train_card_vs_cpu", phase_train_card_vs_cpu)):
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
