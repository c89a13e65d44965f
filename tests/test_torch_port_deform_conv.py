"""The deformable conv's plain sampling and plain adjoint
(``afigan_tpu_torch/ops/kernels/deform_conv.py``), the plain versions of the
kernels of ``csrc/deform_conv.cu``, against the JAX function
``afigan_tpu/ops/deform_conv.py::deform_conv2d`` and ``jax.vjp`` of it,
float32 on the CPU.

Inputs from a numpy seed: x (2, 11, 13, 8), 7 output channels, a sigmoid
mask, at stride 1 and 2 and dilation 1 and 2, modulated and not, x and the
offsets in float32 and in bfloat16 (the mask float32, as the model passes
it), under three offset sets: fractional (uniform in [-3, 3), none an
integer, taps outside the map; bf16 values in both dtypes), all zero (every sample on a pixel: the
block's first training step, whose offset predictor starts at zero), and
integer-valued, landing on rows -1, 0, H-1, H and columns -1, 0, W-1, W
and on interior pixels. At an integer coordinate the offsets' gradient is
the forward difference, as JAX's ``floor`` (no gradient) gives it.

Tolerances. The forward at 1e-5 of the largest output entry: both sides
sample in float32, and the product's sums over 72 terms run in another order
in XLA and in torch. Each gradient at 1e-4 of its largest entry: x's
gradient sums up to 36 contributions an entry in another order (``index_add_``
against XLA's scatter), the offsets' and the mask's gradients sum over the
channels in another order, and the columns' gradient comes from a product
whose order differs too. With bf16 inputs JAX's gradients are taken with
respect to float32 copies of the same values: the float32 gradients the bf16
ones round (the plain adjoint returns float32; ``DeformConv2dFunction``
rounds once).

Mutants that the bounds must reject: (dy, dx) swapped, the mask dropped
from the adjoint, and the backward difference at integer coordinates (the
sample's cell taken as the one before it, ``ceil - 1``, which changes
nothing off the integers and nothing in the forward).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from afigan_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from afigan_tpu_torch.ops import deform_conv as port_deform_conv
from afigan_tpu_torch.ops.kernels import LAUNCHES
from afigan_tpu_torch.ops.kernels import deform_conv as dc

H, W, CIN, COUT = 11, 13, 8, 7
OFFSETS = ("fractional", "zero", "integer")
DTYPES = ("float32", "bfloat16")
FWD_REL, BWD_REL = 1e-5, 1e-4
SAMPLE_GRID = dc.sample_grid  # the mutants below wrap or replace it


def _base(n, stride, dilation, size):
    """(n, 3): each output row's (column's) three taps before their offset."""
    return (np.arange(n) * stride - dilation)[:, None] + np.arange(3) * dilation


def make_inputs(stride, dilation, modulated, offsets, seed, dtype="float32", cin=CIN):
    """numpy inputs: x (2, H, W, cin), offsets (2, Ho, Wo, 18) in x's dtype's
    values (rounded to bf16 for ``dtype`` bfloat16), mask (2, Ho, Wo, 9) or
    None, weight OIHW (COUT, cin, 3, 3), the output's cotangent."""
    rng = np.random.RandomState(seed)
    ho, wo = dc.out_size(H, W, 3, 3, stride, dilation, dilation)
    x = rng.randn(2, H, W, cin).astype(np.float32)
    if offsets == "fractional":
        # bf16 values (the model's offsets), none an integer
        off = torch.from_numpy(rng.uniform(-3, 3, (2, ho, wo, 18)).astype(np.float32))
        off = off.bfloat16().float().numpy()
        off = np.where(off == np.round(off), off + 0.375, off).astype(np.float32)
    elif offsets == "zero":
        off = np.zeros((2, ho, wo, 18), np.float32)
    else:
        def land(n, size):  # one of -1, 0, size-1, size or an interior pixel
            border = np.array([-1, 0, size - 1, size])[rng.randint(0, 4, n)]
            inner = rng.randint(1, size - 1, n)
            return np.where(rng.rand(n) < 0.6, border, inner)

        ty = land(2 * ho * wo * 9, H).reshape(2, ho, wo, 3, 3)
        tx = land(2 * ho * wo * 9, W).reshape(2, ho, wo, 3, 3)
        by = _base(ho, stride, dilation, H)[None, :, None, :, None]
        bx = _base(wo, stride, dilation, W)[None, None, :, None, :]
        off = np.stack([ty - by, tx - bx], -1).reshape(2, ho, wo, 18).astype(np.float32)
    mask = (1 / (1 + np.exp(-rng.randn(2, ho, wo, 9)))).astype(np.float32) if modulated else None
    weight = rng.randn(COUT, cin, 3, 3).astype(np.float32)
    cot = rng.randn(2, ho, wo, COUT).astype(np.float32)
    if dtype == "bfloat16":  # the bf16 values, held as float32
        x, off = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, off))
    return x, off, mask, weight, cot


def _t(a, dtype="float32"):
    return None if a is None else torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _hwio(weight):
    return jnp.asarray(weight.transpose(2, 3, 1, 0))


def jax_run(x, off, mask, weight, cot, stride, dilation):
    """JAX's output and its VJP with respect to x, the offsets, the HWIO
    weight and the mask, all float32 numpy (weight's gradient as OIHW)."""
    def f(x_, o_, w_, m_):
        return jax_deform_conv2d(x_, o_, w_, m_, stride=stride, padding=dilation,
                                 dilation=dilation)

    out, vjp = jax.vjp(f, _j(x), _j(off), _hwio(weight), _j(mask))
    gx, goff, gw, gm = vjp(jnp.asarray(cot))
    return (np.asarray(out), np.asarray(gx), np.asarray(goff),
            np.asarray(gw).transpose(3, 2, 0, 1), None if mask is None else np.asarray(gm))


def within(got, want, rel):
    """max |got - want| <= rel * max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


def port_plain(x, off, mask, weight, cot, stride, dilation, dtype="float32"):
    """The port's plain forward (columns @ weight matrix) and plain adjoint:
    (out, grad_x, grad_offsets, grad_weight, grad_mask), float32."""
    xt, ot, mt, wt = _t(x, dtype), _t(off, dtype), _t(mask), _t(weight)
    cols = dc.deform_im2col(xt, ot, mt, (3, 3), stride, dilation, dilation)
    wmat = dc.weight_matrix(wt)
    out = (cols @ wmat).reshape(cot.shape)
    g = torch.from_numpy(cot).reshape(-1, COUT)
    gx, goff, gm = dc.deform_col2im(g @ wmat.t(), xt, ot, mt, (3, 3), stride, dilation,
                                    dilation)
    gw = (cols.t() @ g).reshape(3, 3, x.shape[-1], COUT).permute(3, 2, 0, 1)
    return out, gx, goff, gw, gm


CASES = [(s, d, m, o, t) for s in (1, 2) for d in (1, 2) for m in (False, True)
         for o in OFFSETS for t in DTYPES]
IDS = [f"s{s}-d{d}-{'mod' if m else 'plain'}-{o}-{t}" for s, d, m, o, t in CASES]


def _seed(stride, dilation, modulated, offsets):
    return 100 * stride + 10 * dilation + 2 * modulated + OFFSETS.index(offsets)


@pytest.mark.parametrize("stride,dilation,modulated,offsets,dtype", CASES, ids=IDS)
def test_plain_forward_equals_jax(stride, dilation, modulated, offsets, dtype):
    x, off, mask, weight, cot = make_inputs(stride, dilation, modulated, offsets,
                                            _seed(stride, dilation, modulated, offsets), dtype)
    if offsets == "integer":
        assert (off == np.round(off)).all()
    if offsets == "fractional":
        assert (off != np.round(off)).all()
    want = jax_run(x, off, mask, weight, cot, stride, dilation)[0]
    got = port_deform_conv.deform_conv2d(_t(x, dtype), _t(off, dtype), _t(weight), _t(mask),
                                         stride, dilation, dilation)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert within(got, want, FWD_REL), float(np.abs(got.numpy() - want).max())


@pytest.mark.parametrize("stride,dilation,modulated,offsets,dtype", CASES, ids=IDS)
def test_plain_adjoint_equals_jax_vjp(stride, dilation, modulated, offsets, dtype):
    x, off, mask, weight, cot = make_inputs(stride, dilation, modulated, offsets,
                                            _seed(stride, dilation, modulated, offsets), dtype)
    _, jgx, jgoff, jgw, jgm = jax_run(x, off, mask, weight, cot, stride, dilation)
    _, gx, goff, gw, gm = port_plain(x, off, mask, weight, cot, stride, dilation, dtype)
    assert gx.dtype == goff.dtype == torch.float32
    for name, got, want in (("x", gx, jgx), ("offsets", goff, jgoff), ("weight", gw, jgw),
                            ("mask", gm, jgm)):
        if want is None:
            assert got is None
            continue
        assert tuple(got.shape) == want.shape, name
        assert np.abs(want).max() > 0, name
        assert within(got, want, BWD_REL), (name, float(np.abs(got.numpy() - want).max()),
                                            float(np.abs(want).max()))


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("cin", [10, 36])
def test_plain_adjoint_equals_jax_vjp_at_odd_channels(cin, offsets):
    """The card's contract cases off the main path, where the adjoint kernel
    is held against this plain adjoint: C % 4 != 0 (10, no vectors) and C
    not a multiple of the kernel's 16-channel chunk (10, 36), modulated,
    bf16, at stride 2 and dilation 2; every gradient against ``jax.vjp``."""
    x, off, mask, weight, cot = make_inputs(2, 2, True, offsets, 300 + cin, "bfloat16", cin)
    _, jgx, jgoff, jgw, jgm = jax_run(x, off, mask, weight, cot, 2, 2)
    _, gx, goff, gw, gm = port_plain(x, off, mask, weight, cot, 2, 2, "bfloat16")
    for name, got, want in (("x", gx, jgx), ("offsets", goff, jgoff), ("weight", gw, jgw),
                            ("mask", gm, jgm)):
        assert tuple(got.shape) == want.shape, name
        assert np.abs(want).max() > 0, name
        assert within(got, want, BWD_REL), (name, float(np.abs(got.numpy() - want).max()),
                                            float(np.abs(want).max()))


@pytest.mark.parametrize("offsets", OFFSETS)
@pytest.mark.parametrize("modulated", [False, True], ids=["plain", "mod"])
def test_function_equals_autograd_of_plain(modulated, offsets):
    """``DeformConv2dFunction`` on CPU tensors (the plain sampling, the
    products, the plain adjoint) against torch autograd through
    ``deform_conv2d_plain``: the same output bit for bit, every gradient at
    1e-5 of its largest entry (summation order)."""
    x, off, mask, weight, cot = make_inputs(2, 1, modulated, offsets, 7)
    leaves = [_t(a).requires_grad_() for a in (x, off, weight, mask) if a is not None]
    args = leaves if modulated else leaves + [None]
    out = dc.DeformConv2dFunction.apply(*args, 2, 1, 1)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    ref_args = ref_leaves if modulated else ref_leaves + [None]
    ref = dc.deform_conv2d_plain(ref_args[0], ref_args[1], ref_args[2], ref_args[3], 2, 1, 1)
    want = torch.autograd.grad(ref, ref_leaves, torch.from_numpy(cot))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert within(g, w.numpy(), 1e-5), float((g - w).abs().max())


def test_function_rounds_gradients_to_their_inputs_dtypes():
    """bf16 x and offsets (the model's), a float32 mask: the gradients come
    back bf16, bf16 and float32, each the float32 gradient rounded once."""
    x, off, mask, weight, cot = make_inputs(1, 1, True, "fractional", 8, "bfloat16")
    xt, ot = _t(x, "bfloat16").requires_grad_(), _t(off, "bfloat16").requires_grad_()
    wt, mt = _t(weight).requires_grad_(), _t(mask).requires_grad_()
    out = dc.DeformConv2dFunction.apply(xt, ot, wt, mt, 1, 1, 1)
    out.backward(torch.from_numpy(cot))
    assert (xt.grad.dtype, ot.grad.dtype, wt.grad.dtype, mt.grad.dtype) == (
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32)
    _, gx, goff, _, gm = port_plain(x, off, mask, weight, cot, 1, 1, "bfloat16")
    torch.testing.assert_close(xt.grad, gx.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(ot.grad, goff.bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(mt.grad, gm, rtol=0, atol=0)


def test_columns_layout_matches_oihw_weight():
    """Zero offsets, no mask, stride 1: column p, k*C + c is x at tap k of
    pixel p (zero padded), and the product with ``weight_matrix`` of the OIHW
    weight is the plain 3x3 conv."""
    x, off, _, weight, _ = make_inputs(1, 1, False, "zero", 3)
    xt = _t(x)
    cols = dc.deform_im2col(xt, _t(off), None, (3, 3), 1, 1, 1)
    assert cols.shape == (2 * H * W, 9 * CIN)
    pad = F.pad(xt, (0, 0, 1, 1, 1, 1))
    want = torch.stack([pad[:, ky:ky + H, kx:kx + W] for ky in range(3) for kx in range(3)],
                       dim=3).reshape(2 * H * W, 9 * CIN)
    torch.testing.assert_close(cols, want, rtol=0, atol=0)
    conv = F.conv2d(xt.permute(0, 3, 1, 2), _t(weight), padding=1).permute(0, 2, 3, 1)
    got = (cols @ dc.weight_matrix(_t(weight))).reshape(conv.shape)
    torch.testing.assert_close(got, conv, rtol=1e-5, atol=1e-5)


def test_cpu_route_launches_nothing():
    x, off, mask, weight, cot = make_inputs(1, 2, True, "fractional", 5)
    before = dict(LAUNCHES)
    leaves = [_t(a).requires_grad_() for a in (x, off, weight, mask)]
    port_deform_conv.deform_conv2d(*leaves, 1, 2, 2).backward(torch.from_numpy(cot))
    assert dict(LAUNCHES) == before
    assert all(t.grad is not None for t in leaves)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x, off, mask, _, _ = make_inputs(1, 1, True, "fractional", 6)
    xt, ot, mt = _t(x), _t(off), _t(mask)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        dc._check(xt.permute(0, 2, 1, 3), ot, mt, (3, 3), 1, 1, 1)
    with pytest.raises(ValueError, match="offsets must be"):
        dc._check(xt, ot[..., :16], mt, (3, 3), 1, 1, 1)
    with pytest.raises(ValueError, match="mask must be"):
        dc._check(xt, ot, mt[..., :8], (3, 3), 1, 1, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dc._check(xt.double(), ot, mt, (3, 3), 1, 1, 1)
    assert dc._check(xt, ot[..., :18], mt, (3, 3), 1, 1, 1) == (2, H, W, CIN, H, W)
    with pytest.raises(ValueError, match="devices"):
        dc.deform_im2col(xt.to("meta"), ot, mt)
    with pytest.raises(ValueError, match="devices"):
        dc.deform_col2im(torch.zeros(2 * H * W, 9 * CIN, device="meta"), xt, ot, mt)


# ---------------------------------------------------------------------------
# mutants the bounds must reject
# ---------------------------------------------------------------------------

def _swapped_grid(real):
    def grid(offsets, *a):
        return real(offsets.reshape(*offsets.shape[:3], -1, 2).flip(-1).reshape(offsets.shape),
                    *a)
    return grid


def _backward_difference_grid(offsets, h, w, kh, kw, stride, padding, dilation):
    """``sample_grid`` with the cell before an integer coordinate (ceil - 1):
    ly = 1 there instead of 0."""
    y0, x0, ly, lx = SAMPLE_GRID(offsets, h, w, kh, kw, stride, padding, dilation)
    sy, sx = y0.float() + ly, x0.float() + lx
    y0f, x0f = torch.ceil(sy) - 1, torch.ceil(sx) - 1
    return y0f.long(), x0f.long(), sy - y0f, sx - x0f


@pytest.mark.parametrize("stride", [1, 2])
def test_mutant_swapped_offsets_rejected(monkeypatch, stride):
    x, off, mask, weight, cot = make_inputs(stride, 1, True, "fractional", 21)
    want = jax_run(x, off, mask, weight, cot, stride, 1)
    monkeypatch.setattr(dc, "sample_grid", _swapped_grid(SAMPLE_GRID))
    got = port_plain(x, off, mask, weight, cot, stride, 1)
    assert not within(got[0], want[0], FWD_REL)
    assert not within(got[2], want[2], BWD_REL)


@pytest.mark.parametrize("offsets", ["fractional", "integer"])
def test_mutant_mask_dropped_from_adjoint_rejected(offsets):
    x, off, mask, weight, cot = make_inputs(1, 1, True, offsets, 22)
    _, jgx, jgoff, _, _ = jax_run(x, off, mask, weight, cot, 1, 1)
    wmat = dc.weight_matrix(_t(weight))
    g = torch.from_numpy(cot).reshape(-1, COUT) @ wmat.t()
    gx, goff, _ = dc.deform_col2im_plain(g, _t(x), _t(off), None)
    assert not within(gx, jgx, BWD_REL)
    assert not within(goff, jgoff, BWD_REL)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 2)])
def test_mutant_backward_difference_rejected(monkeypatch, stride, dilation):
    """At integer coordinates the mutant's forward and x-gradient still equal
    JAX's; the offsets' gradient must not. Off the integers it changes
    nothing (the fractional set passes)."""
    monkeypatch.setattr(dc, "sample_grid", _backward_difference_grid)
    for offsets, rejected in (("integer", True), ("zero", True), ("fractional", False)):
        x, off, mask, weight, cot = make_inputs(stride, dilation, True, offsets, 23)
        want = jax_run(x, off, mask, weight, cot, stride, dilation)
        got = port_plain(x, off, mask, weight, cot, stride, dilation)
        assert within(got[0], want[0], FWD_REL), offsets
        assert within(got[1], want[1], BWD_REL), offsets
        assert within(got[2], want[2], BWD_REL) != rejected, offsets
