"""The launch paths around the port's window-attention and AF-interpolator
kernels, float32 on the CPU.

The attention wrapper reads q, k and v through their strides, so the Swin
block passes views of its packed qkv tensor: on views and on contiguous
copies it must give the same numbers, and the JAX Pallas kernel's (interpret
mode) within 1e-5 absolute on O(1) values, the tolerance of
tests/test_torch_port_swin.py. ``WindowAttention`` keeps its gathered bias and
``AFIGenerator`` its kernel-layout weights between forwards; both must equal a
fresh build and follow every change of the weights.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.ops.pallas.window_attention import fused_window_attention as jax_attention
from afigan_tpu_torch.models.afi import AFIGenerator
from afigan_tpu_torch.models.swin import WindowAttention
from afigan_tpu_torch.ops.kernels import afi_generator as ag
from afigan_tpu_torch.ops.kernels.window_attention import fused_window_attention


@pytest.mark.parametrize("n,nw", [(49, 0), (49, 4), (144, 0), (144, 3)])
def test_attention_on_views_of_packed_qkv(n, nw):
    rng = np.random.RandomState(n + nw)
    bnw, nh, d = 12, 2, 32
    packed = rng.randn(bnw, n, 3, nh, d).astype(np.float32)
    bias = rng.randn(nh, n, n).astype(np.float32)
    mask = None
    if nw:
        mask = np.where(rng.rand(nw, n, n) < 0.3, -100.0, 0.0).astype(np.float32)
        mask[:, np.arange(n), np.arange(n)] = 0.0
    scale = d ** -0.5
    q, k, v = torch.from_numpy(packed).permute(2, 0, 3, 1, 4)  # (bnw, nh, n, d) views
    assert not q.is_contiguous() and q.stride(-1) == 1
    tbias = torch.from_numpy(bias)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = fused_window_attention(q, k, v, tbias, tmask, scale=scale)
    same = fused_window_attention(q.contiguous(), k.contiguous(), v.contiguous(), tbias, tmask,
                                  scale=scale)
    assert torch.equal(got, same)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(packed[:, :, i].transpose(0, 2, 1, 3)))
                  for i in range(3))
    want = jax_attention(jq, jk, jv, jnp.asarray(bias),
                         None if mask is None else jnp.asarray(mask), scale=scale,
                         interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_attention_raises_on_a_strided_last_dimension():
    q = torch.zeros(4, 2, 16, 64)[..., ::2]  # head dimension 32 at stride 2
    bias = torch.zeros(2, 16, 16)
    with pytest.raises(ValueError, match="contiguous"):
        fused_window_attention(q, q, q, bias, scale=1.0)
    k = torch.zeros(4, 2, 16, 32)
    with pytest.raises(ValueError, match="vs q"):
        fused_window_attention(k, k[:, :1], k, bias, scale=1.0)


def _fresh_bias(attn):
    n = attn.window_size ** 2
    b = attn.relative_position_bias_table[attn.relative_position_index]
    return b.reshape(n, n, attn.num_heads).permute(2, 0, 1).float()


def test_window_attention_keeps_its_bias_until_the_table_changes():
    rng = np.random.RandomState(0)
    attn = WindowAttention(64, 2, 4)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(torch.from_numpy(
            rng.randn(*attn.relative_position_bias_table.shape).astype(np.float32)))
    b0 = attn.bias()
    assert b0.dtype == torch.float32 and b0.is_contiguous() and tuple(b0.shape) == (2, 16, 16)
    assert torch.equal(b0, _fresh_bias(attn))
    assert attn.bias() is b0  # kept
    x = torch.from_numpy(rng.randn(3, 16, 64).astype(np.float32))
    with torch.inference_mode():
        y0 = attn(x, None)
    assert attn.bias() is b0  # a forward leaves it
    # load_state_dict copies in place
    sd = {k: v.clone() for k, v in attn.state_dict().items()}
    sd["relative_position_bias_table"] += 1.0
    attn.load_state_dict(sd)
    b1 = attn.bias()
    assert b1 is not b0 and torch.equal(b1, _fresh_bias(attn)) and not torch.equal(b1, b0)
    # any other in-place write
    with torch.no_grad():
        attn.relative_position_bias_table.mul_(0.5)
    b2 = attn.bias()
    assert b2 is not b1 and torch.equal(b2, _fresh_bias(attn))
    # a cast replaces the storage
    attn.double()
    assert attn.bias() is not b2 and torch.equal(attn.bias(), _fresh_bias(attn))
    attn.float()
    with torch.inference_mode():
        y1 = attn(x, None)
    assert not torch.equal(y0, y1)


def _generator(seed=0, c=16, g=8):
    gen = AFIGenerator(c, 3, g)
    gen.init_weights(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in gen.modules():
            if getattr(m, "bias", None) is not None:
                m.bias.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return gen


def _assert_layout_is_fresh(gen, laid, dtype):
    head_w, head_b, rdbs, wmid, bmid, wup, bup, wtail, btail = gen._weights()
    c, g = head_w.shape[0], rdbs[0][0].shape[0]
    f32 = dtype == torch.float32

    def conv_shape(cin, cout):
        return (9, cin, cout) if f32 else (9, cout, cin)

    def check(pair, want, shape):
        for got, ref in zip(pair, want):
            assert (got is None) == (ref is None)
            if got is not None:
                assert got.dtype == dtype and got.is_contiguous() and torch.equal(got, ref)
        assert tuple(pair[0].shape) == shape

    check(laid.head, ag.lay_out_conv(head_w, head_b, dtype), conv_shape(c, c))
    assert len(laid.rdbs) == 3
    for pairs, ws in zip(laid.rdbs, rdbs):
        assert len(pairs) == 5
        for i, (pair, w) in enumerate(zip(pairs, ws)):
            check(pair, ag.lay_out_conv(w, None, dtype),
                  conv_shape(c + i * g, g if i < 4 else c))
    check(laid.mid, ag.lay_out_conv(wmid, bmid, dtype), conv_shape(c, c))
    check(laid.tail, ag.lay_out_conv(wtail, btail, dtype), conv_shape(c, c))
    # the four phase kernels of the transposed conv, from the torch weight
    want_up = ag.phase_kernels(wup.detach()).to(dtype)  # (4, 9, Cin, Cout)
    if not f32:
        want_up = want_up.transpose(-1, -2)
    assert tuple(laid.up[0].shape) == (4, *conv_shape(c, c))
    assert torch.equal(laid.up[0], want_up.contiguous())
    assert torch.equal(laid.up[1], bup.detach().to(dtype))
    assert laid.upsample() == (laid.mid, laid.up, laid.tail)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_generator_keeps_its_layout_until_a_weight_changes(dtype):
    gen = _generator()
    laid = gen.laid_out(dtype)
    _assert_layout_is_fresh(gen, laid, dtype)
    assert gen.laid_out(dtype) is laid  # kept
    # another dtype is another layout
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    assert gen.laid_out(other) is not laid
    laid = gen.laid_out(dtype)
    # load_state_dict copies in place
    gen.load_state_dict(_generator(seed=5).state_dict())
    again = gen.laid_out(dtype)
    assert again is not laid and not torch.equal(again.head[0], laid.head[0])
    _assert_layout_is_fresh(gen, again, dtype)
    # one in-place write to one weight
    with torch.no_grad():
        gen.Generators[0][3][0].weight.mul_(2.0)
    third = gen.laid_out(dtype)
    assert third is not again and torch.equal(third.up[0], (again.up[0].float() * 2).to(dtype))
    _assert_layout_is_fresh(gen, third, dtype)
    # a cast and back replaces every parameter's storage
    gen.double()
    gen.float()
    _assert_layout_is_fresh(gen, gen.laid_out(dtype), dtype)


def test_wrappers_take_the_layout_made_ahead_or_make_it():
    """``laid`` changes nothing on the CPU (the plain versions read the torch
    layout), and a layout that does not fit its conv is refused where it
    would be used."""
    gen = _generator()
    laid = gen.laid_out(torch.float32)
    head_w, head_b, rdbs, *up = gen._weights()
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 8, 16).astype(np.float32))
    with torch.no_grad():
        r = ag.fused_generator_chain(x, head_w, head_b, rdbs, 0.2)
        assert torch.equal(r, ag.fused_generator_chain(x, head_w, head_b, rdbs, 0.2, laid=laid))
        assert torch.equal(ag.fused_rdb(x, rdbs[0]), ag.fused_rdb(x, rdbs[0], laid=laid.rdbs[0]))
        assert torch.equal(ag.fused_upsample(r, x, *up),
                           ag.fused_upsample(r, x, *up, laid=laid.upsample()))
        assert torch.equal(gen(x), ag.fused_upsample(r, x, *up))
    with pytest.raises(ValueError, match="laid-out weight"):
        ag._check_laid(*laid.rdbs[0][0], (9, 16, 16), None, x)
    with pytest.raises(ValueError, match="laid-out weight"):
        ag._check_laid(*gen.laid_out(torch.bfloat16).head, (9, 16, 16), head_b, x)
    with pytest.raises(ValueError, match="bias"):
        ag._check_laid(laid.head[0], None, (9, 16, 16), head_b, x)
