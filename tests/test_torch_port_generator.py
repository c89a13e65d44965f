"""Port AF interpolator vs the JAX package, float32 on the CPU.

The port's chain, single dense block and upsample (their plain versions: on a CPU tensor the
wrappers run F.conv2d over real concatenations) are held against the JAX
Pallas kernels in interpret mode, and the port ``AFIGenerator`` against
the JAX ``AFIGenerator``, on the same numpy inputs and the same weights
(JAX init → ``generator_state_dict``). Tolerances as
tests/test_pallas_chain.py: rtol = atol = 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from afigan_tpu.models.afi.generator import AFIGenerator as JaxGenerator
from afigan_tpu.ops.pallas import fused_generator_chain as jax_chain
from afigan_tpu.ops.pallas import fused_rdb as jax_rdb
from afigan_tpu.ops.pallas import fused_upsample as jax_upsample
from afigan_tpu_torch.models.afi import AFIGenerator
from afigan_tpu_torch.ops.kernels import afi_generator as ag
from afigan_tpu_torch.utils.converters import generator_state_dict

C, G = 32, 8
SHAPES = [(16, 16), (24, 40), (13, 18)]


def _jax_and_port(h, w, seed=0, n_rdb=3):
    x = np.random.RandomState(seed).randn(2, h, w, C).astype(np.float32)
    jm = JaxGenerator(in_channels=C, n_rdb=n_rdb, growth_rate=G)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    tm = AFIGenerator(C, n_rdb, G)
    sd = generator_state_dict(jax.tree.map(np.asarray, params))
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return x, jm, params, tm


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw", SHAPES)
def test_chain_matches_pallas_interpret(hw):
    x, _, params, tm = _jax_and_port(*hw)
    rir = params["generators_0/rir"]
    rdb_ws = [[rir[f"rdb{i}"][f"conv{j}"]["conv"]["kernel"] for j in range(1, 6)]
              for i in range(3)]
    want = jax_chain(jnp.asarray(x), params["generators_0/head"]["conv"]["kernel"],
                     params["generators_0/head"]["conv"]["bias"], rdb_ws, 0.2,
                     tile=8, interpret=True)
    head, rir_t = tm.Generators[0][0], tm.Generators[0][1]
    with torch.no_grad():
        got = ag.fused_generator_chain(torch.from_numpy(x), head[0].weight,
                                       head[0].bias,
                                       [b.weights() for b in rir_t.RDBs], 0.2)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_rdb_matches_pallas_interpret(hw):
    """One dense block: the port's ``fused_rdb`` (and its plain version)
    against the JAX Pallas ``fused_rdb`` in interpret mode, within 1e-5."""
    x, _, params, tm = _jax_and_port(*hw, seed=3, n_rdb=1)
    rdb = params["generators_0/rir"]["rdb0"]
    want = jax_rdb(jnp.asarray(x), [rdb[f"conv{j}"]["conv"]["kernel"] for j in range(1, 6)],
                   0.2, tile=8, interpret=True)
    ws = tm.Generators[0][1].RDBs[0].weights()
    with torch.no_grad():
        got = ag.fused_rdb(torch.from_numpy(x), ws, 0.2)
        plain = ag.fused_rdb_plain(torch.from_numpy(x), ws, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("n_rdb", [1, 2])
def test_generator_with_other_block_counts_matches_jax(n_rdb):
    """Without three blocks the port takes the head conv, one ``fused_rdb``
    per block and the RiR residual, as the JAX package's fused path does."""
    x, jm, params, tm = _jax_and_port(13, 18, seed=4, n_rdb=n_rdb)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_upsample_matches_pallas_interpret(hw):
    x, _, params, tm = _jax_and_port(*hw, seed=1)
    r = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    p = params
    want = jax_upsample(jnp.asarray(r), jnp.asarray(x),
                        p["generators_0/mid"]["conv"]["kernel"],
                        p["generators_0/mid"]["conv"]["bias"],
                        p["generators_0/up"]["kernel"], p["generators_0/up"]["bias"],
                        p["generators_0/tail"]["conv"]["kernel"],
                        p["generators_0/tail"]["conv"]["bias"], tile=8, interpret=True)
    _, _, mid, up, tail = tm.Generators[0]
    with torch.no_grad():
        got = ag.fused_upsample(torch.from_numpy(r), torch.from_numpy(x),
                                mid[0].weight, mid[0].bias, up[0].weight, up[0].bias,
                                tail[0].weight, tail[0].bias)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], C)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_generator_module_matches_jax(hw):
    x, jm, params, tm = _jax_and_port(*hw, seed=2)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_subpixel_phase_kernels_equal_conv_transpose():
    """The (4, 9, Cin, Cout) phase kernels the CUDA deconv reads, applied as
    4 dense 3x3 convs and interleaved, equal ConvTranspose2d(k6, s2, p2)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, 7, 9, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 5, 6, 6).astype(np.float32))
    want = ag.subpixel_deconv_plain(x, w, None, leaky=False)
    ph = ag.phase_kernels(w)  # (4, 9, Cin, Cout)
    out = torch.zeros(1, 14, 18, 5)
    for p in range(4):
        k = ph[p].reshape(3, 3, 8, 5).permute(3, 2, 0, 1)  # OIHW
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k, padding=1)
        out[:, p // 2::2, p % 2::2] = y.permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_conv3x3_fused_epilogue_matches_unfused():
    """Multi-source input, both residuals and the bilinear skip of the plain
    conv (the CUDA kernel's contract) against explicit torch ops."""
    rng = np.random.RandomState(4)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    srcs = [t(1, 6, 8, 4), t(1, 6, 8, 3)]
    w, b = t(5, 7, 3, 3), t(5)
    r1, r2, skip = t(1, 6, 8, 5), t(1, 6, 8, 5), t(1, 3, 4, 5)
    got = ag.conv3x3(srcs, w, b, leaky=True, res1=r1, s1=0.2, res2=r2, s2=0.2,
                     skip=skip)
    x = torch.cat(srcs, -1).permute(0, 3, 1, 2)
    v = torch.nn.functional.conv2d(x, w, b, padding=1).permute(0, 2, 3, 1)
    v = r2 + 0.2 * (r1 + 0.2 * torch.nn.functional.leaky_relu(v, 0.2))
    up = torch.nn.functional.interpolate(skip.permute(0, 3, 1, 2), scale_factor=2,
                                         mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(), (v + up.permute(0, 2, 3, 1)).numpy(),
                               rtol=1e-5, atol=1e-5)
