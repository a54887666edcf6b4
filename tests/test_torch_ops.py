"""The port's ops against the JAX package's, on the CPU in fp32.

Inputs and weights are made with numpy from a seed and handed to both sides.
The plain conv3d and attention (the CPU side of the port's hand-written CUDA
kernels) are also held against the JAX Pallas kernels in interpret mode, at
the JAX kernel tests' tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.ops import activations as jax_act
from rho_diffusion_tpu.ops.attention import xla_attention as jax_xla_attention
from rho_diffusion_tpu.ops.convolution import Downsample as JaxDownsample
from rho_diffusion_tpu.ops.convolution import Upsample as JaxUpsample
from rho_diffusion_tpu.ops.convolution import conv_nd as jax_conv_nd
from rho_diffusion_tpu.ops.embeddings import sinusoidal_position_embedding as jax_sinusoidal
from rho_diffusion_tpu.ops.norm import GroupNorm32 as JaxGroupNorm32
from rho_diffusion_tpu.ops.pallas.conv3d import conv3d_pallas
from rho_diffusion_tpu.ops.pallas.flash_attention import _flash_fwd_padded
from rho_diffusion_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from rho_diffusion_tpu_torch.ops import activations as torch_act
from rho_diffusion_tpu_torch.ops.attention import attention, xla_attention
from rho_diffusion_tpu_torch.ops.convolution import Downsample, Upsample, conv_nd
from rho_diffusion_tpu_torch.ops.embeddings import sinusoidal_position_embedding
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_plain
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import (
    LOG2E, flash_attention, flash_lse_plain, flash_plan)
from rho_diffusion_tpu_torch.ops.norm import GroupNorm32

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def conv_kernel_to_torch(k):
    """flax [*K, I, O] -> torch [O, I, *K]."""
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd, *range(nd)))


@pytest.mark.parametrize("channels", [64, 24, 96], ids=["c64", "c24-fallback", "c96"])
def test_groupnorm32_matches_jax(channels):
    """fp32 statistics; 24 channels take the largest-divisor group count."""
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.normal(size=(2, 4, 5, channels))).astype(np.float32)
    scale = rng.normal(size=channels).astype(np.float32)
    bias = rng.normal(size=channels).astype(np.float32)
    params = {"GroupNorm_0": {"scale": scale, "bias": bias}}
    want = np.asarray(JaxGroupNorm32().apply({"params": params}, jnp.asarray(x)))
    gn = GroupNorm32(channels)
    with torch.no_grad():
        gn.weight.copy_(t(scale))
        gn.bias.copy_(t(bias))
        got = gn(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_groupnorm32_keeps_bf16_dtype():
    gn = GroupNorm32(32)
    x = torch.randn(2, 3, 32).to(torch.bfloat16)
    assert gn(x).dtype == torch.bfloat16


def test_sinusoidal_embedding_matches_jax():
    tt = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jax_sinusoidal(jnp.asarray(tt), 64))
    got = sinusoidal_position_embedding(t(tt), 64).numpy()
    # omega = 10000^(2i/dim) may differ by an ulp between the two pow
    # implementations; at t ~ 1e3 that is ~1e-4 of the argument
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("name", sorted(torch_act._ACTIVATIONS))
def test_activation_matches_jax(name):
    x = np.linspace(-6.0, 6.0, 97, dtype=np.float32)
    want = np.asarray(jax_act.resolve_activation(name)(jnp.asarray(x)))
    got = torch_act.resolve_activation(name)(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "dims,shape", [(1, (2, 9, 3)), (2, (2, 6, 7, 3)), (3, (2, 4, 5, 6, 3))],
    ids=["1d", "2d", "3d"],
)
def test_conv_nd_matches_jax(dims, shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    jmod = jax_conv_nd(dims, 5, 3)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": np.asarray(params["kernel"]),
              "bias": rng.normal(size=5).astype(np.float32)}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = conv_nd(dims, 3, 5, 3)
    with torch.no_grad():
        mod.weight.copy_(t(conv_kernel_to_torch(params["kernel"])))
        mod.bias.copy_(t(params["bias"]))
        got = mod(t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dims,shape", [(2, (2, 4, 6, 3)), (3, (2, 3, 4, 6, 3))], ids=["2d", "3d"])
@pytest.mark.parametrize("use_conv", [True, False], ids=["conv", "noconv"])
def test_upsample_downsample_match_jax(dims, shape, use_conv):
    """Nearest upsampling and strided (symmetric k//2) or pooled
    downsampling; 3-D resamples the inner two dims only."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=shape).astype(np.float32)
    for jcls, tcls, sub in ((JaxUpsample, Upsample, "conv"), (JaxDownsample, Downsample, "op")):
        jmod = jcls(dims, use_conv, out_channels=4 if use_conv else None)
        variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jmod.apply(variables, jnp.asarray(x)))
        mod = tcls(dims, use_conv, 3, 4 if use_conv else None)
        if use_conv:
            p = variables["params"][sub]
            with torch.no_grad():
                getattr(mod, sub).weight.copy_(t(conv_kernel_to_torch(np.asarray(p["kernel"]))))
                getattr(mod, sub).bias.copy_(t(rng.normal(size=4).astype(np.float32)))
            p = {sub: {"kernel": p["kernel"], "bias": getattr(mod, sub).bias.detach().numpy()}}
            want = np.asarray(jmod.apply({"params": p}, jnp.asarray(x)))
        with torch.no_grad():
            got = mod(t(x)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "shape,cout",
    [
        ((1, 4, 4, 4, 8), 8),
        ((2, 8, 4, 4, 16), 8),
        ((1, 4, 6, 5, 8), 16),
        ((2, 4, 8, 8, 4), 12),
        ((2, 4, 6, 6, 1), 16),   # Cin = 1: the UNet's input conv
        ((2, 4, 6, 6, 16), 1),   # Cout = 1: the UNet's output head
    ],
    ids=["cube", "d-tiled", "odd-w", "cout12", "cin1", "cout1"],
)
def test_conv3d_plain_matches_pallas_kernel(shape, cout):
    """The plain version of the port's conv3d kernel against the TPU kernel
    in interpret mode (shapes of tests/ops/test_conv3d_pallas.py plus the
    Cin=1 and Cout=1 heads), atol = rtol = 1e-4."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    k = (0.1 * rng.normal(size=(3, 3, 3, shape[-1], cout))).astype(np.float32)
    want = np.asarray(conv3d_pallas(jnp.asarray(x), jnp.asarray(k), interpret=True))
    w = t(conv_kernel_to_torch(k))
    got = conv3d_plain(t(x), w).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(conv3d(t(x), w).numpy(), got)


def test_conv3d_plain_bias_and_bf16():
    rng = np.random.default_rng(4)
    x = t(rng.normal(size=(1, 3, 4, 5, 8)).astype(np.float32))
    w = t((0.1 * rng.normal(size=(6, 8, 3, 3, 3))).astype(np.float32))
    b = t(rng.normal(size=6).astype(np.float32))
    out = conv3d_plain(x, w, b)
    np.testing.assert_allclose(out.numpy(), (conv3d_plain(x, w) + b).numpy(), atol=1e-6)
    ob = conv3d_plain(x.bfloat16(), w.bfloat16(), b.bfloat16())
    assert ob.dtype == torch.bfloat16
    np.testing.assert_allclose(ob.float().numpy(), out.numpy(), atol=0.05, rtol=0.05)


def qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 300, 4, 32)])
def test_xla_attention_matches_jax(shape):
    q, k, v = qkv(shape, 5)
    want = np.asarray(jax_xla_attention(*(jnp.asarray(a) for a in (q, k, v))))
    got = xla_attention(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize(
    "shape,blocks",
    [
        ((2, 256, 2, 64), {}),                              # K1: one K/V block
        ((1, 300, 4, 32), {}),                              # K1, ragged T
        ((1, 384, 2, 32), {"block_q": 128, "block_k": 128}),  # K2: online softmax
        ((1, 2304, 1, 16), {}),  # K2 by JAX's default blocks: K/V over 2048 tokens
    ],
    ids=["k1", "k1-ragged", "k2", "k2-default-blocks"],
)
def test_flash_plain_matches_pallas_kernel(shape, blocks):
    """The flash kernel's plain version (and the CPU side of the dispatcher)
    against the TPU kernels in interpret mode, atol 5e-5."""
    q, k, v = qkv(shape, 6)
    want = np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                          interpret=True, **blocks))
    got = flash_attention(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    for backend in ("auto", "xla", "flash"):
        np.testing.assert_allclose(attention(t(q), t(k), t(v), backend=backend).numpy(), want,
                                   atol=5e-5)


@pytest.mark.parametrize(
    "shape,block_q,block_k",
    [
        ((1, 512, 16, 16), 128, 512),  # the ViT at patch 4: K1, one K/V block of 512
        ((2, 64, 4, 32), 128, 128),    # D = 32 at T = 64: K1 over a padded block
    ],
    ids=["vit-patch4-d16", "d32-t64"],
)
def test_flash_plain_matches_pallas_kernel_at_narrow_head_dims(shape, block_q, block_k):
    """At the narrow route's head dims (bf16 there on the card) the flash
    kernel's plain version, and its base-2 LSE (``flash_lse_plain``, what
    the narrow kernel writes for the backward), against the TPU kernel K1
    in interpret mode with its natural-log LSE, atol 5e-5. The ViT's
    patch-4 attention (T 512, 16 heads of 16) is the shape where JAX's
    dispatcher sends the ViT to this kernel."""
    b, tq, h, d = shape
    assert flash_plan(b, h, tq, tq, d).route == "narrow"
    q, k, v = qkv(shape, 8)

    def fold(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, tq, d)

    o, residuals = _flash_fwd_padded(fold(q), fold(k), fold(v), block_q, block_k,
                                     interpret=True)
    lse = np.asarray(residuals[4])[:, :tq, 0].reshape(b, h, tq)  # natural log, replicated lanes
    want = np.asarray(o).reshape(b, h, tq, d).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(flash_attention(t(q), t(k), t(v)).numpy(), want, atol=5e-5)
    np.testing.assert_allclose(flash_lse_plain(t(q), t(k)).numpy(), lse * LOG2E, atol=5e-5)
    np.testing.assert_allclose(
        np.asarray(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), interpret=True)),
        want, atol=5e-5)


def test_attention_unknown_backend_raises():
    q, k, v = (t(a) for a in qkv((1, 8, 1, 4), 7))
    with pytest.raises(ValueError, match="backend"):
        attention(q, k, v, backend="nope")
