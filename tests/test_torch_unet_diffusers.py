"""The port's ``UNet_Diffuser`` against the JAX package's, on the CPU in fp32.

* The same seeded JAX params (init, then every leaf shifted by seeded
  noise, so no zero-init layer stays zero) go through
  ``UNetDiffuser.state_dict_from_jax``; the port's forward and every
  parameter gradient of a fixed cotangent's loss equal JAX's forward and
  ``jax.grad``, at 16x16 and 32x32, batch 2, with and without
  MultiEmbeddings. Bar: relative MSE < 1e-9 over the output and over all
  gradients together (and over each gradient holding at least 1e-3 of
  their norm).
* The kwargs JAX accepts and ignores give JAX's tree and the port's same
  state_dict; ``attention_head_dim`` sets the heads; ``dims=3`` raises.
* The attention this backbone runs at DeepGalaxy's 128^2 has heads of 8
  channels over T 1024 and 4096; the port pads D 8 to 16 for its kernels.
  The port's flash Function at head dim 8 (its plain versions on the CPU,
  the padding and the 1/sqrt(8) scale included) holds against JAX's Pallas
  flash attention in interpret mode at T 512 and 1024, forward and
  gradients, at tests/ops/test_flash_attention.py's tolerances (2e-5,
  5e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.models.conditioning import MultiEmbeddings as JaxMultiEmbeddings
from rho_diffusion_tpu.models.unet_diffusers_compat import UNetDiffuser as JaxUNetDiffuser
from rho_diffusion_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings
from rho_diffusion_tpu_torch.models.unet import AttentionBlock
from rho_diffusion_tpu_torch.models.unet_diffusers_compat import UNetDiffuser
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention, padded_head_dim

torch.set_num_threads(2)
RTOL_MSE = 1e-9
SPACE = {"l": [0, 1, 2], "m": [-1, 0, 1]}
Y = np.array([[0.0, -1.0], [2.0, 1.0]], np.float32)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def build_pair(size: int, cond: bool, seed: int = 0, **extra):
    """(jax module, perturbed jax params, port module with those weights)."""
    kw = dict(data_shape=(size, size), in_channels=1, num_res_blocks=2, **extra)
    jkw, tkw = dict(kw), dict(kw)
    init = [jnp.zeros((1, size, size, 1)), jnp.zeros((1,), jnp.int32)]
    if cond:
        jkw.update(num_classes=9, cond_fn=JaxMultiEmbeddings(parameter_space=SPACE,
                                                             embedding_dim=128))
        tkw.update(num_classes=9, cond_fn=MultiEmbeddings(SPACE, 128))
        init.append(jnp.asarray(Y[:1]))
    j_model = JaxUNetDiffuser(**jkw)
    params = jax.jit(j_model.init)(jax.random.PRNGKey(seed), *init)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    t_model = UNetDiffuser(**tkw)
    t_model.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in UNetDiffuser.state_dict_from_jax(params).items()},
                            strict=True)
    return j_model, params, t_model.eval()


@pytest.mark.parametrize("cond", [False, True], ids=["plain", "multi-embeddings"])
@pytest.mark.parametrize("size", [16, 32])
def test_forward_and_gradients_match_jax(size, cond):
    j_model, params, t_model = build_pair(size, cond)
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 1)).astype(np.float32)
    t = np.array([3, 777], np.int32)
    ct = rng.normal(size=(2, size, size, 1)).astype(np.float32)
    y = Y if cond else None
    jy = None if y is None else jnp.asarray(y)

    def loss(p):
        out = j_model.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jy, False)
        return jnp.vdot(out, jnp.asarray(ct)), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = t_model(torch.from_numpy(x), torch.from_numpy(t),
                  None if y is None else torch.from_numpy(y))
    (out * torch.from_numpy(ct)).sum().backward()
    assert np.mean(np.asarray(want) ** 2) > 1e-8, "the output must be non-trivial"
    assert rel_mse(out.detach().numpy(), want) < RTOL_MSE

    want_g = UNetDiffuser.state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {k: p.grad.numpy() for k, p in t_model.named_parameters()}
    assert set(got_g) == set(want_g)
    flat_got = np.concatenate([got_g[k].ravel() for k in sorted(want_g)])
    flat_want = np.concatenate([np.asarray(want_g[k]).ravel() for k in sorted(want_g)])
    assert rel_mse(flat_got, flat_want) < RTOL_MSE
    total = np.linalg.norm(flat_want)
    for k, w in want_g.items():
        if np.linalg.norm(w) >= 1e-3 * total:
            assert rel_mse(got_g[k], w) < RTOL_MSE, k


def test_ignored_kwargs_give_jax_tree_and_dims3_raises():
    """The adapter's fixed architecture ignores its other kwargs, in both
    packages: the trees (and so the state_dicts) are those of the
    defaults."""
    ignored = dict(model_channels=64, channel_mult=(1, 2, 4, 8), attention_resolutions=(16, 8),
                   num_heads=4, num_heads_upsample=2, use_scale_shift_norm=True,
                   resblock_updown=True, use_new_attention_order=True, dropout=0.1,
                   conv_resample=False, out_channels=3)
    base = dict(data_shape=(16, 16), in_channels=1, num_res_blocks=1)
    init = [jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,), jnp.int32)]
    shapes = [jax.tree_util.tree_map(lambda a: a.shape,
                                     JaxUNetDiffuser(**base, **kw).init(jax.random.PRNGKey(0),
                                                                        *init)["params"])
              for kw in ({}, ignored)]
    assert shapes[0] == shapes[1]
    want = {k: v.shape for k, v in UNetDiffuser.state_dict_from_jax(
        jax.tree_util.tree_map(np.zeros, shapes[0], is_leaf=lambda s: isinstance(s, tuple))
    ).items()}
    for kw in ({}, ignored):
        got = {k: v.shape for k, v in UNetDiffuser(**base, **kw).state_dict().items()}
        assert got == want
    assert shapes[0]["model"]["conv_out"]["kernel"] == (3, 3, 32, 1)
    # heads of attention_head_dim channels at every site (64 channels at ds 2 and 4)
    for head_dim, heads in ((8, {8}), (16, {4})):
        model = UNetDiffuser(**base, attention_head_dim=head_dim)
        assert {m.heads for m in model.modules() if isinstance(m, AttentionBlock)} == heads
    with pytest.raises(AssertionError, match="2D-only"):
        UNetDiffuser(data_shape=(8, 8, 8), in_channels=1, dims=3)
    with pytest.raises(AssertionError, match="2D-only"):
        JaxUNetDiffuser(data_shape=(8, 8, 8), in_channels=1, dims=3).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 8, 1)), jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("t,bh", [(512, 2), (1024, 1)], ids=["T512", "T1024"])
def test_flash_at_head_dim_8_matches_jax_interpret(t, bh):
    """Head dim 8 (UNet_Diffuser's), padded to the kernels' 16: forward
    within 2e-5 and dq, dk, dv within 5e-5 of JAX's Pallas kernels in
    interpret mode (block_k 128: the online-softmax kernel over several
    K/V blocks, as at T 4096)."""
    assert padded_head_dim(8) == 16
    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(size=(1, t, bh, 8)).astype(np.float32) for _ in range(3))
    want = jax_flash_attention(q, k, v, 128, 128, True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-5)

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash_attention(q, k, v, 128, 128, True)))

    grads = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    torch.sin(out).sum().backward()
    for got, w in zip(leaves, grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-5)
