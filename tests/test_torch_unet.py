"""The port's UNetv2 against the JAX package's, on the CPU in fp32.

JAX init -> perturbed params (no zero-init layer left at zero) -> the port's
converter -> ``load_state_dict(strict=True)`` -> the same inputs, made with
numpy, through both forwards. Bar: relative field MSE < 1e-9, the bar the JAX
package meets against the reference torch UNet.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.models.conditioning import MultiEmbeddings as JaxMultiEmbeddings
from rho_diffusion_tpu.models.unet import UNet as JaxUNet
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings
from rho_diffusion_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

RTOL_MSE = 1e-9


def rel_mse(got, want):
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def perturbed_params(module, inputs, seed=0):
    """JAX init, then every leaf shifted by small seeded noise so that the
    zero-init output convs and projections carry signal."""
    params = jax.jit(module.init)(jax.random.PRNGKey(seed), *inputs)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params,
    )


def build_pair(kwargs, space=None, y=None, seed=0):
    """(jax module, jax params, port module with the same weights)."""
    jkw = dict(kwargs)
    tkw = dict(kwargs)
    if space is not None:
        emb = kwargs["model_channels"] * 4
        jkw["cond_fn"] = JaxMultiEmbeddings(parameter_space=space, embedding_dim=emb)
        tkw["cond_fn"] = MultiEmbeddings(space, emb)
    j_model = JaxUNet(**jkw)
    shape = (1, *kwargs["data_shape"], kwargs["in_channels"])
    init_inputs = [jnp.zeros(shape), jnp.zeros((1,), jnp.int32)]
    if y is not None:
        init_inputs.append(jnp.asarray(y[:1]))
    params = perturbed_params(j_model, init_inputs, seed)
    sd = export_unet_state_dict(jax.tree_util.tree_map(np.asarray, params), **arch_kwargs(kwargs))
    t_model = UNet(**tkw)
    t_model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return j_model, params, t_model.eval()


def run_pair(j_model, params, t_model, x, t, y=None, cond_mask=None):
    jy = None if y is None else jnp.asarray(y)
    jm = None if cond_mask is None else jnp.asarray(cond_mask)
    apply = jax.jit(j_model.apply, static_argnums=(4,))
    want = np.asarray(apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jy, False,
                            cond_mask=jm))
    with torch.no_grad():
        got = t_model(
            torch.from_numpy(x), torch.from_numpy(t),
            None if y is None else torch.from_numpy(y),
            None if cond_mask is None else torch.from_numpy(cond_mask),
        ).numpy()
    assert got.shape == want.shape
    assert np.mean(want ** 2) > 1e-8, "output must be non-trivial"
    return got, want


def base_kwargs(dims, data_shape, **over):
    kw = dict(
        data_shape=data_shape, in_channels=1, out_channels=1, model_channels=32,
        num_res_blocks=1, attention_resolutions=[2], channel_mult=(1, 2), dims=dims,
        num_heads=2, use_scale_shift_norm=True,
    )
    kw.update(over)
    return kw


@pytest.mark.parametrize(
    "dims,data_shape", [(1, (16,)), (2, (8, 8)), (3, (4, 8, 8))], ids=["1d", "2d", "3d"],
)
def test_unet_forward_matches_jax(dims, data_shape):
    j_model, params, t_model = build_pair(base_kwargs(dims, data_shape))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *data_shape, 1)).astype(np.float32)
    t = np.array([3, 47], np.int32)
    got, want = run_pair(j_model, params, t_model, x, t)
    assert rel_mse(got, want) < RTOL_MSE


@pytest.mark.parametrize(
    "flags",
    [
        {"use_new_attention_order": True, "num_heads": 2},
        {"num_head_channels": 16},
        {"resblock_updown": True},
        {"use_scale_shift_norm": False},
        {"conv_resample": False},
        {"num_heads": 2, "num_heads_upsample": 4},
    ],
    ids=["new-attn-order", "head-channels", "resblock-updown",
         "additive-emb", "pool-resample", "heads-upsample"],
)
def test_unet_flag_variants_match_jax(flags):
    j_model, params, t_model = build_pair(base_kwargs(2, (8, 8), **flags))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    t = np.array([5, 20], np.int32)
    got, want = run_pair(j_model, params, t_model, x, t)
    assert rel_mse(got, want) < RTOL_MSE


def test_unet_hash_embedding_path_matches_jax():
    """The flagship's conditioning: y [B, 256] sha512 rows added straight
    onto the time embedding of an mc-64 model."""
    kw = base_kwargs(3, (4, 8, 8), model_channels=64, num_classes=20, num_heads=4)
    rng = np.random.default_rng(3)
    y = rng.uniform(0.3, 0.9, size=(2, 256)).astype(np.float32)
    j_model, params, t_model = build_pair(kw, y=y)
    x = rng.normal(size=(2, 4, 8, 8, 1)).astype(np.float32)
    t = np.array([999, 0], np.int32)
    got, want = run_pair(j_model, params, t_model, x, t, y)
    assert rel_mse(got, want) < RTOL_MSE


@pytest.mark.parametrize("masked", [False, True], ids=["rows", "cond-mask"])
def test_unet_multi_embeddings_path_matches_jax(masked):
    """Raw parameter rows through MultiEmbeddings; with ``cond_mask`` the
    masked row gets the null condition (classifier-free guidance)."""
    space = {"l": [0, 1, 2], "m": [-1, 0, 1]}
    y = np.array([[0.0, -1.0], [2.0, 1.0]], np.float32)
    kw = base_kwargs(2, (8, 8), num_classes=9)
    j_model, params, t_model = build_pair(kw, space=space, y=y)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 1)).astype(np.float32)
    t = np.array([7, 300], np.int32)
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    got, want = run_pair(j_model, params, t_model, x, t, y, mask)
    assert rel_mse(got, want) < RTOL_MSE
