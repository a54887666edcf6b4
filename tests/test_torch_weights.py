"""The port's weight carry-over against the JAX package's own mapping.

``rho_diffusion_tpu_torch.interop.jax_weights.export_unet_state_dict`` is the
port's copy of the JAX package's ``export_unet_state_dict``; both must give
the same keys and bit-identical arrays, and the JAX package's ``.npz`` weight
files must load into the port's UNet with ``strict=True``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.interop.torch_weights import (
    export_unet_state_dict as jax_export_unet_state_dict,
)
from rho_diffusion_tpu.models.conditioning import MultiEmbeddings as JaxMultiEmbeddings
from rho_diffusion_tpu.models.unet import UNet as JaxUNet
from rho_diffusion_tpu.training.checkpoint import save_model_weights
from rho_diffusion_tpu_torch.interop.jax_weights import (
    arch_kwargs,
    export_unet_state_dict,
    load_jax_npz,
    load_state_dict_file,
)
from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings
from rho_diffusion_tpu_torch.models.unet import UNet

torch.set_num_threads(1)

SPACE = {"l": [0, 1, 2, 3, 4], "m": [-2, -1, 0, 1, 2]}

CASES = {
    "flagship-3d": dict(dims=3, data_shape=(4, 8, 8), model_channels=64, channel_mult=(1, 2),
                        attention_resolutions=[2], num_heads=4, num_classes=20,
                        use_scale_shift_norm=True, cond=True),
    "new-attn-order": dict(dims=2, data_shape=(8, 8), use_new_attention_order=True, num_heads=2),
    "head-channels": dict(dims=2, data_shape=(8, 8), num_head_channels=16),
    "resblock-updown": dict(dims=2, data_shape=(8, 8), resblock_updown=True),
    "pool-resample": dict(dims=1, data_shape=(16,), conv_resample=False),
    "heads-upsample": dict(dims=2, data_shape=(8, 8), num_heads=2, num_heads_upsample=4),
}


def model_kwargs(case):
    kw = dict(in_channels=1, out_channels=1, model_channels=32, num_res_blocks=1,
              attention_resolutions=[2], channel_mult=(1, 2))
    kw.update({k: v for k, v in CASES[case].items() if k != "cond"})
    return kw


def jax_params(case):
    kw = model_kwargs(case)
    y = None
    if CASES[case].get("cond"):
        kw["cond_fn"] = JaxMultiEmbeddings(parameter_space=SPACE,
                                           embedding_dim=4 * kw["model_channels"])
        y = jnp.asarray([[0.0, -2.0]])
    x = jnp.zeros((1, *kw["data_shape"], 1))
    params = jax.jit(JaxUNet(**kw).init)(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32), y)
    return jax.tree_util.tree_map(np.asarray, params["params"])


def torch_unet(case):
    kw = model_kwargs(case)
    if CASES[case].get("cond"):
        kw["cond_fn"] = MultiEmbeddings(SPACE, 4 * kw["model_channels"])
    return UNet(**kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_matches_jax_mapping_bit_for_bit(case):
    params = jax_params(case)
    arch = arch_kwargs(model_kwargs(case))
    want = jax_export_unet_state_dict(params, **arch)
    got = export_unet_state_dict(params, **arch)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and the port's UNet has exactly these parameters
    torch_unet(case).load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in got.items()},
                                     strict=True)


@pytest.mark.parametrize("case", ["flagship-3d", "new-attn-order"])
def test_jax_npz_loads_into_port_strict(case, tmp_path):
    params = jax_params(case)
    path = tmp_path / "model.npz"
    save_model_weights(params, path)
    nested = load_jax_npz(path)
    assert jax.tree_util.tree_structure(nested) == jax.tree_util.tree_structure(params)
    sd = load_state_dict_file(path, model_kwargs(case))
    model = torch_unet(case)
    model.load_state_dict(sd, strict=True)
    want = jax_export_unet_state_dict(params, **arch_kwargs(model_kwargs(case)))
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key], err_msg=key)


def test_reference_pth_loads_as_is(tmp_path):
    """A reference-layout model.pth is the port's native format."""
    model = torch_unet("head-channels")
    path = tmp_path / "model.pth"
    torch.save(model.state_dict(), path)
    sd = load_state_dict_file(path, model_kwargs("head-channels"))
    fresh = torch_unet("head-channels")
    fresh.load_state_dict(sd, strict=True)
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key


def test_npz_with_foreign_keys_is_rejected(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, **{"conv_in/kernel": np.zeros(3)})
    with pytest.raises(ValueError, match="keystr"):
        load_jax_npz(path)
