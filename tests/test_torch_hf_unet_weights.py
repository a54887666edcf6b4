"""The port's HuggingFace ``UNet2DModel`` transplant against the JAX package's.

The diffusers package is not installed, so a UNet2DModel-layout state_dict
comes from the torch mirror of the reference's pinned architecture in
``tests/parity/test_hf_unet_transplant.py`` (block channels (32, 64, 64),
attention heads of 8, diffusers' key names and forward):

* the port's ``transplant_hf_unet2d_state_dict`` equals JAX's leaf for
  leaf, bitwise, in both diffusers namings and with the adapter's
  ``model.`` prefix and ``cond_fn`` tables;
* the port's ``UNet_Diffuser`` on the transplanted weights matches the
  mirror's forward at that file's bar (MSE < 1e-9), with and without the
  identity class embedding;
* the strict leftover, a missing weight and a state_dict without
  ``down_blocks`` raise with JAX's messages;
* ``load_weights_auto`` on such a ``.pth`` loads it into UNet_Diffuser with
  the model's ``attention_head_dim`` (8, and 16 on a mirror of heads of 16),
  and raises under UNetv2; the adapter's checkpoint with its MultiEmbeddings
  tables loads into a UNet_Diffuser that conditions through them.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.interop import transplant_hf_unet2d_state_dict as jax_transplant
from rho_diffusion_tpu_torch.interop.hf_unet_weights import (
    load_hf_unet2d_checkpoint,
    transplant_hf_unet2d_state_dict,
)
from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings
from rho_diffusion_tpu_torch.models.unet import UNet
from rho_diffusion_tpu_torch.models.unet_diffusers_compat import UNetDiffuser
from rho_diffusion_tpu_torch.training.checkpoint import load_weights_auto

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TEMB = 128


def _mirror_module():
    spec = importlib.util.spec_from_file_location(
        "hf_unet_mirror", ROOT / "tests" / "parity" / "test_hf_unet_transplant.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MIRROR = _mirror_module()


def hf_mirror(seed: int = 0, head_dim: int = 8):
    """The mirror of UNet2DModel((32, 64, 64), layers_per_block=2) with
    seeded weights and heads of ``head_dim`` channels, in eval mode."""
    torch.manual_seed(seed)
    mirror = MIRROR.HFUNet2DMirror().eval()
    for m in mirror.modules():
        if isinstance(m, MIRROR.Attn):
            m.heads = m.to_q.weight.shape[0] // head_dim
    return mirror


def inputs(batch: int = 2, size: int = 16, seed: int = 1):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, 1, size, size), generator=gen),
            torch.tensor([3, 777][:batch]))


def port_forward(params: dict, x, t, y=None, size: int = 16, **kw):
    model = UNetDiffuser(data_shape=(size, size), in_channels=1, num_res_blocks=2, **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in UNetDiffuser.state_dict_from_jax(params).items()})
    with torch.no_grad():
        return model.eval()(x.permute(0, 2, 3, 1), t, y).permute(0, 3, 1, 2)


def assert_trees_bitwise(got: dict, want: dict) -> None:
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    want_flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_flat] == [p for p, _ in want_flat]
    for (path, a), (_, b) in zip(got_flat, want_flat):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


def legacy_names(sd: dict) -> dict:
    return {(k.replace(".to_q.", ".query.").replace(".to_k.", ".key.")
             .replace(".to_v.", ".value.").replace(".to_out.0.", ".proj_attn.")): v
            for k, v in sd.items()}


@pytest.mark.parametrize("naming", ["modern", "legacy"])
def test_transplant_bitwise_against_jax(naming):
    sd = hf_mirror().state_dict()
    if naming == "legacy":
        sd = legacy_names(sd)
    assert_trees_bitwise(transplant_hf_unet2d_state_dict(sd), jax_transplant(sd))


def test_legacy_naming_maps_as_the_modern_one():
    sd = hf_mirror().state_dict()
    assert_trees_bitwise(transplant_hf_unet2d_state_dict(legacy_names(sd)),
                         transplant_hf_unet2d_state_dict(sd))


@pytest.mark.parametrize("size", [16, 32])
def test_forward_matches_the_mirror(size):
    mirror = hf_mirror()
    x, t = inputs(size=size)
    with torch.no_grad():
        want = mirror(x, t)
    got = port_forward(transplant_hf_unet2d_state_dict(mirror.state_dict()), x, t, size=size)
    mse = float(torch.mean((got - want) ** 2))
    assert mse < 1e-9, f"field MSE {mse} against the HF-layout mirror"


def test_adapter_prefix_and_cond_fn():
    """The reference adapter's own state_dict (``model.*`` and its
    MultiEmbeddings ``cond_fn.*``): both land, bitwise JAX's, and the
    identity class embedding adds the rows onto the time embedding."""
    mirror = hf_mirror()
    x, t = inputs()
    sd = {f"model.{k}": v for k, v in mirror.state_dict().items()}
    table = torch.randn(5, TEMB, generator=torch.Generator().manual_seed(4))
    sd["cond_fn.embedding_layers.mass.weight"] = table
    params = transplant_hf_unet2d_state_dict(sd)
    assert_trees_bitwise(params, jax_transplant(sd))
    np.testing.assert_array_equal(params["model"]["cond_fn"]["embedding_mass"]["embedding"],
                                  table.numpy())
    cond = table[2][None].repeat(2, 1)
    with torch.no_grad():
        want = mirror(x, t, class_emb=cond)
    tree = {"model": {k: v for k, v in params["model"].items() if k != "cond_fn"}}
    got = port_forward(tree, x, t, cond, num_classes=5)
    assert float(torch.mean((got - want) ** 2)) < 1e-9


def test_strict_leftover_missing_and_no_down_blocks():
    sd = dict(hf_mirror().state_dict())
    bad = {**sd, "unexpected.weight": torch.zeros(3)}
    for fn in (transplant_hf_unet2d_state_dict, jax_transplant):
        with pytest.raises(ValueError, match=r"unconsumed HF weights: \['unexpected.weight'\]"):
            fn(bad)
    assert "time_dense_0" in transplant_hf_unet2d_state_dict(bad, strict=False)["model"]
    missing = dict(sd)
    del missing["mid_block.resnets.0.conv1.weight"]
    with pytest.raises(KeyError, match="missing reference weight "
                                       "'mid_block.resnets.0.conv1.weight'"):
        transplant_hf_unet2d_state_dict(missing)
    with pytest.raises(ValueError, match="no down_blocks"):
        transplant_hf_unet2d_state_dict({"foo.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="not divisible by attention_head_dim 24"):
        transplant_hf_unet2d_state_dict(sd, attention_head_dim=24)


@pytest.mark.parametrize("head_dim", [8, 16])
def test_load_weights_auto_of_a_unet2d_pth(tmp_path, head_dim):
    """A UNet2DModel ``.pth`` through ``load_weights_auto`` (as ``-p``
    reads it) with the model kwargs' ``attention_head_dim``: the loaded
    model's forward is the mirror's; under UNetv2 it raises."""
    mirror = hf_mirror(seed=7, head_dim=head_dim)
    path = tmp_path / "unet2d.pth"
    torch.save(mirror.state_dict(), path)
    kw = {"data_shape": [16, 16], "in_channels": 1, "num_res_blocks": 2}
    if head_dim != 8:
        kw["attention_head_dim"] = head_dim
    model = UNetDiffuser(**kw)
    model.load_state_dict(load_weights_auto(model, path, kw, "UNet_Diffuser"))
    x, t = inputs(seed=8)
    with torch.no_grad():
        want = mirror(x, t)
        got = model.eval()(x.permute(0, 2, 3, 1), t).permute(0, 3, 1, 2)
    assert float(torch.mean((got - want) ** 2)) < 1e-9
    assert_trees_bitwise(load_hf_unet2d_checkpoint(path, attention_head_dim=head_dim),
                         jax_transplant(mirror.state_dict(), attention_head_dim=head_dim))
    unet_kw = {"data_shape": [16, 16], "in_channels": 1, "out_channels": 1,
               "model_channels": 32, "num_res_blocks": 2, "dims": 2, "channel_mult": [1, 2]}
    with pytest.raises(ValueError, match="UNet2DModel checkpoint.*UNet_Diffuser"):
        load_weights_auto(UNet(**unet_kw), path, unet_kw, "UNetv2")


def test_adapter_checkpoint_loads_into_multi_embeddings(tmp_path):
    """The reference adapter's checkpoint with its MultiEmbeddings tables
    (``cond_fn.embedding_layers.*``) through ``load_weights_auto`` into a
    UNet_Diffuser that conditions through MultiEmbeddings: the raw rows'
    embeddings reach the model as the mirror's identity class embedding.
    (The JAX package's own tree keeps such a cond_fn beside ``model`` while
    its transplant puts the tables inside; the port takes both.)"""
    mirror = hf_mirror(seed=9)
    space = {"mass": [0.5, 1.0, 2.0, 4.0, 8.0]}
    table = torch.randn(5, TEMB, generator=torch.Generator().manual_seed(10))
    sd = {f"model.{k}": v for k, v in mirror.state_dict().items()}
    sd["cond_fn.embedding_layers.mass.weight"] = table
    path = tmp_path / "adapter.pth"
    torch.save(sd, path)
    kw = {"data_shape": [16, 16], "in_channels": 1, "num_res_blocks": 2, "num_classes": 5}
    model = UNetDiffuser(**kw, cond_fn=MultiEmbeddings(space, TEMB))
    model.load_state_dict(load_weights_auto(model, path, kw, "UNet_Diffuser"))
    x, t = inputs(seed=11)
    rows = torch.tensor([[2.0], [8.0]])
    with torch.no_grad():
        want = mirror(x, t, class_emb=table[[2, 4]])
        got = model.eval()(x.permute(0, 2, 3, 1), t, rows).permute(0, 3, 1, 2)
    assert float(torch.mean((got - want) ** 2)) < 1e-9
    # the JAX tree's place for the tables, beside "model", carries the same
    params = transplant_hf_unet2d_state_dict(sd)
    beside = {"model": {k: v for k, v in params["model"].items() if k != "cond_fn"},
              "cond_fn": params["model"]["cond_fn"]}
    a, b = (UNetDiffuser.state_dict_from_jax(p) for p in (params, beside))
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
