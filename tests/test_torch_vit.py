"""The port's VisionTransformer against the JAX package's, on the CPU.

The same seeded inputs go through ``rho_diffusion_tpu.models.VisionTransformer``
and ``rho_diffusion_tpu_torch.models.VisionTransformer``, the JAX parameters
carried across by ``VisionTransformer.state_dict_from_jax``:

* the forward in 1-D, 2-D and 3-D at the JAX package's test shapes
  (tests/models/test_vit_and_simple_unet.py), unconditional, and
  conditional through ``class_embed`` (integer labels), ``cond_proj``
  (precomputed 2-D rows) and FourierConditioning (raw parameter rows);
* one MSE loss's parameter gradients against ``jax.grad``;
* the output ``ConvTranspose``'s kernel is flipped in space on the way in
  (an unflipped copy misses);
* a JAX trainer's ``model.npz`` of a tiny ViT config through the port's
  inference session (JAX's forward) and its CLI; the training CLI on the same
  config; int8 leaves the ViT float, as in JAX.

fp32 throughout; the bar is the roadmap's relative MSE < 1e-9 (forwards),
and the same over all gradients together.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Int8Sites
from rho_diffusion_tpu.config import ExperimentConfig as JaxConfig
from rho_diffusion_tpu.models import VisionTransformer as JaxViT
from rho_diffusion_tpu.models.conditioning import FourierConditioning as JaxFourier
from rho_diffusion_tpu.ops import quant as jax_quant
from rho_diffusion_tpu.training.checkpoint import save_model_weights as jax_save_weights
from rho_diffusion_tpu.training.trainer import build_pipeline_from_config as jax_build
from rho_diffusion_tpu_torch import inference
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.models import FourierConditioning, VisionTransformer
from rho_diffusion_tpu_torch.ops.quant import conv_quant
from rho_diffusion_tpu_torch.training.__main__ import main as train_main

ROOT = Path(__file__).resolve().parents[1]
SPACE = {"l": [0, 1, 2, 3, 4], "m": [-4, -3, -2, -1, 0, 1, 2, 3, 4]}
SMALL = dict(patch_size=4, num_channels=1, embedding_dim=32, hidden_dim=64, activation="GELU",
             transformer_depth=2, num_heads=4, dropout=0.0)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def both(shapes, y=None, cond_kw=None, seed=0, **kw):
    """(JAX module, numpy params, port module with those params, x, t).
    flax makes ``class_embed`` only for integer labels at init; the port
    builds it whenever there is no ``cond_fn``, so that one weight keeps the
    port's own init when JAX's tree lacks it."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *shapes, 1)).astype(np.float32)
    t = np.array([0, 3])
    jkw, pkw = dict(SMALL, input_shapes=shapes, **kw), dict(SMALL, input_shapes=shapes, **kw)
    if cond_kw is not None:
        jkw["cond_fn"] = JaxFourier(**cond_kw)
        pkw["cond_fn"] = FourierConditioning(**cond_kw)
    jm = JaxViT(**jkw)
    jy = None if y is None else jnp.asarray(y)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t), jy)["params"])
    pm = VisionTransformer(**pkw)
    loaded = pm.load_state_dict(tensors(VisionTransformer.state_dict_from_jax(params)),
                                strict=False)
    assert not loaded.unexpected_keys
    unused = [] if "class_embed" in params or not hasattr(pm, "class_embed") else [
        "class_embed.weight"]
    assert loaded.missing_keys == unused
    return jm, params, pm, x, t
    return jm, params, pm, x, t


def forwards(jm, params, pm, x, t, y=None):
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                    None if y is None else jnp.asarray(y))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t),
                 None if y is None else torch.from_numpy(np.asarray(y)))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("shapes", [(16,), (8, 8), (8, 8, 8)], ids=["1d", "2d", "3d"])
def test_forward_matches_jax(shapes):
    got, want = forwards(*both(shapes))
    assert got.shape == want.shape == (2, *shapes, 1)
    assert rel_mse(got, want) < 1e-9


def class_rows(n=2):
    return np.array([3, 17][:n])


def precomputed_rows(n=2, width=SMALL["embedding_dim"]):
    return np.random.default_rng(7).normal(size=(n, width)).astype(np.float32)


def raw_rows():
    return np.array([[1.0, -2.0], [4.0, 3.0]], np.float32)


CONDITIONAL = {
    "class_embed": (class_rows(), {}),
    "cond_proj": (precomputed_rows(), {}),
    "fourier": (raw_rows(), {"parameter_space": SPACE, "embedding_dim": 48}),
}


@pytest.mark.parametrize("shapes", [(16,), (8, 8), (8, 8, 8)], ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("seam", list(CONDITIONAL))
def test_conditional_forward_matches_jax(shapes, seam):
    """The three seams: integer labels through class_embed, precomputed rows
    straight to cond_proj (at the width the port fixes, embedding_dim, which
    JAX reads from y at init), raw rows through FourierConditioning."""
    y, cond_kw = CONDITIONAL[seam]
    jm, params, pm, x, t = both(shapes, y=y, cond_kw=cond_kw or None, num_classes=20)
    got, want = forwards(jm, params, pm, x, t, y)
    assert rel_mse(got, want) < 1e-9
    # the condition moves the output
    other, _ = forwards(jm, params, pm, x, t, y[::-1].copy())
    assert np.abs(other - got).max() > 1e-4
    assert ("class_embed" in params) == (seam == "class_embed")
    assert hasattr(pm, "class_embed") == (seam != "fourier")


def test_precomputed_rows_of_another_width_raise():
    _, _, pm, x, t = both((16,), y=precomputed_rows(), num_classes=20)
    with pytest.raises(ValueError, match="width 24; .* takes 32, the model's embedding_dim"):
        pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(precomputed_rows(width=24)))


@pytest.mark.parametrize("shapes", [(16,), (8, 8, 8)], ids=["1d", "3d"])
def test_gradients_match_jax_grad(shapes):
    """One MSE loss's gradients: the port's autograd (the flash Function's
    plain backward on the CPU) against jax.grad, carried by the same map."""
    y = raw_rows()
    jm, params, pm, x, t = both(shapes, y=y, cond_kw={"parameter_space": SPACE,
                                                      "embedding_dim": 32}, num_classes=20)
    target = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    want = VisionTransformer.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    out = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    torch.mean((out - torch.from_numpy(target)) ** 2).backward()
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert num / den < 1e-9
    assert all(np.abs(want[k]).max() > 0 for k in want)


def test_output_conv_kernel_is_flipped():
    """flax's ConvTranspose (transpose_kernel=False) at stride = patch reads
    its kernel reversed in space against conv_transpose: the carrier flips
    it, and the unflipped kernel gives another output."""
    jm, params, pm, x, t = both((8, 8))
    got, want = forwards(jm, params, pm, x, t)
    assert rel_mse(got, want) < 1e-9
    k = params["output_conv"]["kernel"]  # [p, p, hidden, C]
    unflipped = np.transpose(k, (2, 3, 0, 1))
    assert not np.array_equal(unflipped, pm.output_conv.weight.detach().numpy())
    with torch.no_grad():
        pm.output_conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(unflipped)))
        wrong = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert rel_mse(wrong, want) > 1e-3


def vit_config(tmp_path: Path, **model_over) -> Path:
    """The flagship config with a tiny FourierConditioning ViT (8^3 fields)."""
    cfg = json.loads((ROOT / "examples" / "config_spherical_harmonics.json").read_text())
    cfg["model"] = {"name": "VisionTransformer", "kwargs": {
        "patch_size": 4, "input_shapes": [8, 8, 8], "num_channels": 1, "embedding_dim": 32,
        "hidden_dim": 64, "transformer_depth": 2, "num_heads": 4, "dropout": 0.0,
        "num_classes": 20, "cond_fn": "FourierConditioning", **model_over}}
    cfg["dataset"]["kwargs"].update(use_emb_as_labels=False, length=16, grid_el=8)
    cfg["noise_schedule"]["kwargs"]["num_steps"] = 21
    cfg["training"].update(batch_size=8, max_epochs=1, save_checkpoint_every_n_epochs=1,
                           log_every_n_steps=1, loggers=["jsonl"], dtype="float32")
    cfg["inference"].update(cache_file=None, plot_output_file=None, checkpoint=None,
                            num_samples=2)
    path = tmp_path / "vit.json"
    path.write_text(json.dumps(cfg))
    return path


def test_jax_model_npz_through_the_inference_cli(tmp_path):
    """A ViT config's JAX pipeline (FourierConditioning over the dataset's
    parameter space, 256 wide from the trainer's 4 x model_channels rule)
    writes its model.npz; the port's inference session reads it through the
    config's model's carrier and gives JAX's forward, and its CLI samples."""
    from rho_diffusion_tpu.data import SphericalHarmonicDataset as JaxSH

    path = vit_config(tmp_path)
    jcfg = JaxConfig.from_json(path)
    jpipe = jax_build(jcfg, dataset=JaxSH(**jcfg.dataset.kwargs))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 8, 8, 8, 1)).astype(np.float32)
    t = np.array([4, 19])
    y = raw_rows()
    params = jpipe.backbone.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t),
                                 jnp.asarray(y))["params"]
    npz = tmp_path / "model.npz"
    jax_save_weights(params, npz)
    want = np.asarray(jpipe.backbone.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                           jnp.asarray(y)))
    config = ExperimentConfig.from_json(path)
    pipe, _, messages = inference.build_inference_session(config, checkpoint=str(npz),
                                                          work_dir=tmp_path, device="cpu")
    assert any("loaded weights" in m for m in messages), messages
    assert pipe.backbone.cond_fn.embedding_dim == 256
    got = pipe.apply(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)).numpy()
    assert rel_mse(got, want) < 1e-9
    samples = inference.main([str(path), "-p", str(npz), "-d", "cpu", "-n", "2",
                              "--work-dir", str(tmp_path)])
    assert samples.shape == (2, 8, 8, 8, 1) and np.isfinite(samples).all()


def test_training_cli_trains_and_the_inference_cli_samples_its_checkpoint(tmp_path):
    path = vit_config(tmp_path)
    work = tmp_path / "run"
    state = train_main([str(path), "-d", "cpu", "--work-dir", str(work), "--no-resume"])
    assert state.step == 2
    assert (work / "checkpoints" / "step_2.pt").is_file() and (work / "model.pth").is_file()
    samples = inference.main([str(path), "-d", "cpu", "-n", "2", "--work-dir", str(work)])
    assert samples.shape == (2, 8, 8, 8, 1) and np.isfinite(samples).all()
    # the port's own .pth of a ViT reads back by -p
    again = inference.main([str(path), "-p", str(work / "model.pth"), "-d", "cpu", "-n", "2",
                            "--work-dir", str(tmp_path / "elsewhere")])
    assert np.isfinite(again).all()


def test_int8_leaves_the_vit_float():
    """JAX's int8 mode hooks conv_nd and the UNet's Dense sites; the ViT's
    patch conv, Dense layers and ConvTranspose are flax's own, so its int8
    forward is its float forward, in both packages."""
    jm, params, pm, x, t = both((8, 8, 8))
    float_out, want = forwards(jm, params, pm, x, t)
    jax_quant.set_conv_quant("int8")
    try:
        want_int8 = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    finally:
        jax_quant.set_conv_quant("off")
    with Int8Sites() as rec, conv_quant("int8"):
        got, _ = forwards(jm, params, pm, x, t)
    assert rec.calls == []
    np.testing.assert_array_equal(got, float_out)
    np.testing.assert_array_equal(want_int8, want)


@pytest.mark.parametrize("pipeline", ["DDPM", "GaussianDiffusionPipeline"])
def test_cfg_and_cond_dropout_raise(pipeline):
    """The ViT takes no cond_mask: cond_dropout > 0 raises at construction
    and classifier-free guidance raises when sampling, with JAX's message
    (tests/pipeline/test_cfg.py), though the model is class-conditional."""
    from rho_diffusion_tpu_torch.diffusion import DDPM, GaussianDiffusionPipeline, LinearSchedule

    cls = {"DDPM": DDPM, "GaussianDiffusionPipeline": GaussianDiffusionPipeline}[pipeline]
    kw = dict(backbone="VisionTransformer",
              backbone_kwargs=dict(SMALL, input_shapes=(8, 8, 8), num_classes=20),
              schedule=LinearSchedule(21), device="cpu")
    with pytest.raises(ValueError, match="cond_mask"):
        cls(**kw, cond_dropout=0.2)
    pipe = cls(**kw)
    assert not pipe.backbone_supports_cond_mask()
    with pytest.raises(ValueError, match="guidance_scale=3.0 requires a backbone"):
        pipe.reverse_process((2, 8, 8, 8, 1), torch.tensor([1, 2]), guidance_scale=3.0,
                             generator=torch.Generator().manual_seed(0))
    # unguided, the class-conditional ViT samples
    out = pipe.reverse_process((2, 8, 8, 8, 1), torch.tensor([1, 2]),
                               generator=torch.Generator().manual_seed(0))
    out = out["denoised"] if isinstance(out, dict) else out
    assert torch.isfinite(out).all()
