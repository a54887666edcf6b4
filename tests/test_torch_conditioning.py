"""The port's conditioning modules, norms and classifier guidance against the
JAX package's, on the CPU.

* ``FourierConditioning`` (raw parameter rows, in and out of their range),
  ``RMSNorm``, and the flax-semantics ``LayerNorm`` and ``FlaxGroupNorm`` the
  ViT and the SimpleUNet use, relative MSE < 1e-9 in fp32 (bf16 inputs: the
  same fp32 arithmetic, cast back; within one bf16 rounding);
* ``classifier_grad_fn`` against ``jax.grad`` on a toy classifier, under
  ``torch.no_grad`` as the sampler calls it, touching no parameter's
  gradient; ``ClassifierGuidance`` builds the same hook, is not an
  embedding, and the pipelines refuse it as a model's ``cond_fn``;
* a classifier-guided sample (DDIM through ``condition_score``, DDPM through
  ``condition_mean``) against JAX's, the UNet's weights shared and x_T and
  every step's noise injected into both (tests/test_torch_gaussian_sampling.py's
  fixtures), mirroring tests/pipeline/test_gaussian_pipeline.py;
* the registries: the port has every JAX name but ``UNet_Diffuser``.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import rho_diffusion_tpu
import rho_diffusion_tpu.data  # noqa: F401  (fills the JAX registry)
import rho_diffusion_tpu.diffusion  # noqa: F401
import rho_diffusion_tpu.models  # noqa: F401
import rho_diffusion_tpu.training  # noqa: F401
import rho_diffusion_tpu.training.loggers  # noqa: F401
import rho_diffusion_tpu_torch
from rho_diffusion_tpu.models.conditioning import ClassifierGuidance as JaxClassifierGuidance
from rho_diffusion_tpu.models.conditioning import FourierConditioning as JaxFourier
from rho_diffusion_tpu.models.conditioning import classifier_grad_fn as jax_classifier_grad_fn
from rho_diffusion_tpu.ops.norm import RMSNorm as JaxRMSNorm
from rho_diffusion_tpu.registry import registry as jax_registry
from rho_diffusion_tpu_torch.diffusion import DDPM, LinearSchedule
from rho_diffusion_tpu_torch.models import (
    ClassifierGuidance,
    FourierConditioning,
    SimpleUNet,
    UNetBlock,
    UNetDiffuser,
    VisionTransformer,
    classifier_grad_fn,
)
from rho_diffusion_tpu_torch.ops.convolution import Linear
from rho_diffusion_tpu_torch.ops.norm import FlaxGroupNorm, LayerNorm, RMSNorm
from rho_diffusion_tpu_torch.registry import registry
from test_torch_gaussian_sampling import (  # noqa: F401  (the module-scoped fixture)
    SHAPE,
    STEPS,
    X_T,
    Injected,
    assert_close,
    conditions,
    pair,
)

SPACE = {"l": [0, 1, 2, 3, 4], "m": [-4, -3, -2, -1, 0, 1, 2, 3, 4]}


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def load_dense(layer: Linear, p: dict) -> None:
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.array(p["kernel"]).T))
        if layer.bias is not None:
            layer.bias.copy_(torch.from_numpy(np.array(p["bias"])))


@pytest.mark.parametrize("rows", ["inside", "outside"])
def test_fourier_conditioning_matches_jax(rows):
    """Each column min-max normalised by its admissible values, Fourier
    features at k = 1..6, Dense -> SiLU -> Dense; rows outside the range
    extrapolate in both."""
    y = np.array([[0, -4], [2, 1], [4, 4], [3, -1]], np.float32)
    if rows == "outside":
        y = y * 1.7 + 0.3
    jm = JaxFourier(parameter_space=SPACE, embedding_dim=32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                                        jnp.asarray(y))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(y)))
    pm = FourierConditioning(parameter_space=SPACE, embedding_dim=32)
    load_dense(pm.mlp_in, params["mlp_in"])
    load_dense(pm.mlp_out, params["mlp_out"])
    assert pm.mlp_in.in_features == 2 * 13
    with torch.no_grad():
        got = pm(torch.from_numpy(y)).numpy()
    assert rel_mse(got, want) < 1e-9
    # one column alone (a 1-D y) too
    space1 = {"l": SPACE["l"]}
    jm1 = JaxFourier(parameter_space=space1, embedding_dim=8)
    p1 = jax.tree_util.tree_map(np.asarray,
                                jm1.init(jax.random.PRNGKey(1), jnp.asarray(y[:, 0]))["params"])
    pm1 = FourierConditioning(parameter_space=space1, embedding_dim=8)
    load_dense(pm1.mlp_in, p1["mlp_in"])
    load_dense(pm1.mlp_out, p1["mlp_out"])
    with torch.no_grad():
        got1 = pm1(torch.from_numpy(y[:, 0])).numpy()
    assert rel_mse(got1, np.asarray(jm1.apply({"params": p1}, jnp.asarray(y[:, 0])))) < 1e-9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(3, 5, 24)).astype(np.float32) * 3.0
    scale = 1.0 + 0.1 * np.random.default_rng(1).normal(size=24).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(JaxRMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jx)
                      .astype(jnp.float32))
    pm = RMSNorm(24)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(scale))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        out = pm(tx)
    assert out.dtype == tx.dtype
    got = out.float().numpy()
    if dtype == "float32":
        assert rel_mse(got, want) < 1e-9
    else:  # the same fp32 arithmetic, one bf16 rounding of its result
        np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)
    assert pm.eps == 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_and_group_norms_match_flax(dtype):
    """flax's LayerNorm(dtype=float32) and GroupNorm(num_groups): eps 1e-6,
    the fast variance, fp32 statistics; torch's defaults (eps 1e-5, the
    two-pass variance) miss by more."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 6, 6, 16)) * 2.0 + 0.5).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    scale = (1.0 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    ln = LayerNorm(16)
    for jm, pm in ((fnn.LayerNorm(dtype=jnp.float32), ln),
                   (fnn.GroupNorm(num_groups=8, dtype=jnp.float32), FlaxGroupNorm(16, 8))):
        want = np.asarray(jm.apply({"params": params}, jx))
        with torch.no_grad():
            pm.weight.copy_(torch.from_numpy(scale))
            pm.bias.copy_(torch.from_numpy(bias))
            got = pm(tx)
        assert got.dtype == torch.float32
        assert rel_mse(got.numpy(), want) < 1e-9, type(pm).__name__
    # at a small variance eps decides: torch's default misses flax's there
    small = x * 0.003
    torch_default = F.layer_norm(torch.from_numpy(small), (16,), torch.from_numpy(scale),
                                 torch.from_numpy(bias)).numpy()
    want = np.asarray(fnn.LayerNorm(dtype=jnp.float32).apply({"params": params},
                                                             jnp.asarray(small)))
    with torch.no_grad():
        assert rel_mse(ln(torch.from_numpy(small)).numpy(), want) < 1e-9
    assert rel_mse(torch_default, want) > 1e-6
    with pytest.raises(ValueError, match="groups"):
        FlaxGroupNorm(12, 8)


class JaxToy(fnn.Module):
    """tests/pipeline/test_gaussian_pipeline.py's toy classifier."""

    num_classes: int = 3

    @fnn.compact
    def __call__(self, x, t):
        h = x.reshape(x.shape[0], -1)
        h = fnn.Dense(16)(h)
        h = fnn.silu(h + fnn.Dense(16)(t[:, None].astype(jnp.float32)))
        return fnn.Dense(self.num_classes)(h)


class PortToy(torch.nn.Module):
    def __init__(self, params: dict, features: int) -> None:
        super().__init__()
        self.d0, self.d1, self.d2 = Linear(features, 16), Linear(1, 16), Linear(16, 3)
        for i, layer in enumerate((self.d0, self.d1, self.d2)):
            load_dense(layer, params[f"Dense_{i}"])

    def forward(self, x, t):
        h = self.d0(x.reshape(x.shape[0], -1))
        return self.d2(F.silu(h + self.d1(t[:, None].float())))


def toys(shape):
    clf = JaxToy()
    cparams = jax.tree_util.tree_map(
        np.asarray, clf.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                             jnp.zeros((shape[0],), jnp.int32))["params"])
    port = PortToy(cparams, int(np.prod(shape[1:])))
    return (lambda x, t: clf.apply({"params": cparams}, x, t)), port


def test_classifier_grad_fn_matches_jax_grad():
    shape = (2, 8, 8, 1)
    jax_apply, port = toys(shape)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    t = np.array([3, 11])
    y = np.array([0, 2])
    want = np.asarray(jax_classifier_grad_fn(jax_apply, jnp.asarray(y), 5.0)(
        jnp.asarray(x), jnp.asarray(t)))
    fn = classifier_grad_fn(port, torch.from_numpy(y), scale=5.0)
    with torch.no_grad():  # as the sampler calls it
        got = fn(torch.from_numpy(x), torch.from_numpy(t))
    assert not got.requires_grad
    assert all(p.grad is None for p in port.parameters())
    assert rel_mse(got.numpy(), want) < 1e-9
    # the module-level hook builds the same grad_fn; it is no embedding
    module = ClassifierGuidance(classifier=port, guidance_scale=5.0)
    with torch.no_grad():
        again = module.grad_fn(torch.from_numpy(y))(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    with pytest.raises(NotImplementedError, match="grad_fn"):
        module(torch.from_numpy(y))
    with pytest.raises(NotImplementedError):
        JaxClassifierGuidance().apply({}, jnp.asarray(y))
    with pytest.raises(ValueError, match="ClassifierGuidance"):
        DDPM(backbone="UNetv2", backbone_kwargs={}, schedule=LinearSchedule(21),
             cond_fn="ClassifierGuidance", device="cpu")


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_classifier_guided_sample_matches_jax(pair, monkeypatch, sampler):  # noqa: F811
    """DDIM (condition_score) and ancestral DDPM (condition_mean), respaced,
    with a toy classifier's guidance at scale 5 on both sides and the noise
    injected: the same sample; guidance moves it."""
    tpipe, jpipe, params = pair
    jax_apply, port = toys(SHAPE)
    y = np.array([0, 2])
    c = conditions()
    opts = dict(sampler=sampler, num_steps=STEPS)

    def run(guided: bool):
        port_fn = classifier_grad_fn(port, torch.from_numpy(y), 5.0) if guided else None
        jax_fn = jax_classifier_grad_fn(jax_apply, jnp.asarray(y), 5.0) if guided else None
        with monkeypatch.context() as m:
            Injected(m, SHAPE)
            got = tpipe.reverse_process(SHAPE, torch.from_numpy(c), cond_grad_fn=port_fn,
                                        generator=torch.Generator().manual_seed(0), **opts)
            with jax.disable_jit():
                want = jpipe.reverse_process(params, jnp.asarray(0, jnp.int32), SHAPE,
                                             jnp.asarray(c), cond_grad_fn=jax_fn, **opts)
        return got, want

    got, want = run(True)
    assert_close(got, want)
    plain, _ = run(False)
    assert np.abs(plain.numpy() - got.numpy()).max() > 1e-3
    assert all(p.grad is None for p in tpipe.backbone.parameters())


def test_registry_has_every_jax_name_but_the_diffusers_backbone():
    """JAX's registry, filled by its packages, against the port's: no name
    is missing now that UNet_Diffuser (ROADMAP Queue 1 item 9b) is ported;
    the names resolve to the port's modules."""
    assert rho_diffusion_tpu and rho_diffusion_tpu_torch
    missing = {(cat, name) for cat, table in jax_registry.mapping.items() for name in table
               if (cat, name) not in registry}
    assert missing == set()
    assert registry.get("models", "UNet_Diffuser") is UNetDiffuser
    assert registry.get("models", "VisionTransformer") is VisionTransformer
    assert registry.get("models", "UNet") is SimpleUNet
    assert registry.get("models", "UNetv2") is rho_diffusion_tpu_torch.UNet
    assert registry.get("layers", "UNetBlock2d") is registry.get("layers", "UNetBlock3d") \
        is UNetBlock
    assert registry.get("layers", "FourierConditioning") is FourierConditioning
    assert registry.get("layers", "ClassifierGuidance") is ClassifierGuidance
