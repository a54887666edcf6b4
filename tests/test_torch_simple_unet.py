"""The port's SimpleUNet ("UNet") against the JAX package's, on the CPU.

The same seeded inputs go through ``rho_diffusion_tpu.models.SimpleUNet`` and
``rho_diffusion_tpu_torch.models.SimpleUNet``, the JAX parameters carried
across by name (``SimpleUNet.state_dict_from_jax``):

* the forward and one MSE loss's gradients in 1-D, 2-D and 3-D (the up
  path's stride-1 'SAME' ``ConvTranspose`` included), relative MSE < 1e-9;
* the ``ConvTranspose`` alone: flax's at stride 1 'SAME' with
  ``transpose_kernel=False`` is a correlation with the stored kernel, not
  flipped, padded as ``lax.conv_transpose`` pads (odd and even kernels);
* the model in a DDPM pipeline: its training step and ``reverse_process``
  run, and classifier-free guidance and ``cond_dropout`` raise;
* int8: the port quantises the convs JAX's ``conv_nd`` quantises (its
  ``ConvTranspose`` and Dense layers stay float), counted site by site
  against the JAX modules a forward calls.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import Int8Sites
from rho_diffusion_tpu.models import SimpleUNet as JaxSimpleUNet
from rho_diffusion_tpu.ops import quant as jax_quant
from rho_diffusion_tpu_torch.diffusion import DDPM, GaussianDiffusionPipeline, LinearSchedule
from rho_diffusion_tpu_torch.models import SimpleUNet
from rho_diffusion_tpu_torch.models.unet_simple import ConvTransposeSame
from rho_diffusion_tpu_torch.ops.quant import MIN_QUANT_CHANNELS, conv_quant

CASES = {
    "1d": (dict(block_type="UNetBlock2d", dims=1), (16,)),
    "2d": (dict(block_type="UNetBlock2d"), (8, 8)),
    "3d": (dict(block_type="UNetBlock3d"), (8, 8, 8)),
}
WIDTHS = dict(input_channels=1, down_channels=(8, 16, 32), up_channels=(32, 16, 8),
              time_embedding_dim=16)


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def both(case: str, widths=WIDTHS, seed=0):
    kw, spatial = CASES[case]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *spatial, 1)).astype(np.float32)
    t = np.array([1, 2])
    jm = JaxSimpleUNet(**widths, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t))["params"])
    pm = SimpleUNet(**widths, **kw)
    pm.load_state_dict(tensors(SimpleUNet.state_dict_from_jax(params)))
    return jm, params, pm, x, t


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    jm, params, pm, x, t = both(case)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.shape == want.shape == x.shape
    assert rel_mse(got, want) < 1e-9
    # every block runs at full resolution and the up path has its ConvTranspose
    assert isinstance(pm.up_0.conv2, ConvTransposeSame)
    assert pm.down_0.norm.num_groups == 8 and pm.up_1.norm.num_groups == 8


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax_grad(case):
    jm, params, pm, x, t = both(case)
    target = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((out - jnp.asarray(target)) ** 2)

    want = SimpleUNet.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)))
    out = pm(torch.from_numpy(x), torch.from_numpy(t))
    torch.mean((out - torch.from_numpy(target)) ** 2).backward()
    got = {k: p.grad.numpy() for k, p in pm.named_parameters()}
    assert set(got) == set(want)
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    assert num / den < 1e-9


@pytest.mark.parametrize("dims,k", [(1, 2), (2, 3), (2, 4), (3, 3)])
def test_stride1_same_conv_transpose_is_an_unflipped_correlation(dims, k):
    """flax's ConvTranspose at stride 1 'SAME' with transpose_kernel=False
    against the port's ConvTransposeSame on the same stored kernel; the
    kernel flipped in space gives another output, and even kernels take
    lax.conv_transpose's padding (ceil((k-1)/2) before), not a SAME conv's."""
    rng = np.random.default_rng(dims * 10 + k)
    x = rng.normal(size=(2, *(7,) * dims, 3)).astype(np.float32)
    jm = fnn.ConvTranspose(5, (k,) * dims, padding="SAME")
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = ConvTransposeSame(dims, 3, 5, k)
    kernel = params["kernel"]
    spatial = tuple(range(dims))
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(kernel, (dims + 1, dims, *spatial)))))
        pm.bias.copy_(torch.from_numpy(params["bias"]))
        got = pm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        assert rel_mse(got, want) < 1e-9
        pm.weight.copy_(torch.flip(pm.weight, dims=[2 + i for i in range(dims)]))
        flipped = pm(torch.from_numpy(x)).numpy()
    assert rel_mse(flipped, want) > 1e-3


def pipeline(cls=DDPM, **kw):
    extra = ({"model_mean_type": "epsilon", "model_var_type": "fixed_large"}
             if cls is GaussianDiffusionPipeline else {})
    return cls(backbone="UNet", backbone_kwargs=dict(WIDTHS, block_type="UNetBlock3d"),
               schedule=LinearSchedule(21), optimizer="AdamW", device="cpu", **extra, **kw)


def test_pipeline_trains_and_samples_with_the_shape_given():
    pipe = pipeline(ema_decay=0.99)
    state = pipe.create_state(seed=3)
    data = torch.rand((2, 8, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = pipe.training_step(state, {"data": data, "labels": None})
    assert np.isfinite(float(metrics["train_loss"])) and state.step == 1
    assert any(not torch.equal(v, before[k]) for k, v in state.model.state_dict().items())
    out = pipe.reverse_process((2, 8, 8, 8, 1), None,
                               generator=torch.Generator().manual_seed(1))["denoised"]
    assert out.shape == (2, 8, 8, 8, 1) and torch.isfinite(out).all()


@pytest.mark.parametrize("cls", [DDPM, GaussianDiffusionPipeline], ids=["ddpm", "gaussian"])
def test_cfg_and_cond_dropout_raise(cls):
    """The SimpleUNet takes no cond_mask: cond_dropout > 0 raises at
    construction and guided sampling raises, with JAX's message
    (tests/pipeline/test_cfg.py)."""
    with pytest.raises(ValueError, match="cond_mask"):
        pipeline(cls, cond_dropout=0.1)
    with pytest.raises(ValueError, match="cond_dropout must be"):
        pipeline(cls, cond_dropout=1.5)
    pipe = pipeline(cls)
    assert not pipe.backbone_supports_cond_mask()
    with pytest.raises(ValueError, match="cond_mask"):
        pipe.reverse_process((2, 8, 8, 8, 1), torch.zeros((2, 4)), guidance_scale=2.0,
                             generator=torch.Generator().manual_seed(0))


class JaxSites:
    """The JAX modules one forward calls, by class name (flax's method
    interceptor), with the input channels of each."""

    def __init__(self):
        self.calls: list[tuple[str, int, int]] = []

    def __call__(self, next_fun, args, kwargs, context):
        if context.method_name == "__call__" and args and hasattr(args[0], "shape"):
            m = context.module
            feats = getattr(m, "features", None)
            self.calls.append((type(m).__name__, int(args[0].shape[-1]), feats))
        return next_fun(*args, **kwargs)


def test_int8_quantises_the_convs_jax_quantises():
    """Under int8, JAX's conv_nd builds ConvInt8 (the input conv, Cin 1,
    stays float inside it) and the up path's nn.ConvTranspose and every
    nn.Dense stay float; the port's conv sites are the same, each int8 or
    float as in JAX, and its ConvTranspose and Linear layers stay float."""
    widths = dict(input_channels=1, down_channels=(16, 32, 48), up_channels=(48, 32, 16),
                  time_embedding_dim=16)
    jm, params, pm, x, t = both("3d", widths)
    rec = JaxSites()
    jax_quant.set_conv_quant("int8")
    try:
        with fnn.intercept_methods(rec):
            want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    finally:
        jax_quant.set_conv_quant("off")
    jax_convs = [(cin, f) for name, cin, f in rec.calls if name == "ConvInt8"]
    jax_int8 = [c for c in jax_convs if min(c) >= MIN_QUANT_CHANNELS]
    assert {name for name, _, _ in rec.calls} >= {"ConvInt8", "ConvTranspose", "Dense"}
    assert not any(name == "DenseInt8" for name, _, _ in rec.calls)
    with Int8Sites() as sites, conv_quant("int8"), torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    port = sorted((c["x"][-1], c["cout"]) for c in sites.calls)
    assert all(c["site"] == "conv" for c in sites.calls)
    assert port == sorted(jax_convs)
    assert sorted((c["x"][-1], c["cout"]) for c in sites.calls
                  if c["route"] != "float") == sorted(jax_int8)
    # 2 down blocks x 3 convs and 2 up blocks x 2 (conv2 is the ConvTranspose), + input conv
    assert len(port) == 11 and len(jax_int8) == 10
    # the same int8 arithmetic: rounding ties may flip a quantum, nothing more
    assert rel_mse(got, want) < 1e-6
