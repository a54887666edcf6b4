"""The port's training ops against the JAX package's, on the CPU.

* the flash-attention Function's backward (the plain version of the CUDA
  backward kernels, through the same autograd Function) against ``jax.grad``
  of the JAX package's Pallas flash attention in interpret mode, over a
  ragged T and a block_k that splits K/V;
* the conv3d Function's dx (the plain dgrad: the conv on flipped,
  IO-transposed weights), dw (the 27 tap matmuls) and db against ``jax.grad``
  of the JAX package's Pallas conv3d (interpret mode forced);
* the nine "nn" losses, PSNR, min-SNR weights and the EMA step;
* the DDPM loss and every gradient leaf of a small 3-D UNet (nonzero
  weights) against ``jax.value_and_grad`` of ``DDPM.loss_and_metrics``, with
  the timesteps and noise JAX drew handed to the port;
* all nine LR schedules against ``build_lr_schedule``, the DataLoader's index
  batches against the JAX DataLoader's.

Inputs are made with numpy from a seed; each tolerance is stated beside its
check.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from rho_diffusion_tpu.data.loader import DataLoader as JaxDataLoader
from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.ddpm import DDPM as JaxDDPM
from rho_diffusion_tpu.diffusion.gaussian import ModelMeanType as JaxModelMeanType
from rho_diffusion_tpu.diffusion.gaussian import min_snr_weight as jax_min_snr_weight
from rho_diffusion_tpu.metrics import losses as jax_losses
from rho_diffusion_tpu.ops.pallas.conv3d import conv3d as jax_conv3d
from rho_diffusion_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from rho_diffusion_tpu.training.ema import ema_update as jax_ema_update
from rho_diffusion_tpu.training.optimizers import build_lr_schedule as jax_build_lr_schedule
from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM
from rho_diffusion_tpu_torch.diffusion.gaussian import ModelMeanType, min_snr_weight
from rho_diffusion_tpu_torch.interop.jax_weights import arch_kwargs, export_unet_state_dict
from rho_diffusion_tpu_torch.metrics.losses import LOSSES, psnr
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d
from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention
from rho_diffusion_tpu_torch.training.ema import ema_update
from rho_diffusion_tpu_torch.training.optimizers import build_lr_schedule

torch.set_num_threads(1)


@pytest.mark.parametrize("block_k,t,d", [
    pytest.param(128, 200, 32, id="128"),
    pytest.param(None, 200, 32, id="None"),
    pytest.param(None, 512, 128, id="flagship-T512-D128"),
    pytest.param(None, 64, 16, id="vit-T64-D16"),
    pytest.param(None, 50, 16, id="vit-ragged-T50-D16"),
])
def test_flash_backward_matches_jax_grad(block_k, t, d):
    """T=200 pads to 256: with block_k=128 the JAX kernels sweep two K/V
    blocks, the second ragged; None takes one whole block. The flagship's
    attention width (T = 512, D = 128, 2 heads) is the one the fused
    backward kernel runs on the card; the ViT's (64 patches, head dim 16)
    and a ragged T = 50 are the small route's, one wgmma tile a batch*head.
    atol 5e-5, the JAX package's own flash-gradient tolerance
    (tests/ops/test_flash_attention.py), fp32 on both sides."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(1, t, 2, d)).astype(np.float32) for _ in range(3))

    def loss(q, k, v):
        return jnp.sum(jnp.sin(jax_flash_attention(q, k, v, 128, block_k, True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sin(flash_attention(*leaves)).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), atol=5e-5)


@pytest.mark.parametrize("cin,cout", [(1, 1), (1, 16), (8, 1), (8, 16)])
def test_conv3d_function_gradients_match_jax(cin, cout):
    """dx, dw and db of the port's conv Function (plain route) against
    jax.grad through the JAX package's conv3d custom VJP (Pallas forward
    and dgrad in interpret mode, XLA wgrad). Tolerance 2e-4 absolute and
    relative, as tests/ops/test_conv3d_pallas.py holds that VJP."""
    rng = np.random.default_rng(10 * cin + cout)
    x = rng.normal(size=(2, 4, 4, 4, cin)).astype(np.float32)
    kern = (0.1 * rng.normal(size=(3, 3, 3, cin, cout))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    ct = rng.normal(size=(2, 4, 4, 4, cout)).astype(np.float32)

    def loss(x, k, b):
        return jnp.vdot(jax_conv3d(x, k) + b, ct)

    with pltpu.force_tpu_interpret_mode():
        gx, gk, gb = jax.grad(loss, argnums=(0, 1, 2))(x, kern, bias)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(kern.transpose(4, 3, 0, 1, 2).copy()).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    (conv3d(tx, tw, tb) * torch.from_numpy(ct)).sum().backward()
    tol = dict(atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(tw.grad.permute(2, 3, 4, 1, 0).numpy(), np.asarray(gk), **tol)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **tol)


def test_conv3d_backward_skips_unneeded_gradients():
    """The UNet's input conv: x_t needs no gradient, so no dgrad runs."""
    x = torch.randn(1, 3, 3, 3, 1)
    w = torch.randn(4, 1, 3, 3, 3, requires_grad=True)
    conv3d(x, w).sum().backward()
    assert x.grad is None and w.grad is not None


def _loss_inputs(rng):
    pred = rng.normal(size=(6, 5)).astype(np.float32)
    target = rng.normal(size=(6, 5)).astype(np.float32)
    probs = np.exp(target) / np.exp(target).sum(-1, keepdims=True)
    logp = np.log(np.exp(pred) / np.exp(pred).sum(-1, keepdims=True)).astype(np.float32)
    classes = rng.integers(0, 5, size=(6,))
    unit = (1 / (1 + np.exp(-pred))).astype(np.float32)
    return {
        "MSELoss": (pred, target), "L1Loss": (pred, target),
        "HuberLoss": (2 * pred, target), "SmoothL1Loss": (2 * pred, target),
        "CrossEntropyLoss": (pred, classes), "NLLLoss": (logp, classes),
        "BCELoss": (unit, (target > 0).astype(np.float32)),
        "BCEWithLogitsLoss": (pred, (target > 0).astype(np.float32)),
        "KLDivLoss": (logp, probs.astype(np.float32)),
    }


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    """fp32 elementwise losses: 1e-6 relative (summation order only)."""
    pred, target = _loss_inputs(np.random.default_rng(3))[name]
    got = LOSSES[name](torch.from_numpy(pred), torch.from_numpy(np.asarray(target)))
    want = jax_losses.resolve_loss(name)(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if name == "CrossEntropyLoss":  # the class-probability form too
        probs = _loss_inputs(np.random.default_rng(3))["KLDivLoss"][1]
        np.testing.assert_allclose(
            float(LOSSES[name](torch.from_numpy(pred), torch.from_numpy(probs))),
            float(jax_losses.cross_entropy_loss(jnp.asarray(pred), jnp.asarray(probs))), rtol=1e-6)


def test_psnr_min_snr_and_ema_match_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(3, 4, 4, 1)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(float(psnr(torch.from_numpy(a), torch.from_numpy(b))),
                               float(jax_losses.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    abar = schedule.LinearSchedule(1000).alpha_bar_t
    t = np.array([0, 10, 500, 999])
    for mt, jmt in ((ModelMeanType.EPSILON, JaxModelMeanType.EPSILON),
                    (ModelMeanType.START_X, JaxModelMeanType.START_X),
                    (ModelMeanType.VELOCITY, JaxModelMeanType.VELOCITY)):
        np.testing.assert_allclose(
            min_snr_weight(abar, torch.from_numpy(t), mt).numpy(),
            np.asarray(jax_min_snr_weight(jnp.asarray(abar.numpy()), jnp.asarray(t), jmt)),
            rtol=1e-6)
    shadow, param = {"w": a}, {"w": b}
    for step in (0, 7, 5000):
        want = jax_ema_update({"w": jnp.asarray(a)}, {"w": jnp.asarray(b)}, jnp.asarray(step),
                              0.9999)
        got = {"w": torch.from_numpy(shadow["w"].copy())}
        ema_update(got, {"w": torch.from_numpy(param["w"])}, step, 0.9999)
        # one fp32 lerp against s - (1 - d)(s - p): an ulp or two
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), atol=1e-6)


SCHEDULES = {
    "CosineAnnealingLR": {"T_max": 3, "eta_min": 1e-5},
    "StepLR": {"step_size": 2, "gamma": 0.5},
    "ExponentialLR": {"gamma": 0.9},
    "LinearLR": {"start_factor": 0.25, "end_factor": 1.0, "total_iters": 2},
    "MultiStepLR": {"milestones": [1, 2, 2], "gamma": 0.5},
    "ConstantLR": {"factor": 0.5, "total_iters": 2},
    "PolynomialLR": {"total_iters": 3, "power": 2.0},
    "CosineAnnealingWarmRestarts": {"T_0": 1, "T_mult": 2, "eta_min": 1e-5},
    "OneCycleLR": {"max_lr": 1e-3, "epochs": 3},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedules_match_jax(name):
    """Every update count 0 .. 3*T_max*steps_per_epoch (past the cosine's
    end, where the JAX CosineAnnealingLR holds at eta_min): fp32 optax
    against float64 formulas, rtol 1e-5."""
    spe, kw = 5, SCHEDULES[name]
    got = build_lr_schedule(name, 1e-4, spe, kw)
    want = jax_build_lr_schedule(name, 1e-4, spe, kw)
    for count in range(3 * 3 * spe + 1):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, err_msg=str(count))


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.float32), np.asarray([i], np.float32)


@pytest.mark.parametrize("seed,epoch,start,drop_last", [
    (0, 0, 0, True), (777, 3, 2, True), (5, 1, 0, False), (5, 2, 3, False)])
def test_dataloader_batches_match_jax(seed, epoch, start, drop_last):
    ds = _Indexed(23)
    got_loader = DataLoader(ds, 5, seed=seed, drop_last=drop_last, num_workers=2)
    want_loader = JaxDataLoader(ds, 5, seed=seed, drop_last=drop_last, num_workers=2,
                                process_index=0, num_processes=1)
    assert len(got_loader) == len(want_loader)
    for loader in (got_loader, want_loader):
        loader.set_epoch(epoch)
    got = list(got_loader.iter_batches(start))
    want = list(want_loader.iter_batches(start))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            np.testing.assert_array_equal(g[key], w[key])


def test_prefetch_stops_its_thread_and_propagates_errors():
    """A consumer that stops early (the trainer on SIGTERM) leaves no
    producer thread behind; an error in the producer reaches the consumer."""
    # threads of earlier tests may end meanwhile: only a new thread counts
    before = set(threading.enumerate())
    batches = prefetch(iter(range(100)), size=2)
    assert [next(batches) for _ in range(3)] == [0, 1, 2]
    assert set(threading.enumerate()) - before  # the producer runs
    batches.close()
    assert not set(threading.enumerate()) - before

    def failing():
        yield 1
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(prefetch(failing()))


SMALL = dict(
    dims=3, data_shape=[4, 8, 8], in_channels=1, out_channels=1, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
    num_classes=20, use_scale_shift_norm=True,
)
SCHEDULE = dict(num_steps=50, beta_1=1e-4, beta_T=2e-2)


def perturbed_params(jpipe, seed=0):
    """The JAX initial weights plus N(0, 0.05^2): no zero-initialised layer,
    so every gradient upstream of one is nonzero."""
    params = jpipe.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)


def port_pipeline(kw, params, **kwargs):
    pipe = DDPM("UNetv2", kw, schedule.LinearSchedule(**SCHEDULE), device="cpu", **kwargs)
    sd = export_unet_state_dict(params, **arch_kwargs(kw))
    pipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return pipe


def jax_draws(rng, shape, timesteps):
    """t and noise as DDPM.forward_process draws them from ``rng``."""
    t_rng, n_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (shape[0],), 0, timesteps)
    return np.asarray(t), np.asarray(jax.random.normal(n_rng, shape, jnp.float32))


def rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("weighting", [None, "min_snr"])
def test_ddpm_loss_and_gradients_match_jax(weighting):
    """fp32 on both sides, sha512 condition embeddings. Loss to 1e-5
    relative; every gradient leaf to 1e-4 relative rms (the leaves' float
    sums run in other orders in the two frameworks: ~1e-6 seen)."""
    kw = dict(SMALL)
    jpipe = JaxDDPM("UNetv2", kw, jax_schedule.LinearSchedule(**SCHEDULE),
                    loss_weighting=weighting)
    params = perturbed_params(jpipe)
    rng = np.random.default_rng(7)
    batch = {"data": rng.uniform(0, 1, size=(3, 4, 8, 8, 1)).astype(np.float32),
             "labels": rng.uniform(0, 2, size=(3, 128)).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jpipe.loss_and_metrics(p, batch, key), has_aux=True))(params)
    t, noise = (np.array(a) for a in jax_draws(key, batch["data"].shape, 50))

    tpipe = port_pipeline(kw, params, loss_weighting=weighting)
    tpipe.backbone.train()
    got_loss, got_metrics = tpipe.loss_and_metrics(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_metrics["psnr"]), float(metrics["psnr"]), rtol=1e-5)
    want = export_unet_state_dict(jax.tree_util.tree_map(np.asarray, grads), **arch_kwargs(kw))
    got = dict(tpipe.backbone.named_parameters())
    assert set(got) == set(want)
    # A conv bias right before a GroupNorm of one channel per group has a
    # gradient that is zero in exact arithmetic; both sides carry rounding
    # noise there (about 1e-6 of the rms over all gradients), so each leaf's
    # bound adds 1e-5 of that rms to its 1e-4 relative rms.
    floor = 1e-5 * np.sqrt(np.mean(np.concatenate([w.ravel() for w in want.values()]) ** 2))
    large = 0
    for name, w in want.items():
        g = got[name].grad.numpy()
        w_rms = np.sqrt(np.mean(w ** 2))
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-4 * w_rms + floor, name
        large += w_rms > 1e2 * floor
    assert large >= 0.9 * len(want)  # nonzero weights: gradients reach the leaves
