"""The port's ``DiffusersDDPMPipeline`` against the JAX package's, on the CPU.

* For every ``beta_schedule`` (linear, scaled_linear, squaredcos_cap_v2,
  sigmoid), with and without ``rescale_betas_zero_snr``, the coefficient
  tables equal JAX's bitwise (both built in float64 on the host); an
  explicit beta range and ``num_train_timesteps`` too.
* Every JAX error and warning: unknown prediction and variance types, the
  zero-SNR rescale of a ready schedule, the cosine schedule's ignored
  range, epsilon prediction on a zero-terminal-SNR table; the variance
  names' map, ``clip_sample``, the gradient clip of 1.0 and T left to an
  injected schedule's length.
* ``training_losses`` for epsilon, sample and v_prediction (per sample,
  through a UNet_Diffuser at 16x16 with the same seeded weights), the
  pipeline's ``loss_and_metrics`` with JAX's draws patched, and a
  trailing-spacing DDIM sample at zero-SNR under v_prediction from the same
  x_T: relative MSE < 1e-9.
* A config that names the pipeline builds through
  ``build_pipeline_from_config`` and trains a step.
"""
import json
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rho_diffusion_tpu.diffusion import schedule as jax_schedule
from rho_diffusion_tpu.diffusion.diffusers_compat import DiffusersDDPMPipeline as JaxPipeline
from rho_diffusion_tpu.diffusion import gaussian as jg
from rho_diffusion_tpu.models.unet_diffusers_compat import UNetDiffuser as JaxUNetDiffuser
from rho_diffusion_tpu_torch.config import ExperimentConfig
from rho_diffusion_tpu_torch.diffusion import gaussian as tg
from rho_diffusion_tpu_torch.diffusion import schedule
from rho_diffusion_tpu_torch.diffusion.diffusers_compat import DiffusersDDPMPipeline
from rho_diffusion_tpu_torch.models.unet_diffusers_compat import UNetDiffuser
from rho_diffusion_tpu_torch.training.trainer import build_pipeline_from_config

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
KW = dict(data_shape=[16, 16], in_channels=1, num_res_blocks=1)
SHAPE = (2, 16, 16, 1)
T = 100
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
          "fixed_large_variance", "fixed_large_log_variance", "timestep_map")
SCHEDULES = ["linear", "scaled_linear", "squaredcos_cap_v2", "sigmoid"]


def rel_mse(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.mean((got - want) ** 2) / np.mean(want ** 2))


def pair(**kwargs):
    """(port pipeline, JAX pipeline, JAX params) over a UNet_Diffuser with
    the same seeded weights."""
    tpipe = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", **kwargs)
    jpipe = JaxPipeline("UNet_Diffuser", dict(KW), **kwargs)
    params = jax.jit(JaxUNetDiffuser(**KW).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32), params)
    tpipe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           UNetDiffuser.state_dict_from_jax(params).items()})
    return tpipe, jpipe, params


@pytest.mark.parametrize("zero_snr", [False, True], ids=["plain", "zero-snr"])
@pytest.mark.parametrize("name", SCHEDULES)
def test_tables_equal_jax(name, zero_snr):
    mean = "v_prediction" if zero_snr else "epsilon"
    kw = dict(beta_schedule=name, rescale_betas_zero_snr=zero_snr, prediction_type=mean,
              num_train_timesteps=T)
    tpipe = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", **kw)
    jpipe = JaxPipeline("UNet_Diffuser", dict(KW), **kw)
    assert tpipe.timesteps == jpipe.timesteps == T
    for field in TABLES:
        np.testing.assert_array_equal(getattr(tpipe.coeffs, field).numpy(),
                                      np.asarray(getattr(jpipe.coeffs, field)), err_msg=field)
    assert tpipe._zero_terminal_snr == jpipe._zero_terminal_snr == zero_snr


@pytest.mark.parametrize("name", ["linear", "scaled_linear", "sigmoid"])
def test_explicit_beta_range_equals_jax(name):
    kw = dict(beta_schedule=name, beta_start=2e-4, beta_end=3e-2, timesteps=50)
    tpipe = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", **kw)
    jpipe = JaxPipeline("UNet_Diffuser", dict(KW), **kw)
    np.testing.assert_array_equal(tpipe.coeffs.betas.numpy(), np.asarray(jpipe.coeffs.betas))
    # HF's un-rescaled range, not the 1000/T-scaled guided-diffusion one
    if name != "sigmoid":
        assert float(tpipe.coeffs.betas[0]) == pytest.approx(2e-4)


def test_errors_and_warnings_are_jax():
    for make in (lambda **k: DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", **k),
                 lambda **k: JaxPipeline("UNet_Diffuser", dict(KW), **k)):
        with pytest.raises(ValueError, match="unknown prediction_type 'x0'; expected one of "
                                             r"\['epsilon', 'sample', 'v_prediction'\]"):
            make(prediction_type="x0", num_train_timesteps=T)
        with pytest.raises(ValueError, match="unknown variance_type 'wide'"):
            make(variance_type="wide", num_train_timesteps=T)
        with pytest.raises(ValueError, match="rescale_betas_zero_snr requires building"):
            make(schedule=schedule.LinearSchedule(T), rescale_betas_zero_snr=True)
        with pytest.warns(UserWarning, match="ignored by the 'squaredcos_cap_v2' schedule"):
            make(beta_start=1e-4, beta_end=2e-2, num_train_timesteps=T)
        with pytest.raises(ValueError, match="zero-terminal-SNR schedule"):
            make(rescale_betas_zero_snr=True, num_train_timesteps=T)


def test_error_with_a_jax_schedule():
    with pytest.raises(ValueError, match="rescale_betas_zero_snr requires building"):
        JaxPipeline("UNet_Diffuser", dict(KW), schedule=jax_schedule.LinearSchedule(T),
                    rescale_betas_zero_snr=True)


def test_defaults_and_maps_are_jax():
    """squaredcos_cap_v2 / epsilon / fixed_large by default; each variance
    name's type; clip_sample as clip_denoised; grad clip 1.0; T from an
    injected schedule."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpipe = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu")
    jpipe = JaxPipeline("UNet_Diffuser", dict(KW))
    assert tpipe.model_mean_type.value == jpipe.model_mean_type.value == "epsilon"
    assert tpipe.model_var_type.value == jpipe.model_var_type.value == "fixed_large"
    assert tpipe.loss_type.value == jpipe.loss_type.value == "mse"
    assert tpipe.timesteps == 1000 and tpipe.clip_denoised is True
    assert tpipe.optimizer.clip_grad_norm == 1.0
    for name, want in (("fixed_small_log", "fixed_small"), ("fixed_large_log", "fixed_large"),
                       ("learned", "learned"), ("learned_range", "learned_range")):
        p = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", variance_type=name,
                                  num_train_timesteps=T)
        j = JaxPipeline("UNet_Diffuser", dict(KW), variance_type=name, num_train_timesteps=T)
        assert p.model_var_type.value == j.model_var_type.value == want
    p = DiffusersDDPMPipeline("UNet_Diffuser", dict(KW), device="cpu", clip_sample=False,
                              schedule=schedule.LinearSchedule(37), clip_grad_norm=0.5)
    assert p.clip_denoised is False and p.timesteps == 37
    assert p.optimizer.clip_grad_norm == 0.5


@pytest.mark.parametrize("mean", ["epsilon", "sample", "v_prediction"])
def test_training_losses_match_jax(monkeypatch, mean):
    tpipe, jpipe, params = pair(prediction_type=mean, beta_schedule="linear",
                                num_train_timesteps=T, variance_type="fixed_small")
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-1, 1, size=SHAPE).astype(np.float32)
    noise = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([3, 87])
    tpipe.backbone.train()
    got = tg.training_losses(tpipe.coeffs, tpipe._train_model_fn(None), torch.from_numpy(x0),
                             torch.from_numpy(t), torch.from_numpy(noise), tpipe.model_mean_type,
                             tpipe.model_var_type, tpipe.loss_type)
    want = jg.training_losses(jpipe.coeffs, jpipe._model_fn(params, None), jnp.asarray(x0),
                              jnp.asarray(t), jnp.asarray(noise), jpipe.model_mean_type,
                              jpipe.model_var_type, jpipe.loss_type)
    assert rel_mse(got["loss"].detach().numpy(), want["loss"]) < 1e-9
    loss, metrics = tpipe.loss_and_metrics({"data": torch.from_numpy(x0), "labels": None},
                                           t=torch.from_numpy(t), noise=torch.from_numpy(noise))
    monkeypatch.setattr(jpipe, "random_timesteps", lambda r, b: jnp.asarray(t, jnp.int32))
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape, dtype=jnp.float32: jnp.asarray(noise, dtype))
    want_loss, want_metrics = jpipe.loss_and_metrics(params, {"data": jnp.asarray(x0)},
                                                     jax.random.PRNGKey(0))
    assert rel_mse(loss.detach().numpy(), want_loss) < 1e-9
    assert set(metrics) == set(want_metrics)


def test_trailing_ddim_sample_at_zero_snr_matches_jax():
    tpipe, jpipe, params = pair(prediction_type="v_prediction", beta_schedule="scaled_linear",
                                rescale_betas_zero_snr=True, num_train_timesteps=T,
                                variance_type="fixed_small")
    x_T = np.random.default_rng(3).normal(size=SHAPE).astype(np.float32)
    got = tpipe.reverse_process(SHAPE, sampler="ddim", num_steps=10, spacing="trailing",
                                x_T=torch.from_numpy(x_T))
    want = jpipe.reverse_process(params, jax.random.PRNGKey(0), SHAPE, sampler="ddim",
                                 num_steps=10, spacing="trailing", x_T=jnp.asarray(x_T))
    assert np.isfinite(got.numpy()).all()
    assert rel_mse(got.numpy(), want) < 1e-9
    # trailing is the zero-SNR default grid
    again = tpipe.reverse_process(SHAPE, sampler="ddim", num_steps=10, x_T=torch.from_numpy(x_T))
    assert torch.equal(again, got)


def test_config_built_pipeline_trains(tmp_path):
    cfg = json.loads((ROOT / "examples" / "config_smoke.json").read_text())
    cfg["model"] = {"name": "UNet_Diffuser", "kwargs": dict(KW)}
    cfg["pipeline"] = {"name": "DiffusersDDPMPipeline", "kwargs": {
        "prediction_type": "v_prediction", "variance_type": "fixed_small",
        "beta_schedule": "linear", "rescale_betas_zero_snr": True}}
    # the config's noise_schedule is a ready schedule: the zero-SNR rescale
    # is refused, as in JAX, and T is its length
    with pytest.raises(ValueError, match="rescale_betas_zero_snr requires building"):
        build_pipeline_from_config(ExperimentConfig.from_dict(cfg), device="cpu")
    cfg["pipeline"]["kwargs"].pop("rescale_betas_zero_snr")
    pipe = build_pipeline_from_config(ExperimentConfig.from_dict(cfg), device="cpu")
    assert isinstance(pipe, DiffusersDDPMPipeline) and isinstance(pipe.backbone, UNetDiffuser)
    assert pipe.timesteps == len(pipe.schedule) == cfg["noise_schedule"]["kwargs"]["num_steps"]
    state = pipe.create_state(0)
    metrics = pipe.training_step(state, {"data": torch.rand(SHAPE), "labels": None})
    assert state.step == 1 and np.isfinite(float(metrics["train_loss"]))
