"""Gaussian diffusion: coefficients, respacing, the sampling math, DDIM and
the solvers' loop, the VLB and training losses, bits-per-dim, DDIM encoding,
RePaint inpainting, and ``GaussianDiffusionPipeline``.

Port of ``rho_diffusion_tpu/diffusion/gaussian.py``:

* ``ModelMeanType``, ``ModelVarType`` and ``LossType`` (:57-84);
* ``GaussianCoefficients`` and ``coefficients_from_betas`` (:86-166): the
  tables are built in float64 on the host and stored as float32 tensors on
  the pipeline's device;
* the respacing grids ``space_timesteps{,_trailing,_lambda,_karras}`` and
  ``respace``/``respace_subset`` (:169-322). Respacing reads the float32
  ``alphas_cumprod`` back into float64, as JAX does, so the respaced betas
  agree to the last bit; ``timestep_map`` composes with an earlier
  respacing;
* the q/posterior/predict math, ``velocity_target``, ``dynamic_threshold``,
  ``p_mean_variance`` for every mean and variance type,
  ``condition_mean``/``condition_score``, ``p_sample_step``,
  ``ddim_sample_step`` and ``ddim_reverse_step`` (:329-552);
* ``encode_loop``, ``sample_loop`` and ``inpaint_loop`` (:555-828): JAX's
  ``lax.scan`` becomes a Python loop over the (respaced) steps;
* ``vb_terms_bpd``, ``training_losses``, ``min_snr_weight``, ``prior_bpd``
  and ``calc_bpd_loop`` (:835-1031);
* ``GaussianDiffusionPipeline`` (:1038-1411): construction, the model
  calls, ``loss_and_metrics``, ``reverse_process``, ``generate``,
  ``inpaint``, ``encode`` and ``calc_bpd``.

The model always sees original timesteps (``timestep_map[t]``) while the
tables are indexed with the respaced ``t``. Noise comes from one
``torch.Generator`` (batch-wide: x_T, then one draw per stochastic step),
or, given ``row_keys``, from per-row streams (``diffusion.sampling_rng``):
x_T at tag M (the respaced count), a DDPM or DDIM step at its respaced t,
a stochastic solver's step at its original timestep ``timestep_map[i]``,
the tags JAX uses. A DDIM step with eta = 0 multiplies its noise by zero,
so it draws none. Inpainting's draws are set out in ``inpaint_loop``.

Training calls the backbone directly (with autograd, in the mode the
caller set), not ``apply``, which is for sampling; the learned-variance
``vb`` term sees the mean half of the output detached, JAX's
``stop_gradient``.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, fields
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from rho_diffusion_tpu_torch.diffusion.base import (
    AbstractDiffusionPipeline,
    extract,
    normalize_batch,
)
from rho_diffusion_tpu_torch.diffusion.sampling_rng import keys_at_step, normal_like
from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule, named_beta_schedule
from rho_diffusion_tpu_torch.diffusion.solvers import build_solver, is_solver, solver_names
from rho_diffusion_tpu_torch.metrics.losses import discretized_gaussian_log_likelihood, normal_kl
from rho_diffusion_tpu_torch.ops.convolution import mean_flat

_LN2 = math.log(2.0)


class ModelMeanType(enum.Enum):
    PREVIOUS_X = "previous_x"
    START_X = "start_x"
    EPSILON = "epsilon"
    VELOCITY = "v_prediction"


class ModelVarType(enum.Enum):
    LEARNED = "learned"
    FIXED_SMALL = "fixed_small"
    FIXED_LARGE = "fixed_large"
    LEARNED_RANGE = "learned_range"


class LossType(enum.Enum):
    MSE = "mse"
    RESCALED_MSE = "rescaled_mse"
    KL = "kl"
    RESCALED_KL = "rescaled_kl"

    def is_vb(self) -> bool:
        return self in (LossType.KL, LossType.RESCALED_KL)


@dataclass(frozen=True)
class GaussianCoefficients:
    """The q/posterior tables, float32 tensors of shape [T] on one device,
    and ``timestep_map`` (int64): the original-process timestep each
    (possibly respaced) index maps to."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    alphas_cumprod_next: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    fixed_large_variance: torch.Tensor
    fixed_large_log_variance: torch.Tensor
    timestep_map: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    @property
    def device(self) -> torch.device:
        return self.betas.device

    def to(self, device) -> "GaussianCoefficients":
        return GaussianCoefficients(**{f.name: getattr(self, f.name).to(device)
                                       for f in fields(self)})


def _host64(table: torch.Tensor) -> np.ndarray:
    """A float32 table read back into float64 on the host."""
    return table.detach().cpu().numpy().astype(np.float64)


def coefficients_from_betas(betas, timestep_map=None, device=None) -> GaussianCoefficients:
    """Every table from a beta array, in float64, stored as float32."""
    betas = np.asarray(betas, dtype=np.float64)
    (T,) = betas.shape
    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.append(1.0, acp[:-1])
    acp_next = np.append(acp[1:], 0.0)
    posterior_variance = betas * (1.0 - acp_prev) / (1.0 - acp)
    # the posterior variance is 0 at t = 0, so its log borrows t = 1; a
    # one-step table has no t = 1 and borrows beta_0
    pv1 = posterior_variance[1] if T > 1 else betas[0]
    posterior_log_variance_clipped = np.log(np.append(pv1, posterior_variance[1:]))
    fixed_large = np.append(pv1, betas[1:])
    if timestep_map is None:
        timestep_map = np.arange(T)

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(np.float32))).to(device)

    # zero-terminal-SNR tables (alpha_bar_T == 0) have inf reciprocals there
    # by design; only EPSILON reads them at T-1, and the pipeline rejects it
    with np.errstate(divide="ignore"):
        recip = np.sqrt(1.0 / acp)
        recipm1 = np.sqrt(1.0 / acp - 1.0)
    return GaussianCoefficients(
        betas=f32(betas),
        alphas_cumprod=f32(acp),
        alphas_cumprod_prev=f32(acp_prev),
        alphas_cumprod_next=f32(acp_next),
        sqrt_alphas_cumprod=f32(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - acp)),
        sqrt_recip_alphas_cumprod=f32(recip),
        sqrt_recipm1_alphas_cumprod=f32(recipm1),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
        posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
        fixed_large_variance=f32(fixed_large),
        fixed_large_log_variance=f32(np.log(fixed_large)),
        timestep_map=torch.as_tensor(np.asarray(timestep_map, dtype=np.int64), device=device),
    )


def coefficients_from_schedule(schedule: NoiseSchedule, device=None) -> GaussianCoefficients:
    """The tables of a config's schedule, from its (float32) betas."""
    return coefficients_from_betas(_host64(schedule.beta_t), device=device)


def space_timesteps(num_timesteps: int, num_respaced: int) -> np.ndarray:
    """Evenly spaced original timesteps (guided-diffusion striding)."""
    if num_respaced >= num_timesteps:
        return np.arange(num_timesteps)
    frac = num_timesteps / num_respaced
    return np.round(np.arange(num_respaced) * frac).astype(np.int64)


def space_timesteps_trailing(num_timesteps: int, num_respaced: int) -> np.ndarray:
    """The trailing grid t_i = round((i+1) T/n) - 1, anchored at t = T-1
    and closed under halving (the grid progressive distillation trains on)."""
    if num_respaced >= num_timesteps:
        return np.arange(num_timesteps)
    frac = num_timesteps / num_respaced
    use = np.round(np.arange(1, num_respaced + 1) * frac).astype(np.int64) - 1
    if len(np.unique(use)) != num_respaced:
        raise ValueError(f"cannot stride {num_timesteps} timesteps to {num_respaced} distinct points")
    return use


def space_timesteps_lambda(coeffs: GaussianCoefficients, num_respaced: int) -> np.ndarray:
    """Timesteps whose log-SNRs are as nearly uniform as the grid allows
    (the spacing DPM-Solver++ is derived for)."""
    if num_respaced >= coeffs.num_timesteps:
        return np.arange(coeffs.num_timesteps)
    abar = _host64(coeffs.alphas_cumprod)
    if abar[-1] == 0.0:
        raise ValueError(
            "uniform-lambda spacing needs a finite terminal log-SNR; the "
            "zero-terminal-SNR table has lambda(T-1) = -inf — use "
            "'trailing' spacing there",
        )
    lam = 0.5 * np.log(abar / (1.0 - abar))
    return _snap_targets_unique(lam, np.linspace(lam[-1], lam[0], num_respaced))


def _snap_targets_unique(values: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Snap each target to its nearest timestep by ``values[t]``, spilling
    collisions greedily to the nearest free neighbour, so exactly
    ``len(targets)`` distinct steps come back."""
    dist = np.abs(values[None, :] - targets[:, None])
    taken = np.zeros(values.shape[0], bool)
    out = []
    for k in range(targets.shape[0]):
        cand = int(dist[k].argmin())
        offset = 1
        while taken[cand]:
            lo, hi = cand - offset, cand + offset
            if lo >= 0 and not taken[lo]:
                cand = lo
            elif hi < values.shape[0] and not taken[hi]:
                cand = hi
            else:
                offset += 1
        taken[cand] = True
        out.append(cand)
    return np.sort(np.asarray(out, np.int64))


def space_timesteps_karras(coeffs: GaussianCoefficients, num_respaced: int,
                           rho: float = 7.0) -> np.ndarray:
    """The Karras rho-grid of sigma = sqrt((1-abar)/abar), snapped to the
    table; it always holds the terminal step."""
    if num_respaced >= coeffs.num_timesteps:
        return np.arange(coeffs.num_timesteps)
    abar = _host64(coeffs.alphas_cumprod)
    if abar[-1] == 0.0:
        raise ValueError(
            "karras spacing needs a finite sigma_max; the zero-terminal-SNR "
            "table has sigma(T-1) = inf — use 'trailing' spacing there",
        )
    sigma = np.sqrt((1.0 - abar) / abar)
    inv = 1.0 / rho
    grid = np.linspace(sigma[-1] ** inv, sigma[0] ** inv, num_respaced) ** rho
    return _snap_targets_unique(sigma, grid)


def respace_subset(coeffs: GaussianCoefficients, use) -> GaussianCoefficients:
    """Coefficients over an ascending timestep subset: beta_i = 1 -
    abar(t_i)/abar(t_{i-1}), with ``timestep_map`` composed with the
    input's."""
    acp = _host64(coeffs.alphas_cumprod)
    use = np.asarray(use, np.int64)
    tmap = coeffs.timestep_map.cpu().numpy().astype(np.int64)
    last_acp = 1.0
    new_betas = []
    for t in use:
        new_betas.append(1.0 - acp[t] / last_acp)
        last_acp = acp[t]
    return coefficients_from_betas(np.asarray(new_betas), timestep_map=tmap[use],
                                   device=coeffs.device)


def respace(coeffs: GaussianCoefficients, num_respaced: int,
            spacing: str = "uniform-t") -> GaussianCoefficients:
    """Coefficients over ``num_respaced`` steps on the grid ``spacing``:
    'uniform-t', 'uniform-lambda', 'trailing' or 'karras'."""
    if spacing == "uniform-lambda":
        use = space_timesteps_lambda(coeffs, num_respaced)
    elif spacing == "uniform-t":
        use = space_timesteps(coeffs.num_timesteps, num_respaced)
    elif spacing == "trailing":
        use = space_timesteps_trailing(coeffs.num_timesteps, num_respaced)
    elif spacing == "karras":
        use = space_timesteps_karras(coeffs, num_respaced)
    else:
        raise ValueError(
            f"unknown spacing {spacing!r}; expected 'uniform-t', "
            f"'uniform-lambda', 'trailing' or 'karras'",
        )
    return respace_subset(coeffs, use)


# ---------------------------------------------------------------------------
# The sampling math
# ---------------------------------------------------------------------------

def q_mean_variance(c: GaussianCoefficients, x_start, t):
    mean = extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
    variance = extract(1.0 - c.alphas_cumprod, t, x_start.ndim)
    log_variance = extract(c.log_one_minus_alphas_cumprod, t, x_start.ndim)
    return mean, variance, log_variance


def q_sample(c: GaussianCoefficients, x_start, t, noise):
    return (extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * x_start
            + extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * noise)


def q_posterior_mean_variance(c: GaussianCoefficients, x_start, x_t, t):
    mean = (extract(c.posterior_mean_coef1, t, x_t.ndim) * x_start
            + extract(c.posterior_mean_coef2, t, x_t.ndim) * x_t)
    variance = extract(c.posterior_variance, t, x_t.ndim)
    log_variance = extract(c.posterior_log_variance_clipped, t, x_t.ndim)
    return mean, variance, log_variance


def predict_xstart_from_eps(c: GaussianCoefficients, x_t, t, eps):
    return (extract(c.sqrt_recip_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_recipm1_alphas_cumprod, t, x_t.ndim) * eps)


def predict_xstart_from_xprev(c: GaussianCoefficients, x_t, t, xprev):
    coef1 = extract(c.posterior_mean_coef1, t, x_t.ndim)
    coef2 = extract(c.posterior_mean_coef2, t, x_t.ndim)
    return xprev / coef1 - (coef2 / coef1) * x_t


def predict_xstart_from_v(c: GaussianCoefficients, x_t, t, v):
    """x0 = sqrt(abar) x_t - sqrt(1-abar) v."""
    return (extract(c.sqrt_alphas_cumprod, t, x_t.ndim) * x_t
            - extract(c.sqrt_one_minus_alphas_cumprod, t, x_t.ndim) * v)


def velocity_target(c: GaussianCoefficients, x_start, t, noise):
    """The v-prediction target v = sqrt(abar) eps - sqrt(1-abar) x0."""
    return (extract(c.sqrt_alphas_cumprod, t, x_start.ndim) * noise
            - extract(c.sqrt_one_minus_alphas_cumprod, t, x_start.ndim) * x_start)


def predict_eps_from_xstart(c: GaussianCoefficients, x_t, t, pred_xstart):
    """eps = (x_t - sqrt(abar) x0) / sqrt(1-abar): finite at abar = 0."""
    return ((x_t - extract(c.sqrt_alphas_cumprod, t, x_t.ndim) * pred_xstart)
            / extract(c.sqrt_one_minus_alphas_cumprod, t, x_t.ndim))


def dynamic_threshold(x: torch.Tensor, percentile: float = 0.9) -> torch.Tensor:
    """Clamp each sample to +/- its ``percentile`` abs-quantile s (linear
    interpolation, s >= 1) and divide by s."""
    flat = torch.abs(x.reshape(x.shape[0], -1))
    s = torch.quantile(flat, percentile, dim=-1, interpolation="linear")
    s = torch.clamp(s, min=1.0).reshape(s.shape[0], *((1,) * (x.ndim - 1)))
    return torch.maximum(torch.minimum(x, s), -s) / s


def p_mean_variance(
    c: GaussianCoefficients,
    model_fn: Callable,
    x: torch.Tensor,
    t: torch.Tensor,
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    clip_denoised: bool = True,
    denoised_fn: Optional[Callable] = None,
    thresholding_percentile: float = 0.9,
) -> dict:
    """Mean, variance and x0 prediction of p(x_{t-1} | x_t). ``t`` is the
    respaced index; the model gets ``timestep_map[t]``."""
    model_output = model_fn(x, c.timestep_map[t])

    C = x.shape[-1]
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        assert model_output.shape[-1] == 2 * C
        model_output, model_var_values = torch.split(model_output, C, dim=-1)
        if var_type == ModelVarType.LEARNED:
            model_log_variance = model_var_values
        else:
            min_log = extract(c.posterior_log_variance_clipped, t, x.ndim)
            max_log = torch.log(extract(c.betas, t, x.ndim))
            frac = (model_var_values + 1.0) / 2.0
            model_log_variance = frac * max_log + (1.0 - frac) * min_log
        model_variance = torch.exp(model_log_variance)
    elif var_type == ModelVarType.FIXED_LARGE:
        model_variance = extract(c.fixed_large_variance, t, x.ndim)
        model_log_variance = extract(c.fixed_large_log_variance, t, x.ndim)
    elif var_type == ModelVarType.FIXED_SMALL:
        model_variance = extract(c.posterior_variance, t, x.ndim)
        model_log_variance = extract(c.posterior_log_variance_clipped, t, x.ndim)
    else:
        raise NotImplementedError(var_type)

    def process_xstart(xs):
        if denoised_fn is not None:
            xs = denoised_fn(xs)
        if clip_denoised:
            xs = dynamic_threshold(xs, thresholding_percentile)
        return xs

    if mean_type == ModelMeanType.PREVIOUS_X:
        pred_xstart = process_xstart(predict_xstart_from_xprev(c, x, t, model_output))
        model_mean = model_output
    else:
        if mean_type == ModelMeanType.START_X:
            pred_xstart = process_xstart(model_output)
        elif mean_type == ModelMeanType.VELOCITY:
            pred_xstart = process_xstart(predict_xstart_from_v(c, x, t, model_output))
        else:
            pred_xstart = process_xstart(predict_xstart_from_eps(c, x, t, model_output))
        model_mean, _, _ = q_posterior_mean_variance(c, pred_xstart, x, t)
    return {"mean": model_mean, "variance": model_variance,
            "log_variance": model_log_variance, "pred_xstart": pred_xstart}


def condition_mean(c, grad_fn, out, x, t):
    """Sohl-Dickstein conditioning: mean + variance * grad log p(y|x)."""
    return out["mean"] + out["variance"] * grad_fn(x, c.timestep_map[t])


def condition_score(c, grad_fn, out, x, t):
    """Score conditioning (Song et al.): eps - sqrt(1-abar) grad."""
    alpha_bar = extract(c.alphas_cumprod, t, x.ndim)
    eps = predict_eps_from_xstart(c, x, t, out["pred_xstart"])
    eps = eps - torch.sqrt(1.0 - alpha_bar) * grad_fn(x, c.timestep_map[t])
    pred_xstart = predict_xstart_from_eps(c, x, t, eps)
    mean, _, _ = q_posterior_mean_variance(c, pred_xstart, x, t)
    return {**out, "pred_xstart": pred_xstart, "mean": mean}


def _nonzero(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """1 where t != 0: the last step adds no noise."""
    return (t != 0).to(x.dtype).reshape(-1, *((1,) * (x.ndim - 1)))


def p_sample_step(c, model_fn, x, t, noise, mean_type, var_type, clip_denoised=True,
                  cond_grad_fn=None, **kw):
    """One ancestral step with the given standard-normal ``noise``."""
    out = p_mean_variance(c, model_fn, x, t, mean_type, var_type,
                          clip_denoised=clip_denoised, **kw)
    if cond_grad_fn is not None:
        out["mean"] = condition_mean(c, cond_grad_fn, out, x, t)
    sample = out["mean"] + _nonzero(t, x) * torch.exp(0.5 * out["log_variance"]) * noise
    return sample, out["pred_xstart"]


def ddim_sample_step(c, model_fn, x, t, noise, mean_type, var_type, clip_denoised=True,
                     cond_grad_fn=None, eta=0.0, **kw):
    """One DDIM step (Song et al. eq. 12); ``noise`` may be None when
    eta = 0."""
    out = p_mean_variance(c, model_fn, x, t, mean_type, var_type,
                          clip_denoised=clip_denoised, **kw)
    if cond_grad_fn is not None:
        out = condition_score(c, cond_grad_fn, out, x, t)
    eps = predict_eps_from_xstart(c, x, t, out["pred_xstart"])
    alpha_bar = extract(c.alphas_cumprod, t, x.ndim)
    alpha_bar_prev = extract(c.alphas_cumprod_prev, t, x.ndim)
    sigma = (eta * torch.sqrt((1.0 - alpha_bar_prev) / (1.0 - alpha_bar))
             * torch.sqrt(1.0 - alpha_bar / alpha_bar_prev))
    mean_pred = (out["pred_xstart"] * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(torch.clamp(1.0 - alpha_bar_prev - sigma ** 2, min=0.0)) * eps)
    if noise is None:
        return mean_pred, out["pred_xstart"]
    return mean_pred + _nonzero(t, x) * sigma * noise, out["pred_xstart"]


def ddim_reverse_step(c, model_fn, x, t, mean_type, var_type, clip_denoised=True, **kw):
    """One deterministic DDIM reverse-ODE step x_t -> x_{t+1} (encoding)."""
    out = p_mean_variance(c, model_fn, x, t, mean_type, var_type,
                          clip_denoised=clip_denoised, **kw)
    eps = predict_eps_from_xstart(c, x, t, out["pred_xstart"])
    alpha_bar_next = extract(c.alphas_cumprod_next, t, x.ndim)
    sample = (out["pred_xstart"] * torch.sqrt(alpha_bar_next)
              + torch.sqrt(1.0 - alpha_bar_next) * eps)
    return sample, out["pred_xstart"]


@torch.no_grad()
def encode_loop(c: GaussianCoefficients, model_fn: Callable, x0: torch.Tensor,
                mean_type: ModelMeanType, var_type: ModelVarType,
                clip_denoised: bool = False) -> torch.Tensor:
    """Deterministic DDIM encoding x_0 -> x_T over the steps 0 .. M-1."""
    x = torch.as_tensor(x0, device=c.device)
    for t in range(c.num_timesteps):
        tt = torch.full((x.shape[0],), t, dtype=torch.int64, device=c.device)
        x, _ = ddim_reverse_step(c, model_fn, x, tt, mean_type, var_type,
                                 clip_denoised=clip_denoised)
    return x


class _Noise:
    """Standard-normal draws of one loop: batch-wide from a generator (the
    tags are ignored; the draws come in call order), or per row at nested
    tags (each folded into the row keys in turn)."""

    def __init__(self, shape, device, generator=None, row_keys=None):
        self.shape, self.device = tuple(shape), device
        self.row_keys = None if row_keys is None else list(row_keys)
        if self.row_keys is None and generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.generator = generator

    def draw(self, *tags: int) -> torch.Tensor:
        if self.row_keys is not None:
            keys = self.row_keys
            for tag in tags:
                keys = keys_at_step(keys, tag)
            return normal_like(keys, self.shape, self.device)
        return torch.randn(self.shape, generator=self.generator, device=self.device)


@torch.no_grad()
def sample_loop(
    c: GaussianCoefficients,
    model_fn: Callable,
    shape: Sequence[int],
    generator: Optional[torch.Generator],
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    sampler: str = "ddpm",
    eta: float = 0.0,
    clip_denoised: bool = True,
    cond_grad_fn: Optional[Callable] = None,
    x_T: Optional[torch.Tensor] = None,
    progressive: bool = False,
    t_checkpoints=None,
    thresholding_percentile: float = 0.9,
    row_keys: Optional[Sequence[int]] = None,
):
    """The whole reverse process over the respaced steps M-1 .. 0 with
    'ddpm' (ancestral), 'ddim' (eta > 0 adds noise) or a registered solver.

    Noise comes from ``generator`` or, given ``row_keys`` (one 64-bit key
    per row), from each row's own streams. Returns the final x;
    ``progressive=True`` also returns every step's x stacked [M, *shape];
    ``t_checkpoints`` (original timesteps, each snapped to the nearest one
    the trajectory visits) returns ``(x, frames[K, *shape])`` instead."""
    if sampler not in ("ddpm", "ddim") and not is_solver(sampler):
        raise ValueError(
            f"unknown sampler {sampler!r}; expected 'ddpm', 'ddim' or a "
            f"registered ODE solver ({', '.join(solver_names())})",
        )
    shape = tuple(shape)
    device = c.device
    noise = _Noise(shape, device, generator, row_keys)
    M = c.num_timesteps
    x = noise.draw(M) if x_T is None else torch.as_tensor(x_T, device=device,
                                                           dtype=torch.float32)
    kw = {"thresholding_percentile": thresholding_percentile}

    if t_checkpoints is not None and len(t_checkpoints) == 0:
        t_checkpoints = None
    if t_checkpoints is not None and progressive:
        raise ValueError(
            "progressive=True and t_checkpoints are mutually exclusive: "
            "progressive returns every frame; t_checkpoints a strided "
            "buffer. Pass one or the other.",
        )
    tmap = c.timestep_map.cpu().numpy()
    t_ckpt = buf = None
    if t_checkpoints is not None:
        tc = np.asarray(t_checkpoints, np.int64)
        t_ckpt = tmap[np.abs(tmap[None, :] - tc[:, None]).argmin(axis=1)]
        buf = torch.zeros((len(t_ckpt), *shape), dtype=x.dtype, device=device)
    frames = []

    def record(i: int) -> None:
        if buf is not None:
            for k in np.nonzero(t_ckpt == tmap[i])[0]:
                buf[k] = x
        if progressive:
            frames.append(x)

    if is_solver(sampler):
        prog = build_solver(sampler, c.alphas_cumprod)
        mem = prog.init_mem(x)
        for s in prog.steps:
            i = s["i"]
            tt = torch.full((shape[0],), i, dtype=torch.int64, device=device)
            out = p_mean_variance(c, model_fn, x, tt, mean_type, var_type,
                                  clip_denoised=clip_denoised, **kw)
            if cond_grad_fn is not None:
                out = condition_score(c, cond_grad_fn, out, x, tt)
            z = None
            if prog.stochastic:
                # per-row tags are the original timestep here, as in JAX
                z = noise.draw(int(tmap[i])).to(x.dtype)
            x, mem = prog.step(x, out["pred_xstart"], s, mem, z)
            record(i)
    else:
        stochastic = sampler == "ddpm" or float(eta) != 0.0
        for t in range(M - 1, -1, -1):
            tt = torch.full((shape[0],), t, dtype=torch.int64, device=device)
            z = noise.draw(t).to(x.dtype) if stochastic else None
            if sampler == "ddpm":
                x, _ = p_sample_step(c, model_fn, x, tt, z, mean_type, var_type,
                                     clip_denoised=clip_denoised, cond_grad_fn=cond_grad_fn, **kw)
            else:
                x, _ = ddim_sample_step(c, model_fn, x, tt, z, mean_type, var_type,
                                        clip_denoised=clip_denoised, cond_grad_fn=cond_grad_fn,
                                        eta=eta, **kw)
            record(t)
    if t_checkpoints is not None:
        return x, buf
    return (x, torch.stack(frames)) if progressive else x


@torch.no_grad()
def inpaint_loop(
    c: GaussianCoefficients,
    model_fn: Callable,
    known: torch.Tensor,
    mask: torch.Tensor,
    generator: Optional[torch.Generator],
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    sampler: str = "ddpm",
    eta: float = 0.0,
    clip_denoised: bool = True,
    resample_steps: int = 1,
    cond_grad_fn: Optional[Callable] = None,
    thresholding_percentile: float = 0.9,
    row_keys: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """RePaint inpainting (Lugmayr et al., arXiv:2201.09865, Alg. 1) over
    the (respaced) steps M-1 .. 0. ``mask`` is 1 where ``known`` is kept and
    0 where content is generated; it broadcasts to ``known``'s shape. Each
    step denoises the whole field with the model ('ddpm' or 'ddim'), then
    puts back the known region noised to the step's level,
    ``q_sample(known, t-1)``; ``alphas_cumprod_prev[0] == 1`` makes the
    known region of the output equal ``known`` exactly. ``resample_steps``
    U > 1 re-noises the composite one step forward and denoises it again, U
    rounds a step (jump length 1); at t = 0 the re-noise is multiplied by
    zero.

    The draws, batch-wide from ``generator``: x_T, then for each step t
    and round u in order: the step's noise (not for DDIM at eta = 0), the
    known region's, and, for u < U - 1, the re-noise. Per row, from
    ``row_keys``: x_T at tag M, and for (t, u) the tags (t, u, d) folded in
    turn, d = 0 for the known region, 1 for the step and 2 for the re-noise,
    JAX's three nested tags."""
    if sampler not in ("ddpm", "ddim"):
        raise ValueError(
            f"inpainting supports 'ddpm' or 'ddim', got {sampler!r} "
            "(multistep dpm++ has no per-step noise level to project onto)",
        )
    if int(resample_steps) < 1:
        raise ValueError(f"resample_steps must be >= 1, got {resample_steps}")
    device = c.device
    known = torch.as_tensor(known, device=device)
    shape = tuple(known.shape)
    mask = torch.broadcast_to(torch.as_tensor(mask, device=device).to(known.dtype), shape)
    noise = _Noise(shape, device, generator, row_keys)
    M = c.num_timesteps
    x = noise.draw(M).to(known.dtype)
    step = p_sample_step if sampler == "ddpm" else ddim_sample_step
    kw = {"eta": eta} if sampler == "ddim" else {}
    stochastic = sampler == "ddpm" or float(eta) != 0.0
    U = int(resample_steps)
    for t in range(M - 1, -1, -1):
        tt = torch.full((shape[0],), t, dtype=torch.int64, device=device)
        abar_prev = extract(c.alphas_cumprod_prev, tt, x.ndim)
        alpha_t = extract(c.alphas_cumprod, tt, x.ndim) / abar_prev
        live = float(t > 0)
        for u in range(U):
            z = noise.draw(t, u, 1).to(known.dtype) if stochastic else None
            x_unknown, _ = step(c, model_fn, x, tt, z, mean_type, var_type,
                                clip_denoised=clip_denoised, cond_grad_fn=cond_grad_fn,
                                thresholding_percentile=thresholding_percentile, **kw)
            x_known = (torch.sqrt(abar_prev) * known
                       + torch.sqrt(1.0 - abar_prev) * noise.draw(t, u, 0).to(known.dtype))
            x = mask * x_known + (1.0 - mask) * x_unknown
            if u < U - 1:
                renoised = (torch.sqrt(alpha_t) * x
                            + torch.sqrt(1.0 - alpha_t) * noise.draw(t, u, 2).to(known.dtype))
                x = live * renoised + (1.0 - live) * x
    return x


# ---------------------------------------------------------------------------
# The VLB and the training losses
# ---------------------------------------------------------------------------

def vb_terms_bpd(c, model_fn, x_start, x_t, t, mean_type, var_type, clip_denoised=False,
                 thresholding_percentile=0.9) -> dict:
    """KL(q(x_{t-1} | x_t, x_0) || p(x_{t-1} | x_t)) per sample in bits per
    dimension; at t = 0 the discretised decoder's negative log-likelihood."""
    true_mean, _, true_log_var = q_posterior_mean_variance(c, x_start, x_t, t)
    out = p_mean_variance(c, model_fn, x_t, t, mean_type, var_type,
                          clip_denoised=clip_denoised,
                          thresholding_percentile=thresholding_percentile)
    kl = normal_kl(true_mean, true_log_var, out["mean"], out["log_variance"])
    kl = mean_flat(kl) / _LN2
    decoder_nll = -discretized_gaussian_log_likelihood(x_start, out["mean"],
                                                       0.5 * out["log_variance"])
    decoder_nll = mean_flat(decoder_nll) / _LN2
    return {"output": torch.where(t == 0, decoder_nll, kl), "pred_xstart": out["pred_xstart"]}


def training_losses(
    c: GaussianCoefficients,
    model_fn: Callable,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    loss_type: LossType,
    mse_weight: Optional[torch.Tensor] = None,
) -> dict:
    """Per-sample training losses from the caller's ``noise`` (x_0 is noised
    once). KL losses are ``vb_terms_bpd`` (times T when rescaled). MSE
    losses of a learned variance add the ``vb`` term, computed on the model
    output with its mean half detached, so the VLB trains the variance
    only, times T/1000 when rescaled. ``mse_weight`` [B] scales the MSE term
    in the loss; ``terms['mse']`` stays unweighted."""
    x_t = q_sample(c, x_start, t, noise)
    terms: dict[str, torch.Tensor] = {}
    if loss_type.is_vb():
        terms["loss"] = vb_terms_bpd(c, model_fn, x_start, x_t, t, mean_type, var_type)["output"]
        if loss_type == LossType.RESCALED_KL:
            terms["loss"] = terms["loss"] * c.num_timesteps
        return terms

    model_output = model_fn(x_t, c.timestep_map[t])
    if var_type in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE):
        C = x_t.shape[-1]
        assert model_output.shape[-1] == 2 * C
        mean_out, var_values = torch.split(model_output, C, dim=-1)
        frozen = torch.cat([mean_out.detach(), var_values], dim=-1)
        terms["vb"] = vb_terms_bpd(c, lambda *_args: frozen, x_start, x_t, t, mean_type,
                                   var_type)["output"]
        if loss_type == LossType.RESCALED_MSE:
            terms["vb"] = terms["vb"] * (c.num_timesteps / 1000.0)
        model_output = mean_out

    if mean_type == ModelMeanType.PREVIOUS_X:
        target = q_posterior_mean_variance(c, x_start, x_t, t)[0]
    elif mean_type == ModelMeanType.START_X:
        target = x_start
    elif mean_type == ModelMeanType.VELOCITY:
        target = velocity_target(c, x_start, t, noise)
    else:
        target = noise
    terms["mse"] = mean_flat((target - model_output) ** 2)
    weighted = terms["mse"] if mse_weight is None else terms["mse"] * mse_weight
    terms["loss"] = weighted + terms["vb"] if "vb" in terms else weighted
    terms["x_t"] = x_t
    return terms


def prior_bpd(c: GaussianCoefficients, x_start: torch.Tensor) -> torch.Tensor:
    """KL(q(x_T | x_0) || N(0, I)) per sample in bits per dimension."""
    t = torch.full((x_start.shape[0],), c.num_timesteps - 1, dtype=torch.int64,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(c, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / _LN2


@torch.no_grad()
def calc_bpd_loop(
    c: GaussianCoefficients,
    model_fn: Callable,
    x_start: torch.Tensor,
    generator: Optional[torch.Generator],
    mean_type: ModelMeanType,
    var_type: ModelVarType,
    clip_denoised: bool = True,
    thresholding_percentile: float = 0.9,
) -> dict:
    """The whole VLB in bits per dimension, over t = T-1 .. 0 with one noise
    draw a step from ``generator`` (by default one seeded with 0). Returns
    ``total_bpd`` and ``prior_bpd`` [N], and ``vb``, ``xstart_mse`` and
    ``mse`` [N, T], whose columns run from t = T-1 down to 0."""
    x_start = torch.as_tensor(x_start, device=c.device)
    if generator is None:
        generator = torch.Generator(device=c.device).manual_seed(0)
    B = x_start.shape[0]
    vb, xstart_mse, mse = [], [], []
    for t in range(c.num_timesteps - 1, -1, -1):
        tt = torch.full((B,), t, dtype=torch.int64, device=c.device)
        noise = torch.randn(x_start.shape, generator=generator,
                            device=c.device).to(x_start.dtype)
        x_t = q_sample(c, x_start, tt, noise)
        out = vb_terms_bpd(c, model_fn, x_start, x_t, tt, mean_type, var_type,
                           clip_denoised=clip_denoised,
                           thresholding_percentile=thresholding_percentile)
        eps = predict_eps_from_xstart(c, x_t, tt, out["pred_xstart"])
        vb.append(out["output"])
        xstart_mse.append(mean_flat((out["pred_xstart"] - x_start) ** 2))
        mse.append(mean_flat((eps - noise) ** 2))
    vb = torch.stack(vb, dim=1)
    pb = prior_bpd(c, x_start)
    return {"total_bpd": vb.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

class GaussianDiffusionPipeline(AbstractDiffusionPipeline):
    """Config-driven Gaussian diffusion: training (every mean, variance and
    loss type, min-SNR weighting, conditioning dropout), sampling (DDPM,
    DDIM and the solvers, respaced, guided), inpainting, DDIM encoding and
    bits-per-dim."""

    def __init__(
        self,
        backbone,
        backbone_kwargs: dict[str, Any],
        schedule: Optional[NoiseSchedule] = None,
        loss_func="MSELoss",  # accepted for API parity; LossType governs
        timesteps: Optional[int] = None,
        cond_fn=None,
        cond_fn_kwargs: Optional[dict] = None,
        optimizer=None,
        opt_kwargs: Optional[dict] = None,
        model_mean_type: ModelMeanType | str = ModelMeanType.START_X,
        model_var_type: ModelVarType | str = ModelVarType.FIXED_LARGE,
        loss_type: LossType | str = LossType.MSE,
        beta_schedule_name: Optional[str] = None,
        clip_denoised: bool = True,
        thresholding_percentile: float = 0.9,
        sampling_batch_size: int = 10,
        sample_every_n_epochs: int = 5,
        sample_parameter_space: Optional[dict] = None,
        save_checkpoint_every_n_epochs: int = 10,
        t_checkpoints=None,
        cond_dropout: float = 0.0,
        loss_weighting: Optional[str] = None,
        min_snr_gamma: float = 5.0,
        **base_kwargs,
    ) -> None:
        if schedule is None:
            schedule = named_beta_schedule(beta_schedule_name or "cosine", timesteps or 1000)
        elif beta_schedule_name:
            schedule = named_beta_schedule(beta_schedule_name, timesteps or len(schedule))
        super().__init__(
            backbone=backbone, backbone_kwargs=backbone_kwargs, schedule=schedule,
            loss_func=loss_func, timesteps=timesteps, cond_fn=cond_fn,
            cond_fn_kwargs=cond_fn_kwargs, optimizer=optimizer, opt_kwargs=opt_kwargs,
            **base_kwargs,
        )

        def as_enum(e, v):
            return e(v) if isinstance(v, str) else v

        self.model_mean_type = as_enum(ModelMeanType, model_mean_type)
        self.model_var_type = as_enum(ModelVarType, model_var_type)
        self.loss_type = as_enum(LossType, loss_type)
        self.coeffs = coefficients_from_schedule(schedule, device=self.device)
        self._zero_terminal_snr = float(self.coeffs.alphas_cumprod[-1]) == 0.0
        if self._zero_terminal_snr and self.model_mean_type == ModelMeanType.EPSILON:
            raise ValueError(
                "zero-terminal-SNR schedule (alpha_bar_T == 0) with "
                "epsilon-prediction: x0 is unrecoverable from eps at the "
                "terminal step (arXiv:2305.08891). Use "
                "model_mean_type='v_prediction' (or 'x_start') with "
                "rescale_betas_zero_snr.",
            )
        self.clip_denoised = clip_denoised
        self.thresholding_percentile = thresholding_percentile
        self.sampling_batch_size = sampling_batch_size
        self.sample_every_n_epochs = sample_every_n_epochs
        self.sample_parameter_space = sample_parameter_space
        self.save_weights_every_n_epochs = save_checkpoint_every_n_epochs
        self.t_checkpoints = t_checkpoints
        self.cond_dropout = self.validate_cond_dropout(cond_dropout)
        self.loss_weighting = validate_loss_weighting(loss_weighting, self.model_mean_type,
                                                      self.loss_type)
        if self.loss_weighting and self._zero_terminal_snr:
            raise ValueError(
                "loss_weighting='min_snr' gives the zero-SNR terminal step "
                "weight 0, silently un-training the step "
                "rescale_betas_zero_snr exists to fix; drop min_snr or the "
                "zero-terminal-SNR rescale",
            )
        self.min_snr_gamma = float(min_snr_gamma)
        # respaced tables by (steps, spacing): built once, on the device
        self._respaced: dict = {}

    def _model_fn(self, conditions, guidance_scale: Optional[float] = None) -> Callable:
        """``fn(x, t)`` over the conditions, its output cast to x's dtype;
        classifier-free guided when ``guidance_scale`` != 1 (only the mean
        half of a learned-variance output is guided)."""
        if guidance_scale is None or float(guidance_scale) == 1.0 or conditions is None:
            def fn(x, t):
                return self.apply(x, t, conditions).to(x.dtype)

            return fn
        return self.guided_model_fn(conditions, guidance_scale)

    def respaced(self, num_steps: int, spacing: str) -> GaussianCoefficients:
        """The pipeline's tables respaced to ``num_steps`` on ``spacing``."""
        key = (int(num_steps), spacing)
        if key not in self._respaced:
            self._respaced[key] = respace(self.coeffs, num_steps, spacing=spacing)
        return self._respaced[key]

    def _train_model_fn(self, conditions, cond_mask=None) -> Callable:
        """The training model call: the backbone itself (autograd on, in
        the mode the caller set), its output cast to x's dtype."""
        def fn(x, t):
            return self.call_backbone(x, t, conditions, cond_mask).to(x.dtype)

        return fn

    def forward_process(self, data: torch.Tensor, generator=None, t=None, noise=None):
        """Noise a clean batch; returns (x_t, noise, t). Draws t, then the
        noise, from ``generator`` unless given."""
        if t is None:
            t = self.random_timesteps(generator, data.shape[0])
        if noise is None:
            noise = torch.randn(data.shape, generator=generator, device=self.device,
                                dtype=data.dtype)
        return q_sample(self.coeffs, data, t, noise), noise, t

    def loss_and_metrics(self, batch, generator=None, t=None, noise=None, cond_mask=None):
        """The mean of ``training_losses`` over the batch, and the metrics
        train_loss, psnr (clean against noised) and, where the loss has
        them, ``vb`` and ``mse``. The timesteps, the noise and (with
        ``cond_dropout``) the conditioning keep-mask are drawn from
        ``generator`` in that order unless given."""
        batch = normalize_batch(batch)
        data, labels = batch["data"], batch["labels"]
        if t is None:
            t = self.random_timesteps(generator, data.shape[0])
        if noise is None:
            noise = torch.randn(data.shape, generator=generator, device=self.device,
                                dtype=data.dtype)
        if cond_mask is None:
            cond_mask = self.cond_dropout_mask(generator, data.shape[0], labels)
        mse_weight = None
        if self.loss_weighting == "min_snr":
            mse_weight = min_snr_weight(self.coeffs.alphas_cumprod, t, self.model_mean_type,
                                        self.min_snr_gamma)
        terms = training_losses(self.coeffs, self._train_model_fn(labels, cond_mask), data, t,
                                noise, self.model_mean_type, self.model_var_type,
                                self.loss_type, mse_weight=mse_weight)
        loss = torch.mean(terms["loss"])
        metrics = self.training_metrics(data, terms.get("x_t", data), loss)
        if "vb" in terms:
            metrics["vb"] = torch.mean(terms["vb"])
        if "mse" in terms:
            metrics["mse"] = torch.mean(terms["mse"])
        return loss, metrics

    @torch.no_grad()
    def reverse_process(
        self,
        shape,
        conditions=None,
        sampler: str = "ddim",
        eta: float = 0.0,
        num_steps: Optional[int] = None,
        x_T=None,
        progressive: bool = False,
        cond_grad_fn=None,
        t_checkpoints=None,
        guidance_scale: Optional[float] = None,
        spacing: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        row_keys: Optional[Sequence[int]] = None,
    ):
        """DDIM (the default), ancestral or solver sampling, respaced to
        ``num_steps``. The respacing grid defaults to 'trailing' on a
        zero-terminal-SNR schedule, 'uniform-lambda' for the solvers and
        'uniform-t' otherwise. ``t_checkpoints`` (here or at construction)
        returns ``(final, frames[K])``; ``guidance_scale`` != 1 applies
        classifier-free guidance. Noise as in ``sample_loop``."""
        coeffs = self.coeffs
        zero_snr = self._zero_terminal_snr
        if zero_snr and is_solver(sampler):
            raise ValueError(
                f"the '{sampler}' ODE solver operates in log-SNR (lambda) "
                "space, which is -inf at the zero-SNR terminal step; sample "
                "zero-terminal-SNR schedules with 'ddim' or 'ddpm' instead.",
            )
        if zero_snr and cond_grad_fn is not None and sampler == "ddim":
            raise ValueError(
                "classifier guidance with sampler='ddim' inverts eps -> x0 "
                "(condition_score), which is undefined at the zero-SNR "
                "terminal step; use sampler='ddpm' (condition_mean) or "
                "classifier-free guidance (guidance_scale) instead.",
            )
        if num_steps and num_steps < coeffs.num_timesteps:
            coeffs = self.respaced(num_steps, spacing or (
                "trailing" if zero_snr
                else "uniform-lambda" if is_solver(sampler)
                else "uniform-t"))
        if t_checkpoints is None and not progressive:
            t_checkpoints = self.t_checkpoints
        return sample_loop(
            coeffs, self._model_fn(conditions, guidance_scale=guidance_scale), shape,
            generator, self.model_mean_type, self.model_var_type, sampler=sampler, eta=eta,
            clip_denoised=self.clip_denoised, cond_grad_fn=cond_grad_fn, x_T=x_T,
            progressive=progressive, t_checkpoints=t_checkpoints,
            thresholding_percentile=self.thresholding_percentile, row_keys=row_keys,
        )

    def generate(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        parameter_space: Optional[dict] = None,
        conditions=None,
        random: bool = False,
        as_hash_embeddings: bool = False,
        sampler: str = "ddim",
        num_steps: Optional[int] = None,
        eta: float = 0.0,
        guidance_scale: Optional[float] = None,
        spacing: Optional[str] = None,
    ) -> torch.Tensor:
        """Final samples of an eval grid: conditions are the first rows of
        the parameter space (``random=False``), else ``conditions``."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        batch_size = batch_size or self.sampling_batch_size
        shape = self.sample_shape(batch_size)
        space = parameter_space or self.sample_parameter_space
        if conditions is None and space is not None:
            conditions = self.conditions_from_parameter_space(
                space, batch_size, random=random, as_hash_embeddings=as_hash_embeddings,
                embedding_dim=self.condition_embedding_dim())
        else:
            conditions = self.coerce_conditions(conditions, batch_size, generator)
        return self.reverse_process(
            shape, conditions, sampler=sampler, num_steps=num_steps, eta=eta,
            guidance_scale=guidance_scale, spacing=spacing, t_checkpoints=(),
            generator=generator)

    def inpaint(
        self,
        known,
        mask,
        conditions=None,
        sampler: str = "ddpm",
        eta: float = 0.0,
        num_steps: Optional[int] = None,
        resample_steps: int = 1,
        guidance_scale: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        row_keys: Optional[Sequence[int]] = None,
    ) -> torch.Tensor:
        """Regenerate the ``mask == 0`` region of ``known`` (RePaint) with
        the pipeline's conditioning, guidance and respacing ('trailing' on a
        zero-terminal-SNR schedule, 'uniform-t' otherwise). Noise as in
        ``inpaint_loop``."""
        coeffs = self.coeffs
        if num_steps and num_steps < coeffs.num_timesteps:
            coeffs = self.respaced(num_steps,
                                   "trailing" if self._zero_terminal_snr else "uniform-t")
        return inpaint_loop(
            coeffs, self._model_fn(conditions, guidance_scale=guidance_scale), known, mask,
            generator, self.model_mean_type, self.model_var_type, sampler=sampler, eta=eta,
            clip_denoised=self.clip_denoised, resample_steps=resample_steps,
            thresholding_percentile=self.thresholding_percentile, row_keys=row_keys,
        )

    def encode(self, data, conditions=None, num_steps: Optional[int] = None) -> torch.Tensor:
        """DDIM latents of ``data`` (the deterministic reverse ODE), respaced
        on 'uniform-t' to ``num_steps``."""
        coeffs = self.coeffs
        if num_steps and num_steps < coeffs.num_timesteps:
            coeffs = self.respaced(num_steps, "uniform-t")
        return encode_loop(coeffs, self._model_fn(conditions), data, self.model_mean_type,
                           self.model_var_type)

    def calc_bpd(self, data, generator: Optional[torch.Generator] = None, conditions=None,
                 clip_denoised: bool = True) -> dict:
        """Bits per dimension of ``data`` through the whole VLB
        (``calc_bpd_loop``) on the full schedule."""
        return calc_bpd_loop(self.coeffs, self._model_fn(conditions), data, generator,
                             self.model_mean_type, self.model_var_type,
                             clip_denoised=clip_denoised,
                             thresholding_percentile=self.thresholding_percentile)


def min_snr_weight(
    alphas_cumprod: torch.Tensor, t: torch.Tensor, mean_type: ModelMeanType, gamma: float = 5.0,
) -> torch.Tensor:
    """Per-sample min-SNR-gamma loss weight (Hang et al., arXiv:2303.09556),
    so that the weighted loss equals min(SNR, gamma) times the x0-space loss:
    START_X min(SNR, gamma); EPSILON min(SNR, gamma) / SNR; VELOCITY
    min(SNR, gamma) / (SNR + 1)."""
    acp = alphas_cumprod[t]
    snr = acp / torch.clamp(1.0 - acp, min=1e-20)
    clipped = torch.clamp(snr, max=gamma)
    if mean_type == ModelMeanType.START_X:
        return clipped
    if mean_type == ModelMeanType.EPSILON:
        return clipped / snr
    if mean_type == ModelMeanType.VELOCITY:
        return clipped / (snr + 1.0)
    raise ValueError(
        f"min-SNR weighting is undefined for mean_type={mean_type}; "
        "use START_X, EPSILON or VELOCITY",
    )


def validate_loss_weighting(
    loss_weighting: Optional[str], mean_type: ModelMeanType, loss_type: Optional[LossType] = None,
) -> Optional[str]:
    """Normalise and check a ``loss_weighting`` config value at construction."""
    if loss_weighting in (None, "", "none"):
        return None
    canonical = str(loss_weighting).lower().replace("-", "_")
    if canonical != "min_snr":
        raise ValueError(f"unknown loss_weighting {loss_weighting!r}; expected 'min_snr' or none")
    if mean_type not in (ModelMeanType.START_X, ModelMeanType.EPSILON, ModelMeanType.VELOCITY):
        raise ValueError(f"loss_weighting='min_snr' is undefined for mean_type={mean_type}")
    if loss_type is not None and loss_type.is_vb():
        raise ValueError(
            f"loss_weighting='min_snr' only applies to MSE loss types, not loss_type={loss_type}",
        )
    return canonical
