"""``DiffusersDDPMPipeline``: the HuggingFace ``DDPMScheduler`` surface on
the Gaussian diffusion pipeline.

Port of ``rho_diffusion_tpu/diffusion/diffusers_compat.py`` (:54-125). The
reference's diffusers pipeline delegated its schedule to a
``diffusers.SchedulerMixin`` and picked the training target from the
scheduler's ``prediction_type``. Without the diffusers package, this
subclass maps the ``DDPMScheduler`` configuration onto
``GaussianDiffusionPipeline``:

* ``beta_schedule`` "linear", "scaled_linear", "squaredcos_cap_v2" or
  "sigmoid" (with ``beta_start``/``beta_end``/``num_train_timesteps``)
  through ``named_beta_schedule``; the three ranged ones take HF's
  un-rescaled range, default [0.0001, 0.02], and the cosine one warns that
  it ignores a range;
* ``prediction_type`` "epsilon", "sample" or "v_prediction";
* ``variance_type`` "fixed_small(_log)", "fixed_large(_log)", "learned" or
  "learned_range";
* ``clip_sample`` as ``clip_denoised``, and the gradients' global norm
  clipped to ``clip_grad_norm`` (1.0), as the reference clipped inline;
* ``rescale_betas_zero_snr`` (Lin et al., arXiv:2305.08891) rescales a
  schedule built here, and raises with a ready one.

A ready ``schedule`` without an explicit count leaves T to the base class
(its length). The default is the reference scripts' squaredcos_cap_v2,
epsilon, fixed_large.
"""
from __future__ import annotations

import warnings
from typing import Any, Optional

from rho_diffusion_tpu_torch.diffusion.gaussian import (
    GaussianDiffusionPipeline,
    LossType,
    ModelMeanType,
    ModelVarType,
)
from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule, named_beta_schedule

_PREDICTION_TYPES = {
    "epsilon": ModelMeanType.EPSILON,
    "sample": ModelMeanType.START_X,
    "v_prediction": ModelMeanType.VELOCITY,
}

_VARIANCE_TYPES = {
    "fixed_small": ModelVarType.FIXED_SMALL,
    "fixed_small_log": ModelVarType.FIXED_SMALL,
    "fixed_large": ModelVarType.FIXED_LARGE,
    "fixed_large_log": ModelVarType.FIXED_LARGE,
    "learned": ModelVarType.LEARNED,
    "learned_range": ModelVarType.LEARNED_RANGE,
}


class DiffusersDDPMPipeline(GaussianDiffusionPipeline):
    """GaussianDiffusionPipeline configured by DDPMScheduler's names."""

    def __init__(
        self,
        backbone,
        backbone_kwargs: dict[str, Any],
        schedule: Optional[NoiseSchedule] = None,
        timesteps: Optional[int] = None,
        num_train_timesteps: Optional[int] = None,
        prediction_type: str = "epsilon",
        beta_schedule: str = "squaredcos_cap_v2",
        beta_start: Optional[float] = None,
        beta_end: Optional[float] = None,
        variance_type: str = "fixed_large",
        clip_sample: bool = True,
        clip_grad_norm: float = 1.0,
        rescale_betas_zero_snr: bool = False,
        **kwargs,
    ) -> None:
        T = timesteps or num_train_timesteps
        if schedule is None:
            # HF DDPMScheduler: an explicit, un-rescaled beta range (not
            # named_beta_schedule's 1000/T-scaled bare "linear")
            if beta_schedule in ("linear", "scaled_linear", "sigmoid"):
                beta_start = 0.0001 if beta_start is None else beta_start
                beta_end = 0.02 if beta_end is None else beta_end
            elif beta_start is not None or beta_end is not None:
                warnings.warn(
                    f"beta_start/beta_end are ignored by the "
                    f"'{beta_schedule}' schedule (same as HF DDPMScheduler)",
                    stacklevel=2,
                )
            schedule = named_beta_schedule(
                beta_schedule, T or 1000, beta_start=beta_start, beta_end=beta_end,
                zero_terminal_snr=rescale_betas_zero_snr,
            )
        elif rescale_betas_zero_snr:
            raise ValueError(
                "rescale_betas_zero_snr requires building the schedule here "
                "(float64 rescale before table construction) — pass "
                "beta_schedule/beta_start/beta_end instead of a ready "
                "schedule object",
            )
        if prediction_type not in _PREDICTION_TYPES:
            raise ValueError(
                f"unknown prediction_type '{prediction_type}'; "
                f"expected one of {sorted(_PREDICTION_TYPES)}",
            )
        if variance_type not in _VARIANCE_TYPES:
            raise ValueError(
                f"unknown variance_type '{variance_type}'; "
                f"expected one of {sorted(_VARIANCE_TYPES)}",
            )
        kwargs.setdefault("model_var_type", _VARIANCE_TYPES[variance_type])
        kwargs.setdefault("loss_type", LossType.MSE)
        kwargs.setdefault("clip_denoised", clip_sample)
        super().__init__(
            backbone=backbone,
            backbone_kwargs=backbone_kwargs,
            schedule=schedule,
            timesteps=T,
            model_mean_type=_PREDICTION_TYPES[prediction_type],
            clip_grad_norm=clip_grad_norm,
            **kwargs,
        )
