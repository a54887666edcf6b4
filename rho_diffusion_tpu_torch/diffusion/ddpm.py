"""DDPM pipeline — Ho et al. (2020) epsilon prediction, sampling side.

Port of ``rho_diffusion_tpu/diffusion/ddpm.py``:

* ``q_sample``: x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps;
* ``ddpm_reverse_step``: x_{t-1} = (x_t - beta_t / sqrt(1-abar_t) eps_hat)
  / sqrt(alpha_t) + 0.8 sqrt(beta_t) z, clamped to [-1, 1];
* ``DDPM.reverse_process``: the JAX package's ``lax.scan`` becomes a Python
  loop over t = T-1 .. 0 with the same gating (noise only for t > 1, an
  update only for t > 0, so the model is not called at t = 0) and the same
  ``t_checkpoints`` frame buffer, written every T//10 steps.

Noise comes from an explicit ``torch.Generator`` on the pipeline's device.
Classifier-free guidance and the training step are not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from rho_diffusion_tpu_torch.diffusion.base import AbstractDiffusionPipeline, extract
from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule


def q_sample(schedule: NoiseSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward (noising) process q(x_t | x_0)."""
    ab = extract(schedule.alpha_bar_t, t, x0.ndim)
    return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def ddpm_reverse_step(
    schedule: NoiseSchedule,
    x_t: torch.Tensor,
    eps_hat: torch.Tensor,
    t: torch.Tensor,
    z: torch.Tensor,
    noise_factor: float = 0.8,
    clip: bool = True,
) -> torch.Tensor:
    """One ancestral reverse step, vectorised over the batch."""
    alpha = extract(schedule.alpha_t, t, x_t.ndim)
    beta = extract(schedule.beta_t, t, x_t.ndim)
    ab = extract(schedule.alpha_bar_t, t, x_t.ndim)
    mean = (x_t - beta / torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(alpha)
    out = mean + noise_factor * torch.sqrt(beta) * z
    return torch.clamp(out, -1.0, 1.0) if clip else out


class DDPM(AbstractDiffusionPipeline):
    """Epsilon-prediction DDPM with the JAX package's sampling semantics."""

    def __init__(
        self,
        backbone,
        backbone_kwargs: dict[str, Any],
        schedule: NoiseSchedule,
        loss_func="MSELoss",
        timesteps: Optional[int] = None,
        cond_fn=None,
        cond_fn_kwargs: Optional[dict] = None,
        optimizer=None,
        opt_kwargs: Optional[dict] = None,
        t_checkpoints=None,
        sampling_batch_size: int = 10,
        sample_every_n_epochs: int = 5,
        sample_parameter_space: Optional[dict] = None,
        save_checkpoint_every_n_epochs: int = 10,
        noise_factor: float = 0.8,
        clip_denoised: bool = True,
        cond_dropout: float = 0.0,
        loss_weighting: Optional[str] = None,
        min_snr_gamma: float = 5.0,
        **base_kwargs,
    ) -> None:
        if float(schedule.alpha_bar_t[-1]) == 0.0:
            raise ValueError(
                "zero-terminal-SNR schedule (alpha_bar_T == 0) with the "
                "epsilon-only DDPM pipeline: the reverse step divides by "
                "sqrt(alpha_T) = 0. Use GaussianDiffusionPipeline with "
                "model_mean_type='v_prediction'.",
            )
        if not 0.0 <= cond_dropout < 1.0:
            raise ValueError(f"cond_dropout must be in [0, 1), got {cond_dropout}")
        if loss_weighting not in (None, "min_snr"):
            raise ValueError(f"loss_weighting must be None or 'min_snr', got {loss_weighting!r}")
        super().__init__(
            backbone=backbone,
            backbone_kwargs=backbone_kwargs,
            schedule=schedule,
            loss_func=loss_func,
            timesteps=timesteps,
            cond_fn=cond_fn,
            cond_fn_kwargs=cond_fn_kwargs,
            optimizer=optimizer,
            opt_kwargs=opt_kwargs,
            **base_kwargs,
        )
        self.t_checkpoints = t_checkpoints
        self.sampling_batch_size = sampling_batch_size
        self.sample_parameter_space = sample_parameter_space
        self.noise_factor = noise_factor
        self.clip_denoised = clip_denoised

    @torch.no_grad()
    def reverse_process(
        self,
        shape: tuple[int, ...],
        conditions: Optional[torch.Tensor] = None,
        t_checkpoints=None,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Full ancestral sampling. Returns {'denoised', 'buffer'}."""
        T = len(self.schedule)
        batch_size = shape[0]
        dev = self.device
        x = (
            torch.randn(shape, generator=generator, device=dev)
            if x_T is None else torch.as_tensor(x_T, device=dev, dtype=torch.float32)
        )
        num_ckpt = len(t_checkpoints) if t_checkpoints is not None else 0
        steps_per_ckpt = max(T // 10, 1)
        buff = (
            torch.zeros((batch_size, num_ckpt, *shape[1:]), dtype=x.dtype, device=dev)
            if num_ckpt else None
        )
        ckpt_idx = 0
        for t in range(T - 1, -1, -1):
            if t > 0:
                z = (
                    torch.randn(x.shape, generator=generator, device=dev, dtype=x.dtype)
                    if t > 1 else torch.zeros_like(x)
                )
                tt = torch.full((batch_size,), t, dtype=torch.int64, device=dev)
                eps_hat = self.apply(x, tt, conditions).to(x.dtype)
                x = ddpm_reverse_step(
                    self.schedule, x, eps_hat, tt, z,
                    noise_factor=self.noise_factor, clip=self.clip_denoised,
                )
            if buff is not None and t % steps_per_ckpt == 0 and ckpt_idx < num_ckpt:
                buff[:, ckpt_idx] = x
                ckpt_idx += 1
        return {"denoised": x, "buffer": buff}

    def p_sample(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        conditions=None,
        parameter_space: Optional[dict] = None,
        random: bool = True,
        as_hash_embeddings: bool = False,
    ) -> dict:
        """Draw samples, with the shape from the backbone kwargs and the
        conditions from a parameter space."""
        batch_size = batch_size or self.sampling_batch_size
        shape = self.sample_shape(batch_size)
        if conditions is None and parameter_space is not None:
            conditions = self.conditions_from_parameter_space(
                parameter_space, batch_size, random=random,
                as_hash_embeddings=as_hash_embeddings,
                embedding_dim=self.condition_embedding_dim(),
            )
        else:
            conditions = self.coerce_conditions(conditions, batch_size, generator)
        return self.reverse_process(
            shape, conditions, t_checkpoints=self.t_checkpoints, generator=generator,
        )

    def generate(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        parameter_space: Optional[dict] = None,
        conditions=None,
        random: bool = True,
        as_hash_embeddings: bool = False,
    ) -> torch.Tensor:
        """Sample a batch of fields."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = self.p_sample(
            generator,
            batch_size=batch_size,
            conditions=conditions,
            parameter_space=parameter_space or self.sample_parameter_space,
            random=random,
            as_hash_embeddings=as_hash_embeddings,
        )
        return out["denoised"]
