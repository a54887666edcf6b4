"""DDPM pipeline — Ho et al. (2020) epsilon prediction.

Port of ``rho_diffusion_tpu/diffusion/ddpm.py``:

* ``q_sample``: x_t = sqrt(abar_t) x_0 + sqrt(1 - abar_t) eps;
* ``DDPM.loss_and_metrics`` (:145-183): MSE between the predicted and the
  drawn noise at uniform timesteps, optionally min-SNR weighted, with
  per-sample conditioning dropout for classifier-free-guidance training;
* ``ddpm_reverse_step``: x_{t-1} = (x_t - beta_t / sqrt(1-abar_t) eps_hat)
  / sqrt(alpha_t) + 0.8 sqrt(beta_t) z, clamped to [-1, 1];
* ``DDPM.reverse_process`` (:188-277): the JAX package's ``lax.scan``
  becomes a Python loop over t = T-1 .. 0 with the same gating (noise only
  for t > 1, an update only for t > 0, so the model is not called at
  t = 0) and the same ``t_checkpoints`` frame buffer, written every T//10
  steps; ``guidance_scale`` != 1 samples with classifier-free guidance
  (``guided_model_fn``).

Noise comes either from one ``torch.Generator`` on the pipeline's device
(batch-wide), or, given ``row_keys``, from per-row streams
(``diffusion.sampling_rng``: x_T at tag T, step t's noise at tag t), the
serving determinism contract.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from rho_diffusion_tpu_torch.diffusion.base import (
    AbstractDiffusionPipeline,
    extract,
    normalize_batch,
)
from rho_diffusion_tpu_torch.diffusion.gaussian import (
    ModelMeanType,
    min_snr_weight,
    validate_loss_weighting,
)
from rho_diffusion_tpu_torch.diffusion.sampling_rng import keys_at_step, normal_like
from rho_diffusion_tpu_torch.diffusion.schedule import NoiseSchedule
from rho_diffusion_tpu_torch.ops.convolution import mean_flat


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
        self.loss_weighting = validate_loss_weighting(loss_weighting, ModelMeanType.EPSILON)
        self.min_snr_gamma = float(min_snr_gamma)
        # a callable loss_func is the caller's assertion that it is an MSE
        if self.loss_weighting and isinstance(loss_func, str) and \
                loss_func not in ("MSELoss", "mse", "mse_loss"):
            raise ValueError(f"loss_weighting='min_snr' requires an MSE loss_func, got {loss_func!r}")
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
        self.cond_dropout = self.validate_cond_dropout(cond_dropout)
        self.t_checkpoints = t_checkpoints
        self.sampling_batch_size = sampling_batch_size
        self.sample_parameter_space = sample_parameter_space
        self.noise_factor = noise_factor
        self.clip_denoised = clip_denoised

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def forward_process(self, data: torch.Tensor, generator=None, t=None, noise=None):
        """Noise a clean batch; returns (x_t, noise, t). Draws t, then the
        noise, from ``generator`` unless given."""
        if t is None:
            t = self.random_timesteps(generator, data.shape[0])
        if noise is None:
            noise = torch.randn(data.shape, generator=generator, device=self.device,
                                dtype=data.dtype)
        return q_sample(self.schedule, data, t, noise), noise, t

    def loss_and_metrics(self, batch, generator=None, t=None, noise=None, cond_mask=None):
        """MSE between the predicted and the true noise at random timesteps
        (or the min-SNR-weighted per-sample MSE). With ``cond_dropout`` the
        conditioning keep-mask is drawn first, as in the JAX package."""
        batch = normalize_batch(batch)
        data, labels = batch["data"], batch["labels"]
        if cond_mask is None and self.cond_dropout > 0.0:
            cond_mask = self.cond_dropout_mask(generator, data.shape[0], labels)
        x_t, noise, t = self.forward_process(data, generator, t, noise)
        eps_hat = self.call_backbone(x_t, t, labels, cond_mask)
        target = noise.to(eps_hat.dtype)
        if self.loss_weighting == "min_snr":
            w = min_snr_weight(self.schedule.alpha_bar_t, t, ModelMeanType.EPSILON,
                               self.min_snr_gamma)
            loss = torch.mean(w * mean_flat((eps_hat - target) ** 2))
        else:
            loss = self.loss_func(eps_hat, target)
        return loss, self.training_metrics(data, x_t, loss)

    @torch.no_grad()
    def reverse_process(
        self,
        shape: tuple[int, ...],
        conditions: Optional[torch.Tensor] = None,
        t_checkpoints=None,
        x_T: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        row_keys: Optional[Sequence[int]] = None,
        guidance_scale: Optional[float] = None,
    ) -> dict:
        """Full ancestral sampling. Returns {'denoised', 'buffer'}.

        Noise comes from ``generator``, or, given ``row_keys`` (one 64-bit
        key per row, ``sampling_rng``), from each row's own stream, so a
        row's sample does not depend on its batch. ``guidance_scale`` != 1
        with conditions applies classifier-free guidance."""
        T = len(self.schedule)
        batch_size = shape[0]
        dev = self.device
        per_row = row_keys is not None

        def noise(tag: int) -> torch.Tensor:
            if per_row:
                return normal_like(keys_at_step(row_keys, tag), shape, dev)
            return torch.randn(shape, generator=generator, device=dev)

        x = noise(T) if x_T is None else torch.as_tensor(x_T, device=dev, dtype=torch.float32)
        if guidance_scale is not None and float(guidance_scale) != 1.0 and conditions is not None:
            model_fn = self.guided_model_fn(conditions, guidance_scale)
        else:
            def model_fn(x, tt):
                return self.apply(x, tt, conditions)
        num_ckpt = len(t_checkpoints) if t_checkpoints is not None else 0
        steps_per_ckpt = max(T // 10, 1)
        buff = (
            torch.zeros((batch_size, num_ckpt, *shape[1:]), dtype=x.dtype, device=dev)
            if num_ckpt else None
        )
        ckpt_idx = 0
        for t in range(T - 1, -1, -1):
            if t > 0:
                z = noise(t).to(x.dtype) if t > 1 else torch.zeros_like(x)
                tt = torch.full((batch_size,), t, dtype=torch.int64, device=dev)
                eps_hat = model_fn(x, tt).to(x.dtype)
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
        guidance_scale: Optional[float] = None,
    ) -> dict:
        """Draw samples, with the shape from the backbone kwargs and the
        conditions from a parameter space; ``guidance_scale`` != 1 with
        conditions samples with classifier-free guidance."""
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
            guidance_scale=guidance_scale,
        )

    def generate(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        parameter_space: Optional[dict] = None,
        conditions=None,
        random: bool = True,
        as_hash_embeddings: bool = False,
        guidance_scale: Optional[float] = None,
    ) -> torch.Tensor:
        """Sample a batch of fields (guided when ``guidance_scale`` != 1)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        out = self.p_sample(
            generator,
            batch_size=batch_size,
            conditions=conditions,
            parameter_space=parameter_space or self.sample_parameter_space,
            random=random,
            as_hash_embeddings=as_hash_embeddings,
            guidance_scale=guidance_scale,
        )
        return out["denoised"]
