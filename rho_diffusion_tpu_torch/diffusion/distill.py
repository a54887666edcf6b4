"""Progressive distillation (Salimans & Ho, arXiv:2202.00512).

Port of ``rho_diffusion_tpu/diffusion/distill.py``. Each stage halves the
sampling steps: a student with N/2 DDIM steps learns to make in ONE step
what TWO deterministic DDIM steps of the N-step teacher make, then teaches
the next stage. The grids nest exactly (the student's is every other
teacher point of the trailing grid, ``respace_subset``), so the target
inversion

    x0_target = (x_t'' - (sigma''/sigma) x_t) / (alpha'' - (sigma''/sigma) alpha)

is exact: with a teacher that predicts the true noise, the target is the
true x0.

In PyTorch's idiom: the teacher is a frozen copy of the backbone, run under
``torch.no_grad()`` in eval mode (JAX's ``stop_gradient`` with
``train=False``); the student a copy trained in train mode; each stage
starts from the teacher's weights with fresh optimizer state, under the
per-stage warmup-cosine learning rate of JAX's ``_get_tx`` through the
port's ``build_optimizer``. A stage's row indices j and noise come from an
explicit ``torch.Generator`` (j, then the noise, each update), or are
injected through ``draws``, as the samplers take their noise. An update
costs two teacher forwards, a student forward and its backward.
"""
from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from rho_diffusion_tpu_torch.diffusion.base import extract
from rho_diffusion_tpu_torch.diffusion.gaussian import (
    GaussianCoefficients,
    ddim_sample_step,
    p_mean_variance,
    q_sample,
    respace_subset,
    sample_loop,
    space_timesteps_trailing,
)
from rho_diffusion_tpu_torch.training.optimizers import build_optimizer, warmup_cosine_decay


def distill_grid(num_timesteps: int, n: int) -> np.ndarray:
    """The self-nested n-point grid t_i = round((i+1) T/n) - 1: its every
    other point is the grid of n/2, and every stage tops out at t = T-1."""
    if n > num_timesteps:
        raise ValueError(f"cannot stride {num_timesteps} timesteps to {n} distinct points")
    return space_timesteps_trailing(num_timesteps, n)


def distilled_coefficients(coeffs: GaussianCoefficients, n: int) -> GaussianCoefficients:
    """The table a distilled n-step student samples with: ``respace_subset``
    over ``distill_grid`` (not the uniform-t grid)."""
    return respace_subset(coeffs, distill_grid(coeffs.num_timesteps, n))


def nested_grids(coeffs: GaussianCoefficients, n_teacher: int):
    """(teacher, student) tables on nested grids: the student's index j is
    the teacher's 2j+1, and one student step spans teacher steps 2j+1, 2j."""
    if n_teacher % 2 or n_teacher < 2:
        raise ValueError(f"n_teacher must be even and >= 2, got {n_teacher}")
    if n_teacher > coeffs.num_timesteps:
        raise ValueError(f"n_teacher={n_teacher} exceeds the table ({coeffs.num_timesteps})")
    use_t = distill_grid(coeffs.num_timesteps, n_teacher)
    return respace_subset(coeffs, use_t), respace_subset(coeffs, use_t[1::2])


@torch.no_grad()
def distill_targets(c_teacher: GaussianCoefficients, c_student: GaussianCoefficients,
                    teacher_fn: Callable, x_t: torch.Tensor, j: torch.Tensor, mean_type,
                    var_type, clip_denoised: bool = False,
                    thresholding_percentile: float = 0.9) -> torch.Tensor:
    """The x0-space target of student step ``j`` (per row): two
    deterministic DDIM steps of the teacher (indices 2j+1, 2j) from ``x_t``,
    and the single student step that lands there, inverted."""
    kw = {"clip_denoised": clip_denoised, "thresholding_percentile": thresholding_percentile,
          "eta": 0.0}
    x1, _ = ddim_sample_step(c_teacher, teacher_fn, x_t, 2 * j + 1, None, mean_type, var_type,
                             **kw)
    x2, _ = ddim_sample_step(c_teacher, teacher_fn, x1, 2 * j, None, mean_type, var_type, **kw)
    alpha = extract(c_student.sqrt_alphas_cumprod, j, x_t.ndim)
    sigma = extract(c_student.sqrt_one_minus_alphas_cumprod, j, x_t.ndim)
    acp_pp = extract(c_student.alphas_cumprod_prev, j, x_t.ndim)
    ratio = torch.sqrt(1.0 - acp_pp) / sigma
    # alpha'' > alpha and sigma'' < sigma on a monotone schedule; at j == 0
    # (acp_prev == 1) the denominator is exactly 1
    return (x2 - ratio * x_t) / (torch.sqrt(acp_pp) - ratio * alpha)


def truncated_snr_weight(c_student: GaussianCoefficients, j: torch.Tensor,
                         ndim: int) -> torch.Tensor:
    """max(SNR, 1): the paper's truncated-SNR weight of the x0-space loss."""
    acp = extract(c_student.alphas_cumprod, j, ndim)
    return torch.clamp(acp / (1.0 - acp), min=1.0)


def _model_fn(model: torch.nn.Module, labels) -> Callable:
    def fn(x, t):
        return model(x, t, labels).to(x.dtype)

    return fn


class ProgressiveDistiller:
    """Halving stages against a ``GaussianDiffusionPipeline``: the student
    has the pipeline's backbone class, mean and variance types and
    conditioning.

    Usage::

        d = ProgressiveDistiller(pipe, opt_kwargs={"lr": 1e-4})
        student, info = d.distill(pipe.backbone, batches, from_steps=64, to_steps=4,
                                  updates_per_stage=400, generator=g)
        samples = d.sample(student, shape, n_steps=4)  # 4 model calls

    ``sample`` uses the trailing grid the student was trained on;
    ``reverse_process(num_steps=4)`` would stride the uniform-t grid."""

    def __init__(self, pipeline, optimizer: str = "AdamW", opt_kwargs: Optional[dict] = None,
                 loss_weight: str = "truncated_snr", clip_teacher: bool = False,
                 lr_schedule: str = "warmup_cosine") -> None:
        if loss_weight not in ("truncated_snr", "one"):
            raise ValueError(
                f"loss_weight must be 'truncated_snr' or 'one', got {loss_weight!r}")
        if lr_schedule not in ("warmup_cosine", "constant"):
            raise ValueError(
                f"lr_schedule must be 'warmup_cosine' or 'constant', got {lr_schedule!r}")
        self.pipeline = pipeline
        self.loss_weight = loss_weight
        self.clip_teacher = clip_teacher
        self.lr_schedule = lr_schedule
        self._optimizer = optimizer
        self._opt_kwargs = dict(opt_kwargs or {"lr": 1e-4})
        self._grids: dict = {}

    def learning_rate(self, updates: Optional[int]):
        """A stage's learning rate: linear warmup from 0 over
        max(1, min(100, updates // 10)) updates, then cosine decay to a
        tenth by update max(updates, warmup + 1) (optax's
        ``warmup_cosine_decay_schedule``, as JAX's ``_get_tx`` builds it; a
        cold Adam second moment makes constant-lr first steps diverge); the
        constant lr under ``lr_schedule='constant'``."""
        kw = self._opt_kwargs
        lr = kw.get("learning_rate", kw.get("lr", 1e-4))
        if self.lr_schedule == "warmup_cosine" and updates:
            warm = max(1, min(100, updates // 10))
            return warmup_cosine_decay(0.0, lr, warm, max(updates, warm + 1), 0.1 * lr)
        return lr

    def _grids_for(self, n_teacher: int):
        if n_teacher not in self._grids:
            self._grids[n_teacher] = nested_grids(self.pipeline.coeffs, n_teacher)
        return self._grids[n_teacher]

    def stage_loss(self, student: torch.nn.Module, teacher: torch.nn.Module, batch,
                   n_teacher: int, j: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One update's loss (differentiable in the student): the mean over
        the batch of the weight times the squared distance of the student's
        x0 prediction at student index j from the teacher's target. ``j``
        (uniform in [0, n_teacher/2)) and ``noise`` are drawn from
        ``generator``, in that order, unless given."""
        pipe = self.pipeline
        c_teacher, c_student = self._grids_for(n_teacher)
        batch = pipe.batch_to_device(batch)
        data, labels = batch["data"], batch["labels"]
        if j is None:
            j = torch.randint(0, n_teacher // 2, (data.shape[0],), generator=generator,
                              device=pipe.device)
        if noise is None:
            noise = torch.randn(data.shape, generator=generator, device=pipe.device,
                                dtype=data.dtype)
        j, noise = j.to(pipe.device), noise.to(pipe.device)
        x_t = q_sample(c_student, data, j, noise)
        teacher.eval()
        x0_target = distill_targets(c_teacher, c_student, _model_fn(teacher, labels), x_t, j,
                                    pipe.model_mean_type, pipe.model_var_type,
                                    clip_denoised=self.clip_teacher,
                                    thresholding_percentile=pipe.thresholding_percentile)
        student.train()
        out = p_mean_variance(c_student, _model_fn(student, labels), x_t, j,
                              pipe.model_mean_type, pipe.model_var_type, clip_denoised=False)
        w = (truncated_snr_weight(c_student, j, data.ndim)
             if self.loss_weight == "truncated_snr" else 1.0)
        return torch.mean(w * (out["pred_xstart"] - x0_target) ** 2)

    def distill_stage(self, teacher: torch.nn.Module, batches, n_teacher: int, updates: int,
                      generator: Optional[torch.Generator] = None,
                      init: Optional[torch.nn.Module] = None, log_fn: Optional[Callable] = None,
                      draws: Optional[Callable] = None):
        """One halving: returns (student, losses). The student is a copy of
        ``init`` (default: the teacher) trained ``updates`` times on a
        frozen copy of the teacher. ``batches`` is a callable
        ``(update_idx) -> batch`` or an iterable cycled over; ``draws``, if
        given, ``(n_teacher, update_idx) -> (j, noise)``."""
        if updates < 1:
            raise ValueError(f"updates must be >= 1, got {updates}")
        frozen = copy.deepcopy(teacher).eval().requires_grad_(False)
        student = copy.deepcopy(init if init is not None else teacher).requires_grad_(True)
        opt = build_optimizer(self._optimizer, {k: v for k, v in self._opt_kwargs.items()
                                                if k not in ("lr", "learning_rate")},
                              learning_rate=self.learning_rate(updates))
        optim = opt.make(student.parameters())
        get = batches if callable(batches) else _cycler(batches)
        losses = []
        for i in range(updates):
            j, noise = draws(n_teacher, i) if draws is not None else (None, None)
            loss = self.stage_loss(student, frozen, get(i), n_teacher, j=j, noise=noise,
                                   generator=generator)
            optim.zero_grad(set_to_none=True)
            loss.backward()
            opt.set_lr(optim, i)
            optim.step()
            losses.append(loss.detach())
        losses = [float(x) for x in losses]
        if log_fn is not None:
            log_fn({"stage": f"{n_teacher}->{n_teacher // 2}", "loss_first": losses[0],
                    "loss_last": losses[-1]})
        return student.eval(), losses

    def distill(self, teacher: torch.nn.Module, batches, from_steps: int, to_steps: int,
                updates_per_stage: int, generator: Optional[torch.Generator] = None,
                log_fn: Optional[Callable] = None, draws: Optional[Callable] = None):
        """The halvings ``from_steps -> ... -> to_steps``: returns the final
        student and each stage's losses. Sample it with ``sample``: the
        trailing grid it was trained on."""
        ratio = from_steps // max(to_steps, 1)
        if (from_steps < to_steps or from_steps != to_steps * ratio
                or ratio & (ratio - 1)):  # a power of two, or the halvings miss it
            raise ValueError(
                f"from_steps={from_steps} must be a 2^k multiple of to_steps={to_steps}")
        if generator is None:
            generator = torch.Generator(device=self.pipeline.device).manual_seed(0)
        n, model, info = from_steps, teacher, {}
        while n > to_steps:
            model, losses = self.distill_stage(model, batches, n, updates_per_stage, generator,
                                               log_fn=log_fn, draws=draws)
            info[f"{n}->{n // 2}"] = losses
            n //= 2
        return model, info

    @torch.no_grad()
    def sample(self, model: torch.nn.Module, shape, n_steps: int, conditions=None,
               guidance_scale: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Deterministic DDIM over the trailing n-step grid the student was
        distilled on (n model calls), through the pipeline's model call
        with ``model`` as its backbone (classifier-free guided when
        ``guidance_scale`` != 1). x_T is drawn from ``generator`` unless
        given."""
        pipe = self.pipeline
        own = pipe.backbone
        pipe.backbone = model
        try:
            return sample_loop(distilled_coefficients(pipe.coeffs, n_steps),
                               pipe._model_fn(conditions, guidance_scale=guidance_scale),
                               shape, generator, pipe.model_mean_type, pipe.model_var_type,
                               sampler="ddim", eta=0.0, clip_denoised=pipe.clip_denoised,
                               thresholding_percentile=pipe.thresholding_percentile, x_T=x_T)
        finally:
            pipe.backbone = own


def _cycler(batches):
    batches = list(batches)
    if not batches:
        raise ValueError("batches is empty: pass a non-empty iterable "
                         "or a callable (update_idx) -> batch")

    def get(i):
        return batches[i % len(batches)]

    return get
