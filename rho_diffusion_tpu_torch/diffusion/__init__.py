"""Diffusion pipelines of the port (DDPM; GaussianDiffusion with its
training losses, sampling with DDIM, respacing and the registered solvers,
inpainting, encoding and bits-per-dim; its diffusers-named subclass;
progressive distillation) and noise schedules."""
from rho_diffusion_tpu_torch.diffusion.base import AbstractDiffusionPipeline, extract  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step, q_sample  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.diffusers_compat import DiffusersDDPMPipeline  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.distill import (  # noqa: F401
    ProgressiveDistiller,
    distill_grid,
    distilled_coefficients,
)
from rho_diffusion_tpu_torch.diffusion.gaussian import (  # noqa: F401
    GaussianCoefficients,
    GaussianDiffusionPipeline,
    LossType,
    ModelMeanType,
    ModelVarType,
    calc_bpd_loop,
    coefficients_from_schedule,
    dynamic_threshold,
    encode_loop,
    respace,
    respace_subset,
    sample_loop,
    training_losses,
)
from rho_diffusion_tpu_torch.diffusion.schedule import (  # noqa: F401
    CosineBetaSchedule,
    LinearSchedule,
    NoiseSchedule,
    SigmoidSchedule,
    named_beta_schedule,
)
