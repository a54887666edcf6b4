"""Diffusion pipelines of the port (DDPM; GaussianDiffusion sampling with
DDIM, respacing and the registered solvers) and noise schedules."""
from rho_diffusion_tpu_torch.diffusion.base import AbstractDiffusionPipeline, extract  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step, q_sample  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.gaussian import (  # noqa: F401
    GaussianCoefficients,
    GaussianDiffusionPipeline,
    LossType,
    ModelMeanType,
    ModelVarType,
    coefficients_from_schedule,
    dynamic_threshold,
    respace,
    respace_subset,
    sample_loop,
)
from rho_diffusion_tpu_torch.diffusion.schedule import (  # noqa: F401
    CosineBetaSchedule,
    LinearSchedule,
    NoiseSchedule,
    SigmoidSchedule,
    named_beta_schedule,
)
