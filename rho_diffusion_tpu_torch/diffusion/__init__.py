"""Diffusion pipelines of the port (DDPM sampling) and noise schedules."""
from rho_diffusion_tpu_torch.diffusion.base import AbstractDiffusionPipeline, extract  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step, q_sample  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.schedule import (  # noqa: F401
    CosineBetaSchedule,
    LinearSchedule,
    NoiseSchedule,
    SigmoidSchedule,
    named_beta_schedule,
)
