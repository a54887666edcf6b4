"""Losses and training metrics of the port."""
from rho_diffusion_tpu_torch.metrics.losses import psnr, resolve_loss  # noqa: F401
