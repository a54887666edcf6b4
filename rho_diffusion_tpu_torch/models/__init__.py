"""Backbones of the port (UNetv2) and its conditioning modules."""
from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings  # noqa: F401
from rho_diffusion_tpu_torch.models.unet import UNet  # noqa: F401
