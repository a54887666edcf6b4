"""Backbones of the port (UNetv2, the simple UNet, the ViT, UNet_Diffuser)
and their conditioning modules."""
from rho_diffusion_tpu_torch.models.conditioning import (  # noqa: F401
    ClassifierGuidance,
    FourierConditioning,
    MultiEmbeddings,
    classifier_grad_fn,
)
from rho_diffusion_tpu_torch.models.unet import UNet  # noqa: F401
from rho_diffusion_tpu_torch.models.unet_diffusers_compat import UNetDiffuser  # noqa: F401
from rho_diffusion_tpu_torch.models.unet_simple import SimpleUNet, UNetBlock  # noqa: F401
from rho_diffusion_tpu_torch.models.vit import VisionTransformer, ViTBlock  # noqa: F401
