"""rho_diffusion_tpu_torch — the PyTorch/CUDA port of rho_diffusion_tpu.

A second package beside the JAX one, held against it by the tests: the same
JSON configs, registry names and numerics, with the JAX package's Pallas TPU
kernels replaced by hand-written CUDA kernels for Hopper (``csrc/``, built at
first use). It imports torch and never jax or the JAX package.

Importing the package populates the registry with every ported component.
"""
from __future__ import annotations

from rho_diffusion_tpu_torch.registry import registry  # noqa: F401

# importing these modules registers their components
from rho_diffusion_tpu_torch.ops import activations as _activations  # noqa: F401
from rho_diffusion_tpu_torch.ops import embeddings as _embeddings  # noqa: F401
from rho_diffusion_tpu_torch.diffusion import schedule as _schedule  # noqa: F401
from rho_diffusion_tpu_torch.models import conditioning as _conditioning  # noqa: F401
from rho_diffusion_tpu_torch.models import unet as _unet  # noqa: F401
from rho_diffusion_tpu_torch.data import synthetic as _synthetic  # noqa: F401

from rho_diffusion_tpu_torch.config import ExperimentConfig  # noqa: F401
from rho_diffusion_tpu_torch.diffusion.ddpm import DDPM, ddpm_reverse_step, q_sample  # noqa: F401
from rho_diffusion_tpu_torch.models.unet import UNet  # noqa: F401
