"""Datasets of the port (host-side numpy producers) and their loading."""
from rho_diffusion_tpu_torch.data.base import AbstractDataset, Density, MultiVariateDataset, UnivariateDataset  # noqa: F401
from rho_diffusion_tpu_torch.data.deep_galaxy import DeepGalaxyDataset  # noqa: F401
from rho_diffusion_tpu_torch.data.loader import DataLoader, prefetch, prefetch_to_device  # noqa: F401
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace  # noqa: F401
from rho_diffusion_tpu_torch.data.spectroscopy import SpectroscopyDataset  # noqa: F401
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset, compute_spherical_harmonic  # noqa: F401
from rho_diffusion_tpu_torch.data.wrappers import CIFAR10Dataset, MNISTDataset  # noqa: F401
