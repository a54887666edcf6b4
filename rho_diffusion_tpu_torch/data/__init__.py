"""Datasets of the port (host-side numpy producers)."""
from rho_diffusion_tpu_torch.data.parameter_space import DiscreteParameterSpace  # noqa: F401
from rho_diffusion_tpu_torch.data.synthetic import SphericalHarmonicDataset  # noqa: F401
