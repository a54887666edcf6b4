"""Positional / timestep embeddings: the interleaved sinusoidal embedding of
``rho_diffusion_tpu/ops/embeddings.py`` (even indices sin(t / omega_i), odd
indices cos(t / omega_i), omega_i = wavelength^(2i/dim))."""
from __future__ import annotations

import torch

from rho_diffusion_tpu_torch.registry import registry


def sinusoidal_position_embedding(
    t: torch.Tensor, dim: int, wavelength: float = 10000.0,
) -> torch.Tensor:
    """Interleaved sin/cos timestep embedding, shape [len(t), dim], float32."""
    assert dim % 2 == 0, "`dim` must be divisible by 2"
    i = torch.arange(dim // 2, dtype=torch.float32, device=t.device)
    omega = torch.pow(torch.tensor(wavelength, dtype=torch.float32, device=t.device), 2.0 * i / dim)
    args = t.to(torch.float32)[:, None] / omega[None, :]
    pe = torch.stack([torch.sin(args), torch.cos(args)], dim=-1)
    return pe.reshape(t.shape[0], dim)


class SinusoidalPositionEmbedding:
    """Module-style wrapper registered under the reference's layer name."""

    def __init__(self, dim: int, wavelength: float = 10000.0) -> None:
        self.dim = dim
        self.wavelength = wavelength

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return sinusoidal_position_embedding(t, self.dim, self.wavelength)


registry.add("layers", "SinusoidalPositionEmbedding", SinusoidalPositionEmbedding)
