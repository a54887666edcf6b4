"""Physics-parameter conditioning (port of ``MultiEmbeddings``,
``rho_diffusion_tpu/models/conditioning.py:52-97``).

One embedding table per parameter-space dimension; a batch of raw parameter
rows is mapped to per-dimension categorical indices by value equality against
the parameter space (unmatched values resolve to index 0), and the
per-dimension embedding vectors are summed. The tables live in
``embedding_layers.<name>`` as in the reference torch module.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from rho_diffusion_tpu_torch.registry import registry


def space_items(space: Any) -> list[tuple[str, tuple]]:
    if hasattr(space, "parameters"):  # DiscreteParameterSpace
        space = space.parameters
    if not isinstance(space, Mapping):
        raise TypeError("parameter_space must be a mapping or DiscreteParameterSpace")
    return [(k, tuple(v)) for k, v in space.items()]


@registry.register_layer("MultiEmbeddings")
class MultiEmbeddings(nn.Module):
    """Sum of per-parameter embeddings over a discrete parameter space."""

    def __init__(self, parameter_space: Any, embedding_dim: int = 512) -> None:
        super().__init__()
        self.parameter_space = parameter_space
        self.embedding_dim = embedding_dim
        self.space_items = space_items(parameter_space)
        self.embedding_layers = nn.ModuleDict({
            key: nn.Embedding(len(values), embedding_dim) for key, values in self.space_items
        })
        for key, values in self.space_items:
            self.register_buffer(
                f"values_{key}", torch.tensor(values, dtype=torch.float32), persistent=False,
            )
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax ``nn.Embed``'s default: normal with std 1/sqrt(embedding_dim)."""
        for layer in self.embedding_layers.values():
            layer.weight.normal_(0.0, self.embedding_dim ** -0.5, generator=generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        emb = None
        for i, (key, _) in enumerate(self.space_items):
            yi = (y if y.ndim == 1 else y[:, i]).float()
            table = getattr(self, f"values_{key}")
            categorical = torch.argmax((yi[:, None] == table[None, :]).to(torch.int32), dim=-1)
            e = self.embedding_layers[key](categorical)
            emb = e if emb is None else emb + e
        return emb
