"""Physics-parameter conditioning and classifier guidance (port of
``rho_diffusion_tpu/models/conditioning.py``).

* ``MultiEmbeddings`` (JAX :52-97): one embedding table per parameter-space
  dimension; a batch of raw parameter rows is mapped to per-dimension
  categorical indices by value equality against the parameter space
  (unmatched values resolve to index 0), and the per-dimension embedding
  vectors are summed. The tables live in ``embedding_layers.<name>`` as in
  the reference torch module.
* ``FourierConditioning`` (JAX :101-168): each column min-max normalised with
  the static bounds of its admissible values, encoded as ``[x, sin 2 pi k x,
  cos 2 pi k x]`` for k = 1..n_frequencies, then Dense -> SiLU -> Dense
  (``mlp_in``, ``mlp_out``), in fp32.
* ``classifier_grad_fn`` (JAX :24-48) and ``ClassifierGuidance`` (:172-197):
  the ``cond_grad_fn`` of classifier guidance, ``scale * grad_x sum_i
  log_softmax(c(x, t))[i, y_i]``, which ``diffusion.gaussian``'s
  ``condition_mean``/``condition_score`` consume. Sampling runs under
  ``torch.no_grad``, so the hook turns grad on around the classifier and
  differentiates x alone: no parameter of the classifier or the backbone
  collects a gradient.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from rho_diffusion_tpu_torch.ops.convolution import Linear, reset_parameters
from rho_diffusion_tpu_torch.registry import registry


def classifier_grad_fn(classifier_apply: Callable, y: torch.Tensor,
                       scale: float = 1.0) -> Callable:
    """``grad_fn(x, t) = scale * grad_x log p(y | x, t)`` for integer targets
    ``y`` [B], where ``classifier_apply(x, t)`` gives logits [B, classes]."""

    def grad_fn(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            x_in = x.detach().requires_grad_(True)
            logp = F.log_softmax(classifier_apply(x_in, t), dim=-1)
            total = torch.sum(torch.gather(logp, -1, y.long()[:, None]))
            (grad,) = torch.autograd.grad(total, x_in)
        return scale * grad

    return grad_fn


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


@registry.register_layer("FourierConditioning")
class FourierConditioning(nn.Module):
    """Continuous Fourier-feature conditioning over raw parameter rows, a
    drop-in for ``MultiEmbeddings`` (same constructor kwargs, same config
    seam ``model.kwargs.cond_fn``). Values outside a column's [min, max]
    extrapolate in feature space."""

    def __init__(self, parameter_space: Any, embedding_dim: int = 512,
                 n_frequencies: int = 6) -> None:
        super().__init__()
        self.parameter_space = parameter_space
        self.embedding_dim = embedding_dim
        self.n_frequencies = n_frequencies
        self.space_items = space_items(parameter_space)
        width = len(self.space_items) * (1 + 2 * n_frequencies)
        self.mlp_in = Linear(width, embedding_dim)
        self.mlp_out = Linear(embedding_dim, embedding_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """flax ``nn.Dense``'s defaults: LeCun-normal kernels, zero biases."""
        reset_parameters(self.mlp_in, generator)
        reset_parameters(self.mlp_out, generator)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        k = torch.arange(1, self.n_frequencies + 1, dtype=torch.float32, device=y.device)
        feats = []
        for i, (_, values) in enumerate(self.space_items):
            yi = (y if y.ndim == 1 else y[:, i]).float()
            lo, hi = float(min(values)), float(max(values))
            x01 = (yi - lo) / max(hi - lo, 1e-12)
            ang = 2.0 * math.pi * x01[:, None] * k[None, :]
            feats.append(torch.cat([x01[:, None], torch.sin(ang), torch.cos(ang)], dim=-1))
        h = F.silu(self.mlp_in(torch.cat(feats, dim=-1)))
        return self.mlp_out(h)


@registry.register_layer("ClassifierGuidance")
class ClassifierGuidance(nn.Module):
    """Classifier-guidance hook: carries a classifier apply function and a
    scale; ``grad_fn(y)`` is the ``cond_grad_fn`` to pass to
    ``reverse_process``. It is not an embedding: calling it raises, and the
    pipelines refuse it as a model's ``cond_fn``."""

    def __init__(self, classifier: Callable | None = None, guidance_scale: float = 1.0) -> None:
        super().__init__()
        self.classifier = classifier
        self.guidance_scale = guidance_scale

    def grad_fn(self, y: torch.Tensor) -> Callable:
        assert self.classifier is not None, "attach a classifier apply fn"
        return classifier_grad_fn(self.classifier, y, self.guidance_scale)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(
            "ClassifierGuidance is applied at sampling time via "
            "GaussianDiffusion.condition_mean/condition_score (build the hook with "
            ".grad_fn(y)), not as an embedding cond_fn.",
        )
