"""Activation functions, registered by the names the configs use.

Each registered name is a zero-arg factory returning a tensor function, as in
``rho_diffusion_tpu/ops/activations.py``. The functions follow the JAX
package's definitions where PyTorch's default differs: ``GELU`` is the tanh
approximation (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

import inspect

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.registry import registry


def symmetric_log(x: torch.Tensor) -> torch.Tensor:
    """SymmetricLog activation (arXiv:2111.15631):
    tanh(x) + tanh(x) * log(x * tanh(x) + 1)."""
    tx = torch.tanh(x)
    return tx + tx * torch.log1p(x * tx)


_ACTIVATIONS = {
    "ReLU": F.relu,
    "ReLU6": F.relu6,
    "SiLU": F.silu,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "ELU": F.elu,
    "CELU": F.celu,
    "SELU": F.selu,
    "Softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "Mish": lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x))),
    "Hardswish": F.hardswish,
    "Hardtanh": F.hardtanh,
    "Identity": lambda x: x,
    "SymmetricLog": symmetric_log,
}


def _make_factory(fn):
    def factory():
        return fn

    return factory


for _name, _fn in _ACTIVATIONS.items():
    _factory = _make_factory(_fn)
    _factory.__name__ = _name
    registry.add("activations", _name, _factory)


def resolve_activation(activation) -> callable:
    """Accept a registry name, a factory, or a tensor function and return
    the tensor function."""
    if isinstance(activation, str):
        activation = registry.get("activations", activation)
    if activation in _ACTIVATIONS.values():
        return activation
    try:
        takes_args = len(inspect.signature(activation).parameters) >= 1
    except (TypeError, ValueError):
        takes_args = True
    return activation if takes_args else activation()
