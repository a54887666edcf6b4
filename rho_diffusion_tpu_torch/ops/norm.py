"""Normalisation layers on channels-last tensors.

Port of ``GroupNorm32`` (``rho_diffusion_tpu/ops/norm.py``): statistics and
the normalisation run in fp32 whatever the input dtype, the affine scale and
bias are fp32, and the output is cast back to the input dtype. The group
count falls back to the largest divisor of the channel count that is at most
32, which ``nn.GroupNorm(32, C)`` does not do. Parameters are named
``weight``/``bias`` as in the reference torch UNet's ``state_dict``.

``RMSNorm`` is JAX's; ``LayerNorm`` and ``FlaxGroupNorm`` give flax's numbers
for the ViT and the SimpleUNet (eps 1e-6, the fast variance), which
``torch.nn``'s layers do not.
"""
from __future__ import annotations

import torch
from torch import nn


def num_groups_for(channels: int, num_groups: int = 32) -> int:
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm32(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5) -> None:
        super().__init__()
        self.channels = channels
        self.num_groups = num_groups_for(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, *spatial, C] -> same shape and dtype."""
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xg = x.reshape(b, -1, g, c // g).float()
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = xg.square().mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        out = ((xg - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (out * self.weight.float() + self.bias.float()).to(x.dtype)

    def extra_repr(self) -> str:
        return f"{self.channels}, groups={self.num_groups}, eps={self.eps}"


def _flax_normalize(xf: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, eps: float,
                    weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """flax's ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    return (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias


def _fast_stats(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """flax's fast variance: mean(x^2) - mean(x)^2, clipped at zero."""
    mean = xf.mean(dim=dims, keepdim=True)
    var = torch.clamp(xf.square().mean(dim=dims, keepdim=True) - mean.square(), min=0.0)
    return mean, var


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)`` over the last axis: eps 1e-6 (torch's
    default is 1e-5), the fast variance, statistics and output in fp32 (the
    caller casts back)."""

    def __init__(self, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean, var = _fast_stats(xf, -1)
        return _flax_normalize(xf, mean, var, self.eps, self.weight, self.bias)


class FlaxGroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` on channels-last [B, *spatial, C]: eps 1e-6, the
    fast variance, statistics in fp32 over the spatial axes and each group's
    channels; the output is fp32 (the caller casts back). Unlike
    ``GroupNorm32`` the group count must divide the channels."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6) -> None:
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{num_groups} groups do not divide {channels} channels")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        g = self.num_groups
        xf = x.float()
        mean, var = _fast_stats(xf.reshape(b, -1, g, c // g), (1, 3))
        shape = (b, *(1,) * (x.ndim - 2), c)
        mean = mean.repeat_interleave(c // g, dim=2).reshape(shape)
        var = var.repeat_interleave(c // g, dim=2).reshape(shape)
        return _flax_normalize(xf, mean, var, self.eps, self.weight, self.bias)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the channel axis (JAX ``ops/norm.py``
    ``RMSNorm``, the standard form of Zhang & Sennrich 2019): normalised in
    fp32 with eps 1e-6, one ``weight`` (JAX's ``scale``), cast back to the
    input dtype."""

    def __init__(self, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        ms = h.square().mean(dim=-1, keepdim=True)
        h = h * torch.reciprocal(torch.sqrt(ms + self.eps))
        return (h * self.weight).to(x.dtype)
