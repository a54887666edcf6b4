"""GroupNorm with float32 statistics on channels-last tensors.

Port of ``GroupNorm32`` (``rho_diffusion_tpu/ops/norm.py``): statistics and
the normalisation run in fp32 whatever the input dtype, the affine scale and
bias are fp32, and the output is cast back to the input dtype. The group
count falls back to the largest divisor of the channel count that is at most
32, which ``nn.GroupNorm(32, C)`` does not do. Parameters are named
``weight``/``bias`` as in the reference torch UNet's ``state_dict``.
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
