"""The simple baseline UNet ("UNet" v1), registered as ``models/UNet``.

Port of ``rho_diffusion_tpu/models/unet_simple.py``, channels-last and
dims-generic, with the same numerics:

* every block runs at full spatial resolution (all convs stride 1: the
  reference changes only channels, never space);
* a block is conv -> act -> conv -> act, plus an optional residual conv of
  the block's input, an additive time-embedding readout (Dense(time_dim ->
  C)) broadcast over every spatial dim, then flax's GroupNorm with min(8, C)
  groups in fp32 (eps 1e-6, not ``GroupNorm32``'s 32 groups) and the
  activation;
* the down path keeps each block's output as a skip; the up path takes
  concat([h, skip]);
* the output is a Dense to the data's channels (no conv, no zero init), in
  fp32; no attention, no conditioning (``y`` is ignored).

Its stride-1 3x3(x3) convs are the port's ``ConvNd``, so in 3-D they take
the hand-written conv kernel (K5) by ``conv_route``. The up path's second
conv is a flax ``ConvTranspose`` at stride 1 'SAME' with
``transpose_kernel=False``: ``lax.conv_transpose`` then pads (ceil((k-1)/2),
floor((k-1)/2)) and correlates with the stored kernel, unflipped, so it is
the same-resolution conv ``ConvTransposeSame`` (K5 too in 3-D). Under int8
it stays float, as JAX's ``ops/quant.py`` hooks ``conv_nd`` and not
``nn.ConvTranspose``; the Dense sites stay float as well.

Parameters are named after the JAX tree (``input_conv``, ``down_{i}.conv1``,
``up_{i}.conv2``, ``down_{i}.norm``, ``output_conv``, ...), so
``interop.jax_weights`` carries a JAX param tree across by name.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rho_diffusion_tpu_torch.interop.jax_weights import export_named_state_dict
from rho_diffusion_tpu_torch.models.unet import as_torch_dtype
from rho_diffusion_tpu_torch.ops.activations import resolve_activation
from rho_diffusion_tpu_torch.ops.convolution import ConvNd, Linear, compute_dtype, reset_parameters
from rho_diffusion_tpu_torch.ops.embeddings import sinusoidal_position_embedding
from rho_diffusion_tpu_torch.ops.norm import FlaxGroupNorm
from rho_diffusion_tpu_torch.registry import registry


class ConvTransposeSame(ConvNd):
    """flax ``ConvTranspose`` at stride 1, padding 'SAME',
    ``transpose_kernel=False``: a same-resolution correlation with the stored
    kernel [O, I, *K] and ``lax.conv_transpose``'s padding. Float under int8."""

    def __init__(self, dims: int, in_channels: int, out_channels: int, kernel_size: int = 3,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(dims, in_channels, out_channels, kernel_size, dtype=dtype)

    def _pads(self) -> list[tuple[int, int]]:
        k = self.kernel_size
        lo = 0 if k == 1 else math.ceil((k - 1) / 2)
        return [(lo, k - 1 - lo)] * self.dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.dtype, x)
        return self.conv_float(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class UNetBlock(nn.Module):
    """Two-conv block with an additive time embedding (reference
    AbstractUNetBlock)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        dims: int,
        time_dim: int,
        is_up: bool = False,
        kernel_size: int = 3,
        groups: int = 8,
        activation: Any = "GELU",
        residual: bool = False,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        self.dims = dims
        self.act = resolve_activation(activation)
        self.conv1 = ConvNd(dims, in_channels, out_channels, kernel_size, dtype=dtype)
        conv2 = ConvTransposeSame if is_up else ConvNd
        self.conv2 = conv2(dims, out_channels, out_channels, kernel_size, dtype=dtype)
        self.residual_conv = (ConvNd(dims, in_channels, out_channels, kernel_size, dtype=dtype)
                              if residual else None)
        self.time_readout = Linear(time_dim, out_channels, dtype=dtype)
        self.norm = FlaxGroupNorm(out_channels, min(groups, out_channels)) if groups else None

    def forward(self, x: torch.Tensor, time_pe: torch.Tensor) -> torch.Tensor:
        act = self.act
        h = act(self.conv2(act(self.conv1(x))))
        if self.residual_conv is not None:
            h = h + self.residual_conv(x)
        t_out = self.time_readout(time_pe)
        h = h + t_out.reshape(t_out.shape[0], *(1,) * self.dims, -1).to(h.dtype)
        if self.norm is not None:
            h = self.norm(h.float()).to(x.dtype)
        return act(h)


registry.add("layers", "UNetBlock2d", UNetBlock)
registry.add("layers", "UNetBlock3d", UNetBlock)


@registry.register_model("UNet")
class SimpleUNet(nn.Module):
    """Baseline UNet, kwargs-compatible with the reference "UNet"."""

    def __init__(
        self,
        input_channels: int,
        block_type: str = "UNetBlock2d",
        down_channels: Sequence[int] = (64, 128, 256),
        up_channels: Sequence[int] = (256, 128, 64),
        time_embedding_dim: int = 32,
        kernel_size: int = 3,
        padding: int = 1,  # accepted for parity; SAME padding is used
        activation: Any = "ReLU",
        residual: bool = True,
        dims: Optional[int] = None,
        dtype: Any = torch.float32,
    ) -> None:
        super().__init__()
        self.dims = dims or (3 if "3d" in str(block_type) else 2)
        self.time_embedding_dim = time_embedding_dim
        cd = self.compute_dtype = as_torch_dtype(dtype)
        d = self.dims
        self.time_mlp = Linear(time_embedding_dim, time_embedding_dim)
        self.input_conv = ConvNd(d, input_channels, down_channels[0], 3, dtype=cd)

        def block(cin, cout, is_up):
            return UNetBlock(cin, cout, d, time_embedding_dim, is_up=is_up,
                             kernel_size=kernel_size, activation=activation, residual=residual,
                             dtype=cd)

        self.num_down = len(down_channels) - 1
        self.num_up = len(up_channels) - 1
        for i in range(self.num_down):
            self.add_module(f"down_{i}", block(down_channels[i], down_channels[i + 1], False))
        skips = list(down_channels[1:])
        ch = down_channels[-1]
        for i in range(self.num_up):
            self.add_module(f"up_{i}", block(ch + skips.pop(), up_channels[i + 1], True))
            ch = up_channels[i + 1]
        self.output_conv = Linear(ch, input_channels)

    @staticmethod
    def state_dict_from_jax(params: dict) -> dict[str, np.ndarray]:
        """A JAX param tree of this model as its ``state_dict``: the modules
        are named after the tree (the stride-1 ``ConvTranspose`` is an
        unflipped correlation)."""
        return export_named_state_dict(params)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "SimpleUNet":
        """flax's initialisers: LeCun-normal kernels, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, (ConvNd, Linear)):
                reset_parameters(m, generator)
            elif isinstance(m, FlaxGroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, *spatial, C], timesteps: [B] -> [B, *spatial, C] fp32; ``y``
        is ignored (the baseline UNet is unconditional)."""
        time_pe = self.time_mlp(sinusoidal_position_embedding(timesteps, self.time_embedding_dim))
        h = self.input_conv(x.to(self.compute_dtype))
        skips = []
        for i in range(self.num_down):
            h = getattr(self, f"down_{i}")(h, time_pe)
            skips.append(h)
        for i in range(self.num_up):
            h = getattr(self, f"up_{i}")(torch.cat([h, skips.pop()], dim=-1), time_pe)
        return self.output_conv(h.float())
