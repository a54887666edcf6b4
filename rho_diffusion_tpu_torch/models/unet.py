"""The n-dimensional diffusion UNet backbone (flagship model), "UNetv2".

Port of ``rho_diffusion_tpu/models/unet.py`` with the same flags and the same
numerics, laid out as ``nn.Module``s whose ``state_dict`` names and shapes are
those of the reference torch UNetv2 (``time_embed``, ``input_blocks``,
``middle_block``, ``output_blocks``, ``out``, ``cond_fn``), so a reference
``model.pth`` loads with ``load_state_dict(strict=True)`` and JAX parameters
arrive through ``interop.jax_weights``.

Activations are channels-last [B, *spatial, C]. Parameters stay fp32 and are
cast to the compute dtype at use (bf16 on the flagship); GroupNorm statistics
and the attention softmax stay fp32; the time MLP runs in fp32; the output
head runs in fp32.

``use_checkpoint`` recomputes each ResBlock's and AttentionBlock's forward
in the backward (``torch.utils.checkpoint``, non-reentrant) while the model
trains under grad, where the JAX package wraps the same two blocks in
``nn.remat``: their activations are not kept between the forward and the
backward. The state_dict does not depend on it, and the recompute draws the
same dropout masks (checkpoint restores the global CPU and CUDA random
state, which ``nn.Dropout`` draws from).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rho_diffusion_tpu_torch.models.conditioning import MultiEmbeddings
from rho_diffusion_tpu_torch.ops.activations import resolve_activation
from rho_diffusion_tpu_torch.ops.attention import attention
from rho_diffusion_tpu_torch.ops.convolution import (
    Conv1x1,
    ConvNd,
    Downsample,
    Linear,
    Upsample,
    avg_pool_nd,
    resample_factors,
    reset_parameters,
    upsample_nearest,
)
from rho_diffusion_tpu_torch.ops.embeddings import sinusoidal_position_embedding
from rho_diffusion_tpu_torch.ops.norm import GroupNorm32
from rho_diffusion_tpu_torch.registry import registry

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def as_torch_dtype(dtype: Any) -> torch.dtype:
    """A torch dtype from a torch dtype or a config string ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[str(dtype)]


class Activation(nn.Module):
    def __init__(self, fn: Callable) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class Recomputable(nn.Module):
    """A block whose ``block`` forward is recomputed in the backward when
    ``use_checkpoint`` is set and the model trains under grad."""

    use_checkpoint = False

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        if self.use_checkpoint and self.training and torch.is_grad_enabled():
            return checkpoint(self.block, *args, use_reentrant=False)
        return self.block(*args)


class ResBlock(Recomputable):
    """Residual block with timestep-embedding conditioning."""

    def __init__(
        self,
        channels: int,
        emb_channels: int,
        out_channels: int,
        dims: int,
        dropout: float = 0.0,
        use_conv_skip: bool = False,
        use_scale_shift_norm: bool = False,
        up: bool = False,
        down: bool = False,
        activation: Callable = torch.nn.functional.silu,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        self.dims = dims
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.act = activation
        self.in_layers = nn.Sequential(
            GroupNorm32(channels), Activation(activation),
            ConvNd(dims, channels, out_channels, 3, dtype=dtype),
        )
        self.emb_layers = nn.Sequential(
            Activation(activation),
            Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels,
                   dtype=dtype),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(out_channels), Activation(activation), nn.Dropout(dropout),
            ConvNd(dims, out_channels, out_channels, 3, dtype=dtype, zero_init=True),
        )
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        elif use_conv_skip:
            self.skip_connection = ConvNd(dims, channels, out_channels, 3, dtype=dtype)
        else:
            self.skip_connection = Conv1x1(channels, out_channels, dims, dtype=dtype)

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            return upsample_nearest(x, self.dims)
        if self.down:
            return avg_pool_nd(x, self.dims, resample_factors(self.dims))
        return x

    def block(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        norm_in, _, conv_in = self.in_layers
        h = self.act(norm_in(x))
        h, x = self._resample(h), self._resample(x)
        h = conv_in(h)
        emb_out = self.emb_layers(emb)
        emb_out = emb_out.reshape(emb_out.shape[0], *(1,) * self.dims, emb_out.shape[-1]).to(h.dtype)
        norm_out, _, dropout, conv_out = self.out_layers
        if self.use_scale_shift_norm:
            scale, shift = torch.chunk(emb_out, 2, dim=-1)
            h = norm_out(h) * (1.0 + scale) + shift
        else:
            h = norm_out(h + emb_out)
        h = conv_out(dropout(self.act(h)))
        return self.skip_connection(x) + h


class AttentionBlock(Recomputable):
    """Self-attention over all flattened spatial positions. The qkv channel
    order is the reference's legacy per-head [q|k|v] blocks, or [q|k|v]
    thirds with ``use_new_attention_order``."""

    def __init__(
        self,
        channels: int,
        num_heads: int = 1,
        num_head_channels: int = -1,
        use_new_attention_order: bool = False,
        backend: str = "auto",
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        super().__init__()
        if num_head_channels == -1:
            self.heads = num_heads
        else:
            assert channels % num_head_channels == 0, (
                f"channels {channels} not divisible by num_head_channels {num_head_channels}"
            )
            self.heads = channels // num_head_channels
        assert channels % self.heads == 0
        self.new_order = use_new_attention_order
        self.backend = backend
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1x1(channels, 3 * channels, 1, dtype=dtype)
        self.proj_out = Conv1x1(channels, channels, 1, dtype=dtype, zero_init=True)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        b, *spatial, c = x.shape
        tokens = x.shape[1:-1].numel()
        hd = c // self.heads
        qkv = self.qkv(self.norm(x.reshape(b, tokens, c)))
        if self.new_order:
            q, k, v = qkv.reshape(b, tokens, 3, self.heads, hd).unbind(2)
        else:
            q, k, v = qkv.reshape(b, tokens, self.heads, 3 * hd).split(hd, dim=-1)
        a = attention(q, k, v, backend=self.backend).reshape(b, tokens, c)
        return x + self.proj_out(a).reshape(b, *spatial, c)


class TimestepEmbedSequential(nn.Sequential):
    """Passes the timestep embedding to the ResBlocks among its layers."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


@registry.register_model("UNetv2")
class UNet(nn.Module):
    """n-dimensional UNet with attention, timestep embedding and
    parameter-space conditioning; config kwargs match the "UNetv2" JSON
    surface. A 3-D UNet runs on depth slabs under spatial sharding
    (``parallel.spatial``): its resampling leaves the depth alone."""

    @property
    def supports_spatial_sharding(self) -> bool:
        return self.dims == 3

    def __init__(
        self,
        data_shape: Sequence[int],
        in_channels: int,
        model_channels: int,
        out_channels: int,
        num_res_blocks: int,
        attention_resolutions: Sequence[int] = (16, 8),
        dropout: float = 0.0,
        channel_mult: Sequence[int] = (1, 2, 4, 8),
        conv_resample: bool = True,
        dims: int = 2,
        num_classes: Optional[int] = None,
        cond_fn: Optional[nn.Module] = None,
        use_checkpoint: bool = False,
        use_fp16: bool = False,
        num_heads: int = 1,
        num_head_channels: int = -1,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = False,
        resblock_updown: bool = False,
        use_new_attention_order: bool = False,
        activation: Any = "SiLU",
        attention_backend: str = "auto",
        dtype: Any = torch.float32,
    ) -> None:
        super().__init__()
        self.data_shape = tuple(data_shape)
        self.dims = dims
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.compute_dtype = torch.bfloat16 if use_fp16 else as_torch_dtype(dtype)
        act = resolve_activation(activation)
        self.act = act
        cd = self.compute_dtype
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        attn_res = tuple(attention_resolutions)
        min_inner = min(self.data_shape[-2:]) if dims >= 2 else self.data_shape[0]
        if min_inner // (2 ** (len(channel_mult) - 1)) < 3:
            warnings.warn(
                f"data_shape {self.data_shape} shrinks below the 3x3 kernel after "
                f"{len(channel_mult) - 1} downsamplings; reduce channel_mult depth "
                "or enlarge the grid",
                stacklevel=2,
            )
        emb_dim = model_channels * 4
        self.time_embed = nn.Sequential(
            Linear(model_channels, emb_dim), Activation(act), Linear(emb_dim, emb_dim),
        )
        self.cond_fn = cond_fn

        def res(ch_in, ch_out, **kw):
            return ResBlock(
                ch_in, emb_dim, ch_out, dims, dropout=dropout,
                use_scale_shift_norm=use_scale_shift_norm, activation=act, dtype=cd, **kw,
            )

        def attn(ch, heads):
            return AttentionBlock(
                ch, heads, num_head_channels, use_new_attention_order,
                backend=attention_backend, dtype=cd,
            )

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([
            TimestepEmbedSequential(ConvNd(dims, in_channels, ch, 3, dtype=cd)),
        ])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attn_res:
                    layers.append(attn(ch, num_heads))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                down = (
                    res(ch, ch, down=True) if resblock_updown
                    else Downsample(dims, conv_resample, ch, ch, dtype=cd)
                )
                self.input_blocks.append(TimestepEmbedSequential(down))
                chans.append(ch)
                ds *= 2

        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch, num_heads), res(ch, ch))

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attn_res:
                    layers.append(attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(
                        res(ch, ch, up=True) if resblock_updown
                        else Upsample(dims, conv_resample, ch, ch, dtype=cd),
                    )
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        assert not chans

        self.out = nn.Sequential(
            GroupNorm32(ch), Activation(act),
            ConvNd(dims, ch, out_channels, 3, zero_init=True),
        )
        self.use_checkpoint = use_checkpoint
        for m in self.modules():
            if isinstance(m, Recomputable):
                m.use_checkpoint = use_checkpoint

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "UNet":
        """Re-initialise every parameter from ``generator`` with the JAX
        package's initialisers (LeCun-normal, zero-init heads, unit norms)."""
        for m in self.modules():
            if isinstance(m, (ConvNd, Conv1x1, Linear)):
                reset_parameters(m, generator)
            elif isinstance(m, GroupNorm32):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MultiEmbeddings):
                m.reset_parameters(generator)
        return self

    def forward(
        self,
        x: torch.Tensor,
        timesteps: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x: [B, *data_shape, C_in], timesteps: [B] -> [B, *data_shape, C_out] fp32."""
        t0, _, t2 = self.time_embed
        emb = t2(self.act(t0(sinusoidal_position_embedding(timesteps, self.model_channels))))
        if self.num_classes is not None:
            assert y is not None, "class-conditional model requires y"
            if y.ndim == 2 and y.shape == emb.shape:
                cond = y.to(emb.dtype)  # precomputed embeddings (sha512 path)
            else:
                assert self.cond_fn is not None, "conditioning labels require a cond_fn module"
                cond = self.cond_fn(y)
            if cond_mask is not None:
                cond = cond * cond_mask.to(cond.dtype)[:, None]
            emb = emb + cond
        emb = emb.to(self.compute_dtype)

        h = x.to(self.compute_dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=-1), emb)
        norm, _, conv_out = self.out
        return conv_out(self.act(norm(h)).float())
