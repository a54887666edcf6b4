"""Vision Transformer backbone for 1-3-D diffusion, registered as
``models/VisionTransformer``.

Port of ``rho_diffusion_tpu/models/vit.py``, channels-last, with the same
numerics:

* patch embedding by a stride = patch VALID conv (``patch_embed``; a
  per-patch GEMM, which the JAX package leaves to XLA: ``F.conv*d`` here);
* a sinusoidal patch-position embedding -> Dense -> activation, added to the
  patch sequence;
* ``transformer_depth`` pre-LN blocks (``block_{i}``), each adding its own
  Dense (no bias) -> activation of the sinusoidal diffusion-time embedding,
  plus the condition when there is one, to its input. The reference's
  residual wiring is kept: ``attn_residual = norm(x+t) + attn(norm(x+t))``,
  ``out = attn_residual + mlp(norm(attn_residual))``. The LayerNorms are
  flax's (eps 1e-6, the fast variance) in fp32, cast back to x's dtype. The
  qkv projection splits per head: ``reshape(b, s, heads, 3d)`` then thirds
  of the last axis. Attention is ``ops.attention.attention``: the
  hand-written flash kernels on the card (head dim 16 at the bench width
  takes their mma.sync route), their plain versions on the CPU;
* the output: a Dense (no bias) to ``hidden_dim``, reshaped to the patch
  grid, then a stride = patch VALID transpose conv (``output_conv``) in fp32.
  flax's ``ConvTranspose`` with ``transpose_kernel=False`` computes
  ``out[n p + r] = x[n] . w[p - 1 - r]``: the port stores the kernel in
  ``F.conv_transpose*d``'s [in, out, *K] layout, spatially flipped
  (``interop.jax_weights`` flips it on the way in).

The conditional seam is JAX's: with ``num_classes`` set, integer labels go
through ``class_embed``, 2-D precomputed rows (no ``cond_fn``) straight to
``cond_proj``, and raw parameter rows through ``cond_fn``; the condition
joins every block's time embedding. flax shapes ``cond_proj`` from the ``y``
it is initialised with and makes ``class_embed`` only when integer labels
reach it; a torch module fixes its shapes at construction, so without a
``cond_fn`` the port reads ``condition_dim``: given, it builds no
``class_embed`` and a ``cond_proj`` that takes rows that wide, as flax does
when initialised on such rows (the pipeline passes its
``condition_embedding_dim()``, the width of the rows JAX's pipeline
initialises the model on); left None, it builds ``class_embed`` for integer
labels and takes precomputed rows of width ``embedding_dim``. Rows of any
other width raise.

Dropout draws from torch's generator; the parity tests run at dropout 0.
The model takes no ``cond_mask``, so classifier-free guidance on it raises
(``diffusion.base``'s backbone check), as in JAX.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rho_diffusion_tpu_torch.interop.jax_weights import export_named_state_dict
from rho_diffusion_tpu_torch.models.unet import as_torch_dtype
from rho_diffusion_tpu_torch.ops.activations import resolve_activation
from rho_diffusion_tpu_torch.ops.attention import attention
from rho_diffusion_tpu_torch.ops.convolution import Linear, reset_parameters
from rho_diffusion_tpu_torch.ops.embeddings import sinusoidal_position_embedding
from rho_diffusion_tpu_torch.ops.norm import LayerNorm
from rho_diffusion_tpu_torch.registry import registry


class ViTBlock(nn.Module):
    """Transformer block with its own additive time embedding."""

    def __init__(self, embed_dim: int, hidden_dim: int, num_heads: int, dropout: float = 0.0,
                 activation: Any = "GELU", time_dim: int = 128,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.act = resolve_activation(activation)
        self.time_proj = Linear(time_dim, embed_dim, dtype=dtype, bias=False)
        self.norm_1 = LayerNorm(embed_dim)
        self.qkv = Linear(embed_dim, 3 * embed_dim, dtype=dtype)
        self.attn_out = Linear(embed_dim, embed_dim, dtype=dtype)
        self.norm_2 = LayerNorm(embed_dim)
        self.mlp_0 = Linear(embed_dim, hidden_dim, dtype=dtype)
        self.mlp_1 = Linear(hidden_dim, embed_dim, dtype=dtype)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None

    def forward(self, x: torch.Tensor, t_sin: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, S, C]; ``t_sin`` the sinusoidal time embedding [B, time_dim]."""
        t_emb = self.act(self.time_proj(t_sin))
        if cond is not None:
            t_emb = t_emb + cond
        h = x + t_emb[:, None, :].to(x.dtype)
        norm = self.norm_1(h).to(x.dtype)
        b, s, c = norm.shape
        d = c // self.num_heads
        q, k, v = self.qkv(norm).reshape(b, s, self.num_heads, 3 * d).split(d, dim=-1)
        attn = self.attn_out(attention(q, k, v).reshape(b, s, c))
        attn_residual = norm + attn
        mlp = self.act(self.mlp_0(self.norm_2(attn_residual).to(x.dtype)))
        if self.dropout is not None:
            mlp = self.dropout(mlp)
        mlp = self.mlp_1(mlp)
        if self.dropout is not None:
            mlp = self.dropout(mlp)
        return attn_residual + mlp


@registry.register_model("VisionTransformer")
class VisionTransformer(nn.Module):
    """ViT diffusion backbone. Input [B, *input_shapes, num_channels]."""

    # the pipeline passes condition_dim, the width of the precomputed rows
    # JAX's pipeline initialises the model on (flax sizes cond_proj from them)
    sizes_condition_from_rows = True

    def __init__(
        self,
        patch_size: int,
        input_shapes: Sequence[int],
        num_channels: int,
        embedding_dim: int,
        hidden_dim: int,
        activation: Any = "GELU",
        transformer_depth: int = 8,
        pos_embedding_dim: int = 128,
        time_embedding_dim: int = 128,
        max_seq_length: int = 20_000,  # accepted for config parity; unused, as in JAX
        dropout: float = 0.2,
        num_heads: int = 16,
        dtype: Any = torch.float32,
        num_classes: Optional[int] = None,
        cond_fn: Optional[nn.Module] = None,
        condition_dim: Optional[int] = None,
    ) -> None:
        super().__init__()
        self.input_shapes = tuple(input_shapes)
        self.dims = len(self.input_shapes)
        self.embedding_dim = embedding_dim
        self.hidden_dim = hidden_dim
        self.pos_embedding_dim = pos_embedding_dim
        self.time_embedding_dim = time_embedding_dim
        self.depth = transformer_depth
        self.num_classes = num_classes
        self.act = resolve_activation(activation)
        cd = self.compute_dtype = as_torch_dtype(dtype)
        kernel = (patch_size,) * self.dims
        self.cond_fn = cond_fn
        self.condition_dim = condition_dim if cond_fn is None else None
        if num_classes is not None:
            if cond_fn is not None:
                cond_in = cond_fn.embedding_dim
            elif condition_dim is not None:
                cond_in = condition_dim
            else:
                self.class_embed = nn.Embedding(num_classes, embedding_dim)
                cond_in = embedding_dim
            self.cond_proj = Linear(cond_in, embedding_dim, dtype=cd)
        self.patch_embed = _PatchConv(num_channels, embedding_dim, kernel)
        self.pos_proj = Linear(pos_embedding_dim, embedding_dim, dtype=cd)
        for i in range(transformer_depth):
            self.add_module(f"block_{i}", ViTBlock(
                embedding_dim, hidden_dim, num_heads, dropout=dropout, activation=activation,
                time_dim=time_embedding_dim, dtype=cd))
        self.output_projection = Linear(embedding_dim, hidden_dim, dtype=cd, bias=False)
        self.output_conv = _PatchConvTranspose(hidden_dim, num_channels, kernel)

    @staticmethod
    def state_dict_from_jax(params: dict) -> dict[str, np.ndarray]:
        """A JAX param tree of this model as its ``state_dict``: the modules
        are named after the tree, and ``output_conv``'s kernel is flipped."""
        return export_named_state_dict(params, flipped=("output_conv",))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> "VisionTransformer":
        """flax's initialisers: LeCun-normal kernels, zero biases, unit
        norms, embeddings N(0, 1/embedding_dim)."""
        cond_modules = set()
        if self.cond_fn is not None:
            self.cond_fn.reset_parameters(generator)
            cond_modules = set(self.cond_fn.modules())
        for m in self.modules():
            if m in cond_modules:
                continue
            if isinstance(m, Linear):
                reset_parameters(m, generator)
            elif isinstance(m, (_PatchConv, _PatchConvTranspose)):
                m.reset_parameters(generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, self.embedding_dim ** -0.5, generator=generator)
        return self

    def condition(self, y: torch.Tensor) -> torch.Tensor:
        """The condition added to every block's time embedding."""
        if self.cond_fn is not None:
            raw = self.cond_fn(y)
        elif y.ndim == 2:
            if y.shape[1] != self.cond_proj.in_features:
                raise ValueError(
                    f"precomputed conditions of width {y.shape[1]}; this model's cond_proj "
                    f"takes {self.cond_proj.in_features}, its "
                    f"{'condition_dim' if self.condition_dim else 'embedding_dim'}")
            raw = y
        elif self.condition_dim is not None:
            raise ValueError(
                f"this model takes precomputed condition rows [B, {self.condition_dim}] and has "
                "no class_embed for integer labels (as JAX's, initialised on such rows)")
        else:
            raw = self.class_embed(y.long())
        return self.cond_proj(raw.to(self.compute_dtype))

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, *input_shapes, C], timesteps: [B] -> the same shape, fp32.
        ``y`` is read only when ``num_classes`` is set."""
        cond = None
        if self.num_classes is not None:
            assert y is not None, "class-conditional ViT requires y"
            cond = self.condition(y)
        assert x.ndim == self.dims + 2, (
            f"expected [B, {'x'.join(map(str, self.input_shapes))}, C] input, got shape "
            f"{tuple(x.shape)}")
        cd = self.compute_dtype
        patches = self.patch_embed(x.to(cd), cd)
        grid = patches.shape[1:-1]
        seq = math.prod(grid)
        h = patches.reshape(x.shape[0], seq, self.embedding_dim)
        pos = sinusoidal_position_embedding(torch.arange(seq, device=x.device),
                                            self.pos_embedding_dim)
        h = h + self.act(self.pos_proj(pos))[None].to(h.dtype)
        t_sin = sinusoidal_position_embedding(timesteps, self.time_embedding_dim)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, t_sin, cond)
        h = self.output_projection(h).reshape(x.shape[0], *grid, self.hidden_dim)
        return self.output_conv(h.float())


class _PatchConv(nn.Module):
    """A stride = kernel VALID conv over [B, *spatial, C] (flax ``nn.Conv``),
    weight [O, I, *K]."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, ...]) -> None:
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        conv = (F.conv1d, F.conv2d, F.conv3d)[len(self.kernel) - 1]
        out = conv(x.movedim(-1, 1).to(dtype), self.weight.to(dtype), self.bias.to(dtype),
                   stride=self.kernel)
        return out.movedim(1, -1)


class _PatchConvTranspose(nn.Module):
    """A stride = kernel VALID transpose conv over [B, *grid, C] in fp32
    (flax ``nn.ConvTranspose`` with ``transpose_kernel=False``), weight
    [I, O, *K] holding flax's kernel flipped in space."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, ...]) -> None:
        super().__init__()
        self.kernel = kernel
        self.weight = nn.Parameter(torch.empty(cin, cout, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """LeCun normal over flax's fan-in, prod(K) * I."""
        self.weight.normal_(0.0, self.weight[:, 0].numel() ** -0.5, generator=generator)
        self.bias.zero_()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        conv = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[len(self.kernel) - 1]
        return conv(h.movedim(-1, 1), self.weight, self.bias, stride=self.kernel).movedim(1, -1)
