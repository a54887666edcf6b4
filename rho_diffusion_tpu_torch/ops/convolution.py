"""Dimension-generic convolution and resampling on channels-last tensors.

Port of ``rho_diffusion_tpu/ops/convolution.py``. Activations stay
[B, *spatial, C]; parameters are stored as the reference torch UNet stores
them (``weight`` [O, I, *K], ``bias`` [O]) and cast to the compute dtype at
use, so a reference ``state_dict`` loads unchanged.

* Every stride-1 3x3x3 SAME conv goes to ``ops.kernels.conv3d``, a
  differentiable autograd Function: the hand-written CUDA kernels on the
  card (forward and dgrad, bf16 and fp32, any Cin and Cout, so the UNet's
  input conv and fp32 output head too), its plain versions on the CPU.
  ``set_conv3d_backend("plain")`` sends both directions to the plain
  versions on every device instead (a reference run on the card).
* Other convs (1-D, 2-D, and the strided 3-D Downsample) run on
  ``torch.nn.functional.conv{1,2,3}d``, as the JAX package leaves them to XLA.
  "SAME" stride-1 padding follows XLA (for odd kernels k//2 each side);
  strided convs use the reference's symmetric k//2 padding.
* 3-D up/downsampling touches the inner two spatial dims only.
* Under int8 (``ops.quant``'s mode) ``ConvNd`` is JAX's ``ConvInt8`` and
  ``Conv1x1`` its ``DenseInt8``, checked before the conv3d route as JAX's
  ``conv_nd`` checks it before its backends: quantisation is an explicit
  request and must win over the float kernels. ``Linear`` (the time MLP and
  the ResBlocks' emb_layers) stays float, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rho_diffusion_tpu_torch.ops import quant
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d

_CONV3D_BACKEND = "auto"


def set_conv3d_backend(mode: str) -> None:
    """Select where stride-1 3x3x3 convs run: "auto" (the CUDA kernel on the
    card, its plain version on the CPU) or "plain" (the plain version on
    every device)."""
    global _CONV3D_BACKEND
    if mode not in ("auto", "plain"):
        raise ValueError(f"conv3d backend must be 'auto' or 'plain', got {mode!r}")
    _CONV3D_BACKEND = mode


def _tuple(v, dims: int) -> tuple[int, ...]:
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v),) * dims


def compute_dtype(dtype: Optional[torch.dtype], x: torch.Tensor) -> torch.dtype:
    """flax's dtype rule for a layer with fp32 params: the layer's dtype
    when set, else the promotion of the input with fp32."""
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


class ConvNd(nn.Module):
    """An n-dimensional convolution over [B, *spatial, C]."""

    def __init__(
        self,
        dims: int,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int | Sequence[int] = 1,
        padding: str | int = "SAME",
        dtype: Optional[torch.dtype] = None,
        zero_init: bool = False,
    ) -> None:
        super().__init__()
        self.dims = dims
        self.kernel_size = kernel_size
        self.stride = _tuple(stride, dims)
        self.padding = padding
        self.dtype = dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *(kernel_size,) * dims))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        reset_parameters(self)

    def _pads(self) -> list[tuple[int, int]]:
        k = self.kernel_size
        if self.padding == "SAME" and all(s == 1 for s in self.stride):
            return [((k - 1) // 2, k // 2)] * self.dims  # XLA "SAME"
        if self.padding == "SAME":
            return [((k - 1) // 2, (k - 1) // 2)] * self.dims  # symmetric k//2
        return [(int(self.padding), int(self.padding))] * self.dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.get_conv_quant() == "int8":
            return quant.conv_int8(self, x)
        dt = compute_dtype(self.dtype, x)
        return self.conv_float(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def conv_float(self, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
        """The float conv of x and w (and b, when given) in their dtype."""
        if (
            self.dims == 3 and self.kernel_size == 3 and self.padding == "SAME"
            and self.stride == (1, 1, 1)
        ):
            return conv3d(x.contiguous(), w, b, plain=_CONV3D_BACKEND == "plain")
        pads = self._pads()
        xc = x.movedim(-1, 1)
        if any(lo != hi for lo, hi in pads):
            xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        else:
            padding = tuple(lo for lo, _ in pads)
        conv = (F.conv1d, F.conv2d, F.conv3d)[self.dims - 1]
        return conv(xc, w, b, stride=self.stride, padding=padding).movedim(1, -1).contiguous()


conv_nd = ConvNd  # the JAX package's name for the factory


class Conv1x1(nn.Module):
    """A 1x1 convolution stored as the reference stores it ([O, I, 1, ...])
    and applied as a channel matmul (the JAX package's Dense)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_dims: int = 1,
        dtype: Optional[torch.dtype] = None, zero_init: bool = False,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.zero_init = zero_init
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, *(1,) * kernel_dims))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        reset_parameters(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.get_conv_quant() == "int8":
            return quant.dense_int8(self, x)
        dt = compute_dtype(self.dtype, x)
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x.to(dt), w.to(dt), self.bias.to(dt))


class Linear(nn.Linear):
    """``nn.Linear`` with flax's compute-dtype rule (params stay fp32)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.zero_init = False
        reset_parameters(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.compute_dtype, x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The JAX package's initialisers: LeCun-normal weights (zeros for
    zero-init layers), zero biases."""
    w = module.weight
    if getattr(module, "zero_init", False):
        w.zero_()
    else:
        fan_in = math.prod(w.shape[1:])
        w.normal_(0.0, fan_in ** -0.5, generator=generator)
    module.bias.zero_()


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def resample_factors(dims: int) -> tuple[int, ...]:
    """3-D resamples only the inner two dims."""
    return (1, 2, 2) if dims == 3 else (2,) * dims


def upsample_nearest(x: torch.Tensor, dims: int) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of [B, *spatial, C]."""
    for axis, f in enumerate(resample_factors(dims), start=1):
        if f > 1:
            x = torch.repeat_interleave(x, f, dim=axis)
    return x


def avg_pool_nd(x: torch.Tensor, dims: int, window: Sequence[int]) -> torch.Tensor:
    """Average pooling over [B, *spatial, C] with stride = window (VALID)."""
    pool = (F.avg_pool1d, F.avg_pool2d, F.avg_pool3d)[dims - 1]
    return pool(x.movedim(-1, 1), tuple(window), tuple(window)).movedim(1, -1).contiguous()


class Upsample(nn.Module):
    """2x nearest upsample with an optional 3x3 conv (``conv``)."""

    def __init__(self, dims: int, use_conv: bool, channels: int,
                 out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dims = dims
        self.use_conv = use_conv
        if use_conv:
            self.conv = ConvNd(dims, channels, out_channels or channels, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_nearest(x, self.dims)
        return self.conv(x) if self.use_conv else x


class Downsample(nn.Module):
    """2x downsample by a strided 3x3 conv (``op``) or average pooling;
    3-D strides are (1, 2, 2)."""

    def __init__(self, dims: int, use_conv: bool, channels: int,
                 out_channels: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__()
        self.dims = dims
        self.use_conv = use_conv
        stride = resample_factors(dims)
        if use_conv:
            self.op = ConvNd(dims, channels, out_channels or channels, 3, stride=stride,
                             dtype=dtype)
        else:
            assert out_channels in (None, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_conv:
            return self.op(x)
        return avg_pool_nd(x, self.dims, resample_factors(self.dims))
