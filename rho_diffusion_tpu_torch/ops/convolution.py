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
* ``RHO_CONV3D_VIA_2D=1`` (read at import, as JAX reads it) sends every
  3x3x3 SAME float conv with z-stride 1, the (1, 2, 2) Downsample among
  them, through ``conv3d_via_2d`` (JAX's ``Conv3dVia2d``: three batched
  ``F.conv2d`` calls summed), in place of the conv3d route: a study backend
  the caller asks for. int8 still wins over it, as in JAX.
* Inside a rank that holds a depth slab of the volume (``parallel.spmd``
  under spatial sharding), every 3-D conv with a depth kernel of 3 and
  depth stride 1 runs on the slab with its two halo planes and drops its
  first and last output plane (``parallel.spatial.sharded_conv3d_local``):
  JAX's GSPMD halo conv. Each backend above runs it as it runs a whole
  volume. int8 is not ported under spatial sharding (its per-sample
  activation scales read the whole volume) and raises.
* ``record_conv_inputs()`` lists the input shape of every 3-D conv with a
  depth kernel of 3 (the haloed slab under spatial sharding) while it is
  entered, for the checks that no such conv sees a whole-depth volume.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rho_diffusion_tpu_torch.ops import quant
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d
from rho_diffusion_tpu_torch.parallel import spmd
from rho_diffusion_tpu_torch.parallel.spatial import sharded_conv3d_local

_CONV3D_BACKEND = "auto"
_RECORDS: list = []  # the lists record_conv_inputs() has open
# JAX's ops/convolution.py:27-28: the batched 2-D decomposition, a study backend
CONV3D_VIA_2D = os.environ.get("RHO_CONV3D_VIA_2D") == "1"


def set_conv3d_backend(mode: str) -> None:
    """Select where stride-1 3x3x3 convs run: "auto" (the CUDA kernel on the
    card, its plain version on the CPU) or "plain" (the plain version on
    every device)."""
    global _CONV3D_BACKEND
    if mode not in ("auto", "plain"):
        raise ValueError(f"conv3d backend must be 'auto' or 'plain', got {mode!r}")
    _CONV3D_BACKEND = mode


@contextlib.contextmanager
def record_conv_inputs():
    """Yield a list that gets the input shape of every 3-D conv with a depth
    kernel of 3 run while the context is entered."""
    shapes: list = []
    _RECORDS.append(shapes)
    try:
        yield shapes
    finally:
        _RECORDS.remove(shapes)


def _refuse_int8_on_a_slab() -> None:
    if spmd.spatial_rank() is not None:
        raise NotImplementedError(
            "int8 convs under spatial sharding: the activation scales are per sample and "
            "read the whole volume, which a depth slab does not hold",
        )


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
            _refuse_int8_on_a_slab()
            return quant.conv_int8(self, x)
        dt = compute_dtype(self.dtype, x)
        return self.conv_float(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def conv_float(self, x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
        """The float conv of x and w (and b, when given) in their dtype; on
        a depth slab, of the haloed slab, cropped (module docstring)."""
        if self.dims == 3 and self.kernel_size == 3 and spmd.spatial_rank() is not None:
            if self.stride[0] != 1:
                raise NotImplementedError(f"a depth stride of {self.stride[0]} under spatial "
                                          "sharding: the slabs would not stay aligned")
            return sharded_conv3d_local(x, lambda xh: self._conv(xh, w, b))
        return self._conv(x, w, b)

    def _conv(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.dims == 3 and self.kernel_size == 3:
            for shapes in _RECORDS:
                shapes.append(tuple(x.shape))
        if (CONV3D_VIA_2D and self.dims == 3 and self.kernel_size == 3
                and self.padding == "SAME" and self.stride[0] == 1):
            return conv3d_via_2d(x, w, b, self.stride)
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


def conv3d_via_2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """A 3x3x3 conv of [B, D, H, W, Cin] as three batched 2-D convs summed
    (JAX's ``Conv3dVia2d``, ops/convolution.py:262-300): with (B, D) folded
    into the batch, out[:, d] = sum over dz of conv2d(x[:, d + dz - 1],
    w[:, :, dz]), padding 1 each side in every spatial dim (torch's k // 2,
    also for the strided (1, 2, 2) Downsample), then the bias. ``w`` keeps
    the [Cout, Cin, 3, 3, 3] layout, so checkpoints are interchangeable. The
    z-stride must be 1."""
    if int(stride[0]) != 1:
        raise ValueError(f"z-stride must be 1 for the 2d decomposition, got {tuple(stride)}")
    bsz, d, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    out = None
    for dz in range(3):
        xs = xp[:, dz:dz + d].reshape(bsz * d, h, wd, cin).movedim(-1, 1)
        o = F.conv2d(xs, w[:, :, dz], None, stride=tuple(stride[1:]), padding=1)
        out = o if out is None else out + o
    out = out.movedim(1, -1).reshape(bsz, d, out.shape[2], out.shape[3], w.shape[0])
    return out if b is None else out + b


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
            _refuse_int8_on_a_slab()
            return quant.dense_int8(self, x)
        dt = compute_dtype(self.dtype, x)
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x.to(dt), w.to(dt), self.bias.to(dt))


class Linear(nn.Linear):
    """``nn.Linear`` with flax's compute-dtype rule (params stay fp32);
    ``bias=False`` is flax's ``use_bias=False``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None, bias: bool = True) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.zero_init = False
        reset_parameters(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self.compute_dtype, x)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


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
    if module.bias is not None:
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
