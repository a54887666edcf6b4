"""int8 W8A8 inference for the conv stack and the UNet's Dense sites.

Port of ``rho_diffusion_tpu/ops/quant.py``. The scheme is JAX's, bit for
bit on the CPU:

    s_w[c] = max|W[c, ...]| / 127    (per output channel; once per module)
    s_x[b] = max|x[b]| / 127         (per SAMPLE: a served row does not
                                      depend on its batch)
    y      = conv(q(x), q(W)) -> exact int32 sums
    out    = y * (s_x * s_w) + bias  (fp32, then the layer's dtype)

with q(t) = clamp(round_half_even(t / s), -127, 127) (``quantize_int8``).
Layers with fewer than ``MIN_QUANT_CHANNELS`` input or output channels stay
float, and then compute in ``self.dtype or x.dtype`` with the bias added
after the conv in that dtype (JAX's ``ConvInt8``/``DenseInt8`` rule, not
flax's promotion). On the flagship that keeps the Cin = 1 input conv in bf16
and the Cout = 1 head in fp32 (both packages cast to fp32 before the head).

Where it runs (``ops/kernels/conv_int8.py``): the activation quantisation
is S3 on the card, the convs S1's block (3x3x3 SAME at stride 1 and the
(1, 2, 2) Downsample, 2-D 3x3 and 1-D 3-tap at stride 1 and 2, pads (1, 1),
Cin % 16 == 0) or S2 (the rest: Cin % 16 != 0, other kernels), the Dense sites
(``Conv1x1``: the ResBlock's channel-changing skip, attention qkv and
proj_out) ``torch._int_mm`` on S3's output, as JAX leaves its ``DenseInt8``
product to XLA. On the CPU every piece is its plain version.

The weights are quantised once per module and cached on it, keyed by the
parameter's ``_version``, ``data_ptr`` and device, so an optimizer step or
``load_state_dict`` (both update in place and bump the version) or a move
quantises again. ``set_int8_backend("plain")`` sends every piece to its
plain version on any device (the int8 reference model on the card).

The mode is process-global, as in JAX: ``set_conv_quant("int8")``, the
``conv_quant`` context, ``RHO_CONV_INT8=1`` at import, the inference CLI's
``--quant int8`` and ``SamplingService(quantize="int8")``. The port runs
eagerly, so it is read at forward time where JAX reads it at trace time.
Inference only: ``round`` has no gradient, and the training step raises
while the mode is on.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k
from rho_diffusion_tpu_torch.ops.kernels.conv_int8 import quantize_int8  # noqa: F401

MIN_QUANT_CHANNELS = 16
INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
INT_MM_MULTIPLE = 8  # ... and k, n multiples of 8

_CONV_QUANT_MODE = "int8" if os.environ.get("RHO_CONV_INT8") == "1" else "off"
_INT8_BACKEND = "auto"


def set_conv_quant(mode: str) -> None:
    """Select conv quantization: "off" (default) or "int8" (W8A8 inference)."""
    global _CONV_QUANT_MODE
    if mode not in ("off", "int8"):
        raise ValueError(f"conv quant mode must be 'off' or 'int8', got {mode!r}")
    _CONV_QUANT_MODE = mode


def get_conv_quant() -> str:
    return _CONV_QUANT_MODE


@contextmanager
def conv_quant(mode: str):
    """Scoped ``set_conv_quant``."""
    prev = _CONV_QUANT_MODE
    set_conv_quant(mode)
    try:
        yield
    finally:
        set_conv_quant(prev)


def set_int8_backend(mode: str) -> None:
    """Select where the int8 pieces run: "auto" (the kernels on the card,
    their plain versions on the CPU) or "plain" (the plain versions on every
    device: the int8 reference model on the card)."""
    global _INT8_BACKEND
    if mode not in ("auto", "plain"):
        raise ValueError(f"int8 backend must be 'auto' or 'plain', got {mode!r}")
    _INT8_BACKEND = mode


def _plain(x: torch.Tensor) -> bool:
    return x.device.type == "cpu" or _INT8_BACKEND == "plain"


def is_small(cin: int, cout: int) -> bool:
    """A layer that stays float under int8 (the first/last-layer exclusion)."""
    return cin < MIN_QUANT_CHANNELS or cout < MIN_QUANT_CHANNELS


@torch.no_grad()
def quantized_weight(module) -> dict:
    """``module.weight`` [Cout, Cin, ...] quantised per output channel:
    {"wq": int8 in the torch layout, "s_w": [Cout] fp32} plus the kernels'
    layouts as they are asked for (``weight_layout``). Cached on the module
    until the parameter changes (its version, storage or device)."""
    w = module.weight
    key = (w._version, w.data_ptr(), w.device)
    cache = getattr(module, "_int8_cache", None)
    if cache is None or cache["key"] != key:
        wq, s_w = k.quantize_rows(w.detach(), plain=_plain(w))
        cache = {"key": key, "wq": wq, "s_w": s_w}
        module._int8_cache = cache
    return cache


@torch.no_grad()
def weight_layout(cache: dict, name: str) -> torch.Tensor:
    """A kernel's layout of the cached int8 weights: "s1" [Cout, 27, Cin],
    "s1_2d" [Cout, 9, Cin], "s1_1d" [Cout, 3, Cin], "s2" packed words,
    "dense" [Cout, Cin] (its transpose is _int_mm's column-major B)."""
    if name not in cache:
        wq = cache["wq"]
        cache[name] = {"s1": k.s1_weights, "s1_2d": k.s1_2d_weights,
                       "s1_1d": k.s1_1d_weights, "s2": k.s2_weights,
                       "dense": lambda t: t.reshape(t.shape[0], t.shape[1]).contiguous()}[name](wq)
    return cache[name]


def conv_int8(module, x: torch.Tensor) -> torch.Tensor:
    """A ``ConvNd`` forward under int8 (JAX ``ConvInt8``): x [B, *spatial,
    Cin] -> [B, *out_spatial, Cout] in ``module.dtype or x.dtype``."""
    dt = module.dtype or x.dtype
    cin, cout = x.shape[-1], module.weight.shape[0]
    pads = module._pads()
    if is_small(cin, cout):
        y = module.conv_float(x.to(dt), module.weight.to(dt), None)
        return y + module.bias.to(y.dtype)
    ksize = (module.kernel_size,) * module.dims
    xq, s_x = k.quantize_rows(x, plain=_plain(x))
    cache = quantized_weight(module)
    bias = module.bias.detach()
    if _plain(x):
        return k.conv_int8_plain(xq, s_x, cache["wq"], cache["s_w"], bias, module.stride, pads,
                                 dt)
    route = k.int8_conv_route(tuple(x.shape), ksize, module.stride, pads, cout)
    if route == "s1":
        return k.conv3d_s8_kernel(xq, s_x, weight_layout(cache, "s1"), cache["s_w"], bias, dt)
    if route == "s1_strided":
        return k.conv3d_s8_strided_kernel(xq, s_x, weight_layout(cache, "s1"), cache["s_w"],
                                          bias, dt)
    if route in ("s1_2d", "s1_2d_strided"):
        launch = k.conv2d_s8_kernel if route == "s1_2d" else k.conv2d_s8_strided_kernel
        return launch(xq, s_x, weight_layout(cache, "s1_2d"), cache["s_w"], bias, dt)
    if route in ("s1_1d", "s1_1d_strided"):
        launch = k.conv1d_s8_kernel if route == "s1_1d" else k.conv1d_s8_strided_kernel
        return launch(xq, s_x, weight_layout(cache, "s1_1d"), cache["s_w"], bias, dt)
    return k.conv_s8_general_kernel(xq, s_x, weight_layout(cache, "s2"), cache["s_w"], bias,
                                    ksize, module.stride, pads, dt)


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [M, K] @ wq[N, K]^T -> int32 [M, N], exact: ``torch._int_mm``. On
    CUDA it takes M > 16 and K, N multiples of 8: fewer rows are padded with
    zero rows (exact) and cut off after; other K or N raise."""
    m, kk = xq.shape
    n = wq.shape[0]
    if xq.device.type == "cuda":
        if kk % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
            raise ValueError(f"int8 dense {m}x{kk} @ {kk}x{n}: torch._int_mm on CUDA takes K "
                             f"and N multiples of {INT_MM_MULTIPLE}")
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, wq.t())[:m]


def dense_int8(module, x: torch.Tensor) -> torch.Tensor:
    """A ``Conv1x1`` (the JAX package's Dense site) forward under int8 (JAX
    ``DenseInt8``): x [B, ..., Cin] -> [B, ..., Cout] in ``module.dtype or
    x.dtype``."""
    dt = module.dtype or x.dtype
    cin, cout = x.shape[-1], module.weight.shape[0]
    w = module.weight.reshape(cout, cin)
    if is_small(cin, cout):
        return F.linear(x.to(dt), w.to(dt)) + module.bias.to(dt)
    xq, s_x = k.quantize_rows(x, plain=_plain(x))
    cache = quantized_weight(module)
    acc = int_mm(xq.reshape(-1, cin), weight_layout(cache, "dense"))
    acc = acc.reshape(*x.shape[:-1], cout)
    return k.dequantize_plain(acc, s_x, cache["s_w"], module.bias.detach(), dt)


def training_refusal() -> Optional[str]:
    """JAX's reason (diffusion/base.py:317-326) while the mode is on, else
    None."""
    if get_conv_quant() == "off":
        return None
    return ("conv quantization is active (ops/quant.py) but training was requested: round() "
            "has zero gradient, so a quantized train step would silently learn nothing. "
            "Quantization is an inference-only execution mode; call set_conv_quant('off') "
            "before training.")
