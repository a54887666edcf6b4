"""W8A8 inference kernels: the int8 convs and the exact activation quantiser.

The JAX package's int8 path (``rho_diffusion_tpu/ops/quant.py``) is plain
jnp that XLA lowers onto the TPU's int8 units; PyTorch has no int8 conv on
CUDA (``F.conv3d`` on int8 tensors returns int8 and wraps), so the port
brings its own, in ``csrc/conv_int8.cu``:

* S1 ``conv3d_s8_kernel``: the 3x3x3 stride-1 SAME conv on the s8 tensor
  cores, K5's TMA/wgmma block with s8 operands (``csrc/conv3d_s8_wgmma.cuh``)
  and ``igemm_plan``'s plan; Cin % 16 == 0 (TMA's 16-byte strides).
* ``conv3d_s8_strided_kernel``: the UNet's Downsample, the 3x3x3 conv at
  stride (1, 2, 2) with pads (1, 1), Cin % 16 == 0, on S1's block with x's
  tensor map walked every other voxel along H and W (the route
  "s1_strided"); the plan is ``igemm_plan``'s on the output's shape. Its
  launcher is ``csrc/conv3d_s8_strided.cu``, a library of its own.
* ``conv2d_s8_kernel`` and ``conv2d_s8_strided_kernel``: the 2-D UNet's 3x3
  convs with pads (1, 1), Cin % 16 == 0, at stride (1, 1) and (2, 2) (the
  routes "s1_2d" and "s1_2d_strided"), on S1's block with the 1x3x3 tap set
  over x as a depth-1 volume; weights [Cout, 9, Cin] (``s1_2d_weights``).
  Their launchers are ``csrc/conv2d_s8.cu`` and ``csrc/conv2d_s8_strided.cu``.
* ``conv1d_s8_kernel`` and ``conv1d_s8_strided_kernel``: the 1-D UNet's
  3-tap convs with pads (1, 1), Cin % 16 == 0, at stride 1 and 2 (the
  routes "s1_1d" and "s1_1d_strided"), on S1's block with the 1x1x3 tap set
  over x as the volume [B, 1, 1, W, Cin], strided along W alone; weights
  [Cout, 3, Cin] (``s1_1d_weights``). Their launchers are
  ``csrc/conv1d_s8.cu`` and ``csrc/conv1d_s8_strided.cu``.
* S2 ``conv_s8_general_kernel``: any int8 conv of rank 1-3 (as 3-D with unit
  dims), any kernel size, stride and explicit padding: other kernels and
  strides, and the Cin % 16 != 0 the TMA routes do not take.
* S3 ``quantize_rows_kernel``: the symmetric int8 quantisation of each
  leading row (a sample, or an output channel of a weight), bitwise as
  ``quantize_int8``.

Every wrapper takes the plain version for a CPU tensor and, for a CUDA
tensor, launches its kernel or raises; ``int8_conv_route`` names the
kernel a conv takes and raises, naming the shape, where none covers it.
Both convs have an int32 output mode (the exact sums) beside the
dequantised fp32 or bf16 one. The plain conv is a float64 conv of the int8
values, exact because |sum| <= 127^2 * taps * Cin < 2^53, cast to int32;
its dequantisation is JAX's: ``float(acc) * (s_x * s_w) + bias``, each
operation rounded on its own, then one rounding to the output type.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import (
    _build, check_no_autograd, launch_counts, on_device, sm_count)
from rho_diffusion_tpu_torch.ops.kernels.conv3d import igemm_plan

S1_CIN_MULTIPLE = 16  # TMA's global strides are multiples of 16 bytes
S1_MAX_CIN = 4912  # 127^2 * 27 * Cin < 2^31
INT32_MAX = 2**31 - 1
# S1's block by the conv's stride: (1, 1, 1) is S1, (1, 2, 2) the Downsample;
# in 2-D, (1, 1) and (2, 2) on its 1x3x3 tap set; in 1-D, 1 and 2 on its
# 1x1x3 tap set
S1_STRIDES = {(1, 1, 1): "s1", (1, 2, 2): "s1_strided"}
S1_2D_STRIDES = {(1, 1): "s1_2d", (2, 2): "s1_2d_strided"}
S1_1D_STRIDES = {(1,): "s1_1d", (2,): "s1_1d_strided"}
# the routes on S1's block: their launcher (count name), source, stride
# along H and W (along W alone at 3 taps) and taps
S1_ROUTES = {"s1": ("conv3d_s8", "conv_int8", 1, 27),
             "s1_strided": ("conv3d_s8_strided", "conv3d_s8_strided", 2, 27),
             "s1_2d": ("conv2d_s8", "conv2d_s8", 1, 9),
             "s1_2d_strided": ("conv2d_s8_strided", "conv2d_s8_strided", 2, 9),
             "s1_1d": ("conv1d_s8", "conv1d_s8", 1, 3),
             "s1_1d_strided": ("conv1d_s8_strided", "conv1d_s8_strided", 2, 3)}
OUT_KINDS = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_S1_ARGS = [_PTR] * 6 + [_INT] * 12 + [_PTR]
_LAUNCHERS = {
    "conv_int8": {
        "conv3d_s8": _S1_ARGS,
        "conv_s8_general": [_PTR] * 7 + [_INT, _PTR],
        "quantize_int8_rows": [_PTR, _INT, _LL, _LL, _INT, _INT, _INT] + [_PTR] * 4,
    },
    # the strided Downsample's, the 2-D and the 1-D convs' own sources (each
    # builds beside conv_int8.cu)
    "conv3d_s8_strided": {"conv3d_s8_strided": _S1_ARGS},
    "conv2d_s8": {"conv2d_s8": _S1_ARGS},
    "conv2d_s8_strided": {"conv2d_s8_strided": _S1_ARGS},
    "conv1d_s8": {"conv1d_s8": _S1_ARGS},
    "conv1d_s8_strided": {"conv1d_s8_strided": _S1_ARGS},
}


@functools.cache
def _library(name: str = "conv_int8") -> ctypes.CDLL:
    """csrc/<name>.cu's library with its launchers' signatures set."""
    lib = _build.load(name)
    for fn, argtypes in _LAUNCHERS[name].items():
        launcher = getattr(lib, fn)
        launcher.restype = ctypes.c_int
        launcher.argtypes = argtypes
    return lib


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# S3: the quantiser

def quantize_int8(t: torch.Tensor, dims: Sequence[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of ``t`` reducing |max| over ``dims``
    (JAX ``quantize_int8``): q int8 in [-127, 127] and scale, with t ~= q *
    scale; the scale keeps the reduced dims as size 1. Half to even, as
    ``jnp.round``."""
    tf = t.float()
    amax = tf.abs().amax(dim=tuple(dims), keepdim=True).clamp_min(1e-12)
    # a tensor divisor: on CUDA PyTorch divides by a Python scalar as a
    # product with its reciprocal, one rounding off IEEE division (and JAX)
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(tf / scale).clamp(-127, 127).to(torch.int8), scale


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8`` over every dim but the first: q shaped as x, and
    the scales [x.shape[0]] fp32."""
    q, scale = quantize_int8(x, tuple(range(1, x.dim())))
    return q, scale.reshape(x.shape[0])


def quantize_rows(x: torch.Tensor, plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation (S3 on the card, its plain version on the
    CPU or with ``plain``): q shaped as x, scales [x.shape[0]] fp32."""
    if plain or x.device.type == "cpu":
        return quantize_rows_plain(x)
    return quantize_rows_kernel(x)


def quantize_plan(rows: int, n: int, vec: int, sms: int = 132) -> tuple[int, int]:
    """Blocks per row of S3's two launches (256 threads, ``vec`` values a
    thread a pass): the max pass ~2 blocks an SM, the quantise pass ~4, never
    more blocks than a row has passes of values, at most 256 max partials a
    row."""
    passes = -(-n // (256 * vec))
    p = max(1, min(passes, -(-2 * sms // rows), 256))
    q = max(1, min(passes, -(-4 * sms // rows), 65535))
    return p, q


def quantize_rows_kernel(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """S3 on a CUDA tensor (fp32 or bf16): two launches, counted as
    ``quantize_int8_amax`` and ``quantize_int8``."""
    check_no_autograd("quantize_int8", x)
    if x.device.type != "cuda":
        raise RuntimeError(f"quantize_int8 has no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_int8 kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 2 or x.shape[0] > 65535 or x.numel() == 0:
        raise ValueError(f"quantize_int8 kernel: shape {tuple(x.shape)} is out of its range")
    x = x.contiguous()
    rows = x.shape[0]
    n = x.numel() // rows
    vec = (8 if x.dtype == torch.bfloat16 else 4)
    if n % vec or x.data_ptr() % 16:
        vec = 1
    p, qb = quantize_plan(rows, n, vec, sm_count(x.device.index))
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((rows,), dtype=torch.float32, device=x.device)
    partial = torch.empty((rows, p), dtype=torch.float32, device=x.device)
    lib = _library()
    with on_device(x.device):
        code = lib.quantize_int8_rows(x.data_ptr(), int(x.dtype == torch.bfloat16), rows, n, vec,
                                      p, qb, partial.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                      _stream(x.device))
    _build.check(code, lib, "conv_int8_error_string", f"quantize_int8_rows({tuple(x.shape)})")
    launch_counts["quantize_int8_amax"] += 1
    launch_counts["quantize_int8"] += 1
    return q, scale


# ---------------------------------------------------------------------------
# The convs' routes and plain versions

def int8_conv_route(x_shape, kernel_size: Sequence[int], stride: Sequence[int],
                    pads: Sequence[tuple[int, int]], cout: int) -> str:
    """The kernel an int8 conv of x [B, *spatial, Cin] takes on the card:
    "s1" (3-D, 3x3x3, stride 1, pads (1, 1), Cin % 16 == 0), "s1_strided"
    (the same at stride (1, 2, 2): the UNet's Downsample), "s1_2d" and
    "s1_2d_strided" (2-D, 3x3, pads (1, 1), Cin % 16 == 0, at stride (1, 1)
    and (2, 2)), "s1_1d" and "s1_1d_strided" (1-D, 3 taps, pads (1, 1), Cin
    % 16 == 0, at stride 1 and 2), else "s2".
    Raises, naming the shape, where neither covers it: rank above 3, an
    int32 sum that could overflow, or an index past int32."""
    dims = len(kernel_size)
    cin = x_shape[-1]
    taps = 1
    for k in kernel_size:
        taps *= k
    out_spatial = conv_out_spatial(x_shape[1:-1], kernel_size, stride, pads)
    out_numel = x_shape[0] * cout
    for s in out_spatial:
        out_numel *= s
    x_numel = 1
    for s in x_shape:
        x_numel *= s
    problems = []
    if not 1 <= dims <= 3 or len(x_shape) != dims + 2:
        problems.append(f"rank {dims} (the kernels take 1-3 spatial dims)")
    if 127 * 127 * taps * cin > INT32_MAX:
        problems.append(f"{taps} taps x {cin} channels could overflow the int32 sum")
    if max(x_numel, out_numel, taps * cin * cout) > INT32_MAX or min(out_spatial, default=1) < 1:
        problems.append("sizes outside the kernels' int32 indexing")
    if problems:
        raise ValueError(
            f"int8 conv of x {tuple(x_shape)} -> {cout} channels, kernel {tuple(kernel_size)}, "
            f"stride {tuple(stride)}, pads {tuple(pads)}: no kernel covers it "
            f"({'; '.join(problems)})",
        )
    if (dims == 3 and tuple(kernel_size) == (3, 3, 3)
            and tuple(tuple(p) for p in pads) == ((1, 1),) * 3
            and cin % S1_CIN_MULTIPLE == 0):
        route = S1_STRIDES.get(tuple(stride))
        if route:
            return route
    if (dims == 2 and tuple(kernel_size) == (3, 3)
            and tuple(tuple(p) for p in pads) == ((1, 1),) * 2
            and cin % S1_CIN_MULTIPLE == 0):
        route = S1_2D_STRIDES.get(tuple(stride))
        if route:
            return route
    if (dims == 1 and tuple(kernel_size) == (3,) and tuple(tuple(p) for p in pads) == ((1, 1),)
            and cin % S1_CIN_MULTIPLE == 0):
        route = S1_1D_STRIDES.get(tuple(stride))
        if route:
            return route
    return "s2"


def conv_out_spatial(spatial, kernel_size, stride, pads) -> tuple[int, ...]:
    return tuple((n + lo + hi - k) // s + 1
                 for n, k, s, (lo, hi) in zip(spatial, kernel_size, stride, pads))


def conv_int32_plain(xq: torch.Tensor, wq: torch.Tensor, stride: Sequence[int],
                     pads: Sequence[tuple[int, int]]) -> torch.Tensor:
    """The exact int32 sums of an int8 conv: xq [B, *spatial, Cin], wq the
    torch layout [Cout, Cin, *K], explicit (lo, hi) pads per dim. A float64
    conv of the int8 values (exact: every sum is an integer below 2^53),
    cast to int32; [B, *out_spatial, Cout]."""
    dims = wq.dim() - 2
    xc = xq.to(torch.float64).movedim(-1, 1)
    xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
    conv = (F.conv1d, F.conv2d, F.conv3d)[dims - 1]
    y = conv(xc, wq.to(torch.float64), stride=tuple(stride))
    return y.movedim(1, -1).to(torch.int32).contiguous()


def dequantize_plain(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
                     bias: Optional[torch.Tensor], out_dtype: torch.dtype) -> torch.Tensor:
    """JAX's dequantisation (ops/quant.py:151-153) of int32 sums [B, ...,
    Cout]: float(acc) * (s_x[b] * s_w[co]) + bias[co] in fp32, each
    operation rounded on its own, then cast to ``out_dtype``."""
    scale = s_x.reshape(-1, *(1,) * (acc.dim() - 1)) * s_w.reshape(-1)
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def conv_int8_plain(xq, s_x, wq, s_w, bias, stride, pads, out_dtype) -> torch.Tensor:
    """The plain int8 conv: ``conv_int32_plain``, then (unless ``out_dtype``
    is int32) ``dequantize_plain``. S1's and S2's plain version."""
    acc = conv_int32_plain(xq, wq, stride, pads)
    if out_dtype == torch.int32:
        return acc
    return dequantize_plain(acc, s_x, s_w, bias, out_dtype)


# ---------------------------------------------------------------------------
# The kernels' weight layouts

def s1_weights(wq: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3, 3] int8 -> S1's [Cout, 27, Cin], tap = (dz*3+dy)*3+dx."""
    cout, cin = wq.shape[:2]
    return wq.permute(0, 2, 3, 4, 1).reshape(cout, 27, cin).contiguous()


def s1_2d_weights(wq: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3] int8 -> the 2-D routes' [Cout, 9, Cin], tap =
    dy*3+dx: S1's layout over the 1x3x3 tap set."""
    cout, cin = wq.shape[:2]
    return wq.permute(0, 2, 3, 1).reshape(cout, 9, cin).contiguous()


def s1_1d_weights(wq: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3] int8 -> the 1-D routes' [Cout, 3, Cin], tap = dx:
    S1's layout over the 1x1x3 tap set."""
    return wq.permute(0, 2, 1).contiguous()


def s2_weights(wq: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, *K] int8 -> S2's [taps, ceil(Cin/4), Cout] int32 words,
    byte i of a word holding channel 4g + i (little endian), channels past
    Cin zero."""
    cout, cin = wq.shape[:2]
    taps = wq[0, 0].numel()
    g = -(-cin // 4)
    w = wq.reshape(cout, cin, taps).permute(2, 1, 0)  # [taps, Cin, Cout]
    w = F.pad(w, (0, 0, 0, 4 * g - cin)).reshape(taps, g, 4, cout).to(torch.int32) & 0xFF
    words = w[:, :, 0] | (w[:, :, 1] << 8) | (w[:, :, 2] << 16) | (w[:, :, 3] << 24)
    return words.contiguous()


def _check_conv(xq, s_x, s_w, bias, out_dtype, cout: int) -> None:
    if xq.dtype != torch.int8:
        raise TypeError(f"int8 conv takes an int8 x, got {xq.dtype}")
    if out_dtype not in OUT_KINDS:
        raise TypeError(f"int8 conv writes int32, float32 or bfloat16, not {out_dtype}")
    tensors = [t for t in (s_x, s_w, bias) if t is not None]
    if any(t.device != xq.device for t in tensors):
        raise ValueError("int8 conv: x, scales and bias must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("int8 conv: scales and bias must be float32")
    if out_dtype != torch.int32 and (s_x is None or s_w is None):
        raise ValueError("int8 conv: a dequantised output needs both scales")
    if s_x is not None and tuple(s_x.shape) != (xq.shape[0],):
        raise ValueError(f"s_x {tuple(s_x.shape)} does not match batch {xq.shape[0]}")
    for t, what in ((s_w, "s_w"), (bias, "bias")):
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{what} {tuple(t.shape)} does not match Cout {cout}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def conv3d_s8_kernel(xq: torch.Tensor, s_x, w1: torch.Tensor, s_w, bias,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """S1: xq [B, D, H, W, Cin] int8 (Cin % 16 == 0), w1 [Cout, 27, Cin]
    int8 (``s1_weights``), s_x [B], s_w [Cout] and bias [Cout] fp32 (bias
    may be None; both scales may be None for the int32 output). Counted as
    ``conv3d_s8``; the tiles are ``igemm_plan``'s."""
    return _s1_block("s1", xq, s_x, w1, s_w, bias, out_dtype)


def conv3d_s8_strided_kernel(xq: torch.Tensor, s_x, w1: torch.Tensor, s_w, bias,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The Downsample on S1's block: the 3x3x3 conv at stride (1, 2, 2),
    pads (1, 1), of xq [B, D, H, W, Cin] int8 (Cin % 16 == 0) -> [B, D,
    ceil(H/2), ceil(W/2), Cout]; the other arguments as for S1. Counted as
    ``conv3d_s8_strided``; the tiles are ``igemm_plan``'s on the output."""
    return _s1_block("s1_strided", xq, s_x, w1, s_w, bias, out_dtype)


def conv2d_s8_kernel(xq: torch.Tensor, s_x, w9: torch.Tensor, s_w, bias,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 2-D 3x3 stride-1 conv with pads (1, 1) on S1's block: xq [B, H,
    W, Cin] int8 (Cin % 16 == 0), w9 [Cout, 9, Cin] int8
    (``s1_2d_weights``); the other arguments as for S1. Counted as
    ``conv2d_s8``; the tiles are ``igemm_plan``'s on [B, 1, H, W]."""
    return _s1_block("s1_2d", xq, s_x, w9, s_w, bias, out_dtype)


def conv2d_s8_strided_kernel(xq: torch.Tensor, s_x, w9: torch.Tensor, s_w, bias,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 2-D Downsample on S1's block: the 3x3 conv at stride (2, 2),
    pads (1, 1), of xq [B, H, W, Cin] int8 (Cin % 16 == 0) -> [B, ceil(H/2),
    ceil(W/2), Cout]; the other arguments as for ``conv2d_s8_kernel``.
    Counted as ``conv2d_s8_strided``; the tiles are ``igemm_plan``'s on the
    output."""
    return _s1_block("s1_2d_strided", xq, s_x, w9, s_w, bias, out_dtype)


def conv1d_s8_kernel(xq: torch.Tensor, s_x, w3: torch.Tensor, s_w, bias,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 1-D 3-tap stride-1 conv with pads (1, 1) on S1's block: xq [B,
    W, Cin] int8 (Cin % 16 == 0), w3 [Cout, 3, Cin] int8
    (``s1_1d_weights``); the other arguments as for S1. Counted as
    ``conv1d_s8``; the tiles are ``igemm_plan``'s on [B, 1, 1, W]."""
    return _s1_block("s1_1d", xq, s_x, w3, s_w, bias, out_dtype)


def conv1d_s8_strided_kernel(xq: torch.Tensor, s_x, w3: torch.Tensor, s_w, bias,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 1-D Downsample on S1's block: the 3-tap conv at stride 2, pads
    (1, 1), of xq [B, W, Cin] int8 (Cin % 16 == 0) -> [B, ceil(W/2), Cout];
    the other arguments as for ``conv1d_s8_kernel``. Counted as
    ``conv1d_s8_strided``; the tiles are ``igemm_plan``'s on the output."""
    return _s1_block("s1_1d_strided", xq, s_x, w3, s_w, bias, out_dtype)


def _s1_block(route: str, xq, s_x, w1, s_w, bias, out_dtype) -> torch.Tensor:
    """S1's block on ``route`` (``S1_ROUTES``: its launcher and count
    name, its source csrc/<source>.cu, the stride along H and W (W alone
    in 1-D) and the taps; pads (1, 1)). A 2-D x [B, H, W, Cin] is the
    volume [B, 1, H, W, Cin] over the 1x3x3 taps, a 1-D x [B, W, Cin] the
    volume [B, 1, 1, W, Cin] over the 1x1x3 taps."""
    name, source, sw, taps = S1_ROUTES[route]
    check_no_autograd(name, xq, s_x, s_w, bias)
    if xq.device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {xq.device}")
    rank = {27: 5, 9: 4, 3: 3}[taps]
    if xq.dim() != rank or w1.dim() != 3 or tuple(w1.shape[1:]) != (taps, xq.shape[-1]):
        raise ValueError(f"{name} takes x [B,{'D,H,' if taps == 27 else 'H,' if taps == 9 else ''}"
                         f"W,Cin] and w [Cout,{taps},Cin]; got {tuple(xq.shape)} and "
                         f"{tuple(w1.shape)}")
    b, d, h, w = (xq.shape[0], *(1,) * (5 - rank), *xq.shape[1:-1])
    cin = xq.shape[-1]
    cout = w1.shape[0]
    _check_conv(xq, s_x, s_w, bias, out_dtype, cout)
    if w1.dtype != torch.int8 or w1.device != xq.device:
        raise TypeError(f"{name}: w must be int8 on {xq.device}")
    max_cin = S1_MAX_CIN if taps == 27 else INT32_MAX // (127 * 127 * taps)
    if cin % S1_CIN_MULTIPLE or cin > max_cin:
        raise ValueError(f"{name} takes Cin % 16 == 0 up to {max_cin}, got {cin}")
    if not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned x")
    # the tap set's extent along D, H (1 where it stays on the centre) and W
    kd, kh = (3, 3) if taps == 27 else (1, 3) if taps == 9 else (1, 1)
    spatial = conv_out_spatial((d, h, w), (kd, kh, 3), (1, sw if kh == 3 else 1, sw),
                               ((kd // 2,) * 2, (kh // 2,) * 2, (1, 1)))
    out_shape = (b, *spatial, cout)
    if max(xq.numel(), math.prod(out_shape), taps * cin * cout) > INT32_MAX:
        raise ValueError(f"{name}: shape {tuple(xq.shape)} -> {cout} is out of its range")
    plan = tuple(igemm_plan((*out_shape[:-1], cin), cout, sms=sm_count(xq.device.index)))
    w1 = w1.contiguous()
    out = torch.empty(out_shape, dtype=out_dtype, device=xq.device)
    lib = _library(source)
    with on_device(xq.device):
        code = getattr(lib, name)(xq.data_ptr(), w1.data_ptr(), _ptr(s_x), _ptr(s_w),
                                  _ptr(bias), out.data_ptr(), b, d, h, w, cin, cout, *plan,
                                  OUT_KINDS[out_dtype], _stream(xq.device))
    _build.check(code, lib, f"{source}_error_string",
                 f"{name}({tuple(xq.shape)} -> {cout}, plan {plan})")
    launch_counts[name] += 1
    return out.reshape(b, *spatial[5 - rank:], cout)


def conv_s8_general_kernel(xq: torch.Tensor, s_x, w2: torch.Tensor, s_w, bias,
                           kernel_size: Sequence[int], stride: Sequence[int],
                           pads: Sequence[tuple[int, int]],
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """S2: xq [B, *spatial, Cin] int8 of rank 1-3, w2 the packed words
    [taps, ceil(Cin/4), Cout] int32 (``s2_weights``), scales and bias as for
    S1; explicit (lo, hi) pads. Counted as ``conv_s8_general``."""
    check_no_autograd("conv_s8_general", xq, s_x, s_w, bias)
    if xq.device.type != "cuda":
        raise RuntimeError(f"conv_s8_general has no kernel for device {xq.device}")
    dims = len(kernel_size)
    cout = w2.shape[-1]
    int8_conv_route(tuple(xq.shape), kernel_size, stride, pads, cout)  # raises off its range
    _check_conv(xq, s_x, s_w, bias, out_dtype, cout)
    taps = 1
    for k in kernel_size:
        taps *= k
    cin = xq.shape[-1]
    if tuple(w2.shape) != (taps, -(-cin // 4), cout) or w2.dtype != torch.int32:
        raise ValueError(f"conv_s8_general: packed weights {tuple(w2.shape)} {w2.dtype} do not "
                         f"match x {tuple(xq.shape)}, kernel {tuple(kernel_size)}")
    out_spatial = conv_out_spatial(xq.shape[1:-1], kernel_size, stride, pads)
    pad3 = lambda v, fill: (fill,) * (3 - dims) + tuple(v)  # noqa: E731
    spatial = pad3(xq.shape[1:-1], 1)
    args = [xq.shape[0], *spatial, cin, cout, *pad3(kernel_size, 1), *pad3(stride, 1),
            *pad3([lo for lo, _ in pads], 0), *pad3(out_spatial, 1)]
    dims_arg = (ctypes.c_int * 18)(*args)
    xq = xq.contiguous()
    out = torch.empty((xq.shape[0], *out_spatial, cout), dtype=out_dtype, device=xq.device)
    lib = _library()
    with on_device(xq.device):
        code = lib.conv_s8_general(xq.data_ptr(), w2.contiguous().data_ptr(), _ptr(s_x),
                                   _ptr(s_w), _ptr(bias), out.data_ptr(), dims_arg,
                                   OUT_KINDS[out_dtype], _stream(xq.device))
    _build.check(code, lib, "conv_int8_error_string",
                 f"conv_s8_general({tuple(xq.shape)} -> {cout}, kernel {tuple(kernel_size)}, "
                 f"stride {tuple(stride)}, pads {tuple(pads)})")
    launch_counts["conv_s8_general"] += 1
    return out
