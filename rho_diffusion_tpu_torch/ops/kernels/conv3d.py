"""3x3x3 stride-1 SAME convolution on channels-last volumes, differentiable.

``conv3d(x, weight, bias)`` is the autograd Function ``Conv3d``, the port of
the JAX package's ``conv3d`` custom VJP (``rho_diffusion_tpu/ops/pallas/
conv3d.py:225-253``). x: [B, D, H, W, Cin]; weight: torch layout
[Cout, Cin, 3, 3, 3]; bias: [Cout] or None; output [B, D, H, W, Cout] in the
input dtype, accumulated in fp32.

* forward: the hand-written CUDA kernel (``csrc/conv3d.cu``, which replaces
  the TPU kernel ``conv3d_pallas``) on CUDA tensors, ``conv3d_plain`` on CPU
  tensors;
* dgrad: the same kernels on the spatially flipped, IO-transposed weights
  (the JAX package reuses its Pallas kernel the same way), counted apart as
  ``conv3d_dgrad_igemm``/``conv3d_dgrad_direct``; ``conv3d_dgrad_plain`` on
  the CPU. Skipped when x needs no gradient (the UNet's input conv);
* wgrad: ``torch.nn.grad.conv3d_weight`` on the card, as the JAX package
  leaves it to XLA; the 27 tap matmuls of ``conv3d_wgrad_plain`` on the CPU.
  cuDNN would run an fp32 wgrad (on the flagship only the fp32 Cout=1
  head's) in TF32 under torch's default; ``conv3d_wgrad`` turns
  ``torch.backends.cudnn.allow_tf32`` off for its call, so fp32 stays fp32
  in every direction, as in the kernels;
* the bias gradient is a sum over the voxels.

``plain=True`` sends both directions to the plain versions on any device (a
reference run on the card). The plain backward is written out rather than
left to autograd: autograd through ``conv3d_plain`` would save a copy of the
input for each of its 27 taps.

On the card, bf16 with Cin % 8 == 0 (the dgrad's own input channels, i.e.
the forward's Cout, for a dgrad) takes the tensor-core implicit GEMM
(``conv3d_igemm``); every other bf16 or fp32 conv (the UNet's Cin=1 input
conv, its fp32 output head and that head's dgrad) takes the direct kernel
(``conv3d_direct``). The weights are repacked per call into the layout each
kernel reads.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts

_INT32_MAX = 2**31 - 1
_TAPS = [(dz, dy, dx) for dz in range(3) for dy in range(3) for dx in range(3)]


def conv3d_plain(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version: the 27-tap sum of channel matmuls over shifted
    views of the zero-padded input, in fp32, cast to the input dtype. Exact
    on the CPU and independent of cuDNN."""
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    wf = weight.float()
    out = torch.zeros((b * d * h * w, cout), dtype=torch.float32, device=x.device)
    for dz, dy, dx in _TAPS:
        tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
        out.addmm_(tap, wf[:, :, dz, dy, dx].T)
    if bias is not None:
        out += bias.float()
    return out.reshape(b, d, h, w, cout).to(x.dtype)


def dgrad_weight(weight: torch.Tensor) -> torch.Tensor:
    """[Cout, Cin, 3, 3, 3] -> the dgrad conv's [Cin, Cout, 3, 3, 3]:
    spatially flipped, input and output channels swapped."""
    return weight.flip(2, 3, 4).transpose(0, 1)


def conv3d_dgrad_plain(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain input gradient: ``conv3d_plain`` on the flipped,
    IO-transposed weights, in g's dtype."""
    return conv3d_plain(g, dgrad_weight(weight).to(g.dtype))


def conv3d_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain weight gradient [Cout, Cin, 3, 3, 3]: for each tap,
    g^T times the shifted input, in fp32, cast to x's dtype."""
    b, d, h, w, cin = x.shape
    cout = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gt = g.float().reshape(-1, cout).T
    dw = torch.empty((cout, cin, 3, 3, 3), dtype=torch.float32, device=x.device)
    for dz, dy, dx in _TAPS:
        dw[:, :, dz, dy, dx] = gt @ xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
    return dw.to(x.dtype)


def conv3d_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight gradient on the card: the library's conv weight gradient
    on channels-last views (no copy), in x's dtype, without TF32."""
    shape = (g.shape[-1], x.shape[-1], 3, 3, 3)
    allow_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return torch.nn.grad.conv3d_weight(x.movedim(-1, 1), shape, g.movedim(-1, 1), padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = allow_tf32


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dim() != 5 or weight.dim() != 5 or tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(
            f"conv3d takes x [B,D,H,W,Cin] and weight [Cout,Cin,3,3,3]; got "
            f"{tuple(x.shape)} and {tuple(weight.shape)}",
        )
    if weight.shape[1] != x.shape[-1]:
        raise ValueError(f"weight {tuple(weight.shape)} does not match x {tuple(x.shape)}")
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("conv3d: x, weight and bias must be on one device")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(
            f"conv3d: weight and bias must have x's dtype {x.dtype}; got "
            f"{[t.dtype for t in tensors]}",
        )
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match Cout {weight.shape[0]}")


def conv3d_kernel(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    kind: str = "conv3d",
) -> torch.Tensor:
    """Launch the CUDA conv (igemm or direct, as the class docstring says)
    and count it as ``<kind>_igemm`` or ``<kind>_direct``."""
    check_no_autograd(kind, x, weight, bias)
    _check(x, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3d has no kernel for device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"conv3d kernel takes bfloat16 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("conv3d kernel needs a contiguous channels-last x")
    b, d, h, w, cin = x.shape
    cout = weight.shape[0]
    if max(x.numel(), b * d * h * w * cout, 27 * cin * cout) > _INT32_MAX:
        raise ValueError(f"conv3d: shape {tuple(x.shape)} -> {cout} is out of the kernel's range")
    out = torch.empty((b, d, h, w, cout), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16 and cin % 8 == 0:
        if x.data_ptr() % 16:
            raise ValueError("conv3d kernel needs a 16-byte aligned x")
        # [Cout, Cin, dz, dy, dx] -> [Cout, 27*Cin], k = tap*Cin + ci
        wk = weight.permute(0, 2, 3, 4, 1).reshape(cout, 27 * cin).contiguous()
        fn, name = "conv3d_igemm_bf16", f"{kind}_igemm"
    else:
        # [Cout, Cin, dz, dy, dx] -> [27*Cin, Cout]
        wk = weight.permute(2, 3, 4, 1, 0).reshape(27 * cin, cout).contiguous()
        fn = "conv3d_direct_bf16" if x.dtype == torch.bfloat16 else "conv3d_direct_f32"
        name = f"{kind}_direct"
    bk = bias.contiguous() if bias is not None else None
    lib = _build.load("conv3d")
    launcher = getattr(lib, fn)
    launcher.restype = ctypes.c_int
    launcher.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = launcher(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr() if bk is not None else None,
            out.data_ptr(), b, d, h, w, cin, cout, stream,
        )
    _build.check(code, lib, "conv3d_error_string", f"{fn}({tuple(x.shape)} -> {cout})")
    launch_counts[name] += 1
    return out


def conv3d_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Input gradient of the conv: the CUDA kernels on the flipped,
    IO-transposed weights on the card, the plain version on the CPU."""
    if g.device.type == "cpu":
        return conv3d_dgrad_plain(g, weight)
    return conv3d_kernel(g.contiguous(), dgrad_weight(weight).to(g.dtype), None, "conv3d_dgrad")


class Conv3d(torch.autograd.Function):
    """The conv with the kernels' (or the plain versions') forward, dgrad
    and wgrad."""

    @staticmethod
    def forward(ctx, x, weight, bias, plain: bool):
        ctx.plain = plain or x.device.type == "cpu"
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, weight)
        if ctx.plain:
            return conv3d_plain(x, weight, bias)
        return conv3d_kernel(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        dx = dw = db = None
        if need_x:
            dx = conv3d_dgrad_plain(g, weight) if ctx.plain else conv3d_dgrad(g, weight)
        if need_w:
            dw = conv3d_wgrad_plain(x, g) if ctx.plain else conv3d_wgrad(x, g)
        if ctx.has_bias and need_b:
            db = g.float().sum(dim=(0, 1, 2, 3)).to(g.dtype)
        return dx, dw, db, None


def conv3d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """3x3x3 SAME stride-1 conv, differentiable: the CUDA kernels on the
    card, the plain versions on the CPU (or everywhere with ``plain``)."""
    _check(x, weight, bias)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv3d has no kernel for device {x.device}")
    return Conv3d.apply(x, weight, bias, plain)
