"""3x3x3 stride-1 SAME convolution on channels-last volumes.

``conv3d(x, weight, bias)`` runs the hand-written CUDA kernel
(``csrc/conv3d.cu``, which replaces the TPU kernel ``conv3d_pallas`` of
``rho_diffusion_tpu/ops/pallas/conv3d.py``) on CUDA tensors, and
``conv3d_plain`` on CPU tensors. x: [B, D, H, W, Cin]; weight: torch layout
[Cout, Cin, 3, 3, 3]; bias: [Cout] or None; output [B, D, H, W, Cout] in the
input dtype, accumulated in fp32.

On the card, bf16 with Cin % 8 == 0 takes the tensor-core implicit GEMM
(``conv3d_igemm``); every other bf16 or fp32 conv (the UNet's Cin=1 input
conv and fp32 output head) takes the direct kernel (``conv3d_direct``). The
weights are repacked per call into the layout each kernel reads.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, launch_counts

_INT32_MAX = 2**31 - 1


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
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                tap = xp[:, dz:dz + d, dy:dy + h, dx:dx + w, :].reshape(-1, cin)
                out.addmm_(tap, wf[:, :, dz, dy, dx].T)
    if bias is not None:
        out += bias.float()
    return out.reshape(b, d, h, w, cout).to(x.dtype)


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


def conv3d(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """3x3x3 SAME stride-1 conv: the CUDA kernel on the card, the plain
    version on the CPU."""
    _check(x, weight, bias)
    if x.device.type == "cpu":
        return conv3d_plain(x, weight, bias)
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
        fn, name = "conv3d_igemm_bf16", "conv3d_igemm"
    else:
        # [Cout, Cin, dz, dy, dx] -> [27*Cin, Cout]
        wk = weight.permute(2, 3, 4, 1, 0).reshape(27 * cin, cout).contiguous()
        fn = "conv3d_direct_bf16" if x.dtype == torch.bfloat16 else "conv3d_direct_f32"
        name = "conv3d_direct"
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
