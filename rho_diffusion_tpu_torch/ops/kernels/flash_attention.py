"""Flash attention forward (non-causal) for [B, T, H, D] tensors.

``flash_attention(q, k, v)`` runs the hand-written CUDA kernel
(``csrc/flash_attention.cu``, which replaces the TPU kernels
``_fwd_kernel_onepass`` and ``_fwd_kernel`` of
``rho_diffusion_tpu/ops/pallas/flash_attention.py``) on CUDA bf16 or fp32
tensors, and its plain version, ``ops.attention.xla_attention``, on CPU
tensors. Scores and softmax are fp32 at 1/sqrt(D); any T; no log-sum-exp
(this is the forward-only sampling path).

q, k, v may be strided views (the UNet's split of one qkv projection) as long
as D is contiguous; head dims other than 16/32/64/128/256 are zero-padded up
to the next one (padding changes neither Q K^T nor the kept columns of P V).
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, launch_counts

HEAD_DIMS = (16, 32, 64, 128, 256)
_ENTRY = {torch.bfloat16: "flash_attention_fwd_bf16", torch.float32: "flash_attention_fwd_f32"}
_LOG2E = 1.4426950408889634


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain version: the JAX package's reference einsum attention."""
    from rho_diffusion_tpu_torch.ops.attention import xla_attention

    return xla_attention(q, k, v)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q, k, v of shape [B, T, H, D]")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} disagree",
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must be on one device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention [B, T, H, D] -> [B, T, H, D]: the CUDA kernel on
    the card, the plain version on the CPU."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention kernel takes bfloat16 or float32, got {q.dtype}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention kernel takes head_dim <= 256, got {d}")
    if b * h > 65535 or max(tq, tk) > 2**31 - 1:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} is out of the kernel's range")
    dk = next(x for x in HEAD_DIMS if x >= d)
    if dk != d:
        q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
    for t in (q, k, v):
        if (t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                "flash_attention kernel needs D contiguous, B/T/H strides that "
                f"are multiples of 16 bytes and 16-byte aligned data; got strides {t.stride()}",
            )
    out = torch.empty((b, tq, h, dk), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]),
    )
    lib = _build.load("flash_attention")
    fn = getattr(lib, _ENTRY[q.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    scale_log2 = _LOG2E / math.sqrt(d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, tq, tk, dk, ctypes.addressof(strides), scale_log2, stream,
        )
    _build.check(code, lib, "flash_attention_error_string", f"flash_attention({tuple(q.shape)})")
    launch_counts["flash_attention"] += 1
    return out[..., :d] if dk != d else out
