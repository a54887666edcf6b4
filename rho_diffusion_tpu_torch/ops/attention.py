"""Multi-head self-attention over flattened spatial tokens, [B, T, H, D].

Port of ``rho_diffusion_tpu/ops/attention.py``:

* ``xla_attention`` — the plain path, a copy of the JAX package's reference
  einsum attention: q and k each scaled by 1/sqrt(sqrt(d)) in the compute
  dtype, the softmax in fp32 and cast back;
* ``attention()`` — sends every call with head_dim <= 256 to the
  hand-written flash kernels (``ops.kernels.flash_attention``, a
  differentiable autograd Function: the CUDA forward and backward kernels,
  bf16 or fp32, on the card; the plain versions on the CPU), whatever
  the length or dtype, as the JAX dispatcher does. No
  sequence-length threshold is applied: the JAX package's
  ``FLASH_MIN_SEQ_LEN`` was measured on a TPU, and one for the H100 has not
  been measured yet.

``set_attention_backend("xla")`` sends every "auto" call to the plain path
(a reference run on the card, differentiated by autograd).
"""
from __future__ import annotations

import torch

from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention

_AUTO_BACKEND = "auto"


def set_attention_backend(mode: str) -> None:
    """What ``backend="auto"`` resolves to: "auto" (flash where the kernel
    applies) or "xla" (the plain path everywhere)."""
    global _AUTO_BACKEND
    if mode not in ("auto", "xla"):
        raise ValueError(f"attention backend must be 'auto' or 'xla', got {mode!r}")
    _AUTO_BACKEND = mode


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Reference einsum attention. q, k, v: [B, T, H, D] -> [B, T, H, D]."""
    d = q.shape[-1]
    scale = (1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(d))))).to(q.dtype).to(q.device)
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k * scale)
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", weights, v)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, backend: str = "auto",
) -> torch.Tensor:
    """Dispatching multi-head attention. q, k, v: [B, T, H, D].

    Backends: "xla" (the plain einsum path), "flash" (the hand-written
    kernel), "auto" (flash for head_dim <= 256, else xla)."""
    if backend == "auto":
        use_flash = _AUTO_BACKEND == "auto" and q.shape[-1] <= 256
        backend = "flash" if use_flash else "xla"
    if backend == "xla":
        return xla_attention(q, k, v)
    if backend == "flash":
        return flash_attention(q, k, v)
    raise ValueError(f"Unknown attention backend '{backend}'")
