"""Multi-head self-attention over flattened spatial tokens, [B, T, H, D].

Port of ``rho_diffusion_tpu/ops/attention.py``:

* ``xla_attention`` — the plain path, a copy of the JAX package's reference
  einsum attention: q and k each scaled by 1/sqrt(sqrt(d)) in the compute
  dtype, the softmax in fp32 and cast back;
* ``attention()`` — under an active mesh whose context axis (> 1) divides
  the token count, "auto" picks ring attention over the context ranks
  (``parallel.context``, JAX :51-61, :77-79; "rdma" is the kernel K6).
  Otherwise it sends every call with head_dim <= 256 to the hand-written
  flash kernels (``ops.kernels.flash_attention``, a differentiable autograd
  Function: the CUDA forward and backward kernels, bf16 or fp32, on the
  card; the plain versions on the CPU), whatever the length or dtype, as the
  JAX dispatcher does. No sequence-length threshold is applied: the JAX
  package's ``FLASH_MIN_SEQ_LEN`` was measured on a TPU, and one for the
  H100 has not been measured yet.

``set_attention_backend("xla")`` sends every call to the plain paths (a
reference run on the card): "auto" to ``xla_attention`` without a context
mesh, and the "rdma" ring to K6's plain version under one. "ulysses" (JAX
:102-114) raises until ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import torch

from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention
from rho_diffusion_tpu_torch.parallel.context import context_sharded_attention
from rho_diffusion_tpu_torch.parallel.mesh import CONTEXT_AXIS, get_active_mesh

_AUTO_BACKEND = "auto"


def set_attention_backend(mode: str) -> None:
    """"auto" (the kernels where they apply) or "xla" (the plain paths
    everywhere: ``xla_attention``, and K6's plain version in the ring)."""
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


def _ring_capable(q: torch.Tensor) -> bool:
    """Ring attention applies when the calling thread's active mesh has a
    context axis > 1 that divides the token count (JAX :51-61)."""
    mesh = get_active_mesh()
    if mesh is None:
        return False
    ctx = mesh.shape[CONTEXT_AXIS]
    return ctx > 1 and q.shape[1] % ctx == 0


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, backend: str = "auto",
) -> torch.Tensor:
    """Dispatching multi-head attention. q, k, v: [B, T, H, D].

    Backends: "xla" (the plain einsum path), "flash" (the hand-written
    kernel), "ring" (context-parallel over the active mesh's context axis;
    where it does not apply, full attention, as in JAX :97-100), "auto"
    (ring under a context mesh, else flash for head_dim <= 256, else xla).
    """
    if backend == "auto":
        if _ring_capable(q):
            backend = "ring"
        else:
            use_flash = _AUTO_BACKEND == "auto" and q.shape[-1] <= 256
            backend = "flash" if use_flash else "xla"
    if backend == "xla":
        return xla_attention(q, k, v)
    if backend == "flash":
        return flash_attention(q, k, v)
    if backend == "ring":
        if not _ring_capable(q):
            # no context mesh, or tokens that do not split over it: full
            # attention is exact (JAX's own rule, :97-100)
            return xla_attention(q, k, v)
        return context_sharded_attention(q, k, v, get_active_mesh(),
                                         plain=_AUTO_BACKEND == "xla")
    if backend == "ulysses":
        raise NotImplementedError(
            "Ulysses (all-to-all) context parallelism is not ported yet "
            "(ROADMAP Queue 1 item 13); use the 'ring' backend",
        )
    raise ValueError(f"Unknown attention backend '{backend}'")
