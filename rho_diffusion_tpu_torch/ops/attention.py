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
:102-114) is the all-to-all head scatter (``parallel.ulysses``), with each
rank's full-T attention on the flash kernels; where the heads do not divide
by the context ranks (or without a context mesh) it is full attention, as
in JAX.

Inside a rank that holds a depth slab of the volume
(``parallel.spmd.run_ranks`` under spatial sharding), q, k and v are the
rank's contiguous token range (the UNet flattens depth-major), so every
call is an exchange between the context ranks: the ring ("auto", "ring";
the differentiable "xla" ring, or K6 with ``RHO_RING_ATTN_IMPL=rdma``) or
Ulysses runs on the shards where they lie, and "flash", "xla" and the
Ulysses fallback gather the tokens, attend and hand each rank its rows.
"""
from __future__ import annotations

import os

import torch

from rho_diffusion_tpu_torch.ops.kernels.flash_attention import flash_attention
from rho_diffusion_tpu_torch.parallel import spmd
from rho_diffusion_tpu_torch.parallel.context import context_sharded_attention, ring_attention
from rho_diffusion_tpu_torch.parallel.context_rdma import ring_attention_rdma_shards
from rho_diffusion_tpu_torch.parallel.mesh import CONTEXT_AXIS, get_active_mesh
from rho_diffusion_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_sharded_attention

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


def single_device_backend(head_dim: int = 0) -> str:
    """The backend "auto" picks without a ring: "flash" for head dims up to
    256, unless ``set_attention_backend("xla")``."""
    return "flash" if _AUTO_BACKEND == "auto" and head_dim <= 256 else "xla"


def _full_over_shards(backend: str):
    """Full attention of the gathered shards, each rank's rows handed back."""
    attend = flash_attention if backend == "flash" else xla_attention

    def fn(parts):
        first = parts[0][0].device
        q, k, v = (torch.cat([p[i].to(first) for p in parts], dim=1) for i in range(3))
        o = attend(q, k, v)
        tl = parts[0][0].shape[1]
        return [o[:, r * tl:(r + 1) * tl].to(p[0].device) for r, p in enumerate(parts)]

    return fn


def _slab_attention(q, k, v, backend: str) -> torch.Tensor:
    """Attention inside a rank that holds a depth slab: q, k, v are its
    token range [B, T/n, H, D] of the whole [B, T, H, D]."""
    n = spmd.spatial_rank().group.n
    if backend == "auto":
        backend = "ring"
    if backend == "ulysses" and q.shape[2] % n:
        backend = "xla"  # JAX's fallback: full attention when heads % context != 0
    if backend == "ring":
        impl = os.environ.get("RHO_RING_ATTN_IMPL", "xla")
        if impl == "rdma":
            fn = lambda parts: ring_attention_rdma_shards(  # noqa: E731
                *zip(*parts), plain=_AUTO_BACKEND == "xla")
        elif impl == "xla":
            fn = lambda parts: ring_attention(*zip(*parts))  # noqa: E731
        else:
            raise ValueError(f"unknown ring-attention impl {impl!r}: 'xla' | 'rdma'")
    elif backend == "ulysses":
        fn = lambda parts: ulysses_attention(  # noqa: E731
            *(list(x) for x in zip(*parts)), backend=single_device_backend(q.shape[-1]))
    elif backend in ("flash", "xla"):
        fn = _full_over_shards(backend)
    else:
        raise ValueError(f"Unknown attention backend '{backend}'")
    return spmd.exchange((q, k, v), fn)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, backend: str = "auto",
) -> torch.Tensor:
    """Dispatching multi-head attention. q, k, v: [B, T, H, D].

    Backends: "xla" (the plain einsum path), "flash" (the hand-written
    kernel), "ring" (context-parallel over the active mesh's context axis;
    where it does not apply, full attention, as in JAX :97-100), "ulysses"
    (the all-to-all head scatter; full attention where it does not apply,
    JAX :102-113), "auto" (ring under a context mesh, else flash for
    head_dim <= 256, else xla). Inside a rank holding a depth slab, see the
    module docstring.
    """
    if spmd.spatial_rank() is not None:
        return _slab_attention(q, k, v, backend)
    if backend == "auto":
        backend = "ring" if _ring_capable(q) else single_device_backend(q.shape[-1])
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
        mesh = get_active_mesh()
        if not _ring_capable(q) or q.shape[2] % mesh.shape[CONTEXT_AXIS]:
            # needs heads % context == 0 on top of the ring's conditions
            return xla_attention(q, k, v)
        return ulysses_sharded_attention(q, k, v, mesh)
    raise ValueError(f"Unknown attention backend '{backend}'")
