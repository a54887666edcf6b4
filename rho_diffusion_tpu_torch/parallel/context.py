"""Context (sequence) parallelism: ring attention over the "context" mesh
axis.

Port of ``rho_diffusion_tpu/parallel/context.py:31-132``. The token axis of
[B, T, H, D] attention inputs is split over the context ranks; each rank
attends its T/n queries to every K/V shard as the shards rotate around the
ring, and the partial results merge by their log-sum-exp, so the result is
exact full attention. Two implementations, picked by ``impl`` or
``RHO_RING_ATTN_IMPL`` (default "xla"):

* "xla": ``ring_attention``, the JAX package's ppermute ring in plain
  PyTorch (:31-81): each block's attention with the double-sqrt scaling in
  the input dtype and an fp32 softmax, merged in fp32. It is
  differentiable, as in JAX.
* "rdma": K6's ring, one hand-written kernel launch per device that folds
  every shard in the ring's order (``parallel/context_rdma.py``). Forward
  only, as in JAX.

The JAX package runs the ring inside ``shard_map``, one program per device.
The port drives every rank from one process: the shards move to their
ranks' devices (a mesh may place several ranks on one device), the ring
runs, and the output is gathered back to q's device.
"""
from __future__ import annotations

import os

import torch

from rho_diffusion_tpu_torch.parallel.context_rdma import ring_attention_rdma
from rho_diffusion_tpu_torch.parallel.mesh import CONTEXT_AXIS, DATA_AXIS, Mesh


def _block_attention_with_lse(q, k, v):
    """Full attention over one K/V block, returning the normalised output
    and the per-query natural log-sum-exp. q/k/v: [B, T, H, D] ->
    (o, lse [B, T, H] fp32)."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.sqrt(torch.tensor(float(d)))).to(q.dtype).to(q.device)
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k * scale).float()
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    o = torch.einsum("bhts,bshd->bthd", (p / l).to(q.dtype), v)
    lse = (m + torch.log(l))[..., 0]  # [B, H, T]
    return o, lse.transpose(1, 2)


def _merge(o1, lse1, o2, lse2):
    """Online-softmax merge of two partial attention results."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    o = o1 * (w1 / denom)[..., None].to(o1.dtype) + o2 * (w2 / denom)[..., None].to(o2.dtype)
    return o, m + torch.log(denom)


def ring_attention(qs, ks, vs) -> list[torch.Tensor]:
    """The "xla" ring over per-rank shards: ``qs[r]``, ``ks[r]``, ``vs[r]``
    are rank r's [B, T/n, H, D] on its device. Each of the n - 1 rotations
    moves every K/V shard one rank to the right (JAX's ppermute j -> j+1).
    Returns each rank's output shard."""
    n = len(qs)
    state = [_block_attention_with_lse(q, k, v) for q, k, v in zip(qs, ks, vs)]
    for _ in range(1, n):
        ks = [ks[(r - 1) % n].to(qs[r].device) for r in range(n)]
        vs = [vs[(r - 1) % n].to(qs[r].device) for r in range(n)]
        state = [_merge(o, lse, *_block_attention_with_lse(q, k, v))
                 for (o, lse), q, k, v in zip(state, qs, ks, vs)]
    return [o for o, _ in state]


def context_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    impl: str | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Global entry point: shards the token axis of [B, T, H, D] inputs over
    the mesh's context axis and runs ring attention. T must divide by the axis size.
    The batch is also split over the data axis when it divides (:108-111),
    and each data group runs its own ring; otherwise the data groups would
    all compute the same whole batch, so data group 0 computes it once.
    Returns [B, T, H, D] on q's device.

    ``impl``: "xla" or "rdma" (``RHO_RING_ATTN_IMPL`` when None; anything
    else raises, :105-107). ``plain`` runs the "rdma" ring with K6's plain
    version on any device (the reference the kernel is held against)."""
    impl = impl or os.environ.get("RHO_RING_ATTN_IMPL", "xla")
    if impl not in ("xla", "rdma"):
        raise ValueError(f"unknown ring-attention impl {impl!r}: 'xla' | 'rdma'")
    n = mesh.shape[CONTEXT_AXIS]
    b, t = q.shape[:2]
    if t % n:
        raise ValueError(f"{t} tokens do not split over the {n} context ranks")
    n_data = mesh.shape[DATA_AXIS]
    groups = n_data if b % n_data == 0 else 1
    rows = b // groups
    outs = []
    for g in range(groups):
        devices = mesh.context_group(g)
        qg, kg, vg = (x[g * rows:(g + 1) * rows] for x in (q, k, v))
        if impl == "rdma":
            outs.append(ring_attention_rdma(qg, kg, vg, devices, plain=plain))
            continue
        tl = t // n
        shards = [[x[:, r * tl:(r + 1) * tl].to(dev) for r, dev in enumerate(devices)]
                  for x in (qg, kg, vg)]
        outs.append(torch.cat([o.to(q.device) for o in ring_attention(*shards)], dim=1))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
