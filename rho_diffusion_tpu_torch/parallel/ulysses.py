"""Ulysses sequence parallelism: the all-to-all head scatter.

Port of ``rho_diffusion_tpu/parallel/ulysses.py``. The alternative to ring
attention when the heads divide by the context ranks: one all-to-all turns
the token-sharded layout [B, T/n, H, D] into a head-sharded [B, T, H/n, D],
each rank runs FULL attention over its own heads, and a second all-to-all
restores the token sharding. Exact.

Here the two all-to-alls are copies between the ranks' devices (autograd
records them), and each rank's full-T attention is the port's single-device
attention: the hand-written flash kernels (K1 forward, the fused K3/K4
backward) where they apply, the plain einsum path otherwise or after
``set_attention_backend("xla")``. At the flagship's shape a rank runs D 128,
T 512 and B*H = rows * 4 / n.

* ``ulysses_attention(qs, ks, vs)``: every rank's shard in, every rank's
  output shard out (the body of JAX's ``shard_map``);
* ``ulysses_sharded_attention(q, k, v, mesh)``: the global entry, tokens
  split over the context axis (rows over "data" when they divide).
"""
from __future__ import annotations

import torch

from rho_diffusion_tpu_torch.parallel.mesh import CONTEXT_AXIS, DATA_AXIS, Mesh

__all__ = ["ulysses_attention", "ulysses_sharded_attention"]


def _local_attention(backend: str):
    from rho_diffusion_tpu_torch.ops import attention as ops_attention

    if backend == "auto":
        backend = ops_attention.single_device_backend()
    if backend not in ("flash", "xla"):
        raise ValueError(f"Ulysses runs 'flash' or 'xla' attention per rank, got {backend!r}")
    return ops_attention.flash_attention if backend == "flash" else ops_attention.xla_attention


def ulysses_attention(qs: list, ks: list, vs: list, backend: str = "auto") -> list:
    """Rank r's shard in ``qs[r]``, ``ks[r]``, ``vs[r]`` ([B, T/n, H, D], on
    its device; H % n == 0). Rank r gathers every rank's tokens of heads
    [r H/n, (r + 1) H/n), attends over all T, and the outputs go back to the
    ranks that own their tokens. Returns each rank's [B, T/n, H, D]."""
    n = len(qs)
    h = qs[0].shape[2]
    if h % n:
        raise ValueError(f"heads {h} not divisible by context={n}; use ring attention")
    hl, tl = h // n, qs[0].shape[1]
    devices = [q.device for q in qs]
    attend = _local_attention(backend)

    def scatter(xs, r):  # [B, T/n, H, D] of every rank -> [B, T, H/n, D] on rank r
        return torch.cat([x[:, :, r * hl:(r + 1) * hl].to(devices[r]) for x in xs], dim=1)

    heads = [attend(scatter(qs, r), scatter(ks, r), scatter(vs, r)) for r in range(n)]
    return [torch.cat([o[:, j * tl:(j + 1) * tl].to(devices[j]) for o in heads], dim=2)
            for j in range(n)]


def ulysses_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                              backend: str = "auto") -> torch.Tensor:
    """[B, T, H, D] attention with T split over the context axis (and B over
    "data" when it divides), each shard on its rank's device. Exact against
    full attention. Returns [B, T, H, D] on q's device."""
    n_data, n = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
    b, t = q.shape[:2]
    if t % n:
        raise ValueError(f"{t} tokens do not split over the {n} context ranks")
    groups = n_data if b % n_data == 0 else 1
    rows, tl = b // groups, t // n
    outs = []
    for g in range(groups):
        devices = mesh.context_group(g)
        shards = [[x[g * rows:(g + 1) * rows, r * tl:(r + 1) * tl].to(dev)
                   for r, dev in enumerate(devices)] for x in (q, k, v)]
        outs.append(torch.cat([o.to(q.device) for o in ulysses_attention(*shards, backend)],
                              dim=1))
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
