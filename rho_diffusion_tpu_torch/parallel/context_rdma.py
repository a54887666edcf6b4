"""Ring attention over one context group with K6: one kernel launch per
device, every rank's K/V shard read where it lies.

Port of ``rho_diffusion_tpu/parallel/context_rdma.py`` (``_kernel`` and
``ring_attention_rdma``, :50-189). The TPU kernel owns the whole ring: K/V
in a 2-slot VMEM buffer, an async remote copy of slot ``cur`` to the right
neighbour's slot ``nxt`` before the compute on slot ``cur``, a REGULAR
semaphore for backpressure, and the (m, l, acc) state in VMEM. At step s
rank r folds the shard of rank (r - s) mod n.

The port computes the same function, in the same fold order, without the
slots: on the H100 a rank's blocks can read every shard, so nothing has to
rotate.

* **Fold order.** Rank r folds shards r, r-1, ..., r-n+1 (mod n), the
  order in which the TPU ring delivers them.
* **One launch per device.** ``ring_attention_fold`` (K6,
  ``ops/kernels/ring_attention.py``) covers every rank on one device in one
  launch, and keeps each query row's (m, l, acc) in registers across all n
  shards.
* **All ranks on q's card** (chip_smoke's context=4 mesh on one card): the
  shards are strided views of q, k, v (the UNet's fused qkv is read in
  place), each rank's output is written straight into the [B, T, H, D]
  result at its token offset, and the call is one launch: no copy, no
  event, no stream of its own.
* **Ranks on other cards**: each rank's q, k and v shards are filled once,
  contiguous, onto its own card (on q's card too: the kernel takes one
  stride set for all shards; PyTorch orders a copy between cards after
  both cards' current streams); each card records one event after its
  fills. A card's
  launch waits for the fill events of every other card, since it reads
  every shard (over NVLink, with peer access; a pair without it raises).
  Then every device's current stream waits for every launch before the
  shards are freed, and each rank's output is copied into the result.

On the CPU, and with ``plain=True`` on any device, the same fold runs with
the plain version (the reference that chip_smoke holds the kernel against).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import check_no_autograd
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import (
    check_peer_access, kernel_head_dim, ring_attention_fold, ring_attention_fold_plain)
from rho_diffusion_tpu_torch.parallel.mesh import canonical_device

LOG2E = 1.4426950408889634


def _event(device: torch.device):
    return torch.cuda.Event() if device.type == "cuda" else None


def _record(event, device: torch.device) -> None:
    if event is not None:
        event.record(torch.cuda.current_stream(device))


def _wait(device: torch.device, event) -> None:
    if event is not None and device.type == "cuda":
        torch.cuda.current_stream(device).wait_event(event)


def _kernel_ring(devices: Sequence[torch.device], plain: bool) -> bool:
    """Whether a ring over ``devices`` runs K6 (else its plain version):
    raises for a ring that mixes the CPU and cards, or whose cards cannot
    read each other's memory, before anything moves."""
    on_card = {dev.type == "cuda" for dev in devices}
    if len(on_card) != 1:
        raise ValueError(f"ring attention: a ring's ranks are all on CUDA or all on the CPU, "
                         f"got {devices}")
    kernel = on_card == {True} and not plain
    if kernel:
        check_peer_access(devices)
    return kernel


def ring_attention_rdma(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, devices: Sequence[torch.device],
    plain: bool = False,
) -> torch.Tensor:
    """Exact attention of [B, T, H, D] q, k, v over a ring of
    ``len(devices)`` ranks: rank r owns tokens [r T/n, (r + 1) T/n) of each
    and folds the K/V shards in the ring's order. Returns [B, T, H, D] on
    q's device, in q's dtype. Forward only, as in JAX. ``plain`` folds with
    the plain version on any device."""
    check_no_autograd("ring_attention", q, k, v)
    devices = [canonical_device(d) for d in devices]
    n = len(devices)
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"ring attention: {t} tokens do not split over {n} ranks")
    dk = kernel_head_dim(d) if _kernel_ring(devices, plain) else d
    if dk != d:
        q, k, v = (F.pad(x, (0, dk - d)) for x in (q, k, v))
    tl = t // n
    src = q.device
    out = torch.empty((b, t, h, dk), dtype=q.dtype, device=src)

    def rows(x, r):
        return x[:, r * tl:(r + 1) * tl]

    if all(dev == src for dev in devices):
        ring_attention_rdma_shards(*([rows(x, r) for r in range(n)] for x in (q, k, v)),
                                   plain=plain, outs=[rows(out, r) for r in range(n)],
                                   head_dim=d)
    else:
        # contiguous on each rank's device, so that every shard has one stride set
        outs = ring_attention_rdma_shards(
            *([rows(x, r).to(dev).contiguous() for r, dev in enumerate(devices)]
              for x in (q, k, v)), plain=plain, head_dim=d)
        for r, o in enumerate(outs):
            rows(out, r).copy_(o)
    return out[..., :d] if dk != d else out


def ring_attention_rdma_shards(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                               vs: Sequence[torch.Tensor], plain: bool = False,
                               outs: Optional[Sequence[torch.Tensor]] = None,
                               head_dim: Optional[int] = None) -> list:
    """The ring over shards that already lie on their ranks' devices (a
    depth-sharded volume's tokens): rank r's [B, T/n, H, D] in ``qs[r]``,
    ``ks[r]``, ``vs[r]``. One fold launch per device covers its ranks and
    reads every shard where it lies (on one card, the strided views of each
    rank's fused qkv, no copy). Returns each rank's output on its device, in
    q's dtype, or writes it into ``outs``; ``head_dim`` is the true head dim
    of shards already zero-padded to the kernel's. Forward only; ``plain``
    folds with the plain version."""
    check_no_autograd("ring_attention", *qs, *ks, *vs)
    devices = [canonical_device(q.device) for q in qs]
    b, tl, h, d = qs[0].shape
    kernel = _kernel_ring(devices, plain)
    fold = ring_attention_fold if kernel else ring_attention_fold_plain
    dk = kernel_head_dim(d) if kernel else d
    if dk != d:
        qs, ks, vs = ([F.pad(x, (0, dk - d)) for x in xs] for xs in (qs, ks, vs))
    scale_log2 = LOG2E / math.sqrt(head_dim or d)
    by_device: dict = {}
    for r, dev in enumerate(devices):
        by_device.setdefault(dev, []).append(r)
    given = outs is not None
    if not given:
        outs = [torch.empty((b, tl, h, dk), dtype=qs[0].dtype, device=dev) for dev in devices]
    if len(by_device) > 1 and kernel:
        # a card's launch reads every other card's shards: it waits for their
        # producers (PyTorch orders a copy between cards after both cards'
        # current streams; peer access is checked by the fold)
        ready = {dev: _event(dev) for dev in by_device}
        for dev, event in ready.items():
            _record(event, dev)
        done = []
        for dev, ranks in by_device.items():
            for other, event in ready.items():
                if other != dev:
                    _wait(dev, event)
            fold([qs[r] for r in ranks], [outs[r] for r in ranks], ranks, ks, vs, scale_log2)
            done.append(_event(dev))
            _record(done[-1], dev)
        # no card frees or overwrites a shard before every launch has read it
        for dev in by_device:
            for event in done:
                _wait(dev, event)
    else:
        for dev, ranks in by_device.items():
            fold([qs[r] for r in ranks], [outs[r] for r in ranks], ranks, ks, vs, scale_log2)
    if given:
        return list(outs)
    return [o[..., :d] for o in outs] if dk != d else outs
