"""Ring attention over one context group with K6: double-buffered K/V
rotation on copy streams, one kernel launch per rank and step.

Port of ``rho_diffusion_tpu/parallel/context_rdma.py`` (``_kernel`` and
``ring_attention_rdma``, :50-189). The TPU kernel owns the whole ring: K/V
in a 2-slot VMEM buffer, an async remote copy of slot ``cur`` to the right
neighbour's slot ``nxt`` started before the compute on slot ``cur``, and a
REGULAR semaphore for backpressure. On CUDA the copies between ranks are
the copy engine's work, outside the kernel. Each rank r of the ring owns,
on its device:

* ``kv_buf`` [2 slots, 2 (k|v), B*H, S, D] and its fp32 state m, l, acc;
* a compute stream, on which ``ring_attn_step`` (K6,
  ``ops/kernels/ring_attention.py``) folds one slot into the state;
* a comm stream, on which it copies a slot to its right neighbour
  (``dst.copy_(src, non_blocking=True)``: a device-to-device copy when the
  two ranks share a card, a peer copy over NVLink when they do not).

CUDA events stand for the semaphores. At step s (0 <= s < n), with
cur = s % 2 and nxt = (s + 1) % 2, rank r does, in this order:

1. if s < n - 1, send: its comm stream waits until
   * slot ``cur`` holds the shard it forwards: the fill of slot 0 (s = 0),
     else the left neighbour's copy of step s - 1 (**recv**);
   * the right neighbour has finished its step s - 1 compute on its slot
     ``nxt``, the slot this copy overwrites (**ready**, the backpressure of
     TPU :116-119 and :134-138);
   * the right neighbour's own outgoing copy of step s - 1, which read that
     slot, has drained (**send**);
   then copies its slot ``cur`` into the right neighbour's slot ``nxt``;
2. compute: its compute stream waits for the recv of step s - 1 (s >= 1)
   and launches K6 on slot ``cur`` (``first`` at s = 0 starts the state,
   ``last`` at s = n - 1 writes the output).

Every wait names an event recorded in step s - 1 or before, so the one
thread that enqueues the whole ring never waits on an event not yet
recorded. A ring of n = 2 sends once and waits on no ready event
(tests/parallel/test_parallel.py:516-526). Per-call tensors are allocated
on each device's current stream, every side stream waits for it first
(PyTorch itself puts a copy into another card's memory behind that card's
current stream), and every device's current stream waits for every side
stream at the end, so the caching allocator never hands out a block a side
stream still uses.

On the CPU the same protocol runs with no-op streams and events, and the
step is the plain version. Passing ``step=ring_attn_step_plain`` runs the
same protocol on the card with the plain step (the reference that
chip_smoke holds the kernel against).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import check_no_autograd
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import kernel_head_dim, ring_attn_step

LOG2E = 1.4426950408889634

_STREAMS: dict = {}  # (device, rank) -> (compute stream, comm stream)


class _NoEvent:
    """The CPU's event: its work is done when it is enqueued."""

    def record(self, stream=None) -> None:
        pass


class _NoStream:
    """The CPU's stream: work runs as it is enqueued."""

    def wait_event(self, event) -> None:
        pass


def _rank_streams(device: torch.device, rank: int):
    if device.type != "cuda":
        return _NoStream(), _NoStream()
    key = (device, rank)
    if key not in _STREAMS:
        _STREAMS[key] = (torch.cuda.Stream(device=device), torch.cuda.Stream(device=device))
    return _STREAMS[key]


def _on(stream):
    return torch.cuda.stream(stream) if isinstance(stream, torch.cuda.Stream) \
        else contextlib.nullcontext()


def _event(device: torch.device):
    return torch.cuda.Event() if device.type == "cuda" else _NoEvent()


def _current(device: torch.device):
    return torch.cuda.current_stream(device) if device.type == "cuda" else _NoStream()


def ring_attention_rdma(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, devices: Sequence[torch.device],
    step: Optional[Callable] = None,
) -> torch.Tensor:
    """Exact attention of [B, T, H, D] q, k, v over a ring of
    ``len(devices)`` ranks: rank r holds tokens [r T/n, (r + 1) T/n) of each
    and the K/V shards rotate to the right. Returns [B, T, H, D] on q's
    device, in q's dtype. Forward only, as in JAX."""
    step = step or ring_attn_step
    check_no_autograd("ring_attention", q, k, v)
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    b, t, h, d = q.shape
    if t % n:
        raise ValueError(f"ring attention: {t} tokens do not split over {n} ranks")
    tl, bh = t // n, b * h
    dk = kernel_head_dim(d) if any(dev.type == "cuda" for dev in devices) else d
    scale_log2 = LOG2E / math.sqrt(d)
    src = q.device

    def shard(x, r, dev):
        x = x[:, r * tl:(r + 1) * tl].to(dev, non_blocking=True)
        return F.pad(x, (0, dk - d)) if dk != d else x

    # per-call tensors, on each device's current stream (see the docstring)
    ranks = []
    for r, dev in enumerate(devices):
        ranks.append({
            "buf": torch.empty((2, 2, bh, tl, dk), dtype=q.dtype, device=dev),
            "m": torch.empty((bh, tl), dtype=torch.float32, device=dev),
            "l": torch.empty((bh, tl), dtype=torch.float32, device=dev),
            "acc": torch.empty((bh, tl, dk), dtype=torch.float32, device=dev),
            "o": torch.empty((b, tl, h, dk), dtype=q.dtype, device=dev),
            "streams": _rank_streams(dev, r),
        })
    start = {}
    for dev in {src, *devices}:
        start[dev] = _event(dev)
        start[dev].record(_current(dev))
    for r, (dev, rank) in enumerate(zip(devices, ranks)):
        cs, ms = rank["streams"]
        for stream in (cs, ms):
            stream.wait_event(start[dev])
        cs.wait_event(start[src])
        with _on(cs):
            rank["q"] = shard(q, r, dev)
            for i, x in enumerate((k, v)):  # [B, S, H, D] -> slot 0's [B*H, S, D]
                rank["buf"][0, i].view(b, h, tl, dk).copy_(shard(x, r, dev).permute(0, 2, 1, 3))
        rank["filled"] = _event(dev)
        rank["filled"].record(cs)

    computed = [[None] * n for _ in range(n)]  # [rank][step], on the compute stream
    copied = [[None] * n for _ in range(n)]    # [rank][step], on the comm stream
    for s in range(n):
        cur, nxt = s % 2, (s + 1) % 2
        for r, (dev, rank) in enumerate(zip(devices, ranks)):
            cs, ms = rank["streams"]
            left, right = (r - 1) % n, (r + 1) % n
            if s < n - 1:
                ms.wait_event(rank["filled"] if s == 0 else copied[left][s - 1])  # recv
                if s >= 1:
                    ms.wait_event(computed[right][s - 1])  # ready
                    ms.wait_event(copied[right][s - 1])    # send
                with _on(ms):
                    ranks[right]["buf"][nxt].copy_(rank["buf"][cur], non_blocking=True)
                copied[r][s] = _event(dev)
                copied[r][s].record(ms)
            if s >= 1:
                cs.wait_event(copied[left][s - 1])  # recv
            with _on(cs):
                step(rank["q"], rank["buf"][cur, 0], rank["buf"][cur, 1], rank["m"], rank["l"],
                     rank["acc"], rank["o"], scale_log2, s == 0, s == n - 1)
            computed[r][s] = _event(dev)
            computed[r][s].record(cs)

    done = []
    for dev, rank in zip(devices, ranks):
        for stream in rank["streams"]:
            event = _event(dev)
            event.record(stream)
            done.append(event)
    for dev in {src, *devices}:
        for event in done:
            _current(dev).wait_event(event)
    out = torch.cat([rank["o"].to(src) for rank in ranks], dim=1)
    return out[..., :d] if dk != d else out
