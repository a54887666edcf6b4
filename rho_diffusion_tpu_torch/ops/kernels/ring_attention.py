"""Ring attention (K6): one launch folds every K/V shard of a ring, in the
ring's order, into each query row of the ranks on one device.

``ring_attention_fold`` launches the hand-written kernel of
``csrc/ring_attention.cu`` (bf16 and fp32 instances), which replaces the
TPU kernel ``_kernel`` / ``ring_attention_rdma``
(``rho_diffusion_tpu/parallel/context_rdma.py:50-189``); the ring around it
(which ranks live where, fills, events) is ``parallel/context_rdma.py``.
``ring_attention_fold_plain`` is its plain version, the same fp32
arithmetic in PyTorch, one ``ring_attn_step_plain`` per shard. Both take:

* ``qs``, ``outs``: for each rank of the launch its queries and its output,
  [B, Tq, H, D] (any strides with D contiguous), all on one device;
* ``ranks``: those ranks' indices in the ring of n = ``len(ks)``;
* ``ks``, ``vs``: every rank's K and V shard, [B, S, H, D], in rank order,
  each on its own rank's device;
* ``scale_log2``: log2(e)/sqrt(d) of the true head dim d.

Rank r folds shards r, r-1, ..., r-n+1 (mod n), the order in which the TPU
ring delivers them (at step s rank r holds the shard of rank (r - s) mod
n), into the running max m of the base-2 scores s = q k^T * scale_log2, the
row sum l of exp2(s - m) and the unnormalised output acc, all fp32, and
writes o = acc / l in q's dtype. The kernel keeps (m, l, acc) in registers;
the ring pads head dims other than 16, 32, 64, 128 or 256 with zeros.

K6 has no backward, as in JAX (a bare ``pallas_call`` without
``custom_vjp``): a launch under grad mode with an input that requires grad
raises. Each launch adds one to ``launch_counts["ring_attention"]``: a ring
call makes one launch per device that holds ranks.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts

HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_RANKS = 16  # the kernel's shard table (csrc/ring_attention.cu MAX_RING)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_PEERS: set = set()  # (device, peer) pairs whose peer access is enabled


def kernel_head_dim(d: int) -> int:
    """The kernel's head dim for a true head dim ``d`` (raises past 256)."""
    for x in HEAD_DIMS:
        if x >= d:
            return x
    raise ValueError(f"ring_attention kernel takes head_dim <= 256, got {d}")


def _to_bh(q: torch.Tensor) -> torch.Tensor:
    b, t, h, d = q.shape
    return q.permute(0, 2, 1, 3).reshape(b * h, t, d)


def ring_attn_step_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, m: torch.Tensor, l: torch.Tensor,  # noqa: E741
    acc: torch.Tensor, o: Optional[torch.Tensor], scale_log2: float, first: bool, last: bool,
) -> None:
    """Fold one K/V shard into a rank's state, in fp32 (TPU :92-107 and
    :140-144, in base 2). ``q`` [B, Tq, H, D]; ``k``, ``v`` the shard as
    [B*H, S, D]; ``m``, ``l`` fp32 [B*H, Tq] and ``acc`` fp32 [B*H, Tq, D],
    updated in place; ``first`` starts the state from (-inf, 0, 0) without
    reading it; ``last`` writes ``o = acc / l`` ([B, Tq, H, D], o's dtype)."""
    check_no_autograd("ring_attention", q, k, v)
    if first:
        m.fill_(-float("inf"))
        l.zero_()
        acc.zero_()
    s = torch.einsum("ntd,nsd->nts", _to_bh(q).float(), k.float()) * scale_log2
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp2(s - m_new[..., None])
    corr = torch.exp2(m - m_new)
    l.mul_(corr).add_(p.sum(-1))
    acc.mul_(corr[..., None]).add_(torch.einsum("nts,nsd->ntd", p, v.float()))
    m.copy_(m_new)
    if last:
        b, tq, h, _ = q.shape
        out = (acc / l[..., None]).reshape(b, h, tq, -1).permute(0, 2, 1, 3)
        o.copy_(out.to(o.dtype))


def ring_attention_fold_plain(
    qs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor], ranks: Sequence[int],
    ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], scale_log2: float,
) -> None:
    """The plain version of ``ring_attention_fold``: each rank's state in
    fp32 tensors, one ``ring_attn_step_plain`` per shard in ring order."""
    check_no_autograd("ring_attention", *qs, *ks, *vs)
    n = len(ks)
    for q, o, r in zip(qs, outs, ranks):
        b, tq, h, d = q.shape
        m = torch.empty((b * h, tq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)  # noqa: E741
        acc = torch.empty((b * h, tq, d), dtype=torch.float32, device=q.device)
        for s in range(n):
            j = (r - s) % n
            ring_attn_step_plain(q, _to_bh(ks[j].to(q.device)), _to_bh(vs[j].to(q.device)),
                                 m, l, acc, o, scale_log2, s == 0, s == n - 1)


def check_peer_access(devices: Sequence[torch.device]) -> None:
    """Raise unless every CUDA device of a ring can read every other's
    memory: the kernel reads the other ranks' shards where they lie."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(
                    f"ring_attention: cuda:{a} cannot read cuda:{b}'s memory (no peer access); "
                    "the ring's kernel reads every rank's K/V shard in place",
                )


def _enable_peer(lib: ctypes.CDLL, device: int, peer: int) -> None:
    if (device, peer) in _PEERS:
        return
    fn = lib.ring_attention_enable_peer
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    _build.check(fn(device, peer), lib, "ring_attention_error_string",
                 f"ring_attention: peer access cuda:{device} -> cuda:{peer}")
    _PEERS.add((device, peer))


def _check_layout(name: str, tensors: Sequence[torch.Tensor], shape, dtype) -> None:
    strides = {t.stride() for t in tensors}
    if len(strides) != 1:
        raise ValueError(f"ring_attention: every {name} must have one stride set, got {strides}")
    for t in tensors:
        if tuple(t.shape) != shape or t.dtype != dtype or t.device.type != "cuda":
            raise ValueError(f"ring_attention: {name} must be CUDA {dtype} {shape}, got "
                             f"{t.device} {t.dtype} {tuple(t.shape)}")
        if (t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"ring_attention kernel needs {name} with D contiguous, B/T/H strides that are "
                f"multiples of 16 bytes and 16-byte aligned data; got strides {t.stride()}",
            )


def _check(qs, outs, ranks, ks, vs) -> None:
    q = qs[0]
    if q.dtype not in _SUFFIX:
        raise TypeError(f"ring_attention kernel takes bfloat16 or float32, got {q.dtype}")
    b, tq, h, d = q.shape
    n, s = len(ks), ks[0].shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"ring_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if (not 1 <= n <= MAX_RANKS or len(vs) != n
            or not 1 <= len(qs) == len(outs) == len(ranks) <= n):
        raise ValueError(f"ring_attention: {len(qs)} ranks of a ring of {n} "
                         f"(at most {MAX_RANKS})")
    if any(not 0 <= r < n for r in ranks) or len(set(ranks)) != len(ranks):
        raise ValueError(f"ring_attention: ranks {list(ranks)} are not distinct ranks of {n}")
    if b * h > 65535 or tq == 0 or s == 0:
        raise ValueError(f"ring_attention: shape {tuple(q.shape)} is out of the kernel's range")
    _check_layout("q", qs, (b, tq, h, d), q.dtype)
    _check_layout("o", outs, (b, tq, h, d), q.dtype)
    _check_layout("k", ks, (b, s, h, d), q.dtype)
    _check_layout("v", vs, (b, s, h, d), q.dtype)
    if any(t.device != q.device for t in (*qs, *outs)):
        raise ValueError("ring_attention: the launch's q and o must be on one device")


def ring_attention_fold(
    qs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor], ranks: Sequence[int],
    ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor], scale_log2: float,
) -> None:
    """Fold every shard into each of ``ranks`` and write its output: one
    kernel launch on the current stream of the queries' CUDA device, the
    plain version for CPU tensors. The caller orders the launch after the
    fills of the shards it reads (``parallel/context_rdma.py``)."""
    check_no_autograd("ring_attention", *qs, *ks, *vs)
    device = qs[0].device
    if device.type == "cpu":
        ring_attention_fold_plain(qs, outs, ranks, ks, vs, scale_log2)
        return
    if device.type != "cuda":
        raise RuntimeError(f"ring_attention has no kernel for device {device}")
    _check(qs, outs, ranks, ks, vs)
    lib = _build.load("ring_attention")
    peers = {t.device for t in (*ks, *vs)} - {device}
    check_peer_access([device, *peers])
    for peer in peers:
        _enable_peer(lib, device.index, peer.index)
    b, tq, h, d = qs[0].shape
    table = (ctypes.c_longlong * (5 * MAX_RANKS))()
    for i, (k, v) in enumerate(zip(ks, vs)):
        table[i], table[MAX_RANKS + i] = k.data_ptr(), v.data_ptr()
    for z, (q, o, r) in enumerate(zip(qs, outs, ranks)):
        table[2 * MAX_RANKS + z] = q.data_ptr()
        table[3 * MAX_RANKS + z] = o.data_ptr()
        table[4 * MAX_RANKS + z] = r
    strides = (ctypes.c_longlong * 12)(*(st for t in (qs[0], outs[0], ks[0], vs[0])
                                         for st in t.stride()[:3]))
    fn = getattr(lib, f"ring_attention_{_SUFFIX[qs[0].dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        code = fn(ctypes.addressof(table), ctypes.addressof(strides), len(ks), len(qs), b, h, tq,
                  ks[0].shape[1], d, scale_log2, stream)
    _build.check(code, lib, "ring_attention_error_string",
                 f"ring_attention({len(qs)} of {len(ks)} ranks, {tuple(qs[0].shape)})")
    launch_counts["ring_attention"] += 1
