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

The route goes by dtype and head dim (``ring_route``): bf16 takes the
``mma.sync`` kernel, fp32 at head dims 64 and 128 (the UNet's 128) the
3xTF32 kernel on ``wgmma`` (``csrc/ring_attention_tf32.cuh``: a pre-pass
splits every shard into its tf32 terms on the launch's device, then the
fold), other fp32 the CUDA-core FMA kernel.

K6 has no backward, as in JAX (a bare ``pallas_call`` without
``custom_vjp``): a launch under grad mode with an input that requires grad
raises. Each launch adds one to its route's count: ``ring_attention`` (the
bf16 and FMA kernels), or ``ring_attention_tf32`` and its pre-pass's
``ring_attention_tf32_split``. A ring call launches once per device that
holds ranks (the tf32 route: the pre-pass, then the fold).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts
from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_round, tf32_split

HEAD_DIMS = (16, 32, 64, 128, 256)
TF32_HEAD_DIMS = (64, 128)  # the 3xTF32 kernel's head dims
TF32_BM, TF32_BN = 128, 32  # its query rows a block and keys a ring stage
MAX_RANKS = 16  # the kernel's shard table (csrc/ring_attention.cu MAX_RING)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCHERS = {
    "ring_attention_bf16": [_PTR, _PTR] + [_INT] * 7 + [_FLOAT, _PTR],
    "ring_attention_f32": [_PTR, _PTR] + [_INT] * 7 + [_FLOAT, _PTR],
    "ring_attention_tf32_split": [_PTR, _PTR] + [_INT] * 7 + [_PTR] * 3,
    "ring_attention_tf32": [_PTR, _PTR] + [_INT] * 7 + [_FLOAT] + [_PTR] * 3,
    "tf32_probe": [_PTR] * 3 + [_INT, _PTR],
}
_PEERS: set = set()  # (device, peer) pairs whose peer access is enabled


@functools.cache
def _library() -> ctypes.CDLL:
    """csrc/ring_attention.cu's library with its launchers' signatures set."""
    lib = _build.load("ring_attention")
    for fn, argtypes in _LAUNCHERS.items():
        launcher = getattr(lib, fn)
        launcher.restype = ctypes.c_int
        launcher.argtypes = argtypes
    return lib


def ring_route(dtype, d: int) -> str:
    """The fold's kernel for a dtype and kernel head dim: "bf16" (mma.sync),
    "tf32" (fp32 at head dims 64 and 128: 3xTF32 on wgmma) or "f32" (other
    fp32: CUDA-core FMAs)."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype != torch.float32:
        raise TypeError(f"ring_attention kernel takes bfloat16 or float32, got {dtype}")
    return "tf32" if d in TF32_HEAD_DIMS else "f32"


def tf32_split_shape(n: int, b: int, h: int, s: int, d: int) -> tuple[tuple, tuple]:
    """The tf32 route's scratch: K's terms [2, B*H, n*S8, D] and V^T's
    [2, B*H, D, n*S8], S8 = S rounded up to 8 (csrc/ring_attention_tf32.cuh)."""
    keys = n * -(-s // 8) * 8
    return (2, b * h, keys, d), (2, b * h, d, keys)


def tf32_smem_bytes(d: int, stages: int = 2) -> int:
    """Shared memory of a tf32 block at head dim ``d``: Q's lo terms, the
    ring's stages (K's and V^T's two terms each), its barriers and the 1024
    bytes that align them to the swizzle (ring_attention_tf32.cuh's
    smem_bytes)."""
    return TF32_BM * d * 4 + stages * 4 * TF32_BN * d * 4 + 16 * stages + 1024


def tf32_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The tf32 route's 3xTF32 products alone, one warpgroup on one tile:
    [2, 64, n] fp32, twice a [64, 32] times b [n, 32]^T (n 32 or 128): once
    with its operands in S = Q K^T's layouts, once in O += P V's (a read in
    the accumulator's layout, b's k permuted to match). A test of the
    operand layouts the kernel relies on; its plain version is ``a @ b.T``
    in fp32, twice."""
    n = b.shape[0]
    if (a.shape != (64, 32) or b.shape != (n, 32) or n not in (32, 128)
            or a.dtype != torch.float32 or b.dtype != torch.float32):
        raise ValueError(f"tf32_probe takes fp32 a [64, 32] and b [n, 32], n 32 or 128; got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
    if a.device.type != "cuda":
        raise RuntimeError(f"tf32_probe has no kernel for device {a.device}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((2, 64, n), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        code = lib.tf32_probe(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                              torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(code, lib, "ring_attention_error_string", f"tf32_probe(n={n})")
    return out


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
    lib = _library()
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
    route = ring_route(qs[0].dtype, d)
    shape = (ctypes.addressof(table), ctypes.addressof(strides), len(ks), len(qs), b, h, tq,
             ks[0].shape[1], d)
    stream = torch.cuda.current_stream(device).cuda_stream
    what = f"({len(qs)} of {len(ks)} ranks, {tuple(qs[0].shape)})"
    if route == "tf32":
        kt, vt = ring_split_kernel(lib, shape, device, stream)
        with torch.cuda.device(device):
            code = lib.ring_attention_tf32(*shape, scale_log2, kt.data_ptr(), vt.data_ptr(),
                                           stream)
    else:
        with torch.cuda.device(device):
            code = getattr(lib, f"ring_attention_{route}")(*shape, scale_log2, stream)
    _build.check(code, lib, "ring_attention_error_string", f"ring_attention_{route}{what}")
    launch_counts["ring_attention_tf32" if route == "tf32" else "ring_attention"] += 1


def ring_split(ks: Sequence[torch.Tensor],
               vs: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32 route's pre-pass alone, on the shards' device: every shard's
    K and V^T tf32 terms, as ``ring_split_plain`` lays them out. The fold
    launches it itself; this entry is for holding it against its plain
    version."""
    device = ks[0].device
    b, s, h, d = ks[0].shape
    _check_layout("k", ks, (b, s, h, d), torch.float32)
    _check_layout("v", vs, (b, s, h, d), torch.float32)
    table = (ctypes.c_longlong * (5 * MAX_RANKS))()
    for i, (k, v) in enumerate(zip(ks, vs)):
        table[i], table[MAX_RANKS + i] = k.data_ptr(), v.data_ptr()
    strides = (ctypes.c_longlong * 12)(*(st for t in (ks[0], ks[0], ks[0], vs[0])
                                         for st in t.stride()[:3]))
    lib = _library()
    shape = (ctypes.addressof(table), ctypes.addressof(strides), len(ks), 1, b, h, 1, s, d)
    return ring_split_kernel(lib, shape, device, torch.cuda.current_stream(device).cuda_stream)


def ring_split_kernel(lib: ctypes.CDLL, shape: tuple, device: torch.device,
                      stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the tf32 route's pre-pass: every shard's K and V^T split into
    their tf32 terms on ``device`` (``tf32_split_shape``'s layouts;
    ``shape`` is the launchers' table, strides and sizes). Its plain version
    is ``ring_split_plain``."""
    _, _, n, _, b, h, _, s, d = shape
    k_shape, v_shape = tf32_split_shape(n, b, h, s, d)
    kt = torch.empty(k_shape, dtype=torch.float32, device=device)
    vt = torch.empty(v_shape, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.ring_attention_tf32_split(*shape, kt.data_ptr(), vt.data_ptr(), stream)
    _build.check(code, lib, "ring_attention_error_string",
                 f"ring_attention_tf32_split(n={n}, B={b}, H={h}, S={s}, D={d})")
    launch_counts["ring_attention_tf32_split"] += 1
    return kt, vt


def ring_split_plain(ks: Sequence[torch.Tensor], vs: Sequence[torch.Tensor]):
    """The plain pre-pass: K's terms [2, B*H, n*S8, D] and V^T's [2, B*H, D,
    n*S8] (each shard's keys padded with zeros to S8, V^T's keys in each
    aligned 8 in the order 0, 2, 4, 6, 1, 3, 5, 7: the tf32 A operand's k
    order over an accumulator's columns, csrc/wgmma.cuh ``tf32_k_perm``),
    hi = tf32(x) and lo = tf32(x - hi), fp32."""
    b, s, h, d = ks[0].shape
    s8 = -(-s // 8) * 8
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    order = (torch.arange(s8).view(-1, 8)[:, perm]).reshape(-1)

    def padded(t):
        return torch.nn.functional.pad(_to_bh(t.float()), (0, 0, 0, s8 - s))

    k = torch.cat([padded(t) for t in ks], dim=1)
    v = torch.cat([padded(t)[:, order.to(t.device)] for t in vs], dim=1).transpose(1, 2)
    terms = []
    for x in (k, v):
        hi, lo = tf32_split(x.contiguous())
        terms.append(torch.stack([hi, tf32_round(lo)]))
    return terms[0], terms[1]
