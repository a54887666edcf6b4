"""Flash attention (non-causal) for [B, T, H, D] tensors, forward and backward.

``flash_attention(q, k, v)`` is differentiable. It is the autograd Function
``FlashAttention``, the port of the JAX package's ``_flash_mha`` custom VJP
(``rho_diffusion_tpu/ops/pallas/flash_attention.py:374-408``):

* on CUDA bf16 or fp32 tensors the forward is a hand-written kernel launched
  from ``csrc/flash_attention.cu`` (replacing the TPU kernels
  ``_fwd_kernel_onepass`` and ``_fwd_kernel``) and the backward a kernel
  launched from ``csrc/flash_attention_bwd.cu`` (replacing
  ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``);
* on CPU tensors both directions are the plain versions below, through the
  same Function, so the CPU tests run its backward logic.

Scores and softmax are fp32 at 1/sqrt(D); any T. The forward writes the
row log-sum-exp only when the call will be differentiated (grad mode on and
an input that requires grad), as the TPU primal path skips it. The LSE is
kept in base 2 of the scaled scores (see flash_attention.cu), and the
backward exponentiates in that base. ``delta = rowsum(dO * O)`` is a PyTorch
expression (``flash_delta``) on the fp32 routes, as the JAX package leaves
it to XLA; the bf16 fused route and the bf16 pair take it from a pre-pass
kernel (``flash_delta_kernel``, counted as ``flash_attention_bwd_delta``;
the PyTorch expression is five kernels), and the small and long routes
compute it in their one kernel.

q, k, v may be strided views (the UNet's split of one qkv projection) as long
as D is contiguous; head dims other than 16/32/64/128/256 are zero-padded up
to the next one (padding changes neither Q K^T nor the kept columns of P V,
and the padded gradient columns are dropped).

The forward's route is ``flash_plan``'s, by head dim and dtype only: bf16 at
head dims 64 and 128 (the UNet's) takes the Hopper kernel
(``csrc/flash_attention_wgmma.cuh``: Q and K/V tiles by TMA through an
mbarrier ring, Q K^T and P V on ``wgmma``, warp-specialised), with the
plan's query rows a block and keys a tile; bf16 at padded head dims 16 and
32 (the ViT's 16) takes ONE Hopper kernel a call at every T
(``csrc/flash_attention_fwd_narrow.cuh``: a warpgroup a batch*head and 64
query rows, two a block, K/V through a cp.async ring of its own, both
products on ``wgmma``), counted as ``flash_attention_fwd_narrow``; bf16 at
256 takes the ``mma.sync`` kernel (at 16 and 32 on request,
``MMA_SYNC_PLAN``: the old side of the comparison). fp32 at head dims 64 and 128
takes K6's 3xTF32 fold with one shard (``csrc/ring_attention_tf32.cuh``:
every product three TF32 products on ``wgmma``, after a pre-pass that
splits K and V^T into their tf32 terms; counted as ``flash_attention_tf32``
and ``flash_attention_tf32_split``); fp32 at 16, 32 and 256 its CUDA-core
kernel. A failed build, encode or launch raises; no route stands in for
another. ``flash_routes`` counts the forward's launches by route and key
length.

The backward's route is ``flash_bwd_plan``'s, by head dim and dtype the
same way, and for small head dims by T: bf16 at padded head dims 16 and 32
with Tq, Tk <= 64 (the ViT's attention) takes ONE kernel a backward
(``csrc/flash_attention_bwd_small.cuh``: a warpgroup a batch*head, its
inputs resident, delta and all five products inside, on ``wgmma``), counted
as ``flash_attention_bwd_small``; bf16 at padded head dims 16 and 32 past
64 keys or queries (the ViT at patch 4) takes ONE kernel a backward too
(``csrc/flash_attention_bwd_long.cuh``: ``long_bwd_groups`` blocks a
batch*head taking its chunks of 128 keys in turn, K and V resident, Q, dO
and O streamed, delta and all five products inside, on ``wgmma``, dQ
summed across chunks in a fixed order through fp32 scratch linear in T),
counted as ``flash_attention_bwd_long``; bf16 at head dims 64 and 128 takes
ONE fused kernel
(``csrc/flash_attention_bwd_wgmma.cuh``: K and V of a block resident, Q and
dO tiles by TMA through an mbarrier ring, all five products on ``wgmma``,
dQ added across the key tiles in a fixed order, so the gradients are
bitwise repeatable), counted as ``flash_attention_bwd``; fp32 at 64 and 128
a 3xTF32 pair on ``wgmma`` (``csrc/flash_attention_bwd_tf32.cuh``: dK/dV
over key blocks and dQ over query blocks after a pre-pass that splits q,
dO, k and v; counted as ``flash_attention_bwd_tf32_dkv``, ``_dq`` and
``_split``); bf16 at 256 takes the ``mma.sync`` pair and fp32 at 16, 32
and 256 the CUDA-core pair (dK/dV and dQ kernels, counted as
``flash_attention_bwd_dkv`` and ``_dq``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import (
    _build, check_no_autograd, launch_counts, on_device, sm_count)
from rho_diffusion_tpu_torch.ops.kernels.ring_attention import (
    TF32_HEAD_DIMS, ring_split_plain, tf32_split_shape)
from rho_diffusion_tpu_torch.ops.kernels.tf32 import tf32_matmul, tf32_round, tf32_split

HEAD_DIMS = (16, 32, 64, 128, 256)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
LOG2E = 1.4426950408889634

# The wgmma route's tiles (csrc/flash_attention_wgmma.cuh): head dims it
# takes, query rows a block (64 per consumer warpgroup), the (query rows,
# keys a K/V tile) instances the launcher has, and the K/V ring's depth, in
# at most SMEM_LIMIT bytes of shared memory a block.
WGMMA_HEAD_DIMS = (64, 128)
FLASH_BM = (64, 128)
WGMMA_TILES = ((64, 64), (128, 128), (128, 64))
FLASH_STAGES = 2
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
# the forward's launches by route and key length, e.g. "wgmma Tk=4096"
flash_routes: Counter = Counter()


class FlashPlan(NamedTuple):
    """The forward's route ("wgmma", "narrow", "mma_sync", "tf32" or "fp32")
    and its tiles: query rows a block (bm; on the narrow route a warpgroup)
    and keys a K/V tile (bn). The wgmma route takes the tiles of
    WGMMA_TILES; the others have fixed tiles, which the plan records."""

    route: str
    bm: int
    bn: int

    def smem_bytes(self, d: int) -> int:
        """Shared memory of a wgmma block at padded head dim ``d``: Q, the
        K and V rings, their barriers and the 1024 bytes that align them to
        the swizzle (flash_attention_wgmma.cuh's smem_bytes)."""
        return (2 * d * self.bm + 2 * FLASH_STAGES * 2 * d * self.bn
                + 8 * (1 + 3 * FLASH_STAGES) + 1024)


MMA_SYNC_PLAN = FlashPlan("mma_sync", 64, 64)
# The narrow route (csrc/flash_attention_fwd_narrow.cuh): bf16 at padded head
# dims 16 and 32; a warpgroup owns 64 query rows of one batch*head (an item),
# NARROW_WARPGROUPS items a block, each with its own ring of NARROW_STAGES
# stages of 64 keys
NARROW_HEAD_DIMS = (16, 32)
NARROW_WARPGROUPS = 2
NARROW_STAGES = 3
NARROW_PLAN = FlashPlan("narrow", 64, 64)
FP32_PLAN = FlashPlan("fp32", 16, 64)
# K6's 3xTF32 fold (csrc/ring_attention_tf32.cuh): 128 query rows a block,
# a ring of 32-key stages; its shared memory is ring_attention.tf32_smem_bytes
TF32_PLAN = FlashPlan("tf32", 128, 32)
WGMMA_PLANS = tuple(FlashPlan("wgmma", bm, bn) for bm, bn in WGMMA_TILES)

# The fused backward's fixed tiles (csrc/flash_attention_bwd_wgmma.cuh):
# query rows a ring stage, a ring of FLASH_BWD_STAGES stages and
# FLASH_BWD_DQ_BUFS dQ shares in flight. Its keys a block are the padded
# head dim: one consumer warpgroup per 64 keys and per 64-channel chunk of
# dQ.
FLASH_BWD_BM = 64
FLASH_BWD_STAGES = 2
FLASH_BWD_DQ_BUFS = 2


class FlashBwdPlan(NamedTuple):
    """The backward's route ("wgmma": the fused kernel; "small": one kernel
    a batch*head at small head dims; "long": one kernel a call at small head
    dims past the small route's T; "tf32", "mma_sync" or "fp32": a dkv/dq
    pair) and its keys a block (bn): the padded head dim on the fused route;
    the most keys a batch*head on the small route; 128 on the long route;
    the pair's dkv kernel's fixed tile otherwise."""

    route: str
    bn: int

    def smem_bytes(self, d: Optional[int] = None) -> int:
        """Shared memory of a fused block (head dim ``bn``): K and V, the Q
        and dO rings, the bf16 dS^T tile, dQ's fp32 shares, the lse and
        delta rows, the barriers and the 1024 bytes that align them to the
        swizzle (flash_attention_bwd_wgmma.cuh's smem_bytes). On the small
        route, ``small_bwd_smem_bytes``; on the long route
        ``long_bwd_smem_bytes`` at padded head dim ``d``."""
        if self.route == "small":
            return small_bwd_smem_bytes()
        if self.route == "long":
            return long_bwd_smem_bytes(d)
        d, bm = self.bn, FLASH_BWD_BM
        return (2 * 2 * d * self.bn + 2 * FLASH_BWD_STAGES * 2 * d * bm + 2 * self.bn * bm
                + FLASH_BWD_DQ_BUFS * 4 * bm * d + 2 * FLASH_BWD_STAGES * 4 * bm
                + 8 * (1 + FLASH_BWD_STAGES) + 1024)


MMA_SYNC_BWD_PLAN = FlashBwdPlan("mma_sync", 64)
# The small route (csrc/flash_attention_bwd_small.cuh): bf16 at padded head
# dims 16 and 32 where every key and query of a batch*head fits one 64-row
# wgmma tile; one warpgroup a batch*head, SMALL_BWD_WARPGROUPS a block
SMALL_BWD_HEAD_DIMS = (16, 32)
SMALL_BWD_T = 64
SMALL_BWD_WARPGROUPS = 2
SMALL_BWD_PLAN = FlashBwdPlan("small", SMALL_BWD_T)
# The long route (csrc/flash_attention_bwd_long.cuh): the same head dims
# past SMALL_BWD_T; a block of LONG_BWD_WARPGROUPS warpgroups owns 64 keys
# each, and query tiles of LONG_BWD_BM rows stream through a ring of
# LONG_BWD_STAGES[d] stages
LONG_BWD_WARPGROUPS = 2
LONG_BWD_BM = 64
LONG_BWD_STAGES = {16: 3, 32: 2}
LONG_BWD_PLAN = FlashBwdPlan("long", 64 * LONG_BWD_WARPGROUPS)
# The long route's blocks in all that long_bwd_groups aims for: one wave of
# two blocks an SM on the H100's 132 SMs (more blocks a batch*head only
# where B*H leaves SMs idle: at the ViT's patch-4 shape one block a
# batch*head ran faster than two or four)
LONG_BWD_BLOCKS = 2 * 132
FP32_BWD_PLAN = FlashBwdPlan("fp32", 16)
# The 3xTF32 pair (csrc/flash_attention_bwd_tf32.cuh): blocks of 64 rows
# (dkv: keys, dq: queries), two warpgroups, the other side streamed through
# a ring of TF32_BWD_STAGES stages of TF32_BWD_BN rows
TF32_BWD_PLAN = FlashBwdPlan("tf32", 64)
TF32_BWD_BN = 32
TF32_BWD_STAGES = 2


def narrow_fwd_smem_bytes(d: int) -> int:
    """Shared memory of a narrow-route block at padded head dim ``d`` (16 or
    32): per warpgroup Q and the K stages, then the V stages, each a [64][d]
    slot of 2 d bytes a row in 128-byte swizzled [64][64] regions (4 slots a
    region at d = 16, 2 at 32), then 1024 bytes that align the block to the
    swizzle (flash_attention_fwd_narrow.cuh's smem_bytes)."""
    if d not in NARROW_HEAD_DIMS:
        raise ValueError(f"the narrow route takes padded head dims {NARROW_HEAD_DIMS}, not {d}")
    per_region = 128 // (2 * d)
    regions = -(-(1 + NARROW_STAGES) // per_region) + -(-NARROW_STAGES // per_region)
    return NARROW_WARPGROUPS * regions * 64 * 128 + 1024


def small_bwd_smem_bytes() -> int:
    """Shared memory of a small-route block, at padded head dim 16 and 32
    alike: per warpgroup K, V, Q, dO and the bf16 dS^T tile as 128-byte
    swizzled [64][64] tiles (channels past D unused), the lse and delta
    rows, rounded up to 1024 bytes; then 1024 bytes that align the block to
    the swizzle (flash_attention_bwd_small.cuh's SMEM)."""
    tile = SMALL_BWD_T * 128
    region = -(-(5 * tile + 2 * 4 * SMALL_BWD_T) // 1024) * 1024
    return SMALL_BWD_WARPGROUPS * region + 1024


def long_bwd_groups(bh: int, tk: int) -> int:
    """The long route's blocks a batch*head: enough for LONG_BWD_BLOCKS in
    all (so one where B*H fills the card), at most its chunks of 128 keys,
    each block taking every groups-th chunk in turn."""
    chunks = -(-tk // LONG_BWD_PLAN.bn)
    return min(chunks, -(-LONG_BWD_BLOCKS // bh))


def long_bwd_scratch_bytes(bh: int, tq: int, tk: int, d: int) -> int:
    """Device memory the long route allocates besides dq, dk and dv: each
    block's fp32 slots of dQ (one [64, d] tile a query tile) where there is
    more than one chunk of keys, and a counter a batch*head where there is
    more than one block. Under (bh + LONG_BWD_BLOCKS) * ceil(tq/64) * 64 * d
    * 4 + 4 * bh bytes: linear in T (dQ's own size in fp32 where bh >=
    LONG_BWD_BLOCKS)."""
    groups = long_bwd_groups(bh, tk)
    slots = bh * groups * -(-tq // LONG_BWD_BM) * LONG_BWD_BM * d * 4
    return (slots if tk > LONG_BWD_PLAN.bn else 0) + (4 * bh if groups > 1 else 0)


def long_bwd_smem_bytes(d: int) -> int:
    """Shared memory of a long-route block at padded head dim ``d`` (16 or
    32): the 128-byte swizzled [64][64] tiles (K and V of 128 keys, the Q and
    dO rings, the dS^T tile of 128 keys; channels past D unused), one fp32
    dQ share, the O ring, the lse rows and each warpgroup's delta rows, and
    the 1024 bytes that align them to the swizzle
    (flash_attention_bwd_long.cuh's smem_bytes)."""
    if d not in SMALL_BWD_HEAD_DIMS:
        raise ValueError(f"the long route takes padded head dims {SMALL_BWD_HEAD_DIMS}, not {d}")
    wgs, bm, stages = LONG_BWD_WARPGROUPS, LONG_BWD_BM, LONG_BWD_STAGES[d]
    tile = 64 * 128
    return ((3 * wgs + 2 * stages) * tile + bm * d * 4 + stages * bm * d * 2
            + stages * bm * 4 + stages * wgs * bm * 4 + 1024)


def tf32_bwd_smem_bytes(d: int, dkv: bool) -> int:
    """Shared memory of a tf32 backward block at head dim ``d``: the two
    warpgroups' A lo terms (64 rows each), the ring's stages (two streamed
    tensors, two terms each), the [64][32] fp32 tiles (dq: dS's two terms;
    dkv: P^T's and dS^T's), the barriers and the 1024 bytes that align them
    to the swizzle (flash_attention_bwd_tf32.cuh's smem_bytes)."""
    rows = TF32_BWD_PLAN.bn
    return (2 * rows * d * 4 + TF32_BWD_STAGES * 4 * TF32_BWD_BN * d * 4
            + (4 if dkv else 2) * rows * 32 * 4 + 16 * TF32_BWD_STAGES + 1024)
# the fused kernel's one plan at each padded head dim
WGMMA_BWD_PLANS = {d: FlashBwdPlan("wgmma", d) for d in WGMMA_HEAD_DIMS}


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for a true one: the next of HEAD_DIMS."""
    return next(x for x in HEAD_DIMS if x >= d)


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, h: int, tq: int, tk: int, d: int, dtype=torch.bfloat16,
               sms: int = 132) -> FlashPlan:
    """The forward's plan for q [b, tq, h, d] against tk keys on a card of
    ``sms`` multiprocessors (132: the H100 SXM).

    The route goes by head dim and dtype: bf16 whose padded head dim is 64
    or 128 takes the wgmma kernel, 16 or 32 the narrow kernel
    (``NARROW_PLAN``, at every T), 256 the mma.sync kernel; fp32 at 64 and
    128 the 3xTF32 fold (``TF32_PLAN``), other fp32 the CUDA-core kernel
    (``FP32_PLAN``); other dtypes have none. For the wgmma route, each SM runs two
    consumer warpgroups: one block of 128 query rows, or two blocks of 64
    rows (with 64-key tiles a block holds 80 KB of shared memory, so two
    fit). The busiest SM then works through ceil(blocks / sms) blocks of bm
    rows; the plan takes the bm for which that is least, 128 on a tie (K/V
    is read once per 128 rows instead of twice). So T = 512 at sampling
    batch 4 (16 heads: 64 blocks of 128 rows or 128 of 64) takes 64, and
    batch 8 and up, and T = 4096, take 128. K/V tiles as long as the query
    tile (64 where there are no more keys): on the H100 these beat the other
    tile. Cached: the UNet asks for the same few plans on every step."""
    if dtype == torch.float32:
        return TF32_PLAN if padded_head_dim(d) in TF32_HEAD_DIMS else FP32_PLAN
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16 or float32, got {dtype}")
    if padded_head_dim(d) in NARROW_HEAD_DIMS:
        return NARROW_PLAN
    if padded_head_dim(d) not in WGMMA_HEAD_DIMS:
        return MMA_SYNC_PLAN
    bm = min(FLASH_BM, key=lambda m: (busiest_sm_rows(m, b, h, tq, sms), -m))
    return FlashPlan("wgmma", bm, bm if tk > 64 else 64)


def flash_bwd_plan(b: int, h: int, tq: int, tk: int, d: int,
                   dtype=torch.bfloat16) -> FlashBwdPlan:
    """The backward's plan for q [b, tq, h, d] against tk keys.

    The route goes by head dim and dtype as the forward's: bf16 whose padded
    head dim is 64 or 128 takes the fused kernel; bf16 at padded 16 or 32
    takes the small route where tq and tk are at most SMALL_BWD_T (one
    wgmma tile: the ViT's 64 patches), the long route past it (the ViT at
    patch 4: 512 patches); bf16 at 256 the mma.sync pair; fp32 at 64 and 128 the 3xTF32 pair (``TF32_BWD_PLAN``),
    other fp32 the CUDA-core pair; other dtypes have none. Beyond the small
    route's T the shape takes no part: the fused kernel's tile is a function
    of the head dim alone
    (``WGMMA_BWD_PLANS``), D keys a block, as its consumer warpgroups split
    dQ's 64-channel chunks; ragged or short key ranges are masked. At
    D = 128 that is one block an SM of two warpgroups (dK and dV of 64 keys
    fill half a warpgroup's registers, so a block of one warpgroup also ran
    one an SM, and took 1.7-2x as long on the H100)."""
    if dtype == torch.float32:
        return TF32_BWD_PLAN if padded_head_dim(d) in TF32_HEAD_DIMS else FP32_BWD_PLAN
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16 or float32, got {dtype}")
    dk = padded_head_dim(d)
    if dk in SMALL_BWD_HEAD_DIMS:
        return SMALL_BWD_PLAN if max(tq, tk) <= SMALL_BWD_T else LONG_BWD_PLAN
    if dk not in WGMMA_HEAD_DIMS:
        return MMA_SYNC_BWD_PLAN
    return WGMMA_BWD_PLANS[dk]


def busiest_sm_rows(bm: int, b: int, h: int, tq: int, sms: int = 132) -> int:
    """Query rows the busiest SM works through when blocks of ``bm`` rows
    are dealt out to ``sms`` multiprocessors: ceil(blocks / sms) * bm."""
    return -(-(-(-tq // bm) * b * h) // sms) * bm


# ctypes signatures of the launchers, set once on load
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD = [_PTR] * 5 + [_INT] * 5 + [_PTR, _FLOAT]
_BWD = [_PTR] * 9 + [_INT] * 5 + [_PTR, _FLOAT, _FLOAT, _PTR]
_LAUNCHERS = {
    "flash_attention": {
        "flash_attention_fwd_bf16": _FWD + [_PTR],
        "flash_attention_fwd_narrow": _FWD + [_PTR],
        "flash_attention_fwd_f32": _FWD + [_PTR],
        "flash_attention_fwd_wgmma": _FWD + [_INT] * 2 + [_PTR],
        "flash_wgmma_pv_probe": [_PTR] * 3 + [_INT] * 2 + [_PTR],
        "flash_attention_tf32_split": [_PTR] * 4 + [_INT] * 4 + [_PTR] * 2,
        "flash_attention_tf32": [_PTR] * 5 + [_INT] * 5 + [_PTR, _FLOAT, _PTR],
    },
    "flash_attention_bwd": {
        **{f"flash_attention_bwd_{which}_{suffix}": _BWD
           for which in ("dkv", "dq") for suffix in ("bf16", "f32")},
        "flash_attention_bwd_wgmma": [_PTR] * 11 + [_INT] * 5 + [_PTR, _FLOAT, _FLOAT, _INT,
                                                                 _PTR],
        "flash_attention_bwd_delta": [_PTR] * 3 + [_INT] * 4 + [_PTR] * 2,
        "flash_attention_bwd_small": [_PTR] * 9 + [_INT] * 5 + [_PTR, _FLOAT, _FLOAT, _PTR],
        "flash_attention_bwd_long": [_PTR] * 11 + [_INT] * 6 + [_PTR, _FLOAT, _FLOAT, _PTR],
        "flash_attention_bwd_tf32_split": [_PTR] * 6 + [_INT] * 5 + [_PTR] * 2,
        **{f"flash_attention_bwd_tf32_{which}": _BWD[:-1] + [_PTR] * 3 for which in ("dkv", "dq")},
    },
}


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu's library with its launchers' signatures set."""
    lib = _build.load(name)
    for fn, argtypes in _LAUNCHERS[name].items():
        launcher = getattr(lib, fn)
        launcher.restype = ctypes.c_int
        launcher.argtypes = argtypes
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The plain forward: the JAX package's reference einsum attention."""
    from rho_diffusion_tpu_torch.ops.attention import xla_attention

    return xla_attention(q, k, v)


def flash_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Base-2 log-sum-exp of the fp32 scaled scores, [B, H, Tq]."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) / math.sqrt(q.shape[-1])
    return torch.logsumexp(s, dim=-1) * LOG2E


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, H, Tq] contiguous."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _p_and_ds(q, k, v, o, lse, do):
    """fp32 P (recomputed from the base-2 ``lse``) and dS = P (dO V^T - delta)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None])
    dp = torch.einsum("bthd,bshd->bhts", do.float(), v.float())
    return p, p * (dp - flash_delta(o, do)[..., None]), scale


def flash_attention_bwd_dkv_plain(q, k, v, o, lse, do) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the dkv kernel (TPU ``_bwd_dkv_kernel``), in
    fp32: dV = P^T dO, dK = dS^T Q / sqrt(D), in k's and v's dtypes."""
    p, ds, scale = _p_and_ds(q, k, v, o, lse, do)
    dv = torch.einsum("bhts,bthd->bshd", p, do.float())
    dk = torch.einsum("bhts,bthd->bshd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do) -> torch.Tensor:
    """The plain version of the dq kernel (TPU ``_bwd_dq_kernel``), in fp32:
    dQ = dS K / sqrt(D), in q's dtype."""
    _, ds, scale = _p_and_ds(q, k, v, o, lse, do)
    return (torch.einsum("bhts,bshd->bthd", ds, k.float()) * scale).to(q.dtype)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward (dq, dk, dv): the two kernels' plain versions, the
    TPU kernels' arithmetic written out in fp32."""
    return (flash_attention_bwd_dq_plain(q, k, v, o, lse, do),
            *flash_attention_bwd_dkv_plain(q, k, v, o, lse, do))


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


def _kernel_layout(name: str, *tensors: torch.Tensor) -> tuple[int, int]:
    """Device and shape checks shared by the launchers; returns (padded head
    dim, true head dim)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"{name} has no kernel for device {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel takes bfloat16 or float32, got {q.dtype}")
    b, _, h, d = q.shape
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"{name} kernel takes head_dim <= 256, got {d}")
    if b * h > 65535 or max(t.shape[1] for t in tensors) > 2**31 - 1 or q.shape[1] == 0:
        raise ValueError(f"{name}: shape {tuple(q.shape)} is out of the kernel's range")
    return padded_head_dim(d), d


def _pad(t: torch.Tensor, dk: int) -> torch.Tensor:
    return F.pad(t, (0, dk - t.shape[-1])) if t.shape[-1] != dk else t


def _check_strides(name: str, tensors) -> None:
    for t in tensors:
        if (t.stride(-1) != 1 or any(s * t.element_size() % 16 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"{name} kernel needs D contiguous, B/T/H strides that are multiples "
                f"of 16 bytes and 16-byte aligned data; got strides {t.stride()}",
            )


def _check_fp32(name: str, tensors, shapes) -> None:
    """A tf32 pre-pass's inputs: fp32 of the given shapes on one device,
    laid out as ``_check_strides`` asks."""
    if any(t.dtype != torch.float32 or t.shape != shape or t.device != tensors[0].device
           for t, shape in zip(tensors, shapes)):
        raise ValueError(f"{name} takes fp32 tensors of shapes {[tuple(x) for x in shapes]} on "
                         f"one device, got {[(tuple(t.shape), t.dtype) for t in tensors]}")
    _check_strides(name, tensors)


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def flash_attention_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False,
    plan: Optional[FlashPlan] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel of ``plan``'s route (``flash_plan``'s when
    not given: tile studies and the old-against-new comparisons pass their
    own). Returns the output padded to the kernel's head dim, [B, Tq, H,
    Dk], and the base-2 LSE [B, H, Tq] (fp32) when ``with_lse``, else None.
    The narrow route's launches count as ``flash_attention_fwd_narrow``,
    the tf32 fold's as ``flash_attention_tf32``, the others' as
    ``flash_attention``."""
    check_no_autograd("flash_attention", q, k, v)
    _check(q, k, v)
    dk, d = _kernel_layout("flash_attention", q, k, v)
    q, k, v = (_pad(t, dk) for t in (q, k, v))
    _check_strides("flash_attention", (q, k, v))
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    device = q.device
    if plan is None:
        plan = flash_plan(b, h, tq, tk, dk, q.dtype, sm_count(device.index))
    if (plan.route in ("fp32", "tf32")) != (q.dtype == torch.float32):
        raise ValueError(f"flash_attention: the {plan.route} route does not take {q.dtype}")
    out = torch.empty((b, tq, h, dk), dtype=q.dtype, device=device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=device) if with_lse else None
    lib = _library("flash_attention")
    lse_ptr = lse.data_ptr() if lse is not None else None
    scale_log2 = LOG2E / math.sqrt(d)
    stream = torch.cuda.current_stream(device).cuda_stream
    what = f"flash_attention({tuple(q.shape)}, Tk={tk}, plan {tuple(plan)})"
    if plan.route == "tf32":
        ks, vts = flash_fwd_split(k, v)
        strides = _strides(q, out)
        with on_device(device):
            code = lib.flash_attention_tf32(q.data_ptr(), out.data_ptr(), lse_ptr, ks.data_ptr(),
                                            vts.data_ptr(), b, h, tq, tk, dk,
                                            ctypes.addressof(strides), scale_log2, stream)
        _build.check(code, lib, "flash_attention_error_string", what)
        launch_counts["flash_attention_tf32"] += 1
    else:
        strides = _strides(q, k, v, out)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
                b, h, tq, tk, dk, ctypes.addressof(strides), scale_log2)
        if plan.route == "narrow" and (q.dtype != torch.bfloat16 or dk not in NARROW_HEAD_DIMS):
            raise ValueError(f"flash_attention: the narrow route takes bf16 at padded head dims "
                             f"{NARROW_HEAD_DIMS}, got {q.dtype} at {dk}")
        with on_device(device):
            if plan.route == "wgmma":
                code = lib.flash_attention_fwd_wgmma(*args, plan.bm, plan.bn, stream)
            elif plan.route == "narrow":
                code = lib.flash_attention_fwd_narrow(*args, stream)
            elif plan.route == "mma_sync":
                code = lib.flash_attention_fwd_bf16(*args, stream)
            else:
                code = lib.flash_attention_fwd_f32(*args, stream)
        _build.check(code, lib, "flash_attention_error_string", what)
        launch_counts["flash_attention_fwd_narrow" if plan.route == "narrow"
                      else "flash_attention"] += 1
    flash_routes[f"{plan.route} Tk={tk}"] += 1
    return out, lse


def flash_fwd_split(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32 forward's pre-pass on fp32 k, v [B, Tk, H, D] (D = 64 or
    128, D contiguous, on the card): K's terms [2, B*H, Tk8, D] and V^T's
    [2, B*H, D, Tk8] (Tk8 = Tk rounded up to 8), the layouts of K6's split
    with one shard. Its plain version is ``flash_split_plain``; the forward
    launches it itself."""
    if k.device.type != "cuda":
        raise RuntimeError(f"flash_attention_tf32_split has no kernel for device {k.device}")
    _check_fp32("flash_attention_tf32_split", (k, v), (k.shape, k.shape))
    b, tk, h, d = k.shape
    k_shape, v_shape = tf32_split_shape(1, b, h, tk, d)
    ks = torch.empty(k_shape, dtype=torch.float32, device=k.device)
    vts = torch.empty(v_shape, dtype=torch.float32, device=k.device)
    lib = _library("flash_attention")
    strides = _strides(k, v)
    with on_device(k.device):
        code = lib.flash_attention_tf32_split(
            k.data_ptr(), v.data_ptr(), ks.data_ptr(), vts.data_ptr(), b, h, tk, d,
            ctypes.addressof(strides), torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(code, lib, "flash_attention_error_string",
                 f"flash_attention_tf32_split({tuple(k.shape)})")
    launch_counts["flash_attention_tf32_split"] += 1
    return ks, vts


def flash_split_plain(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the tf32 forward's pre-pass: K6's split
    (``ring_split_plain``) of one shard, k and v [B, Tk, H, D]."""
    return ring_split_plain([k], [v])


def flash_tf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     terms: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32 forward's arithmetic in plain PyTorch, fp32 [B, T, H, D]
    in, (o, base-2 lse [B, H, Tq]) out: S = Q K^T as 3xTF32 products summed
    per 32-channel chunk (``terms`` 1: one TF32 product, the control), the
    softmax in fp32, P V as 3xTF32 products summed per 32 keys. The kernel
    keeps the softmax online over 32-key tiles, which changes only the
    order of fp32 sums."""
    qb, kb, vb = (t.float().transpose(1, 2) for t in (q, k, v))
    s = _tf32_chunked(qb, kb.transpose(-1, -2), terms) * (LOG2E / math.sqrt(q.shape[-1]))
    lse = torch.logsumexp(s * math.log(2), dim=-1) * LOG2E
    o = _tf32_chunked(torch.exp2(s - lse[..., None]), vb, terms)
    return o.transpose(1, 2), lse


def wgmma_pv_probe(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The wgmma route's P V product alone, one warpgroup on one tile:
    p [64, bn] bf16 (read into the A operand's registers) times v [bn, hd]
    bf16 (by TMA, the MN-major B operand), fp32 [64, hd]; bn and hd 64 or
    128. A test of the two operand layouts the forward kernel relies on;
    its plain version is ``p.float() @ v.float()``."""
    bn, hd = v.shape
    if p.shape != (64, bn) or p.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise ValueError(f"wgmma_pv_probe takes p [64, bn] and v [bn, hd] in bf16, got "
                         f"{tuple(p.shape)} {p.dtype} and {tuple(v.shape)} {v.dtype}")
    if v.device.type != "cuda":
        raise RuntimeError(f"wgmma_pv_probe has no kernel for device {v.device}")
    p, v = p.contiguous(), v.contiguous()
    out = torch.empty((64, hd), dtype=torch.float32, device=v.device)
    lib = _library("flash_attention")
    with on_device(v.device):
        code = lib.flash_wgmma_pv_probe(p.data_ptr(), v.data_ptr(), out.data_ptr(), bn, hd,
                                        torch.cuda.current_stream(v.device).cuda_stream)
    _build.check(code, lib, "flash_attention_error_string", f"wgmma_pv_probe(bn={bn}, hd={hd})")
    return out


def flash_delta_kernel(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """The pre-pass of the fused backward and the bf16 pair: delta =
    rowsum(dO * O) in fp32, [B, H, Tq] contiguous, from bf16 o and do [B,
    Tq, H, D] (D contiguous; the launcher takes the padded head dims 16, 32,
    64, 128 and 256 and refuses others). Its plain version is
    ``flash_delta``."""
    check_no_autograd("flash_attention_bwd_delta", o, do)
    if o.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd_delta has no kernel for device {o.device}")
    b, tq, h, d = o.shape
    if (do.shape != o.shape or o.dtype != torch.bfloat16 or do.dtype != torch.bfloat16
            or o.stride(-1) != 1 or do.stride(-1) != 1):
        raise ValueError(f"flash_attention_bwd_delta takes bf16 o and do [B, T, H, D] with D "
                         f"contiguous, got {tuple(o.shape)} {o.dtype}, {tuple(do.shape)} "
                         f"{do.dtype}")
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=o.device)
    lib = _library("flash_attention_bwd")
    strides = _strides(o, do)
    with on_device(o.device):
        code = lib.flash_attention_bwd_delta(
            o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, tq, d, ctypes.addressof(strides),
            torch.cuda.current_stream(o.device).cuda_stream)
    _build.check(code, lib, "flash_attention_bwd_error_string",
                 f"flash_attention_bwd_delta({tuple(o.shape)})")
    launch_counts["flash_attention_bwd_delta"] += 1
    return delta


def flash_attention_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, needs: tuple[bool, bool, bool] = (True, True, True),
    plan: Optional[FlashBwdPlan] = None,
) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the backward of ``plan``'s route (``flash_bwd_plan``'s when
    not given: the old-against-new comparisons pass the pair's) on the
    forward's inputs, its padded output ``o`` and base-2 ``lse``. ``needs``
    says which of dq, dk, dv to return: the fused, small and long kernels
    compute all three in one launch, the pair launches dkv for dk or dv and
    dq for dq."""
    check_no_autograd("flash_attention_bwd", q, k, v, o, do)
    _check(q, k, v)
    dk_, d = _kernel_layout("flash_attention_bwd", q, k, v)
    q, k, v, o, do = (_pad(t, dk_) for t in (q, k, v, o, do.to(q.dtype)))
    do = do.contiguous()
    _check_strides("flash_attention_bwd", (q, k, v, do))
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    if plan is None:
        plan = flash_bwd_plan(b, h, tq, tk, dk_, q.dtype)
    if (plan.route in ("fp32", "tf32")) != (q.dtype == torch.float32):
        raise ValueError(f"flash_attention_bwd: the {plan.route} route does not take {q.dtype}")
    if plan.route == "tf32":
        grads = _bwd_tf32(q, k, v, o, lse.contiguous(), do, needs, d)
    elif plan.route in ("small", "long"):
        grads = _bwd_one_launch(plan.route, q, k, v, o, lse.contiguous(), do, needs, d)
    if plan.route in ("tf32", "small", "long"):
        return tuple(t[..., :d] if t is not None and dk_ != d else t for t in grads)
    fused = plan.route == "wgmma"
    lse = lse.contiguous()
    # bf16's delta from the pre-pass kernel, the fp32 pair's from the
    # PyTorch expression
    delta = flash_delta_kernel(o, do) if q.dtype == torch.bfloat16 else flash_delta(o, do)
    want_kv = fused or needs[1] or needs[2]
    dq = (torch.empty_like(q, memory_format=torch.contiguous_format)
          if fused or needs[0] else None)
    dk = torch.empty((b, tk, h, dk_), dtype=q.dtype, device=q.device) if want_kv else None
    dv = torch.empty_like(dk) if want_kv else None
    lib = _library("flash_attention_bwd")
    strides = _strides(q, k, v, do, dq if dq is not None else q, dk if want_kv else k,
                       dv if want_kv else v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr() if dq is not None else None,
            dk.data_ptr() if want_kv else None, dv.data_ptr() if want_kv else None)
    shape = (b, h, tq, tk, dk_, ctypes.addressof(strides), 1.0 / math.sqrt(d),
             LOG2E / math.sqrt(d))
    if fused:
        # dQ's fp32 accumulator across key tiles (the first tile stores, so
        # it needs no zeroing) and the counters that order the additions
        acc = order = None
        q_tiles = -(-tq // FLASH_BWD_BM)
        if tk > plan.bn:
            acc = torch.empty(b * h * q_tiles * FLASH_BWD_BM * dk_, dtype=torch.float32,
                              device=q.device)
            order = torch.zeros(b * h * q_tiles, dtype=torch.int32, device=q.device)
        with on_device(q.device):
            code = lib.flash_attention_bwd_wgmma(
                *ptrs, acc.data_ptr() if acc is not None else None,
                order.data_ptr() if order is not None else None, *shape, plan.bn, stream)
        _build.check(code, lib, "flash_attention_bwd_error_string",
                     f"flash_attention_bwd({tuple(q.shape)}, Tk={tk}, plan {tuple(plan)})")
        launch_counts["flash_attention_bwd"] += 1
    for which, wanted in (("dkv", want_kv), ("dq", needs[0])):
        if fused or not wanted:
            continue
        fn = getattr(lib, f"flash_attention_bwd_{which}_{_SUFFIX[q.dtype]}")
        with on_device(q.device):
            code = fn(*ptrs, *shape, stream)
        _build.check(code, lib, "flash_attention_bwd_error_string",
                     f"flash_attention_bwd_{which}({tuple(q.shape)})")
        launch_counts[f"flash_attention_bwd_{which}"] += 1
    grads = (dq if needs[0] else None, dk if needs[1] else None, dv if needs[2] else None)
    return tuple(t[..., :d] if t is not None and dk_ != d else t for t in grads)


def _bwd_one_launch(route, q, k, v, o, lse, do, needs, d):
    """The small route (Tq, Tk <= SMALL_BWD_T) or the long route (past it)
    on padded bf16 inputs at head dims 16 and 32: one launch writes dq, dk
    and dv, delta computed inside. The long route's dQ crosses chunks of
    keys through each block's fp32 slots, summed in block order by the
    block that finishes last (a zeroed counter a batch*head)."""
    b, tq, h, dk_ = q.shape
    tk = k.shape[1]
    name = f"flash_attention_bwd_{route}"
    small = max(tq, tk) <= SMALL_BWD_T
    if q.dtype != torch.bfloat16 or dk_ not in SMALL_BWD_HEAD_DIMS or small != (route == "small"):
        raise ValueError(f"{name} takes bf16 at padded head dims {SMALL_BWD_HEAD_DIMS} with Tq, "
                         f"Tk {'<=' if route == 'small' else 'not both <='} {SMALL_BWD_T}; got q "
                         f"{tuple(q.shape)} {q.dtype}, Tk={tk}")
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"{name}: o {tuple(o.shape)} {o.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    _check_strides(name, (o,))
    dq = torch.empty((b, tq, h, dk_), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, dk_), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _library("flash_attention_bwd")
    strides = _strides(q, k, v, o, do, dq, dk, dv)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
           lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (b, h, tq, tk, dk_, ctypes.addressof(strides), 1.0 / math.sqrt(d),
             LOG2E / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    with on_device(q.device):
        if route == "small":
            code = lib.flash_attention_bwd_small(*ins, *shape)
        else:
            # the blocks' fp32 slots of dQ (each written whole by a block's
            # first chunk before it is read, so no zeroing) and the counters
            # of the blocks that have finished
            part = arrived = None
            groups = long_bwd_groups(b * h, tk)
            if tk > LONG_BWD_PLAN.bn:
                part = torch.empty(b * h * groups * -(-tq // LONG_BWD_BM) * LONG_BWD_BM * dk_,
                                   dtype=torch.float32, device=q.device)
            if groups > 1:
                arrived = torch.zeros(b * h, dtype=torch.int32, device=q.device)
            code = lib.flash_attention_bwd_long(
                *ins, part.data_ptr() if part is not None else None,
                arrived.data_ptr() if arrived is not None else None, groups, *shape)
    _build.check(code, lib, "flash_attention_bwd_error_string",
                 f"{name}({tuple(q.shape)}, Tk={tk})")
    launch_counts[name] += 1
    return (dq if needs[0] else None, dk if needs[1] else None, dv if needs[2] else None)


def _bwd_tf32(q, k, v, o, lse, do, needs, d):
    """The 3xTF32 pair on padded fp32 inputs: the pre-pass, then dkv (for
    dk or dv) and dq (for dq); delta from the PyTorch expression, as the
    FMA pair's."""
    b, tq, h, dk_ = q.shape
    tk = k.shape[1]
    qs, kvs = flash_bwd_split(q, do, k, v)
    delta = flash_delta(o, do)
    want_kv = needs[1] or needs[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if needs[0] else None
    dk = torch.empty((b, tk, h, dk_), dtype=q.dtype, device=q.device) if want_kv else None
    dv = torch.empty_like(dk) if want_kv else None
    lib = _library("flash_attention_bwd")
    strides = _strides(q, k, v, do, dq if dq is not None else q, dk if want_kv else k,
                       dv if want_kv else v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr() if dq is not None else None,
            dk.data_ptr() if want_kv else None, dv.data_ptr() if want_kv else None)
    shape = (b, h, tq, tk, dk_, ctypes.addressof(strides), 1.0 / math.sqrt(d),
             LOG2E / math.sqrt(d), qs.data_ptr(), kvs.data_ptr(), stream)
    for which, wanted in (("dkv", want_kv), ("dq", needs[0])):
        if not wanted:
            continue
        with on_device(q.device):
            code = getattr(lib, f"flash_attention_bwd_tf32_{which}")(*ptrs, *shape)
        _build.check(code, lib, "flash_attention_bwd_error_string",
                     f"flash_attention_bwd_tf32_{which}({tuple(q.shape)}, Tk={tk})")
        launch_counts[f"flash_attention_bwd_tf32_{which}"] += 1
    return (dq if needs[0] else None, dk if needs[1] else None, dv if needs[2] else None)


def flash_bwd_split(q: torch.Tensor, do: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tf32 backward's pre-pass on fp32 [B, T, H, D] tensors (D = 64
    or 128; D contiguous, strides and data 16-byte aligned; on the card):
    the tf32 terms of q and dO, [2 (q, dO), 2 (hi, lo), B*H, Tq, D], and of
    k and v, [2 (k, v), 2, B*H, Tk, D]. Its plain version is
    ``flash_bwd_split_plain``; the backward launches it itself."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_bwd_tf32_split has no kernel for device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_fp32("flash_attention_bwd_tf32_split", (q, do, k, v),
                (q.shape, q.shape, (b, tk, h, d), (b, tk, h, d)))
    qs = torch.empty((2, 2, b * h, tq, d), dtype=torch.float32, device=q.device)
    kvs = torch.empty((2, 2, b * h, tk, d), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention_bwd")
    strides = _strides(q, do, k, v)
    with on_device(q.device):
        code = lib.flash_attention_bwd_tf32_split(
            q.data_ptr(), do.data_ptr(), k.data_ptr(), v.data_ptr(), qs.data_ptr(),
            kvs.data_ptr(), b, h, tq, tk, d, ctypes.addressof(strides),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, lib, "flash_attention_bwd_error_string",
                 f"flash_attention_bwd_tf32_split({tuple(q.shape)}, Tk={tk})")
    launch_counts["flash_attention_bwd_tf32_split"] += 1
    return qs, kvs


def flash_bwd_split_plain(q: torch.Tensor, do: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the tf32 backward's pre-pass: each of q, dO
    (and k, v) [B, T, H, D] as [B*H, T, D] rows, its hi = tf32(x) and lo =
    tf32(x - hi) terms, fp32: [2 (q, dO), 2 (hi, lo), B*H, Tq, D] and [2 (k,
    v), 2, B*H, Tk, D]. No padding and no transposed copy: the kernels read
    the transposed operands from these at transposed positions."""
    def terms(x):
        hi, lo = tf32_split(x.float().transpose(1, 2).reshape(-1, x.shape[1], x.shape[3])
                            .contiguous())
        return torch.stack([hi, tf32_round(lo)])

    return torch.stack([terms(q), terms(do)]), torch.stack([terms(k), terms(v)])


def _tf32_chunked(a: torch.Tensor, b: torch.Tensor, terms: int = 3,
                  chunk: int = 32) -> torch.Tensor:
    """a @ b (batched, fp32) as the tf32 kernels sum it: per ``chunk`` of
    the reduced dimension, the TF32 terms' products (``tf32_matmul``; at
    most 12 TF32 products in the tensor cores' accumulator), the chunks'
    sums added in fp32 in order."""
    out = None
    for c in range(0, a.shape[-1], chunk):
        part = tf32_matmul(a[..., c:c + chunk].contiguous(), b[..., c:c + chunk, :].contiguous(),
                           terms)
        out = part if out is None else out + part
    return out


def flash_bwd_tf32_plain(q, k, v, o, lse, do, terms: int = 3):
    """The tf32 backward pair's arithmetic in plain PyTorch, fp32 [B, T,
    H, D] in, (dq, dk, dv) out, product by product in the kernels' order:
    S and dP over the head dim in 32-channel chunks; P from the base-2
    ``lse``; dS = P' (dP - delta) with P' = hi + tf32(lo), P as it is read
    back from its two tf32 terms; dV = P^T dO and dK = dS^T Q / sqrt(D) over
    32-query stages, dQ = dS K / sqrt(D) over 32-key stages, each product
    3xTF32 (``terms`` 1: one TF32 product, the control)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qb, kb, vb, dob = (t.float().transpose(1, 2) for t in (q, k, v, do))
    s = _tf32_chunked(qb, kb.transpose(-1, -2), terms)
    p = torch.exp2(s * (scale * LOG2E) - lse[..., None])
    dp = _tf32_chunked(dob, vb.transpose(-1, -2), terms)
    p_hi, p_lo = tf32_split(p.contiguous())
    ds = (p_hi + tf32_round(p_lo)) * (dp - flash_delta(o, do)[..., None])
    dv = _tf32_chunked(p.transpose(-1, -2), dob, terms)
    dk = _tf32_chunked(ds.transpose(-1, -2), qb, terms) * scale
    dq = _tf32_chunked(ds, kb, terms) * scale
    return tuple(t.transpose(1, 2) for t in (dq, dk, dv))


class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' (or, on the CPU, the plain
    versions') forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, with_lse: bool):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v)
            saved_out, lse = out, (flash_lse_plain(q, k) if with_lse else None)
        else:
            saved_out, lse = flash_attention_fwd_kernel(q, k, v, with_lse)
            d = q.shape[-1]
            out = saved_out if saved_out.shape[-1] == d else saved_out[..., :d]
        if with_lse:
            ctx.save_for_backward(q, k, v, saved_out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        saved = ctx.saved_tensors  # read once: a recomputed block unpacks each tensor once
        if not saved:
            raise RuntimeError("flash_attention was run without its log-sum-exp; "
                               "it cannot be differentiated")
        q, k, v, o, lse = saved
        needs = ctx.needs_input_grad[:3]
        if q.device.type == "cpu":
            dq = flash_attention_bwd_dq_plain(q, k, v, o, lse, do) if needs[0] else None
            dk, dv = (flash_attention_bwd_dkv_plain(q, k, v, o, lse, do)
                      if needs[1] or needs[2] else (None, None))
        else:
            dq, dk, dv = flash_attention_bwd_kernel(q, k, v, o, lse, do, needs)
        return (*(g if need else None for g, need in zip((dq, dk, dv), needs)), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Multi-head attention [B, T, H, D] -> [B, T, H, D], differentiable: the
    CUDA kernels on the card, the plain versions on the CPU."""
    _check(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_attention has no kernel for device {q.device}")
    with_lse = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, with_lse)
