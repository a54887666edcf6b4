"""Flash attention (non-causal) for [B, T, H, D] tensors, forward and backward.

``flash_attention(q, k, v)`` is differentiable. It is the autograd Function
``FlashAttention``, the port of the JAX package's ``_flash_mha`` custom VJP
(``rho_diffusion_tpu/ops/pallas/flash_attention.py:374-408``):

* on CUDA bf16 or fp32 tensors the forward is a hand-written kernel launched
  from ``csrc/flash_attention.cu`` (replacing the TPU kernels
  ``_fwd_kernel_onepass`` and ``_fwd_kernel``) and the backward the two
  kernels of ``csrc/flash_attention_bwd.cu`` (replacing ``_bwd_dkv_kernel``
  and ``_bwd_dq_kernel``);
* on CPU tensors both directions are the plain versions below, through the
  same Function, so the CPU tests run its backward logic.

Scores and softmax are fp32 at 1/sqrt(D); any T. The forward writes the
row log-sum-exp only when the call will be differentiated (grad mode on and
an input that requires grad), as the TPU primal path skips it. The LSE is
kept in base 2 of the scaled scores (see flash_attention.cu), and the
backward exponentiates in that base. ``delta = rowsum(dO * O)`` is a PyTorch
expression, as the JAX package leaves it to XLA.

q, k, v may be strided views (the UNet's split of one qkv projection) as long
as D is contiguous; head dims other than 16/32/64/128/256 are zero-padded up
to the next one (padding changes neither Q K^T nor the kept columns of P V,
and the padded gradient columns are dropped).

The forward's route is ``flash_plan``'s, by head dim and dtype only: bf16 at
head dims 64 and 128 (the UNet's) takes the Hopper kernel
(``csrc/flash_attention_wgmma.cuh``: Q and K/V tiles by TMA through an
mbarrier ring, Q K^T and P V on ``wgmma``, warp-specialised), with the
plan's query rows a block and keys a tile; bf16 at 16,
32 and 256 takes the ``mma.sync`` kernel; fp32 its CUDA-core kernel. A
failed build, encode or launch raises; no route stands in for another.
``flash_routes`` counts the forward's launches by route and key length.
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
    """The forward's route ("wgmma", "mma_sync" or "fp32") and its tiles:
    query rows a block (bm) and keys a K/V tile (bn). The wgmma route takes
    the tiles of WGMMA_TILES; the other two have fixed tiles, which the plan
    records."""

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
FP32_PLAN = FlashPlan("fp32", 16, 64)
WGMMA_PLANS = tuple(FlashPlan("wgmma", bm, bn) for bm, bn in WGMMA_TILES)


def padded_head_dim(d: int) -> int:
    """The kernels' head dim for a true one: the next of HEAD_DIMS."""
    return next(x for x in HEAD_DIMS if x >= d)


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, h: int, tq: int, tk: int, d: int, dtype=torch.bfloat16,
               sms: int = 132) -> FlashPlan:
    """The forward's plan for q [b, tq, h, d] against tk keys on a card of
    ``sms`` multiprocessors (132: the H100 SXM).

    The route goes by head dim and dtype: bf16 whose padded head dim is 64
    or 128 takes the wgmma kernel, other bf16 the mma.sync kernel, fp32 its
    own; other dtypes have none. For the wgmma route, each SM runs two
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
        return FP32_PLAN
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bfloat16 or float32, got {dtype}")
    if padded_head_dim(d) not in WGMMA_HEAD_DIMS:
        return MMA_SYNC_PLAN
    bm = min(FLASH_BM, key=lambda m: (busiest_sm_rows(m, b, h, tq, sms), -m))
    return FlashPlan("wgmma", bm, bm if tk > 64 else 64)


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
        "flash_attention_fwd_f32": _FWD + [_PTR],
        "flash_attention_fwd_wgmma": _FWD + [_INT] * 2 + [_PTR],
        "flash_wgmma_pv_probe": [_PTR] * 3 + [_INT] * 2 + [_PTR],
    },
    "flash_attention_bwd": {f"flash_attention_bwd_{which}_{suffix}": _BWD
                            for which in ("dkv", "dq") for suffix in ("bf16", "f32")},
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


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_longlong * (3 * len(tensors)))(*(s for t in tensors for s in t.stride()[:3]))


def flash_attention_fwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, with_lse: bool = False,
    plan: Optional[FlashPlan] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel of ``plan``'s route (``flash_plan``'s when
    not given: tile studies pass their own). Returns the output padded to
    the kernel's head dim, [B, Tq, H, Dk], and the base-2 LSE [B, H, Tq]
    (fp32) when ``with_lse``, else None."""
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
    if (plan.route == "fp32") != (q.dtype == torch.float32):
        raise ValueError(f"flash_attention: the {plan.route} route does not take {q.dtype}")
    out = torch.empty((b, tq, h, dk), dtype=q.dtype, device=device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=device) if with_lse else None
    lib = _library("flash_attention")
    strides = _strides(q, k, v, out)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, tq, tk, dk, ctypes.addressof(strides), LOG2E / math.sqrt(d))
    stream = torch.cuda.current_stream(device).cuda_stream
    with on_device(device):
        if plan.route == "wgmma":
            code = lib.flash_attention_fwd_wgmma(*args, plan.bm, plan.bn, stream)
        elif plan.route == "mma_sync":
            code = lib.flash_attention_fwd_bf16(*args, stream)
        else:
            code = lib.flash_attention_fwd_f32(*args, stream)
    _build.check(code, lib, "flash_attention_error_string",
                 f"flash_attention({tuple(q.shape)}, Tk={tk}, plan {tuple(plan)})")
    launch_counts["flash_attention"] += 1
    flash_routes[f"{plan.route} Tk={tk}"] += 1
    return out, lse


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


def flash_attention_bwd_kernel(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, needs: tuple[bool, bool, bool] = (True, True, True),
) -> tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Launch the backward kernels (dkv, then dq) on the forward's inputs,
    its padded output ``o`` and base-2 ``lse``. ``needs`` says which of dq,
    dk, dv to compute (dk and dv come from one launch)."""
    check_no_autograd("flash_attention_bwd", q, k, v, o, do)
    _check(q, k, v)
    dk_, d = _kernel_layout("flash_attention_bwd", q, k, v)
    q, k, v, o, do = (_pad(t, dk_) for t in (q, k, v, o, do.to(q.dtype)))
    do = do.contiguous()
    _check_strides("flash_attention_bwd", (q, k, v, do))
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    delta = flash_delta(o, do)
    lse = lse.contiguous()
    dq = torch.empty_like(q, memory_format=torch.contiguous_format) if needs[0] else None
    want_kv = needs[1] or needs[2]
    dk = torch.empty((b, tk, h, dk_), dtype=q.dtype, device=q.device) if want_kv else None
    dv = torch.empty_like(dk) if want_kv else None
    lib = _library("flash_attention_bwd")
    strides = _strides(q, k, v, do, dq if dq is not None else q, dk if want_kv else k,
                       dv if want_kv else v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launches = [("dkv", want_kv), ("dq", needs[0])]
    for which, wanted in launches:
        if not wanted:
            continue
        fn = getattr(lib, f"flash_attention_bwd_{which}_{_SUFFIX[q.dtype]}")
        with on_device(q.device):
            code = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr() if dq is not None else None,
                dk.data_ptr() if want_kv else None, dv.data_ptr() if want_kv else None,
                b, h, tq, tk, dk_, ctypes.addressof(strides), 1.0 / math.sqrt(d),
                LOG2E / math.sqrt(d), stream,
            )
        _build.check(code, lib, "flash_attention_bwd_error_string",
                     f"flash_attention_bwd_{which}({tuple(q.shape)})")
        launch_counts[f"flash_attention_bwd_{which}"] += 1
    return tuple(t[..., :d] if t is not None and dk_ != d else t for t in (dq, dk, dv))


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
        if not ctx.saved_tensors:
            raise RuntimeError("flash_attention was run without its log-sum-exp; "
                               "it cannot be differentiated")
        q, k, v, o, lse = ctx.saved_tensors
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
