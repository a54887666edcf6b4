"""Flash attention (non-causal) for [B, T, H, D] tensors, forward and backward.

``flash_attention(q, k, v)`` is differentiable. It is the autograd Function
``FlashAttention``, the port of the JAX package's ``_flash_mha`` custom VJP
(``rho_diffusion_tpu/ops/pallas/flash_attention.py:374-408``):

* on CUDA bf16 or fp32 tensors the forward is the hand-written kernel of
  ``csrc/flash_attention.cu`` (replacing the TPU kernels ``_fwd_kernel_onepass``
  and ``_fwd_kernel``) and the backward the two kernels of
  ``csrc/flash_attention_bwd.cu`` (replacing ``_bwd_dkv_kernel`` and
  ``_bwd_dq_kernel``);
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
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts

HEAD_DIMS = (16, 32, 64, 128, 256)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
LOG2E = 1.4426950408889634


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
    return next(x for x in HEAD_DIMS if x >= d), d


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
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel. Returns the output padded to the kernel's
    head dim, [B, Tq, H, Dk], and the base-2 LSE [B, H, Tq] (fp32) when
    ``with_lse``, else None."""
    check_no_autograd("flash_attention", q, k, v)
    _check(q, k, v)
    dk, d = _kernel_layout("flash_attention", q, k, v)
    q, k, v = (_pad(t, dk) for t in (q, k, v))
    _check_strides("flash_attention", (q, k, v))
    b, tq, h, _ = q.shape
    tk = k.shape[1]
    out = torch.empty((b, tq, h, dk), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load("flash_attention")
    fn = getattr(lib, f"flash_attention_fwd_{_SUFFIX[q.dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
    ]
    strides = _strides(q, k, v, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            b, h, tq, tk, dk, ctypes.addressof(strides), LOG2E / math.sqrt(d), stream,
        )
    _build.check(code, lib, "flash_attention_error_string", f"flash_attention({tuple(q.shape)})")
    launch_counts["flash_attention"] += 1
    return out, lse


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
    lib = _build.load("flash_attention_bwd")
    strides = _strides(q, k, v, do, dq if dq is not None else q, dk if want_kv else k,
                       dv if want_kv else v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launches = [("dkv", want_kv), ("dq", needs[0])]
    for which, wanted in launches:
        if not wanted:
            continue
        fn = getattr(lib, f"flash_attention_bwd_{which}_{_SUFFIX[q.dtype]}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        with torch.cuda.device(q.device):
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
