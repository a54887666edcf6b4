"""One step of ring attention (K6): fold one K/V slot into a rank's running
online-softmax state.

``ring_attn_step`` launches the hand-written kernel of
``csrc/ring_attention.cu`` (bf16 and fp32 instances), which replaces the
compute of the TPU kernel ``_kernel`` / ``ring_attention_rdma``
(``rho_diffusion_tpu/parallel/context_rdma.py:50-189``); the ring around it
(slots, copies, ordering) is ``parallel/context_rdma.py``.
``ring_attn_step_plain`` is its plain version: the same fp32 arithmetic in
PyTorch. Both take the same arguments and update the state in place:

* ``q`` [B, Tq, H, D] (any strides with D contiguous), ``k``/``v`` the
  slot's contiguous [B*H, S, D], in one dtype;
* ``m``, ``l`` fp32 [B*H, Tq] and ``acc`` fp32 [B*H, Tq, D]: the running
  max of the base-2 scores s = q k^T * log2(e)/sqrt(d), the row sum of
  exp2(s - m), and the unnormalised output;
* ``first`` starts the state from (-inf, 0, 0) without reading it;
  ``last`` writes ``o = acc / l`` (``o`` is [B, Tq, H, D] in q's dtype) and
  leaves the state alone.

``scale_log2`` is log2(e)/sqrt(d) of the true head dim d; the ring pads
other head dims to the kernel's (16, 32, 64, 128 or 256) with zeros.

K6 has no backward, as in JAX (a bare ``pallas_call`` without
``custom_vjp``): a launch under grad mode with an input that requires grad
raises. Each launch adds one to ``launch_counts["ring_attention"]``; a ring
call over n ranks launches n * n times.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rho_diffusion_tpu_torch.ops.kernels import _build, check_no_autograd, launch_counts

HEAD_DIMS = (16, 32, 64, 128, 256)
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


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
    """The plain version of ``ring_attn_step``, in fp32 (TPU :92-107 and
    :140-144, in base 2)."""
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


def _check(q, k, v, m, l, acc, o, last: bool) -> None:  # noqa: E741
    if q.device.type != "cuda":
        raise RuntimeError(f"ring_attention has no kernel for device {q.device}")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"ring_attention kernel takes bfloat16 or float32, got {q.dtype}")
    b, tq, h, d = q.shape
    bh, s = b * h, k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"ring_attention kernel takes head dims {HEAD_DIMS}, got {d}")
    if bh > 65535 or tq == 0 or s == 0:
        raise ValueError(f"ring_attention: shape {tuple(q.shape)} is out of the kernel's range")
    want = {"k": (k, (bh, s, d), q.dtype), "v": (v, (bh, s, d), q.dtype),
            "m": (m, (bh, tq), torch.float32), "l": (l, (bh, tq), torch.float32),
            "acc": (acc, (bh, tq, d), torch.float32)}
    if last:
        want["o"] = (o, (b, tq, h, d), q.dtype)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != q.device:
            raise ValueError(f"ring_attention: {name} must be {dtype} {shape} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if name != "o" and not t.is_contiguous():
            raise ValueError(f"ring_attention: {name} must be contiguous")
    for name, t in (("q", q), ("o", o if last else q)):
        if (t.stride(-1) != 1 or any(st * t.element_size() % 16 for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"ring_attention kernel needs {name} with D contiguous, B/T/H strides that are "
                f"multiples of 16 bytes and 16-byte aligned data; got strides {t.stride()}",
            )


def ring_attn_step(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, m: torch.Tensor, l: torch.Tensor,  # noqa: E741
    acc: torch.Tensor, o: Optional[torch.Tensor], scale_log2: float, first: bool, last: bool,
) -> None:
    """Fold the slot (k, v) into the state on the current CUDA stream: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    check_no_autograd("ring_attention", q, k, v)
    if q.device.type == "cpu":
        ring_attn_step_plain(q, k, v, m, l, acc, o, scale_log2, first, last)
        return
    _check(q, k, v, m, l, acc, o, last)
    b, tq, h, d = q.shape
    lib = _build.load("ring_attention")
    fn = getattr(lib, f"ring_attn_step_{_SUFFIX[q.dtype]}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    strides = (ctypes.c_longlong * 6)(*q.stride()[:3], *(o if last else q).stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            o.data_ptr() if last else None, b, h, tq, k.shape[1], d, ctypes.addressof(strides),
            scale_log2, int(first), int(last), stream,
        )
    _build.check(code, lib, "ring_attention_error_string", f"ring_attention({tuple(q.shape)})")
    launch_counts["ring_attention"] += 1
