"""The 3xTF32 split in plain PyTorch: what the tf32 kernel routes compute.

The tensor cores take fp32 operands as TF32, which keeps 10 of fp32's 23
mantissa bits. The conv and ring kernels' tf32 routes (``csrc/wgmma.cuh``
``split_tf32``) split each fp32 operand into two TF32 terms,
a = a_hi + a_lo with a_hi = tf32(a), and take

    a b ~ tf32(a_lo) b_hi + a_hi tf32(b_lo) + a_hi b_hi

in the fp32 accumulator, the small terms first. Each TF32 product is exact
in fp32, so only a_lo b_lo (~2^-22 relative) and the accumulator's own
rounding are lost: fp32 accuracy at three TF32 products. One TF32 product,
a_hi b_hi, is ~2^-11 relative.

``tf32_round`` is the kernels' ``cvt.rna.tf32.f32`` (round to nearest, ties
away from zero); ``tf32_split`` its split; ``tf32_matmul`` the product of
the split terms with exact fp32 products and fp32 sums, on any device (on a
card with TF32 matmuls turned off, torch's default).
"""
from __future__ import annotations

import torch

TF32_DROP_BITS = 13  # fp32 mantissa bits TF32 does not keep


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (its low 13 mantissa bits zero), to
    nearest with ties away from zero: half of the dropped bits' weight is
    added to the magnitude bits, which are then cut."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    half, mask = 1 << (TF32_DROP_BITS - 1), ~((1 << TF32_DROP_BITS) - 1)
    return ((x.contiguous().view(torch.int32) + half) & mask).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = x - hi, exact in fp32: hi + lo
    == x and |lo| <= 2^-11 |x|. The kernels feed tf32(lo) to the tensor
    cores."""
    hi = tf32_round(x)
    return hi, x - hi


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b (fp32) as the tensor cores compute it from TF32 terms: with
    ``terms`` 3 the kernels' 3xTF32 (tf32(a_lo) b_hi + a_hi tf32(b_lo) +
    a_hi b_hi, the small terms first), with 1 a single TF32 product
    (a_hi b_hi)."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    if terms == 1:
        return a_hi @ b_hi
    if terms != 3:
        raise ValueError(f"tf32_matmul takes 1 or 3 terms, got {terms}")
    return tf32_round(a_lo) @ b_hi + a_hi @ tf32_round(b_lo) + a_hi @ b_hi
