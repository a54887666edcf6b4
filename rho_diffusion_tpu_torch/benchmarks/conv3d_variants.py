"""Bottleneck isolation of the port's conv GEMM (K5) at the level-1 shape.

The counterpart of ``benchmarks/conv3d_variants.py`` on the card. Every
variant is K5's own Hopper block (``csrc/conv3d_wgmma.cuh``: TMA into an
mbarrier ring, wgmma) with one factor changed
(``ops/kernels/conv3d_variants.py``):

  full      K5's kernel as it is, on K5's plan (K7)
  nopatch   every tap's box drops its (dz, dy) offset, keeping dx (K7)
  nodma     A is never loaded: a fixed pattern in every ring stage, only B
            arrives (K7)
  dotsonly  9 dots on one patch p [P, CPAD]: the mainloop without the gather (K9)
  bigdotN   the patch of N depth slices (default 4) in device memory, then one
            dense GEMM with K = 27*Cin per pass (K8)

Each is timed state-chained, ``x + 0.001 * f(x)`` (``p + 0.001 * f(p) @
back`` for dotsonly), and printed with ms, TFLOP/s and the share of the
card's 989 TFLOP/s bf16 peak, and the device time of its own kernels.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv3d_variants [-d cuda|cpu] [variant ...]
"""
from __future__ import annotations

import functools
import sys

import torch

from rho_diffusion_tpu_torch.benchmarks._timing import (
    PEAK_BF16, chain_time, device_line, device_ms, parse_device, tflops)
from rho_diffusion_tpu_torch.ops.kernels.conv3d_variants import (
    VARIANTS, bigdot, conv_variant, dots_only)

# the JAX script's constants (tests shrink them): the level-1 conv, the TPU
# kernel's depth and channel tiles (TD sets dotsonly's patch rows M, TC its
# output width) and the padded width of one dz, dy tap row, 3*CIN
B, D, H, W, CIN, COUT = 32, 32, 16, 16, 128, 128
TD, TC = 8, 128
CPAD = 384
DEFAULT_VARIANTS = ("full", "nopatch", "nodma", "dotsonly")


def conv_flops() -> float:
    return 2.0 * B * D * H * W * CIN * COUT * 27


def bigdot_td(variant: str) -> int:
    return int(variant[6:]) if len(variant) > 6 else 4


def check_variant(variant: str) -> None:
    if variant in (*VARIANTS, "dotsonly"):
        return
    if variant.startswith("bigdot") and (len(variant) == 6 or variant[6:].isdigit()):
        return
    raise ValueError(f"unknown variant {variant!r}: full, nopatch, nodma, dotsonly or bigdot[N]")


def inputs(device, seed: int = 0) -> dict:
    """Seeded bf16 inputs as the JAX script draws them: x and p ~ 0.1 N,
    km ~ 0.02 N, dotsonly's projection back ~ 0.01 N."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(shape, scale):
        return (scale * torch.randn(shape, generator=gen, device=device)).bfloat16()

    x = draw((B, D, H, W, CIN), 0.1)
    km = draw((9 * CPAD, COUT), 0.02)
    return {"x": x, "km": km, "km_tc": km[:, :TC].contiguous(),
            "p": draw((B * (D // TD) * TD * H * W, CPAD), 0.1), "back": draw((TC, CPAD), 0.01)}


def kernel_fn(variant: str, ins: dict):
    """The variant's wrapper as a function of its chained input: x, or p
    for dotsonly."""
    km, km_tc = ins["km"], ins["km_tc"]
    if variant == "dotsonly":
        return lambda p: dots_only(p, km_tc)
    if variant.startswith("bigdot"):
        td = bigdot_td(variant)
        return lambda x: bigdot(x, km, td)
    return lambda x: conv_variant(x, km, variant)


def chained_input(variant: str, ins: dict) -> torch.Tensor:
    return ins["p"] if variant == "dotsonly" else ins["x"]


def kernel_call(variant: str, ins: dict):
    """The variant's wrapper call on ``ins``, as a zero-argument function."""
    return functools.partial(kernel_fn(variant, ins), chained_input(variant, ins))


def kernel_names(variant: str) -> tuple:
    """The CUDA kernels (profiler name substrings) a variant launches."""
    if variant == "dotsonly":
        return ("conv3d_dotsonly",)
    if variant.startswith("bigdot"):
        return ("conv3d_bigdot_im2col", "conv3d_bigdot_gemm")
    return (f"conv3d_variant_{variant}",)


def step_fn(variant: str, ins: dict):
    """The chained step of the JAX script: x + 0.001 f(x), and for dotsonly
    p + 0.001 f(p) @ back (f(p) has TC columns, p CPAD)."""
    f, back = kernel_fn(variant, ins), ins["back"]
    if variant == "dotsonly":
        return lambda p: p + 0.001 * (f(p) @ back).to(p.dtype)
    return lambda x: x + 0.001 * f(x).to(x.dtype)


def run(variant: str, ins: dict) -> dict:
    check_variant(variant)
    start = chained_input(variant, ins)
    ms = chain_time(step_fn(variant, ins), start, iters=20, reps=3)
    on_card = start.device.type == "cuda"
    return {"variant": variant, "ms": ms,
            "tflops": tflops(conv_flops(), ms) if on_card else None,
            "peak_share": conv_flops() / (ms * 1e-3) / PEAK_BF16 if on_card else None,
            "kernels_ms": (device_ms(kernel_call(variant, ins), kernel_names(variant))
                           if on_card else None),
            "kernels": list(kernel_names(variant))}


def main(argv=None) -> list:
    args = parse_device(__doc__, argv, variants=dict(nargs="*"))
    variants = args.variants or list(DEFAULT_VARIANTS)
    for v in variants:
        check_variant(v)
    print(device_line(args.device), flush=True)
    print(f"conv [{B},{D},{H},{W},{CIN}] -> {COUT}, bf16: {conv_flops() / 1e9:.1f} GFLOP",
          flush=True)
    ins = inputs(args.device)
    rows = []
    for v in variants:
        r = run(v, ins)
        rows.append(r)
        rate = (f"  ({r['tflops']:6.1f} TF/s, {r['peak_share']:6.1%} of 989 TF/s)"
                if r["tflops"] is not None else "")
        dev = f"  kernels {r['kernels_ms']:.4f} ms on the device" if r["kernels_ms"] else ""
        print(f"{v:>9}: {r['ms']:8.4f} ms{rate}{dev}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
