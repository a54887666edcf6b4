"""Per-level conv profile of the port's conv kernel (K5) on the card.

The counterpart of ``benchmarks/conv_profile.py``: at each flagship UNet
level's conv shape (batch 32), K5's forward and its forward plus dgrad (the
input gradient of sum(conv(x)^2), through K5 on the flipped weights), each
beside cuDNN's (``F.conv3d``, ``torch.nn.grad.conv3d_input``), state-chained;
then the equal-FLOP cuBLAS matmul (``(a @ b) @ proj``) at the im2col shapes
of the four levels and one generic large matmul, the tensor cores' reach
with a dense operand. The library calls are yardsticks only.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv_profile [-d cuda|cpu]
"""
from __future__ import annotations

import sys

import torch

from rho_diffusion_tpu_torch.benchmarks._timing import (
    PEAK_BF16, chain_time, device_line, parse_device, tflops)
from rho_diffusion_tpu_torch.benchmarks.conv3d_ab import (
    chain, conv_flops, conv_inputs, library_conv)
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d, conv3d_dgrad

# flagship (examples/config_spherical_harmonics.json): 3-D UNet, mc=64,
# mult (1,2,4,8), batch 32, 32^3 grid; 3-D downsampling halves the inner dims
LEVEL_SHAPES = [  # (B, D, H, W, Cin, Cout)
    (32, 32, 32, 32, 64, 64),    # level 0
    (32, 32, 16, 16, 128, 128),  # level 1
    (32, 32, 8, 8, 256, 256),    # level 2
    (32, 32, 4, 4, 512, 512),    # level 3 (bottleneck)
    (32, 32, 32, 32, 128, 64),   # level-0 decoder (skip concat)
]
MATMUL_SHAPES = [  # (M, K, N)
    (32 * 32 * 32 * 32, 27 * 64, 64),  # level-0 conv as an im2col matmul
    (32 * 32 * 16 * 16, 27 * 128, 128),
    (32 * 32 * 8 * 8, 27 * 256, 256),
    (32 * 32 * 4 * 4, 27 * 512, 512),
    (8192, 4096, 4096),                # generic large matmul
]


def library_dgrad(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    b, d, h, w, _ = g.shape
    shape = (b, weight.shape[1], d, h, w)
    return torch.nn.grad.conv3d_input(shape, weight, g.movedim(-1, 1), padding=1).movedim(1, -1)


def fwd_bwd(conv, dgrad):
    """x + 1e-6 * d/dx sum(conv(x)^2): the gradient 2 conv(x), in fp32 as
    in the JAX script's loss, rounded to x's dtype for the dgrad."""
    def step(x):
        g = (2.0 * conv(x).float()).to(x.dtype)
        return x + 1e-6 * dgrad(g).to(x.dtype)
    return step


def profile_shape(shape, device) -> dict:
    x0, weight, back = conv_inputs(shape, device)
    fl = conv_flops(shape)
    k5 = lambda x: conv3d(x, weight)  # noqa: E731
    lib = lambda x: library_conv(x, weight)  # noqa: E731
    row = {"shape": list(shape)}
    for name, conv, dgrad in (("k5", k5, lambda g: conv3d_dgrad(g, weight)),
                              ("library", lib, lambda g: library_dgrad(g, weight))):
        t_f = chain_time(chain(conv, back), x0, iters=24)
        t_fb = chain_time(fwd_bwd(conv, dgrad), x0, iters=24)
        on_card = device.type == "cuda"
        row.update({f"{name}_fwd_ms": t_f, f"{name}_fwdbwd_ms": t_fb,
                    f"{name}_fwd_tflops": tflops(fl, t_f) if on_card else None,
                    f"{name}_fwdbwd_tflops": tflops(2 * fl, t_fb) if on_card else None})
    return row


def profile_matmul(m: int, k: int, n: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(1)

    def draw(s):
        return (0.05 * torch.randn(s, generator=gen, device=device)).bfloat16()

    a0, bmat, proj = draw((m, k)), draw((k, n)), draw((n, k))
    ms = chain_time(lambda a: a + 0.001 * ((a @ bmat) @ proj), a0, iters=24)
    fl = 4.0 * m * k * n
    return {"m": m, "k": k, "n": n, "ms": ms,
            "tflops": tflops(fl, ms) if device.type == "cuda" else None}


def main(argv=None) -> dict:
    args = parse_device(__doc__, argv)
    print(device_line(args.device), flush=True)
    convs, matmuls = [], []
    for shape in LEVEL_SHAPES:
        r = profile_shape(shape, args.device)
        convs.append(r)
        b, d, h, w, cin, cout = shape
        line = f"{b}x{d}x{h}x{w} {cin}->{cout}:"
        for name, label in (("k5", "K5"), ("library", "cuDNN")):
            line += f"  {label} fwd {r[f'{name}_fwd_ms']:8.3f} ms"
            if r[f"{name}_fwd_tflops"] is not None:
                line += f" {r[f'{name}_fwd_tflops']:6.1f} TF/s"
            line += f", fwd+dgrad {r[f'{name}_fwdbwd_ms']:8.3f} ms"
            if r[f"{name}_fwdbwd_tflops"] is not None:
                line += f" {r[f'{name}_fwdbwd_tflops']:6.1f} TF/s"
        print(line, flush=True)
    for m, k, n in MATMUL_SHAPES:
        r = profile_matmul(m, k, n, args.device)
        matmuls.append(r)
        rate = ""
        if r["tflops"] is not None:
            rate = f" {r['tflops']:6.1f} TF/s ({r['tflops'] * 1e12 / PEAK_BF16:.0%} of 989)"
        print(f"matmul {m}x{k}x{n}: {r['ms']:8.3f} ms{rate}", flush=True)
    return {"convs": convs, "matmuls": matmuls}


if __name__ == "__main__":
    main(sys.argv[1:])
