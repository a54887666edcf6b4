"""A/B: the port's conv kernel (K5) against ``F.conv3d`` (cuDNN) on the card.

The counterpart of ``benchmarks/conv3d_ab.py``: at each of its six shapes,
both convs state-chained (``x + 0.001 * conv(x)``, through a [Cout, Cin]
projection where Cout != Cin), and the largest difference between them on
the first input. ``F.conv3d`` is the yardstick here and nowhere on a path of
the port.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv3d_ab [-d cuda|cpu] [shape index]
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.benchmarks._timing import (
    PEAK_BF16, chain_time, device_line, parse_device, tflops)
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d

SHAPES = [  # (B, D, H, W, Cin, Cout)
    (32, 32, 32, 32, 64, 64),
    (32, 32, 16, 16, 128, 128),
    (32, 32, 8, 8, 256, 256),
    (32, 32, 4, 4, 512, 512),
    (32, 32, 32, 32, 128, 64),
    (32, 32, 4, 4, 1024, 512),
]


def conv_inputs(shape, device, seed: int = 0):
    """Seeded bf16 x ~ 0.1 N, weight [Cout, Cin, 3, 3, 3] ~ 0.02 N and, where
    Cout != Cin, the chain's projection back [Cout, Cin] ~ 0.02 N."""
    b, d, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(s, scale):
        return (scale * torch.randn(s, generator=gen, device=device)).bfloat16()

    x = draw((b, d, h, w, cin), 0.1)
    weight = draw((cout, cin, 3, 3, 3), 0.02)
    back = draw((cout, cin), 0.02) if cin != cout else None
    return x, weight, back


def library_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.conv3d`` on the channels-last view of x, back to [B, D, H, W, Cout]."""
    return F.conv3d(x.movedim(-1, 1), weight, padding=1).movedim(1, -1)


def chain(conv, back):
    def step(x):
        y = conv(x)
        if back is not None:
            y = y @ back
        return x + 0.001 * y.to(x.dtype)
    return step


def conv_flops(shape) -> float:
    b, d, h, w, cin, cout = shape
    return 2.0 * b * d * h * w * cin * cout * 27


def run(shape, device) -> dict:
    x0, weight, back = conv_inputs(shape, device)
    with torch.no_grad():
        want = library_conv(x0, weight).float()
        err = float((conv3d(x0, weight).float() - want).abs().max())
        ref = float(want.abs().max()) or 1.0
    k5 = chain(lambda x: conv3d(x, weight), back)
    lib = chain(lambda x: library_conv(x, weight), back)
    t_lib = chain_time(lib, x0, iters=24)
    t_k5 = chain_time(k5, x0, iters=24)
    on_card = device.type == "cuda"
    fl = conv_flops(shape)
    return {"shape": list(shape), "library_ms": t_lib, "k5_ms": t_k5,
            "k5_tflops": tflops(fl, t_k5) if on_card else None,
            "library_tflops": tflops(fl, t_lib) if on_card else None,
            "k5_over_library": t_k5 / t_lib, "maxerr": err, "rel": err / ref}


def main(argv=None) -> list:
    args = parse_device(__doc__, argv, shape=dict(nargs="?", type=int))
    shapes = SHAPES if args.shape is None else [SHAPES[args.shape]]
    print(device_line(args.device), flush=True)
    rows = []
    for shape in shapes:
        r = run(shape, args.device)
        rows.append(r)
        b, d, h, w, cin, cout = shape
        share = ""
        if r["k5_tflops"] is not None:
            share = (f" K5 {r['k5_tflops'] * 1e12 / PEAK_BF16:4.0%}, "
                     f"cuDNN {r['library_tflops'] * 1e12 / PEAK_BF16:4.0%} of 989 TF/s;")
        print(f"{b}x{d}x{h}x{w} {cin:>4}->{cout:<4}: F.conv3d {r['library_ms']:8.3f} ms  "
              f"K5 {r['k5_ms']:8.3f} ms  K5/F.conv3d {r['k5_over_library']:5.2f}x;{share}  "
              f"maxerr {r['maxerr']:.2e} (rel {r['rel']:.2e})", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
