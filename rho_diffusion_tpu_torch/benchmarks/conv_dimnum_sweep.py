"""Which phrasing of the same 3x3x3 conv does cuDNN run fastest?

The counterpart of ``benchmarks/conv_dimnum_sweep.py``: at one flagship
level (B, D, H, W, C = C; level 1 unless named) in bf16, each phrasing
state-chained (``x + 0.001 * f(x)``, ``_timing.chain_time``), its rate
against the card's 989 TFLOP/s bf16 peak (``_timing.PEAK_BF16``):

* ``DHWIO``: ``F.conv3d`` on the channels-last view (cuDNN sees NDHWC);
* ``flip+OI (dgrad form)``: the same with the kernel flipped in space, the
  function JAX's flipped, IO-swapped kernel under DHWOI numbers computes;
* ``dgrad (autograd)``: the conv's input gradient, ``conv3d_input`` (what
  autograd runs for it; JAX's ``vjp``) applied to x;
* ``NCDHW/OIDHW``: ``F.conv3d`` on a contiguous channels-first copy;
* ``fold B into D``: one (B*D)-deep volume (its depth halo wrong at the
  batch seams, its operations the same);
* ``k5``: the port's native conv (``ops.kernels.conv3d``).

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv_dimnum_sweep
    [-d cuda|cpu] [level]
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.benchmarks._timing import (
    PEAK_BF16, chain_time, device_line, parse_device, tflops)
from rho_diffusion_tpu_torch.benchmarks.conv3d_ab import conv_inputs, library_conv
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d

LEVELS = {"0": (32, 32, 32, 32, 64), "1": (32, 32, 16, 16, 128), "2": (32, 32, 8, 8, 256),
          "3": (32, 32, 4, 4, 512)}


def dgrad(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The input gradient of the conv at cotangent x (channels-last)."""
    g = x.movedim(-1, 1)
    return torch.nn.grad.conv3d_input(g.shape, weight, g, padding=1).movedim(1, -1)


def ncdhw_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.conv3d`` on [B, C, D, H, W] in the contiguous channels-first layout."""
    return F.conv3d(x, weight, padding=1)


def phrasings(weight: torch.Tensor) -> dict:
    """name -> (f, whether it takes the channels-first x)."""
    flipped = weight.flip((2, 3, 4))
    return {
        "DHWIO": (lambda x: library_conv(x, weight), False),
        "flip+OI (dgrad form)": (lambda x: library_conv(x, flipped), False),
        "dgrad (autograd)": (lambda x: dgrad(x, weight), False),
        "NCDHW/OIDHW": (lambda x: ncdhw_conv(x, weight), True),
        "fold B into D": (lambda x: library_conv(x, weight), False),
        "k5": (lambda x: conv3d(x, weight), False),
    }


def main(argv=None) -> list:
    args = parse_device(__doc__, argv, level=dict(nargs="?", default="1", choices=sorted(LEVELS)))
    b, d, h, w, c = LEVELS[args.level]
    x0, weight, _ = conv_inputs((b, d, h, w, c, c), args.device)
    fl = 2.0 * b * d * h * w * c * c * 27
    print(f"{device_line(args.device)} level={args.level} shape={tuple(x0.shape)}", flush=True)
    rows = []
    for name, (f, channels_first) in phrasings(weight).items():
        x = x0
        if channels_first:
            x = x0.movedim(-1, 1).contiguous()
        elif name == "fold B into D":
            x = x0.reshape(1, b * d, h, w, c)
        ms = chain_time(lambda x, f=f: x + 0.001 * f(x).to(x.dtype), x, iters=24)
        share = tflops(fl, ms) * 1e12 / PEAK_BF16 if args.device.type == "cuda" else None
        rows.append({"name": name, "ms": ms, "tflops": tflops(fl, ms), "peak_share": share})
        print(f"{name:>22}: {ms:8.3f} ms  {tflops(fl, ms):7.1f} TF/s"
              + ("" if share is None else f" ({share:4.0%})"), flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
