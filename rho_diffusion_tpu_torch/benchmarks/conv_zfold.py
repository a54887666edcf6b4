"""The z-fold phrasing of a 3x3x3 conv against the port's and cuDNN's.

The counterpart of ``benchmarks/conv_zfold.py``: a 3x3x3 SAME conv phrased
as ONE 2-D 3x3 conv whose input is the depth neighbourhood concatenated on
the channels, (B*D, H, W, 3*Cin), and whose kernel is the 3x3x3 one with
its depth taps moved into the input channels, tap-major (the reduction
depth triples). At JAX's ``LEVEL_SHAPES`` in bf16 it times, state-chained
(``_timing.chain_time``), the forward (``x + 0.001 * conv(x)``, through a
[Cout, Cin] projection where Cout != Cin) and the forward and input
gradient (``x - 1e-6 * d/dx sum(conv(x)^2)``) of four phrasings:

* ``k5``: the port's native conv (``ops.kernels.conv3d``: K5 on the card);
* ``cudnn``: ``F.conv3d`` on the channels-last view;
* ``zfold``: the fold, one ``F.conv2d``;
* ``via2d``: ``ops.convolution.conv3d_via_2d`` (JAX's ``Conv3dVia2d``:
  three ``F.conv2d`` summed, the backend ``RHO_CONV3D_VIA_2D=1`` selects).

Each row gives the rate against the card's 989 TFLOP/s bf16 peak
(``_timing.PEAK_BF16``) and the largest difference of the phrasing's
forward from k5's on the first input.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv_zfold [-d cuda|cpu]
    [shape index]
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.benchmarks._timing import (
    PEAK_BF16, chain_time, device_line, parse_device, tflops)
from rho_diffusion_tpu_torch.benchmarks.conv3d_ab import (
    chain, conv_flops, conv_inputs, library_conv)
from rho_diffusion_tpu_torch.ops.convolution import conv3d_via_2d
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d

# the JAX script's flagship levels (B, D, H, W, Cin, Cout); D never downsamples
LEVEL_SHAPES = [
    (32, 32, 32, 32, 64, 64),
    (32, 32, 16, 16, 128, 128),
    (32, 32, 8, 8, 256, 256),
    (32, 32, 4, 4, 512, 512),
    (32, 32, 32, 32, 128, 64),
]


def zfold_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of [B, D, H, W, Cin] by depth-tap channel folding:
    input channels tap-major (kz * Cin + ci), the kernel [Cout, Cin, kz, kh,
    kw] moved to [Cout, kz * Cin, kh, kw]."""
    b, d, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    xz = torch.cat([xp[:, 0:d], xp[:, 1:d + 1], xp[:, 2:d + 2]], dim=-1)
    k2 = weight.permute(0, 2, 1, 3, 4).reshape(weight.shape[0], 3 * cin, 3, 3)
    y = F.conv2d(xz.reshape(b * d, h, w, 3 * cin).movedim(-1, 1), k2, padding=1)
    return y.movedim(1, -1).reshape(b, d, h, w, weight.shape[0])


def phrasings(weight: torch.Tensor) -> dict:
    return {"k5": lambda x: conv3d(x, weight),
            "cudnn": lambda x: library_conv(x, weight),
            "zfold": lambda x: zfold_conv(x, weight),
            "via2d": lambda x: conv3d_via_2d(x, weight, None)}


def grad_step(conv):
    def step(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(conv(xr).float().pow(2).sum(), xr)
        return x - 1e-6 * g.to(x.dtype)
    return step


def run(shape, device) -> dict:
    x0, weight, back = conv_inputs(shape, device)
    fl = conv_flops(shape)
    on_card = device.type == "cuda"
    rows = {}
    with torch.no_grad():
        ref = conv3d(x0, weight).float()
    for name, conv in phrasings(weight).items():
        with torch.no_grad():
            err = float((conv(x0).float() - ref).abs().max())
        fwd = chain_time(chain(conv, back), x0, iters=24)
        both = chain_time(grad_step(conv), x0, iters=24)
        rows[name] = {"fwd_ms": fwd, "fwd_bwd_ms": both, "max_abs_err_vs_k5": err,
                      "fwd_peak_share": tflops(fl, fwd) * 1e12 / PEAK_BF16 if on_card else None,
                      "fwd_bwd_peak_share":
                          tflops(3 * fl, both) * 1e12 / PEAK_BF16 if on_card else None}
    return {"shape": list(shape), "flops": fl, "rows": rows}


def main(argv=None) -> list:
    args = parse_device(__doc__, argv, shape=dict(nargs="?", type=int))
    shapes = LEVEL_SHAPES if args.shape is None else [LEVEL_SHAPES[args.shape]]
    print(device_line(args.device), flush=True)
    out = []
    for shape in shapes:
        r = run(shape, args.device)
        out.append(r)
        print(f"shape B{shape[0]} DHW{tuple(shape[1:4])} C{shape[4]}->{shape[5]}:", flush=True)
        for name, row in r["rows"].items():
            share = "" if row["fwd_peak_share"] is None else (
                f" ({row['fwd_peak_share']:5.1%} of peak; fwd+bwd "
                f"{row['fwd_bwd_peak_share']:5.1%})")
            print(f"  {name:6s} fwd {row['fwd_ms']:8.3f} ms  fwd+bwd {row['fwd_bwd_ms']:8.3f} ms"
                  f"{share}  |err| vs k5 {row['max_abs_err_vs_k5']:.2e}", flush=True)
        k5 = r["rows"]["k5"]
        print("  speed vs k5: " + "  ".join(
            f"{n} fwd {k5['fwd_ms'] / v['fwd_ms']:.2f}x fwd+bwd "
            f"{k5['fwd_bwd_ms'] / v['fwd_bwd_ms']:.2f}x"
            for n, v in r["rows"].items() if n != "k5"), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
