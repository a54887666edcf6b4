"""Probe: the int8 conv S1 against K5's bf16 conv at the flagship's levels.

The counterpart of ``benchmarks/conv_int8_probe.py``, which asked whether
XLA puts int8 convs on the TPU's int8 units. Here the int8 conv is the
port's own kernel S1 (``csrc/conv3d_s8_wgmma.cuh``), so the question is how
near it comes to the H100's int8 rate (1,979 TOPS dense, twice bf16's 989
TFLOP/s) and what W8A8 costs beside it: the activation's quantisation S3
(two launches, bound by its bytes). At each of ``LEVEL_SHAPES`` (batch 32,
3x3x3 SAME, Cin = Cout per level) it times, with CUDA events, best of three
runs of ``ITERS`` calls:

* S1 on int8 operands with the bf16 dequantised output (``s8_ms``);
* S3 on the level's bf16 activation (``quant_ms``);
* K5 on the same shape in bf16 (``k5_ms``), the float conv S1 replaces;

each beside its bound (operations at the int8 or bf16 peak, or bytes at
3.35 TB/s, the larger), and S1 held bitwise against its plain version on
the first batch element. Rows are returned from ``main(argv)``; the first
printed line names the card and its power limit.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.conv_int8_probe [-d cuda|cpu]
"""
from __future__ import annotations

import sys
import time

import torch

from rho_diffusion_tpu_torch.benchmarks._timing import PEAK_BF16, device_line, parse_device
from rho_diffusion_tpu_torch.ops.kernels import conv_int8 as k
from rho_diffusion_tpu_torch.ops.kernels.conv3d import conv3d

PEAK_INT8 = 1979e12  # H100 SXM dense int8 (data sheet)
MEM_RATE = 3.35e12  # H100 SXM device memory, bytes/s
ITERS = 10

LEVEL_SHAPES = [
    # (B, D, H, W, Cin, Cout): the flagship UNet's levels (benchmarks/conv_profile.py)
    (32, 32, 32, 32, 64, 64),
    (32, 32, 16, 16, 128, 128),
    (32, 32, 8, 8, 256, 256),
    (32, 32, 4, 4, 512, 512),
]


def bound_ms(ops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_mem = ops / peak, nbytes / MEM_RATE
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def time_ms(fn, device: torch.device, iters: int = ITERS, reps: int = 3) -> float:
    """Best milliseconds per call of ``fn`` over ``reps`` runs of ``iters``
    calls, after one warm-up call: CUDA events on the card, the host clock
    on the CPU (a CPU number, never the card's)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


def level_inputs(shape, device, seed: int = 0):
    """Seeded bf16 x ~ N(0, 1) and weights ~ N(0, 1/(27 Cin)), quantised as
    the int8 path quantises them (weights per output channel, x per sample,
    both through ``quantize_rows``)."""
    b, d, h, w, cin, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, d, h, w, cin), generator=gen, device=device).bfloat16()
    weight = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device=device)
              / (27 * cin) ** 0.5)
    bias = 0.02 * torch.randn((cout,), generator=gen, device=device)
    xq, s_x = k.quantize_rows(x)
    wq, s_w = k.quantize_rows(weight)
    return x, weight, bias, xq, s_x, wq, s_w


def run(shape, device) -> dict:
    b, d, h, w, cin, cout = shape
    x, weight, bias, xq, s_x, wq, s_w = level_inputs(shape, device)
    w1 = k.s1_weights(wq)
    wb, bb = weight.bfloat16(), bias.bfloat16()
    on_card = device.type == "cuda"
    with torch.no_grad():
        if on_card:
            s1 = lambda: k.conv3d_s8_kernel(xq, s_x, w1, s_w, bias, torch.bfloat16)  # noqa: E731
            quant = lambda: k.quantize_rows_kernel(x)  # noqa: E731
            got = k.conv3d_s8_kernel(xq[:1], s_x[:1], w1, s_w, bias, torch.int32)
        else:
            pads = [(1, 1)] * 3
            s1 = lambda: k.conv_int8_plain(xq, s_x, wq, s_w, bias, (1, 1, 1), pads,  # noqa: E731
                                           torch.bfloat16)
            quant = lambda: k.quantize_rows_plain(x)  # noqa: E731
            got = k.conv_int8_plain(xq[:1], s_x[:1], wq, s_w, bias, (1, 1, 1), pads, torch.int32)
        want = k.conv_int32_plain(xq[:1], wq, (1, 1, 1), [(1, 1)] * 3)
        exact = bool(torch.equal(got, want))
        t_s8 = time_ms(s1, device)
        t_q = time_ms(quant, device)
        t_k5 = time_ms(lambda: conv3d(x, wb, bb), device)
    ops = 2.0 * b * d * h * w * cin * cout * 27
    voxels = b * d * h * w
    s8_bound, s8_by = bound_ms(ops, voxels * (cin + 2 * cout) + 27 * cin * cout, PEAK_INT8)
    k5_bound, k5_by = bound_ms(ops, 2.0 * voxels * (cin + cout) + 54 * cin * cout, PEAK_BF16)
    q_bound = voxels * cin * 3 / MEM_RATE * 1e3  # bf16 read once, int8 written once
    return {"shape": list(shape), "s8_ms": t_s8, "s8_bound_ms": s8_bound, "s8_bound_by": s8_by,
            "s8_tops": ops / t_s8 / 1e9 if on_card else None,
            "s8_share_of_int8_peak": s8_bound / t_s8 if on_card else None,
            "quant_ms": t_q, "quant_bound_ms": q_bound, "quant_bound_by": "bytes",
            "k5_ms": t_k5, "k5_bound_ms": k5_bound, "k5_bound_by": k5_by,
            "int8_total_ms": t_s8 + t_q, "s8_over_k5": t_s8 / t_k5,
            "int8_total_over_k5": (t_s8 + t_q) / t_k5, "s1_int32_exact": exact}


def main(argv=None) -> list:
    args = parse_device(__doc__, argv)
    print(device_line(args.device), flush=True)
    rows = []
    for shape in LEVEL_SHAPES:
        r = run(shape, args.device)
        rows.append(r)
        b, d, h, w, cin, cout = shape
        rate = ""
        if r["s8_tops"] is not None:
            rate = (f" ({r['s8_tops']:.0f} TOP/s, {r['s8_share_of_int8_peak']:.0%} of its "
                    f"bound)")
        print(f"[{b}x{d}x{h}x{w} {cin}->{cout}] S1 {r['s8_ms']:8.3f} ms{rate} | S3 "
              f"{r['quant_ms']:7.3f} ms (bound {r['quant_bound_ms']:.3f}) | K5 bf16 "
              f"{r['k5_ms']:8.3f} ms | S1/K5 {r['s8_over_k5']:.2f}x, (S1+S3)/K5 "
              f"{r['int8_total_over_k5']:.2f}x | S1 exact {r['s1_int32_exact']}", flush=True)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
