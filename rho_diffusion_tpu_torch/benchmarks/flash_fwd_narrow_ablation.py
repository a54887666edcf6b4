"""Ablation: what holds the narrow flash forward at the ViT's patch-4 shape.

The narrow route (``csrc/flash_attention_fwd_narrow.cuh``) computes the
ViT's attention at head dim 16, and at B 32, T 512, H 16 its bound is its
exponentials' (134 M ex2 on the special-function unit: 0.032 ms on an H100
SXM at 1,980 MHz; its products 0.009 ms, its bytes 0.010). This script asks
whether the exponentials set the kernel's time. Each variant removes one
part from a copy of the kernel's source (its results are then wrong: only
its time counts) and is built from that copy with the port's own ``nvcc``
flags, one ``nvcc`` for each variant, all started together:

* ``base``: the kernel as it is;
* ``no_exp``: every ``ex2`` (P and the rescale factors) replaced by a
  multiply, so the special-function unit does no work;
* ``no_pv``: no P V product (P is still computed and rounded to bf16);
* ``no_qk``: no Q K^T product (the zeroed score accumulators stand in);
* ``no_max``: no shuffles for the rows' max (each thread keeps its own);
* ``no_refill``: no K/V loads after the first STAGES tiles (later tiles
  read stale stages), so no wait on a load past the prologue;
* ``no_pack``: P packed into bf16 pairs by integer ops (truncation) in
  place of the conversion instructions;
* ``minb2``, ``minb4``: the registers at D = 16 held to two or four blocks
  an SM in place of three (``__launch_bounds__``): four or eight
  warpgroups an SM in place of six; ``wgs1_minb6``: one warpgroup a block,
  six blocks an SM;
* ``stages4``: the K/V ring four stages deep in place of three.

Each variant runs the forward with its LSE, as the ViT's training step does.
Beside them, on the same inputs, the ``mma.sync`` kernel it replaced (on
request, ``MMA_SYNC_PLAN``) and SDPA's forward. Every variant is timed as
device time: ``ITERS`` calls of the wrapper captured in a CUDA graph, the
graph replayed between CUDA events (no host work, which at T = 64 is larger
than the kernel), in rounds that visit the variants in turn (so drift falls
on all alike), and the best round is kept.
The first printed line names the card and its power limit, the last is one
JSON object.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.flash_fwd_narrow_ablation [--shape B T H D]
"""
from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from rho_diffusion_tpu_torch.benchmarks._ablation import build_variants
from rho_diffusion_tpu_torch.benchmarks._timing import device_line, parse_device
from rho_diffusion_tpu_torch.ops.kernels import _build
from rho_diffusion_tpu_torch.ops.kernels import flash_attention as fa

SOURCE = "flash_attention_fwd_narrow.cuh"
ITERS = 20
ROUNDS = 3

# name -> [(text in the kernel's source, its replacement, how often it occurs)]
VARIANTS = {
    "base": [],
    "no_exp": [("ex2(fmaf(", "0.5f * (fmaf(", 4), ("= ex2(m_r[0] - mx0), alpha1 = ex2(m_r[1]",
                                                   "= 0.5f * (m_r[0] - mx0), alpha1 = 0.5f * "
                                                   "(m_r[1]", 1)],
    "no_pv": [("wg::WgmmaRS<HD>::mma(o_acc,", "if (0) wg::WgmmaRS<HD>::mma(o_acc,", 1)],
    "no_qk": [("wg::Wgmma<64>::mma(s_acc,", "if (0) wg::Wgmma<64>::mma(s_acc,", 1)],
    "no_pack": [("wg::pack_bf16(p0, p1)",
                 "((__float_as_uint(p0) >> 16) | (__float_as_uint(p1) & 0xffff0000u))", 1),
                ("wg::pack_bf16(p2, p3)",
                 "((__float_as_uint(p2) >> 16) | (__float_as_uint(p3) & 0xffff0000u))", 1)],
    "no_max": [("    for (int off = 1; off < 4; off <<= 1) {\n      mx0 = fmaxf",
                "    for (int off = 1; off < 1; off <<= 1) {\n      mx0 = fmaxf", 1)],
    "no_refill": [("    if (j + STAGES < p.kv_tiles) load_kv<HD>(j + STAGES,",
                   "    if (false) load_kv<HD>(j + STAGES,", 1)],
    "minb2": [("constexpr int MIN_BLOCKS_16 = 3;", "constexpr int MIN_BLOCKS_16 = 2;", 1)],
    "minb4": [("constexpr int MIN_BLOCKS_16 = 3;", "constexpr int MIN_BLOCKS_16 = 4;", 1)],
    "wgs1_minb6": [("constexpr int WGS = 2;", "constexpr int WGS = 1;", 1),
                   ("constexpr int MIN_BLOCKS_16 = 3;", "constexpr int MIN_BLOCKS_16 = 6;", 1)],
    "stages4": [("constexpr int STAGES = 3;", "constexpr int STAGES = 4;", 1)],
}


def narrow_ptxas(log: str) -> list:
    """The ptxas lines (registers, spills) of the narrow kernel's instances
    in one build's ``-Xptxas -v`` output."""
    out, current = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif "flash_fwd_narrow" in current and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def time_call(fn, replays: int = 5) -> float:
    """Device milliseconds a call of ``fn``: ITERS calls captured in a CUDA
    graph, the graph replayed ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * ITERS)


def main(argv=None) -> dict:
    args = parse_device("the narrow flash forward's ablation", argv,
                        **{"--shape": dict(type=int, nargs=4, default=[32, 512, 16, 16])})
    if args.device.type != "cuda":
        raise RuntimeError("the ablation builds and times CUDA kernels: it runs on the card only")
    print(device_line(args.device), flush=True)
    b, t, h, d = args.shape
    if fa.flash_plan(b, h, t, t, d).route != "narrow":
        raise ValueError(f"shape {args.shape} does not take the narrow route")
    libs, logs = build_variants(VARIANTS, SOURCE, "flash_attention",
                                fa._LAUNCHERS["flash_attention"],
                                _build.build_dir().parent / "ablation_fwd")
    gen = torch.Generator(device=args.device).manual_seed(0)
    q, k, v = torch.randn((b, t, h, 3 * d), generator=gen, device=args.device).to(
        torch.bfloat16).split(d, dim=-1)
    library = fa._library
    best = {name: float("inf") for name in VARIANTS}
    try:
        for _ in range(ROUNDS):
            for name in VARIANTS:
                fa._library = lambda _name, lib=libs[name]: lib
                call = lambda: fa.flash_attention_fwd_kernel(q, k, v, with_lse=True)  # noqa: E731
                call()
                best[name] = min(best[name], time_call(call))
    finally:
        fa._library = library
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    others = {
        "mma_sync": lambda: fa.flash_attention_fwd_kernel(q, k, v, with_lse=True,
                                                          plan=fa.MMA_SYNC_PLAN),
        "sdpa": lambda: F.scaled_dot_product_attention(qt, kt, vt),
    }
    other_ms = {name: float("inf") for name in others}
    for _ in range(ROUNDS):
        for name, fn in others.items():
            fn()
            other_ms[name] = min(other_ms[name], time_call(fn))
    result = {"shape": [b, t, h, d], "iters": ITERS, "rounds": ROUNDS, "with_lse": True,
              "ms": best, "mma_sync_ms": other_ms["mma_sync"], "sdpa_ms": other_ms["sdpa"],
              "ptxas": {name: narrow_ptxas(log) for name, log in logs.items()}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:]) else 1)
