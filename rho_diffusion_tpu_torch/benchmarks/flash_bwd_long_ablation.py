"""Ablation: what holds the long flash backward at the ViT's patch-4 shape.

The long route (``csrc/flash_attention_bwd_long.cuh``) takes 5-6x its bound
at B 32, T 512, H 16, D 16, and its bound is its exponentials'. This script
asks which part of a query tile's work the time goes to. Each variant
removes one part from a copy of the kernel's source (its results are then
wrong: only its time counts) and is built from that copy with the port's
own ``nvcc`` flags, one ``nvcc`` for each variant, all started together:

* ``base``: the kernel as it is;
* ``no_exp``: P without its ``ex2`` (the exponent itself is used);
* ``no_softmax_math``: no P, dS or dS^T stores at all (the score
  accumulators' bits stand in for the bf16 operands);
* ``no_delta``: no delta rows (the dot products of O and dO);
* ``no_rs``: no dV and dK products; ``no_dq``: no dQ product;
* ``no_tile_barrier``: no block barrier after warpgroup 1's dQ share;
* ``no_slot_store``: no store of dQ's fp32 slots; ``no_slot_read``: no
  read of them by a block's later chunks; ``no_slot_prefetch``: no L2
  prefetch of them a tile ahead; ``late_slot_read``: that read issued
  after the gradient products rather than before them.

The base kernel is also timed at other counts of blocks a batch*head
(``groups``: ``long_bwd_groups``'s choice, and 1, 2 and 4), and beside it,
on the same inputs, the ``mma.sync`` pair it replaced (on request, delta
pre-pass included) and SDPA's backward (``torch.autograd.grad`` of
``F.scaled_dot_product_attention`` on a kept graph). Every variant
is timed with CUDA events over ``ITERS`` calls of the wrapper, in rounds
that visit the variants in turn (so drift falls on all alike), and the
best round is kept. The first printed line names the card and its power
limit, the last is one JSON object.

Usage: python -m rho_diffusion_tpu_torch.benchmarks.flash_bwd_long_ablation [--shape B T H D]
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

SOURCE = "flash_attention_bwd_long.cuh"
ITERS = 20
ROUNDS = 3
GROUPS = (1, 2, 4)

# name -> [(text in the kernel's source, its replacement, how often it occurs)]
VARIANTS = {
    "base": [],
    "no_exp": [("fab::ex2(", "(", 4)],
    "no_softmax_math": [
        ("      for (int jj = 0; jj < 8; ++jj) {\n        const float2 l2",
         "      for (int jj = 0; jj < 8 && false; ++jj) {\n        const float2 l2", 1),
        ("      wg::fence_proxy_async();\n      wg::named_barrier(1 + group, 128);  // this",
         "#pragma unroll\n      for (int a = 0; a < 16; ++a) {\n"
         "        pf[a / 4][a % 4] = __float_as_uint(s_acc[a]);\n"
         "        dsf[a / 4][a % 4] = __float_as_uint(dp_acc[a]);\n      }\n"
         "      wg::fence_proxy_async();\n      wg::named_barrier(1 + group, 128);  // this", 1),
    ],
    "no_delta": [(
        "          sum = fbs::dot8(fbs::ld_shared_v4(o_row + (dhalf * DCH + cc) * 16),\n"
        "                          fbs::ld_shared_v4(do_base + wg::sw128_offset(drow, "
        "dhalf * DCH + cc)),\n                          sum);",
        "          sum += 0.f;", 1)],
    "no_rs": [("wg::WgmmaRS<HD>::mma(dv_acc,", "if (0) wg::WgmmaRS<HD>::mma(dv_acc,", 1),
              ("wg::WgmmaRS<HD>::mma(dk_acc,", "if (0) wg::WgmmaRS<HD>::mma(dk_acc,", 1)],
    "no_dq": [("wg::WgmmaT<HD>::mma(dq_acc,", "if (0) wg::WgmmaT<HD>::mma(dq_acc,", 1)],
    "no_tile_barrier": [("      __syncthreads();  // the share is written;",
                         "      // the share is written;", 1)],
    "no_slot_store": [("        __stcg(slot + jj * 32,",
                       "        if (dq_acc[0] == 12345.f) __stcg(slot + jj * 32,", 1)],
    "no_slot_read": [("prev[jj] = __ldcg(slot + jj * 32);", "prev[jj] = make_float4(0, 0, 0, 0);",
                      1)],
    "no_slot_prefetch": [("prefetch_l2(rows.part", "(void)(rows.part", 2)],
    "late_slot_read": [
        ("      if (group == 0 && !first) {\n#pragma unroll\n"
         "        for (int jj = 0; jj < NJ; ++jj) prev[jj] = __ldcg(slot + jj * 32);\n      }\n",
         "", 1),
        ("      wg::fence_regs(dsf);\n\n      // ---- warpgroup 1's dQ share",
         "      wg::fence_regs(dsf);\n      if (group == 0 && !first) {\n#pragma unroll\n"
         "        for (int jj = 0; jj < NJ; ++jj) prev[jj] = __ldcg(slot + jj * 32);\n      }\n\n"
         "      // ---- warpgroup 1's dQ share", 1)],
}


def time_call(fn) -> float:
    """Milliseconds a call of ``fn`` over ITERS calls between CUDA events."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv=None) -> dict:
    args = parse_device("the long flash backward's ablation", argv,
                        **{"--shape": dict(type=int, nargs=4, default=[32, 512, 16, 16])})
    if args.device.type != "cuda":
        raise RuntimeError("the ablation builds and times CUDA kernels: it runs on the card only")
    print(device_line(args.device), flush=True)
    b, t, h, d = args.shape
    libs, _ = build_variants(VARIANTS, SOURCE, "flash_attention_bwd",
                             fa._LAUNCHERS["flash_attention_bwd"],
                             _build.build_dir().parent / "ablation")
    gen = torch.Generator(device=args.device).manual_seed(0)
    q, k, v = torch.randn((b, t, h, 3 * d), generator=gen, device=args.device).to(
        torch.bfloat16).split(d, dim=-1)
    do = torch.randn((b, t, h, d), generator=gen, device=args.device).to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd_kernel(q, k, v, with_lse=True)
    chosen = fa.long_bwd_groups(b * h, t)
    runs = [(name, chosen) for name in VARIANTS]
    runs += [("base", g) for g in GROUPS if g != chosen and g <= -(-t // fa.LONG_BWD_PLAN.bn)]
    library, groups_of = fa._library, fa.long_bwd_groups
    best = {run: float("inf") for run in runs}
    try:
        for _ in range(ROUNDS):
            for name, groups in runs:
                fa._library = lambda _name, lib=libs[name]: lib
                fa.long_bwd_groups = lambda _bh, _tk, g=groups: g
                call = lambda: fa.flash_attention_bwd_kernel(q, k, v, o, lse, do)  # noqa: E731
                call()
                best[(name, groups)] = min(best[(name, groups)], time_call(call))
    finally:
        fa._library, fa.long_bwd_groups = library, groups_of
    pair = lambda: fa.flash_attention_bwd_kernel(  # noqa: E731
        q, k, v, o, lse, do, plan=fa.MMA_SYNC_BWD_PLAN)
    qt, kt, vt = (z.detach().transpose(1, 2).requires_grad_() for z in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    sdpa = lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),  # noqa: E731
                                       retain_graph=True)
    others = {"pair": float("inf"), "sdpa_backward": float("inf")}
    for _ in range(ROUNDS):
        for name, fn in (("pair", pair), ("sdpa_backward", sdpa)):
            fn()
            others[name] = min(others[name], time_call(fn))
    result = {"shape": [b, t, h, d], "groups_chosen": chosen, "iters": ITERS, "rounds": ROUNDS,
              "ms": {name: ms for (name, g), ms in best.items() if g == chosen},
              "base_ms_by_groups": {str(g): ms for (name, g), ms in best.items()
                                    if name == "base"},
              "pair_ms": others["pair"], "sdpa_backward_ms": others["sdpa_backward"]}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:]) else 1)
