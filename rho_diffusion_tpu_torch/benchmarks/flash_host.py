"""Host cost of the flash wrappers on the card: the Python and launcher work
of one call.

    python rho_diffusion_tpu_torch/benchmarks/flash_host.py [--against DIR] [--rounds 2]

Each wrapper call is timed on the host clock while the card is kept busy
ahead of it (``torch.cuda._sleep``), so the loop never waits for the device
and the time is the work done before the launch returns. Each row says
whether the card was still busy when the loop ended (``device_busy``); a
row where it was not also counts device time. The calls: K1's forward at
one of a batch-8 UNet forward's six calls (T = 512, 4 heads of 128, q/k/v
strided views of one qkv) through ``flash_attention_fwd_kernel`` and
through ``flash_attention`` without grad (the sampling path's call); K3
(dkv) and K4 (dq) through ``flash_attention_bwd_kernel`` at a batch-32
training step's shape. Best and median of ``REPS`` loops, in microseconds
a call.

With ``--against DIR`` (another checkout of the repository, e.g. a parent
commit unpacked with ``git archive``) each tree is measured in a fresh
process of its own, in turns: DIR, this tree, this tree, DIR, ``--rounds``
times. The card's nvidia-smi name and power limit come first, then one JSON
line a run; ``main`` returns the rows.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
REPS = 5
SLEEP_CYCLES = 400_000_000  # ~0.2 s of device time ahead of each loop


def measure(root: Path) -> dict:
    """Host microseconds a call of each wrapper, with the package imported
    from the tree at ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from rho_diffusion_tpu_torch.ops.kernels import flash_attention as fa

    if not Path(fa.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {fa.__file__}, not the tree at {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def views(b):
        qkv = torch.randn((b, 512, 4, 384), generator=gen, device=dev).bfloat16()
        return qkv.split(128, dim=-1)

    def host_us(fn, calls: int) -> dict:
        for _ in range(10):
            fn()
        times, busy = [], True
        for _ in range(REPS):
            torch.cuda.synchronize()
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) / calls * 1e6)
            end = torch.cuda.Event()
            end.record()
            busy = busy and not end.query()
        torch.cuda.synchronize()
        return {"best_us": min(times), "median_us": statistics.median(times),
                "calls": calls, "device_busy": busy}

    q, k, v = views(8)
    q3, k3, v3 = views(32)
    o, lse = fa.flash_attention_fwd_kernel(q3, k3, v3, with_lse=True)
    do = torch.randn(o.shape, generator=gen, device=dev).bfloat16()
    with torch.no_grad():
        return {
            "k1_fwd_kernel": host_us(lambda: fa.flash_attention_fwd_kernel(q, k, v), 400),
            "k1_flash_attention": host_us(lambda: fa.flash_attention(q, k, v), 400),
            # the backward's delta adds a few PyTorch launches a call: fewer
            # calls keep the launch queue from filling
            "k3_dkv_kernel": host_us(lambda: fa.flash_attention_bwd_kernel(
                q3, k3, v3, o, lse, do, (False, True, True)), 100),
            "k4_dq_kernel": host_us(lambda: fa.flash_attention_bwd_kernel(
                q3, k3, v3, o, lse, do, (True, False, False)), 100),
        }


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--against", type=Path, help="another checkout to measure in turns")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a child's tree
    args = parser.parse_args(argv)
    if args.one:
        row = measure(args.one)
        print(json.dumps(row))
        return [row]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    trees = [("this", HERE)]
    if args.against:
        trees = [("against", args.against), ("this", HERE), ("this", HERE),
                 ("against", args.against)] * args.rounds
    rows = []
    for tag, root in trees:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"the run on {root} failed:\n{proc.stderr[-4000:]}")
        row = {"tree": tag, "root": str(root), **json.loads(proc.stdout.strip().splitlines()[-1])}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
