"""Serving latency and throughput on the flagship 32^3 DDIM-50 workload.

    python -m rho_diffusion_tpu_torch.benchmarks.serve_bench [-d cuda|cpu]

Port of ``benchmarks/serve_bench.py``: what a deployment sees from the
port's ``SamplingService``:

* single-request latency (bucket 1): p50 over ``SERVE_NLAT`` (8) requests,
  one at a time;
* batched throughput: ``SERVE_NLOAD`` (32) concurrent one-sample requests,
  coalesced by the service's worker into launches of the largest bucket;
* mean batch occupancy, volumes/s and the load phase's launches.

The workload is JAX's: a GaussianDiffusionPipeline (epsilon, fixed_large,
LinearSchedule(1000)) over UNetv2 32^3, model_channels 64, channel_mult
(1, 2, 4, 8), bf16, weights seeded with 0, zero condition rows, sampled by
``SERVE_SAMPLER`` ('ddim') over ``SERVE_STEPS`` (50) respaced steps, buckets
``SERVE_BUCKETS`` (1,8). Other knobs: ``SERVE_GRID``, ``SERVE_DELAY`` (the
coalescing window, 0.01 s), ``SERVE_GUIDANCE`` (classifier-free guidance
scale), ``SERVE_TRANSFER_DTYPE`` (bfloat16|float16 pulls), ``SERVE_QUANT``
(int8 raises until ROADMAP Queue 1 item 11). ``SERVE_SMOKE=1`` is a tiny
CPU-sized run (8^3, width 16, 4 steps, buckets 1,2, 3 + 6 requests).

It prints one JSON line with JAX's keys; ``warmup_compile_s`` is the
service's build and warm-up (every bucket run once). The line before it
names the device (on the card its nvidia-smi name and power limit) and
gives the device's busy share over the load phase: the device time
torch.profiler records over the load phase's wall clock. It runs on CUDA unless
``-d cpu`` is given, and raises when CUDA is absent.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional, Sequence

import numpy as np

from rho_diffusion_tpu_torch.benchmarks._timing import device_events, device_line, parse_device


def settings() -> dict:
    """The workload the ``SERVE_*`` variables select."""
    smoke = os.environ.get("SERVE_SMOKE") == "1"
    guidance = os.environ.get("SERVE_GUIDANCE")
    return {
        "smoke": smoke,
        "grid": 8 if smoke else int(os.environ.get("SERVE_GRID", 32)),
        "mc": 16 if smoke else 64,
        "steps": 4 if smoke else int(os.environ.get("SERVE_STEPS", 50)),
        "sampler": os.environ.get("SERVE_SAMPLER", "ddim"),
        "buckets": tuple(int(b) for b in os.environ.get(
            "SERVE_BUCKETS", "1,2" if smoke else "1,8").split(",")),
        "n_lat": 3 if smoke else int(os.environ.get("SERVE_NLAT", 8)),
        "n_load": 6 if smoke else int(os.environ.get("SERVE_NLOAD", 32)),
        "delay": float(os.environ.get("SERVE_DELAY", 0.01)),
        "guidance": float(guidance) if guidance is not None else None,
        "transfer_dtype": os.environ.get("SERVE_TRANSFER_DTYPE") or None,
        "quantize": os.environ.get("SERVE_QUANT") or None,
    }


def pipeline(s: dict, device, dtype: str = "bfloat16"):
    """The workload's pipeline, its weights seeded with 0 (``dtype`` the
    UNet's compute dtype)."""
    from rho_diffusion_tpu_torch.diffusion import GaussianDiffusionPipeline, LinearSchedule

    return GaussianDiffusionPipeline(
        backbone="UNetv2",
        backbone_kwargs=dict(
            data_shape=(s["grid"],) * 3, dims=3, in_channels=1, out_channels=1,
            model_channels=s["mc"], num_res_blocks=2,
            channel_mult=(1, 2) if s["smoke"] else (1, 2, 4, 8), attention_resolutions=[16, 8],
            num_heads=4, num_classes=20, use_scale_shift_norm=True, dtype=dtype),
        schedule=LinearSchedule(100 if s["smoke"] else 1000), model_mean_type="epsilon",
        model_var_type="fixed_large", optimizer="AdamW", device=device, seed=0)


def workload_name(s: dict) -> str:
    g = s["guidance"]
    return (f"{s['grid']}^3 {s['sampler']}-{s['steps']} (bf16, mc={s['mc']})"
            + (f" cfg={g}" if g is not None and g != 1.0 else "")
            + (f" xfer={s['transfer_dtype']}" if s["transfer_dtype"] else "")
            + (f" quant={s['quantize']}" if s["quantize"] else ""))


def load_phase(service, conds1: np.ndarray, n_load: int, device) -> tuple:
    """``n_load`` one-sample requests submitted at once: their results,
    the wall clock from the first submit to the last result, and the
    device time torch.profiler recorded over it (None on the CPU or when
    it recorded no device event)."""
    def run():
        t0 = time.perf_counter()
        futs = [service.submit(conditions=conds1, seed=1000 + i) for i in range(n_load)]
        outs = [f.result() for f in futs]
        return outs, time.perf_counter() - t0

    if device.type != "cuda":
        outs, wall = run()
        return outs, wall, None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs, wall = run()
    busy_ns = sum(e.duration_ns() for e in device_events(prof.profiler.kineto_results.events()))
    return outs, wall, busy_ns / 1e9 if busy_ns else None


def build_service(s: dict, device, params: Optional[dict] = None):
    """The service over ``pipeline(s)`` (serving ``params``, a state_dict,
    when given), every bucket warmed up."""
    from rho_diffusion_tpu_torch.serving import SamplingService

    return SamplingService(
        pipeline(s, device), params, sampler=s["sampler"], num_steps=s["steps"],
        cond_dim=4 * s["mc"], guidance_scale=s["guidance"], transfer_dtype=s["transfer_dtype"],
        quantize=s["quantize"], batch_buckets=s["buckets"], max_delay_s=s["delay"], warmup=True)


def measure(service, s: dict, device) -> tuple[dict, Optional[float]]:
    """The latency and load phases on a built service: JAX's result keys
    (but ``warmup_compile_s``), and the device's busy share of the load
    phase (None where not measured)."""
    conds1 = np.zeros((1, 4 * s["mc"]), np.float32)
    # single-request latency (no contention: bucket 1)
    lats = []
    for i in range(s["n_lat"]):
        t0 = time.perf_counter()
        res = service.generate(conditions=conds1, seed=i)
        lats.append(time.perf_counter() - t0)
        if not np.isfinite(res.samples).all():
            raise FloatingPointError(f"request {i} sampled non-finite values")
    lats.sort()
    # concurrent load: n_load one-sample requests submitted at once
    launches_before = service.stats()["launches"]
    outs, load_wall, busy_s = load_phase(service, conds1, s["n_load"], device)
    stats = service.stats()
    return {
        "workload": workload_name(s),
        "single_request_latency_p50_s": round(lats[len(lats) // 2], 4),
        "concurrent_requests": s["n_load"],
        "concurrent_wall_s": round(load_wall, 3),
        "throughput_volumes_per_s": round(s["n_load"] / load_wall, 3),
        "mean_batch_occupancy": round(stats["mean_occupancy"], 3),
        "load_phase_launches": stats["launches"] - launches_before,
        "all_finite": all(bool(np.isfinite(o.samples).all()) for o in outs),
    }, None if busy_s is None else busy_s / load_wall


def main(argv: Optional[Sequence[str]] = None) -> dict:
    device = parse_device(__doc__.splitlines()[0], argv).device
    s = settings()
    t0 = time.perf_counter()
    service = build_service(s, device)
    compile_s = time.perf_counter() - t0
    try:
        measured, busy = measure(service, s, device)
    finally:
        service.close()
    print(f"{device_line(device)} load_phase_device_busy_share="
          f"{'not measured' if busy is None else busy}", flush=True)
    result = {"workload": measured.pop("workload"), "warmup_compile_s": round(compile_s, 1),
              **measured}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
